"""Regenerate the golden end-to-end fixture.

Builds a small alignment with planted couplings and gaps, runs the FULL
CLI on CPU, and freezes every output file under tests/golden/expected/.
test_golden.py asserts byte-identity against these files, locking the
whole output surface (couplings format README.md:60-62, outliers format
SpydrPick.hpp:89-129) across engine-perf churn.

Run from the repo root:  python tests/golden/make_golden.py
"""

import os
import shutil
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax

jax.config.update("jax_platforms", "cpu")

HERE = os.path.dirname(os.path.abspath(__file__))


def build_alignment_fasta(path: str) -> None:
    """60 samples x 200 loci: planted couplings, gaps, low-MAF columns,
    duplicate samples (exercises sample reweighting)."""
    from spydrpick_jax.core.alignment import Alignment
    from spydrpick_jax.io.fasta import write_fasta

    rng = np.random.default_rng(1234)
    S, L = 60, 200
    base = rng.integers(0, 4, size=(1, L))
    codes = np.repeat(base, S, axis=0)
    mut = rng.random((S, L)) < 0.20
    codes[mut] = rng.integers(0, 4, size=int(mut.sum()))
    # planted couplings: copies with small noise
    codes[:, 150] = codes[:, 20]
    codes[:, 151] = codes[:, 21]
    flip = rng.random(S) < 0.05
    codes[flip, 151] = rng.integers(0, 4, size=int(flip.sum()))
    # a monomorphic and a low-MAF column (filtered out)
    codes[:, 100] = 2
    codes[:, 101] = 3
    codes[0, 101] = 1
    # gaps: a gappy stripe plus a column over the gap threshold
    codes[rng.random((S, L)) < 0.04] = 4
    codes[: int(0.3 * S), 102] = 4
    # duplicate samples -> reweighting has an effect
    codes[50:] = codes[:10]
    write_fasta(
        path,
        Alignment(
            codes=codes.astype(np.uint8),
            sample_names=[f"sample_{i}" for i in range(S)],
            id_string="golden",
            translation=np.arange(L, dtype=np.int64),
            n_original_positions=L,
        ),
    )


def build_alignment2(path: str, mappings: str, weights: str) -> None:
    """Fixture 2: sparse genome mappings (circular distance over a
    600-position genome), user-supplied sample weights, explicit MI
    threshold — the flag paths fixture 1 does not reach."""
    from spydrpick_jax.core.alignment import Alignment
    from spydrpick_jax.io.fasta import write_fasta

    rng = np.random.default_rng(4321)
    S, L = 50, 160
    base = rng.integers(0, 4, size=(1, L))
    codes = np.repeat(base, S, axis=0)
    mut = rng.random((S, L)) < 0.25
    codes[mut] = rng.integers(0, 4, size=int(mut.sum()))
    codes[:, 120] = codes[:, 30]          # planted coupling
    codes[rng.random((S, L)) < 0.05] = 4  # gaps
    write_fasta(
        path,
        Alignment(
            codes=codes.astype(np.uint8),
            sample_names=[f"s{i}" for i in range(S)],
            id_string="golden2",
            translation=np.arange(L, dtype=np.int64),
            n_original_positions=L,
        ),
    )
    # sparse original positions over a 600-position circular genome
    with open(mappings, "w") as f:
        f.write(" ".join(str(3 * i + 17) for i in range(L)))
    # user-supplied weights (bypasses the clustering path)
    w = (rng.random(S) * 0.8 + 0.2).round(4)
    with open(weights, "w") as f:
        f.write(" ".join(str(x) for x in w))


GOLDEN2_ARGS = [
    "--seed", "11",
    "--mi-threshold", "0.08",
    "--ld-threshold", "15",
    "--genome-size", "600",
    "--output-sample-distance-matrix",
]


def main() -> None:
    from spydrpick_jax.cli import main as cli_main

    fasta = os.path.join(HERE, "golden.fasta")
    build_alignment_fasta(fasta)

    expected = os.path.join(HERE, "expected")
    if os.path.isdir(expected):
        shutil.rmtree(expected)
    os.makedirs(expected)

    tmp = tempfile.mkdtemp()
    rc = cli_main([
        fasta,
        "--seed", "7",
        "--ld-threshold", "10",
        "--mi-values", "1500",
        "--output-state-frequencies",
        "--output-sample-weights",
        "--output-dir", tmp,
    ])
    assert rc in (0, None), rc
    for name in sorted(os.listdir(tmp)):
        shutil.copy(os.path.join(tmp, name), os.path.join(expected, name))
        print("froze", name)
    shutil.rmtree(tmp)

    # fixture 2
    fasta2 = os.path.join(HERE, "golden2.fasta")
    mappings = os.path.join(HERE, "golden2.mappings")
    weights = os.path.join(HERE, "golden2.weights")
    build_alignment2(fasta2, mappings, weights)
    expected2 = os.path.join(HERE, "expected2")
    if os.path.isdir(expected2):
        shutil.rmtree(expected2)
    os.makedirs(expected2)
    tmp = tempfile.mkdtemp()
    rc = cli_main([
        fasta2, *GOLDEN2_ARGS,
        "--mappings-list", mappings,
        "--sample-weights", weights,
        "--output-dir", tmp,
    ])
    assert rc in (0, None), rc
    for name in sorted(os.listdir(tmp)):
        shutil.copy(os.path.join(tmp, name), os.path.join(expected2, name))
        print("froze", name)
    shutil.rmtree(tmp)


if __name__ == "__main__":
    main()
