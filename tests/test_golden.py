"""Golden end-to-end fixture: the WHOLE output surface, byte-for-byte.

tests/golden/expected/ holds frozen outputs of a full CLI run on a
small alignment with planted couplings, gaps, filtered columns, and
duplicate samples (regenerate with ``python tests/golden/make_golden.py``
— only when an intentional output-surface change is made).

This locks the couplings/outliers/weights/state-frequency formats
(reference: README.md:60-62, SpydrPick.hpp:89-129) and the numeric
pipeline itself against regressions while perf work churns the engine.
"""

import os

import pytest

from spydrpick_jax.cli import main as cli_main

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
EXPECTED = os.path.join(GOLDEN, "expected")

ARGS = [
    os.path.join(GOLDEN, "golden.fasta"),
    "--seed", "7",
    "--ld-threshold", "10",
    "--mi-values", "1500",
    "--output-state-frequencies",
    "--output-sample-weights",
]


def test_golden_outputs_byte_identical(tmp_path):
    rc = cli_main(ARGS + ["--output-dir", str(tmp_path)])
    assert rc in (0, None)
    expected_files = sorted(os.listdir(EXPECTED))
    got_files = sorted(os.listdir(tmp_path))
    assert got_files == expected_files
    for name in expected_files:
        with open(os.path.join(EXPECTED, name), "rb") as f:
            want = f.read()
        with open(tmp_path / name, "rb") as f:
            got = f.read()
        assert got == want, f"{name} diverged from the golden fixture"


@pytest.mark.parametrize("tile", [8, 32])
def test_golden_couplings_tile_invariant(tmp_path, tile):
    """The couplings file must not depend on engine tiling."""
    rc = cli_main(ARGS + ["--output-dir", str(tmp_path), "--tile", str(tile)])
    assert rc in (0, None)
    name = "golden.60x198.spydrpick_couplings.1-based.1472edges"
    with open(os.path.join(EXPECTED, name), "rb") as f:
        want = f.read()
    with open(tmp_path / name, "rb") as f:
        got = f.read()
    assert got == want


def test_golden2_outputs_byte_identical(tmp_path):
    """Fixture 2: sparse --mappings-list over a circular --genome-size,
    user-supplied --sample-weights, explicit --mi-threshold, distance
    matrix dump — the flag paths fixture 1 does not reach."""
    from tests.golden.make_golden import GOLDEN2_ARGS

    expected2 = os.path.join(GOLDEN, "expected2")
    rc = cli_main([
        os.path.join(GOLDEN, "golden2.fasta"), *GOLDEN2_ARGS,
        "--mappings-list", os.path.join(GOLDEN, "golden2.mappings"),
        "--sample-weights", os.path.join(GOLDEN, "golden2.weights"),
        "--output-dir", str(tmp_path),
    ])
    assert rc in (0, None)
    expected_files = sorted(os.listdir(expected2))
    assert sorted(os.listdir(tmp_path)) == expected_files
    for name in expected_files:
        with open(os.path.join(expected2, name), "rb") as f:
            want = f.read()
        with open(tmp_path / name, "rb") as f:
            got = f.read()
        assert got == want, f"{name} diverged from golden fixture 2"


def test_golden2_codes_storage_byte_identical(tmp_path):
    """Codes-resident storage must reproduce fixture 2 byte-for-byte
    (explicit --mi-threshold: no tournament, whose accumulation order
    differs at ULP level between storage modes)."""
    from tests.golden.make_golden import GOLDEN2_ARGS

    expected2 = os.path.join(GOLDEN, "expected2")
    rc = cli_main([
        os.path.join(GOLDEN, "golden2.fasta"), *GOLDEN2_ARGS,
        "--mappings-list", os.path.join(GOLDEN, "golden2.mappings"),
        "--sample-weights", os.path.join(GOLDEN, "golden2.weights"),
        "--onehot-storage", "codes",
        "--output-dir", str(tmp_path),
    ])
    assert rc in (0, None)
    for name in sorted(os.listdir(expected2)):
        with open(os.path.join(expected2, name), "rb") as f:
            want = f.read()
        with open(tmp_path / name, "rb") as f:
            got = f.read()
        assert got == want, f"{name} diverged under codes storage"
