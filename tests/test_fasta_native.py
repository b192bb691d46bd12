"""Native FASTA parser: parity with the NumPy parser + perf sanity."""

import numpy as np
import pytest

from spydrpick_jax.io import fasta

try:
    from spydrpick_jax.native import fasta_native

    fasta_native._load()
    HAVE_NATIVE = True
except Exception:  # pragma: no cover
    HAVE_NATIVE = False

pytestmark = pytest.mark.skipif(not HAVE_NATIVE, reason="g++ toolchain unavailable")


def test_native_matches_numpy(tmp_path):
    p = tmp_path / "a.fasta"
    p.write_text(
        ">s1 some description\nACGT-\nacgtN\n\n>s2\nACGTA\nCGTAX\n>s3\nacgta\ncgtan\n"
    )
    nc, nn = fasta_native.parse(p)
    pc, pn = fasta._numpy_parse(p)
    np.testing.assert_array_equal(nc, pc)
    assert nn == pn == ["s1", "s2", "s3"]


def test_native_random_roundtrip(tmp_path):
    from spydrpick_jax.io.fasta import write_fasta
    from tests.conftest import random_alignment

    al = random_alignment(37, 211, seed=70, gap_frac=0.2)
    p = tmp_path / "r.fasta"
    write_fasta(p, al)
    codes, names = fasta_native.parse(p)
    np.testing.assert_array_equal(codes, al.codes)
    assert names == al.sample_names


def test_native_error_paths(tmp_path):
    with pytest.raises(FileNotFoundError):
        fasta_native.parse(tmp_path / "missing.fasta")
    bad = tmp_path / "bad.fasta"
    bad.write_text("no header here\n")
    with pytest.raises(ValueError, match="malformed"):
        fasta_native.parse(bad)
    unal = tmp_path / "unal.fasta"
    unal.write_text(">a\nACGT\n>b\nACG\n")
    with pytest.raises(ValueError, match="unaligned"):
        fasta_native.parse(unal)


def test_native_large_parallel(tmp_path):
    rng = np.random.default_rng(0)
    S, L = 200, 5000
    rows = []
    syms = np.frombuffer(b"ACGT-", dtype=np.uint8)
    want = rng.integers(0, 5, size=(S, L)).astype(np.uint8)
    with open(tmp_path / "big.fasta", "wb") as f:
        for s in range(S):
            f.write(b">seq_%d\n" % s)
            f.write(syms[want[s]].tobytes() + b"\n")
    codes, names = fasta_native.parse(tmp_path / "big.fasta")
    np.testing.assert_array_equal(codes, want)
    assert names[0] == "seq_0" and names[-1] == f"seq_{S-1}"
