"""FASTA / loci-list IO tests."""

import numpy as np
import pytest

from spydrpick_jax.core.alphabet import encode_bytes
from spydrpick_jax.io.fasta import read_fasta, write_fasta
from spydrpick_jax.io.loci import parse_loci_list, parse_value_list


def test_encode_semantics():
    # A,C,G,T map to 0..3 case-insensitively; everything else is gap=4
    # (reference README.md:42)
    codes = encode_bytes(b"ACGTacgtNn-. X")
    assert codes.tolist() == [0, 1, 2, 3, 0, 1, 2, 3, 4, 4, 4, 4, 4, 4]


def test_fasta_roundtrip(tmp_path):
    p = tmp_path / "a.fasta"
    p.write_text(">s1 desc\nACGT-\nACGTN\n>s2\nacgtn\nACGT.\n")
    al = read_fasta(p)
    assert al.n_samples == 2
    assert al.n_loci == 10
    assert al.sample_names == ["s1", "s2"]
    assert al.codes[0].tolist() == [0, 1, 2, 3, 4, 0, 1, 2, 3, 4]
    assert al.codes[1].tolist() == [0, 1, 2, 3, 4, 0, 1, 2, 3, 4]
    out = tmp_path / "out.fasta"
    write_fasta(out, al)
    al2 = read_fasta(out)
    assert np.array_equal(al.codes, al2.codes)
    assert al2.sample_names == al.sample_names


def test_fasta_unaligned_raises(tmp_path):
    p = tmp_path / "bad.fasta"
    p.write_text(">a\nACGT\n>b\nACG\n")
    with pytest.raises(ValueError, match="unaligned"):
        read_fasta(p)


def test_fasta_mappings(tmp_path):
    p = tmp_path / "a.fasta"
    p.write_text(">a\nACGT\n")
    al = read_fasta(p, mappings=np.array([10, 20, 30, 400]))
    assert al.translation.tolist() == [10, 20, 30, 400]
    assert al.n_original_positions == 401
    al2 = read_fasta(p, mappings=np.array([10, 20, 30, 400]), genome_size=1000)
    assert al2.n_original_positions == 1000


def test_loci_and_value_lists(tmp_path):
    p = tmp_path / "loci.txt"
    p.write_text("1 5\n9\t12\n")
    assert parse_loci_list(p, indexing_base=1).tolist() == [0, 4, 8, 11]
    v = tmp_path / "vals.txt"
    v.write_text("0.5 1.25\n2.0\n")
    assert parse_value_list(v).tolist() == [0.5, 1.25, 2.0]


def test_unique_path_increments(tmp_path):
    """Auto-uniquified output names (reference get_unique_ofstream,
    SpydrPick.cpp:429,459; gwes_plot.r:71-76 expects .N suffixes)."""
    from spydrpick_jax.utils.uniquefile import unique_path

    base = tmp_path / "out.txt"
    p1 = unique_path(str(base))
    assert str(p1) == str(base)
    base.write_text("x")
    p2 = unique_path(str(base))
    assert str(p2) == str(base) + ".1"
    (tmp_path / "out.txt.1").write_text("y")
    p3 = unique_path(str(base))
    assert str(p3) == str(base) + ".2"


def test_native_formatter_matches_python_fallback(tmp_path):
    """The OpenMP row formatter and the Python fallback must produce
    byte-identical couplings files (incl. %.6f rounding ties)."""
    import io

    import numpy as np

    from spydrpick_jax.engine.solver import EdgeSet
    from spydrpick_jax.io.writers import write_couplings
    from tests.conftest import random_alignment

    al = random_alignment(20, 50, seed=77)
    rng = np.random.default_rng(7)
    E = 5000
    i = rng.integers(0, 49, E)
    j = i + rng.integers(1, 50 - np.maximum(i, 1), E).clip(1)
    j = np.minimum(j, 49)
    keep = j > i
    i, j = i[keep], j[keep]
    # exercise rounding ties: exact binary values + random
    mi = np.concatenate([rng.random(len(i) - 3),
                         [0.1234565, 0.0000005, 1.5]])[: len(i)]
    edges = EdgeSet(i.astype(np.int64), j.astype(np.int64),
                    mi.astype(np.float64), mi.astype(np.float64),
                    np.zeros(50))
    flags = rng.integers(0, 2, len(i)).astype(np.uint8)
    a, b = io.StringIO(), io.StringIO()
    write_couplings(a, edges, flags, al, use_native=True)
    write_couplings(b, edges, flags, al, use_native=False)
    assert a.getvalue() == b.getvalue()
    assert a.getvalue().count("\n") == len(i)


def test_sort_desc_tie_semantics():
    """sort_desc's argsort+tie-fix must equal the reference 3-key
    lexsort exactly, including long equal-MI runs."""
    import numpy as np

    from spydrpick_jax.engine.solver import EdgeSet

    rng = np.random.default_rng(3)
    E = 20000
    mi = rng.choice([0.5, 0.25, 0.125, rng.random()], E)  # heavy ties
    mi += rng.random(E) * (rng.random(E) < 0.3)           # mixed uniques
    i = rng.integers(0, 1000, E).astype(np.int64)
    j = i + 1 + rng.integers(0, 100, E).astype(np.int64)
    e = EdgeSet(i, j, mi, mi * 0.5, np.zeros(4))
    got = e.sort_desc()
    order = np.lexsort((j, i, -mi))
    np.testing.assert_array_equal(got.mi, mi[order])
    np.testing.assert_array_equal(got.ipos, i[order])
    np.testing.assert_array_equal(got.jpos, j[order])
    np.testing.assert_array_equal(got.mi_wog, (mi * 0.5)[order])


def test_empty_fasta_file_reports_empty_not_missing(tmp_path):
    """A zero-length file must raise 'empty FASTA file', not
    FileNotFoundError (the native open_map rejects missing and empty
    files with the same code)."""
    import pytest

    from spydrpick_jax.io.fasta import read_fasta

    p = tmp_path / "empty.fasta"
    p.write_bytes(b"")
    with pytest.raises(ValueError, match="empty FASTA file"):
        read_fasta(p)
    with pytest.raises(FileNotFoundError):
        read_fasta(tmp_path / "missing.fasta")
