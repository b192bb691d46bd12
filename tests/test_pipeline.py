"""End-to-end pipeline + CLI + output-format tests."""

import numpy as np
import pytest

from spydrpick_jax.io.fasta import write_fasta
from spydrpick_jax.pipeline import PipelineOptions, run_pipeline

from tests.conftest import random_alignment


def _write_test_fasta(tmp_path, al, name="aln.fasta"):
    p = tmp_path / name
    write_fasta(p, al)
    return p


@pytest.fixture
def fasta_path(tmp_path):
    al = random_alignment(n_samples=50, n_loci=80, seed=30, gap_frac=0.05)
    return _write_test_fasta(tmp_path, al)


def test_pipeline_end_to_end(fasta_path, tmp_path):
    opts = PipelineOptions(
        alignmentfile=str(fasta_path),
        mi_threshold=0.05,
        output_dir=str(tmp_path),
        seed=3,
    )
    res = run_pipeline(opts)
    assert res.edges.n_edges > 0
    # descending MI order
    assert (np.diff(res.edges.mi) <= 1e-12).all()
    # couplings file exists and row format matches README:
    # pos1 pos2 distance flag mi
    lines = open(res.couplings_path).read().strip().split("\n")
    assert len(lines) == res.edges.n_edges
    first = lines[0].split()
    assert len(first) == 5
    int(first[0]); int(first[1]); int(first[2]); assert first[3] in "01"
    float(first[4])
    # 1-based indexing by default: min position >= 1
    p1 = np.array([int(l.split()[0]) for l in lines])
    assert p1.min() >= 1
    # outliers file: 8 columns
    olines = open(res.outliers_path).read().strip().split("\n")
    if olines and olines[0]:
        assert len(olines[0].split()) == 8


def test_pipeline_stage_timings(fasta_path, tmp_path):
    """run_pipeline fills per-stage wall times (the reference driver's
    cputimer prints, SpydrPick.cpp:157-161) incl. nested sweep phases
    and ARACNE stage times (ARACNE.hpp:499-523)."""
    tm: dict = {}
    opts = PipelineOptions(
        alignmentfile=str(fasta_path), mi_threshold=0.05,
        output_dir=str(tmp_path), seed=3,
    )
    run_pipeline(opts, timings=tm)
    for k in ("preprocess_s", "engine_build_s", "threshold_s", "sweep_s",
              "sort_s", "aracne_s", "write_s", "total_s"):
        assert k in tm and tm[k] >= 0, k
    assert "compute_s" in tm["sweep_phases"]
    assert tm["aracne_phases"]["edges"] > 0
    assert tm["total_s"] >= tm["sweep_s"]


def test_pipeline_auto_threshold_small(fasta_path, tmp_path):
    opts = PipelineOptions(
        alignmentfile=str(fasta_path),
        mi_threshold=-1.0,
        mi_values=50,
        mi_threshold_pairs=100,
        mi_threshold_iterations=3,
        output_dir=str(tmp_path),
    )
    res = run_pipeline(opts)
    assert res.mi_threshold > 0
    assert res.edges.n_edges > 0


def test_pipeline_no_aracne_flags_zero(fasta_path, tmp_path):
    opts = PipelineOptions(
        alignmentfile=str(fasta_path), mi_threshold=0.05,
        no_aracne=True, output_dir=str(tmp_path),
    )
    res = run_pipeline(opts)
    assert (res.flags == 0).all()  # SpydrPick.cpp:406-421 caveat


def test_pipeline_deterministic(fasta_path, tmp_path):
    kw = dict(
        alignmentfile=str(fasta_path), mi_threshold=-1.0, mi_values=50,
        mi_threshold_pairs=100, mi_threshold_iterations=3, seed=9,
    )
    r1 = run_pipeline(PipelineOptions(output_dir=str(tmp_path / "a"), **kw),
                      write_outputs=False)
    r2 = run_pipeline(PipelineOptions(output_dir=str(tmp_path / "b"), **kw),
                      write_outputs=False)
    assert r1.mi_threshold == r2.mi_threshold
    np.testing.assert_array_equal(r1.edges.ipos, r2.edges.ipos)
    np.testing.assert_array_equal(r1.edges.mi, r2.edges.mi)


def test_pipeline_include_exclude(tmp_path):
    al = random_alignment(n_samples=40, n_loci=30, seed=31)
    p = _write_test_fasta(tmp_path, al)
    inc = tmp_path / "inc.txt"
    inc.write_text(" ".join(str(i) for i in range(1, 21)))  # 1-based, keep 20
    exc = tmp_path / "exc.txt"
    exc.write_text("1 2")  # 1-based, drop original positions 0,1
    opts = PipelineOptions(
        alignmentfile=str(p), mi_threshold=0.0, no_filter_alignment=True,
        include_list=str(inc), exclude_list=str(exc),
        no_sample_reweighting=True, output_dir=str(tmp_path),
    )
    res = run_pipeline(opts, write_outputs=False)
    assert res.alignment.n_loci == 18
    assert res.alignment.translation.min() == 2


def test_pipeline_sample_weights_file(tmp_path):
    al = random_alignment(n_samples=10, n_loci=20, seed=32)
    p = _write_test_fasta(tmp_path, al)
    wf = tmp_path / "w.txt"
    wf.write_text(" ".join(["0.25"] * 10))
    opts = PipelineOptions(
        alignmentfile=str(p), mi_threshold=0.0, no_filter_alignment=True,
        sample_weights=str(wf), output_dir=str(tmp_path),
    )
    res = run_pipeline(opts, write_outputs=False)
    np.testing.assert_allclose(res.alignment.weights, 0.25)


def test_aux_outputs(fasta_path, tmp_path):
    opts = PipelineOptions(
        alignmentfile=str(fasta_path), mi_threshold=0.1,
        output_state_frequencies=True, output_sample_weights=True,
        output_sample_distance_matrix=True, output_filtered_alignment=True,
        output_dir=str(tmp_path),
    )
    run_pipeline(opts)
    names = {p.name for p in tmp_path.iterdir()}
    assert any(".state_frequencies" in n for n in names)
    assert any(".weights" in n for n in names)
    assert any(".distance_matrix" in n for n in names)
    assert any(".filtered.fasta" in n for n in names)


def test_cli_version_and_parsing(capsys):
    from spydrpick_jax.cli import main

    assert main(["--version"]) == 0
    out = capsys.readouterr().out
    assert "spydrpick-jax version" in out
    assert main([]) == 1  # no alignment file -> error


def test_cli_full_run(fasta_path, tmp_path):
    from spydrpick_jax.cli import main

    rc = main([
        str(fasta_path), "--mi-threshold", "0.1",
        "--output-dir", str(tmp_path), "-v",
    ])
    assert rc == 0
    assert any("spydrpick_couplings" in p.name for p in tmp_path.iterdir())


def test_pipeline_nothing_to_do_exits_zero(tmp_path):
    """Every column filtered out -> 'nothing to do', exit SUCCESS
    (reference semantics, SpydrPick.cpp:257-265)."""
    # monomorphic alignment: no column has >1 non-gap allele
    al = random_alignment(n_samples=20, n_loci=10, seed=1)
    al.codes[:] = 2
    p = _write_test_fasta(tmp_path, al, "mono.fasta")
    opts = PipelineOptions(alignmentfile=str(p), mi_threshold=0.05,
                           output_dir=str(tmp_path))
    with pytest.raises(SystemExit) as e:
        run_pipeline(opts)
    assert e.value.code in (0, None)


def test_pipeline_tiny_alignment_under_tile(tmp_path):
    """L far below the tile size (512 default) must pad cleanly through
    the whole pipeline."""
    al = random_alignment(n_samples=30, n_loci=5, seed=2)
    p = _write_test_fasta(tmp_path, al, "tiny.fasta")
    opts = PipelineOptions(alignmentfile=str(p), mi_threshold=0.0,
                           no_filter_alignment=True,
                           no_sample_reweighting=True,
                           output_dir=str(tmp_path))
    res = run_pipeline(opts)
    assert 0 < res.edges.n_edges <= 5 * 4 // 2
    lines = open(res.couplings_path).read().strip().split("\n")
    assert len(lines) == res.edges.n_edges


def test_pipeline_auto_threshold_too_small_is_clean_error(tmp_path):
    """Auto threshold on an alignment with fewer possible pairs than
    the target count must raise the explanatory ValueError, not an
    opaque partition error."""
    al = random_alignment(n_samples=30, n_loci=8, seed=3)
    p = _write_test_fasta(tmp_path, al, "small.fasta")
    opts = PipelineOptions(alignmentfile=str(p), mi_threshold=-1.0,
                           no_filter_alignment=True,
                           output_dir=str(tmp_path))
    with pytest.raises(ValueError, match="mi-threshold"):
        run_pipeline(opts)
