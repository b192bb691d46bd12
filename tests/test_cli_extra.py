"""Additional CLI / output-surface tests: mappings list, genome size,
outlier-node FASTA contents, plot generation."""

import numpy as np

from spydrpick_jax.io.fasta import read_fasta, write_fasta
from spydrpick_jax.pipeline import PipelineOptions, run_pipeline

from tests.conftest import random_alignment


def test_mappings_list_and_genome_size(tmp_path):
    """--mappings-list remaps output positions; --genome-size sets the
    circular wrap (reference README 'Advanced usage')."""
    al = random_alignment(n_samples=40, n_loci=20, seed=80)
    p = tmp_path / "a.fasta"
    write_fasta(p, al)
    mp = tmp_path / "map.txt"
    orig = (np.arange(20) * 50 + 7).astype(int)  # sparse original positions
    mp.write_text(" ".join(str(x + 1) for x in orig))  # 1-based input
    opts = PipelineOptions(
        alignmentfile=str(p), mi_threshold=0.0, no_filter_alignment=True,
        mappings_list=str(mp), genome_size=2000,
        no_sample_reweighting=True, output_dir=str(tmp_path),
    )
    res = run_pipeline(opts)
    lines = open(res.couplings_path).read().strip().split("\n")
    p1 = np.array([int(l.split()[0]) for l in lines])
    p2 = np.array([int(l.split()[1]) for l in lines])
    d = np.array([int(l.split()[2]) for l in lines])
    # output positions are translated originals (1-based)
    assert set(p1) | set(p2) <= set((orig + 1).tolist())
    # distances use the circular genome size
    raw = np.abs(p1 - p2)
    np.testing.assert_array_equal(d, np.minimum(raw, 2000 - raw))


def test_outlier_node_fasta_contents(tmp_path):
    """The outlier-node FASTA holds exactly the outlier-edge columns
    (SpydrPick.cpp:488-503)."""
    rng = np.random.default_rng(81)
    S, L = 80, 40
    codes = rng.integers(0, 4, size=(S, L)).astype(np.uint8)
    codes[:, 30] = codes[:, 5]  # strong pair -> outliers
    al = random_alignment(2, 2)
    from spydrpick_jax.core.alignment import Alignment

    al = Alignment(codes, [f"s{i}" for i in range(S)], "t",
                   np.arange(L), L)
    p = tmp_path / "t.fasta"
    write_fasta(p, al)
    opts = PipelineOptions(
        alignmentfile=str(p), mi_threshold=0.05, no_filter_alignment=True,
        no_sample_reweighting=True, output_dir=str(tmp_path),
    )
    res = run_pipeline(opts)
    fastas = list(tmp_path.glob("*.outlier_nodes.fasta"))
    if res.edges.mi.max() >= res.outlier_threshold:
        assert fastas, "outlier nodes fasta expected"
        sub = read_fasta(fastas[0])
        # planted pair columns must be among the outlier nodes
        mask = res.edges.mi >= res.outlier_threshold
        nodes = np.unique(np.concatenate(
            [res.edges.ipos[mask], res.edges.jpos[mask]]))
        assert sub.n_loci == len(nodes)
        np.testing.assert_array_equal(sub.codes, al.codes[:, nodes])


def test_plot_tool(tmp_path):
    al = random_alignment(n_samples=40, n_loci=30, seed=82)
    p = tmp_path / "a.fasta"
    write_fasta(p, al)
    res = run_pipeline(PipelineOptions(
        alignmentfile=str(p), mi_threshold=0.0, no_filter_alignment=True,
        no_sample_reweighting=True, output_dir=str(tmp_path)))
    from spydrpick_jax.plot import main as plot_main

    rc = plot_main([res.couplings_path, "--out", str(tmp_path / "plot.png"),
                    "--ld-dist", "5", "--outlier-threshold",
                    str(res.outlier_threshold)])
    assert rc == 0
    assert (tmp_path / "plot.png").exists()


def test_cli_error_paths(capsys):
    """Missing alignment file and no-args runs exit 1 with a clear
    message (reference exits via po error paths, SpydrPick.cpp:143-154)."""
    from spydrpick_jax.cli import main

    assert main([]) == 1
    assert main(["/nonexistent-alignment.fasta"]) == 1
    err = capsys.readouterr().err
    assert "ERROR" in err


def test_cli_aracne_outputfile_accepted(tmp_path):
    """--aracne-outputfile is registered (unused) in the reference's
    combined binary (ARACNE_options.cpp:180); we accept-and-ignore it
    like its block/grouping-size siblings."""
    from spydrpick_jax.cli import main

    al = random_alignment(n_samples=30, n_loci=24, seed=83)
    fasta = tmp_path / "a.fasta"
    write_fasta(str(fasta), al)
    rc = main([str(fasta), "--mi-threshold", "0.1", "--seed", "1",
               "--no-filter-alignment", "--no-sample-reweighting",
               "--aracne-outputfile", "custom-aracne.out",
               "--output-dir", str(tmp_path), "--jax-cache-dir", "none"])
    assert rc == 0
    assert not (tmp_path / "custom-aracne.out").exists()  # ignored, as in the reference


def test_fasta_junk_preamble_rejected(tmp_path):
    """A file whose first non-whitespace byte is not '>' is rejected with
    a clear message (advisor round-4 finding)."""
    import pytest

    from spydrpick_jax.io.fasta import _numpy_parse

    p = tmp_path / "junk.fasta"
    p.write_bytes(b"junk preamble\n>s1\nACGT\n")
    with pytest.raises(ValueError, match="does not start with a FASTA header"):
        _numpy_parse(p)


def test_cli_jax_cache_flag(tmp_path):
    """--jax-cache-dir points the persistent XLA compilation cache at the
    given directory (repeat CLI runs skip jit compiles); 'none' disables."""
    import jax

    from spydrpick_jax.cli import main

    al = random_alignment(n_samples=40, n_loci=64)
    fasta = tmp_path / "cache.fasta"
    write_fasta(str(fasta), al)
    cache = tmp_path / "jit-cache"
    rc = main([str(fasta), "--ld-threshold", "20", "--seed", "3",
               "--mi-threshold", "0.1",
               "--output-dir", str(tmp_path), "--jax-cache-dir", str(cache)])
    assert rc == 0
    assert jax.config.jax_compilation_cache_dir == str(cache)


def test_cli_sharded_matches_single_device(tmp_path):
    """Full CLI run with --sharded on the virtual 8-device mesh produces
    byte-identical couplings/outliers files to the single-device CLI —
    the user-facing contract of the distributed backend (the engine-level
    twin lives in tests/test_sharding.py)."""
    import filecmp

    from spydrpick_jax.cli import main

    al = random_alignment(n_samples=48, n_loci=96, seed=29, gap_frac=0.08)
    fasta = tmp_path / "sh.fasta"
    write_fasta(str(fasta), al)
    d1 = tmp_path / "single"
    variants = {
        tmp_path / "rows": ["--sharded"],                  # 1-D row mesh
        tmp_path / "2d": ["--sharded", "--sample-shards", "2"],  # 2-D mesh
    }
    for d, extra in [(d1, [])] + list(variants.items()):
        rc = main([str(fasta), "--ld-threshold", "10", "--seed", "5",
                   "--mi-threshold", "0.05",
                   "--output-dir", str(d), "--jax-cache-dir", "none"]
                  + extra)
        assert rc == 0
    files1 = sorted(p.name for p in d1.iterdir())
    assert any("couplings" in f for f in files1)
    for d2 in variants:
        assert sorted(p.name for p in d2.iterdir()) == files1
        for name in files1:
            assert filecmp.cmp(d1 / name, d2 / name, shallow=False), (
                d2.name, name)
