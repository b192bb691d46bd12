"""Sweep checkpoint/resume tests (new capability vs the reference,
SURVEY §5: the reference run is monolithic with no resume)."""

import os

import numpy as np

from spydrpick_jax.engine import checkpoint as ck
from spydrpick_jax.engine.solver import EngineConfig, MIEngine

from tests.conftest import random_alignment


def test_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "sweep.ckpt")
    c = ck.SweepCheckpoint(
        params_key="k1",
        done_rows={0, 16, 32},
        colmax=np.array([0.1, 0.2]),
        ipos=[np.array([1, 2])],
        jpos=[np.array([3, 4])],
        mi=[np.array([0.5, 0.6])],
        mi_wog=[np.array([0.4, 0.55])],
    )
    ck.save(path, c)
    got = ck.load(path, "k1")
    assert got is not None
    assert got.done_rows == {0, 16, 32}
    np.testing.assert_array_equal(got.colmax, c.colmax)
    np.testing.assert_array_equal(got.ipos[0], [1, 2])
    # mismatched parameters -> ignored
    assert ck.load(path, "other-key") is None
    assert ck.load(str(tmp_path / "missing.ckpt"), "k1") is None


def test_sweep_resume_matches_clean_run(tmp_path):
    al = random_alignment(n_samples=50, n_loci=64, seed=50, gap_frac=0.1)
    engine = MIEngine(al, EngineConfig(tile=8))
    clean = engine.sweep(0.02).sort_desc()

    # simulate a killed run: checkpoint after every row, stop after 3 rows
    path = str(tmp_path / "sweep.ckpt")
    key = ck.params_key(engine.statics, 0.02)
    partial_rows = [0, 8, 16]
    colmax = np.full(al.n_loci, -np.inf)
    all_i, all_j, all_mi, all_wog = [], [], [], []
    import jax
    import jax.numpy as jnp

    for i0 in partial_rows:
        ci, cj, vals, wogs, ipos, jpos, count, lines = jax.tree.map(
            np.asarray,
            engine._row_sweep(engine.data, i0=jnp.asarray(i0, jnp.int32),
                              threshold=jnp.asarray(0.02, jnp.float32)),
        )
        keep = jpos > ipos  # line-packed window: drop zero-pad holes
        all_i.append(ipos[keep].astype(np.int64))
        all_j.append(jpos[keep].astype(np.int64))
        all_mi.append(vals[keep].astype(np.float64))
        all_wog.append(wogs[keep].astype(np.float64))
        hi = min(i0 + 8, al.n_loci)
        colmax[i0:hi] = np.maximum(colmax[i0:hi], ci[: hi - i0])
        colmax = np.maximum(colmax, cj[: al.n_loci])
    ck.save(path, ck.SweepCheckpoint(key, set(partial_rows), colmax,
                                     all_i, all_j, all_mi, all_wog))

    resumed = engine.sweep(0.02, checkpoint_path=path).sort_desc()
    assert resumed.n_edges == clean.n_edges
    np.testing.assert_array_equal(resumed.ipos, clean.ipos)
    np.testing.assert_array_equal(resumed.jpos, clean.jpos)
    np.testing.assert_allclose(resumed.mi, clean.mi, rtol=1e-6)
    np.testing.assert_allclose(resumed.colmax, clean.colmax, rtol=1e-6)
    # completed run removes the checkpoint
    import os

    assert not os.path.exists(path)


def test_overflow_checkpoint_resume_matches_clean(tmp_path):
    """Overflow -> checkpoint -> kill -> resume must equal a clean run.

    Round-1 bug: a block-row whose edge count exceeded edge_capacity was
    persisted in the checkpoint with its TRUNCATED store contents and
    listed in done_rows, so a resumed run silently lost every edge beyond
    the per-row window.  The fix drops truncated edges from the saved
    arrays and leaves overflowed rows out of done_rows (re-swept and
    re-extracted on resume).
    """
    al = random_alignment(n_samples=40, n_loci=64, seed=52, gap_frac=0.05)
    # threshold -1 keeps every pair: early block-rows have ~476 edges,
    # far above edge_capacity=128 -> guaranteed overflow
    cfg = EngineConfig(tile=8, edge_capacity=128, rows_per_dispatch=1)
    engine = MIEngine(al, cfg)
    clean = engine.sweep(-1.0).sort_desc()
    assert clean.n_edges == 64 * 63 // 2  # sanity: all pairs kept

    class Killed(Exception):
        pass

    calls = {"n": 0}

    def progress(r0, r1, n_edges, dt):
        calls["n"] += 1
        if calls["n"] == 3:  # die mid-sweep, after 2 checkpointed groups
            raise Killed

    path = str(tmp_path / "ov.ckpt")
    engine2 = MIEngine(al, cfg)
    try:
        engine2.sweep(-1.0, progress=progress, checkpoint_path=path,
                      checkpoint_every=1)
        raise AssertionError("progress kill did not fire")
    except Killed:
        pass
    assert os.path.exists(path)
    # the saved checkpoint must not claim overflowed rows as done
    saved = ck.load(path, ck.params_key(engine2.statics, -1.0))
    assert saved is not None
    assert 0 not in saved.done_rows  # block-row 0 overflowed (476 > 128)

    resumed = MIEngine(al, cfg).sweep(
        -1.0, checkpoint_path=path).sort_desc()
    assert resumed.n_edges == clean.n_edges
    np.testing.assert_array_equal(resumed.ipos, clean.ipos)
    np.testing.assert_array_equal(resumed.jpos, clean.jpos)
    np.testing.assert_allclose(resumed.mi, clean.mi, rtol=1e-6)
    np.testing.assert_allclose(resumed.colmax, clean.colmax, rtol=1e-6)


def test_checkpoint_written_during_sweep(tmp_path):
    al = random_alignment(n_samples=40, n_loci=64, seed=51)
    engine = MIEngine(al, EngineConfig(tile=8))
    path = str(tmp_path / "s.ckpt")
    engine.sweep(0.05, checkpoint_path=path, checkpoint_every=2)
    # file removed after successful completion
    import os

    assert not os.path.exists(path)


def test_cli_checkpoint_resume_outputs_match(tmp_path):
    """End-to-end CLI resume: a checkpoint written by a partial engine
    run must be picked up by the FULL CLI (same flags -> same params
    key) and produce byte-identical couplings to an uncheckpointed CLI
    run."""
    from spydrpick_jax.io.fasta import write_fasta
    from spydrpick_jax.cli import main as cli_main

    al = random_alignment(n_samples=40, n_loci=64, seed=52, gap_frac=0.1)
    fasta = tmp_path / "cli_ck.fasta"
    write_fasta(str(fasta), al)

    base_args = [str(fasta), "--mi-threshold", "0.05", "--seed", "3",
                 "--no-filter-alignment", "--no-sample-reweighting",
                 "--tile", "8"]
    clean_dir = tmp_path / "clean"
    rc = cli_main(base_args + ["--output-dir", str(clean_dir)])
    assert rc in (0, None)

    # partial checkpoint with the engine the CLI will rebuild: the
    # params key covers statics + threshold, so configs must match
    from spydrpick_jax.io.fasta import read_fasta

    al2 = read_fasta(str(fasta))
    al2.weights = None
    eng = MIEngine(al2, EngineConfig(tile=8, wog_fetch="outliers"))
    assert eng.statics.wog_lazy  # the CLI's production mode
    path = str(tmp_path / "cli.ckpt")
    key = ck.params_key(eng.statics, 0.05)
    ck.save(path, ck.SweepCheckpoint(key, set(), np.full(al2.n_loci, -np.inf),
                                     [], [], [], []))

    resume_dir = tmp_path / "resumed"
    rc = cli_main(base_args + ["--checkpoint", path,
                               "--output-dir", str(resume_dir)])
    assert rc in (0, None)
    clean_files = sorted(os.listdir(clean_dir))
    assert sorted(os.listdir(resume_dir)) == clean_files
    for name in clean_files:
        with open(clean_dir / name, "rb") as f1, open(resume_dir / name, "rb") as f2:
            assert f1.read() == f2.read(), name


def test_row_window_checkpoint_resume_matches_clean(tmp_path):
    """Windowed sweep killed mid-run: a checkpoint may catch a row with
    only SOME of its j-windows swept — those partial rows must be
    dropped from the saved arrays and re-swept on resume (persisting
    them would double- or under-count their windows)."""
    al = random_alignment(n_samples=40, n_loci=96, seed=97, gap_frac=0.1)
    cfg = EngineConfig(tile=8, row_window=24, rows_per_dispatch=2,
                       wog_fetch="full")
    clean = MIEngine(al, cfg).sweep(0.02).sort_desc()

    class Killed(Exception):
        pass

    calls = {"n": 0}

    def progress(r0, r1, n_edges, dt):
        calls["n"] += 1
        if calls["n"] == 5:  # die mid-sweep, partway through the items
            raise Killed

    path = str(tmp_path / "win.ckpt")
    engine2 = MIEngine(al, cfg)
    try:
        engine2.sweep(0.02, progress=progress, checkpoint_path=path,
                      checkpoint_every=3)
        raise AssertionError("progress kill did not fire")
    except Killed:
        pass
    assert os.path.exists(path)
    saved = ck.load(path, ck.params_key(engine2.statics, 0.02))
    assert saved is not None
    # every persisted edge belongs to a row listed as done
    if saved.ipos:
        rows = (saved.ipos[0] // 8) * 8
        assert set(np.unique(rows)) <= saved.done_rows

    resumed = MIEngine(al, cfg).sweep(
        0.02, checkpoint_path=path).sort_desc()
    assert resumed.n_edges == clean.n_edges
    np.testing.assert_array_equal(resumed.ipos, clean.ipos)
    np.testing.assert_array_equal(resumed.jpos, clean.jpos)
    np.testing.assert_allclose(resumed.mi, clean.mi, rtol=1e-6)
    np.testing.assert_allclose(resumed.mi_wog, clean.mi_wog, rtol=1e-6)
    np.testing.assert_allclose(resumed.colmax, clean.colmax, rtol=1e-6)


def test_lazy_wog_checkpoint_resume_matches_full(tmp_path):
    """Checkpoint + lazy wog (the production drain) now compose: a
    killed lazy run resumes and produces the same output surface as an
    uncheckpointed FULL-wog run — exact wog for outlier candidates,
    mi elsewhere.  (Round-2 limitation: checkpoint x lazy was a hard
    error, so checkpointed big runs paid dual compute.)"""
    from spydrpick_jax.engine.outliers import outlier_thresholds

    al = random_alignment(n_samples=50, n_loci=96, seed=53, gap_frac=0.2)
    al.codes[:, 90] = al.codes[:, 9]  # plant an outlier coupling
    full = MIEngine(al, EngineConfig(tile=8, wog_fetch="full")).sweep(
        0.01).sort_desc()

    class Killed(Exception):
        pass

    calls = {"n": 0}

    def progress(r0, r1, n, dt):
        calls["n"] += 1
        if calls["n"] == 3:
            raise Killed

    cfg = EngineConfig(tile=8, wog_fetch="outliers", rows_per_dispatch=2)
    path = str(tmp_path / "lazy.ckpt")
    try:
        MIEngine(al, cfg).sweep(0.01, progress=progress,
                                checkpoint_path=path, checkpoint_every=2)
        raise AssertionError("progress kill did not fire")
    except Killed:
        pass
    assert os.path.exists(path)
    resumed = MIEngine(al, cfg).sweep(0.01, checkpoint_path=path).sort_desc()

    assert resumed.n_edges == full.n_edges
    np.testing.assert_array_equal(resumed.ipos, full.ipos)
    np.testing.assert_array_equal(resumed.jpos, full.jpos)
    np.testing.assert_allclose(resumed.mi, full.mi, rtol=1e-6)
    thr_out, _ = outlier_thresholds(full.colmax)
    cand = full.mi >= thr_out
    assert cand.any()
    np.testing.assert_allclose(resumed.mi_wog[cand], full.mi_wog[cand],
                               rtol=1e-5, atol=1e-7)


def test_lazy_full_checkpoints_not_interchangeable(tmp_path):
    """A lazy snapshot must not resume a full-wog run (placeholders
    would masquerade as exact wog): the params key separates them."""
    al = random_alignment(n_samples=30, n_loci=32, seed=54)
    lazy_eng = MIEngine(al, EngineConfig(tile=8, wog_fetch="outliers"))
    full_eng = MIEngine(al, EngineConfig(tile=8, wog_fetch="full"))
    k_lazy = ck.params_key(lazy_eng.statics, 0.05)
    k_full = ck.params_key(full_eng.statics, 0.05)
    assert k_lazy != k_full
    path = str(tmp_path / "x.ckpt")
    ck.save(path, ck.SweepCheckpoint(k_lazy, set(), np.zeros(32),
                                     [], [], [], []))
    assert ck.load(path, k_full) is None


def test_checkpoint_overflow_raises_before_corrupting(tmp_path):
    """A checkpointed sweep whose edges exceed the store capacity must
    raise BEFORE dispatching the group that would clamp-clobber earlier
    rows' store lines — the last saved checkpoint then predates any
    corruption, so resuming it with a larger --store-capacity matches a
    clean run exactly."""
    import pytest

    path = str(tmp_path / "sweep.ckpt")
    al = random_alignment(n_samples=40, n_loci=256, seed=91, gap_frac=0.1)
    clean = MIEngine(al, EngineConfig(tile=32)).sweep(-1.0).sort_desc()

    tiny = MIEngine(al, EngineConfig(tile=32, edge_capacity=1 << 12,
                                     store_capacity=1 << 13,
                                     rows_per_dispatch=2))
    with pytest.raises(RuntimeError, match="store overflow"):
        tiny.sweep(-1.0, checkpoint_path=path, checkpoint_every=2)

    # resume the pre-overflow checkpoint with enough capacity
    big = MIEngine(al, EngineConfig(tile=32, store_capacity=1 << 22))
    resumed = big.sweep(-1.0, checkpoint_path=path).sort_desc()
    np.testing.assert_array_equal(clean.ipos, resumed.ipos)
    np.testing.assert_array_equal(clean.jpos, resumed.jpos)
    np.testing.assert_array_equal(clean.mi, resumed.mi)
    np.testing.assert_array_equal(clean.mi_wog, resumed.mi_wog)
