"""Multi-device sharding tests on the 8-device virtual CPU mesh.

Shard-count invariance of the merged edge list is the analogue of the
reference's thread-count invariance (SURVEY §4): the tbb::parallel_reduce
join (mi.hpp:355-361) must not change results, and neither may our mesh
size.
"""

import jax
import numpy as np
import pytest

from spydrpick_jax.engine.solver import EngineConfig, MIEngine
from spydrpick_jax.parallel.mesh import balanced_row_order, make_mesh, sharded_sweep

from tests.conftest import random_alignment


@pytest.fixture(scope="module")
def engine():
    al = random_alignment(n_samples=60, n_loci=100, seed=40, gap_frac=0.1)
    return MIEngine(al, EngineConfig(tile=16, edge_capacity=4096))


def _key(e):
    order = np.lexsort((e.jpos, e.ipos))
    return e.ipos[order], e.jpos[order], e.mi[order], e.mi_wog[order]


def test_devices_available():
    assert jax.device_count() == 8, "conftest must force 8 virtual CPU devices"


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_sharded_matches_single_device(engine, n_dev):
    single = engine.sweep(0.05)
    mesh = make_mesh(n_dev)
    sharded = sharded_sweep(engine, 0.05, mesh)
    si, sj, sm, sw = _key(single)
    mi_, mj, mm, mw = _key(sharded)
    np.testing.assert_array_equal(si, mi_)
    np.testing.assert_array_equal(sj, mj)
    np.testing.assert_allclose(sm, mm, rtol=1e-6)
    np.testing.assert_allclose(sw, mw, rtol=1e-6)
    np.testing.assert_allclose(single.colmax, sharded.colmax, rtol=1e-6)


def test_balanced_row_order():
    assert balanced_row_order(5) == [0, 4, 1, 3, 2]
    assert balanced_row_order(4) == [0, 3, 1, 2]
    assert sorted(balanced_row_order(17)) == list(range(17))


def test_dryrun_multichip_entrypoint():
    """The driver-facing multichip dry run must compile and execute."""
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)


def test_sharded_epoch_recycling_matches():
    """Per-device stores smaller than the sweep's edge volume must
    recycle in epochs (mid-sweep collective drains) with the identical
    merged EdgeSet; overflowed rows stay exact across epochs."""
    al = random_alignment(n_samples=50, n_loci=160, seed=41, gap_frac=0.1)
    ref = MIEngine(al, EngineConfig(tile=16, edge_capacity=4096)).sweep(-1.0)
    # K=512 per-row window: block-rows can reach 16*160 = 2560 > K, so
    # some rows overflow; store 2 dispatch batches per device at most
    # per-device cap collapses to the G*K floor (1024 slots = 8 lines =
    # one dispatch batch), so every batch fills the store -> epoch drain
    tiny = MIEngine(al, EngineConfig(
        tile=16, edge_capacity=512, store_capacity=1 << 10,
        rows_per_dispatch=2,
    ))
    timings: dict = {}
    sharded = sharded_sweep(tiny, -1.0, make_mesh(2), timings=timings)
    assert timings["epoch_drains"] >= 1
    si, sj, sm, sw = _key(ref)
    mi_, mj, mm, mw = _key(sharded)
    np.testing.assert_array_equal(si, mi_)
    np.testing.assert_array_equal(sj, mj)
    np.testing.assert_allclose(sm, mm, rtol=1e-6)
    np.testing.assert_allclose(sw, mw, rtol=1e-6)


def test_sharded_codes_storage_matches():
    """Sharded sweep with the codes-resident alignment (one-hot expanded
    per tile) must equal the dense single-device sweep."""
    al = random_alignment(n_samples=40, n_loci=96, seed=43, gap_frac=0.1)
    ref = MIEngine(al, EngineConfig(tile=16)).sweep(0.02)
    codes = MIEngine(al, EngineConfig(tile=16, onehot_storage="codes"))
    sharded = sharded_sweep(codes, 0.02, make_mesh(4))
    si, sj, sm, sw = _key(ref)
    mi_, mj, mm, mw = _key(sharded)
    np.testing.assert_array_equal(si, mi_)
    np.testing.assert_array_equal(sj, mj)
    np.testing.assert_allclose(sm, mm, rtol=1e-6)
    np.testing.assert_allclose(sw, mw, rtol=1e-6)


def test_sample_sharded_2d_mesh_matches():
    """2-D (rows x samples) mesh: the alignment itself is sharded over
    the samples axis and per-tile crosstables psum-merge — results must
    equal the single-device sweep (incl. a sample count that does not
    divide the shard count, exercising the zero-weight pad)."""
    al = random_alignment(n_samples=45, n_loci=96, seed=47, gap_frac=0.1)
    ref = MIEngine(al, EngineConfig(tile=16)).sweep(0.02)
    eng = MIEngine(al, EngineConfig(tile=16))
    mesh = make_mesh(2, n_samples=4)  # 2x4 = 8 virtual devices
    assert mesh.shape == {"rows": 2, "samples": 4}
    sharded = sharded_sweep(eng, 0.02, mesh)
    si, sj, sm, sw = _key(ref)
    mi_, mj, mm, mw = _key(sharded)
    np.testing.assert_array_equal(si, mi_)
    np.testing.assert_array_equal(sj, mj)
    # the psum splits the sample reduction into per-shard partials, so
    # agreement is at f32 accumulation-order level, not bitwise
    np.testing.assert_allclose(sm, mm, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(sw, mw, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ref.colmax, sharded.colmax, rtol=1e-4)


def test_sample_sharded_int8_unit_matches_f32():
    """2-D mesh in int8 unit mode (codes residency, lazy wog) against
    the single-device f32 path: both compute exact counts, so the
    sharded int8 sweep must equal the one-device f32 sweep exactly."""
    al = random_alignment(n_samples=45, n_loci=256, seed=48, gap_frac=0.1)
    al.weights = None
    ref = MIEngine(al, EngineConfig(tile=128, mxu_int8="off",
                                    wog_fetch="outliers")).sweep(0.02)
    eng = MIEngine(al, EngineConfig(tile=128, onehot_storage="codes",
                                    wog_fetch="outliers"))
    assert eng.statics.int8_mode == "unit"
    sharded = sharded_sweep(eng, 0.02, make_mesh(2, n_samples=4))
    for a, b in zip(_key(ref), _key(sharded)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ref.colmax, sharded.colmax)


def test_sample_sharded_int8_fixed14_bit_identical():
    """2-D mesh on the int8 fixed14 path: int32 count partials psum
    EXACTLY, so the sharded sweep is BIT-identical to the single-device
    int8 sweep (unlike the f32 psum path, whose partial sums
    reassociate)."""
    al = random_alignment(n_samples=45, n_loci=256, seed=49, gap_frac=0.1)
    cfg = EngineConfig(tile=128, mxu_int8="on")
    ref_eng = MIEngine(al, cfg)
    assert ref_eng.statics.int8_mode == "fixed14", ref_eng.statics.int8_mode
    ref = ref_eng.sweep(0.02)
    eng = MIEngine(al, cfg)
    sharded = sharded_sweep(eng, 0.02, make_mesh(2, n_samples=4))
    si, sj, sm, sw = _key(ref)
    mi_, mj, mm, mw = _key(sharded)
    np.testing.assert_array_equal(si, mi_)
    np.testing.assert_array_equal(sj, mj)
    np.testing.assert_array_equal(sm, mm)
    np.testing.assert_array_equal(sw, mw)
    np.testing.assert_array_equal(ref.colmax, sharded.colmax)


def test_sample_sharded_int8_unit_bit_identical():
    """Unit weights on the 2-D mesh: exact integer counts in a SINGLE
    int8 pass, psum'd in int32 — bit-identical to single-device (the
    dual/wog variant shares the merged crosstable)."""
    al = random_alignment(n_samples=45, n_loci=256, seed=50, gap_frac=0.1)
    al.weights = None
    cfg = EngineConfig(tile=128)
    ref_eng = MIEngine(al, cfg)
    assert ref_eng.statics.int8_mode == "unit", ref_eng.statics.int8_mode
    ref = ref_eng.sweep(0.02)
    eng = MIEngine(al, cfg)
    sharded = sharded_sweep(eng, 0.02, make_mesh(2, n_samples=4))
    si, sj, sm, sw = _key(ref)
    mi_, mj, mm, mw = _key(sharded)
    np.testing.assert_array_equal(si, mi_)
    np.testing.assert_array_equal(sj, mj)
    np.testing.assert_array_equal(sm, mm)
    np.testing.assert_array_equal(sw, mw)


def test_sharded_lazy_wog_matches_full():
    """Sharded sweep with the production lazy-wog drain: exact wog for
    every edge at/above the outlier threshold, mi elsewhere (the only
    wog values the output surface reads, SpydrPick.hpp:100-124)."""
    from spydrpick_jax.engine.outliers import outlier_thresholds

    al = random_alignment(n_samples=50, n_loci=96, seed=49, gap_frac=0.2)
    al.codes[:, 90] = al.codes[:, 9]  # plant an outlier coupling
    full = MIEngine(al, EngineConfig(tile=16, wog_fetch="full"))
    lazy = MIEngine(al, EngineConfig(tile=16, wog_fetch="outliers"))
    e_full = sharded_sweep(full, 0.01, make_mesh(4))
    e_lazy = sharded_sweep(lazy, 0.01, make_mesh(4))
    fi, fj, fm, fw = _key(e_full)
    li, lj, lm, lw = _key(e_lazy)
    np.testing.assert_array_equal(fi, li)
    np.testing.assert_array_equal(fj, lj)
    np.testing.assert_array_equal(fm, lm)
    thr_out, _ = outlier_thresholds(e_full.colmax)
    cand = fm >= thr_out
    assert cand.any()
    np.testing.assert_allclose(fw[cand], lw[cand], rtol=1e-5, atol=1e-7)


def test_sharded_all_features_compose():
    """2-D (rows x samples) mesh + codes-resident alignment + lazy wog
    together — the full production configuration for the largest
    BASELINE shapes — must match the plain single-device sweep."""
    al = random_alignment(n_samples=44, n_loci=96, seed=51, gap_frac=0.15)
    al.codes[:, 90] = al.codes[:, 9]
    ref = MIEngine(al, EngineConfig(tile=16, wog_fetch="full")).sweep(0.02)
    eng = MIEngine(al, EngineConfig(tile=16, onehot_storage="codes",
                                    wog_fetch="outliers"))
    sharded = sharded_sweep(eng, 0.02, make_mesh(2, n_samples=4))
    fi, fj, fm, fw = _key(ref)
    li, lj, lm, lw = _key(sharded)
    np.testing.assert_array_equal(fi, li)
    np.testing.assert_array_equal(fj, lj)
    np.testing.assert_allclose(fm, lm, rtol=1e-4, atol=1e-6)
    from spydrpick_jax.engine.outliers import outlier_thresholds
    thr_out, _ = outlier_thresholds(ref.colmax)
    cand = fm >= thr_out
    assert cand.any()
    np.testing.assert_allclose(fw[cand], lw[cand], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_row_window_matches_single(n_dev):
    """Windowed (j-chunked) sharded sweep == full-width single-device:
    the wide-alignment streaming mode composes with the row mesh."""
    al = random_alignment(n_samples=50, n_loci=120, seed=45, gap_frac=0.1)
    full = MIEngine(al, EngineConfig(tile=8, row_window=1)).sweep(0.03)
    win_eng = MIEngine(al, EngineConfig(tile=8, row_window=32))
    sharded = sharded_sweep(win_eng, 0.03, make_mesh(n_dev))
    si, sj, sm, sw = _key(full)
    mi_, mj, mm, mw = _key(sharded)
    np.testing.assert_array_equal(si, mi_)
    np.testing.assert_array_equal(sj, mj)
    np.testing.assert_allclose(sm, mm, rtol=1e-6)
    np.testing.assert_allclose(sw, mw, rtol=1e-6)
    np.testing.assert_allclose(
        full.colmax, sharded.colmax[: len(full.colmax)], rtol=1e-6)


def test_sharded_row_window_overflow_and_epochs():
    """Windowed sharded sweep under item overflow + store recycling."""
    al = random_alignment(n_samples=40, n_loci=128, seed=46, gap_frac=0.1)
    ref = MIEngine(al, EngineConfig(tile=8, row_window=1)).sweep(-1.0)
    eng = MIEngine(al, EngineConfig(tile=8, row_window=32,
                                    edge_capacity=128,
                                    store_capacity=1 << 10,
                                    rows_per_dispatch=2))
    timings: dict = {}
    sharded = sharded_sweep(eng, -1.0, make_mesh(4), timings=timings)
    assert timings["overflow_rows"] > 0
    assert sharded.n_edges == 128 * 127 // 2
    si, sj, sm, sw = _key(ref)
    mi_, mj, mm, mw = _key(sharded)
    np.testing.assert_array_equal(si, mi_)
    np.testing.assert_array_equal(sj, mj)
    np.testing.assert_allclose(sm, mm, rtol=1e-6)
    np.testing.assert_allclose(sw, mw, rtol=1e-6)


def test_sharded_view_pair_mi_matches_engine():
    """ShardedEngineView's psum pairs kernel == the single-device pairs
    kernel: the threshold tournament may run on either."""
    from spydrpick_jax.parallel.mesh import ShardedEngineView

    al = random_alignment(n_samples=45, n_loci=80, seed=60, gap_frac=0.15)
    eng = MIEngine(al, EngineConfig(tile=16))
    view = ShardedEngineView(eng, make_mesh(2, n_samples=4))
    rng = np.random.default_rng(0)
    ii = rng.integers(0, 80, size=500)
    jj = (ii + 1 + rng.integers(0, 78, size=500)) % 80
    np.testing.assert_allclose(
        eng.pair_mi(ii, jj), view.pair_mi(ii, jj), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        eng.pair_wog(ii, jj), view.pair_wog(ii, jj), rtol=1e-4, atol=1e-6)


def test_sharded_view_tournament_matches():
    """determine_mi_threshold accepts the view (duck-typed engine) and
    agrees with the unsharded tournament up to psum accumulation order."""
    from spydrpick_jax.engine.threshold import determine_mi_threshold
    from spydrpick_jax.parallel.mesh import ShardedEngineView

    al = random_alignment(n_samples=40, n_loci=150, seed=61, gap_frac=0.1)
    eng = MIEngine(al, EngineConfig(tile=16))
    view = ShardedEngineView(eng, make_mesh(2, n_samples=4))
    t_ref = determine_mi_threshold(eng, 500, threshold_pairs=1000,
                                   iterations=3, seed=5)
    t_view = determine_mi_threshold(view, 500, threshold_pairs=1000,
                                    iterations=3, seed=5)
    np.testing.assert_allclose(t_ref, t_view, rtol=1e-4, atol=1e-6)


def test_sample_sharded_overflow_reextraction():
    """Per-item overflow on a 2-D mesh re-extracts through the sharded
    view (previously caveated to the unsharded engine)."""
    al = random_alignment(n_samples=45, n_loci=96, seed=62, gap_frac=0.1)
    ref = MIEngine(al, EngineConfig(tile=8)).sweep(-1.0)
    eng = MIEngine(al, EngineConfig(tile=8, edge_capacity=128))
    timings: dict = {}
    sharded = sharded_sweep(eng, -1.0, make_mesh(2, n_samples=4),
                            timings=timings)
    assert timings["overflow_rows"] > 0
    assert sharded.n_edges == 96 * 95 // 2
    si, sj, sm, sw = _key(ref)
    mi_, mj, mm, mw = _key(sharded)
    np.testing.assert_array_equal(si, mi_)
    np.testing.assert_array_equal(sj, mj)
    np.testing.assert_allclose(sm, mm, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(sw, mw, rtol=1e-4, atol=1e-6)


def test_sample_sharded_windowed_matches():
    """2-D mesh + j-windowed rows: the full wide-alignment recipe
    (samples sharded, rows meshed, windows streamed) in one run."""
    al = random_alignment(n_samples=45, n_loci=120, seed=63, gap_frac=0.1)
    ref = MIEngine(al, EngineConfig(tile=8, row_window=1)).sweep(0.02)
    eng = MIEngine(al, EngineConfig(tile=8, row_window=32))
    sharded = sharded_sweep(eng, 0.02, make_mesh(2, n_samples=4))
    si, sj, sm, sw = _key(ref)
    mi_, mj, mm, mw = _key(sharded)
    np.testing.assert_array_equal(si, mi_)
    np.testing.assert_array_equal(sj, mj)
    np.testing.assert_allclose(sm, mm, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(sw, mw, rtol=1e-4, atol=1e-6)


def test_sharded_checkpoint_resume_matches_clean(tmp_path):
    """Kill a sharded sweep mid-run on the 8-device mesh, resume from
    its checkpoint, and match a clean sharded run exactly — including
    rows that overflowed their per-item window (their truncated store
    edges must not be persisted as complete).  Round-2 gap: the sharded
    checkpoint path existed but had zero tests."""
    import os

    from spydrpick_jax.engine import checkpoint as ck

    al = random_alignment(n_samples=40, n_loci=128, seed=70, gap_frac=0.1)
    # edge_capacity 128 overflows the early block-rows at threshold -1
    cfg = EngineConfig(tile=8, edge_capacity=128, rows_per_dispatch=1,
                       wog_fetch="full")
    mesh = make_mesh(8)
    clean = sharded_sweep(MIEngine(al, cfg), -1.0, mesh).sort_desc()
    assert clean.n_edges == 128 * 127 // 2  # all pairs kept

    class Killed(Exception):
        pass

    calls = {"n": 0}

    def progress(r0, r1, n_edges, dt):
        calls["n"] += 1
        if calls["n"] == 2:  # die after one checkpointed batch
            raise Killed

    path = str(tmp_path / "sharded.ckpt")
    eng2 = MIEngine(al, cfg)
    with pytest.raises(Killed):
        sharded_sweep(eng2, -1.0, mesh, progress=progress,
                      checkpoint_path=path, checkpoint_every=8)
    assert os.path.exists(path)
    saved = ck.load(path, ck.params_key(eng2.statics, -1.0))
    assert saved is not None
    assert 0 not in saved.done_rows  # block-row 0 overflowed (~1000 > 128)
    # every persisted edge belongs to a row listed done
    if saved.ipos and len(saved.ipos[0]):
        rows = (saved.ipos[0] // 8) * 8
        assert set(np.unique(rows)) <= saved.done_rows

    resumed = sharded_sweep(MIEngine(al, cfg), -1.0, mesh,
                            checkpoint_path=path).sort_desc()
    assert resumed.n_edges == clean.n_edges
    np.testing.assert_array_equal(resumed.ipos, clean.ipos)
    np.testing.assert_array_equal(resumed.jpos, clean.jpos)
    np.testing.assert_allclose(resumed.mi, clean.mi, rtol=1e-6)
    np.testing.assert_allclose(resumed.mi_wog, clean.mi_wog, rtol=1e-6)
    np.testing.assert_allclose(resumed.colmax, clean.colmax, rtol=1e-6)
    assert not os.path.exists(path)  # completed run removes it


def test_sharded_checkpoint_resume_windowed(tmp_path):
    """Sharded + j-windowed checkpoint kill/resume: partially-swept
    rows (some windows missing) must re-sweep on resume."""
    import os

    al = random_alignment(n_samples=40, n_loci=96, seed=71, gap_frac=0.1)
    cfg = EngineConfig(tile=8, row_window=32, rows_per_dispatch=2,
                       wog_fetch="full")
    mesh = make_mesh(4)
    clean = sharded_sweep(MIEngine(al, cfg), 0.02, mesh).sort_desc()

    class Killed(Exception):
        pass

    calls = {"n": 0}

    def progress(r0, r1, n_edges, dt):
        calls["n"] += 1
        if calls["n"] == 2:
            raise Killed

    path = str(tmp_path / "sharded_win.ckpt")
    with pytest.raises(Killed):
        sharded_sweep(MIEngine(al, cfg), 0.02, mesh, progress=progress,
                      checkpoint_path=path, checkpoint_every=8)
    assert os.path.exists(path)
    resumed = sharded_sweep(MIEngine(al, cfg), 0.02, mesh,
                            checkpoint_path=path).sort_desc()
    assert resumed.n_edges == clean.n_edges
    np.testing.assert_array_equal(resumed.ipos, clean.ipos)
    np.testing.assert_array_equal(resumed.jpos, clean.jpos)
    np.testing.assert_allclose(resumed.mi, clean.mi, rtol=1e-6)
    np.testing.assert_allclose(resumed.colmax, clean.colmax, rtol=1e-6)


def test_sharded_lazy_checkpoint_resume(tmp_path):
    """Sharded + lazy wog + checkpoint kill/resume: resumed placeholder
    wog values resolve post-hoc for outlier candidates (same output
    surface as a clean full-wog sharded run)."""
    import os

    from spydrpick_jax.engine.outliers import outlier_thresholds

    al = random_alignment(n_samples=40, n_loci=96, seed=72, gap_frac=0.2)
    al.codes[:, 90] = al.codes[:, 9]  # plant an outlier coupling
    mesh = make_mesh(4)
    full = sharded_sweep(
        MIEngine(al, EngineConfig(tile=8, wog_fetch="full")), 0.01, mesh
    ).sort_desc()

    class Killed(Exception):
        pass

    calls = {"n": 0}

    def progress(r0, r1, n, dt):
        calls["n"] += 1
        if calls["n"] == 2:
            raise Killed

    cfg = EngineConfig(tile=8, wog_fetch="outliers", rows_per_dispatch=1)
    path = str(tmp_path / "sl.ckpt")
    with pytest.raises(Killed):
        sharded_sweep(MIEngine(al, cfg), 0.01, mesh, progress=progress,
                      checkpoint_path=path, checkpoint_every=4)
    assert os.path.exists(path)
    resumed = sharded_sweep(MIEngine(al, cfg), 0.01, mesh,
                            checkpoint_path=path).sort_desc()
    assert resumed.n_edges == full.n_edges
    np.testing.assert_array_equal(resumed.ipos, full.ipos)
    np.testing.assert_array_equal(resumed.jpos, full.jpos)
    np.testing.assert_allclose(resumed.mi, full.mi, rtol=1e-6)
    thr_out, _ = outlier_thresholds(full.colmax)
    cand = full.mi >= thr_out
    assert cand.any()
    np.testing.assert_allclose(resumed.mi_wog[cand], full.mi_wog[cand],
                               rtol=1e-5, atol=1e-7)
