"""End-to-end engine tests: sweep vs brute-force oracle, colmax,
thresholds, edge capacity overflow fallback."""

import numpy as np

from spydrpick_jax.engine.outliers import outlier_thresholds, quartile
from spydrpick_jax.engine.solver import EngineConfig, MIEngine
from spydrpick_jax.ops.reference import crosstab_pair, mi_single

from tests.conftest import random_alignment


def brute_force_edges(al, threshold, pseudocount=0.5):
    """(i, j, mi, mi_wog_effective) for all stored pairs + colmax, f64."""
    S, L = al.n_samples, al.n_loci
    w = al.weights
    pres = al.state_presence
    pres_w = al.state_presence_wo_gaps
    gaps = al.gap_presence
    edges = []
    colmax = np.full(L, -np.inf)
    for i in range(L):
        for j in range(i + 1, L):
            C = crosstab_pair(al.codes[:, i], al.codes[:, j], w)
            mi = mi_single(C, pres[i], pres[j], pseudocount)
            a, b = al.translation[i], al.translation[j]
            d = abs(a - b)
            d = min(d, al.n_original_positions - d)
            if d > 0:  # ld_threshold=0
                colmax[i] = max(colmax[i], mi)
                colmax[j] = max(colmax[j], mi)
            if mi > threshold:
                if gaps[i] or gaps[j]:
                    wog = mi_single(C, pres_w[i], pres_w[j], pseudocount)
                else:
                    wog = mi
                edges.append((i, j, mi, wog))
    return edges, colmax


def _compare(al, threshold, config=None):
    config = config or EngineConfig()
    engine = MIEngine(al, config)
    got = engine.sweep(threshold)
    want, colmax = brute_force_edges(al, threshold, config.pseudocount)

    got_pairs = {(int(i), int(j)): (m, wg) for i, j, m, wg in
                 zip(got.ipos, got.jpos, got.mi, got.mi_wog)}
    want_pairs = {(i, j): (mi, wog) for i, j, mi, wog in want}
    # pairs may differ only right at the threshold boundary (f32 vs f64)
    for k in set(got_pairs) ^ set(want_pairs):
        m = got_pairs.get(k, want_pairs.get(k))[0]
        assert abs(m - threshold) < 1e-4, (k, m)
    for k in set(got_pairs) & set(want_pairs):
        g_mi, g_wog = got_pairs[k]
        mi, wog = want_pairs[k]
        assert abs(g_mi - mi) < 5e-5, k
        assert abs(g_wog - wog) < 5e-5, k
    np.testing.assert_allclose(got.colmax, colmax, rtol=1e-4, atol=1e-5)
    return got


def test_sweep_matches_brute_force():
    al = random_alignment(n_samples=80, n_loci=100, seed=7, gap_frac=0.15)
    _compare(al, threshold=0.05)


def test_sweep_small_tile_multiblock():
    """Multiple tiles incl. a ragged last block (L=50, tile=16)."""
    al = random_alignment(n_samples=50, n_loci=50, seed=8, gap_frac=0.2)
    _compare(al, 0.02, EngineConfig(tile=16, edge_capacity=4096))


def test_sweep_tile_invariance():
    """Edges must not depend on the tile size (the analogue of the
    reference's thread-count invariance, SURVEY §4)."""
    al = random_alignment(n_samples=60, n_loci=70, seed=9)
    e1 = MIEngine(al, EngineConfig(tile=16)).sweep(0.03).sort_desc()
    e2 = MIEngine(al, EngineConfig(tile=64)).sweep(0.03).sort_desc()
    assert e1.n_edges == e2.n_edges
    np.testing.assert_array_equal(e1.ipos, e2.ipos)
    np.testing.assert_array_equal(e1.jpos, e2.jpos)
    np.testing.assert_allclose(e1.mi, e2.mi, rtol=1e-5)


def test_capacity_overflow_fallback():
    """Tiny edge buffer forces the full-row fallback path."""
    al = random_alignment(n_samples=40, n_loci=60, seed=10)
    full = _compare(al, 0.0, EngineConfig(tile=32, edge_capacity=8))
    assert full.n_edges == 60 * 59 // 2  # threshold 0 stores everything


def test_ld_threshold_masks_colmax_only():
    """ld-threshold gates colmax updates but NOT edge storage
    (mi.hpp:423-434)."""
    al = random_alignment(n_samples=60, n_loci=30, seed=11)
    e_no_ld = MIEngine(al, EngineConfig(tile=16)).sweep(0.0)
    e_ld = MIEngine(al, EngineConfig(tile=16, ld_threshold=10)).sweep(0.0)
    assert e_no_ld.n_edges == e_ld.n_edges
    assert not np.array_equal(e_no_ld.colmax, e_ld.colmax)
    # recompute colmax with the ld rule in numpy
    mi_map = {}
    for i, j, m in zip(e_no_ld.ipos, e_no_ld.jpos, e_no_ld.mi):
        mi_map[(i, j)] = m
    colmax = np.full(al.n_loci, -np.inf)
    G = al.n_original_positions
    for (i, j), m in mi_map.items():
        d = abs(al.translation[i] - al.translation[j])
        d = min(d, G - d)
        if d > 10:
            colmax[i] = max(colmax[i], m)
            colmax[j] = max(colmax[j], m)
    np.testing.assert_allclose(e_ld.colmax, colmax, rtol=1e-4)


def test_circular_vs_linear_distance():
    al = random_alignment(n_samples=40, n_loci=24, seed=12)
    c = MIEngine(al, EngineConfig(tile=8, ld_threshold=12)).sweep(0.0)
    l = MIEngine(al, EngineConfig(tile=8, ld_threshold=12, linear_genome=True)).sweep(0.0)
    # circular wrap means pairs near the ends are closer -> colmax differs
    assert not np.array_equal(c.colmax, l.colmax)


def test_pair_mi_matches_sweep():
    al = random_alignment(n_samples=70, n_loci=40, seed=13, gap_frac=0.1)
    engine = MIEngine(al, EngineConfig(tile=16))
    edges = engine.sweep(-1.0)  # store all
    ii, jj = edges.ipos[:100], edges.jpos[:100]
    pm = engine.pair_mi(ii, jj)
    np.testing.assert_allclose(pm, edges.mi[:100], rtol=1e-4, atol=1e-6)


def test_quartiles_and_tukey():
    colmax = np.arange(100, dtype=np.float64)
    assert quartile(colmax, 1) == 25.0
    assert quartile(colmax, 3) == 75.0
    out, ext = outlier_thresholds(colmax)
    assert out == 75 + 1.5 * 50
    assert ext == 75 + 3.0 * 50


def test_store_capacity_overflow(tmp_path):
    """Packed mode recycles the store in epochs — a sweep whose total
    edges exceed store capacity still completes exactly; the legacy
    (checkpointed) drain needs the whole sweep resident and raises."""
    from spydrpick_jax.engine.solver import EngineConfig, MIEngine
    import pytest as _pytest

    al = random_alignment(n_samples=30, n_loci=64, seed=99)
    cfg = EngineConfig(tile=16, edge_capacity=64, store_capacity=128,
                       rows_per_dispatch=1)
    edges = MIEngine(al, cfg).sweep(-1.0)  # 2016 pairs >> 128-slot store
    assert edges.n_edges == 64 * 63 // 2
    ref = MIEngine(al, EngineConfig(tile=16)).sweep(-1.0)
    e1, e2 = edges.sort_desc(), ref.sort_desc()
    np.testing.assert_array_equal(e1.ipos, e2.ipos)
    np.testing.assert_array_equal(e1.jpos, e2.jpos)
    np.testing.assert_array_equal(e1.mi, e2.mi)
    with _pytest.raises(RuntimeError, match="overflow"):
        MIEngine(al, cfg).sweep(-1.0,
                                checkpoint_path=str(tmp_path / "ck.npz"))


def test_deferred_wog_drain_matches_full():
    """wog_fetch="outliers" (the pipeline/bench drain) must hold exact
    wog for every edge at/above the outlier threshold and mi for the
    rest (the only wog values the output surface reads,
    SpydrPick.hpp:100-124)."""
    from spydrpick_jax.engine.outliers import outlier_thresholds

    al = random_alignment(n_samples=60, n_loci=120, seed=21, gap_frac=0.2)
    # plant strong couplings so edges clear the Tukey fence
    al.codes[:, 100] = al.codes[:, 10]
    al.codes[:, 110] = al.codes[:, 30]
    full = MIEngine(al, EngineConfig(tile=16, wog_fetch="full")).sweep(0.01)
    defer = MIEngine(al, EngineConfig(tile=16, wog_fetch="outliers")).sweep(0.01)

    np.testing.assert_array_equal(full.ipos, defer.ipos)
    np.testing.assert_array_equal(full.jpos, defer.jpos)
    np.testing.assert_array_equal(full.mi, defer.mi)
    np.testing.assert_array_equal(full.colmax, defer.colmax)

    thr_out, _ = outlier_thresholds(full.colmax)
    cand = full.mi >= thr_out
    assert cand.any()  # fixture must exercise the resolver
    # lazy mode recomputes candidate wog via the pairs kernel: same
    # math, different accumulation order than the tile kernel
    np.testing.assert_allclose(full.mi_wog[cand], defer.mi_wog[cand],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(defer.mi_wog[~cand], defer.mi[~cand])
    # and the deferral actually differs somewhere below the threshold
    # (gap-afflicted edges exist at gap_frac=0.2)
    assert (full.mi_wog != full.mi).any()


def test_route_width_buckets_invariant():
    """Bucketed route windows must produce the identical EdgeSet as the
    full-width route (same survivors, same line packing)."""
    al = random_alignment(n_samples=50, n_loci=200, seed=33, gap_frac=0.1)
    full = MIEngine(al, EngineConfig(tile=16, width_buckets=1)).sweep(0.01)
    buck = MIEngine(al, EngineConfig(tile=16, width_buckets=4)).sweep(0.01)
    np.testing.assert_array_equal(full.ipos, buck.ipos)
    np.testing.assert_array_equal(full.jpos, buck.jpos)
    np.testing.assert_array_equal(full.mi, buck.mi)
    np.testing.assert_array_equal(full.mi_wog, buck.mi_wog)
    np.testing.assert_array_equal(full.colmax, buck.colmax)


def test_onehot_codes_matches_dense():
    """Codes-resident alignment (one-hot expanded per tile on the fly)
    must be bit-identical to the dense precomputed one-hot — both the
    sweep and the pairs (tournament) kernel."""
    al = random_alignment(n_samples=50, n_loci=200, seed=55, gap_frac=0.15)
    dense = MIEngine(al, EngineConfig(tile=32, onehot_storage="dense"))
    codes = MIEngine(al, EngineConfig(tile=32, onehot_storage="codes"))
    assert codes.statics.onehot_codes and not dense.statics.onehot_codes
    assert codes.data.onehot.dtype == np.uint8
    e1, e2 = dense.sweep(0.01).sort_desc(), codes.sweep(0.01).sort_desc()
    np.testing.assert_array_equal(e1.ipos, e2.ipos)
    np.testing.assert_array_equal(e1.jpos, e2.jpos)
    np.testing.assert_array_equal(e1.mi, e2.mi)
    np.testing.assert_array_equal(e1.mi_wog, e2.mi_wog)
    np.testing.assert_array_equal(e1.colmax, e2.colmax)
    # pairs (tournament) kernel: the gather structure differs between
    # storage modes, which steers XLA-CPU to a different dot
    # vectorisation order — agreement is to the last ULP, not bitwise
    ii, jj = e1.ipos[:64], e1.jpos[:64]
    np.testing.assert_allclose(dense.pair_mi(ii, jj), codes.pair_mi(ii, jj),
                               rtol=1e-5, atol=1e-7)


def test_packed_epoch_recycling_matches():
    """A store smaller than the sweep's total edges must recycle in
    epochs (drain + reuse from line 0) and produce the identical
    EdgeSet — with per-row capacity large enough that no row overflows,
    so the epoch-collected data itself is what's verified."""
    al = random_alignment(n_samples=40, n_loci=512, seed=77, gap_frac=0.1)
    big = MIEngine(al, EngineConfig(tile=64))
    tiny = MIEngine(al, EngineConfig(tile=64, edge_capacity=1 << 15,
                                     store_capacity=1 << 16,
                                     rows_per_dispatch=2))
    timings: dict = {}
    e1 = big.sweep(-1.0).sort_desc()
    e2 = tiny.sweep(-1.0, timings=timings).sort_desc()
    assert timings["epoch_drains"] >= 1          # store was recycled
    assert timings["overflow_rows"] == 0         # data came from epochs
    assert e1.n_edges == 512 * 511 // 2
    np.testing.assert_array_equal(e1.ipos, e2.ipos)
    np.testing.assert_array_equal(e1.jpos, e2.jpos)
    np.testing.assert_array_equal(e1.mi, e2.mi)
    np.testing.assert_array_equal(e1.mi_wog, e2.mi_wog)
    np.testing.assert_array_equal(e1.colmax, e2.colmax)


def test_packed_epoch_recycling_lazy_wog():
    """Epoch recycling under the production drain (wog_fetch="outliers",
    lazy wog resolved via the pairs kernel after the store was reused)."""
    al = random_alignment(n_samples=40, n_loci=512, seed=78, gap_frac=0.2)
    al.codes[:, 500] = al.codes[:, 5]  # plant an outlier coupling
    full = MIEngine(al, EngineConfig(tile=64, wog_fetch="outliers")).sweep(0.01)
    timings: dict = {}
    tiny = MIEngine(al, EngineConfig(tile=64, wog_fetch="outliers",
                                     edge_capacity=1 << 15,
                                     store_capacity=1 << 16,
                                     rows_per_dispatch=2))
    e2 = tiny.sweep(0.01, timings=timings)
    assert timings["epoch_drains"] >= 1
    e1, e2 = full.sort_desc(), e2.sort_desc()
    np.testing.assert_array_equal(e1.ipos, e2.ipos)
    np.testing.assert_array_equal(e1.jpos, e2.jpos)
    np.testing.assert_array_equal(e1.mi, e2.mi)
    np.testing.assert_array_equal(e1.mi_wog, e2.mi_wog)


def test_packed_drain_multiple_chunks():
    """Force the packed drain across several fetch chunks (including a
    partial tail): store offset must cross chunk boundaries and the
    assembled EdgeSet must match a single-chunk run exactly."""
    al = random_alignment(n_samples=30, n_loci=768, seed=41, gap_frac=0.1)
    # store_capacity 1<<20 -> cap_lines 8192, chunk 2048 lines; storing
    # every pair of L=768 needs ~2700 lines -> 1 full chunk + a tail
    multi = MIEngine(al, EngineConfig(tile=128, store_capacity=1 << 20))
    small = MIEngine(al, EngineConfig(tile=128, store_capacity=1 << 18))
    assert multi._chunk_lines < 2700 <= 2 * multi._chunk_lines + 1
    e1 = multi.sweep(-1.0).sort_desc()
    e2 = small.sweep(-1.0).sort_desc()
    assert e1.n_edges == 768 * 767 // 2
    np.testing.assert_array_equal(e1.ipos, e2.ipos)
    np.testing.assert_array_equal(e1.jpos, e2.jpos)
    np.testing.assert_array_equal(e1.mi, e2.mi)


def test_pipeline_depth_two_matches():
    """Bounded lag-1 counts pipelining must not change results (it only
    reorders host syncs), including across epoch drains."""
    al = random_alignment(n_samples=40, n_loci=512, seed=79, gap_frac=0.1)
    d1 = MIEngine(al, EngineConfig(tile=64)).sweep(0.01).sort_desc()
    eng = MIEngine(al, EngineConfig(tile=64, pipeline_depth=2,
                                    edge_capacity=1 << 15,
                                    store_capacity=1 << 16,
                                    rows_per_dispatch=2))
    timings: dict = {}
    d2 = eng.sweep(0.01, timings=timings).sort_desc()
    np.testing.assert_array_equal(d1.ipos, d2.ipos)
    np.testing.assert_array_equal(d1.jpos, d2.jpos)
    np.testing.assert_array_equal(d1.mi, d2.mi)
    np.testing.assert_array_equal(d1.mi_wog, d2.mi_wog)


def test_epoch_recycling_with_partial_overflow():
    """Mixed case: SOME rows overflow their per-row K window while the
    store also recycles in epochs — truncated rows must be filtered
    from every epoch's collected data and re-extracted exactly once."""
    al = random_alignment(n_samples=40, n_loci=256, seed=81, gap_frac=0.1)
    ref = MIEngine(al, EngineConfig(tile=32)).sweep(-1.0).sort_desc()
    # K=4096: early block-rows (up to 32*255 ~ 8k pairs) overflow, late
    # rows fit; store = one 2-row dispatch group -> epoch every group
    tiny = MIEngine(al, EngineConfig(tile=32, edge_capacity=4096,
                                     store_capacity=1 << 13,
                                     rows_per_dispatch=2))
    timings: dict = {}
    got = tiny.sweep(-1.0, timings=timings).sort_desc()
    assert timings["epoch_drains"] >= 1
    assert 0 < timings["overflow_rows"] < 256 // 32
    assert got.n_edges == 256 * 255 // 2
    np.testing.assert_array_equal(ref.ipos, got.ipos)
    np.testing.assert_array_equal(ref.jpos, got.jpos)
    np.testing.assert_array_equal(ref.mi, got.mi)
    np.testing.assert_array_equal(ref.mi_wog, got.mi_wog)


# --------------------------------------------------------------------- #
# j-windowed rows (EngineConfig.row_window): wide-alignment streaming
# --------------------------------------------------------------------- #

def _assert_edgesets_equal(a, b, exact=True):
    assert a.n_edges == b.n_edges, (a.n_edges, b.n_edges)
    np.testing.assert_array_equal(a.ipos, b.ipos)
    np.testing.assert_array_equal(a.jpos, b.jpos)
    if exact:
        np.testing.assert_array_equal(a.mi, b.mi)
        np.testing.assert_array_equal(a.mi_wog, b.mi_wog)
    else:
        np.testing.assert_allclose(a.mi, b.mi, rtol=1e-6)
        np.testing.assert_allclose(a.mi_wog, b.mi_wog, rtol=1e-6)
    np.testing.assert_allclose(a.colmax[: len(b.colmax)],
                               b.colmax[: len(a.colmax)], rtol=1e-6)


def test_row_window_matches_full():
    """Windowed sweep (the 10^6-column streaming mode) must equal the
    full-width sweep bit-for-bit: same tiles, same route compaction,
    only the buffering granularity differs."""
    al = random_alignment(n_samples=40, n_loci=100, seed=90, gap_frac=0.1)
    full = MIEngine(al, EngineConfig(tile=8, row_window=1)).sweep(0.03)
    win = MIEngine(al, EngineConfig(tile=8, row_window=16)).sweep(0.03)
    _assert_edgesets_equal(full.sort_desc(), win.sort_desc())


def test_row_window_size_invariance():
    """Results must not depend on the window width (the same invariance
    as tile size / shard count, SURVEY §4)."""
    al = random_alignment(n_samples=50, n_loci=90, seed=91, gap_frac=0.15)
    sweeps = [
        MIEngine(al, EngineConfig(tile=8, row_window=w)).sweep(0.02).sort_desc()
        for w in (16, 24, 48)
    ]
    for s in sweeps[1:]:
        _assert_edgesets_equal(sweeps[0], s)


def test_row_window_oracle():
    """Windowed sweep against the f64 brute-force oracle."""
    al = random_alignment(n_samples=60, n_loci=80, seed=92, gap_frac=0.12)
    _compare(al, 0.04, EngineConfig(tile=8, row_window=16))


def test_row_window_overflow_reextraction():
    """Per-ITEM overflow: only the overflowed (row, window) is dropped
    and re-extracted; sibling windows of the same row keep their stored
    edges."""
    al = random_alignment(n_samples=40, n_loci=96, seed=93, gap_frac=0.1)
    ref = MIEngine(al, EngineConfig(tile=8, row_window=1)).sweep(-1.0)
    # K=128 < 8*88 pairs of early windows -> several items overflow
    win = MIEngine(al, EngineConfig(tile=8, row_window=32,
                                    edge_capacity=128))
    timings: dict = {}
    got = win.sweep(-1.0, timings=timings)
    assert timings["overflow_rows"] > 0  # counted per item
    assert got.n_edges == 96 * 95 // 2
    _assert_edgesets_equal(ref.sort_desc(), got.sort_desc())


def test_row_window_xla_compaction():
    """Windowed mode with the cumsum+scatter fallback compaction."""
    al = random_alignment(n_samples=40, n_loci=70, seed=94)
    ref = MIEngine(al, EngineConfig(tile=8, row_window=1,
                                    compaction="route")).sweep(0.02)
    got = MIEngine(al, EngineConfig(tile=8, row_window=16,
                                    compaction="scatter")).sweep(0.02)
    _assert_edgesets_equal(ref.sort_desc(), got.sort_desc())


def test_row_window_wog_full_drain():
    """Windowed mode with the full (non-lazy) wog drain."""
    al = random_alignment(n_samples=40, n_loci=70, seed=95, gap_frac=0.2)
    ref = MIEngine(al, EngineConfig(tile=8, row_window=1,
                                    wog_fetch="full")).sweep(0.02)
    got = MIEngine(al, EngineConfig(tile=8, row_window=16,
                                    wog_fetch="full")).sweep(0.02)
    _assert_edgesets_equal(ref.sort_desc(), got.sort_desc())


def test_row_window_auto_and_rounding():
    """row_window resolution: explicit widths round to tiles and divide
    Lp exactly; auto stays full-width below 2^17 padded columns."""
    from spydrpick_jax.engine.solver import build_device_data

    al = random_alignment(n_samples=4, n_loci=1000, seed=96)
    # auto at this width: full rows
    _, st = build_device_data(al, EngineConfig(tile=8))
    assert st.row_window == 0
    # explicit: rounded to a tile multiple that tiles Lp exactly
    _, st = build_device_data(al, EngineConfig(tile=8, row_window=100))
    assert st.row_window % 8 == 0
    assert st.Lp % st.row_window == 0
    # window >= Lp degenerates to full-width
    _, st = build_device_data(al, EngineConfig(tile=8, row_window=4096))
    assert st.row_window == 0


def test_packed_incremental_assembly_matches(monkeypatch):
    """Incremental in-sweep assembly submits (submit_ready) must yield
    byte-identical edge arrays to whole-epoch collection: batch size 1
    forces a collect per fetched chunk, across epoch recycles."""
    from spydrpick_jax.engine import solver as solver_mod

    monkeypatch.setattr(solver_mod, "_ASM_BATCH_CHUNKS", 1)
    al = random_alignment(n_samples=40, n_loci=512, seed=79, gap_frac=0.1)
    big = MIEngine(al, EngineConfig(tile=64))
    tiny = MIEngine(al, EngineConfig(tile=64, edge_capacity=1 << 15,
                                     store_capacity=1 << 17,
                                     rows_per_dispatch=2))
    timings: dict = {}
    e1 = big.sweep(-1.0).sort_desc()
    e2 = tiny.sweep(-1.0, timings=timings).sort_desc()
    assert timings["overflow_rows"] == 0
    np.testing.assert_array_equal(e1.ipos, e2.ipos)
    np.testing.assert_array_equal(e1.jpos, e2.jpos)
    np.testing.assert_array_equal(e1.mi, e2.mi)
    np.testing.assert_array_equal(e1.mi_wog, e2.mi_wog)


def test_identical_statics_share_jitted_programs():
    """The pipeline builds a fresh MIEngine per run; engines with
    identical SweepStatics must share the module-level traced/compiled
    programs (solver._jit_* lru factories) instead of retracing — the
    warm-pipeline latency fix)."""
    al = random_alignment(n_samples=30, n_loci=64, seed=11, gap_frac=0.1)
    a = MIEngine(al, EngineConfig(tile=16))
    b = MIEngine(al, EngineConfig(tile=16))
    assert a.statics == b.statics
    assert a._pairs_mi is b._pairs_mi
    assert a._rows_group is b._rows_group
    assert a._fetch_chunk is b._fetch_chunk
    # different statics must NOT collide
    c = MIEngine(al, EngineConfig(tile=16, pseudocount=0.7))
    assert c._pairs_mi is not a._pairs_mi
    # and both still sweep to identical results
    e1, e2 = a.sweep(-1.0).sort_desc(), b.sweep(-1.0).sort_desc()
    np.testing.assert_array_equal(e1.mi, e2.mi)
    np.testing.assert_array_equal(e1.ipos, e2.ipos)
