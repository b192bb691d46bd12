"""The exact int8 crosstable modes and the compaction paths, end to end
through the engine sweep, against the f32 path and the f64 oracle."""

import numpy as np
import pytest

from spydrpick_jax.core.alignment import Alignment
from spydrpick_jax.engine.solver import EngineConfig, MIEngine

from tests.conftest import random_alignment

BI = 128  # tile width of these tests


def _assert_same(a, b):
    for f in ("ipos", "jpos", "mi", "mi_wog", "colmax"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize(
    "unit,compaction,n_loci",
    [(True, "route", 2 * BI), (False, "scatter", 2 * BI),
     (True, "scatter", 8 * BI)],
    # 8*BI: Lp=1024 -> several tiles per row and several route buckets
)
def test_sweep_parity(unit, compaction, n_loci):
    """int8-unit vs f32 and scatter vs route: every pairing computes
    exact counts (unit weights) or the same f32 crosstable, so the
    sweeps must agree bit for bit."""
    al = random_alignment(n_samples=40, n_loci=n_loci, seed=60, gap_frac=0.15)
    if unit:
        al.weights = None
    ref = MIEngine(al, EngineConfig(tile=BI, mxu_int8="off",
                                    compaction="route"))
    got = MIEngine(al, EngineConfig(tile=BI, compaction=compaction))
    assert got.statics.int8_mode == ("unit" if unit else "off")
    _assert_same(ref.sweep(0.05).sort_desc(), got.sweep(0.05).sort_desc())


def test_unit_weights_int8_matches_f32():
    """Unit weights select the int8 single pass under "auto"; the lazy
    (mi-only) sweep must EQUAL the f32 path's values."""
    al = random_alignment(n_samples=40, n_loci=2 * BI, seed=61, gap_frac=0.1)
    al.weights = None
    i8 = MIEngine(al, EngineConfig(tile=BI, wog_fetch="outliers"))
    assert i8.statics.unit_weights and i8.statics.int8_mode == "unit"
    f32 = MIEngine(al, EngineConfig(tile=BI, wog_fetch="outliers",
                                    mxu_int8="off"))
    assert f32.statics.int8_mode == "off"
    _assert_same(f32.sweep(0.05).sort_desc(), i8.sweep(0.05).sort_desc())


def test_int8_unit_mode_bit_identical():
    """Unit weights auto-select the int8 crosstable (mxu_int8="auto"):
    0/1 int8 operands accumulate exact integer counts in int32, so the
    sweep is BIT-IDENTICAL to the f32 path (both produce the same exact
    f32 crosstable)."""
    al = random_alignment(n_samples=40, n_loci=3 * BI, seed=81,
                          gap_frac=0.12)
    al.weights = None
    e_i8 = MIEngine(al, EngineConfig(tile=BI, wog_fetch="outliers"))
    assert e_i8.statics.int8_mode == "unit"
    assert e_i8.statics.storage_dtype == "int8"
    e_bf = MIEngine(al, EngineConfig(tile=BI, wog_fetch="outliers",
                                     mxu_int8="off"))
    assert e_bf.statics.int8_mode == "off"
    _assert_same(e_i8.sweep(0.03).sort_desc(), e_bf.sweep(0.03).sort_desc())


def test_int8_fixed14_accuracy_vs_oracle():
    """Weighted sweeps with bounded weight spread run the fixed14 int8
    split under mxu_int8="on"; its error against the f64 oracle must
    stay in the same class as the f32 path's (the f32 epilogue
    dominates both)."""
    from spydrpick_jax.ops.reference import mi_matrix

    al = random_alignment(n_samples=40, n_loci=3 * BI, seed=81,
                          gap_frac=0.12)
    rng = np.random.default_rng(3)
    al.weights = rng.random(40) * 0.9 + 0.1   # spread 10 <= 32
    M = mi_matrix(al.codes, al.weights, al.state_presence)
    e_fx = MIEngine(al, EngineConfig(tile=BI, wog_fetch="outliers",
                                     mxu_int8="on"))
    assert e_fx.statics.int8_mode == "fixed14"
    assert e_fx.statics.int8_scale > 16383.0  # 16383 / max_w, max_w < 1
    e_bw = MIEngine(al, EngineConfig(tile=BI, wog_fetch="outliers"))
    assert e_bw.statics.int8_mode == "off"  # weighted default: f32
    fx = e_fx.sweep(0.02)
    bw = e_bw.sweep(0.02)
    err_fx = max(abs(m - M[i, j]) for i, j, m in zip(fx.ipos, fx.jpos, fx.mi))
    err_bw = max(abs(m - M[i, j]) for i, j, m in zip(bw.ipos, bw.jpos, bw.mi))
    assert err_fx < max(2.0 * err_bw, 5e-5), (err_fx, err_bw)
    # threshold-boundary flips only
    assert abs(fx.n_edges - bw.n_edges) <= max(2, bw.n_edges // 1000)


def test_int8_auto_gate_on_weight_spread():
    """Weighted runs stay on f32 under "auto"; "on" selects fixed14 only
    for a weight spread max/min <= 32 (the quantisation error grows
    with the spread)."""
    al = random_alignment(n_samples=40, n_loci=2 * BI, seed=7, gap_frac=0.1)
    w = np.ones(40)
    w[0] = 1 / 64.0  # spread 64 > 32
    al.weights = w
    assert MIEngine(al, EngineConfig(tile=BI)).statics.int8_mode == "off"
    wide = MIEngine(al, EngineConfig(tile=BI, mxu_int8="on"))
    assert wide.statics.int8_mode == "off"
    w[0] = 1 / 16.0  # spread 16 <= 32
    al.weights = w
    assert MIEngine(al, EngineConfig(tile=BI)).statics.int8_mode == "off"
    narrow = MIEngine(al, EngineConfig(tile=BI, mxu_int8="on"))
    assert narrow.statics.int8_mode == "fixed14"


def test_int8_fixed14_overflow_dual_consistency():
    """Overflowed rows re-extract through the DUAL pass; under fixed14
    it must use the same int8 crosstable, so a capacity-starved sweep
    equals the roomy one bit for bit."""
    al = random_alignment(n_samples=40, n_loci=3 * BI, seed=19,
                          gap_frac=0.1)
    rng = np.random.default_rng(11)
    al.weights = rng.random(40) * 0.5 + 0.5
    roomy = MIEngine(al, EngineConfig(tile=BI, wog_fetch="outliers",
                                      mxu_int8="on"))
    assert roomy.statics.int8_mode == "fixed14"
    tight = MIEngine(al, EngineConfig(tile=BI, wog_fetch="outliers",
                                      mxu_int8="on", edge_capacity=4096))
    a = roomy.sweep(0.005).sort_desc()
    b = tight.sweep(0.005).sort_desc()
    assert a.n_edges == b.n_edges and a.n_edges > 4096  # overflow exercised
    np.testing.assert_array_equal(a.ipos, b.ipos)
    np.testing.assert_array_equal(a.jpos, b.jpos)
    np.testing.assert_array_equal(a.mi, b.mi)
    # (mi_wog is NOT compared: lazy mode defaults wog := mi except for
    # outlier candidates, while re-extracted overflow rows carry real
    # dual-pass wog — the output surface only ever reads wog for
    # outliers)


def test_int8_fixed14_exact_grid_weights():
    """Weights on the fixed-point grid (multiples of 1/16384 with
    max_w = 16383/16384, so q = 16384 and w_q = w*q exactly) make the
    fixed14 crosstable EXACT integer arithmetic — the error vs the f64
    oracle must then be pure f32-epilogue error, i.e. no worse than the
    f32 engine's on the same data."""
    from spydrpick_jax.ops.reference import mi_matrix

    al = random_alignment(n_samples=48, n_loci=2 * BI, seed=23,
                          gap_frac=0.1)
    rng = np.random.default_rng(9)
    k = rng.integers(1024, 16384, size=48)   # spread 16 <= 32
    k[0] = 16383                             # pins max_w = 16383/16384
    al.weights = k / 16384.0
    M = mi_matrix(al.codes, al.weights, al.state_presence)
    e_fx = MIEngine(al, EngineConfig(tile=BI, wog_fetch="outliers",
                                     mxu_int8="on"))
    assert e_fx.statics.int8_mode == "fixed14"
    assert abs(e_fx.statics.int8_scale - 16384.0) < 1e-9
    e_bw = MIEngine(al, EngineConfig(tile=BI, wog_fetch="outliers"))
    fx = e_fx.sweep(0.02)
    bw = e_bw.sweep(0.02)
    err_fx = max(abs(m - M[i, j]) for i, j, m in zip(fx.ipos, fx.jpos, fx.mi))
    err_bw = max(abs(m - M[i, j]) for i, j, m in zip(bw.ipos, bw.jpos, bw.mi))
    # exact counts can only match the f32 crosstable (tiny slack for
    # epilogue input rounding differences)
    assert err_fx <= err_bw * 1.2 + 1e-7, (err_fx, err_bw)


def test_int8_windowed_rows_bit_identical():
    """J-windowed sweeps compose with the int8 modes: window mode only
    re-tiles the work items, so results match full-width bit for bit."""
    al = random_alignment(n_samples=40, n_loci=4 * BI, seed=33,
                          gap_frac=0.1)
    rng = np.random.default_rng(2)
    al.weights = rng.random(40) * 0.9 + 0.1
    w = MIEngine(al, EngineConfig(tile=BI, wog_fetch="outliers",
                                  mxu_int8="on", row_window=2 * BI))
    assert w.statics.row_window == 2 * BI
    assert w.statics.int8_mode == "fixed14"
    f = MIEngine(al, EngineConfig(tile=BI, wog_fetch="outliers",
                                  mxu_int8="on", row_window=1))
    assert f.statics.row_window == 0 and f.statics.int8_mode == "fixed14"
    a = w.sweep(0.02).sort_desc()
    b = f.sweep(0.02).sort_desc()
    assert a.n_edges == b.n_edges
    np.testing.assert_array_equal(a.ipos, b.ipos)
    np.testing.assert_array_equal(a.jpos, b.jpos)
    np.testing.assert_array_equal(a.mi, b.mi)


def test_fixed14_sample_count_guard():
    """fixed14 must NOT be selected (even under --mxu-int8 on) when an
    int32 crosstable cell could wrap: sum(w_q) <= S*16383 needs S below
    ~131k samples.  Such runs stay on the f32 path."""
    S, L = 140000, 32
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 5, size=(S, L)).astype(np.uint8)
    al = Alignment(
        codes=codes,
        sample_names=[f"s{i}" for i in range(S)],
        id_string="guard",
        translation=np.arange(L, dtype=np.int64),
        n_original_positions=L,
        weights=rng.random(S) * 0.9 + 0.1,
    )
    eng = MIEngine(al, EngineConfig(tile=8, mxu_int8="on"))
    assert eng.statics.int8_mode == "off"
    # a small-S twin with the same weights spread DOES select fixed14
    al_small = Alignment(
        codes=codes[:48],
        sample_names=[f"s{i}" for i in range(48)],
        id_string="guard-s",
        translation=np.arange(L, dtype=np.int64),
        n_original_positions=L,
        weights=(rng.random(48) * 0.9 + 0.1),
    )
    eng_s = MIEngine(al_small, EngineConfig(tile=8, mxu_int8="on"))
    assert eng_s.statics.int8_mode == "fixed14"
