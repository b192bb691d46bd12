"""The crosstable modes of ops/mi.py (f32, int8 unit, int8 fixed14)
against exact integer counts and the float64 oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from spydrpick_jax.core.alphabet import N_STATES
from spydrpick_jax.engine.solver import EngineConfig, MIEngine
from spydrpick_jax.ops.mi import INT8_PASS_MULTS, crosstab_tile_int8
from spydrpick_jax.ops.reference import crosstab_pair, mi_single

from tests.conftest import random_alignment


def _onehot(codes):
    S, L = codes.shape
    oh = np.zeros((S, L, N_STATES), np.int64)
    np.put_along_axis(oh, codes[:, :, None].astype(np.int64), 1, axis=2)
    return oh.reshape(S, L * N_STATES)


def _fixed14_digits(w):
    q = 16383.0 / w.max()
    w_q = np.clip(np.round(w.astype(np.float32) * np.float32(q)), 0,
                  16383).astype(np.int64)
    return w_q, w_q // 128, w_q % 128


@pytest.mark.parametrize("mode", ["unit", "fixed14"])
@pytest.mark.parametrize("S,L", [(64, 40), (300, 24)])
def test_crosstab_int8_exact_counts(mode, S, L):
    """The int8 crosstable equals the integer counts computed in int64
    on the host — exactly, for both modes."""
    al = random_alignment(n_samples=S, n_loci=L, seed=S + L, gap_frac=0.2)
    oh = _onehot(al.codes)
    if mode == "unit":
        parts = (oh,)
        want = oh.T @ oh
    else:
        w_q, hi, lo = _fixed14_digits(al.weights)
        parts = (oh * hi[:, None], oh * lo[:, None])
        want = (oh * w_q[:, None]).T @ oh
    got = crosstab_tile_int8(
        tuple(jnp.asarray(p, jnp.int8) for p in parts),
        jnp.asarray(oh, jnp.int8), INT8_PASS_MULTS[mode])
    assert got.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("mode,tol", [("off", 2e-6), ("unit", 2e-6),
                                      ("fixed14", 5e-5)])
def test_row_modes_vs_oracle(mode, tol):
    """A full MI row (both variants) in each crosstable mode against the
    f64 oracle; unit weights for the unit mode, spread-10 weights for
    the f32 and fixed14 modes."""
    al = random_alignment(n_samples=100, n_loci=64, seed=4, gap_frac=0.25)
    if mode == "unit":
        al.weights = None
    w = np.ones(al.n_samples) if al.weights is None else al.weights
    eng = MIEngine(al, EngineConfig(
        tile=32, mxu_int8="off" if mode == "off" else "on"))
    assert eng.statics.int8_mode == mode
    for i0 in (0, 32):
        mi, wog, store, _ = (np.asarray(x) for x in eng._row_full(
            eng.data, i0=jnp.asarray(i0, jnp.int32)))
        for r in range(0, 32, 5):
            for j in range(i0 + r + 1, al.n_loci, 7):
                i = i0 + r
                C = crosstab_pair(al.codes[:, i], al.codes[:, j], w)
                want = mi_single(C, al.state_presence[i],
                                 al.state_presence[j])
                assert store[r, j]
                assert abs(mi[r, j] - want) < tol, (mode, i, j)
                if al.gap_presence[i] or al.gap_presence[j]:
                    want_w = mi_single(C, al.state_presence_wo_gaps[i],
                                       al.state_presence_wo_gaps[j])
                    assert abs(wog[r, j] - want_w) < tol, (mode, i, j)


def test_fixed14_digit_split():
    """Two base-128 digits reconstruct the 14-bit quantised weight
    exactly, both fit int8, and the quantisation error is within half a
    step of 1/q (plus the f32 rounding of w * q, ~1e-3 of a step)."""
    rng = np.random.default_rng(1)
    w = rng.random(10000) * 0.9 + 0.1
    w_q, hi, lo = _fixed14_digits(w)
    assert hi.max() <= 127 and lo.max() <= 127 and min(hi.min(), lo.min()) >= 0
    np.testing.assert_array_equal(128 * hi + lo, w_q)
    q = 16383.0 / w.max()
    assert np.abs(w_q / q - w).max() <= 0.501 / q
