"""Unit tests for the two edge-compaction paths (roll-routing and
cumsum+scatter) against a NumPy compaction reference."""

import numpy as np
import pytest


def _live_entries(out):
    """(ipos, jpos, val, wog) of the live slots of a K window, in slot
    order (dead slots and sub-line holes carry jpos = 0 < ipos or
    (0, 0), which the store's jpos > ipos fetch filter drops)."""
    vals, wogs, ipos, jpos, count, lines = (np.asarray(x) for x in out)
    keep = jpos > ipos
    return ipos[keep], jpos[keep], vals[keep], wogs[keep]


@pytest.mark.parametrize("with_wog", [False, True])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 1.0])
def test_route_matches_scatter_and_numpy(density, with_wog):
    """Route and scatter compaction must store the same edges, in the
    same row-major order and with bit-identical payloads, as a NumPy
    compaction of the mask — on both payload configurations (lazy
    mi-only and dual mi+wog)."""
    import jax.numpy as jnp
    from spydrpick_jax.ops.compact import (
        compact_edges_route,
        compact_edges_scatter,
    )

    rng = np.random.default_rng(int(density * 100) + 3 + with_wog)
    T, Lp, i0, K, j_off = 16, 1024, 32, 1 << 14, 128
    mi = rng.random((T, Lp)).astype(np.float32)
    wog = (mi * 0.5).astype(np.float32) if with_wog else None
    mask = rng.random((T, Lp)) < density
    args = (jnp.asarray(mi), None if wog is None else jnp.asarray(wog),
            jnp.asarray(mask), i0, K)
    route = compact_edges_route(*args, j_offset=j_off)
    scatter = compact_edges_scatter(*args, j_offset=j_off)

    rr, cc = np.nonzero(mask)  # row-major: i-row, then ascending j
    want = (i0 + rr, j_off + cc, mi[rr, cc],
            wog[rr, cc] if with_wog else np.zeros(len(rr), np.float32))
    assert int(route[4]) == int(scatter[4]) == len(rr)
    for got in (_live_entries(route), _live_entries(scatter)):
        for g, w, name in zip(got, want, ("ipos", "jpos", "vals", "wogs")):
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_route_integrated_sweep():
    """Full engine sweeps with route and with scatter compaction must
    produce the same EdgeSet exactly (the store layouts differ; the
    edges and values may not)."""
    from spydrpick_jax.engine.solver import EngineConfig, MIEngine
    from tests.conftest import random_alignment

    al = random_alignment(n_samples=40, n_loci=256, seed=71, gap_frac=0.1)
    ref = MIEngine(al, EngineConfig(tile=32, compaction="scatter")
                   ).sweep(0.02).sort_desc()
    got = MIEngine(al, EngineConfig(tile=32, compaction="route")
                   ).sweep(0.02).sort_desc()
    np.testing.assert_array_equal(ref.ipos, got.ipos)
    np.testing.assert_array_equal(ref.jpos, got.jpos)
    np.testing.assert_array_equal(ref.mi, got.mi)
    np.testing.assert_array_equal(ref.mi_wog, got.mi_wog)
