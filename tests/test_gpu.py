"""Checks that need the GPU (marker ``gpu``; they skip elsewhere).

Run on the card:  JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import numpy as np
import pytest

from spydrpick_jax.engine.solver import EngineConfig, MIEngine

from tests.conftest import random_alignment


@pytest.mark.gpu
def test_weighted_default_precision_is_not_tf32(gpu):
    """The weighted crosstable at the default precision keeps the
    weights near f32: its counts are within 1e-5 relative of a float64
    product (TF32 rounds them to ~7e-5 on this data)."""
    import jax.numpy as jnp

    from spydrpick_jax.ops.mi import crosstab_tile_flat

    rng = np.random.default_rng(0)
    S, T5 = 3000, 2560
    oh_i = rng.random((S, T5)) < 0.2
    oh_j = rng.random((S, T5)) < 0.2
    w = rng.random(S) * 0.9 + 0.1
    want = (oh_i * w[:, None]).T @ oh_j.astype(np.float64)
    prec = MIEngine(random_alignment(), EngineConfig()).statics.precision
    got = crosstab_tile_flat(
        jnp.asarray(oh_i * w[:, None], jnp.float32),
        jnp.asarray(oh_j, jnp.bfloat16), precision=prec)
    rel = np.abs(np.asarray(got, np.float64) - want).max() / want.max()
    assert rel < 1e-5, rel


@pytest.mark.gpu
@pytest.mark.parametrize("compaction", ["route", "scatter"])
def test_int8_unit_sweep_bit_identical_on_gpu(gpu, compaction):
    """Unit weights: the int8 sweep equals the f32 sweep bit for bit on
    the card, with either compaction."""
    al = random_alignment(n_samples=300, n_loci=1024, seed=3, gap_frac=0.1)
    al.weights = None
    a = MIEngine(al, EngineConfig(compaction=compaction)).sweep(0.01)
    b = MIEngine(al, EngineConfig(compaction=compaction, mxu_int8="off")
                 ).sweep(0.01)
    a, b = a.sort_desc(), b.sort_desc()
    for f in ("ipos", "jpos", "mi", "colmax"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
