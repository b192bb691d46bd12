"""Tournament threshold estimation tests (SpydrPick.hpp:257-343)."""

import numpy as np

from spydrpick_jax.engine.solver import EngineConfig, MIEngine
from spydrpick_jax.engine.threshold import (
    default_mi_values,
    determine_mi_threshold,
    determine_threshold_pairs,
    sample_pairs,
)

from tests.conftest import random_alignment


def test_default_mi_values():
    assert default_mi_values(1000, 0) == 100_000
    assert default_mi_values(10**6, 0) == 10**7  # capped (SpydrPick.cpp:338)
    assert default_mi_values(1000, 777) == 777


def test_determine_threshold_pairs_auto_rule():
    # replicate SpydrPick.hpp:262-271: grow while tail < 100
    possible = 10**12
    pct = 1 - 1e-7  # tail fraction 1e-7 -> needs the 500k cap
    assert determine_threshold_pairs(0, possible, pct) == 500_000
    pct = 0.99  # tail 1% -> 100k gives 1000 >= 100 -> no growth
    assert determine_threshold_pairs(0, possible, pct) == 100_000
    # explicit value passes through, capped at possible/10
    assert determine_threshold_pairs(300, 10**12, 0.5) == 300
    assert determine_threshold_pairs(300, 2000, 0.5) == 200


def test_sample_pairs_unique_and_bounded():
    rng = np.random.default_rng(0)
    ii, jj = sample_pairs(rng, 500, 60)
    assert len(ii) == 500
    assert (ii < jj).all()
    assert ii.min() >= 0 and jj.max() < 60
    keys = set(zip(ii.tolist(), jj.tolist()))
    assert len(keys) == 500


def test_sample_pairs_deterministic_by_seed():
    a = sample_pairs(np.random.default_rng(7), 100, 50)
    b = sample_pairs(np.random.default_rng(7), 100, 50)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_threshold_estimate_brackets_true_quantile():
    """Estimated threshold should approximate the exact MI quantile."""
    al = random_alignment(n_samples=60, n_loci=60, seed=20)
    engine = MIEngine(al, EngineConfig(tile=32))
    # exact: all pairwise MI values
    edges = engine.sweep(-1.0)
    all_mi = np.sort(edges.mi)
    n_values = 100  # want ~100 top pairs saved
    thr = determine_mi_threshold(engine, n_values, threshold_pairs=150,
                                 iterations=5, seed=1)
    n_above = int((all_mi > thr).sum())
    # sampled estimate is noisy; just require the right order of magnitude
    assert 10 <= n_above <= 1000


def test_threshold_deterministic():
    al = random_alignment(n_samples=40, n_loci=50, seed=21)
    engine = MIEngine(al, EngineConfig(tile=32))
    t1 = determine_mi_threshold(engine, 50, threshold_pairs=100, iterations=3, seed=5)
    t2 = determine_mi_threshold(engine, 50, threshold_pairs=100, iterations=3, seed=5)
    assert t1 == t2


def test_pack_tournament_indices_convention():
    """Shared packing helper (single-device + sharded tournaments):
    uint16 iff positions fit 16 bits, zero padding past n_valid, chunk
    tiling exact."""
    import numpy as np

    from spydrpick_jax.engine.solver import pack_tournament_indices

    iters, n_valid, chunk = 3, 10, 8
    ipos = np.arange(iters * n_valid) % 7
    jpos = (np.arange(iters * n_valid) % 7) + 1
    ip3, jp3, nc, dt = pack_tournament_indices(
        ipos, jpos, iters, n_valid, chunk, Lp=1 << 16)
    assert dt == "uint16" and ip3.dtype == np.uint16
    assert ip3.shape == (iters, nc, chunk) and nc == 2  # ceil(10/8)
    flat = ip3.reshape(iters, -1)
    for it in range(iters):
        np.testing.assert_array_equal(
            flat[it, :n_valid], ipos[it * n_valid:(it + 1) * n_valid])
        assert (flat[it, n_valid:] == 0).all()  # pad slots zeroed
    # positions past 16 bits switch to int32
    *_, dt32 = pack_tournament_indices(
        ipos, jpos, iters, n_valid, chunk, Lp=(1 << 16) + 1)
    assert dt32 == "int32"
