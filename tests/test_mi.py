"""MI math tests: analytic cases + JAX-vs-float64-oracle agreement.

Test strategy per SURVEY §4: the reference repo ships no tests, so the
golden model is our own float64 transliteration of mi.hpp:146-181
(spydrpick_jax/ops/reference.py) plus analytic identities.
"""

import numpy as np
import jax.numpy as jnp

from spydrpick_jax.core.alphabet import N_STATES
from spydrpick_jax.ops.mi import mi_from_crosstabs, tile_mi
from spydrpick_jax.ops.reference import crosstab_pair, mi_single

from tests.conftest import random_alignment


def _presence(codes_col):
    p = np.zeros(N_STATES, dtype=bool)
    p[np.unique(codes_col)] = True
    return p


def test_identical_columns_mi_is_entropy():
    """Duplicated columns: MI -> H(col) as pseudocount -> 0."""
    rng = np.random.default_rng(0)
    col = rng.integers(0, 4, size=5000).astype(np.uint8)
    w = np.ones(5000)
    C = crosstab_pair(col, col, w)
    ip = _presence(col)
    mi = mi_single(C, ip, ip, pseudocount=1e-9)
    p = np.bincount(col, minlength=5) / 5000
    H = -np.sum(p[p > 0] * np.log(p[p > 0]))
    assert abs(mi - H) < 1e-4


def test_independent_columns_mi_near_zero():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 4, size=20000).astype(np.uint8)
    b = rng.integers(0, 4, size=20000).astype(np.uint8)
    w = np.ones(20000)
    mi = mi_single(crosstab_pair(a, b, w), _presence(a), _presence(b), 0.5)
    assert 0 <= mi < 5e-3


def test_mi_symmetry():
    """MI(i,j) == MI(j,i): swapping roles transposes the crosstable."""
    rng = np.random.default_rng(2)
    a = rng.integers(0, 5, size=300).astype(np.uint8)
    b = rng.integers(0, 5, size=300).astype(np.uint8)
    w = rng.random(300)
    mi_ij = mi_single(crosstab_pair(a, b, w), _presence(a), _presence(b), 0.5)
    mi_ji = mi_single(crosstab_pair(b, a, w), _presence(b), _presence(a), 0.5)
    assert abs(mi_ij - mi_ji) < 1e-12


def test_jax_matches_oracle_batch():
    """Batched jnp MI == float64 oracle within f32 tolerance."""
    rng = np.random.default_rng(3)
    S, P = 200, 50
    a = rng.integers(0, 5, size=(S, P)).astype(np.uint8)
    b = rng.integers(0, 5, size=(S, P)).astype(np.uint8)
    w = rng.random(S)
    C = np.stack([crosstab_pair(a[:, k], b[:, k], w) for k in range(P)])
    ip = np.stack([_presence(a[:, k]) for k in range(P)])
    jp = np.stack([_presence(b[:, k]) for k in range(P)])
    want = np.array([mi_single(C[k], ip[k], jp[k], 0.5) for k in range(P)])
    got = np.asarray(
        mi_from_crosstabs(
            jnp.asarray(C, jnp.float32), jnp.asarray(ip, jnp.float32),
            jnp.asarray(jp, jnp.float32), 0.5,
        )
    )
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_tile_mi_matches_oracle_including_gaps():
    """Full tile path (crosstab matmul + both MI variants) vs oracle."""
    al = random_alignment(n_samples=100, n_loci=12, seed=4, gap_frac=0.25)
    S, L = al.n_samples, al.n_loci
    w = al.weights
    oh = np.zeros((S, L, N_STATES), dtype=np.float32)
    np.put_along_axis(oh, al.codes[:, :, None].astype(np.int64), 1, axis=2)
    xi_w = (oh * w[:, None, None]).reshape(S, L * N_STATES)
    xj = oh.reshape(S, L * N_STATES)
    ip = al.state_presence.astype(np.float32)
    ipw = al.state_presence_wo_gaps.astype(np.float32)

    mi, mi_wog = tile_mi(
        jnp.asarray(xi_w), jnp.asarray(xj),
        jnp.asarray(ip), jnp.asarray(ip),
        jnp.asarray(ipw), jnp.asarray(ipw), 0.5,
    )
    mi = np.asarray(mi)
    mi_wog = np.asarray(mi_wog)

    for i in range(L):
        for j in range(L):
            if i == j:
                continue
            C = crosstab_pair(al.codes[:, i], al.codes[:, j], w)
            want = mi_single(C, al.state_presence[i], al.state_presence[j], 0.5)
            want_wog = mi_single(
                C, al.state_presence_wo_gaps[i], al.state_presence_wo_gaps[j], 0.5
            )
            assert abs(mi[i, j] - want) < 5e-5, (i, j)
            assert abs(mi_wog[i, j] - want_wog) < 5e-5, (i, j)


def test_gap_exclusion_uses_raw_counts_quirk():
    """The wo-gaps variant reuses the *raw* crosstable (gap cells leak
    into the j-marginal row sums, mi.hpp:173) — oracle encodes this;
    make sure a gap-heavy pair exercises the difference."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 5, size=400).astype(np.uint8)
    b = rng.integers(0, 5, size=400).astype(np.uint8)
    w = np.ones(400)
    C = crosstab_pair(a, b, w)
    full = mi_single(C, _presence(a), _presence(b), 0.5)
    ipw, jpw = _presence(a).copy(), _presence(b).copy()
    ipw[4] = jpw[4] = False
    wog = mi_single(C, ipw, jpw, 0.5)
    assert full != wog  # gap contribution must matter on gap-rich data


def test_unit_weights_match_integer_counts():
    """weight==1 for all samples reproduces plain count tables."""
    rng = np.random.default_rng(6)
    a = rng.integers(0, 4, size=100).astype(np.uint8)
    b = rng.integers(0, 4, size=100).astype(np.uint8)
    C = crosstab_pair(a, b, np.ones(100))
    ref = np.zeros((5, 5))
    for x, y in zip(a, b):
        ref[x, y] += 1
    np.testing.assert_array_equal(C, ref)
