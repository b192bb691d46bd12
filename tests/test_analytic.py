"""Hand-derived analytic parity fixtures.

Every expected value in this file is computed BY HAND from the
reference semantics (include/mi.hpp:146-181, ARACNE.hpp:311-321,480-487)
as literal arithmetic — independently of ops/reference.py — so the
oracle itself, the f32 crosstable path, and the exact int8 path are all
pinned to the same externally-derived numbers.

Derivations are written out per fixture.  Notation: pc = pseudocount,
A = counts + pc on presence-masked cells, Z = masked sum of A,
MI = jointH - icondH - jcondH with icondH using the FULL row sum over
all i-states (the mi.hpp:173 SIMD-row quirk, live only when the
presence masks exclude states that still hold raw counts — i.e. the
gap-excluded re-evaluation, mi.hpp:466-490).
"""

import math

import numpy as np
import pytest

from spydrpick_jax.core.alignment import Alignment
from spydrpick_jax.engine.solver import EngineConfig, MIEngine

xlx = lambda p: p * math.log(p)


def _align(cols, weights=None):
    codes = np.array(cols, dtype=np.uint8).T.copy()
    return Alignment(
        codes=codes,
        sample_names=[f"s{i}" for i in range(codes.shape[0])],
        id_string="analytic",
        translation=np.arange(codes.shape[1], dtype=np.int64),
        n_original_positions=codes.shape[1],
        weights=weights,
    )


# --------------------------------------------------------------------- #
# Fixture A — gap-exclusion full-row-sum quirk, unit weights.
#
# col_i = [0, 0, 4, 4], col_j = [1, 4, 1, 4] (4 = gap), w = 1, pc = 0.5.
# Counts: C[0,1] = C[0,4] = C[4,1] = C[4,4] = 1.
#
# WITH gaps (ip = {0,4}, jp = {1,4}): A = 1.5 on the four cells, Z = 6,
# every P = 1/4; columns are independent so
#   MI = ln(1/4) - ln(1/2) - ln(1/2) = 0            (exactly)
#
# WITHOUT gaps (ipw = {0}, jpw = {1}): the crosstable is REUSED with the
# gap bit cleared (mi.hpp:123-129,472).  pm covers only cell (0,1):
# A[0,1] = 1.5, Z = 1.5, P[0,1] = 1 -> jointH = 0; jcondH = xlogx(1) = 0.
# icondH uses the FULL column sum over all i-states (mi.hpp:173):
# A[4,1] = C[4,1] = 1 (raw count, no pc — outside pm), so
#   amarg = (1.5 + 1) / 1.5 = 5/3,  icondH = (5/3)·ln(5/3)
#   MI_wog = -(5/3)·ln(5/3) ≈ -0.851375...
# (a masked marginal would give icondH = 0 and MI_wog = 0 — this fixture
# fails loudly if the quirk is ever "fixed")
# --------------------------------------------------------------------- #
A_COL_I = [0, 0, 4, 4]
A_COL_J = [1, 4, 1, 4]
A_MI = 0.0
A_MI_WOG = -(5.0 / 3.0) * math.log(5.0 / 3.0)


# --------------------------------------------------------------------- #
# Fixture B — the same quirk with non-trivial weights w = [2, 1, 1, 4].
#
# Counts: C[0,1] = 2, C[0,4] = 1, C[4,1] = 1, C[4,4] = 4.
# WITH gaps: A = [[2.5, 1.5], [1.5, 4.5]] on ({0,4} x {1,4}), Z = 10:
#   jointH = xlx(.25) + xlx(.15) + xlx(.15) + xlx(.45)
#   icondH = xlx(.40) + xlx(.60)   (column sums 4/10, 6/10)
#   jcondH = xlx(.40) + xlx(.60)   (row sums    4/10, 6/10)
# WITHOUT gaps: pm = {(0,1)}, A[0,1] = 2.5, Z = 2.5, P = 1:
#   jointH = 0, jcondH = 0,
#   icondH = xlogx((2.5 + C[4,1]) / 2.5) = xlx(1.4)
#   MI_wog = -1.4·ln(1.4)
# --------------------------------------------------------------------- #
B_W = [2.0, 1.0, 1.0, 4.0]
B_MI = (xlx(0.25) + xlx(0.15) + xlx(0.15) + xlx(0.45)) \
    - (xlx(0.4) + xlx(0.6)) - (xlx(0.4) + xlx(0.6))
B_MI_WOG = -1.4 * math.log(1.4)


# --------------------------------------------------------------------- #
# Fixture C — duplicated gap-free column (MI ~ column entropy).
#
# col = [0, 0, 1, 1] twice, w = 1, pc = 0.5.  C = diag(2, 2) on {0,1}:
# A = [[2.5, .5], [.5, 2.5]], Z = 6; marginals all 3/6 = 1/2:
#   MI = xlx(2.5/6)·2 + xlx(0.5/6)·2 - 4·xlx(1/2)
# No gaps anywhere -> mi_wog must EQUAL mi (the formatter default,
# SpydrPick.hpp:106-107).
# --------------------------------------------------------------------- #
C_MI = 2 * xlx(2.5 / 6) + 2 * xlx(0.5 / 6) - 4 * xlx(0.5)


@pytest.mark.parametrize(
    "cols,weights,exp_mi,exp_wog",
    [
        ([A_COL_I, A_COL_J], None, A_MI, A_MI_WOG),
        ([A_COL_I, A_COL_J], B_W, B_MI, B_MI_WOG),
        ([[0, 0, 1, 1], [0, 0, 1, 1]], None, C_MI, C_MI),
    ],
    ids=["quirk-unit", "quirk-weighted", "dup-column"],
)
def test_hand_derived_mi_all_paths(cols, weights, exp_mi, exp_wog):
    """Oracle, XLA batch kernel, and the engine sweep must all hit the
    hand-derived numbers."""
    from spydrpick_jax.ops.mi import mi_from_crosstabs
    from spydrpick_jax.ops.reference import crosstab_pair, mi_single

    al = _align(cols, None if weights is None else np.asarray(weights))
    w = np.ones(4) if weights is None else np.asarray(weights, np.float64)

    # 1. f64 oracle (ops/reference.py) against the hand value
    C = crosstab_pair(al.codes[:, 0], al.codes[:, 1], w)
    ip, jp = al.state_presence[0], al.state_presence[1]
    ipw, jpw = al.state_presence_wo_gaps[0], al.state_presence_wo_gaps[1]
    assert mi_single(C, ip, jp, 0.5) == pytest.approx(exp_mi, abs=1e-12)
    assert mi_single(C, ipw, jpw, 0.5) == pytest.approx(exp_wog, abs=1e-12)

    # 2. the vectorised XLA crosstable math (f32 — x64 stays off here)
    got = np.asarray(mi_from_crosstabs(
        C[None], ip[None].astype(np.float64), jp[None].astype(np.float64),
        0.5))
    assert got[0] == pytest.approx(exp_mi, abs=2e-6)

    # 3. the production engine sweep (f32): both stored variants
    eng = MIEngine(al, EngineConfig(tile=8, wog_fetch="full"))
    edges = eng.sweep(-10.0)
    k = {(i, j): (m, wg) for i, j, m, wg in
         zip(edges.ipos, edges.jpos, edges.mi, edges.mi_wog)}
    m, wg = k[(0, 1)]
    assert m == pytest.approx(exp_mi, abs=2e-6)
    assert wg == pytest.approx(exp_wog, abs=2e-6)


def test_hand_derived_mi_int8_unit():
    """The exact int8 unit-weight crosstable (auto-selected for unit
    weights) hits the same hand-derived quirk numbers (fixture A
    embedded in a 256-column alignment, dual variant on)."""
    cols = [A_COL_I, A_COL_J] + [[0, 1, 0, 1]] * 254
    al = _align(cols)
    eng = MIEngine(al, EngineConfig(tile=128, wog_fetch="full"))
    assert eng.statics.int8_mode == "unit"
    edges = eng.sweep(-10.0)
    k = {(i, j): (m, wg) for i, j, m, wg in
         zip(edges.ipos, edges.jpos, edges.mi, edges.mi_wog)}
    m, wg = k[(0, 1)]
    assert m == pytest.approx(A_MI, abs=2e-6)
    assert wg == pytest.approx(A_MI_WOG, abs=2e-6)


# --------------------------------------------------------------------- #
# Fixture D — gap-row mass spread over TWO present j-states (the
# mi.hpp:173 full-row-sum quirk with a non-degenerate wo-gaps table).
#
# col_i = [0, 0, 1, 4, 4], col_j = [2, 3, 2, 2, 3], w = 1, pc = 0.5.
# Counts: C[0,2]=1, C[0,3]=1, C[1,2]=1, C[4,2]=1, C[4,3]=1.
#
# WITHOUT gaps (ipw = {0,1}, jpw = {2,3}; gap row 4 keeps raw counts):
#   A (masked cells) = [[1.5, 1.5], [1.5, 0.5]] on {0,1}x{2,3}, Z = 5.
#   jointH = xlx(.3)+xlx(.3)+xlx(.3)+xlx(.1)
#   icondH (FULL column sums incl. row 4's raw counts, /Z):
#     col 2: (1.5+1.5+1)/5 = 0.8 ; col 3: (1.5+0.5+1)/5 = 0.6
#     icondH = xlx(0.8) + xlx(0.6)      <- 1.4 > 1: quirk visible
#   jcondH (masked row sums): xlx(0.6) + xlx(0.4)
#   MI_wog = jointH - icondH - jcondH
# (a mask-correct icondH would use 0.6/0.4 — the hand value below pins
# the quirk with BOTH present j-states carrying gap-row mass)
# --------------------------------------------------------------------- #
D_COL_I = [0, 0, 1, 4, 4]
D_COL_J = [2, 3, 2, 2, 3]
D_MI_WOG = (xlx(0.3) + xlx(0.3) + xlx(0.3) + xlx(0.1)) \
    - (xlx(0.8) + xlx(0.6)) - (xlx(0.6) + xlx(0.4))


def test_gap_row_mass_two_present_jstates():
    """Fixture D: quirk value with gap mass under two present j-states,
    oracle + engine (wo-gaps variant)."""
    from spydrpick_jax.ops.reference import crosstab_pair, mi_single

    al = _align([D_COL_I, D_COL_J])
    w = np.ones(5)
    C = crosstab_pair(al.codes[:, 0], al.codes[:, 1], w)
    ipw, jpw = al.state_presence_wo_gaps[0], al.state_presence_wo_gaps[1]
    assert mi_single(C, ipw, jpw, 0.5) == pytest.approx(D_MI_WOG, abs=1e-12)

    eng = MIEngine(al, EngineConfig(tile=8, wog_fetch="full"))
    edges = eng.sweep(-10.0)
    k = {(i, j): wg for i, j, wg in
         zip(edges.ipos, edges.jpos, edges.mi_wog)}
    assert k[(0, 1)] == pytest.approx(D_MI_WOG, abs=2e-6)


# --------------------------------------------------------------------- #
# Filter boundary equality (README.md:49: MAF "at least" 1%, gaps
# "at most" 15% — both INCLUSIVE).  n = 200 samples so the boundary
# frequencies are exact binary-rational quotients of the thresholds.
# --------------------------------------------------------------------- #

def test_filter_boundaries_inclusive():
    from spydrpick_jax.core.filter import FilterParams, filter_mask

    n = 200
    def col(second_count, gap_count):
        c = np.zeros(n, np.uint8)          # majority state 0
        c[:second_count] = 1               # minor allele
        c[n - gap_count:] = 4              # gaps
        assert second_count + gap_count <= n
        return c

    cols = [
        col(2, 0),    # MAF = 2/200 = 0.01 exactly -> KEPT ("at least")
        col(1, 0),    # MAF = 0.005 < 0.01        -> dropped
        col(4, 30),   # gaps = 30/200 = 0.15 exactly -> KEPT ("at most")
        col(4, 31),   # gaps = 0.155 > 0.15          -> dropped
        col(0, 0),    # single allele                -> dropped
        col(2, 30),   # both exactly at boundary     -> KEPT
    ]
    al = _align([c.tolist() for c in cols])
    mask = filter_mask(al, FilterParams(maf_threshold=0.01,
                                        gap_threshold=0.15))
    assert mask.tolist() == [True, False, True, False, False, True]


# --------------------------------------------------------------------- #
# Circular distance at the exact half-genome tie (mi.hpp:313-320:
# min(d, G - d); at d == G/2 both arms agree) and the STRICT ld
# inequality on colmax gating (mi.hpp:423-427: dist > ld).
# --------------------------------------------------------------------- #

def test_circular_half_genome_tie_and_strict_ld():
    G = 16
    # two perfectly coupled columns at original positions 0 and 8 = G/2
    rng = np.random.default_rng(3)
    base = rng.integers(0, 2, size=40)
    codes = np.stack([base, base], axis=1).astype(np.uint8)
    al = Alignment(codes, [f"s{i}" for i in range(40)], "half",
                   np.array([0, 8], dtype=np.int64), G)
    # distance = min(8, 16-8) = 8 on both arms
    eng = MIEngine(al, EngineConfig(tile=8, ld_threshold=8))
    e = eng.sweep(-10.0)
    assert e.n_edges == 1  # storage is NOT ld-gated (mi.hpp:430-434)
    # colmax IS: dist 8 > ld 8 is FALSE -> no colmax contribution
    assert not np.isfinite(e.colmax).any()
    eng2 = MIEngine(al, EngineConfig(tile=8, ld_threshold=7))
    e2 = eng2.sweep(-10.0)
    assert np.isfinite(e2.colmax).all()  # 8 > 7 -> tracked


# --------------------------------------------------------------------- #
# Weight w == w duplicated rows: integer weights make every crosstable
# count identical (exact integer arithmetic in both paths), so the two
# engines' edge sets must match BIT FOR BIT — an oracle-independent
# identity of the weighting semantics (apegrunt cache_sample_weights
# consumption at mi_parameters.hpp:53-60).
# --------------------------------------------------------------------- #

def test_integer_weights_equal_duplicated_rows_bitwise():
    rng = np.random.default_rng(9)
    S, L = 12, 24
    codes = rng.integers(0, 4, size=(S, L)).astype(np.uint8)
    codes[rng.random((S, L)) < 0.1] = 4
    w = rng.integers(1, 4, size=S).astype(np.float64)  # 1..3 copies
    al_w = _align(codes.T.tolist(), weights=w)
    dup = np.repeat(codes, w.astype(int), axis=0)
    al_d = _align(dup.T.tolist())   # unit weights
    e_w = MIEngine(al_w, EngineConfig(tile=8, wog_fetch="full")) \
        .sweep(-10.0).sort_desc()
    e_d = MIEngine(al_d, EngineConfig(tile=8, wog_fetch="full")) \
        .sweep(-10.0).sort_desc()
    np.testing.assert_array_equal(e_w.ipos, e_d.ipos)
    np.testing.assert_array_equal(e_w.jpos, e_d.jpos)
    np.testing.assert_array_equal(e_w.mi, e_d.mi)
    np.testing.assert_array_equal(e_w.mi_wog, e_d.mi_wog)
    np.testing.assert_array_equal(e_w.colmax, e_d.colmax)


# --------------------------------------------------------------------- #
# Weighted tournament: determine_mi_threshold vs an independent
# from-scratch reimplementation (sampling replicated seed-for-seed;
# per-pair MI computed with the formula hand-written below, f64).
# --------------------------------------------------------------------- #

def _mi_pair_independent(ci, cj, w, pc=0.5):
    """Hand-written mi.hpp:146-181 (full-row-sum icondH), no imports
    from the package's math modules."""
    C = np.zeros((5, 5))
    for a, b, ww in zip(ci, cj, w):
        C[a, b] += ww
    ip = np.zeros(5, bool)
    ip[np.unique(ci)] = True
    jp = np.zeros(5, bool)
    jp[np.unique(cj)] = True
    pm = np.outer(ip, jp)
    A = C + pc * pm
    Z = A[pm].sum()
    P = A / Z
    f = lambda x: x * np.log(x) if x > 0 else 0.0
    jointH = sum(f(P[a, b]) for a in range(5) for b in range(5) if pm[a, b])
    icondH = sum(f(P[:, b].sum()) for b in range(5) if jp[b])  # FULL column
    jcondH = sum(f(P[a, jp].sum()) for a in range(5) if ip[a])
    return jointH - icondH - jcondH


def test_weighted_tournament_matches_independent_estimator():
    from spydrpick_jax.engine.threshold import (
        determine_mi_threshold,
        determine_threshold_pairs,
        sample_pairs,
    )

    rng0 = np.random.default_rng(11)
    S, L = 30, 60
    codes = rng0.integers(0, 4, size=(S, L)).astype(np.uint8)
    codes[rng0.random((S, L)) < 0.1] = 4
    w = rng0.random(S) * 2 + 0.25
    al = _align(codes.T.tolist(), weights=w)
    eng = MIEngine(al, EngineConfig(tile=8))

    n_values, iters, seed, req_pairs = 40, 3, 7, 120
    got = determine_mi_threshold(eng, n_values, threshold_pairs=req_pairs,
                                 iterations=iters, seed=seed)

    # independent replication (same published sampling contract)
    possible = L * (L - 1) // 2
    percentile = 1.0 - n_values / possible
    pairs_n = determine_threshold_pairs(req_pairs, possible, percentile)
    idx = min(int(percentile * pairs_n), pairs_n - 1)
    rng = np.random.default_rng(seed)
    ests = []
    for _ in range(iters):
        ii, jj = sample_pairs(rng, pairs_n, L)
        vals = np.array([
            _mi_pair_independent(codes[:, i], codes[:, j], w)
            for i, j in zip(ii, jj)
        ])
        ests.append(np.sort(vals)[idx])
    ests = np.asarray(ests)
    exp = np.sort(ests)[len(ests) // 2 - (0 if len(ests) % 2 else 1)]
    assert got == pytest.approx(exp, abs=5e-6)  # engine evaluates in f32


# --------------------------------------------------------------------- #
# ARACNE tie semantics (ARACNE.hpp:311-321 rule, 480-487 tie rewind).
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("use_native", [False, True])
def test_aracne_equal_triangle_threshold_zero(use_native):
    """Equal-MI triangle at threshold 0: every edge is the minimum of
    its triangle with margin 0, which passes ``mid - min >= 0`` — all
    three marked indirect (flags 0).  At any positive threshold the
    margin fails — all direct.  This is the exact case the reference's
    equal-MI block-boundary rewind exists to get right."""
    from spydrpick_jax.engine.aracne import run_aracne

    i = np.array([0, 0, 1])
    j = np.array([1, 2, 2])
    w = np.array([0.7, 0.7, 0.7])
    assert run_aracne(i, j, w, threshold=0.0,
                      use_native=use_native).tolist() == [0, 0, 0]
    assert run_aracne(i, j, w, threshold=1e-15,
                      use_native=use_native).tolist() == [1, 1, 1]


@pytest.mark.parametrize("use_native", [False, True])
def test_aracne_tie_run_order_independent(use_native):
    """Flags must not depend on the order of edges within an equal-MI
    run (the reference guarantees this by rewinding block starts over
    ties, ARACNE.hpp:480-487; the closed form is order-free by
    construction).  Mixed graph: a tied triangle chained to a strictly
    weaker edge."""
    from spydrpick_jax.engine.aracne import run_aracne

    # triangle (0,1,2) all at 0.5; edge (2,3) at 0.5 (same run, no
    # triangle); edge (0,3) at 0.2 -> triangle (0,2,3) has min 0.2
    i = np.array([0, 0, 1, 2, 0])
    j = np.array([1, 2, 2, 3, 3])
    w = np.array([0.5, 0.5, 0.5, 0.5, 0.2])
    base = None
    for perm_seed in range(4):
        order = np.random.default_rng(perm_seed).permutation(len(w))
        flags = run_aracne(i[order], j[order], w[order], threshold=0.0,
                           use_native=use_native)
        keyed = {(a, b): f for a, b, f in zip(i[order], j[order], flags)}
        if base is None:
            base = keyed
        assert keyed == base
    # hand check: triangle edges all indirect (tie at thr 0); (2,3) has
    # common neighbour 0 with min(w02, w03) = 0.2 < 0.5 -> direct;
    # (0,3)'s triangle min is itself with margin 0.3 >= 0 -> indirect
    assert base == {(0, 1): 0, (0, 2): 0, (1, 2): 0, (2, 3): 1, (0, 3): 0}


@pytest.mark.parametrize("use_native", [False, True])
def test_aracne_tie_straddling_reference_block_boundary(use_native):
    """The reference streams edges in 16384-edge blocks and rewinds the
    block start over an equal-MI run crossing the boundary
    (ARACNE.hpp:480-487).  Build a graph whose tied run would straddle
    that boundary and check the closed form treats every tied triangle
    alike regardless of position in the sorted stream."""
    from spydrpick_jax.engine.aracne import run_aracne

    rng = np.random.default_rng(5)
    # filler: a long descending run of isolated (triangle-free) edges
    n_fill = 16384
    fi = np.arange(n_fill) * 2 + 100
    fj = fi + 1
    fw = np.linspace(0.9, 0.61, n_fill)
    # the tied run at 0.6 crossing the 16384 boundary: K disjoint
    # triangles, all edges tied
    K = 6
    ti, tj, tw = [], [], []
    for t in range(K):
        a = 50_000 + 3 * t
        ti += [a, a, a + 1]
        tj += [a + 1, a + 2, a + 2]
        tw += [0.6, 0.6, 0.6]
    i = np.concatenate([fi, ti])
    j = np.concatenate([fj, tj])
    w = np.concatenate([fw, tw])
    order = np.argsort(-w, kind="stable")
    flags = run_aracne(i[order], j[order], w[order], threshold=0.0,
                       use_native=use_native)
    keyed = {(a, b): f for a, b, f in zip(i[order], j[order], flags)}
    for t in range(K):  # every tied triangle fully indirect
        a = 50_000 + 3 * t
        assert keyed[(a, a + 1)] == 0
        assert keyed[(a, a + 2)] == 0
        assert keyed[(a + 1, a + 2)] == 0
    assert all(keyed[(a, b)] == 1 for a, b in zip(fi, fj))  # fillers direct


def test_empty_colmax_quartiles_use_boost_lowest_not_inf():
    """Positions that never see a pair past the LD threshold keep an
    EMPTY max accumulator; the reference's boost ``acc::max`` yields
    ``lowest()`` (-1.8e308), NOT -inf (mi.hpp:244-290).  The distinction
    is live when > 3/4 of positions are empty: Q3 = Q1 = lowest() gives
    IQR = 0 and outlier threshold = lowest() — the reference flags
    EVERY stored edge as an outlier.  -inf quartiles would give
    IQR = NaN and flag none."""
    from spydrpick_jax.engine.outliers import outlier_thresholds, quartile

    low = np.finfo(np.float64).min

    # > 3/4 empty: both quartiles collapse to lowest(), IQR = 0
    colmax = np.full(8, -np.inf)
    colmax[0] = 0.5
    assert quartile(colmax, 1) == low
    assert quartile(colmax, 3) == low
    out, ext = outlier_thresholds(colmax)
    assert out == low and ext == low          # NOT NaN
    assert 0.123 > out                        # every edge flags outlier

    # only Q1 empty (3 of 8 positions; Q1 = vals[8//4] = vals[2]):
    # fence overflows to +inf in f64 — no outliers, the same behaviour
    # the reference's finite lowest() produces
    colmax = np.array([-np.inf, -np.inf, -np.inf, 0.2, 0.3, 0.4, 0.5, 0.6])
    assert quartile(colmax, 1) == low
    assert quartile(colmax, 3) == 0.5
    out, ext = outlier_thresholds(colmax)
    assert math.isinf(out) and out > 0
    assert math.isinf(ext) and ext > 0

    # no empties: plain indexing quartiles, untouched by the mapping
    colmax = np.arange(8, dtype=np.float64)
    assert quartile(colmax, 1) == 2.0 and quartile(colmax, 3) == 6.0
    out, ext = outlier_thresholds(colmax)
    assert out == 6.0 + 1.5 * 4.0 and ext == 6.0 + 3.0 * 4.0
