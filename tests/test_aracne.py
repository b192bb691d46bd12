"""ARACNE DPI tests: hand-built triangles incl. equal-MI ties
(reference tie semantics ARACNE.hpp:480-487, rule :311-313, flag
polarity :399-405) and a randomized cross-check against a literal
triangle-enumeration oracle."""

import itertools

import numpy as np
import pytest

from spydrpick_jax.engine.aracne import aracne_mark_indirect, run_aracne


def oracle_mark(ipos, jpos, mi, threshold):
    """Literal reference rule: for every 3-clique, mark the min-MI
    edge(s) iff midval - minval >= threshold (ARACNE.hpp:296-324)."""
    E = len(mi)
    edge_of = {}
    for k, (a, b) in enumerate(zip(ipos, jpos)):
        edge_of[(a, b)] = k
        edge_of[(b, a)] = k
    nodes = sorted({*ipos, *jpos})
    marked = np.zeros(E, dtype=bool)
    for a, b, c in itertools.combinations(nodes, 3):
        if (a, b) in edge_of and (b, c) in edge_of and (a, c) in edge_of:
            ks = [edge_of[(a, b)], edge_of[(b, c)], edge_of[(a, c)]]
            ws = sorted(mi[k] for k in ks)
            if ws[1] - ws[0] >= threshold:
                for k in ks:
                    if mi[k] == ws[0]:
                        marked[k] = True
    return marked


def test_simple_triangle():
    #   0-1 strong, 1-2 strong, 0-2 weak -> 0-2 indirect
    ipos = np.array([0, 1, 0])
    jpos = np.array([1, 2, 2])
    mi = np.array([0.9, 0.8, 0.3])
    ind = aracne_mark_indirect(ipos, jpos, mi, threshold=1e-10)
    assert ind.tolist() == [False, False, True]
    flags = run_aracne(ipos, jpos, mi, use_native=False)
    assert flags.tolist() == [1, 1, 0]


def test_no_triangle_no_marking():
    ipos = np.array([0, 2, 4])
    jpos = np.array([1, 3, 5])
    mi = np.array([0.9, 0.1, 0.5])
    assert not aracne_mark_indirect(ipos, jpos, mi).any()


def test_equal_mi_triangle_tolerance():
    """All-equal triangle: midval-minval == 0 < eps -> nothing marked
    with the default threshold; with threshold=0 all three are marked."""
    ipos = np.array([0, 1, 0])
    jpos = np.array([1, 2, 2])
    mi = np.array([0.5, 0.5, 0.5])
    assert not aracne_mark_indirect(ipos, jpos, mi).any()
    assert aracne_mark_indirect(ipos, jpos, mi, threshold=0.0).all()


def test_two_way_tie_for_min():
    """Two edges tie for min below a strong edge: mid == min, so the DPI
    margin is 0 — nothing marked at positive threshold, both marked at
    threshold 0 (ARACNE.hpp:311-321 semantics)."""
    ipos = np.array([0, 1, 0])
    jpos = np.array([1, 2, 2])
    mi = np.array([0.9, 0.4, 0.4])
    assert not aracne_mark_indirect(ipos, jpos, mi, threshold=1e-10).any()
    ind0 = aracne_mark_indirect(ipos, jpos, mi, threshold=0.0)
    assert ind0.tolist() == [False, True, True]


def test_threshold_blocks_marking():
    ipos = np.array([0, 1, 0])
    jpos = np.array([1, 2, 2])
    mi = np.array([0.9, 0.8, 0.75])
    assert not aracne_mark_indirect(ipos, jpos, mi, threshold=0.1).any()
    assert aracne_mark_indirect(ipos, jpos, mi, threshold=0.01).tolist() == [
        False, False, True]


def test_shared_edge_multiple_triangles():
    """An edge can survive one triangle but fall in another."""
    # edges: 0-1 (0.2), 0-2 (0.9), 1-2 (0.8), 1-3 (0.1), 0-3 (0.05)
    ipos = np.array([0, 0, 1, 1, 0])
    jpos = np.array([1, 2, 2, 3, 3])
    mi = np.array([0.2, 0.9, 0.8, 0.1, 0.05])
    ind = aracne_mark_indirect(ipos, jpos, mi, threshold=1e-10)
    # triangle (0,1,2): min 0.2 -> edge 0 marked
    # triangle (0,1,3): min 0.05 -> edge 4 (0-3) marked; 1-3 is mid
    assert ind.tolist() == [True, False, False, False, True]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("threshold", [1e-12, 0.0, 0.05])
def test_random_graph_vs_oracle(seed, threshold):
    rng = np.random.default_rng(seed)
    n_nodes = 12
    pairs = [(a, b) for a in range(n_nodes) for b in range(a + 1, n_nodes)]
    take = rng.random(len(pairs)) < 0.45
    pairs = [p for p, t in zip(pairs, take) if t]
    ipos = np.array([p[0] for p in pairs])
    jpos = np.array([p[1] for p in pairs])
    mi = rng.random(len(pairs))
    # inject some exact ties
    if len(mi) > 6:
        mi[3] = mi[1]
        mi[5] = mi[2]
    want = oracle_mark(ipos, jpos, mi, threshold)
    got = aracne_mark_indirect(ipos, jpos, mi, threshold)
    np.testing.assert_array_equal(got, want)


def test_non_dense_node_ids():
    """Node ids need not be dense (reference remaps, ARACNE.hpp:50-88)."""
    ipos = np.array([100, 500, 100])
    jpos = np.array([500, 900, 900])
    mi = np.array([0.9, 0.8, 0.3])
    ind = aracne_mark_indirect(ipos, jpos, mi, 1e-10)
    assert ind.tolist() == [False, False, True]
