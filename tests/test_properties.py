"""Property tests from SURVEY §4's test plan: sample-permutation
invariance, weight-1 ⇔ unweighted counts, duplicated-column MI."""

import numpy as np

from spydrpick_jax.engine.solver import EngineConfig, MIEngine
from spydrpick_jax.ops.reference import crosstab_pair, mi_single

from tests.conftest import random_alignment


def test_sample_permutation_invariance():
    """Permuting the samples (and their weights) must not change MI —
    the analogue of the reference's accumulation-order freedom under
    TBB scheduling (only f32 summation order differs)."""
    al = random_alignment(n_samples=60, n_loci=48, seed=90, gap_frac=0.1)
    def key(e):
        o = np.lexsort((e.jpos, e.ipos))
        return e.ipos[o], e.jpos[o], e.mi[o]

    e1 = MIEngine(al, EngineConfig(tile=16)).sweep(-1.0)
    perm = np.random.default_rng(1).permutation(al.n_samples)
    al2 = random_alignment(n_samples=60, n_loci=48, seed=90, gap_frac=0.1)
    al2.codes = al2.codes[perm]
    al2.weights = al2.weights[perm]
    e2 = MIEngine(al2, EngineConfig(tile=16)).sweep(-1.0)
    i1, j1, m1 = key(e1)
    i2, j2, m2 = key(e2)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(j1, j2)
    np.testing.assert_allclose(m1, m2, rtol=1e-4, atol=1e-6)


def test_unit_weights_equal_unweighted_counts():
    """weight=1 for every sample ⇔ plain coincidence counts: the
    weighted crosstable must be exactly the integer count table."""
    al = random_alignment(n_samples=50, n_loci=8, seed=91, gap_frac=0.2)
    w1 = np.ones(al.n_samples)
    C = crosstab_pair(al.codes[:, 0], al.codes[:, 1], w1)
    counts = np.zeros((5, 5))
    for a, b in zip(al.codes[:, 0], al.codes[:, 1]):
        counts[a, b] += 1
    np.testing.assert_array_equal(C, counts)
    # and the engine with weights=None equals weights=ones bitwise
    al.weights = None
    e_none = MIEngine(al, EngineConfig(tile=8)).sweep(-1.0).sort_desc()
    al.weights = w1
    e_ones = MIEngine(al, EngineConfig(tile=8)).sweep(-1.0).sort_desc()
    np.testing.assert_array_equal(e_none.mi, e_ones.mi)


def test_duplicated_column_mi_is_maximal():
    """A duplicated column pairs with itself at the top of the ranking
    (MI ≈ H(col), the analytic maximum for that column)."""
    al = random_alignment(n_samples=200, n_loci=20, seed=92, gap_frac=0.0)
    al.codes[:, 15] = al.codes[:, 3]
    edges = MIEngine(al, EngineConfig(tile=8)).sweep(-1.0).sort_desc()
    assert (edges.ipos[0], edges.jpos[0]) == (3, 15)
    # analytic check: MI(X, X) == H(X) on the pseudocounted table
    C = crosstab_pair(al.codes[:, 3], al.codes[:, 15],
                      al.weights if al.weights is not None
                      else np.ones(al.n_samples))
    pres = al.state_presence
    got = mi_single(C, pres[3], pres[15], 0.5)
    np.testing.assert_allclose(edges.mi[0], got, rtol=1e-5)
