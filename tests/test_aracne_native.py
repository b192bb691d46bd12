"""Native (C++) ARACNE kernel: parity with the NumPy implementation."""

import numpy as np
import pytest

from spydrpick_jax.engine.aracne import aracne_mark_indirect

try:
    from spydrpick_jax.native import aracne_native

    aracne_native._load()
    HAVE_NATIVE = True
except Exception:  # pragma: no cover - toolchain missing
    HAVE_NATIVE = False

pytestmark = pytest.mark.skipif(not HAVE_NATIVE, reason="g++ toolchain unavailable")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("threshold", [1e-12, 0.0, 0.05])
def test_native_matches_numpy(seed, threshold):
    rng = np.random.default_rng(seed)
    n_nodes = 40
    pairs = [(a, b) for a in range(n_nodes) for b in range(a + 1, n_nodes)]
    take = rng.random(len(pairs)) < 0.3
    pairs = [p for p, t in zip(pairs, take) if t]
    ipos = np.array([p[0] for p in pairs], dtype=np.int64)
    jpos = np.array([p[1] for p in pairs], dtype=np.int64)
    mi = rng.random(len(pairs))
    if len(mi) > 8:  # exact ties
        mi[3] = mi[1]
        mi[7] = mi[2]
    want = aracne_mark_indirect(ipos, jpos, mi, threshold)
    got = aracne_native.mark_indirect(ipos, jpos, mi, threshold)
    np.testing.assert_array_equal(got, want)


def test_native_sparse_ids_and_scale():
    rng = np.random.default_rng(9)
    E = 20000
    ipos = rng.integers(0, 100000, size=E)
    jpos = ipos + rng.integers(1, 50, size=E)
    # dedupe
    keys, idx = np.unique(ipos * (1 << 20) + jpos, return_index=True)
    ipos, jpos = ipos[idx], jpos[idx]
    mi = rng.random(len(ipos))
    want = aracne_mark_indirect(ipos, jpos, mi, 1e-10)
    got = aracne_native.mark_indirect(ipos, jpos, mi, 1e-10)
    np.testing.assert_array_equal(got, want)
