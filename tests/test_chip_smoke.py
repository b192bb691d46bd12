"""CPU tests of chip_smoke.py's inputs and comparison helpers (the
phases themselves need a GPU)."""

import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _rows(pairs_mi, flags=None):
    """Couplings rows (pos1 pos2 distance flag mi)."""
    flags = flags or [0] * len(pairs_mi)
    return np.array([[p, q, q - p, f, m]
                     for ((p, q), m), f in zip(pairs_mi.items(), flags)], float)


def test_compare_identical_and_within_tolerance():
    want = _rows({(1, 5): 0.5, (2, 9): 0.3, (3, 4): 0.1})
    got = want.copy()
    got[:, 4] += 4e-6
    r = cs.compare_edge_rows(want, got, 5e-6)
    assert r["ok"] and r["common"] == 3 and r["max_dmi"] < 5e-6


def test_compare_flags_mi_and_threshold_edges():
    want = _rows({(1, 5): 0.5, (2, 9): 0.3, (3, 4): 0.1})
    # an MI beyond tolerance fails, naming the pair
    got = want.copy()
    got[1, 4] += 1e-4
    r = cs.compare_edge_rows(want, got, 5e-6)
    assert not r["ok"] and "(2, 9)" in r["first"]
    # a pair missing at the save threshold is allowed; a strong one is not
    assert cs.compare_edge_rows(want, want[:2], 5e-6)["ok"]
    r = cs.compare_edge_rows(want, want[1:], 5e-6)
    assert not r["ok"] and "only in want" in r["first"]
    # an ARACNE flag flip needs a near-tie on a shared position
    flipped = want.copy()
    flipped[0, 3] = 1
    assert not cs.compare_edge_rows(want, flipped, 5e-6)["ok"]
    tie = _rows({(1, 5): 0.5, (1, 9): 0.5 + 4e-6, (3, 4): 0.1})
    tie_flip = tie.copy()
    tie_flip[0, 3] = 1
    r = cs.compare_edge_rows(tie, tie_flip, 5e-6)
    assert r["ok"] and r["flag_diffs"] == 1


def test_make_codes_plants_couplings():
    codes, pairs = cs.make_codes(400, 64, seed=3, planted=3)
    assert codes.shape == (400, 64) and codes.max() <= 4
    assert len(pairs) == 3 and all(i < j for i, j in pairs)
    for i, j in pairs:
        both = (codes[:, i] < 4) & (codes[:, j] < 4)
        assert (codes[both, i] == codes[both, j]).mean() > 0.85
    assert abs((codes == 4).mean() - 0.05) < 0.01
    w = cs.make_weights(400, seed=3)
    assert 0.1 <= w.min() and w.max() <= 1.0


def test_numpy_compaction_reference_matches_route():
    import jax.numpy as jnp

    from spydrpick_jax.ops.compact import compact_edges_route

    rng = np.random.default_rng(0)
    mi = rng.random((8, 512)).astype(np.float32)
    mask = (rng.random((8, 512)) < 0.1) & (np.arange(512) > 16 + np.arange(8)[:, None])
    out = compact_edges_route(jnp.asarray(mi), None, jnp.asarray(mask), 16, 4096)
    for g, w in zip(cs.live_entries(out),
                    cs.numpy_compaction(mi, None, mask, 16, 0)):
        np.testing.assert_array_equal(g, w)


def test_refuses_without_gpu_and_prints_no_result():
    """On the CPU the script must fail and print no JSON result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         env=env, capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0
    assert not any(l.startswith("{") for l in out.stdout.splitlines())
    assert "no GPU" in out.stderr
