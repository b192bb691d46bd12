"""Position filter + sample weighting tests (reference README.md:49-56)."""

import numpy as np

from spydrpick_jax.core.alignment import Alignment
from spydrpick_jax.core.filter import FilterParams, filter_list, filter_mask
from spydrpick_jax.core.weights import (
    compute_sample_weights,
    hamming_distance_matrix,
)

from tests.conftest import random_alignment


def _align_from_cols(cols):
    codes = np.array(cols, dtype=np.uint8).T.copy()
    return Alignment(
        codes=codes,
        sample_names=[f"s{i}" for i in range(codes.shape[0])],
        id_string="t",
        translation=np.arange(codes.shape[1]),
        n_original_positions=codes.shape[1],
    )


def test_filter_rules():
    n = 100
    # column 0: monomorphic -> drop (needs >1 non-gap allele)
    c0 = [0] * n
    # column 1: two alleles, minor at exactly 1% -> keep (>= threshold)
    c1 = [1] * 99 + [2]
    # column 2: minor below 1% of samples? with n=100, 1 sample = 1% keep;
    #           make a 0.5% case impossible at n=100 -> use gaps instead
    # column 3: 16% gaps -> drop (gap freq <= 15%)
    c3 = [0] * 42 + [1] * 42 + [4] * 16
    # column 4: 15% gaps exactly -> keep
    c4 = [0] * 43 + [1] * 42 + [4] * 15
    # column 5: two alleles but second-most-frequent is a gap -> only 1
    #           non-gap allele -> drop
    c5 = [0] * 90 + [4] * 10
    al = _align_from_cols([c0, c1, c3, c4, c5])
    mask = filter_mask(al)
    assert mask.tolist() == [False, True, False, True, False]


def test_filter_thresholds_configurable():
    n = 100
    c = [0] * 95 + [1] * 5  # 5% minor allele
    al = _align_from_cols([c])
    assert filter_mask(al, FilterParams(maf_threshold=0.05)).tolist() == [True]
    assert filter_mask(al, FilterParams(maf_threshold=0.06)).tolist() == [False]


def test_sample_weights_clusters():
    # two identical groups of sizes 3 and 1 -> weights 1/3 and 1
    codes = np.array(
        [[0, 1, 2, 3]] * 3 + [[3, 2, 1, 0]],
        dtype=np.uint8,
    )
    al = Alignment(
        codes=codes,
        sample_names=list("abcd"),
        id_string="t",
        translation=np.arange(4),
        n_original_positions=4,
    )
    w = compute_sample_weights(al, threshold=0.9)
    np.testing.assert_allclose(w, [1 / 3, 1 / 3, 1 / 3, 1.0])


def test_hamming_matrix():
    al = random_alignment(16, 30, seed=3)
    d = hamming_distance_matrix(al)
    # brute force
    ref = np.array(
        [[np.sum(a != b) for b in al.codes] for a in al.codes], dtype=np.int64
    )
    np.testing.assert_array_equal(d, ref)


def test_match_counts_streaming_path_parity(monkeypatch):
    """The host-streaming path (codes too large for device residency)
    must equal the device-resident path exactly, including multi-tile
    splits and pad columns."""
    from spydrpick_jax.core import weights as W

    al = random_alignment(24, 300, seed=9, gap_frac=0.2)
    resident = W.sample_match_counts(al, tile=128)  # 3 tiles, 84 pad cols
    monkeypatch.setattr(W, "_DEVICE_RESIDENT_BYTES", 0)
    streamed = W.sample_match_counts(al, tile=128)
    np.testing.assert_array_equal(resident, streamed)
    ref = np.array(
        [[np.sum(a == b) for b in al.codes] for a in al.codes],
        dtype=np.float32,
    )
    np.testing.assert_array_equal(resident, ref)


def test_match_counts_f64_group_flush(monkeypatch):
    """Alignments wider than the f32-exact bound flush partial counts
    into a host float64 accumulator per column group; shrinking the
    bound must not change the result (ADVICE r3: past ~16.7M columns
    f32 accumulation silently loses integer exactness)."""
    from spydrpick_jax.core import weights as W

    al = random_alignment(16, 700, seed=11, gap_frac=0.15)
    base = W.sample_match_counts(al, tile=128)
    # force the streaming path AND a flush every two 128-col tiles
    monkeypatch.setattr(W, "_DEVICE_RESIDENT_BYTES", 0)
    monkeypatch.setattr(W, "_EXACT_F32_COLS", 256)
    flushed = W.sample_match_counts(al, tile=128)
    assert flushed.dtype == np.float64
    np.testing.assert_array_equal(base, flushed)
    # resident path must also reroute to streaming past the bound
    monkeypatch.setattr(W, "_DEVICE_RESIDENT_BYTES", 1 << 40)
    rerouted = W.sample_match_counts(al, tile=128)
    np.testing.assert_array_equal(base, rerouted)


def test_weights_count_gap_as_state():
    # gap==gap counts as identity (5-state Hamming)
    codes = np.array([[4, 4, 0, 1], [4, 4, 0, 1]], dtype=np.uint8)
    al = Alignment(
        codes=codes, sample_names=["a", "b"], id_string="t",
        translation=np.arange(4), n_original_positions=4,
    )
    w = compute_sample_weights(al, threshold=1.0)
    np.testing.assert_allclose(w, [0.5, 0.5])
