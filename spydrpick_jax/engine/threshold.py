"""Tournament-style MI save-threshold estimation.

Reference semantics (``determine_MI_threshold`` / ``sample_pairs`` /
``determine_threshold_pairs``, include/SpydrPick.hpp:171-343, driven at
src/SpydrPick.cpp:336-364):

  * target count of saved values: ``--mi-values``, else
    ``min(1e7, 100 * n_loci)`` (SpydrPick.cpp:338-339; NB the help text
    says "#samples*100" but the code uses n_loci — we follow the code);
  * percentile = 1 - n_values / possible_pairs (SpydrPick.hpp:298);
  * sample size auto-rule: start at 100k, grow by 10k while the tail
    above the percentile holds < 100 values, cap 500k, and never more
    than possible_pairs/10 (SpydrPick.hpp:257-282);
  * 10 iterations (``--mi-threshold-iterations``): sample unique (i<j)
    pairs uniformly, evaluate MI, take the value at
    ``floor(percentile * pairs)`` of the ascending order statistics
    (std::nth_element, SpydrPick.hpp:329-330);
  * final threshold: lower median of the iteration estimates
    (SpydrPick.hpp:339-342).

Determinism fix called out in SURVEY §5: the reference seeds mt19937
from the wall clock (SpydrPick.hpp:178) making runs irreproducible;
we use an explicit ``--seed``.
"""

from __future__ import annotations

import numpy as np

from spydrpick_jax.engine.solver import MIEngine


def determine_threshold_pairs(
    threshold_pairs: int, possible_pairs: int, threshold_percentile: float
) -> int:
    """Auto sample size (SpydrPick.hpp:257-282, replicated exactly)."""
    if threshold_pairs == 0:
        threshold_pairs = 100_000
        desired_tail = 100
        cap = 500_000
        while (
            threshold_pairs - threshold_percentile * threshold_pairs < desired_tail
            and threshold_pairs < cap
        ):
            threshold_pairs += 10_000
    if possible_pairs // 10 < threshold_pairs:
        threshold_pairs = possible_pairs // 10
    return threshold_pairs


def sample_pairs(rng: np.random.Generator, n_pairs: int, n_loci: int) -> tuple[np.ndarray, np.ndarray]:
    """Unique uniform (i < j) pairs (SpydrPick.hpp:171-207 semantics,
    seeded RNG instead of wall clock)."""
    collected = np.empty(0, dtype=np.int64)
    while len(collected) < n_pairs:
        need = n_pairs - len(collected)
        a = rng.integers(0, n_loci, size=int(need * 1.3) + 16)
        b = rng.integers(0, n_loci, size=len(a))
        ok = a != b
        a, b = a[ok], b[ok]
        keys = np.minimum(a, b) * n_loci + np.maximum(a, b)
        new = np.setdiff1d(keys, collected)  # unique, not yet drawn
        collected = np.concatenate([collected, new])
    # unbiased truncation to exactly n_pairs
    collected = rng.permutation(collected)[:n_pairs]
    return collected // n_loci, collected % n_loci


def determine_mi_threshold(
    engine: MIEngine,
    n_values: int,
    threshold_pairs: int = 0,
    iterations: int = 10,
    seed: int = 42,
    verbose_out=None,
) -> float:
    """Estimate the MI save threshold (SpydrPick.hpp:284-343)."""
    n_loci = engine.L
    possible_pairs = n_loci * (n_loci - 1) // 2
    percentile = 1.0 - float(n_values) / possible_pairs
    pairs_n = determine_threshold_pairs(threshold_pairs, possible_pairs, percentile)
    if pairs_n <= 0 or percentile <= 0.0:
        # n_values >= possible_pairs (tiny alignments): every pair would
        # be saved anyway; a negative percentile would otherwise produce
        # an opaque negative-partition-index error below
        raise ValueError(
            f"alignment too small for threshold estimation ({possible_pairs} possible "
            f"pairs <= {n_values} target values); set --mi-threshold explicitly "
            "(e.g. --mi-threshold 0 to keep all pairs)"
        )
    threshold_idx = min(int(percentile * pairs_n), pairs_n - 1)

    if verbose_out is not None:
        print(f" ({pairs_n} pairs * {iterations} iterations)", file=verbose_out)

    rng = np.random.default_rng(seed)
    # draw every iteration's sample first (identical rng stream to the
    # sequential loop), then evaluate ALL iterations in one batch
    draws = [sample_pairs(rng, pairs_n, n_loci) for _ in range(iterations)]
    ii = np.concatenate([d[0] for d in draws])
    jj = np.concatenate([d[1] for d in draws])
    if hasattr(engine, "pair_quantiles"):
        # one device dispatch: MI evaluation + per-iteration order
        # statistic on device, only ``iterations`` floats come back —
        # bit-identical threshold values to the host-partition path
        thresholds = list(engine.pair_quantiles(
            ii, jj, iterations, pairs_n, threshold_idx))
        if verbose_out is not None:
            for it, t in enumerate(thresholds):
                print(f"spydrpick-jax: {it + 1:2d}/{iterations} threshold "
                      f"sample = {t:.6f}", file=verbose_out)
    else:
        # sharded / minimal engines: chunked pair_mi dispatches pipeline
        # on device; order statistics taken on host (same values)
        mi_all = engine.pair_mi(ii, jj)
        thresholds = []
        for it in range(iterations):
            mi = mi_all[it * pairs_n: (it + 1) * pairs_n]
            mi_sorted_at = np.partition(mi, threshold_idx)[threshold_idx]
            thresholds.append(float(mi_sorted_at))
            if verbose_out is not None:
                print(f"spydrpick-jax: {it + 1:2d}/{iterations} threshold "
                      f"sample = {mi_sorted_at:.6f}", file=verbose_out)

    thresholds = np.asarray(thresholds)
    n = len(thresholds)
    median_idx = n // 2 - (0 if n % 2 else 1)  # lower median (SpydrPick.hpp:339)
    return float(np.partition(thresholds, median_idx)[median_idx])


def default_mi_values(n_loci: int, mi_values_flag: int) -> int:
    """--mi-values resolution (src/SpydrPick.cpp:338-339)."""
    if mi_values_flag != 0:
        return mi_values_flag
    return min(10_000_000, 100 * n_loci)
