"""Measure a defensible CPU baseline for bench.py's vs_baseline ratio.

The reference binary cannot be built here (the apegrunt submodule is
empty in the snapshot), so the denominator is measured from this repo's
own engine on XLA-CPU — an optimistically fast stand-in for "a good
CPU implementation of the same math" (one-hot crosstable matmuls +
vectorised entropy, multi-threaded by XLA) — then scaled from this
host's cores to the BASELINE.md 64-core reference node.

Usage: python scripts/cpu_baseline.py [S] [L]
Prints one JSON line with measured pairs/s and the 64-core projection.
"""
import json
import os
import sys
import time

import numpy as np


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")

    from spydrpick_jax.core.alignment import Alignment
    from spydrpick_jax.engine.solver import EngineConfig, MIEngine

    S = int(sys.argv[1]) if len(sys.argv) > 1 else 3000
    L = int(sys.argv[2]) if len(sys.argv) > 2 else 2048

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(S, L)).astype(np.uint8)
    codes[rng.random((S, L)) < 0.05] = 4
    al = Alignment(
        codes=codes,
        sample_names=[f"s{i}" for i in range(S)],
        id_string="cpubase",
        translation=np.arange(L, dtype=np.int64),
        n_original_positions=L,
        weights=rng.random(S) * 0.9 + 0.1,
    )
    engine = MIEngine(al, EngineConfig(tile=512, compaction="scatter"))
    # threshold retaining ~100*L edges, like bench.py
    ii = rng.integers(0, L, 20000)
    jj = rng.integers(0, L, 20000)
    keep = ii != jj
    sample = engine.pair_mi(np.minimum(ii, jj)[keep], np.maximum(ii, jj)[keep])
    frac = min(1.0, (100 * L) / (L * (L - 1) / 2))
    threshold = float(np.quantile(sample, 1 - frac))

    engine.sweep(threshold)  # compile
    t0 = time.perf_counter()
    edges = engine.sweep(threshold)
    dt = time.perf_counter() - t0

    pairs = L * (L - 1) / 2
    cores = os.cpu_count() or 1
    pairs_per_s = pairs / dt
    print(json.dumps({
        "metric": "cpu_mi_column_pairs_per_s",
        "value": round(pairs_per_s, 1),
        "cores": cores,
        "projected_64core": round(pairs_per_s * 64 / cores, 1),
        "config": {"samples": S, "loci": L, "seconds": round(dt, 2),
                   "edges": int(edges.n_edges),
                   "threshold": round(threshold, 6)},
    }))


if __name__ == "__main__":
    main()
