"""Benchmark: all-pairs MI sweep throughput on one chip.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N}

Config: the BASELINE.md "medium" shape (~3k samples x ~30k filtered
columns), overridable via BENCH_SAMPLES / BENCH_LOCI / BENCH_TILE.
Further knobs: BENCH_ROWS (rows/dispatch), BENCH_DEPTH (counts-sync
pipeline depth), BENCH_ONEHOT (dense|codes), BENCH_WOG_FETCH,
BENCH_COMPACTION (route|scatter), BENCH_ROW_WINDOW (j-window width;
0 = auto), BENCH_MXU_INT8, BENCH_UNIT_WEIGHTS=1.
The metric is column-pairs/s through the REAL production sweep
(crosstable matmuls + dual-variant entropy + colmax + on-device edge
store) at a threshold retaining ~100*L edges — the reference's
auto-threshold target (src/SpydrPick.cpp:338-339).

vs_baseline: the reference repo publishes no numbers and its binary
cannot be built here (BASELINE.md), so the denominator is MEASURED:
this repo's own engine on XLA-CPU (one-hot crosstable matmuls +
vectorised dual entropy, XLA multi-threaded — scripts/cpu_baseline.py)
ran 574,210 pairs/s on this 4-core host; projected linearly to the
BASELINE.md 64-core reference node = 9.19e6 pairs/s.  (The round-1
back-of-envelope estimate for the reference binary itself was 3e7;
it is reported alongside in the config blob.)  vs_baseline >= 10
meets the north-star "10x a 64-core CPU node".
"""

import json
import os
import sys
import time

import numpy as np

BASELINE_CPU_PAIRS_PER_S = 9.19e6   # measured, see scripts/cpu_baseline.py
BASELINE_CPU_ESTIMATE = 3.0e7       # round-1 reference-binary estimate


def main():
    from spydrpick_jax.core.alignment import Alignment
    from spydrpick_jax.engine.solver import EngineConfig, MIEngine
    from spydrpick_jax.utils.device import describe_devices
    from spydrpick_jax.utils.jax_cache import configure_compile_cache

    configure_compile_cache()

    S = int(os.environ.get("BENCH_SAMPLES", 3000))
    L = int(os.environ.get("BENCH_LOCI", 30720))
    tile = int(os.environ.get("BENCH_TILE", 512))
    compact = os.environ.get("BENCH_COMPACTION", "auto")
    rows_per_dispatch = int(os.environ.get("BENCH_ROWS", 8))

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(S, L)).astype(np.uint8)
    codes[rng.random((S, L)) < 0.05] = 4
    al = Alignment(
        codes=codes,
        sample_names=[f"s{i}" for i in range(S)],
        id_string="bench",
        translation=np.arange(L, dtype=np.int64),
        n_original_positions=L,
        weights=(None if os.environ.get("BENCH_UNIT_WEIGHTS") == "1"
                 else rng.random(S) * 0.9 + 0.1),
    )
    print("# data built", flush=True)
    engine = MIEngine(
        al,
        EngineConfig(tile=tile, compaction=compact,
                     rows_per_dispatch=rows_per_dispatch,
                     pipeline_depth=int(os.environ.get("BENCH_DEPTH", 2)),
                     onehot_storage=os.environ.get("BENCH_ONEHOT", "auto"),
                     row_window=int(os.environ.get("BENCH_ROW_WINDOW", 0)),
                     mxu_int8=os.environ.get("BENCH_MXU_INT8", "auto"),
                     wog_fetch=os.environ.get("BENCH_WOG_FETCH", "outliers")),
    )
    print("# engine ready", flush=True)

    def progress(lo, hi, n, dt):
        print(f"# rows {lo}-{hi} ({n} edges, {dt:.2f}s)", flush=True)

    # threshold retaining ~100*L of the L^2/2 pairs, estimated from a
    # sample (the production tournament does the same, SpydrPick.hpp:284)
    ii = rng.integers(0, L, 20000)
    jj = rng.integers(0, L, 20000)
    keep = ii != jj
    sample = engine.pair_mi(np.minimum(ii, jj)[keep], np.maximum(ii, jj)[keep])
    target_frac = min(1.0, (100 * L) / (L * (L - 1) / 2))
    threshold = float(np.quantile(sample, 1 - target_frac))
    print(f"# threshold {threshold:.6f}", flush=True)

    t0 = time.perf_counter()
    edges = engine.sweep(threshold, progress=progress)
    compile_and_run = time.perf_counter() - t0
    print(f"# first sweep {compile_and_run:.1f}s", flush=True)

    # sweep ADAPTIVELY: at least BENCH_SWEEPS runs, continuing until
    # the two fastest agree within 4%, capped at BENCH_SWEEPS_MAX.  The
    # min and the full series are recorded in the result blob.
    n_min = int(os.environ.get("BENCH_SWEEPS", 7))
    n_max = int(os.environ.get("BENCH_SWEEPS_MAX", 20))
    runs = []
    phases: dict = {}
    while True:
        p: dict = {}
        t0 = time.perf_counter()
        edges = engine.sweep(threshold, progress=progress, timings=p)
        t = time.perf_counter() - t0
        runs.append(t)
        if t <= min(runs):
            phases = p
        lo = sorted(runs)[:2]
        stable = len(runs) >= max(2, n_min) and lo[1] / lo[0] < 1.04
        print(f"# sweep {len(runs)}: {t:.3f}s (best {lo[0]:.3f}s, "
              f"{'stable' if stable else 'unstable'}) phases {p}", flush=True)
        if stable or len(runs) >= n_max:
            break
    dt = min(runs)
    runs = [round(t, 3) for t in runs]

    # --- end-to-end pipeline phases (tournament + sweep + ARACNE +
    # writers on the same alignment; reference UX is per-stage cputimer
    # prints, src/SpydrPick.cpp:157-161) ---
    e2e: dict = {}
    if os.environ.get("BENCH_E2E", "1") == "1":
        import tempfile

        from spydrpick_jax.io.fasta import write_fasta
        from spydrpick_jax.pipeline import PipelineOptions, run_pipeline

        with tempfile.TemporaryDirectory() as td:
            print("# e2e: writing fasta", flush=True)
            fasta = os.path.join(td, "bench.fasta")
            write_fasta(fasta, al)
            wfile = os.path.join(td, "bench.weights")
            with open(wfile, "w") as f:
                f.write("\n".join(f"{x:.9f}" for x in (
                    al.weights if al.weights is not None else np.ones(S))))
            # two passes: the first pays one-time costs a production
            # deployment does not (tournament/pairs XLA compile or
            # persistent-cache deserialize); the reference binary has no
            # compile stage, so the WARM pass is the comparable
            # end-to-end number.  Both totals are recorded.
            tm_cold: dict = {}
            print("# e2e: running pipeline (cold, auto threshold)",
                  flush=True)
            t0 = time.perf_counter()
            run_pipeline(PipelineOptions(
                alignmentfile=fasta, mi_threshold=-1.0, seed=1,
                sample_weights=wfile, tile=tile,
                output_dir=os.path.join(td, "out_cold"),
            ), timings=tm_cold)
            cold_total = time.perf_counter() - t0
            tm: dict = {}
            print("# e2e: running pipeline (warm)", flush=True)
            res = run_pipeline(PipelineOptions(
                alignmentfile=fasta, mi_threshold=-1.0, seed=1,
                sample_weights=wfile, tile=tile,
                output_dir=os.path.join(td, "out"),
            ), timings=tm)
            e2e = {k: (round(v, 3) if isinstance(v, float) else v)
                   for k, v in tm.items() if not isinstance(v, dict)}
            e2e["cold_total_s"] = round(cold_total, 3)
            e2e["cold_threshold_s"] = round(
                tm_cold.get("threshold_s", 0.0), 3)
            e2e["cold_sweep_s"] = round(tm_cold.get("sweep_s", 0.0), 3)
            e2e["sweep_phases"] = {
                k: (round(v, 3) if isinstance(v, float) else v)
                for k, v in tm.get("sweep_phases", {}).items()}
            e2e["aracne_phases"] = {
                k: (round(v, 3) if isinstance(v, float) else v)
                for k, v in tm.get("aracne_phases", {}).items()}
            e2e["edges"] = int(res.edges.n_edges)
            e2e["mi_threshold"] = round(res.mi_threshold, 6)
            print(f"# e2e: {e2e}", flush=True)

    pairs = L * (L - 1) / 2
    pairs_per_s = pairs / dt
    result = {
        "metric": "mi_column_pairs_per_s",
        "value": round(pairs_per_s, 1),
        "unit": "column-pairs/s/chip",
        "vs_baseline": round(pairs_per_s / BASELINE_CPU_PAIRS_PER_S, 3),
        "config": {
            "baseline_denominator": BASELINE_CPU_PAIRS_PER_S,
            "vs_ref_estimate": round(pairs_per_s / BASELINE_CPU_ESTIMATE, 3),
            "samples": S, "loci": L, "tile": tile,
            "device": describe_devices(),
            "int8_mode": engine.statics.int8_mode,
            "compaction": engine.statics.compaction,
            "matmul_precision": engine.statics.matmul_precision,
            "rows_per_dispatch": rows_per_dispatch,
            "threshold": round(threshold, 6),
            "edges": int(edges.n_edges),
            "sweep_seconds": round(dt, 3),
            "sweep_method": (
                f"min of {len(runs)} sweeps (adaptive: best two within "
                f"4% or cap {n_max})"),
            "sweep_seconds_all": runs,
            "first_run_seconds": round(compile_and_run, 3),
            "phases": {k: (round(v, 3) if isinstance(v, float) else v)
                       for k, v in phases.items()},
            "end_to_end_s": e2e,
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    sys.exit(main())
