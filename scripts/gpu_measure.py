"""Crosstable precision, int8 GEMM lowering, edge compaction and the
sweep's time split, measured on one GPU.

    python scripts/gpu_measure.py [--out chiprun_out/gpu_measure.json]

Sections (all on the card JAX finds first; fails without a GPU):

* precision — one 512x512-column tile pair of the bench data (3000
  samples, weights in [0.1, 1]): crosstable GEMM time and GEMM+epilogue
  time for each matmul precision, and max |MI - f64 oracle| over the
  pairs of two 512-column tiles (ops/reference.py);
* int8 — the same tile in the int8 unit and fixed14 modes, plus the
  unit-weight f32 and bf16 GEMMs for comparison;
* kernels — a profiler trace of the tile crosstables: the device
  kernels each mode runs (names, summed device time);
* sweep — full MIEngine sweeps at 3000 x 30720 (threshold keeping
  ~100*L edges): compaction route vs scatter (weighted f32), and the
  unit-weight int8 sweep, in the order route, scatter, scatter, route;
* split — a trace of one weighted sweep: device busy time by kernel
  class (GEMM, transpose, everything else = epilogue, masks,
  compaction, stores) and the top kernels.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (inputs and the oracle)


def timed(fn, *args, n=30):
    """Seconds per call of ``n`` back-to-back calls (after one warm-up),
    ended by one block_until_ready: the host's dispatch overlaps the
    device's work, as in the sweep's loop."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def device_ms(name, fn, *args, n=5):
    """Device kernels of ``n`` traced calls: [(kernel, ms per call)]."""
    import jax

    jax.block_until_ready(fn(*args))
    d = os.path.join(ROOT, ".trace", "tile", name)
    with jax.profiler.trace(d):
        for _ in range(n):
            out = fn(*args)
        jax.block_until_ready(out)
    return [(k, v / n) for k, v in summarize(device_events(d))["top_ms"]]


def device_events(trace_dir):
    """[(kernel name, start ns, duration ns)] of the GPU stream lines of
    the newest trace under ``trace_dir``."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True), key=os.path.getmtime)[-1]
    out = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name.startswith("Stream"):
                out.extend((e.name, e.start_ns, e.duration_ns)
                           for e in line.events)
    return out


def kernel_class(name: str) -> str:
    n = name.lower()
    if any(k in n for k in ("gemm", "xmma", "cutlass", "cublas", "sm90_",
                            "triton_gemm", "matmul")):
        return "gemm"
    if "transpose" in n:
        return "transpose"
    return "other"


def summarize(events, top=15):
    by_name: dict = {}
    for name, _, dur in events:
        by_name[name] = by_name.get(name, 0) + dur
    by_class: dict = {}
    for name, dur in by_name.items():
        c = kernel_class(name)
        by_class[c] = by_class.get(c, 0) + dur
    busy = 0
    end = -1
    for _, s, d in sorted((e for e in events), key=lambda e: e[1]):
        if s >= end:
            busy += d
            end = s + d
        elif s + d > end:
            busy += s + d - end
            end = s + d
    span = (max(s + d for _, s, d in events) - min(s for _, s, _ in events)
            if events else 0)
    tops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "busy_ms": busy / 1e6, "span_ms": span / 1e6,
        "class_ms": {k: v / 1e6 for k, v in by_class.items()},
        "top_ms": [(k[:160], v / 1e6) for k, v in tops],
        "n_events": len(events),
    }


def section_precision(res):
    import jax
    import jax.numpy as jnp

    from spydrpick_jax.core.alphabet import N_STATES
    from spydrpick_jax.ops.mi import (
        INT8_PASS_MULTS,
        crosstab_tile_flat,
        crosstab_tile_int8,
        mi_from_crosstab_flat,
    )

    S, L, T = cs.E2E_SAMPLES, cs.KERNEL_LOCI, cs.KERNEL_TILE
    codes, _ = cs.make_codes(S, L, seed=0)
    w = cs.make_weights(S, seed=0)
    al = cs.alignment(codes, w)
    oh = (codes[:, :, None] == np.arange(N_STATES)).reshape(S, -1)
    pres = al.state_presence.reshape(-1).astype(np.float32)
    xi_w = jnp.asarray((oh[:, :T * 5] * w[:, None]).astype(np.float32))
    xj = [jnp.asarray(oh[:, c * T * 5:(c + 1) * T * 5], jnp.bfloat16)
          for c in range(L // T)]
    ipf = jnp.asarray(pres[:T * 5])
    jpf = [jnp.asarray(pres[c * T * 5:(c + 1) * T * 5]) for c in range(L // T)]
    rng = np.random.default_rng(3)
    ii = rng.integers(0, T, 3000)
    jj = rng.integers(0, L, 3000)
    keep = ii < jj
    ii, jj = ii[keep], jj[keep]
    want = cs.oracle_mi(codes, w, al.state_presence, ii, jj)

    precs = {
        "high": jax.lax.Precision.HIGH,
        "highest": jax.lax.Precision.HIGHEST,
        "default": jax.lax.Precision.DEFAULT,
        "bf16_3x": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
    }
    out = {}
    for name, p in precs.items():
        gemm = jax.jit(lambda a, b, p=p: crosstab_tile_flat(a, b, precision=p))
        full = jax.jit(lambda a, b, ip, jp, p=p: mi_from_crosstab_flat(
            crosstab_tile_flat(a, b, precision=p), ip, jp, 0.5))
        mi = np.concatenate([np.asarray(full(xi_w, x, ipf, jp))
                             for x, jp in zip(xj, jpf)], axis=1)
        err = float(np.abs(mi[ii, jj] - want).max())
        out[name] = {
            "gemm_ms": timed(gemm, xi_w, xj[1]) * 1e3,
            "gemm_epilogue_ms": timed(full, xi_w, xj[1], ipf, jpf[1]) * 1e3,
            "max_abs_mi_err": err,
            "device_kernels_ms": device_ms(f"prec_{name}", full, xi_w, xj[1],
                                           ipf, jpf[1]),
        }
        print(f"precision {name}: {out[name]}", flush=True)
    res["precision"] = out

    # int8 modes and the unit-weight float GEMMs, same tile shapes
    x8 = jnp.asarray(oh[:, :T * 5], jnp.int8)
    xj8 = jnp.asarray(oh[:, T * 5:2 * T * 5], jnp.int8)
    q = 16383.0 / w.max()
    w_q = np.clip(np.round(w.astype(np.float32) * np.float32(q)), 0, 16383
                  ).astype(np.int64)
    hi = jnp.asarray(oh[:, :T * 5] * (w_q // 128)[:, None], jnp.int8)
    lo = jnp.asarray(oh[:, :T * 5] * (w_q % 128)[:, None], jnp.int8)
    u32 = jnp.asarray(oh[:, :T * 5], jnp.float32)
    ubf = jnp.asarray(oh[:, :T * 5], jnp.bfloat16)
    fns = {
        "int8_unit": (jax.jit(lambda a, b: crosstab_tile_int8(
            (a,), b, INT8_PASS_MULTS["unit"])), (x8, xj8)),
        "int8_fixed14": (jax.jit(lambda a, c, b: crosstab_tile_int8(
            (a, c), b, INT8_PASS_MULTS["fixed14"])), (hi, lo, xj8)),
        "f32_unit_default": (jax.jit(lambda a, b: crosstab_tile_flat(
            a, b, precision=jax.lax.Precision.DEFAULT)), (u32, xj[1])),
        "bf16_unit": (jax.jit(lambda a, b: crosstab_tile_flat(
            a, b, precision=jax.lax.Precision.DEFAULT)), (ubf, xj[1])),
    }
    res["gemm_ms"] = {k: timed(f, *a) * 1e3 for k, (f, a) in fns.items()}
    print(f"gemm times {res['gemm_ms']}", flush=True)

    # which kernels each mode runs, and their device time
    res["tile_kernels"] = {k: device_ms(k, f, *a) for k, (f, a) in fns.items()}
    for k, v in res["tile_kernels"].items():
        print(f"kernels {k}: {v}", flush=True)


def section_sweep(res):
    import jax

    from spydrpick_jax.engine.solver import EngineConfig, MIEngine

    S, L = cs.E2E_SAMPLES, cs.E2E_LOCI
    codes, _ = cs.make_codes(S, L, seed=1)
    w = cs.make_weights(S, seed=1)
    rng = np.random.default_rng(0)

    def threshold(eng):
        ii = rng.integers(0, L, 20000)
        jj = rng.integers(0, L, 20000)
        k = ii != jj
        m = eng.pair_mi(np.minimum(ii, jj)[k], np.maximum(ii, jj)[k])
        return float(np.quantile(m, 1 - 100 * L / (L * (L - 1) / 2)))

    engines = {
        "route": MIEngine(cs.alignment(codes, w),
                          EngineConfig(compaction="route", wog_fetch="outliers")),
        "scatter": MIEngine(cs.alignment(codes, w),
                            EngineConfig(compaction="scatter",
                                         wog_fetch="outliers")),
    }
    thr = threshold(engines["route"])
    times: dict = {k: [] for k in engines}
    phases = {}
    for k in engines:  # compile + warm
        t0 = time.perf_counter()
        e = engines[k].sweep(thr)
        print(f"sweep {k} first (compile) {time.perf_counter() - t0:.2f} s, "
              f"{e.n_edges} edges", flush=True)
    for k in ("route", "scatter", "scatter", "route"):
        p: dict = {}
        t0 = time.perf_counter()
        e = engines[k].sweep(thr, timings=p)
        times[k].append(time.perf_counter() - t0)
        phases[k] = p
        print(f"sweep {k}: {times[k][-1]:.3f} s {p}", flush=True)
    res["sweep_weighted_s"] = times
    res["sweep_weighted_phases"] = phases
    res["sweep_edges"] = int(e.n_edges)
    res["threshold"] = thr

    unit = MIEngine(cs.alignment(codes, None), EngineConfig(wog_fetch="outliers"))
    thr_u = threshold(unit)
    unit.sweep(thr_u)
    ut = []
    for _ in range(2):
        t0 = time.perf_counter()
        unit.sweep(thr_u)
        ut.append(time.perf_counter() - t0)
    res["sweep_unit_int8_s"] = ut
    res["sweep_unit_statics"] = unit.statics.int8_mode
    print(f"sweep unit int8: {ut}", flush=True)

    # time split of one weighted sweep (default compaction)
    best = min(times, key=lambda k: min(times[k]))
    d = os.path.join(ROOT, ".trace", "sweep")
    with jax.profiler.trace(d):
        t0 = time.perf_counter()
        engines[best].sweep(thr)
        wall = time.perf_counter() - t0
    split = summarize(device_events(d))
    split["wall_ms"] = wall * 1e3
    split["compaction"] = best
    res["sweep_split"] = split
    print(f"sweep split ({best}): {json.dumps(split, indent=1)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "gpu_measure.json"))
    ap.add_argument("--skip-sweep", action="store_true")
    args = ap.parse_args(argv)
    import jax

    from spydrpick_jax.utils.device import describe_devices
    from spydrpick_jax.utils.jax_cache import configure_compile_cache

    if jax.devices()[0].platform != "gpu":
        print("gpu_measure: needs a GPU", file=sys.stderr)
        return 1
    configure_compile_cache()
    res = {"device": describe_devices()}
    print(res["device"], flush=True)
    section_precision(res)
    if not args.skip_sweep:
        section_sweep(res)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: res[k] for k in res if k != "tile_kernels"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
