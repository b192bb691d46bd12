#!/usr/bin/env python3
"""Smoke test of the GWES pipeline on a GPU, through its user entry points.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python chip_smoke.py           # one card: phases 1-5
    python chip_smoke.py --four    # four cards: the sharded CLI paths only

One process drives every card.  Each phase stops the run with a
non-zero exit at its first failure; the last line of standard output is
one JSON object, printed only when every phase passed:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Phases (one card):
  1. device — JAX's first device must be a GPU; prints the card's name
     and power limit, the JAX version and XLA_FLAGS;
  2. native libraries — the C++ ARACNE, FASTA and formatter libraries
     build and load (no silent NumPy fallback);
  3. kernels at real widths — the crosstable + MI epilogue in each mode
     (f32 at the default precision, int8 unit, int8 fixed14) on
     3000 samples x two 512-column tiles, the pairs kernel, both edge
     compactions and the sample-identity GEMM, each against the plain
     references (ops/reference.py, NumPy);
  4. golden fixtures — tests/golden/*.fasta through the CLI, compared
     with tests/golden/expected* within stated tolerances;
  5. end to end — the BASELINE.md "medium" deployment (3000 samples x
     30,720 columns, user weights in [0.1, 1], auto threshold,
     --ld-threshold 5000, ARACNE) through the CLI, cold and warm; the
     planted couplings must rank first and sampled stored edges must
     match the f64 oracle.

With --four: the same end-to-end input through ``--sharded`` (row mesh)
and ``--sharded --sample-shards 2`` (rows x samples mesh) on four
cards, against the one-card run.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, ".smoke")  # scratch inside the checkout (.gitignore)

# the end-to-end deployment (BASELINE.md "medium")
E2E_SAMPLES, E2E_LOCI, E2E_PLANTED, E2E_LD = 3000, 30720, 8, 5000
# phase 3: real widths — the production tile, two tiles of it
KERNEL_TILE, KERNEL_LOCI = 512, 1024

# tolerances, in nats
MI_TOL = 5e-5        # f32 paths vs the f64 oracle (the CPU path's class)
FIXED14_TOL = 1e-4   # 14-bit weight quantisation on top of f32
FILE_TOL = 5e-6      # printed MI (6 decimals) on the GPU vs the CPU fixture


class SmokeError(Exception):
    """A phase failed."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(*msg) -> None:
    print(*msg, flush=True)


# ---------------------------------------------------------------------- #
# inputs and references
# ---------------------------------------------------------------------- #

def make_codes(S: int, L: int, seed: int, planted: int = E2E_PLANTED,
               gap_frac: float = 0.05, mutate: float = 0.1):
    """(S, L) uint8 codes with ``planted`` coupled column pairs (a noisy
    copy: ``mutate`` of the samples redrawn) and ``gap_frac`` gaps.
    Returns (codes, planted pairs as sorted 0-based (i, j))."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(S, L), dtype=np.uint8)
    pairs = []
    cols = rng.choice(L, size=2 * planted, replace=False)
    for a, b in cols.reshape(-1, 2):
        a, b = sorted((int(a), int(b)))
        src = codes[:, a].copy()
        mut = rng.random(S) < mutate
        src[mut] = rng.integers(0, 4, size=int(mut.sum()), dtype=np.uint8)
        codes[:, b] = src
        pairs.append((a, b))
    codes[rng.random((S, L)) < gap_frac] = 4
    return codes, sorted(pairs)


def make_weights(S: int, seed: int) -> np.ndarray:
    """User sample weights in [0.1, 1] (spread 10)."""
    return np.random.default_rng(seed + 1).random(S) * 0.9 + 0.1


def alignment(codes, weights, name="smoke"):
    from spydrpick_jax.core.alignment import Alignment

    S, L = codes.shape
    return Alignment(
        codes=codes, sample_names=[f"s{i}" for i in range(S)],
        id_string=name, translation=np.arange(L, dtype=np.int64),
        n_original_positions=L, weights=weights,
    )


def oracle_mi(codes, weights, presence, ii, jj, pseudocount=0.5):
    """f64 MI of explicit column pairs (ops/reference.py)."""
    from spydrpick_jax.ops.reference import crosstab_pair, mi_single

    w = np.ones(codes.shape[0]) if weights is None else weights
    return np.array([
        mi_single(crosstab_pair(codes[:, i], codes[:, j], w),
                  presence[i], presence[j], pseudocount)
        for i, j in zip(ii, jj)
    ])


def numpy_compaction(mi, wog, mask, i0, j_offset):
    """Row-major (ipos, jpos, mi, wog) of the masked entries."""
    rr, cc = np.nonzero(mask)
    w = np.zeros(len(rr), mi.dtype) if wog is None else wog[rr, cc]
    return i0 + rr, j_offset + cc, mi[rr, cc], w


def live_entries(out):
    """Live (ipos, jpos, mi, wog) of a compaction's K window."""
    vals, wogs, ipos, jpos, _, _ = (np.asarray(x) for x in out)
    keep = jpos > ipos
    return ipos[keep], jpos[keep], vals[keep], wogs[keep]


# ---------------------------------------------------------------------- #
# output-file comparison (phase 4 and --four)
# ---------------------------------------------------------------------- #

def read_edges(path: str, ncols: int) -> np.ndarray:
    """(E, ncols) float64 rows of a couplings (5 columns: pos1 pos2
    distance flag mi) or outliers file (8 columns: ... mi wog
    gap-effect extreme)."""
    with open(path, "rb") as f:
        data = f.read()
    first = data.split(b"\n", 1)[0].split()
    rows = np.array(data.split(), dtype=np.float64)
    check(len(first) in (0, ncols) and rows.size % ncols == 0,
          f"{os.path.basename(path)}: not {ncols} columns per row")
    return rows.reshape(-1, ncols)


def _keys(rows):
    return rows[:, 0].astype(np.int64) * (1 << 32) + rows[:, 1].astype(np.int64)


def compare_edge_rows(want: np.ndarray, got: np.ndarray, tol: float) -> dict:
    """Compare two edge tables (rows of pos1 pos2 distance flag mi [wog
    ...]) up to numerical noise of ``tol`` nats.

    * pairs may appear on one side only if their MI is within ``tol``
      of the lower cut of the two files (the save or outlier threshold);
    * common pairs need the same distance, |dMI| <= tol and (where
      present) |dWOG| <= tol;
    * ARACNE flags may differ only on near-ties: an edge whose MI is
      within 2*tol of another edge that shares one of its positions.

    Returns a dict with ``ok`` and ``first`` (the first difference that
    breaks the rules, or "")."""
    res = {"ok": True, "first": "", "common": 0, "only_want": 0,
           "only_got": 0, "max_dmi": 0.0, "flag_diffs": 0}

    def fail(msg):
        if res["ok"]:
            res["ok"], res["first"] = False, msg

    kw, kg = _keys(want), _keys(got)
    common, iw, ig = np.intersect1d(kw, kg, return_indices=True)
    res["common"] = len(common)
    cut = max(want[:, 4].min(initial=np.inf), got[:, 4].min(initial=np.inf))
    for name, rows, keys, other in (("want", want, kw, kg), ("got", got, kg, kw)):
        only = ~np.isin(keys, other)
        res[f"only_{name}"] = int(only.sum())
        bad = only & (rows[:, 4] > cut + tol)
        if bad.any():
            r = rows[np.argmax(bad)]
            fail(f"pair ({int(r[0])}, {int(r[1])}) with MI {r[4]:.6f} only in "
                 f"{name} (cut {cut:.6f})")
    a, b = want[iw], got[ig]
    if len(a):
        dmi = np.abs(a[:, 4] - b[:, 4])
        res["max_dmi"] = float(dmi.max())
        if (dmi > tol).any():
            k = int(np.argmax(dmi))
            fail(f"pair ({int(a[k, 0])}, {int(a[k, 1])}): MI {a[k, 4]:.6f} vs "
                 f"{b[k, 4]:.6f}")
        if (a[:, 2] != b[:, 2]).any():
            k = int(np.argmax(a[:, 2] != b[:, 2]))
            fail(f"pair ({int(a[k, 0])}, {int(a[k, 1])}): distance "
                 f"{int(a[k, 2])} vs {int(b[k, 2])}")
        if a.shape[1] > 5:
            dw = np.abs(a[:, 5] - b[:, 5])
            if (dw > tol).any():
                k = int(np.argmax(dw))
                fail(f"pair ({int(a[k, 0])}, {int(a[k, 1])}): wo-gaps MI "
                     f"{a[k, 5]:.6f} vs {b[k, 5]:.6f}")
        flip = np.nonzero(a[:, 3] != b[:, 3])[0]
        res["flag_diffs"] = len(flip)
        for k in flip:
            p, q, m = a[k, 0], a[k, 1], a[k, 4]
            near = ((want[:, 0] == p) | (want[:, 1] == p)
                    | (want[:, 0] == q) | (want[:, 1] == q))
            near &= _keys(want) != common[k]
            if not (np.abs(want[near, 4] - m) <= 2 * tol).any():
                fail(f"pair ({int(p)}, {int(q)}): ARACNE flag "
                     f"{int(a[k, 3])} vs {int(b[k, 3])}, no near-tie")
                break
    return res


def find_output(d: str, suffix: str) -> str:
    """The one output file in ``d`` whose name ends with ``suffix``."""
    hits = [f for f in os.listdir(d) if f.endswith(suffix)]
    check(len(hits) == 1, f"{d}: expected one *{suffix}, found {hits}")
    return os.path.join(d, hits[0])


def couplings_path(d: str) -> str:
    hits = [f for f in os.listdir(d)
            if ".spydrpick_couplings." in f and f.endswith("edges")]
    check(len(hits) == 1, f"{d}: expected one couplings file, found {hits}")
    return os.path.join(d, hits[0])


def same_bytes(p: str, q: str) -> bool:
    with open(p, "rb") as f, open(q, "rb") as g:
        return f.read() == g.read()


# ---------------------------------------------------------------------- #
# phases
# ---------------------------------------------------------------------- #

def phase_device(n_cards: int):
    import jax

    from spydrpick_jax.utils.device import gpu_name_and_power_limit
    from spydrpick_jax.utils.jax_cache import configure_compile_cache

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX finds no GPU (first device: {devs[0].platform})")
    check(len(devs) >= n_cards, f"{n_cards} GPUs needed, JAX sees {len(devs)}")
    cards = gpu_name_and_power_limit()
    check(cards is not None, "nvidia-smi gives no card name and power limit")
    for line in cards.splitlines():  # as nvidia-smi gives them
        log(line)
    card = cards.splitlines()[0]
    log(f"phase 1: jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}, "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, compile cache "
        f"{configure_compile_cache()}")
    return card


def phase_native():
    from spydrpick_jax.native import aracne_native, fasta_native, format_native

    for mod in (aracne_native, fasta_native, format_native):
        try:
            lib = mod._load()
        except Exception as e:  # a fallback would hide this; fail instead
            raise SmokeError(f"{mod.__name__}: build/load failed: {e!r}")
        log(f"phase 2: {mod.__name__.rsplit('.', 1)[1]} -> {lib._name}")


def phase_kernels():
    import jax.numpy as jnp

    from spydrpick_jax.core.weights import sample_match_counts
    from spydrpick_jax.engine.solver import EngineConfig, MIEngine
    from spydrpick_jax.ops.compact import (
        compact_edges_route,
        compact_edges_scatter,
    )

    S, L, T = E2E_SAMPLES, KERNEL_LOCI, KERNEL_TILE
    codes, _ = make_codes(S, L, seed=0)
    weights = make_weights(S, seed=0)
    rng = np.random.default_rng(5)
    ii = rng.integers(0, L, 4000)
    jj = rng.integers(0, L, 4000)
    keep = ii < jj
    ii, jj = ii[keep], jj[keep]

    # crosstable + epilogue, both variants, every mode
    for mode, w, cfg, tol in (
        ("f32", weights, {"mxu_int8": "off"}, MI_TOL),
        ("unit", None, {}, MI_TOL),
        ("fixed14", weights, {"mxu_int8": "on"}, FIXED14_TOL),
    ):
        al = alignment(codes, w)
        eng = MIEngine(al, EngineConfig(tile=T, **cfg))
        st = eng.statics
        check(st.int8_mode == ("off" if mode == "f32" else mode),
              f"mode {mode}: engine chose {st.int8_mode}")
        rows = {}
        for i0 in range(0, L, T):
            mi, wog, _, _ = eng._row_full(eng.data,
                                          i0=jnp.asarray(i0, jnp.int32))
            rows[i0] = (np.asarray(mi), np.asarray(wog))
        got = np.array([rows[i - i % T][0][i % T, j] for i, j in zip(ii, jj)])
        want = oracle_mi(codes, w, al.state_presence, ii, jj)
        err = float(np.abs(got - want).max())
        gap = al.gap_presence[ii] | al.gap_presence[jj]
        got_w = np.array([rows[i - i % T][1][i % T, j]
                          for i, j in zip(ii[gap], jj[gap])])
        want_w = oracle_mi(codes, w, al.state_presence_wo_gaps,
                           ii[gap], jj[gap])
        err_w = float(np.abs(got_w - want_w).max())
        prec = st.matmul_precision if mode == "f32" else "exact int32 counts"
        log(f"phase 3: crosstable+epilogue {mode} ({prec}): S={S}, two "
            f"{T}-column tiles, {len(ii)} pairs: max|MI - f64| = {err:.3e}, "
            f"max|MI_wog - f64| = {err_w:.3e} (tol {tol:.0e})")
        check(err <= tol and err_w <= tol, f"crosstable {mode} out of tolerance")
        if mode == "f32":
            pm = eng.pair_mi(ii, jj)
            perr = float(np.abs(pm - want).max())
            log(f"phase 3: pairs kernel (tournament): max|MI - f64| = "
                f"{perr:.3e} (tol {MI_TOL:.0e})")
            check(perr <= MI_TOL, "pairs kernel out of tolerance")

    # both edge compactions at a real row width vs NumPy
    W = E2E_LOCI
    mi = rng.random((T, W)).astype(np.float32)
    wog = (mi * 0.5).astype(np.float32)
    i0 = 1024
    mask = rng.random((T, W)) < 200.0 / W  # ~200 edges per i-row ...
    mask &= np.arange(W)[None, :] > i0 + np.arange(T)[:, None]  # ... j > i
    for name, fn in (("route", compact_edges_route),
                     ("scatter", compact_edges_scatter)):
        out = fn(jnp.asarray(mi), jnp.asarray(wog), jnp.asarray(mask),
                 i0, 1 << 19, j_offset=0)
        got = live_entries(out)
        want = numpy_compaction(mi, wog, mask, i0, 0)
        same = all(np.array_equal(g, w) for g, w in zip(got, want))
        log(f"phase 3: compaction {name}: {T}x{W} buffer, "
            f"{int(mask.sum())} edges, identical to NumPy: {same}")
        check(same, f"compaction {name} differs from NumPy")

    # sample-identity GEMM (sample weighting) vs NumPy integer counts
    sub = codes[:, :256]
    got = sample_match_counts(alignment(sub, None))
    oh = (sub[:, :, None] == np.arange(5)).reshape(S, -1).astype(np.float64)
    same = np.array_equal(got, oh @ oh.T)
    log(f"phase 3: sample-identity GEMM {S}x{S} over 256 columns: "
        f"identical to NumPy: {same}")
    check(same, "sample identity counts differ from NumPy")


def phase_golden():
    from spydrpick_jax.cli import main as cli_main

    sys.path.insert(0, HERE)
    from tests.golden.make_golden import GOLDEN2_ARGS

    gold = os.path.join(HERE, "tests", "golden")
    runs = {
        "expected": [os.path.join(gold, "golden.fasta"), "--seed", "7",
                     "--ld-threshold", "10", "--mi-values", "1500",
                     "--output-state-frequencies", "--output-sample-weights"],
        "expected2": [os.path.join(gold, "golden2.fasta"), *GOLDEN2_ARGS,
                      "--mappings-list", os.path.join(gold, "golden2.mappings"),
                      "--sample-weights", os.path.join(gold, "golden2.weights")],
    }
    exact = (".weights", ".state_frequencies", ".distance_matrix")
    for name, argv in runs.items():
        out = os.path.join(WORK, name)
        rc = cli_main(argv + ["--output-dir", out])
        check(rc in (0, None), f"golden {name}: CLI exit {rc}")
        want_dir = os.path.join(gold, name)
        for f in sorted(os.listdir(want_dir)):
            if f.endswith(exact):
                check(same_bytes(os.path.join(want_dir, f), os.path.join(out, f)),
                      f"golden {name}: {f} differs")
                log(f"phase 4: {name}/{f}: byte-identical")
        for label, want_p, got_p, ncols in (
            ("couplings", couplings_path(want_dir), couplings_path(out), 5),
            ("outliers", find_output(want_dir, ".outliers"),
             find_output(out, ".outliers"), 8),
        ):
            r = compare_edge_rows(read_edges(want_p, ncols),
                                  read_edges(got_p, ncols), FILE_TOL)
            log(f"phase 4: {name} {label}: {r['common']} common rows, "
                f"{r['only_want']}/{r['only_got']} only in fixture/GPU, "
                f"max|dMI| {r['max_dmi']:.2e} (tol {FILE_TOL:.0e}), "
                f"{r['flag_diffs']} flag differences"
                + ("" if r["ok"] else f"; FIRST DIFFERENCE: {r['first']}"))
            check(r["ok"], f"golden {name} {label}: {r['first']}")


def write_e2e_input(unit: bool = False):
    """FASTA (+ weights file) of the end-to-end deployment; returns
    (fasta path, weights path or None, codes, weights, planted)."""
    from spydrpick_jax.io.fasta import write_fasta

    codes, planted = make_codes(E2E_SAMPLES, E2E_LOCI, seed=1)
    weights = None if unit else make_weights(E2E_SAMPLES, seed=1)
    os.makedirs(WORK, exist_ok=True)
    fasta = os.path.join(WORK, "smoke.fasta")
    if not os.path.exists(fasta):
        write_fasta(fasta, alignment(codes, None))
    wfile = None
    if weights is not None:
        wfile = os.path.join(WORK, "smoke.weights")
        with open(wfile, "w") as f:
            f.write("\n".join(f"{x:.9f}" for x in weights) + "\n")
    return fasta, wfile, codes, weights, planted


def e2e_argv(fasta, wfile, out):
    argv = [fasta, "--ld-threshold", str(E2E_LD), "--seed", "1",
            "--output-dir", out]
    return argv + (["--sample-weights", wfile] if wfile
                   else ["--no-sample-reweighting"])


def phase_e2e(card: str):
    from spydrpick_jax.cli import main as cli_main
    from spydrpick_jax.core.weights import _DEVICE_RESIDENT_BYTES
    from spydrpick_jax.engine.solver import dense_onehot_limit
    from spydrpick_jax.utils.device import device_bytes_limit

    fasta, wfile, codes, weights, planted = write_e2e_input()
    lim = device_bytes_limit()
    log(f"phase 5: device bytes_limit {lim}: dense one-hot kept below "
        f"{dense_onehot_limit()} B, codes kept resident for sample "
        f"weighting below {lim // 4 if lim else _DEVICE_RESIDENT_BYTES} B")
    for run in ("cold", "warm"):
        out = os.path.join(WORK, f"e2e_{run}")
        tm: dict = {}
        t0 = time.perf_counter()
        rc = cli_main(e2e_argv(fasta, wfile, out), timings=tm)
        wall = time.perf_counter() - t0
        check(rc in (0, None), f"end to end ({run}): CLI exit {rc}")
        stages = {k: round(v, 3) for k, v in tm.items() if isinstance(v, float)}
        log(f"phase 5: {run} run on {card}: wall {wall:.2f} s, stages {stages}")
        log(f"phase 5: {run} sweep phases "
            f"{ {k: (round(v, 3) if isinstance(v, float) else v) for k, v in tm['sweep_phases'].items()} }")
        log(f"phase 5: statics {tm['engine']}")
    cpl = read_edges(couplings_path(out), 5)
    outl = read_edges(find_output(out, ".outliers"), 8)
    E = len(cpl)
    log(f"phase 5: {E} edges stored (target 100*L = {100 * E2E_LOCI}), "
        f"{len(outl)} outlier rows")
    check(0.5 * 100 * E2E_LOCI <= E <= 2 * 100 * E2E_LOCI, "edge count off target")
    check(os.path.basename(couplings_path(out)).startswith(
        f"smoke.{E2E_SAMPLES}x{E2E_LOCI}."), "filtering dropped columns")
    top = {(int(a) - 1, int(b) - 1) for a, b in cpl[:len(planted), :2]}
    check(top == set(planted), f"planted pairs {planted} not at the top: {top}")
    log(f"phase 5: the {len(planted)} planted couplings rank 1-{len(planted)}")
    rng = np.random.default_rng(7)
    pick = rng.choice(E, size=min(10000, E), replace=False)
    ii = cpl[pick, 0].astype(np.int64) - 1
    jj = cpl[pick, 1].astype(np.int64) - 1
    al = alignment(codes, weights)
    want = oracle_mi(codes, weights, al.state_presence, ii, jj)
    err = float(np.abs(cpl[pick, 4] - want).max())
    log(f"phase 5: {len(pick)} sampled stored edges: max|MI - f64 oracle| = "
        f"{err:.3e} (tol {MI_TOL:.0e}, printed with 6 decimals)")
    check(err <= MI_TOL, "stored MI out of tolerance")


def phase_four(card: str):
    """Row mesh and rows x samples mesh on four cards vs one card."""
    import jax

    from spydrpick_jax.cli import main as cli_main

    def run(tag, argv):
        out = os.path.join(WORK, f"four_{tag}")
        t0 = time.perf_counter()
        rc = cli_main(argv(out))
        check(rc in (0, None), f"{tag}: CLI exit {rc}")
        log(f"phase 6: {tag}: {time.perf_counter() - t0:.2f} s on {card}")
        return couplings_path(out)

    for unit in (False, True):
        fasta, wfile, *_ = write_e2e_input(unit=unit)
        kind = "unit weights (int8)" if unit else "user weights (f32)"
        base = lambda out: e2e_argv(fasta, wfile, out)
        one = run(f"one-card-{'unit' if unit else 'f32'}", base)
        if not unit:
            rows = run("row-mesh", lambda out: base(out) + ["--sharded"])
            same = same_bytes(one, rows)
            log(f"phase 6: row mesh (4 x rows), {kind}: couplings "
                f"byte-identical to one card: {same}")
            check(same, "row mesh differs from one card")
        mesh2 = run(f"2d-mesh-{'unit' if unit else 'f32'}",
                    lambda out: base(out) + ["--sharded", "--sample-shards", "2"])
        if unit:
            same = same_bytes(one, mesh2)
            log(f"phase 6: 2-D mesh (2 rows x 2 samples), {kind}: couplings "
                f"byte-identical to one card: {same}")
            check(same, "2-D mesh (int8) differs from one card")
        else:
            r = compare_edge_rows(read_edges(one, 5), read_edges(mesh2, 5),
                                  FILE_TOL)
            log(f"phase 6: 2-D mesh (2 rows x 2 samples), {kind}: "
                f"{r['common']} common, {r['only_want']}/{r['only_got']} only "
                f"one side, max|dMI| {r['max_dmi']:.2e} (tol {FILE_TOL:.0e}), "
                f"{r['flag_diffs']} flag differences"
                + ("" if r["ok"] else f"; FIRST DIFFERENCE: {r['first']}"))
            check(r["ok"], f"2-D mesh: {r['first']}")
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
             for d in jax.devices()[:4]]
    log(f"phase 6: peak bytes in use per device: {peaks}")
    check(all(p > 0 for p in peaks), "a device did no work")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths on four cards")
    args = ap.parse_args(argv)
    try:
        import spydrpick_jax
    except ImportError:
        print("chip_smoke: run from the root of a checkout", file=sys.stderr)
        return 2
    if os.path.dirname(os.path.abspath(spydrpick_jax.__file__)) != os.path.join(
            HERE, "spydrpick_jax"):
        print("chip_smoke: the package must come from this checkout",
              file=sys.stderr)
        return 2
    import jax

    try:
        card = phase_device(4 if args.four else 1)
        shutil.rmtree(WORK, ignore_errors=True)
        if args.four:
            phase_four(card)
        else:
            for name, phase in (("native", phase_native),
                                ("kernels", phase_kernels),
                                ("golden", phase_golden),
                                ("e2e", lambda: phase_e2e(card))):
                t0 = time.perf_counter()
                phase()
                log(f"phase {name}: passed in {time.perf_counter() - t0:.1f} s")
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
