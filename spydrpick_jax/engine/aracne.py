"""ARACNE indirect-edge pruning (data-processing-inequality filter).

Reference: include/ARACNE.hpp (blocked, mutex-striped, TBB-parallel
streaming implementation).  We re-derived the algorithm's *semantics*
and found the block streaming is purely an execution strategy — the
final flag assignment is order-independent:

For each stored edge e = (a, b, w), over every common neighbour c of a
and b with edge weights w_ac and w_bc, let m_c = min(w_ac, w_bc). The
DPI rule (ARACNE.hpp:311-313: ``midval - minval >= threshold`` marks
the triangle's minimum-weight edges indirect) reduces per edge to:

    indirect(e)  <=>  max_c m_c  >=  w + max(threshold, 0)

Derivation: e is marked in triangle (e, ac, bc) iff w == min of the
three and mid - min >= threshold.  When w < m_c the mid is m_c, giving
``m_c - w >= threshold``; when w == m_c the mid equals w so the margin
is 0, which passes only for threshold <= 0.  Both cases collapse to
``m_c >= w + max(threshold, 0)``.  Every triangle of the graph is
examined by the reference exactly because its smallest in-block member
edge never trips the intra-block skip (ARACNE.hpp:358), and marking is
idempotent — hence the streamed result equals this closed form.
(The threshold==0 equal-MI block-boundary rewind at ARACNE.hpp:480-487
exists only to realise the same guarantee and needs no analogue here.)

Output polarity (ARACNE.hpp:399-405 + SpydrPick.hpp formatter): the
public flag is 1 for *direct* (surviving) edges, i.e. NOT indirect.
With --no-aracne the flag column is all zeros (SpydrPick.cpp:406-421).

Implementation: vectorised CSR adjacency + per-edge sorted-merge
intersection in NumPy, with an optional C++ kernel
(spydrpick_jax/native) for large graphs.  The MI sweep dominates
wall-time; the graph here is <= ~1e7 edges.
"""

from __future__ import annotations

import os
import time

import numpy as np

DEFAULT_EDGE_THRESHOLD = float(np.finfo(np.float64).eps)


def _csr_adjacency(ipos, jpos, n_nodes):
    """Sorted-neighbour CSR over undirected edges; returns
    (indptr, neighbors, edge_ids) with neighbours ascending per node."""
    deg = np.bincount(ipos, minlength=n_nodes) + np.bincount(jpos, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    E = len(ipos)
    # endpoints interleaved: for edge k, entries (ipos[k]->jpos[k]) and reverse
    src = np.concatenate([ipos, jpos])
    dst = np.concatenate([jpos, ipos])
    eid = np.concatenate([np.arange(E), np.arange(E)])
    order = np.lexsort((dst, src))
    return indptr, dst[order], eid[order]


def aracne_mark_indirect(
    ipos: np.ndarray,
    jpos: np.ndarray,
    mi: np.ndarray,
    threshold: float = DEFAULT_EDGE_THRESHOLD,
    timings: dict | None = None,
) -> np.ndarray:
    """(E,) bool: True where the edge is INDIRECT (to be pruned).

    Positions may be arbitrary node ids; they are densified internally
    (reference remap_and_initialize, ARACNE.hpp:50-88).
    ``timings`` (optional dict) receives per-stage wall seconds —
    remap_s / adjacency_s / process_s — the analogue of the reference's
    per-stage read/sort/process debug timers (ARACNE.hpp:499-523).
    """
    E = len(mi)
    if E == 0:
        return np.zeros(0, dtype=bool)
    t0 = time.perf_counter()
    nodes, inv = np.unique(np.concatenate([ipos, jpos]), return_inverse=True)
    a = inv[:E]
    b = inv[E:]
    n_nodes = len(nodes)
    t1 = time.perf_counter()
    indptr, nbr, eid = _csr_adjacency(a, b, n_nodes)
    t2 = time.perf_counter()
    w = np.asarray(mi, dtype=np.float64)
    margin = w + max(threshold, 0.0)

    # Fully vectorised batch intersection (no per-edge Python loop; the
    # reference streams 16384-edge blocks in parallel, ARACNE.hpp:447-494
    # — here whole chunks of edges go through flat NumPy ops at once).
    #
    # For each edge (u, v) we scan the smaller endpoint's neighbourhood
    # and test membership of each candidate c in ne(v) via ONE global
    # searchsorted: the CSR order is (src major, dst minor), so
    # key = src * n_nodes + dst is globally sorted ascending and the
    # query (v, c) is key v * n_nodes + c.
    deg = indptr[1:] - indptr[:-1]
    swap = deg[a] > deg[b]
    u = np.where(swap, b, a)  # smaller-degree endpoint
    v = np.where(swap, a, b)
    keys = np.repeat(np.arange(n_nodes, dtype=np.int64), deg) * n_nodes + nbr
    cnt = deg[u]  # >= 1 always: v itself is in ne(u)
    cum = np.concatenate([[0], np.cumsum(cnt)])

    indirect = np.zeros(E, dtype=bool)

    def _chunk(start: int, end: int) -> None:
        c_cnt = cnt[start:end]
        seg0 = (cum[start:end] - cum[start]).astype(np.int64)
        M = int(cum[end] - cum[start])
        rep = np.repeat(np.arange(start, end, dtype=np.int64), c_cnt)
        offs = np.arange(M, dtype=np.int64) - np.repeat(seg0, c_cnt)
        flat = indptr[u[rep]] + offs
        cand = nbr[flat]
        e1 = eid[flat]                      # edge (u, c)
        query = v[rep] * n_nodes + cand
        pos = np.clip(np.searchsorted(keys, query), 0, len(keys) - 1)
        hit = keys[pos] == query
        e2 = eid[pos]                       # edge (v, c)
        valid = hit & (e1 != rep) & (e2 != rep)
        m = np.where(valid, np.minimum(w[e1], w[e2]), -np.inf)
        best = np.maximum.reduceat(m, seg0)  # all segments non-empty
        indirect[start:end] = best >= margin[start:end]

    # chunk boundaries bounded by candidate rows (memory) and split fine
    # enough to thread: NumPy's searchsorted/take/ufuncs release the GIL,
    # so chunks scale across cores like the reference's TBB block stream
    flat_budget = 1 << 21  # ~2M candidate rows per chunk (~130 MB each)
    bounds = [0]
    while bounds[-1] < E:
        nxt = int(np.searchsorted(cum, cum[bounds[-1]] + flat_budget, side="right")) - 1
        bounds.append(min(max(nxt, bounds[-1] + 1), E))
    spans = list(zip(bounds[:-1], bounds[1:]))
    if len(spans) == 1:
        _chunk(*spans[0])
    else:
        from concurrent.futures import ThreadPoolExecutor

        workers = min(len(spans), os.cpu_count() or 1)
        with ThreadPoolExecutor(workers) as ex:
            list(ex.map(lambda s: _chunk(*s), spans))
    if timings is not None:
        timings["remap_s"] = t1 - t0
        timings["adjacency_s"] = t2 - t1
        timings["process_s"] = time.perf_counter() - t2
        timings["nodes"] = int(n_nodes)
        timings["chunks"] = len(spans)
    return indirect


def run_aracne(
    ipos: np.ndarray,
    jpos: np.ndarray,
    mi: np.ndarray,
    threshold: float = DEFAULT_EDGE_THRESHOLD,
    use_native: bool = True,
    timings: dict | None = None,
    verbose_out=None,
) -> np.ndarray:
    """(E,) uint8 ARACNE flags: 1 = direct survivor, 0 = indirect.

    Entry point mirroring ``aracne::run_ARACNE`` (ARACNE.hpp:550-555).
    ``timings``/``verbose_out`` expose per-stage wall times, mirroring
    the reference's per-stage debug prints (ARACNE.hpp:499-523) —
    at the 1e7-edge default this stage is ~30 s of otherwise-opaque
    wall time on a small host.
    """
    t = timings if timings is not None else {}
    if use_native:
        try:
            from spydrpick_jax.native import aracne_native

            t0 = time.perf_counter()
            ind = aracne_native.mark_indirect(ipos, jpos, mi, threshold)
            t["native_s"] = time.perf_counter() - t0
            t["edges"] = len(mi)
            if verbose_out is not None:
                print(f"ARACNE: {len(mi)} edges processed in "
                      f"{t['native_s']:.2f}s (native kernel)",
                      file=verbose_out, flush=True)
            return (~ind).astype(np.uint8)
        except Exception:
            pass  # fall back to NumPy
    flags = (~aracne_mark_indirect(ipos, jpos, mi, threshold,
                                   timings=t)).astype(np.uint8)
    t["edges"] = len(mi)
    if verbose_out is not None and len(mi):
        print(
            f"ARACNE: {len(mi)} edges / {t.get('nodes', 0)} nodes; "
            f"remap {t.get('remap_s', 0.0):.2f}s, "
            f"adjacency {t.get('adjacency_s', 0.0):.2f}s, "
            f"process {t.get('process_s', 0.0):.2f}s "
            f"({t.get('chunks', 1)} chunks)",
            file=verbose_out, flush=True,
        )
    return flags
