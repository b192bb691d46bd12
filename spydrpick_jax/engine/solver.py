"""All-pairs MI sweep engine.

Accelerator redesign of the reference hot path (``MI_solver``/
``mutual_information_block_kernel``, include/mi.hpp:292-532, driven by
``get_MI_network``'s tbb::parallel_reduce at include/SpydrPick.hpp:143):

  * the upper-triangular (iblock, jblock) tile loop (mi.hpp:390-398)
    becomes a host loop over *block-rows* of TILE columns, each row a
    single jitted program: one weighted one-hot matmul per j-chunk
    (a tensor-core GEMM) + fused elementwise entropy math, accumulated
    into a (TILE, L) MI row buffer with ``lax.fori_loop``;
  * the lock-protected shared edge ``Graph`` (mi.hpp:411-463) becomes a
    static-shape on-device compaction: mask -> cumsum -> scatter into a
    fixed-capacity edge buffer with an overflow count (dynamic shapes
    would defeat XLA, and a device round-trip of the full MI matrix
    would be PCIe bound);
  * the per-position running max tracker (``maxvaltracker``,
    mi.hpp:244-290) becomes two masked max-reductions per row;
  * the gaps-excluded re-evaluation for gap-afflicted edges
    (mi.hpp:466-490) is fused into the same pass: both MI variants come
    from one crosstable, and the stored "wo-gaps" weight is
    ``gap_i | gap_j ? mi_wo_gaps : mi`` — exactly what the reference's
    store-then-lookup-with-default dance produces
    (mi.hpp:433,474-487 + SpydrPick.hpp:106-107).

The sweep core is a *pure function* of a ``DeviceData`` pytree and a
hashable ``SweepStatics`` config so the same program runs single-chip
(jit) and multi-chip (shard_map over a row-sharded mesh, see
spydrpick_jax/parallel/mesh.py).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from spydrpick_jax.core.alignment import Alignment
from spydrpick_jax.core.alphabet import N_STATES
from spydrpick_jax.ops.compact import (
    compact_edges_route,
    compact_edges_scatter,
)
from spydrpick_jax.ops.mi import (
    INT8_PASS_MULTS,
    crosstab_tile_flat,
    crosstab_tile_int8,
    mi_from_crosstab_flat,
    mi_from_crosstabs,
)
from spydrpick_jax.utils.device import device_bytes_limit


# edge compaction used by EngineConfig(compaction="auto"): the faster
# measured on one H100 at 3000 x 30720 (1.90 s vs 2.03 s sweeps, PERF.md)
DEFAULT_COMPACTION = "scatter"


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    tile: int = 512                 # columns per tile (TI == TJ)
    # alignment residency: "dense" keeps the (S, Lp*5) one-hot in device
    # memory; "codes" keeps only the (S, Lp) uint8 codes and expands
    # one-hot tiles on the fly (exact; 10x less device memory — what
    # lets ~300k-column alignments fit one device).  "auto" switches to
    # codes when the dense one-hot would exceed 1/16 of the device's
    # memory limit (1 GiB where the device reports none).
    onehot_storage: str = "auto"    # "auto" | "dense" | "codes"
    edge_capacity: int = 1 << 19    # per-block-row edge buffer capacity
    pseudocount: float = 0.5        # --mi-pseudocount
    ld_threshold: int = 0           # --ld-threshold (colmax gating only)
    linear_genome: bool = False     # --linear-genome
    compute_dtype: str = "float32"  # or "float64" (CPU testing)
    storage_dtype: str = "bfloat16" # dense one-hot storage dtype
    store_capacity: int = 1 << 24   # device-resident edge store (cap per run)
    rows_per_dispatch: int = 8      # block-rows per device dispatch
    # counts-sync pipeline depth (host loop): 1 = synchronous per-group
    # resolve; 2 = bounded lag-1 (next group dispatched before the
    # previous group's counts are read).  Depth 2 hides the per-group
    # counts round-trip behind the next group's compute; checkpointed
    # runs force depth 1 (snapshots need synchronous bookkeeping).
    pipeline_depth: int = 2
    # precision of the weighted f32 crosstable matmul (see
    # ops/mi.py:crosstab_tile_flat).  The one-hot operand is exact in
    # any format; the weights are not.  "highest" = full f32 products
    # on every backend.  On a GPU "high" and "default" both run TF32,
    # which keeps 10 mantissa bits of the weights (PERF.md: ~7e-5
    # relative count error) — not for weighted data.  On the CPU all
    # three are f32.
    matmul_precision: str = "highest"
    # int8 crosstable modes (exact integer arithmetic in int32).
    # "auto": int8 for unit-weight runs only, where the 0/1 one-hot
    # operands make the counts exact (MI bit-identical to the f32
    # path).  "on": additionally run weighted sweeps as a 14-bit
    # fixed-point weight split ("fixed14": two int8 passes) when the
    # weight spread max/min is <= 32 — weights quantise to rel. 2^-14
    # of the max weight (see tests/test_int8_crosstable.py).
    mxu_int8: str = "auto"     # "auto" | "on" | "off"
    # edge-compaction path: "route" (ops/compact.py, exact
    # scatter-free roll-routing) or "scatter" (cumsum + one scatter);
    # "auto" = the faster one on the current backend (PERF.md)
    compaction: str = "auto"
    # drain policy for the gaps-excluded MI variant ("full" fetches the
    # whole wog store alongside mi; "outliers" leaves it on device and
    # gathers only the store lines holding outlier candidates
    # (mi >= outlier threshold) at the end — the only edges whose wog
    # the output surface ever reads (SpydrPick.hpp:100-124).  The
    # pipeline/bench use "outliers"; "auto" = "full" so library users
    # and the oracle tests get exact mi_wog for every edge.)
    wog_fetch: str = "auto"  # "auto" | "full" | "outliers"
    # route-compaction width buckets: block-row i0 only stores j > i0,
    # so late rows route a right-aligned slice of the buffer instead of
    # the full Lp (separate compiled program per bucket).  0 = auto
    # (4 buckets when Lp >= 8192, off below); 1 = off.
    width_buckets: int = 0
    # j-window width for very wide alignments: the sweep's unit of work
    # becomes a (block-row, j-window) item with a (tile, row_window) MI
    # buffer instead of (tile, Lp) — fixed device memory per item, so
    # alignment width is bounded by device memory for the codes only
    # (~S bytes per column), not by the row buffer (2 GB at Lp = 10^6)
    # or the routing temporaries.  0 = auto (full-width below 2^17
    # padded columns, else ~2^16 windows);
    # 1 = force full-width; else the window width (rounded to tiles).
    row_window: int = 0
    verbose: bool = False


class DeviceData(NamedTuple):
    """Device-resident alignment tensors (a pytree for jit/shard_map)."""

    # dense mode: (S, Lp*5) one-hot (padded cols zero); codes mode
    # (st.onehot_codes): (S, Lp) uint8 codes (pad = 255), expanded to
    # one-hot tiles on the fly by onehot_slice
    onehot: jnp.ndarray
    weights: jnp.ndarray       # (S,)
    presence: jnp.ndarray      # (Lp, 5) 0/1 state presence
    presence_wog: jnp.ndarray  # (Lp, 5) presence with gap bit cleared
    gap: jnp.ndarray           # (Lp,) bool gap presence
    orig_pos: jnp.ndarray      # (Lp,) int32 original genome positions
    # (S, Lp) uint8 codes (pad = 255) for the PAIRS paths (tournament /
    # lazy wog / overflow re-extraction), whose fused crosstable reads
    # codes directly instead of materialising (S, P, 5) one-hots.  In
    # codes storage mode this is the same buffer as ``onehot``; dense
    # engines carry it as a 10x-smaller sibling (S*Lp bytes).
    codes: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class SweepStatics:
    """Hashable static sweep parameters (jit static argument)."""

    L: int
    Lp: int
    S: int
    tile: int
    n_chunks: int
    edge_capacity: int
    pseudocount: float
    ld_threshold: int
    linear_genome: bool
    genome_size: int
    compute_dtype: str
    matmul_precision: str = "highest"
    compaction: str = "scatter"  # "scatter" | "route"
    # lazy-wog mode (wog_fetch="outliers"): the hot sweep computes and
    # stores only mi; the gaps-excluded variant is recomputed post-hoc
    # for outlier-candidate edges via the pairs kernel — the reference
    # itself evaluates wo-gaps MI only for stored gap-afflicted edges
    # (mi.hpp:466-490), never for the full tile space.
    wog_lazy: bool = False
    # codes-resident alignment (see EngineConfig.onehot_storage)
    onehot_codes: bool = False
    storage_dtype: str = "bfloat16"
    # every sample weight is exactly 1 (--no-sample-reweighting or no
    # weights): the weighted one-hot IS the 0/1 one-hot, exact in any
    # matmul format, so the f32 crosstable needs no extra precision
    unit_weights: bool = False
    # sample-axis sharding (2-D mesh, parallel/mesh.py:sharded_sweep):
    # when set, S is the LOCAL sample-shard size and every per-tile
    # crosstable is psum-merged over this mesh axis before the entropy
    # stage — the alignment never needs to be replicated (the S=20k+
    # configs whose one-hot exceeds one device's memory).
    psum_axis: str | None = None
    # j-window width (0 = full-width rows; see EngineConfig.row_window).
    # When set, Lp is a multiple of it and the sweep iterates
    # (block-row, j-window) work items with traced window starts.
    row_window: int = 0
    # int8 crosstable mode (see EngineConfig.mxu_int8): "off", "unit"
    # (exact 0/1 int8 single pass), or "fixed14" (weighted 14-bit
    # fixed-point split; int8_scale is the static quantisation factor
    # q — device weights round to w_q = round(w*q) in [0, 16383] and
    # the int32 counts are multiplied by 1/q after conversion to f32).
    int8_mode: str = "off"
    int8_scale: float = 0.0

    @property
    def cdtype(self):
        return jnp.dtype(self.compute_dtype)

    @property
    def precision(self):
        return {
            "highest": jax.lax.Precision.HIGHEST,
            "high": jax.lax.Precision.HIGH,
            "default": jax.lax.Precision.DEFAULT,
        }[self.matmul_precision]

    @property
    def xtab_precision(self):
        """Crosstable matmul precision: with unit weights both operands
        are 0/1 (exact in bf16 and TF32), so a DEFAULT pass is exact."""
        if self.unit_weights:
            return jax.lax.Precision.DEFAULT
        return self.precision

    @property
    def store_lanes(self) -> int:
        """Lane width of the 2-D edge stores.  Stores are (lines, LN)
        rather than flat (cap,) so that every append is a dynamic
        offset in the major dimension — a contiguous copy of whole
        lines — and the drain moves whole lines (see fetch_chunk_core).
        Appends advance in whole lines (per-row counts rounded up; the
        sub-line tail is zero padding, dropped by the jpos > ipos
        filter at fetch)."""
        import math

        return math.gcd(self.edge_capacity, 128)


@dataclasses.dataclass
class EdgeSet:
    """Thresholded edges + per-position max-MI, the sweep's result.

    Mirrors the reference ``MI_network`` payload (SpydrPick.hpp:59-67):
    ``network`` -> (ipos, jpos, mi), ``network_wo_gaps`` -> mi_wog
    (already defaulted to mi where no gap applies), colmax feeds the
    outlier quartiles.
    """

    ipos: np.ndarray     # (E,) int64 filtered column index, ipos < jpos
    jpos: np.ndarray     # (E,) int64
    mi: np.ndarray       # (E,) float
    mi_wog: np.ndarray   # (E,) float, == mi where neither column has gaps
    colmax: np.ndarray   # (L,) float per-position max MI past LD distance

    @property
    def n_edges(self) -> int:
        return len(self.mi)

    def sort_desc(self) -> "EdgeSet":
        """Descending MI, ties broken by (ipos, jpos) for determinism
        (reference Graph::sort at src/SpydrPick.cpp:398).

        One unstable f32 argsort to RANK the MI values (ties share a
        rank), then one unstable int64 argsort of the packed key
        ``rank * L^2 + ipos * L + jpos`` — unique per edge (pairs are
        unique in the store), so no stability and no tie fixup is
        needed and the cost is independent of the tie structure.  A
        3-key lexsort (3 stable merge sorts) took ~23 s at the
        1e7-edge default; the previous tied-span lexsort degraded to
        that on quantised/low-entropy data where most MI values
        collide (measured 3.3 s vs 0.8 s here at 3.2M edges).  The
        packed key needs ``n_ranks * L^2 < 2^63`` (L = 1 + max
        position actually present — NOT colmax's length, which toy
        EdgeSets may not size to the position range); past that (only
        the ~1M-column class with >~1e7 distinct MI values) fall back
        to the tied-span lexsort."""
        n = len(self.mi)
        order = np.argsort(self.mi)[::-1]
        mi_s = self.mi[order]
        eq = mi_s[1:] == mi_s[:-1]
        if eq.any():  # no ties -> the descending argsort is already final
            L = int(self.jpos.max()) + 1  # jpos > ipos always
            L2 = L * L
            rank = np.empty(n, dtype=np.int64)
            rank_s = np.empty(n, dtype=np.int64)
            rank_s[0] = 0
            np.cumsum(mi_s[1:] != mi_s[:-1], out=rank_s[1:])
            rank[order] = rank_s
            n_ranks = int(rank_s[-1]) + 1
            if n_ranks <= (2 ** 63 - 1) // L2:
                key = rank * L2 + self.ipos.astype(np.int64) * L + self.jpos
                order = np.argsort(key)
            else:
                tied = np.zeros(n, dtype=bool)
                tied[1:] = eq
                tied[:-1] |= eq
                sub = order[tied]
                sub = sub[np.lexsort(
                    (self.jpos[sub], self.ipos[sub], -self.mi[sub]))]
                order[tied] = sub
        return EdgeSet(
            self.ipos[order], self.jpos[order], self.mi[order],
            self.mi_wog[order], self.colmax,
        )


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------- #
# pure sweep core (shared by jit single-chip and shard_map multi-chip)
# ---------------------------------------------------------------------- #

def _buf_dtype(st: SweepStatics):
    return jnp.float32 if st.cdtype == jnp.float32 else st.cdtype


def dense_onehot_limit() -> int:
    """Largest dense one-hot (bytes) that "auto" residency keeps on the
    device: 1/16 of the device's memory limit, 1 GiB where the device
    reports none (the CPU)."""
    lim = device_bytes_limit()
    return lim // 16 if lim else 1 << 30


def effective_row_capacity(st: SweepStatics) -> int:
    """Usable per-row edge slots (both compaction paths now emit a dense
    K-capacity window with a true count, so this is simply K)."""
    return st.edge_capacity


def onehot_slice(data: DeviceData, st: SweepStatics, c0, dtype):
    """(S, tile*5) one-hot block of columns [c0, c0+tile) in ``dtype``
    (interleaved minor layout: the 5 states of each column adjacent).

    Codes mode: the one-hot never lives in device memory; each tile is
    expanded by a broadcast compare of the codes against the 5 states.
    Pad codes (255) match no state, exactly like the all-zero one-hot
    rows/columns of the dense storage.
    """
    T = st.tile
    if not st.onehot_codes:
        x = jax.lax.dynamic_slice(
            data.onehot, (0, c0 * N_STATES), (st.S, T * N_STATES)
        )
        return x if x.dtype == dtype else x.astype(dtype)
    sl = jax.lax.dynamic_slice(data.onehot, (0, c0), (st.S, T))  # u8
    states = jnp.arange(N_STATES, dtype=jnp.uint8)
    return (sl[:, :, None] == states).astype(dtype).reshape(st.S, -1)


def tile_crosstab(st: SweepStatics, xi, xj):
    """(TI*5, TJ*5) crosstable of one tile pair in the compute dtype.

    ``xi`` is the weighted i-side operand of :func:`row_buffers` (a
    tuple of int8 digit operands in the int8 modes).  On 2-D meshes the
    per-shard counts are psum-merged over the samples axis (SURVEY
    §7.9's collective analogue of Graph::join, one level lower — at the
    count accumulation the reference does in-thread).  int32 partials
    psum exactly, and are converted (and de-quantised) only after the
    collective, so sharded int8 sweeps are bit-identical to one device.
    """
    if st.int8_mode == "off":
        C = crosstab_tile_flat(xi, xj, dtype=_buf_dtype(st),
                               precision=st.xtab_precision)
        return jax.lax.psum(C, st.psum_axis) if st.psum_axis else C
    C = crosstab_tile_int8(xi, xj, INT8_PASS_MULTS[st.int8_mode])
    if st.psum_axis:
        C = jax.lax.psum(C, st.psum_axis)
    C = C.astype(jnp.float32)
    if st.int8_mode == "fixed14":
        C = C * jnp.float32(1.0 / st.int8_scale)
    return C


def tile_mi_pair(data: DeviceData, st: SweepStatics, xi, xj, i0, j0):
    """(mi, mi_wog_effective) for the (i0, j0) tile of column pairs.

    Uses the flat (TI*5, TJ*5) crosstable layout of
    ops/mi.py:crosstab_tile_flat (no transpose after the matmul)."""
    T = st.tile
    C = tile_crosstab(st, xi, xj)
    ipf = jax.lax.dynamic_slice_in_dim(data.presence, i0, T, 0).reshape(-1)
    jpf = jax.lax.dynamic_slice_in_dim(data.presence, j0, T, 0).reshape(-1)
    ipwf = jax.lax.dynamic_slice_in_dim(data.presence_wog, i0, T, 0).reshape(-1)
    jpwf = jax.lax.dynamic_slice_in_dim(data.presence_wog, j0, T, 0).reshape(-1)
    mi = mi_from_crosstab_flat(C, ipf, jpf, st.pseudocount)
    mi_wog = mi_from_crosstab_flat(C, ipwf, jpwf, st.pseudocount)
    gi = jax.lax.dynamic_slice_in_dim(data.gap, i0, T, 0)
    gj = jax.lax.dynamic_slice_in_dim(data.gap, j0, T, 0)
    either = gi[:, None] | gj[None, :]
    # effective wo-gaps weight: reference stores a wo-gaps edge only for
    # gap-afflicted pairs (mi.hpp:433); the outlier formatter falls back
    # to mi when absent (SpydrPick.hpp:106-107).
    return mi, jnp.where(either, mi_wog, mi)


def tile_mi_single(data: DeviceData, st: SweepStatics, xi, xj, i0, j0):
    """mi only for the (i0, j0) tile — the lazy-wog hot path (bit-
    identical to tile_mi_pair's first output)."""
    T = st.tile
    C = tile_crosstab(st, xi, xj)
    ipf = jax.lax.dynamic_slice_in_dim(data.presence, i0, T, 0).reshape(-1)
    jpf = jax.lax.dynamic_slice_in_dim(data.presence, j0, T, 0).reshape(-1)
    return mi_from_crosstab_flat(C, ipf, jpf, st.pseudocount)


def row_buffers(data: DeviceData, st: SweepStatics, i0,
                dual: bool | None = None, jc0=None):
    """Fill (tile, W) MI row buffers for block-row i0 via fori_loop.

    ``jc0=None`` (full-width mode): W = Lp, the buffer covers the whole
    row.  ``jc0`` set (windowed mode, st.row_window > 0): W =
    st.row_window and the buffer covers global columns
    [jc0, jc0 + W) — jc0 may be a TRACED multiple of the tile size, so
    one compiled program serves every window of every row.  Windows are
    how rows too wide to buffer whole (the ~10^6-column class: a
    (512, Lp) f32 buffer is 2 GB at Lp = 10^6, and the roll-routing
    temporaries multiply it) stream through fixed-size device memory.

    ``dual=False`` (the st.wog_lazy default) computes only the mi
    buffer and returns (mi_buf, None); the wog variant is recovered
    post-hoc for the few edges that need it (mi.hpp:466-490 sparsity).
    ``dual=True`` forces both (overflow re-extraction, oracle tests).
    """
    if dual is None:
        dual = not st.wog_lazy
    T = st.tile
    W = st.Lp if jc0 is None else st.row_window
    base = 0 if jc0 is None else jc0
    bd = _buf_dtype(st)

    # i-side operand, built once per row: the weight-scaled one-hot
    # (f32 path), or int8 digit operands whose int32 products recombine
    # exactly (see tile_crosstab).  The dual pass (overflow
    # re-extraction) shares the same crosstable, so it reproduces the
    # values the single-variant sweep stored bit for bit.
    if st.int8_mode == "unit":
        # 0/1 operands: exact integer counts, bit-identical MI to f32
        xi = (onehot_slice(data, st, i0, jnp.int8),)
    elif st.int8_mode == "fixed14":
        # w_q = round(w * q) in [0, 16383] split into two base-128
        # digits; tile_crosstab recombines 128*A + B in int32
        w_q = jnp.clip(
            jnp.round(data.weights.astype(jnp.float32)
                      * jnp.float32(st.int8_scale)), 0, 16383
        ).astype(jnp.int32)
        x = onehot_slice(data, st, i0, jnp.int32)
        xi = ((x * (w_q // 128)[:, None]).astype(jnp.int8),
              (x * (w_q % 128)[:, None]).astype(jnp.int8))
    else:
        xi = onehot_slice(data, st, i0, st.cdtype)
        xi = (xi * data.weights[:, None].astype(st.cdtype)).astype(bd)
    xj_dtype = (jnp.int8 if st.int8_mode != "off"
                else jnp.dtype(st.storage_dtype))

    mi_buf = jnp.full((T, W), -jnp.inf, dtype=bd)
    wog_buf = jnp.full((T, W), -jnp.inf, dtype=bd) if dual else None

    def tile_pair(xj, j0):
        if not dual:
            return tile_mi_single(data, st, xi, xj, i0, j0), None
        return tile_mi_pair(data, st, xi, xj, i0, j0)

    def body(c, bufs):
        # c is the tile index LOCAL to the window; j0 is global
        mi_buf, wog_buf = bufs
        j0 = base + c * T
        xj = onehot_slice(data, st, j0, xj_dtype)
        mi, wog = tile_pair(xj, j0)
        mi_buf = jax.lax.dynamic_update_slice(mi_buf, mi.astype(bd), (0, c * T))
        if wog_buf is not None:
            wog_buf = jax.lax.dynamic_update_slice(
                wog_buf, wog.astype(bd), (0, c * T))
        return mi_buf, wog_buf

    # first tile that can hold a stored (j > i0) pair: the one containing
    # the diagonal (windows entirely left of it are never dispatched)
    start = i0 // T if jc0 is None else jnp.maximum(i0 - jc0, 0) // T
    if dual:
        return jax.lax.fori_loop(start, W // T, body, (mi_buf, wog_buf))
    mi_buf = jax.lax.fori_loop(
        start, W // T, lambda c, m: body(c, (m, None))[0], mi_buf
    )
    return mi_buf, None


def row_masks(data: DeviceData, st: SweepStatics, i0, jc0=None):
    """(store_base, colmax_mask) for block-row i0 (full-width, or the
    [jc0, jc0 + row_window) j-window when ``jc0`` is given).

    store_base: valid upper-triangle pairs (storage is *not* LD-gated,
    mi.hpp:430-434); colmax_mask additionally requires genome distance
    > ld_threshold (mi.hpp:423-427).
    """
    T = st.tile
    i_global = i0 + jnp.arange(T, dtype=jnp.int32)
    if jc0 is None:
        W = st.Lp
        j_global = jnp.arange(W, dtype=jnp.int32)
        jpos_orig = data.orig_pos
    else:
        W = st.row_window
        base = jnp.asarray(jc0, jnp.int32)
        j_global = base + jnp.arange(W, dtype=jnp.int32)
        jpos_orig = jax.lax.dynamic_slice(data.orig_pos, (base,), (W,))
    valid = (i_global[:, None] < st.L) & (j_global[None, :] < st.L)
    upper = j_global[None, :] > i_global[:, None]
    ipos_orig = data.orig_pos[jnp.clip(i_global, 0, st.Lp - 1)]
    d = jnp.abs(ipos_orig[:, None] - jpos_orig[None, :])
    if not st.linear_genome:
        d = jnp.minimum(d, st.genome_size - d)
    return valid & upper, valid & upper & (d > st.ld_threshold)


def row_sweep_core(data: DeviceData, st: SweepStatics, i0, threshold,
                   width: int | None = None, jc0=None):
    """One block-row (or one j-window of one): colmax parts + compacted
    thresholded edges.

    Returns (colmax_i (T,), colmax_j (Lp or W,), vals (K,), wogs (K,),
    ipos (K,) int32 global, jpos (K,) int32, count, lines):
    ``count`` is the true edge count (poisoned to 2^30 on window
    overflow), ``lines`` the number of valid LN-wide store lines the
    K window holds (sub-line tails are zero padding with jpos = 0,
    dropped by the jpos > ipos fetch filter).

    ``width`` (static): route-compaction window — callers guarantee
    Lp - width <= i0, so the static right-aligned slice [Lp-width, Lp)
    covers every storable j > i0 of this block-row and the routing cost
    scales with the live triangle instead of the full row (the store
    layout is identical to a full-width route: same survivors, same
    j-ascending order, same per-i-row line packing).

    ``jc0`` (traced, multiple of tile; exclusive with ``width``):
    windowed mode — the MI buffers themselves cover only global columns
    [jc0, jc0 + st.row_window), so device memory per work item is fixed
    regardless of alignment width (the (i, j)-tile grid streamed as
    (block-row, j-window) items; per-item K applies per window).
    """
    K = st.edge_capacity
    LN = st.store_lanes
    T = st.tile
    windowed = jc0 is not None
    mi_buf, wog_buf = row_buffers(data, st, i0, jc0=jc0)
    store_base, colmax_mask = row_masks(data, st, i0, jc0=jc0)
    neg = jnp.asarray(-jnp.inf, mi_buf.dtype)
    Wb = mi_buf.shape[1]  # Lp, or row_window in windowed mode

    masked = jnp.where(colmax_mask, mi_buf, neg)
    colmax_i = jnp.max(masked, axis=1)   # (T,) maxima for rows i0..i0+T
    colmax_j = jnp.max(masked, axis=0)   # (Wb,) contributions to j positions

    store = store_base & (mi_buf > threshold)
    j_offset = 0 if jc0 is None else jc0
    if width is not None and width < Wb:
        # route buckets: the static right-aligned slice holds every
        # storable j > i0, so routing scales with the live triangle
        start = Wb - width
        mi_buf, store = mi_buf[:, start:], store[:, start:]
        wog_buf = None if wog_buf is None else wog_buf[:, start:]
        j_offset = start
    compact = (compact_edges_route if st.compaction == "route"
               else compact_edges_scatter)
    vals, wogs, ipos, jpos, count, lines = compact(
        mi_buf, wog_buf, store, i0, K, LN, j_offset=j_offset)
    return (colmax_i, colmax_j, vals.astype(mi_buf.dtype),
            wogs.astype(mi_buf.dtype), ipos, jpos, count, lines)


def overflow_edge_mask(s_i, s_j, overflow_items, T, RW):
    """Boolean mask of fetched edges that belong to overflowed
    (block-row, j-window) items: their stored entries are TRUNCATED by
    the per-item K window, so callers drop them and re-extract on host
    (windowed items drop only their own j-window).  Shared by the
    single-device sweep and both sharded drain paths."""
    srow = (s_i // T) * T
    bad = np.zeros(len(s_i), bool)
    for i0, jc0 in overflow_items:
        b = srow == i0
        if jc0 is not None:
            b &= (s_j >= jc0) & (s_j < jc0 + RW)
        bad |= b
    return bad


def rows_group_core(
    data: DeviceData,
    st: SweepStatics,
    row_starts,            # (G,) int32; -1 entries are skipped padding
    threshold,
    colmax,                # (Lp,) carry
    mi_s, wog_s,           # (cap,) edge stores (device-resident carries)
    ip_s, jp_s,            # (cap,) int32 position stores
    offset,                # () int32: next free slot
    total,                 # () int32: true edge count (overflow detect)
    width: int | None = None,  # static route window (row_sweep_core)
    chunk_starts=None,     # (G,) int32 j-window starts (windowed mode)
):
    """Sweep a group of block-rows (or (block-row, j-window) work items
    when ``chunk_starts`` is given), appending edges to device-resident
    stores — no host transfer per row.  Stores are 2-D (lines, LN)
    with ``offset`` counted in LINES (see SweepStatics.store_lanes).  The
    per-item K-sized compaction window is appended at line ``offset``;
    the garbage tail beyond each item's line count is overwritten by the
    next append, so lines [0, offset) are always valid (sub-line holes
    are zero padding, dropped by the jpos > ipos fetch filter).
    Overflow (an item exceeding K) is detected on the host from counts.
    """
    T = st.tile
    K = st.edge_capacity
    LN = st.store_lanes
    KL = K // LN                   # lines per row window
    cap_lines = mi_s.shape[0]
    G = row_starts.shape[0]
    windowed = chunk_starts is not None

    def one_row(i0, jc0, carry):
        colmax, mi_s, wog_s, ip_s, jp_s, offset, total = carry
        colmax_i, colmax_j, vals, wogs, ipos, jpos, count, lines = (
            row_sweep_core(data, st, i0, threshold, width,
                           jc0 if windowed else None)
        )
        if windowed:  # colmax_j covers only [jc0, jc0 + W)
            cur_j = jax.lax.dynamic_slice(colmax, (jc0,), colmax_j.shape)
            colmax = jax.lax.dynamic_update_slice(
                colmax, jnp.maximum(cur_j, colmax_j), (jc0,)
            )
        else:
            colmax = jnp.maximum(colmax, colmax_j)
        cur = jax.lax.dynamic_slice(colmax, (i0,), (T,))
        colmax = jax.lax.dynamic_update_slice(
            colmax, jnp.maximum(cur, colmax_i), (i0,)
        )
        off_w = jnp.minimum(offset, cap_lines - KL)  # never clobber past cap
        to2d = lambda x: x.reshape(KL, LN)
        mi_s = jax.lax.dynamic_update_slice(mi_s, to2d(vals), (off_w, 0))
        if not st.wog_lazy:
            # lazy mode never computes nor reads wog store lines (the
            # resolver recomputes outlier candidates post-hoc), so the
            # append — and the store allocation, see sweep() — is elided
            wog_s = jax.lax.dynamic_update_slice(wog_s, to2d(wogs), (off_w, 0))
        ip_s = jax.lax.dynamic_update_slice(ip_s, to2d(ipos), (off_w, 0))
        jp_s = jax.lax.dynamic_update_slice(jp_s, to2d(jpos), (off_w, 0))
        offset = off_w + jnp.minimum(lines, KL)
        total = total + count
        return (colmax, mi_s, wog_s, ip_s, jp_s, offset, total), count, lines

    def body(r, state):
        carry, counts, lines_a = state
        i0 = row_starts[r]
        jc0 = chunk_starts[r] if windowed else None
        new_carry, count, lines = jax.lax.cond(
            i0 >= 0,
            lambda c: one_row(i0, jc0, c),
            lambda c: (c, jnp.int32(0), jnp.int32(0)),
            carry,
        )
        return new_carry, counts.at[r].set(count), lines_a.at[r].set(lines)

    carry = (colmax, mi_s, wog_s, ip_s, jp_s, offset, total)
    counts0 = jnp.zeros(G, jnp.int32)
    carry, counts, lines_a = jax.lax.fori_loop(
        0, G, body, (carry, counts0, counts0))
    return (*carry, counts, lines_a)


def row_full_core(data: DeviceData, st: SweepStatics, i0, jc0=None):
    """Full MI row, or one j-window of it (host-extraction fallback for
    capacity overflow); always dual — overflow re-extraction needs
    exact wog for every edge of the row regardless of lazy mode."""
    mi_buf, wog_buf = row_buffers(data, st, i0, dual=True, jc0=jc0)
    store_base, colmax_mask = row_masks(data, st, i0, jc0=jc0)
    return mi_buf, wog_buf, store_base, colmax_mask


def _pairs_xtab(data: DeviceData, st: SweepStatics, ipos, jpos):
    """(P, 5, 5) weighted joint-count tables for explicit position
    pairs, computed from the codes matrix.

    The joint state ``q = ci*5 + cj`` of every (sample, pair) cell is
    compared against the 25 joint states inside one fused
    compare/select/reduce over samples — device-memory traffic is the
    two (S, P) u8 code gathers instead of two (S, P, 5) one-hot
    operands plus a batched matmul with 5x5 outputs, too small to tile.
    The 25-state axis is laid out MAJOR (25, P) so the pair axis stays
    the minor (contiguous) one.

    Pad rows (codes 255) miss every comparison and contribute exactly
    zero, like the all-zero one-hot rows they replace."""
    bd = _buf_dtype(st)
    ci = jnp.take(data.codes, ipos, axis=1).astype(jnp.int32)  # (S, P)
    cj = jnp.take(data.codes, jpos, axis=1).astype(jnp.int32)
    q = ci * N_STATES + cj
    k = jnp.arange(N_STATES * N_STATES, dtype=jnp.int32)
    w = data.weights.astype(bd)
    C = jnp.sum(
        jnp.where(q[:, None, :] == k[None, :, None],
                  w[:, None, None], jnp.zeros((), bd)),
        axis=0,
    )  # (25, P)
    if st.psum_axis:
        # sample-sharded crosstable merge (see tile_mi_pair)
        C = jax.lax.psum(C, st.psum_axis)
    return jnp.moveaxis(C, 0, -1).reshape(-1, N_STATES, N_STATES)


def pairs_mi_core(data: DeviceData, st: SweepStatics, ipos, jpos):
    """Batched per-pair MI (tournament path; reference
    ``MI_solver::single`` + ``single_edge_MI_solver``, mi.hpp:183-224,
    SpydrPick.hpp:209-255)."""
    C = _pairs_xtab(data, st, ipos, jpos)
    ip = data.presence[ipos]
    jp = data.presence[jpos]
    return mi_from_crosstabs(C, ip, jp, st.pseudocount)


def pairs_mi_dual_core(data: DeviceData, st: SweepStatics, ipos, jpos):
    """(mi, effective wog) for explicit pairs — the lazy-wog resolver.

    The wo-gaps variant reuses the same crosstable with the gap bit
    cleared from the presence masks, defaulted to mi for pairs where
    neither column has gaps — the reference's store-then-lookup
    semantics (mi.hpp:433,466-490 + SpydrPick.hpp:106-107)."""
    C = _pairs_xtab(data, st, ipos, jpos)
    mi = mi_from_crosstabs(C, data.presence[ipos], data.presence[jpos],
                           st.pseudocount)
    wog = mi_from_crosstabs(C, data.presence_wog[ipos],
                            data.presence_wog[jpos], st.pseudocount)
    either = data.gap[ipos] | data.gap[jpos]
    return mi, jnp.where(either, wog, mi)


def pairs_quantile_core(data: DeviceData, st: SweepStatics, ip3, jp3,
                        n_valid, k):
    """Device-side threshold tournament: per-iteration MI evaluation +
    order statistic in ONE program.

    ip3/jp3: (iters, n_chunks, chunk) position indices (uint16/int32;
    chunk rows beyond ``n_valid`` pairs per iteration are padding).
    Returns (iters,) f32 — the ascending order statistic ``k`` of each
    iteration's ``n_valid`` MI values (std::nth_element semantics,
    SpydrPick.hpp:329-330; identical values to a host-side partition
    over the same f32 MI).  Replaces ~60 chunked dispatches + a full
    MI-vector drain per tournament with one dispatch returning
    ``iters`` floats."""

    def one_iter(ij):
        ip, jp = ij
        mi = jax.lax.map(
            lambda c: pairs_mi_core(data, st,
                                    c[0].astype(jnp.int32),
                                    c[1].astype(jnp.int32)),
            (ip, jp),
        ).reshape(-1)
        pad = jnp.arange(mi.shape[0], dtype=jnp.int32) >= n_valid
        # +inf padding occupies the TOP of the ascending order, leaving
        # indices [0, n_valid) — hence order statistic k — untouched
        mi = jnp.where(pad, jnp.inf, mi.astype(jnp.float32))
        return jnp.sort(mi)[k]

    return jax.lax.map(one_iter, (ip3, jp3))


def pack_tournament_indices(ipos, jpos, iters: int, n_valid: int,
                            chunk: int, Lp: int):
    """(iters, nc, chunk) zero-padded index tensors for
    ``pairs_quantile_core`` — the packing convention shared by
    ``MIEngine.pair_quantiles`` and ``ShardedEngineView.pair_quantiles``
    (uint16 when positions fit, pad rows masked by ``n_valid``)."""
    Pp = _ceil_to(n_valid, chunk)
    nc = Pp // chunk
    dt = np.uint16 if Lp <= (1 << 16) else np.int32
    ip3 = np.zeros((iters, Pp), dtype=dt)
    jp3 = np.zeros((iters, Pp), dtype=dt)
    for it in range(iters):
        ip3[it, :n_valid] = ipos[it * n_valid: (it + 1) * n_valid]
        jp3[it, :n_valid] = jpos[it * n_valid: (it + 1) * n_valid]
    return (ip3.reshape(iters, nc, chunk), jp3.reshape(iters, nc, chunk),
            nc, np.dtype(dt).name)


_FETCH_CHUNK_LINES = 2048  # store lines per drain transfer (1 MB of f32 mi)
_ASM_BATCH_CHUNKS = 8      # full chunks per incremental assembly submit


def fetch_chunk_core(mi_s, wog_s, ip_s, jp_s, c0, st: SweepStatics,
                     ch: int, include_wog: bool):
    """Packed host-drain slice of the edge stores: ``ch`` lines starting
    at line ``c0`` (static shape — compiled once; the legacy ``[:off]``
    fetch paid a fresh slice compile per distinct offset).

    With the "route" compaction every store line belongs to exactly one
    i-row (per-row line-granular assembly, ops/compact.py), so
    ipos travels once per line (lane 0) instead of once per edge; the
    scatter compaction emits whole-block K windows whose lines mix
    i-rows, so ipos travels per edge there.  jpos travels as uint16
    when it fits — 772 B per 128-edge line instead of 2048 B for the
    four f32/i32 buffers.
    """
    CH = ch
    mi = jax.lax.dynamic_slice_in_dim(mi_s, c0, CH, 0)
    ip = jax.lax.dynamic_slice_in_dim(ip_s, c0, CH, 0)
    if st.compaction == "route":
        ip = ip[:, 0]
    elif st.Lp <= (1 << 16):
        ip = ip.astype(jnp.uint16)
    jp = jax.lax.dynamic_slice_in_dim(jp_s, c0, CH, 0)
    if st.Lp <= (1 << 16):
        jp = jp.astype(jnp.uint16)
    out = (mi, ip, jp)
    if include_wog:
        out += (jax.lax.dynamic_slice_in_dim(wog_s, c0, CH, 0),)
    return out


# ---------------------------------------------------------------------- #
# engine (host driver)
# ---------------------------------------------------------------------- #

def build_device_data(alignment: Alignment, config: EngineConfig) -> tuple[DeviceData, SweepStatics]:
    """Materialise the DeviceData pytree + statics for an alignment."""
    L, S = alignment.n_loci, alignment.n_samples
    tile = config.tile
    Lp = max(_ceil_to(L, tile), tile)
    # j-window width (see EngineConfig.row_window): auto-on past 2^17
    # padded columns, where the full-width (tile, Lp) row buffer and
    # its routing temporaries stop fitting comfortably; the window
    # count is fixed first and the width rounded up so windows tile Lp
    # exactly (bounded padding: < n_windows * tile columns).
    rw = config.row_window
    if rw == 0:
        rw = (1 << 16) if Lp > (1 << 17) else 1
    if rw > 1 and rw < Lp:
        rw = max(_ceil_to(rw, tile), tile)
        n_w = -(-Lp // rw)
        rw = _ceil_to(-(-Lp // n_w), tile)
        Lp = n_w * rw
    else:
        rw = 0
    cdtype = jnp.dtype(config.compute_dtype)
    sdtype = jnp.dtype(config.storage_dtype)
    if cdtype == jnp.float64:
        sdtype = jnp.float64  # keep everything f64 in x64 test mode

    compaction = {"auto": DEFAULT_COMPACTION, "route": "route",
                  "scatter": "scatter"}[config.compaction]

    # int8 crosstable modes (EngineConfig.mxu_int8): unit-weight runs
    # get the exact 0/1 int8 single pass under "auto"; weighted sweeps
    # run the fixed14 split only under "on", and only when the weight
    # SPREAD is bounded — the per-sample quantisation error is
    # <= (max_w/min_w)/2^15 relative, so at spread <= 32 it stays in the
    # f32 epilogue's own error class (tests/test_int8_crosstable.py).
    # int8 one-hot storage also halves dense-mode device memory.
    wr = (np.ones(S) if alignment.weights is None
          else np.asarray(alignment.weights, dtype=np.float64))
    unit_weights = bool(np.all(wr == 1.0))
    int8_mode, int8_scale = "off", 0.0
    if sdtype == jnp.bfloat16 and config.mxu_int8 != "off":
        if unit_weights:
            int8_mode = "unit"
        elif (config.mxu_int8 == "on" and np.all(wr > 0)
              and float(wr.max()) / float(wr.min()) <= 32.0
              and S * 16383 < 2**31):
            # S guard: an int32 crosstable cell accumulates at most
            # sum(w_q) <= S*16383 — past ~131k samples it could wrap,
            # so such runs stay on the f32 path
            int8_mode = "fixed14"
            int8_scale = 16383.0 / float(wr.max())
    if int8_mode != "off":
        sdtype = jnp.dtype(jnp.int8)

    codes = np.full((S, Lp), 255, dtype=np.uint8)
    codes[:, :L] = alignment.codes
    oh_mode = config.onehot_storage
    if oh_mode == "auto":
        dense_bytes = S * Lp * N_STATES * jnp.dtype(sdtype).itemsize
        oh_mode = "codes" if dense_bytes > dense_onehot_limit() else "dense"
    if oh_mode == "codes":
        onehot = jnp.asarray(codes)  # 10x smaller; tiles expand on use
        codes_dev = onehot           # pairs paths share the buffer
    else:
        codes_dev = jnp.asarray(codes)
        states = jnp.arange(N_STATES, dtype=jnp.uint8)
        oh3 = (codes_dev[:, :, None] == states[None, None, :])
        onehot = oh3.astype(sdtype).reshape(S, Lp * N_STATES)

    def _pad_bool(x):
        out = np.zeros((Lp, N_STATES), dtype=bool)
        out[:L] = x
        return out

    gap = np.zeros(Lp, dtype=bool)
    gap[:L] = alignment.gap_presence
    orig = np.full(Lp, np.iinfo(np.int32).max // 4, dtype=np.int32)
    orig[:L] = alignment.translation.astype(np.int32)

    data = DeviceData(
        onehot=onehot,
        weights=jnp.asarray(wr, dtype=cdtype),
        presence=jnp.asarray(_pad_bool(alignment.state_presence), dtype=cdtype),
        presence_wog=jnp.asarray(
            _pad_bool(alignment.state_presence_wo_gaps), dtype=cdtype
        ),
        gap=jnp.asarray(gap),
        orig_pos=jnp.asarray(orig),
        codes=codes_dev,
    )
    statics = SweepStatics(
        L=L, Lp=Lp, S=S, tile=tile, n_chunks=Lp // tile,
        edge_capacity=config.edge_capacity,
        pseudocount=config.pseudocount,
        ld_threshold=config.ld_threshold,
        linear_genome=config.linear_genome,
        genome_size=int(alignment.n_original_positions),
        compute_dtype=config.compute_dtype,
        matmul_precision=config.matmul_precision,
        compaction=compaction,
        wog_lazy=config.wog_fetch == "outliers",
        unit_weights=unit_weights,
        onehot_codes=oh_mode == "codes",
        storage_dtype=str(jnp.dtype(sdtype)),
        row_window=rw,
        int8_mode=int8_mode,
        int8_scale=int8_scale,
    )
    return data, statics


# ---------------------------------------------------------------------- #
# module-level jitted-program factories, memoised on the statics.
#
# The pipeline builds a NEW engine per run; per-engine jax.jit wrappers
# would retrace every program and pay a persistent-cache deserialize
# per dispatch even when an identical-statics engine already ran in
# this process.  SweepStatics is a
# frozen, hashable dataclass of scalars, so the traced+compiled
# executables are safely shared; device tensors only ever travel as
# call arguments.
# ---------------------------------------------------------------------- #


@functools.lru_cache(maxsize=64)
def _jit_row_sweep(st):
    return jax.jit(partial(row_sweep_core, st=st))


@functools.lru_cache(maxsize=64)
def _jit_row_full(st):
    return jax.jit(partial(row_full_core, st=st))


@functools.lru_cache(maxsize=64)
def _jit_pairs_mi(st):
    return jax.jit(partial(pairs_mi_core, st=st))


@functools.lru_cache(maxsize=64)
def _jit_pairs_dual(st):
    return jax.jit(partial(pairs_mi_dual_core, st=st))


@functools.lru_cache(maxsize=128)
def _jit_quant(st, iters, nc, chunk, dt):
    del iters, nc, chunk, dt  # cache key only; shapes live in the args
    return jax.jit(lambda data, ip3, jp3, n_valid, kk:
                   pairs_quantile_core(data, st, ip3, jp3, n_valid, kk))


@functools.lru_cache(maxsize=64)
def _jit_fetch(st, ch, include_wog):
    return jax.jit(partial(fetch_chunk_core, st=st, ch=ch,
                           include_wog=include_wog))


@functools.lru_cache(maxsize=64)
def _jit_fetch_colmax(st):
    return jax.jit(lambda c: c[: st.L])


@functools.lru_cache(maxsize=64)
def _jit_group(st, width):
    def _group(data, row_starts, threshold, colmax, mi_s, wog_s,
               ip_s, jp_s, offset, total):
        return rows_group_core(data, st, row_starts, threshold,
                               colmax, mi_s, wog_s, ip_s, jp_s,
                               offset, total, width=width)

    return jax.jit(_group, donate_argnums=(3, 4, 5, 6, 7, 8, 9))


@functools.lru_cache(maxsize=64)
def _jit_group_win(st):
    def _group(data, row_starts, chunk_starts, threshold, colmax,
               mi_s, wog_s, ip_s, jp_s, offset, total):
        return rows_group_core(data, st, row_starts, threshold,
                               colmax, mi_s, wog_s, ip_s, jp_s,
                               offset, total, chunk_starts=chunk_starts)

    return jax.jit(_group, donate_argnums=(4, 5, 6, 7, 8, 9, 10))


class MIEngine:
    """Holds device-resident alignment tensors and jitted sweep programs."""

    def __init__(self, alignment: Alignment, config: EngineConfig = EngineConfig(),
                 _prebuilt: tuple | None = None):
        self.alignment = alignment
        self.config = config
        # _prebuilt: (data, statics) from an existing engine — lets two
        # engines with different static schedules share one set of
        # device-resident alignment tensors (in-process kernel A/Bs;
        # the statics must describe the same data layout)
        if _prebuilt is not None:
            self.data, self.statics = _prebuilt
        else:
            self.data, self.statics = build_device_data(alignment, config)
        self.L = self.statics.L
        self.S = self.statics.S
        self.Lp = self.statics.Lp
        self.tile = self.statics.tile

        st = self.statics
        self._row_sweep = _jit_row_sweep(st)
        self._row_full = _jit_row_full(st)
        self._pairs_mi = _jit_pairs_mi(st)
        self._pairs_dual = _jit_pairs_dual(st)
        # device-accumulating group sweep; stores donated so the carry
        # stays in place across dispatches
        self._rows_group = _jit_group(st, None)
        # drain chunk size: largest divisor of the store line count
        # <= _FETCH_CHUNK_LINES, so chunks tile the store exactly.
        # The store must hold at least one full dispatch group (G per-row
        # K windows) — the packed drain recycles it in epochs (see
        # sweep), so capacity bounds the compute-ahead-of-drain lag, not
        # the total edge count.
        import math

        self._cap_slots = max(
            config.store_capacity,
            2 * config.edge_capacity,
            config.rows_per_dispatch * config.edge_capacity,
        )
        cap_lines = self._cap_slots // st.store_lanes
        self._chunk_lines = math.gcd(cap_lines, _FETCH_CHUNK_LINES)
        self._fetch_chunk = _jit_fetch(st, self._chunk_lines, False)
        self._fetch_chunk_wog = _jit_fetch(st, self._chunk_lines, True)
        self._fetch_colmax = _jit_fetch_colmax(st)

    # ------------------------------------------------------------------ #
    def _route_widths(self) -> list[int | None]:
        """Ascending route-window bucket widths (None = full Lp)."""
        st = self.statics
        n = self.config.width_buckets
        if n == 0:
            n = 4 if st.Lp >= 8192 else 1
        if st.row_window or st.compaction != "route" or n <= 1:
            # windowed mode needs no buckets: items left of the diagonal
            # are simply never dispatched
            return [None]
        LN = st.store_lanes
        widths: set = set()
        for k in range(1, n):
            W = _ceil_to(max(st.Lp >> k, LN), LN)
            if W < st.Lp:
                widths.add(W)
        return sorted(widths) + [None]

    def _bucket_width(self, i0: int, widths) -> int | None:
        rem = self.Lp - i0
        for W in widths:
            if W is None or W >= rem:
                return W
        return None

    def _group_fn(self, width: int | None):
        return _jit_group(self.statics, width)

    def _group_fn_win(self):
        """Windowed twin of :meth:`_group_fn`: one compiled program for
        every (block-row, j-window) item group (both starts traced)."""
        return _jit_group_win(self.statics)

    # ------------------------------------------------------------------ #
    def _pairs_chunked(self, fn, pick, ipos, jpos, chunk):
        """Chunk explicit pairs to one static shape and pipeline the
        dispatches: all chunks are enqueued before any result is read,
        so callers pay one pipeline of device work instead of a blocking
        host round trip per chunk (~60 chunks/iteration at the 500k-pair
        production tournament).  ``pick`` selects the wanted output of
        ``fn`` (the dual kernel returns (mi, wog))."""
        P = len(ipos)
        out = np.empty(P, dtype=np.float64)
        results = []
        for c0 in range(0, P, chunk):
            ii = np.asarray(ipos[c0 : c0 + chunk], dtype=np.int32)
            jj = np.asarray(jpos[c0 : c0 + chunk], dtype=np.int32)
            n = len(ii)
            if n < chunk:  # pad to a single static shape
                ii = np.pad(ii, (0, chunk - n))
                jj = np.pad(jj, (0, chunk - n))
            res = pick(fn(self.data, ipos=jnp.asarray(ii),
                          jpos=jnp.asarray(jj)))
            res.copy_to_host_async()
            results.append((c0, n, res))
        for c0, n, res in results:
            out[c0 : c0 + n] = np.asarray(res)[:n]
        return out

    def pair_mi(self, ipos: np.ndarray, jpos: np.ndarray, chunk: int = 8192) -> np.ndarray:
        """MI for explicit position pairs (tournament path)."""
        return self._pairs_chunked(self._pairs_mi, lambda r: r,
                                   ipos, jpos, chunk)

    def pair_quantiles(self, ipos: np.ndarray, jpos: np.ndarray,
                       iters: int, n_valid: int, k: int,
                       chunk: int = 8192) -> np.ndarray:
        """Per-iteration MI order statistics for the threshold
        tournament, computed in ONE device dispatch (pairs_quantile_core)
        — the only host traffic is the compact index upload and
        ``iters`` floats down.  ``ipos``/``jpos`` hold ``iters``
        consecutive samples of ``n_valid`` pairs each; returns (iters,)
        f64 of each sample's ascending order statistic ``k`` —
        bit-identical values to partitioning pair_mi's output."""
        ip3, jp3, nc, dt = pack_tournament_indices(
            ipos, jpos, iters, n_valid, chunk, self.Lp)
        fn = _jit_quant(self.statics, iters, nc, chunk, dt)
        out = fn(self.data, jnp.asarray(ip3), jnp.asarray(jp3),
                 jnp.asarray(n_valid, jnp.int32),
                 jnp.asarray(k, jnp.int32))
        return np.asarray(out, dtype=np.float64)

    def sweep(
        self,
        threshold: float,
        progress=None,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 16,
        timings: dict | None = None,
    ) -> EdgeSet:
        """All-pairs upper-triangle sweep storing edges with mi > threshold.

        ``progress``: optional callable(row_start, row_end, n_edges, dt)
        mirroring the reference per-block verbose lines (mi.hpp:497-506).
        ``checkpoint_path``: optional tile-range checkpoint (resume a
        killed run; saved every ``checkpoint_every`` rows).
        ``timings``: optional dict filled with wall-clock phase seconds
        (compute_s = dispatch+sync group loop, fetch_s = bulk edge-store
        drain to host, overflow_s = per-row re-extraction) so the bench
        can itemize where a sweep spends its time.
        """
        from spydrpick_jax.engine import checkpoint as ckpt_mod

        t_setup0 = time.perf_counter()
        L, T, K = self.L, self.tile, self.config.edge_capacity
        colmax = np.full(L, -np.inf)
        all_i, all_j, all_mi, all_wog = [], [], [], []
        done_rows: set[int] = set()
        ck_key = ckpt_mod.params_key(self.statics, threshold)
        if checkpoint_path:
            ck = ckpt_mod.load(checkpoint_path, ck_key)
            if ck is not None:
                colmax = ck.colmax
                all_i, all_j, all_mi, all_wog = ck.ipos, ck.jpos, ck.mi, ck.mi_wog
                done_rows = ck.done_rows
        bd = _buf_dtype(self.statics)
        thr = jnp.asarray(threshold, bd)

        # Device-accumulating group sweep: edges append to device-resident
        # stores; per group only the (G,) counts vector crosses the slow
        # host link.  Without checkpointing the drain is *packed and
        # overlapped*: completed fixed-size store chunks start their
        # device->host copy asynchronously while later groups compute
        # (fetch_chunk_core), so the drain largely hides under compute.
        # Checkpointed runs keep the legacy bulk fetch (the mid-run
        # snapshot needs the full wog store anyway).
        # Stores are (lines, LN) 2-D — see SweepStatics.store_lanes.
        LN = self.statics.store_lanes
        CH = self._chunk_lines
        cap_lines = self._cap_slots // LN
        KL = K // LN
        K_eff = effective_row_capacity(self.statics)
        G = self.config.rows_per_dispatch
        RW = self.statics.row_window
        row_starts = [r for r in range(0, L, T) if r not in done_rows]
        # windowed mode: the unit of work is a (block-row, j-window)
        # item; a row is done when all its windows past the diagonal
        # have resolved
        row_pending: dict[int, int] = {}
        packed = checkpoint_path is None
        wog_full = self.config.wog_fetch != "outliers"

        colmax_d = jnp.asarray(
            np.concatenate([colmax, np.full(self.Lp - L, -np.inf)]), bd
        )
        mi_s = jnp.zeros((cap_lines, LN), bd)
        # lazy-wog sweeps never write nor read the wog store: keep a
        # 1-line dummy so the jitted signature stays uniform without the
        # cap_lines*LN*4 B HBM allocation (268 MB at default caps)
        wog_s = jnp.zeros(
            (1 if self.statics.wog_lazy else cap_lines, LN), bd)
        ip_s = jnp.zeros((cap_lines, LN), jnp.int32)
        jp_s = jnp.zeros((cap_lines, LN), jnp.int32)
        offset = jnp.asarray(0, jnp.int32)  # in lines
        total = jnp.asarray(0, jnp.int32)

        overflow_items: list[tuple[int, int | None]] = []  # (i0, jc0)
        expected_offset = 0
        pending: list[tuple[int, tuple]] = []  # (c0, device chunk arrays)
        fetched_lines_total = 0
        epoch_drains = 0
        # packed-drain assembly runs on a worker thread, so the NumPy
        # repack of an epoch's chunks (np.asarray waits + keep-filter +
        # concatenation) never stalls the dispatch loop (and with it
        # the device).  One worker keeps epochs ordered; the futures
        # resolve in the final fetch phase.
        from concurrent.futures import ThreadPoolExecutor

        assembler = ThreadPoolExecutor(1)
        collected_futs: list = []
        n_submitted = 0  # chunks of the current epoch already submitted

        def fetch_chunks_upto(watermark: int):
            """Dispatch async d2h copies of every complete, not-yet-
            fetched store chunk below ``watermark`` lines."""
            fetch = self._fetch_chunk_wog if wog_full else self._fetch_chunk
            while (len(pending) + 1) * CH <= min(watermark, cap_lines):
                c0 = len(pending) * CH
                out = fetch(mi_s, wog_s, ip_s, jp_s,
                            jnp.asarray(c0, jnp.int32))
                for o in out:
                    o.copy_to_host_async()
                pending.append((c0, out))

        def submit_ready():
            """Hand full, already-in-flight chunks to the assembly
            worker in batches DURING compute: the epoch's numpy repack
            happens incrementally under the device's compute instead of
            as one big post-loop job (the 100k/200k sweep-vs-compute
            residual), and the collected device buffers release as each
            batch completes.  Chunk order is preserved, so the final
            edge arrays are byte-identical to a single whole-epoch
            collect."""
            nonlocal n_submitted
            if len(pending) - n_submitted >= _ASM_BATCH_CHUNKS:
                batch = list(pending[n_submitted:])
                collected_futs.append(assembler.submit(
                    self._collect_packed, batch, batch[-1][0] + CH,
                    wog_full,
                ))
                # null the handed-off device-buffer refs (keeping only
                # the chunk offsets, which fetch/drain bookkeeping use)
                # so chunk memory frees as each assembly batch completes
                for k in range(n_submitted, len(pending)):
                    pending[k] = (pending[k][0], None)
                n_submitted = len(pending)

        def drain_epoch():
            """Hand everything written so far to the assembly worker and
            recycle the device store from line 0 (packed mode): every
            complete chunk is already in flight and batches of them were
            already submitted (submit_ready), so this only enqueues the
            partial tail chunk and its deferred numpy repack — the
            dispatch loop never blocks on host assembly.  Capacity
            therefore bounds the compute-ahead-of-drain lag, not the
            sweep's total edges."""
            nonlocal expected_offset, offset, fetched_lines_total, n_submitted
            if expected_offset > n_submitted * CH:
                fetch_chunks_upto(_ceil_to(expected_offset, CH))
                collected_futs.append(assembler.submit(
                    self._collect_packed, list(pending[n_submitted:]),
                    expected_offset, wog_full,
                ))
            fetched_lines_total += expected_offset
            pending.clear()
            expected_offset = 0
            n_submitted = 0
            offset = jnp.asarray(0, jnp.int32)

        # groups are width-uniform: each route-bucket width is its own
        # compiled program (see _route_widths); rows ascend, so buckets
        # are contiguous and this costs no extra dispatches.  Windowed
        # mode has a single program ("win": both starts traced), so
        # groups are just consecutive G-item slices.
        if RW:
            items: list[tuple[int, int]] = []
            for r in row_starts:
                wins = [jc0 for jc0 in range((r // RW) * RW, self.Lp, RW)]
                row_pending[r] = len(wins)
                items.extend((r, jc0) for jc0 in wins)
            groups = [("win", items[k: k + G])
                      for k in range(0, len(items), G)]
        else:
            widths = self._route_widths()
            groups: list[tuple[int | None, list]] = []
            for r in row_starts:
                w = self._bucket_width(r, widths)
                if groups and groups[-1][0] == w and len(groups[-1][1]) < G:
                    groups[-1][1].append((r, None))
                else:
                    groups.append((w, [(r, None)]))
        ck_rows = 0
        inflight: list[tuple[list[int], object, object, float]] = []

        sync_wait = 0.0

        def resolve_one():
            """Collect one in-flight group's counts (bookkeeping +
            watermark-driven chunk fetches + progress)."""
            nonlocal expected_offset, sync_wait
            grp, counts, lines_a, g_t0 = inflight.pop(0)
            t_w0 = time.perf_counter()
            counts_np = np.asarray(counts)
            lines_np = np.asarray(lines_a)
            sync_wait += time.perf_counter() - t_w0
            for r, (i0, jc0) in enumerate(grp):
                if jc0 is None:
                    done_rows.add(i0)
                else:
                    row_pending[i0] -= 1
                    if row_pending[i0] == 0:
                        done_rows.add(i0)
                n = int(counts_np[r])
                expected_offset += min(int(lines_np[r]), K // LN)
                if n > K_eff:
                    overflow_items.append((i0, jc0))
            if packed:
                fetch_chunks_upto(expected_offset)
                submit_ready()
            if progress is not None:
                progress(grp[0][0], min(grp[-1][0] + T, L),
                         int(counts_np.sum()), time.perf_counter() - g_t0)

        # pipeline_depth 1 resolves each group's counts synchronously
        # (device idles ~a round trip per group while the host learns
        # completion and dispatches the next); depth 2 bounds the lag to
        # one group — the next group is dispatched before the previous
        # group's counts are read, and its chunk fetches enqueue behind
        # exactly one group of compute.  (An earlier unbounded-lag
        # attempt measured slower: with the host free-running, every
        # chunk fetch piled up at the end of the sweep.)
        # checkpointing requires synchronous resolves: a snapshot taken
        # with an unresolved in-flight group would hold its edges in the
        # store while done_rows lacks the rows -> duplicates on resume
        # any exception in the dispatch/fetch loop (capacity error,
        # progress callback, checkpoint I/O) must still release the
        # assembler and its in-flight device chunk references
        try:
            depth = 1 if checkpoint_path else max(1, self.config.pipeline_depth)
            t_compute0 = time.perf_counter()
            t_setup = t_compute0 - t_setup0
            for gi, (gw, group) in enumerate(groups):
                pend_lines = sum(len(g) for g, *_ in inflight) * KL
                if packed and expected_offset + pend_lines + len(group) * KL > cap_lines:
                    # next group might not fit: sync in-flight bookkeeping,
                    # then recycle the store (store writes clamp at
                    # cap_lines - KL, so this must happen *before* dispatch)
                    while inflight:
                        resolve_one()
                    if expected_offset + len(group) * KL > cap_lines:
                        epoch_drains += 1
                        drain_epoch()
                elif (not packed
                      and expected_offset + pend_lines + len(group) * KL
                      > cap_lines):
                    # legacy (checkpointed) drain cannot recycle: device
                    # writes would clamp at cap_lines - KL and CLOBBER
                    # earlier rows' lines — and a checkpoint taken after
                    # that would persist the corrupt store as complete
                    # rows, silently losing edges on resume.  Raise
                    # BEFORE dispatching, so the last saved checkpoint
                    # predates any clobbering and resuming with a larger
                    # --store-capacity is sound (capacity is not part of
                    # the checkpoint key for exactly this reason).
                    raise RuntimeError(
                        f"edge store overflow: ~{expected_offset * LN} stored "
                        f"edge slots + next group would exceed capacity "
                        f"{cap_lines * LN}; raise --mi-threshold or "
                        f"--store-capacity and resume from the checkpoint"
                    )
                t0 = time.perf_counter()
                rows_p = [it[0] for it in group] + [-1] * (G - len(group))
                if gw == "win":
                    chunks_p = [it[1] for it in group] + [0] * (G - len(group))
                    (colmax_d, mi_s, wog_s, ip_s, jp_s, offset, total, counts,
                     lines_a) = self._group_fn_win()(
                        self.data, jnp.asarray(rows_p, jnp.int32),
                        jnp.asarray(chunks_p, jnp.int32), thr,
                        colmax_d, mi_s, wog_s, ip_s, jp_s, offset, total,
                    )
                else:
                    (colmax_d, mi_s, wog_s, ip_s, jp_s, offset, total, counts,
                     lines_a) = self._group_fn(gw)(
                        self.data, jnp.asarray(rows_p, jnp.int32), thr,
                        colmax_d, mi_s, wog_s, ip_s, jp_s, offset, total,
                    )
                counts.copy_to_host_async()
                lines_a.copy_to_host_async()
                inflight.append((group, counts, lines_a, t0))
                while len(inflight) >= depth:
                    resolve_one()  # depth 1: drains to empty (synchronous)
                ck_rows += len(group)
                if checkpoint_path and ck_rows >= checkpoint_every and gi < len(groups) - 1:
                    ck_rows = 0
                    s_i, s_j, s_m, s_w, s_c = self._fetch_stores(
                        mi_s, wog_s, ip_s, jp_s, offset, colmax_d
                    )
                    # persist only rows that are COMPLETE and un-overflowed:
                    # overflowed rows hold TRUNCATED edges in the store, and
                    # windowed rows may be partially swept — both re-sweep on
                    # resume (saving them as complete would silently lose
                    # edges beyond the per-item window / the missing windows)
                    save_done = done_rows - {i0 for i0, _ in overflow_items}
                    keep = np.isin(
                        (s_i // T) * T,
                        np.fromiter(save_done, np.int64, len(save_done)),
                    )
                    s_i, s_j = s_i[keep], s_j[keep]
                    s_m, s_w = s_m[keep], s_w[keep]
                    ckpt_mod.save(
                        checkpoint_path,
                        ckpt_mod.SweepCheckpoint(
                            ck_key, save_done, np.maximum(colmax, s_c),
                            all_i + [s_i], all_j + [s_j],
                            all_mi + [s_m], all_wog + [s_w],
                        ),
                    )

            while inflight:
                resolve_one()
            t_compute = time.perf_counter() - t_compute0
            # legacy drain keeps the whole sweep in the store: device appends
            # clamp at cap-K lines, and expected_offset below that proves no
            # append was ever clamped (the packed drain recycles instead)
            if not packed and expected_offset > cap_lines - KL:
                raise RuntimeError(
                    f"edge store overflow: ~{expected_offset * LN} edge slots "
                    f"exceed capacity {cap_lines * LN}; raise --mi-threshold or "
                    f"the engine store_capacity"
                )

            t_fetch0 = time.perf_counter()
            if packed:
                drain_epoch()
                collected = [f.result() for f in collected_futs]
                _cat = lambda k, dt: (
                    np.concatenate([c[k] for c in collected])
                    if collected else np.empty(0, dt)
                )
                s_i, s_j = _cat(0, np.int64), _cat(1, np.int64)
                s_m = _cat(2, np.float64)
                s_w = _cat(3, np.float64) if wog_full else None
                s_c = np.asarray(self._fetch_colmax(colmax_d), dtype=np.float64)
            else:
                s_i, s_j, s_m, s_w, s_c = self._fetch_stores(
                    mi_s, wog_s, ip_s, jp_s, offset, colmax_d
                )
            assembler.shutdown(wait=True)
        except BaseException:
            assembler.shutdown(wait=False, cancel_futures=True)
            raise
        t_fetch = time.perf_counter() - t_fetch0
        t_overflow0 = time.perf_counter()
        colmax = np.maximum(colmax, s_c)
        if overflow_items:
            bad = overflow_edge_mask(s_i, s_j, overflow_items, T, RW)
            s_i, s_j, s_m = s_i[~bad], s_j[~bad], s_m[~bad]
            if s_w is not None:
                s_w = s_w[~bad]
            for i0, jc0 in overflow_items:
                if jc0 is None:
                    bufs = self._row_full(
                        self.data, i0=jnp.asarray(i0, jnp.int32))
                else:
                    bufs = self._row_full(
                        self.data, i0=jnp.asarray(i0, jnp.int32),
                        jc0=jnp.asarray(jc0, jnp.int32))
                mi_buf, wog_buf, store_base, _ = jax.tree.map(np.asarray, bufs)
                mask = store_base & (mi_buf > threshold)
                ii, jj = np.nonzero(mask)
                all_i.append(i0 + ii.astype(np.int64))
                all_j.append((0 if jc0 is None else jc0) + jj.astype(np.int64))
                all_mi.append(mi_buf[mask].astype(np.float64))
                all_wog.append(wog_buf[mask].astype(np.float64))
        if s_w is None:
            # deferred drain: resolve wog only for outlier candidates
            # (the only edges whose wog the output surface reads,
            # SpydrPick.hpp:100-124); mi for the rest
            s_w = self._resolve_deferred_wog(s_m, s_i, s_j, colmax)
        all_i.append(s_i)
        all_j.append(s_j)
        all_mi.append(s_m)
        all_wog.append(s_w)

        if timings is not None:
            timings["compute_s"] = t_compute
            timings["fetch_s"] = t_fetch
            timings["overflow_s"] = time.perf_counter() - t_overflow0
            timings["overflow_rows"] = len(overflow_items)
            timings["fetched_edges"] = (
                fetched_lines_total if packed else expected_offset
            ) * LN
            timings["epoch_drains"] = epoch_drains
            # host time blocked on per-group counts syncs: device compute
            # hides under it at depth 1, but the tail of each wait past
            # group completion is dispatch-gap idle
            timings["sync_wait_s"] = sync_wait
            timings["setup_s"] = t_setup
            timings["drain"] = (
                "legacy" if not packed
                else ("packed+wog" if wog_full else "packed")
            )

        if checkpoint_path and os.path.exists(checkpoint_path):
            os.unlink(checkpoint_path)  # run completed; stale resume data

        t_asm0 = time.perf_counter()
        cat = lambda xs, dt: np.concatenate(xs) if xs else np.empty(0, dt)
        f_i, f_j = cat(all_i, np.int64), cat(all_j, np.int64)
        f_m, f_w = cat(all_mi, np.float64), cat(all_wog, np.float64)
        if self.statics.wog_lazy and not packed and f_m.size:
            # checkpointed lazy run: stored/persisted wog values are mi
            # placeholders (incl. edges loaded from a resume snapshot);
            # resolve outlier candidates over the FULL edge set now that
            # the final colmax — hence the Tukey fence — is known
            from spydrpick_jax.engine.outliers import outlier_thresholds

            thr_out, _ = outlier_thresholds(colmax)
            cand = f_m >= thr_out
            if cand.any():
                f_w = f_w.copy()
                f_w[cand] = self.pair_wog(f_i[cand], f_j[cand])
        if timings is not None:
            timings["assemble_s"] = time.perf_counter() - t_asm0
        return EdgeSet(ipos=f_i, jpos=f_j, mi=f_m, mi_wog=f_w,
                       colmax=colmax)

    def _fetch_stores(self, mi_s, wog_s, ip_s, jp_s, offset, colmax_d):
        """Bulk host fetch of the device edge stores (lines [:offset]) +
        colmax.

        Both compaction paths emit dense entries, but sub-line tails and
        overflowed / poisoned rows hold zero padding; real edges always
        satisfy jpos > ipos while padding is (0, 0), so that inequality
        filters padding exactly.  In lazy-wog mode the wog store was
        never computed (all zeros): the returned wog is an mi
        placeholder, resolved for outlier candidates at the end of the
        sweep (the only wog values the output surface reads)."""
        off = int(offset)  # lines
        L = self.L
        s_i = np.asarray(ip_s[:off]).reshape(-1).astype(np.int64)
        s_j = np.asarray(jp_s[:off]).reshape(-1).astype(np.int64)
        s_m = np.asarray(mi_s[:off]).reshape(-1).astype(np.float64)
        keep = s_j > s_i
        if self.statics.wog_lazy:
            s_w = s_m[keep].copy()
            return (s_i[keep], s_j[keep], s_m[keep], s_w,
                    np.asarray(colmax_d[:L], dtype=np.float64))
        s_w = np.asarray(wog_s[:off]).reshape(-1).astype(np.float64)
        return (s_i[keep], s_j[keep], s_m[keep], s_w[keep],
                np.asarray(colmax_d[:L], dtype=np.float64))

    def _collect_packed(self, pending, off: int, wog_full: bool):
        """Assemble host edge arrays from the packed chunk fetches
        (fetch_chunk_core): broadcast the per-line ipos back to edges,
        widen uint16 jpos, drop zero-padding holes via jpos > ipos.

        Single vectorised pass over the whole epoch (per-chunk slicing
        only waits on the async copies) — runs on the assembly worker
        thread, off the dispatch loop.  Returns (ipos, jpos, mi,
        wog-or-None)."""
        LN = self.statics.store_lanes
        CH = self._chunk_lines
        mi_p, ip_p, jp_p, wog_p = [], [], [], []
        for c0, out in pending:
            valid = min(off - c0, CH)
            if valid <= 0:
                break
            mi_p.append(np.asarray(out[0])[:valid])
            ip_p.append(np.asarray(out[1])[:valid])
            jp_p.append(np.asarray(out[2])[:valid])
            if wog_full:
                wog_p.append(np.asarray(out[3])[:valid])
        if not mi_p:
            e = np.empty(0)
            return (e.astype(np.int64), e.astype(np.int64), e,
                    e if wog_full else None)
        ip_a = np.concatenate(ip_p)
        if ip_a.ndim == 1:  # route: one i-row per line, broadcast
            ipb = np.repeat(ip_a.astype(np.int64), LN)
        else:               # xla windows mix i-rows per line
            ipb = ip_a.reshape(-1).astype(np.int64)
        jpb = np.concatenate(jp_p).reshape(-1).astype(np.int64)
        keep = jpb > ipb
        mi = np.concatenate(mi_p).reshape(-1)[keep].astype(np.float64)
        wog = (np.concatenate(wog_p).reshape(-1)[keep].astype(np.float64)
               if wog_full else None)
        return ipb[keep], jpb[keep], mi, wog

    def _resolve_deferred_wog(self, s_m, s_i, s_j, colmax):
        """Deferred wog resolution (lazy mode — the sweep never computed
        wog): compute the outlier threshold from the final colmax
        (exactly as the pipeline will, engine/outliers.py) and fill
        exact wog values via the pairs kernel for candidate edges only;
        everything below the threshold keeps wog = mi (the output
        surface never reads it, SpydrPick.hpp:100-124)."""
        from spydrpick_jax.engine.outliers import outlier_thresholds

        s_w = s_m.copy()
        if s_m.size == 0:
            return s_w
        thr_out, _ = outlier_thresholds(colmax)
        cand = s_m >= thr_out
        if cand.any():
            s_w[cand] = self.pair_wog(s_i[cand], s_j[cand])
        return s_w

    def pair_wog(self, ipos: np.ndarray, jpos: np.ndarray,
                 chunk: int = 8192) -> np.ndarray:
        """Effective wo-gaps MI for explicit pairs (lazy-wog resolver),
        chunked to a single static shape; dispatches pipeline like
        :meth:`pair_mi`."""
        return self._pairs_chunked(self._pairs_dual, lambda r: r[1],
                                   ipos, jpos, chunk)
