"""Multi-device sharding of the MI tile sweep.

The reference's only parallelism is shared-memory TBB: thread-private
edge graphs merged by ``join`` (mi.hpp:336-361) under a
tbb::parallel_reduce over block-rows (SpydrPick.hpp:143).  This
rebuild turns that into real SPMD (SURVEY §2 parallelism inventory):

  * a 1-D ``Mesh`` over axis ``"rows"``;
  * the alignment one-hot / presence tensors are *replicated*;
  * each device sweeps groups of block-rows of the upper-triangular
    tile grid (tile data parallelism — the analogue of thread-private
    ranges), appending edges to its own *device-resident* fixed-capacity
    stores — the same design as the single-chip sweep: per step only a
    replicated (n_dev, G) counts vector reaches the host;
  * per-position colmax is merged with ``jax.lax.pmax`` at drain time
    (the analogue of ``maxvaltracker::join``), and the edge stores are
    merged with an ``all_gather`` of statically-shaped store prefixes
    (the analogue of ``Graph::join``) — a *collective*, so every process
    of a multi-host run can address the result (no host fetches of
    non-addressable shards);
  * block-row costs fall linearly with the row index (upper triangle),
    so rows are scheduled in a balanced interleaving that pairs row r
    with row R-1-r within each device batch.

Multi-host note: with ``jax.distributed.initialize`` the same program
runs over all hosts' devices; the one-hot is replicated once over the
inter-host network and each step's collectives stay small (counts).
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from spydrpick_jax.engine.solver import (
    DeviceData,
    EdgeSet,
    MIEngine,
    SweepStatics,
    effective_row_capacity,
    overflow_edge_mask,
    row_sweep_core,
    rows_group_core,
)

def _smap(**kw):
    """shard_map with the varying-manual-axes checker off: the fori_loop
    carries inside row_sweep_core start unvarying (jnp.full) and become
    device-varying through i0 — semantically fine (each device owns its
    rows), but the checker rejects the mixed carry type."""
    return partial(jax.shard_map, check_vma=False, **kw)


def make_mesh(n_devices: int | None = None, n_samples: int = 1) -> Mesh:
    """1-D row mesh, or a 2-D (rows, samples) mesh when n_samples > 1.

    The samples axis shards the alignment itself (each device holds
    S/n_samples sequences) and per-tile crosstables are psum-merged
    over it — for alignments too large to replicate per device (the
    S=20k x L=1M BASELINE config: one-hot ~20 GB).  The devices are
    joined all to all, so the mesh shape follows the algorithm only."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[: n_devices * n_samples]
    if n_samples == 1:
        return Mesh(np.array(devices), axis_names=("rows",))
    arr = np.array(devices).reshape(-1, n_samples)
    return Mesh(arr, axis_names=("rows", "samples"))


def _mesh_shape(mesh: Mesh) -> tuple[int, int]:
    """(row shards, sample shards) of a 1-D or 2-D sweep mesh."""
    n_rows = mesh.shape["rows"]
    n_samp = mesh.shape.get("samples", 1)
    return n_rows, n_samp


def make_sharded_row_step(mesh: Mesh, st: SweepStatics):
    """Jitted SPMD step: each device sweeps one block-row and returns
    its K-sized edge buffers (simple one-shot API; the production sweep
    uses :func:`make_sharded_group_step`'s device-resident stores)."""
    data_specs = jax.tree.map(lambda _: P(), DeviceData(*[0] * 7))

    @jax.jit
    @_smap(
        mesh=mesh,
        in_specs=(data_specs, P("rows"), P()),
        out_specs=(P("rows"), P(), P("rows"), P("rows"), P("rows"),
                   P("rows"), P("rows")),
    )
    def step(data, row_starts, threshold):
        i0 = row_starts[0]  # one row per device in this batch
        colmax_i, colmax_j, vals, wogs, ipos, jpos, count, _ = row_sweep_core(
            data, st, i0, threshold
        )
        # the analogue of maxvaltracker::join (mi.hpp:256-265):
        colmax_j = jax.lax.pmax(colmax_j, "rows")
        return (
            colmax_i[None],
            colmax_j,
            vals[None],
            wogs[None],
            ipos[None],
            jpos[None],
            count[None],
        )

    return step


def make_sharded_group_step(mesh: Mesh, st: SweepStatics,
                            windowed: bool = False):
    """Jitted SPMD step over groups of block-rows with device-resident
    edge stores (the multi-chip twin of ``MIEngine._rows_group``).

    Per device: sweep its (G,) row_starts (−1 = padding), appending
    edges to its own (cap,) stores.  Only the all-gathered (n_dev, G)
    counts and (n_dev,) offsets — a few hundred bytes — are replicated
    for the host; stores stay on device until :func:`make_drain`.
    Stores and carries are donated, so they update in place.

    ``windowed`` (st.row_window > 0): work items are (block-row,
    j-window) pairs — the step takes an extra (G,) chunk_starts
    operand (see solver.row_sweep_core's ``jc0``).
    """
    n_rows_sh, n_samp = _mesh_shape(mesh)
    if n_samp > 1:
        # sample-sharded mode: S in the step's statics is the LOCAL
        # shard size; every per-tile crosstable psums over "samples"
        # (solver.tile_crosstab), so all sample-ranks hold identical MI
        # and their stores stay replicated.
        import dataclasses as _dc

        assert st.S % n_samp == 0, (st.S, n_samp)
        st = _dc.replace(st, S=st.S // n_samp, psum_axis="samples")
        data_specs = DeviceData(
            onehot=P("samples", None), weights=P("samples"),
            presence=P(), presence_wog=P(), gap=P(), orig_pos=P(),
            codes=P("samples", None),
        )
    else:
        data_specs = jax.tree.map(lambda _: P(), DeviceData(*[0] * 7))
    sh = P("rows")

    if windowed:
        @partial(jax.jit, donate_argnums=(4, 5, 6, 7, 8, 9, 10))
        @_smap(
            mesh=mesh,
            in_specs=(data_specs, sh, sh, P(), sh, sh, sh, sh, sh, sh, sh),
            out_specs=(sh, sh, sh, sh, sh, sh, sh, P(), P(), P()),
        )
        def step(data, row_starts, chunk_starts, thr, colmax, mi_s, wog_s,
                 ip_s, jp_s, offset, total):
            (colmax1, mi_s1, wog_s1, ip_s1, jp_s1, offset1, total1, counts,
             lines) = rows_group_core(
                data, st, row_starts[0], thr, colmax[0], mi_s[0], wog_s[0],
                ip_s[0], jp_s[0], offset[0], total[0],
                chunk_starts=chunk_starts[0],
            )
            counts_all = jax.lax.all_gather(counts, "rows")
            lines_all = jax.lax.all_gather(lines, "rows")
            offs_all = jax.lax.all_gather(offset1, "rows")
            return (colmax1[None], mi_s1[None], wog_s1[None], ip_s1[None],
                    jp_s1[None], offset1[None], total1[None],
                    counts_all, lines_all, offs_all)

        return step

    @partial(jax.jit, donate_argnums=(3, 4, 5, 6, 7, 8, 9))
    @_smap(
        mesh=mesh,
        in_specs=(data_specs, sh, P(), sh, sh, sh, sh, sh, sh, sh),
        out_specs=(sh, sh, sh, sh, sh, sh, sh, P(), P(), P()),
    )
    def step(data, row_starts, thr, colmax, mi_s, wog_s, ip_s, jp_s,
             offset, total):
        (colmax1, mi_s1, wog_s1, ip_s1, jp_s1, offset1, total1, counts,
         lines) = rows_group_core(
            data, st, row_starts[0], thr, colmax[0], mi_s[0], wog_s[0],
            ip_s[0], jp_s[0], offset[0], total[0],
        )
        counts_all = jax.lax.all_gather(counts, "rows")    # (n_rows, G)
        lines_all = jax.lax.all_gather(lines, "rows")      # (n_rows, G)
        offs_all = jax.lax.all_gather(offset1, "rows")     # (n_rows,)
        return (colmax1[None], mi_s1[None], wog_s1[None], ip_s1[None],
                jp_s1[None], offset1[None], total1[None],
                counts_all, lines_all, offs_all)

    return step


def make_drain(mesh: Mesh, st: SweepStatics, m: int):
    """Collective drain: all-gather the first ``m`` store LINES of every
    device's (lines, LN) stores (static shape) + pmax-merged colmax,
    all outputs replicated — addressable on every process of a
    multi-host run (the analogue of ``Graph::join``, mi.hpp:336-361).

    In lazy-wog mode the wog store is never computed, so its gather is
    skipped (25% less collective payload); the driver resolves wog for
    outlier candidates post-hoc."""
    sh = P("rows")
    n_out = 4 if st.wog_lazy else 5

    @jax.jit
    @_smap(
        mesh=mesh,
        in_specs=(sh, sh, sh, sh, sh),
        out_specs=tuple([P()] * n_out),
    )
    def drain(mi_s, wog_s, ip_s, jp_s, colmax):
        cm = jax.lax.pmax(colmax[0], "rows")
        g = lambda x: jax.lax.all_gather(x[0, :m], "rows")  # (n_dev, m, LN)
        if st.wog_lazy:
            return g(mi_s), g(ip_s), g(jp_s), cm
        return g(mi_s), g(wog_s), g(ip_s), g(jp_s), cm

    return drain


def shard_sample_data(engine: MIEngine, mesh: Mesh):
    """Commit the engine's alignment tensors to a 2-D (rows, samples)
    mesh: the sample axis is padded to the shard count (zero weights /
    pad codes contribute nothing to the crosstables) and the one-hot /
    weights are sharded over ``"samples"`` — the alignment itself never
    needs to fit one device.  Returns (data, statics-with-padded-S)."""
    import dataclasses as _dc

    st = engine.statics
    _, n_samp = _mesh_shape(mesh)
    data = engine.data
    S_pad = -(-st.S // n_samp) * n_samp
    if S_pad != st.S:
        pad = S_pad - st.S
        oh_pad = (
            np.full((pad, data.onehot.shape[1]), 255, np.uint8)
            if st.onehot_codes
            else np.zeros((pad, data.onehot.shape[1]),
                          np.asarray(data.onehot).dtype)
        )
        data = data._replace(
            onehot=jnp.concatenate(
                [data.onehot, jnp.asarray(oh_pad)], axis=0),
            weights=jnp.concatenate(
                [data.weights,
                 jnp.zeros(pad, data.weights.dtype)], axis=0),
            codes=jnp.concatenate(
                [data.codes,
                 jnp.full((pad, data.codes.shape[1]), 255, jnp.uint8)],
                axis=0) if not st.onehot_codes else data.codes,
        )
        st = _dc.replace(st, S=S_pad)
    shd = lambda x, spec: jax.device_put(
        np.asarray(x), jax.sharding.NamedSharding(mesh, spec))
    onehot_sh = shd(data.onehot, P("samples", None))
    data = DeviceData(
        onehot=onehot_sh,
        weights=shd(data.weights, P("samples")),
        presence=shd(data.presence, P()),
        presence_wog=shd(data.presence_wog, P()),
        gap=shd(data.gap, P()),
        orig_pos=shd(data.orig_pos, P()),
        # codes mode: the codes matrix IS the (padded, sharded) onehot
        codes=(onehot_sh if st.onehot_codes
               else shd(data.codes, P("samples", None))),
    )
    return data, st


class ShardedEngineView:
    """Mesh-backed twins of the single-device engine's auxiliary
    evaluators for 2-D (sample-sharded) meshes: pair MI (threshold
    tournament), pair wog (lazy-wog resolution), and full-row buffers
    (overflow re-extraction).  Each is a shard_map program whose
    crosstables psum over ``"samples"`` — at scales where the alignment
    cannot fit one device, these paths previously fell back to the
    unsharded engine and would OOM (the round-2 caveat).

    Duck-compatible with ``MIEngine`` where the tournament needs it
    (``.L``, ``.pair_mi``) so ``determine_mi_threshold`` accepts it
    directly."""

    def __init__(self, engine: MIEngine, mesh: Mesh):
        import dataclasses as _dc

        from spydrpick_jax.engine.solver import (
            pairs_mi_core,
            pairs_mi_dual_core,
            row_full_core,
        )

        self.engine = engine
        self.mesh = mesh
        _, n_samp = _mesh_shape(mesh)
        assert n_samp > 1, "use the engine directly on 1-D meshes"
        self.data, self.st = shard_sample_data(engine, mesh)
        self.L = engine.L
        # local statics: S is the per-shard sample count; crosstables
        # psum over the samples axis (solver.tile_crosstab / pairs_mi_*;
        # shard_sample_data already padded S to the shard count)
        st_loc = _dc.replace(
            self.st, S=self.st.S // n_samp, psum_axis="samples",
        )
        self._st_loc = st_loc
        data_specs = DeviceData(
            onehot=P("samples", None), weights=P("samples"),
            presence=P(), presence_wog=P(), gap=P(), orig_pos=P(),
            codes=P("samples", None),
        )

        def _wrap(core):
            @jax.jit
            @_smap(mesh=mesh, in_specs=(data_specs, P(), P()),
                   out_specs=P())
            def f(data, ipos, jpos):
                return core(data, st_loc, ipos, jpos)

            return f

        self._pairs_mi = _wrap(pairs_mi_core)
        self._pairs_dual = _wrap(pairs_mi_dual_core)
        self._row_full_fns: dict[bool, object] = {}
        self._quant_fns: dict[tuple, object] = {}
        self._row_full_core = row_full_core
        self._data_specs = data_specs

    def _chunked(self, fn, pick, ipos, jpos, chunk=8192):
        """Chunk explicit pairs to one static shape; pipeline dispatches
        before reads (same design as MIEngine.pair_mi)."""
        P_ = len(ipos)
        out = np.empty(P_, dtype=np.float64)
        results = []
        for c0 in range(0, P_, chunk):
            ii = np.asarray(ipos[c0: c0 + chunk], dtype=np.int32)
            jj = np.asarray(jpos[c0: c0 + chunk], dtype=np.int32)
            n = len(ii)
            if n < chunk:
                ii = np.pad(ii, (0, chunk - n))
                jj = np.pad(jj, (0, chunk - n))
            res = pick(fn(self.data, jnp.asarray(ii), jnp.asarray(jj)))
            res.copy_to_host_async()
            results.append((c0, n, res))
        for c0, n, res in results:
            out[c0: c0 + n] = np.asarray(res)[:n]
        return out

    def pair_mi(self, ipos, jpos, chunk: int = 8192) -> np.ndarray:
        return self._chunked(self._pairs_mi, lambda r: r, ipos, jpos, chunk)

    def pair_quantiles(self, ipos, jpos, iters: int, n_valid: int, k: int,
                       chunk: int = 8192) -> np.ndarray:
        """One-dispatch tournament on the 2-D mesh (psum crosstables) —
        same contract as MIEngine.pair_quantiles: (iters,) order
        statistics, the only down-traffic."""
        from spydrpick_jax.engine.solver import (
            pack_tournament_indices,
            pairs_quantile_core,
        )

        ip3, jp3, nc, dt = pack_tournament_indices(
            ipos, jpos, iters, n_valid, chunk, self.st.Lp)
        key = ("quant", iters, nc, chunk, dt)
        f = self._quant_fns.get(key)
        if f is None:
            st_loc = self._st_loc
            mesh, data_specs = self.mesh, self._data_specs

            @jax.jit
            @_smap(mesh=mesh,
                   in_specs=(data_specs, P(), P(), P(), P()),
                   out_specs=P())
            def f(data, ip3, jp3, n_valid, kk):
                return pairs_quantile_core(data, st_loc, ip3, jp3,
                                           n_valid, kk)

            self._quant_fns[key] = f
        out = f(self.data, jnp.asarray(ip3), jnp.asarray(jp3),
                jnp.asarray(n_valid, jnp.int32),
                jnp.asarray(k, jnp.int32))
        return np.asarray(out, dtype=np.float64)

    def pair_wog(self, ipos, jpos, chunk: int = 8192) -> np.ndarray:
        return self._chunked(self._pairs_dual, lambda r: r[1], ipos, jpos,
                             chunk)

    def row_full(self, i0: int, jc0: int | None = None):
        """Replicated (T, W) dual MI/wog buffers + masks for one
        block-row (or one j-window of it) — the sharded overflow
        re-extraction path."""
        windowed = jc0 is not None
        if windowed not in self._row_full_fns:
            core, st_loc = self._row_full_core, self._st_loc
            mesh, data_specs = self.mesh, self._data_specs
            if windowed:
                @jax.jit
                @_smap(mesh=mesh, in_specs=(data_specs, P(), P()),
                       out_specs=(P(), P(), P(), P()))
                def f(data, i0, jc0):
                    return core(data, st_loc, i0, jc0=jc0)
            else:
                @jax.jit
                @_smap(mesh=mesh, in_specs=(data_specs, P()),
                       out_specs=(P(), P(), P(), P()))
                def f(data, i0):
                    return core(data, st_loc, i0)
            self._row_full_fns[windowed] = f
        f = self._row_full_fns[windowed]
        args = (jnp.asarray(i0, jnp.int32),)
        if windowed:
            args += (jnp.asarray(jc0, jnp.int32),)
        return f(self.data, *args)


def balanced_row_order(n_rows: int) -> list[int]:
    """Interleave cheap and expensive rows: [0, R-1, 1, R-2, ...]."""
    order = []
    lo, hi = 0, n_rows - 1
    while lo <= hi:
        order.append(lo)
        if hi != lo:
            order.append(hi)
        lo += 1
        hi -= 1
    return order


_DRAIN_GRAIN = 1 << 9  # lines; rounds gather sizes up: bounds drain recompiles


def sharded_sweep(
    engine: MIEngine,
    threshold: float,
    mesh: Mesh | None = None,
    progress=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 16,
    timings: dict | None = None,
    view: "ShardedEngineView | None" = None,
) -> EdgeSet:
    """Multi-device all-pairs sweep; results identical to
    ``MIEngine.sweep`` (shard-count invariance is tested — the analogue
    of the reference's thread-count invariance, SURVEY §4).

    Device-resident stores + collective drain: per step only the
    replicated counts cross to the host; the edge payload is gathered
    once at the end (and at checkpoints).  Safe for multi-process runs —
    no host access to non-addressable shards.

    On 2-D sample-sharded meshes the per-row overflow re-extraction and
    the lazy-wog resolution run through :class:`ShardedEngineView` (psum
    over the samples axis), so no path needs the full alignment on one
    device; pass a prebuilt ``view`` to reuse its sharded tensors (the
    pipeline builds one for the threshold tournament).
    """
    from spydrpick_jax.engine import checkpoint as ckpt_mod

    mesh = mesh or make_mesh()
    st = engine.statics
    lazy = st.wog_lazy  # mi-only tiles; wog resolved post-hoc for
    # outlier candidates via the pairs kernel (replicated, so identical
    # on every process) — the single-chip production drain's design
    n_dev, n_samp = _mesh_shape(mesh)

    data = engine.data
    if n_samp > 1:
        if view is None:
            view = ShardedEngineView(engine, mesh)
        data, st = view.data, view.st
    RW = st.row_window
    step = make_sharded_group_step(mesh, st, windowed=bool(RW))

    multiprocess = len({d.process_index for d in mesh.devices.flat}) > 1
    if multiprocess and n_samp == 1:
        # commit the replicated operands to the global mesh: every
        # process holds identical host copies (same alignment), so a
        # fully-replicated device_put is well-defined across hosts
        rep = jax.sharding.NamedSharding(mesh, P())
        data = jax.tree.map(
            lambda x: jax.device_put(np.asarray(x), rep), engine.data
        )

    L, T, K = st.L, st.tile, st.edge_capacity
    K_eff = effective_row_capacity(st)
    LN = st.store_lanes
    KL = K // LN
    G = engine.config.rows_per_dispatch
    # per-device stores must fit one dispatch batch (G per-row windows);
    # the epoch drain below recycles them when a sweep outgrows capacity
    cap_lines = max(
        engine.config.store_capacity // n_dev, 2 * K, G * K
    ) // LN
    bd = jnp.float32 if st.cdtype == jnp.float32 else st.cdtype
    thr = jnp.asarray(threshold, bd)

    colmax_host = np.full(L, -np.inf)
    all_i, all_j, all_mi, all_wog = [], [], [], []
    done_rows: set[int] = set()
    ck_key = ckpt_mod.params_key(st, threshold)
    if checkpoint_path:
        ck = ckpt_mod.load(checkpoint_path, ck_key)
        if ck is not None:
            colmax_host = ck.colmax
            all_i, all_j, all_mi, all_wog = ck.ipos, ck.jpos, ck.mi, ck.mi_wog
            done_rows = ck.done_rows

    n_rows = -(-L // T)
    row_order = [r * T for r in balanced_row_order(n_rows)
                 if r * T not in done_rows]
    # windowed mode: the unit of work is a (block-row, j-window) item;
    # the balanced row interleaving already mixes cheap/expensive rows,
    # and each row expands to its live windows in order
    row_pending: dict[int, int] = {}
    order: list[tuple[int, int | None]] = []
    for r in row_order:
        if RW:
            wins = list(range((r // RW) * RW, st.Lp, RW))
            row_pending[r] = len(wins)
            order.extend((r, jc0) for jc0 in wins)
        else:
            order.append((r, None))
    # pad to a multiple of n_dev*G with skip markers
    per_step = n_dev * G
    while len(order) % per_step:
        order.append((-1, 0))

    def shard_init(shape, dtype, fill=0):
        arr = np.full(shape, fill, dtype)
        return jax.device_put(
            arr, jax.sharding.NamedSharding(mesh, P("rows"))
        )

    colmax_d = shard_init((n_dev, st.Lp), np.dtype(bd), -np.inf)
    mi_s = shard_init((n_dev, cap_lines, LN), np.dtype(bd))
    # lazy mode never writes nor drains the wog store (rows_group_core
    # elides the append; make_drain skips the gather) — 1-line dummy
    wog_s = shard_init((n_dev, 1 if lazy else cap_lines, LN), np.dtype(bd))
    ip_s = shard_init((n_dev, cap_lines, LN), np.int32)
    jp_s = shard_init((n_dev, cap_lines, LN), np.int32)
    offset = shard_init((n_dev,), np.int32)  # in lines
    total = shard_init((n_dev,), np.int32)

    row_spec = jax.sharding.NamedSharding(mesh, P("rows"))

    drains: dict[int, object] = {}

    def drain_enqueue(mi_s, wog_s, ip_s, jp_s, colmax_d, offs):
        """Dispatch the collective gather of valid store line-prefixes
        (replicated outputs; ``offs`` is per-device line counts) and
        start its host copies — materialisation is deferred, so epoch
        drains do not stall the dispatch loop (the single-chip packed
        drain's design).  Returns (device result tree, offs copy)."""
        m = max(int(offs.max()), 1)
        m = min(-(-m // _DRAIN_GRAIN) * _DRAIN_GRAIN, cap_lines)
        if m not in drains:
            drains[m] = make_drain(mesh, st, m)
        res = drains[m](mi_s, wog_s, ip_s, jp_s, colmax_d)
        for leaf in jax.tree.leaves(res):
            leaf.copy_to_host_async()
        return res, np.array(offs)

    def drain_collect(res, offs):
        """Materialise one enqueued drain into host edge arrays.
        In lazy mode the returned wog is a COPY of mi (the post-hoc
        candidate resolver overwrites outlier rows at the end)."""
        if lazy:
            g_mi, g_ip, g_jp, cm = jax.tree.map(np.asarray, res)
            g_wog = None
        else:
            g_mi, g_wog, g_ip, g_jp, cm = jax.tree.map(np.asarray, res)
        outs = ([], [], [], [])
        for d in range(n_dev):
            n = int(offs[d])
            ii = g_ip[d, :n].reshape(-1)
            jj = g_jp[d, :n].reshape(-1)
            keep = jj > ii  # drop zero-padding holes
            outs[0].append(ii[keep].astype(np.int64))
            outs[1].append(jj[keep].astype(np.int64))
            outs[2].append(g_mi[d, :n].reshape(-1)[keep].astype(np.float64))
            outs[3].append(
                (g_mi if g_wog is None else g_wog)[d, :n]
                .reshape(-1)[keep].astype(np.float64)
            )
        cat = lambda xs: np.concatenate(xs) if xs else np.empty(0)
        return tuple(cat(x) for x in outs) + (cm[:L].astype(np.float64),)

    def drain_now(mi_s, wog_s, ip_s, jp_s, colmax_d, offs):
        return drain_collect(*drain_enqueue(
            mi_s, wog_s, ip_s, jp_s, colmax_d, offs))

    overflow_items: list[tuple[int, int | None]] = []  # (i0, jc0)
    expected_off = np.zeros(n_dev, np.int64)
    offs_np = np.zeros(n_dev, np.int32)
    fetched_lines_total = 0
    # epoch-drained pieces.  Uncheckpointed runs defer materialisation:
    # the collective gather is dispatched and its host copies started,
    # but the numpy assembly waits until the end of the sweep (the
    # dispatch loop never stalls on a drain — the single-chip packed
    # drain's design).  Checkpointed runs materialise synchronously
    # (snapshots need the values).  Overflow filtering happens on the
    # combined arrays with the FINAL overflow list — a row's overflow
    # is detected in its own batch, before any later drain, so the
    # final list covers every drained piece.
    packed = checkpoint_path is None
    # packed epochs materialise on ONE worker thread (the single-chip
    # sweep's assembler pattern): the collective gather is dispatched on
    # the dispatch loop, but its numpy assembly — and therefore the
    # release of the replicated (n_dev, m, LN) device buffers — happens
    # off-loop as soon as the async host copies land.  Keeping the raw
    # device trees until the end of the sweep would hold EVERY epoch's
    # gather in HBM simultaneously, defeating the epoch-recycling
    # design on large-edge runs.
    from concurrent.futures import ThreadPoolExecutor

    assembler = ThreadPoolExecutor(1)
    ep_futs: list = []  # deferred materialisation futures (packed runs)
    ep_i: list = []     # materialised pieces (checkpointed runs)
    ep_j: list = []
    ep_m: list = []
    ep_w: list = []

    def drain_filtered(mi_s, wog_s, ip_s, jp_s, colmax_d, offs):
        s_i, s_j, s_m, s_w, s_c = drain_now(
            mi_s, wog_s, ip_s, jp_s, colmax_d, offs
        )
        if overflow_items:
            bad = overflow_edge_mask(s_i, s_j, overflow_items, T, RW)
            s_i, s_j = s_i[~bad], s_j[~bad]
            s_m, s_w = s_m[~bad], s_w[~bad]
        return s_i, s_j, s_m, s_w, s_c

    # exceptions in the dispatch/fetch loop must still release the
    # assembler and its deferred epoch gathers (device references)
    try:
        ck_rows = 0
        t_compute0 = time.perf_counter()
        steps = [order[s0 : s0 + per_step] for s0 in range(0, len(order), per_step)]
        for batch in steps:
            if (expected_off + G * KL > cap_lines).any():
                # recycle the per-device stores: drain everything written so
                # far, then continue appending from line 0 (capacity bounds
                # the drain cadence, not the sweep's total edges)
                if packed:
                    res, offs_c = drain_enqueue(
                        mi_s, wog_s, ip_s, jp_s, colmax_d, offs_np)
                    ep_futs.append(assembler.submit(drain_collect, res, offs_c))
                    del res
                else:
                    s_i, s_j, s_m, s_w, s_c = drain_filtered(
                        mi_s, wog_s, ip_s, jp_s, colmax_d, offs_np
                    )
                    ep_i.append(s_i); ep_j.append(s_j)
                    ep_m.append(s_m); ep_w.append(s_w)
                    colmax_host = np.maximum(colmax_host, s_c)
                fetched_lines_total += int(offs_np.sum())
                offset = shard_init((n_dev,), np.int32)
                expected_off[:] = 0
                offs_np = np.zeros(n_dev, np.int32)
            t0 = time.perf_counter()
            # device d gets batch[d::n_dev]: a cheap/expensive mix from the
            # balanced interleaving
            starts = np.full((n_dev, G), -1, np.int32)
            chunks = np.zeros((n_dev, G), np.int32)
            for d in range(n_dev):
                mine = batch[d::n_dev]
                starts[d, : len(mine)] = [it[0] for it in mine]
                if RW:
                    chunks[d, : len(mine)] = [it[1] for it in mine]
            starts_d = jax.device_put(starts, row_spec)
            if RW:
                chunks_d = jax.device_put(chunks, row_spec)
                (colmax_d, mi_s, wog_s, ip_s, jp_s, offset, total,
                 counts, lines_b, offs) = step(
                    data, starts_d, chunks_d, thr, colmax_d, mi_s, wog_s,
                    ip_s, jp_s, offset, total,
                )
            else:
                (colmax_d, mi_s, wog_s, ip_s, jp_s, offset, total,
                 counts, lines_b, offs) = step(
                    data, starts_d, thr, colmax_d, mi_s, wog_s, ip_s, jp_s,
                    offset, total,
                )
            counts_np = np.asarray(counts)  # replicated: safe on any process
            lines_np = np.asarray(lines_b)
            offs_np = np.asarray(offs)
            for d in range(n_dev):
                for g in range(G):
                    i0 = int(starts[d, g])
                    if i0 < 0:
                        continue
                    jc0 = int(chunks[d, g]) if RW else None
                    if RW:
                        row_pending[i0] -= 1
                        if row_pending[i0] == 0:
                            done_rows.add(i0)
                    else:
                        done_rows.add(i0)
                    n = int(counts_np[d, g])
                    expected_off[d] += min(int(lines_np[d, g]), KL)
                    if n > K_eff:
                        overflow_items.append((i0, jc0))
            if progress is not None:
                live = starts[starts >= 0]
                progress(int(live.min()), int(live.max()) + T,
                         int(counts_np.sum()), time.perf_counter() - t0)
            ck_rows += per_step
            if checkpoint_path and ck_rows >= checkpoint_every and batch is not steps[-1]:
                ck_rows = 0
                s_i, s_j, s_m, s_w, s_c = drain_filtered(
                    mi_s, wog_s, ip_s, jp_s, colmax_d, offs_np
                )
                # persist only COMPLETE, un-overflowed rows (windowed rows
                # may be partially swept at this point — they re-sweep on
                # resume; the already-drained epoch pieces keep their edges
                # for the live run's final assembly)
                save_done = done_rows - {i0 for i0, _ in overflow_items}
                if jax.process_index() == 0:
                    cat = lambda xs, dt: (
                        np.concatenate(xs) if xs else np.empty(0, dt))
                    c_i = cat(all_i + ep_i + [s_i], np.int64)
                    c_j = cat(all_j + ep_j + [s_j], np.int64)
                    c_m = cat(all_mi + ep_m + [s_m], np.float64)
                    c_w = cat(all_wog + ep_w + [s_w], np.float64)
                    keep = np.isin(
                        (c_i // T) * T,
                        np.fromiter(save_done, np.int64, len(save_done)),
                    )
                    ckpt_mod.save(
                        checkpoint_path,
                        ckpt_mod.SweepCheckpoint(
                            ck_key, save_done, np.maximum(colmax_host, s_c),
                            [c_i[keep]], [c_j[keep]],
                            [c_m[keep]], [c_w[keep]],
                        ),
                    )
        t_compute = time.perf_counter() - t_compute0

        t_fetch0 = time.perf_counter()
        if packed:
            # materialise the deferred epoch gathers + the final prefix,
            # then filter ONCE with the complete overflow list
            res, offs_c = drain_enqueue(
                mi_s, wog_s, ip_s, jp_s, colmax_d, offs_np)
            ep_futs.append(assembler.submit(drain_collect, res, offs_c))
            del res
            pieces = [f.result() for f in ep_futs]
            for piece in pieces:
                colmax_host = np.maximum(colmax_host, piece[4])
            cat0 = lambda k, dt: np.concatenate(
                [p[k] for p in pieces]) if pieces else np.empty(0, dt)
            s_i, s_j = cat0(0, np.int64), cat0(1, np.int64)
            s_m, s_w = cat0(2, np.float64), cat0(3, np.float64)
            if overflow_items:
                bad = overflow_edge_mask(s_i, s_j, overflow_items, T, RW)
                s_i, s_j = s_i[~bad], s_j[~bad]
                s_m, s_w = s_m[~bad], s_w[~bad]
            t_fetch = time.perf_counter() - t_fetch0
        else:
            s_i, s_j, s_m, s_w, s_c = drain_filtered(
                mi_s, wog_s, ip_s, jp_s, colmax_d, offs_np
            )
            t_fetch = time.perf_counter() - t_fetch0
            colmax_host = np.maximum(colmax_host, s_c)

            cat0 = lambda xs, dt: np.concatenate(xs) if xs else np.empty(0, dt)
            s_i = cat0(ep_i + [s_i], np.int64)
            s_j = cat0(ep_j + [s_j], np.int64)
            s_m = cat0(ep_m + [s_m], np.float64)
            s_w = cat0(ep_w + [s_w], np.float64)

        assembler.shutdown(wait=True)
    except BaseException:
        assembler.shutdown(wait=False, cancel_futures=True)
        raise

    t_overflow0 = time.perf_counter()
    if overflow_items:
        for i0, jc0 in overflow_items:
            # replicated re-extraction: identical on every process; on
            # 2-D meshes it runs sharded (the alignment may not fit one
            # device)
            if view is not None:
                bufs = view.row_full(i0, jc0)
            elif jc0 is None:
                bufs = engine._row_full(
                    engine.data, i0=jnp.asarray(i0, jnp.int32))
            else:
                bufs = engine._row_full(
                    engine.data, i0=jnp.asarray(i0, jnp.int32),
                    jc0=jnp.asarray(jc0, jnp.int32))
            mi_buf, wog_buf, store_base, _ = jax.tree.map(np.asarray, bufs)
            mask = store_base & (mi_buf > threshold)
            ii, jj = np.nonzero(mask)
            all_i.append(i0 + ii.astype(np.int64))
            all_j.append((0 if jc0 is None else jc0) + jj.astype(np.int64))
            all_mi.append(mi_buf[mask].astype(np.float64))
            all_wog.append(wog_buf[mask].astype(np.float64))
    all_i.append(s_i)
    all_j.append(s_j)
    all_mi.append(s_m)
    all_wog.append(s_w)

    if timings is not None:
        timings["compute_s"] = t_compute
        timings["fetch_s"] = t_fetch
        timings["overflow_s"] = time.perf_counter() - t_overflow0
        timings["overflow_rows"] = len(overflow_items)
        # epoch-drained lines were counted at each recycle (packed
        # epochs live in ep_futs, so summing ep_i alone undercounts)
        timings["fetched_edges"] = (
            fetched_lines_total + int(offs_np.sum())
        ) * LN
        timings["epoch_drains"] = (len(ep_futs) - 1 if packed else len(ep_i))
        # dispatch-step count (scaling model: ceil(items / (n_dev * G)))
        # and the mesh row-shard count, for tests/test_scaling_model.py
        timings["steps"] = len(steps)
        timings["n_dev"] = n_dev

    if checkpoint_path and jax.process_index() == 0:
        import os

        if os.path.exists(checkpoint_path):
            os.unlink(checkpoint_path)  # run completed; stale resume data

    cat = lambda xs, dt: np.concatenate(xs) if xs else np.empty(0, dt)
    f_i, f_j = cat(all_i, np.int64), cat(all_j, np.int64)
    f_m, f_w = cat(all_mi, np.float64), cat(all_wog, np.float64)
    if lazy and f_m.size:
        # lazy drains stored mi placeholders for wog (incl. edges loaded
        # from a resume snapshot); resolve outlier candidates via the
        # pairs kernel now that the final colmax — hence the Tukey
        # fence — is known (replicated: identical on every process)
        from spydrpick_jax.engine.outliers import outlier_thresholds

        thr_out, _ = outlier_thresholds(colmax_host)
        cand = f_m >= thr_out
        if cand.any():
            f_w = f_w.copy()
            resolver = view.pair_wog if view is not None else engine.pair_wog
            f_w[cand] = resolver(f_i[cand], f_j[cand])
    return EdgeSet(ipos=f_i, jpos=f_j, mi=f_m, mi_wog=f_w,
                   colmax=colmax_host)
