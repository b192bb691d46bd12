"""On-device edge compaction: (T, W) MI buffers + store mask -> a
dense, fixed-capacity K window of edges for the device-resident store.

Two exact paths with one contract (engine/solver.py:row_sweep_core
picks one through ``SweepStatics.compaction``):

* :func:`compact_edges_scatter` — flat cumsum + one index scatter, then
  payload gathers.
* :func:`compact_edges_route` — roll-routing, which never gathers or
  scatters at element granularity:

  1. *Monotone bit-serial routing* compacts every i-row of the (T, Lp)
     buffer to a dense prefix using only static lane rolls + selects:
     each surviving element must move left by ``shift = lane - rank``
     (its count of dropped predecessors), which is non-decreasing along
     the row, so routing one bit of ``shift`` at a time (round b moves
     elements with bit b set left by 2^b) keeps all in-flight elements
     at distinct positions — for masked l < l':
     ``p_b[l'] - p_b[l] >= #masked[l, l') >= 1`` at every round.
     15 rounds of roll+select replace the scatter entirely, and the
     payload values are routed verbatim (bit-exact).
  2. *Line-granular assembly*: each i-row's dense prefix occupies
     ``ceil(count_i / LN)`` 128-lane lines; a row-gather at line
     granularity (slices of 128 contiguous lanes) packs them into the
     (K/LN, LN) store-format window.  Sub-line tails are zeroed and
     carry ``jpos = 0``, which the standard ``jpos > ipos`` fetch
     filter drops.

Role in the reference: the lock-protected dynamic ``Graph::add`` of
the hot loop (include/mi.hpp:411-463).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def route_rows(mask: jnp.ndarray, payloads: tuple[jnp.ndarray, ...]):
    """Compact each row of ``mask`` (R, N) to a dense prefix.

    Returns (routed_payloads, counts): routed payload rows hold, in
    lanes [0, counts[r]), the payload values of the masked lanes in
    order; lanes beyond that hold stale garbage (callers mask them).
    Payloads must be f32 (values are moved verbatim; integer payloads
    are exact below 2^24).
    """
    R, N = mask.shape
    bits = int(N - 1).bit_length()
    lane = jax.lax.broadcasted_iota(jnp.int32, (R, N), 1)
    # exclusive count of dropped predecessors == left-shift distance
    drop = (~mask).astype(jnp.int32)
    shift = jnp.cumsum(drop, axis=1) - drop
    rs = jnp.where(mask, shift, 0)  # 0 == settled/dead (never moves)

    ps = list(payloads)
    for b in range(bits):
        sh = 1 << b
        src_rs = jnp.roll(rs, -sh, axis=1)
        # wrap guard: lanes reading circularly past the row end must not
        # accept (a wrapped copy would be a live duplicate)
        take = ((src_rs >> b) & 1 == 1) & (lane + sh < N)
        moved = (rs >> b) & 1 == 1
        rs = jnp.where(take, src_rs - sh, jnp.where(moved, 0, rs))
        ps = [jnp.where(take, jnp.roll(p, -sh, axis=1), p) for p in ps]
    counts = mask.sum(axis=1, dtype=jnp.int32)
    return tuple(ps), counts


def compact_edges_route(mi_buf, wog_buf, store_mask, i0, K: int, LN: int = 128,
                        j_offset: int = 0):
    """(T, W) buffers + store mask -> store-format dense K window.

    ``wog_buf`` may be None (lazy-wog mode): the wog output is then all
    zeros and only two payloads are routed.

    ``j_offset`` is the global column index of buffer column 0 —
    callers may pass a right-aligned slice of the full row (block-row
    i0 only stores j > i0, so the left half of late rows is dead weight
    for the O(W log W) routing) or a j-chunk window of a row too wide
    to buffer whole.  It may be a TRACED scalar (added to the routed
    local indices post-gather), so one compiled program serves every
    window position; ``i0`` may be traced likewise.

    Returns (vals, wogs, ipos, jpos, count, lines):
      * the (K,) outputs are ``lines`` 128-lane lines of line-packed
        edges (per i-row: ``ceil(count_i/LN)`` lines, zero-padded
        sub-line tails with jpos = 0 < ipos for the fetch filter);
      * ``count`` is the true edge count (poisoned to 2^30 when the
        line-packed extent exceeds the K window so the caller's
        overflow path re-extracts the row);
      * ``lines`` is the number of valid store lines ( <= K/LN ).
    """
    T, Lp = mi_buf.shape
    assert K % LN == 0
    if Lp % LN:  # tiny-config path (tests); production Lp is 128-aligned
        pad = LN - Lp % LN
        padc = [(0, 0), (0, pad)]
        mi_buf = jnp.pad(mi_buf, padc)
        if wog_buf is not None:
            wog_buf = jnp.pad(wog_buf, padc)
        store_mask = jnp.pad(store_mask, padc)
        Lp += pad
    KL = K // LN
    row_lines = Lp // LN

    wd = mi_buf.dtype  # f32, or f64 in x64 oracle-test mode
    jidx = jax.lax.broadcasted_iota(wd, (T, Lp), 1)  # buffer-local
    if wog_buf is None:
        (r_mi, r_j), counts = route_rows(store_mask, (mi_buf, jidx))
        r_wog = None
    else:
        (r_mi, r_wog, r_j), counts = route_rows(
            store_mask, (mi_buf, wog_buf.astype(wd), jidx)
        )

    # line bookkeeping: i-row r contributes lines_r = ceil(counts_r/LN)
    lines_r = -(-counts // LN)
    cum = jnp.cumsum(lines_r)                      # inclusive
    starts = cum - lines_r                         # exclusive
    total_lines = cum[-1]
    count = counts.sum()

    # output line o -> source row r(o), line-within-row w(o)
    o = jnp.arange(KL, dtype=jnp.int32)
    r = jnp.searchsorted(cum, o, side="right").astype(jnp.int32)
    r = jnp.minimum(r, T - 1)
    w = o - starts[r]
    src_line = r * row_lines + w
    live = o < total_lines

    def gather_lines(x):
        g = jnp.take(x.reshape(T * row_lines, LN),
                     jnp.where(live, src_line, 0), axis=0)
        return g  # (KL, LN)

    g_mi = gather_lines(r_mi)
    g_j = gather_lines(r_j)

    # mask: entry e of line o is valid iff w*LN + lane < counts[r]
    lane = jnp.arange(LN, dtype=jnp.int32)[None, :]
    valid = live[:, None] & ((w[:, None] * LN + lane) < counts[r][:, None])
    vals = jnp.where(valid, g_mi, 0.0).reshape(-1)
    if r_wog is None:
        wogs = jnp.zeros_like(vals)
    else:
        wogs = jnp.where(valid, gather_lines(r_wog), 0.0).reshape(-1)
    joff = jnp.asarray(j_offset, jnp.int32)
    jpos = jnp.where(valid, g_j.astype(jnp.int32) + joff, 0).reshape(-1)
    ipos = jnp.where(valid, i0 + r[:, None], 0).reshape(-1)

    overflow = total_lines > KL
    count = jnp.where(overflow, jnp.int32(1 << 30), count)
    lines = jnp.minimum(total_lines, KL)
    return vals, wogs, ipos, jpos, count, lines


def compact_edges_scatter(mi_buf, wog_buf, store_mask, i0, K: int,
                          LN: int = 128, j_offset=0):
    """Cumsum + scatter twin of :func:`compact_edges_route` (same
    arguments and outputs).  The K window holds the first K surviving
    entries in row-major order, so store lines mix i-rows; dead slots
    carry (ipos, jpos) = (0, 0), dropped by the jpos > ipos fetch
    filter.  ``count`` is the true count (callers detect count > K)."""
    T, W = mi_buf.shape
    flat_mask = store_mask.reshape(-1)
    pos = jnp.cumsum(flat_mask.astype(jnp.int32))
    count = pos[-1]
    dest = jnp.where(flat_mask, pos - 1, K)  # index K == dropped
    # one scatter for the flat indices, then gathers for the payloads
    # (instead of one full-size scatter per payload)
    idxs = (
        jnp.zeros(K, jnp.int32)
        .at[dest]
        .set(jnp.arange(T * W, dtype=jnp.int32), mode="drop")
    )
    vals = jnp.take(mi_buf.reshape(-1), idxs)
    wogs = (jnp.zeros_like(vals) if wog_buf is None
            else jnp.take(wog_buf.reshape(-1), idxs))
    slot_live = jnp.arange(K, dtype=jnp.int32) < count
    ipos = jnp.where(slot_live, i0 + idxs // W, 0).astype(jnp.int32)
    jpos = jnp.where(slot_live, jnp.asarray(j_offset, jnp.int32) + idxs % W,
                     0).astype(jnp.int32)
    lines = (jnp.minimum(count, K) + LN - 1) // LN
    return vals, wogs, ipos, jpos, count, lines
