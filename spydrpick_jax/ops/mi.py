"""Vectorised mutual-information math on weighted 5x5 crosstables.

Accelerator reformulation of the reference MI kernel
(include/mi.hpp:108-224):

  * the weighted crosstable (apegrunt ``Weighted_crosstable_2Dblock``,
    call site mi.hpp:126) becomes a one-hot matrix product (a GEMM):
    ``C = Xi_w^T @ Xj`` where ``Xi_w`` is the weight-scaled one-hot
    i-tile and ``Xj`` the one-hot j-tile, contracted over samples;
  * the per-pair pseudocount/normalise/entropy stage
    (``normalize_and_get_mi_single``, mi.hpp:146-181) becomes a fully
    vectorised elementwise broadcast over the whole tile of pairs;
  * the gaps-excluded re-evaluation (mi.hpp:466-490) reuses the same
    crosstable with the gap bit cleared from the presence masks —
    here both variants are produced in a single fused pass.

See :mod:`spydrpick_jax.ops.reference` for the float64 oracle and the
exact statement of the semantics (including the full-row-sum quirk of
mi.hpp:173 that we preserve).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from spydrpick_jax.core.alphabet import N_STATES


def _xlogx(x: jnp.ndarray) -> jnp.ndarray:
    """x * ln(x), defined as 0 at x <= 0 (matches apegrunt ``xlogx``)."""
    safe = jnp.where(x > 0, x, 1.0)
    return jnp.where(x > 0, x * jnp.log(safe), 0.0)


def mi_from_crosstabs(
    C: jnp.ndarray,
    ip: jnp.ndarray,
    jp: jnp.ndarray,
    pseudocount: float,
) -> jnp.ndarray:
    """MI for a batch of weighted crosstables.

    C:  (..., 5, 5) raw weighted joint counts, C[..., a, b] for i-state a
        and j-state b.
    ip: (..., 5) i-column state-presence (0/1, broadcastable to C[...]).
    jp: (..., 5) j-column state-presence.

    Returns (...,) MI in nats. Mirrors mi.hpp:146-181 exactly; see
    ops/reference.py for the formula derivation.
    """
    dtype = C.dtype
    ip = ip.astype(dtype)
    jp = jp.astype(dtype)
    pm = ip[..., :, None] * jp[..., None, :]
    A = C + jnp.asarray(pseudocount, dtype) * pm
    Z = jnp.sum(A * pm, axis=(-2, -1), keepdims=True)
    P = A / jnp.maximum(Z, jnp.finfo(dtype).tiny)
    jointH = jnp.sum(_xlogx(P) * pm, axis=(-2, -1))
    # j-marginal: full sum over ALL i-states (mi.hpp:173 sums the whole
    # SIMD row) — matters only in gap-excluded mode.
    amarg = jnp.sum(P, axis=-2)
    icondH = jnp.sum(_xlogx(amarg) * jp, axis=-1)
    # i-marginal: masked sum over present j-states (mi.hpp:174,178).
    bmarg = jnp.sum(P * jp[..., None, :], axis=-1)
    jcondH = jnp.sum(_xlogx(bmarg) * ip, axis=-1)
    return jointH - icondH - jcondH


def crosstab_tile(
    xi_w: jnp.ndarray,
    xj: jnp.ndarray,
    dtype=jnp.float32,
    precision=jax.lax.Precision.HIGHEST,
) -> jnp.ndarray:
    """Weighted crosstables for a (TI, TJ) tile of column pairs.

    xi_w: (S, TI*5) weight-scaled one-hot i-columns.
    xj:   (S, TJ*5) one-hot j-columns.
    Returns (TI, TJ, 5, 5) counts. The contraction over samples is the
    GEMM-shaped hot loop of the whole pipeline.

    ``precision`` must keep the weights near f32: with the one-hot
    stored bf16, DEFAULT precision lets XLA elide the bf16->f32 convert
    and run a bf16 dot, which rounds the *weights* to 8 mantissa bits
    (~3e-3 relative count error — observed, and fatal for MI ranking);
    on a GPU DEFAULT may also mean TF32 (10 mantissa bits).  The 0/1
    operand is exact in any format; only the weighted side needs f32.
    """
    TI5 = xi_w.shape[1]
    TJ5 = xj.shape[1]
    C = jax.lax.dot_general(
        xi_w,
        xj,
        dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=dtype,
        precision=precision,
    )  # (TI*5, TJ*5)
    C = C.reshape(TI5 // N_STATES, N_STATES, TJ5 // N_STATES, N_STATES)
    return C.transpose(0, 2, 1, 3)


def crosstab_tile_flat(
    xi_w: jnp.ndarray,
    xj: jnp.ndarray,
    dtype=jnp.float32,
    precision=jax.lax.Precision.HIGHEST,
) -> jnp.ndarray:
    """(TI*5, TJ*5) crosstable in matmul-native layout (no transpose).

    The (TI, TJ, 5, 5) layout of :func:`crosstab_tile` puts the 5-state
    axis minor, so every elementwise op of the epilogue works on
    5-wide rows after a transpose.  The flat layout is the GEMM's own
    output; use :func:`mi_from_crosstab_flat` on the result.
    """
    return jax.lax.dot_general(
        xi_w,
        xj,
        dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=dtype,
        precision=precision,
    )


# int8 crosstable modes: the weight each int8 pass's int32 product
# carries in the recombined counts (see crosstab_tile_int8)
INT8_PASS_MULTS = {"unit": (1,), "fixed14": (128, 1)}


def crosstab_tile_int8(xi_parts: tuple, xj: jnp.ndarray,
                       mults: tuple) -> jnp.ndarray:
    """(TI*5, TJ*5) int32 crosstable from int8 operands, exact.

    ``xi_parts``: int8 (S, TI*5) i-side operands, one per pass;
    ``mults``: the integer each pass's product is scaled by.  Unit
    weights pass the 0/1 one-hot itself (one pass, mults (1,)); the
    fixed14 weighted mode passes the two base-128 digits of the
    quantised weights (mults (128, 1)), recombined as 128*A + B.
    Every product and sum is an integer below 2^31 (callers bound
    S * 16383), so the counts are exact on any backend.
    """
    C = None
    for x, m in zip(xi_parts, mults):
        part = jax.lax.dot_general(
            x, xj,
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        part = part if m == 1 else part * jnp.int32(m)
        C = part if C is None else C + part
    return C


def _group_sum_rows(x: jnp.ndarray) -> jnp.ndarray:
    """(TI*5, M) -> (TI, M): sum over each column-group of 5 rows."""
    TI5, M = x.shape
    return x.reshape(TI5 // N_STATES, N_STATES, M).sum(axis=1)


def _group_sum_cols(x: jnp.ndarray) -> jnp.ndarray:
    """(N, TJ*5) -> (N, TJ): sum over each group of 5 adjacent columns."""
    N, TJ5 = x.shape
    return x.reshape(N, TJ5 // N_STATES, N_STATES).sum(axis=2)


def mi_from_crosstab_flat(
    C: jnp.ndarray,
    ipf: jnp.ndarray,
    jpf: jnp.ndarray,
    pseudocount: float,
) -> jnp.ndarray:
    """MI tile from a flat (TI*5, TJ*5) crosstable.

    ipf: (TI*5,) flattened i-presence (0/1); jpf: (TJ*5,) j-presence.
    Returns (TI, TJ).  Same math as :func:`mi_from_crosstabs`
    (mi.hpp:146-181 semantics incl. the full-row-sum quirk), expressed
    with lane-friendly shapes: all O(25·TI·TJ) elementwise work happens
    on (TI*5, TJ*5) arrays; reductions collapse the interleaved state
    axes.  Division by Z is folded into a final log-identity:
    sum pm*xlogx(A/Z) = (sum pm*A*lnA - lnZ*sum pm*A)/Z.
    """
    dtype = C.dtype
    pm = ipf[:, None] * jpf[None, :]
    A = C + jnp.asarray(pseudocount, dtype) * pm
    Am = A * pm
    lnA = jnp.log(jnp.where(A > 0, A, 1.0))

    # Z and joint term
    Z = _group_sum_cols(_group_sum_rows(Am))                 # (TI, TJ)
    G_joint = _group_sum_cols(_group_sum_rows(Am * lnA))     # sum pm*A*lnA
    lnZ = jnp.log(jnp.maximum(Z, jnp.finfo(dtype).tiny))
    invZ = 1.0 / jnp.maximum(Z, jnp.finfo(dtype).tiny)
    jointH = (G_joint - lnZ * Z) * invZ

    # j-marginal (full sum over ALL i-states — mi.hpp:173 quirk)
    R = _group_sum_rows(A)                                    # (TI, TJ*5) raw row sums
    lnR = jnp.log(jnp.where(R > 0, R, 1.0))
    jpb = jpf[None, :]
    G_i = _group_sum_cols(R * lnR * jpb)                      # sum_b jp*R*lnR
    S_i = _group_sum_cols(R * jpb)                            # sum_b jp*R
    icondH = (G_i - lnZ * S_i) * invZ

    # i-marginal (masked over present j-states)
    Bm = _group_sum_cols(A * jpf[None, :])                    # (TI*5, TJ)
    lnB = jnp.log(jnp.where(Bm > 0, Bm, 1.0))
    ipb = ipf[:, None]
    G_j = _group_sum_rows(Bm * lnB * ipb)                     # (TI, TJ)
    S_j = _group_sum_rows(Bm * ipb)
    jcondH = (G_j - lnZ * S_j) * invZ

    return jointH - icondH - jcondH


@partial(jax.jit, static_argnames=("pseudocount",))
def tile_mi(
    xi_w: jnp.ndarray,
    xj: jnp.ndarray,
    ip: jnp.ndarray,
    jp: jnp.ndarray,
    ip_wog: jnp.ndarray,
    jp_wog: jnp.ndarray,
    pseudocount: float = 0.5,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(mi, mi_wo_gaps) for a tile of column pairs, sharing one crosstable.

    ip/jp: (TI, 5) / (TJ, 5) presence masks; *_wog variants have the gap
    bit cleared (apegrunt ``get_statepresence_blocks_wo_gaps``,
    mi.hpp:114).
    """
    C = crosstab_tile(xi_w, xj, dtype=xi_w.dtype if xi_w.dtype != jnp.bfloat16 else jnp.float32)
    mi = mi_from_crosstabs(C, ip[:, None, :], jp[None, :, :], pseudocount)
    mi_wog = mi_from_crosstabs(C, ip_wog[:, None, :], jp_wog[None, :, :], pseudocount)
    return mi, mi_wog


def make_tile_mi_fn(pseudocount: float):
    """Unjitted tile MI closure for embedding in larger jitted programs."""

    def fn(xi_w, xj, ip, jp, ip_wog, jp_wog):
        C = crosstab_tile(
            xi_w, xj, dtype=jnp.float32 if xi_w.dtype == jnp.bfloat16 else xi_w.dtype
        )
        mi = mi_from_crosstabs(C, ip[:, None, :], jp[None, :, :], pseudocount)
        mi_wog = mi_from_crosstabs(C, ip_wog[:, None, :], jp_wog[None, :, :], pseudocount)
        return mi, mi_wog

    return fn
