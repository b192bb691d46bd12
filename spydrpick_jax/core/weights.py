"""Population-structure sample reweighting.

Reference semantics (apegrunt ``cache_sample_weights`` consumed at
src/SpydrPick.cpp:321; rule documented in reference README "Advanced
usage" and the NAR 2019 paper): each sample's weight is

    w_i = 1 / |{ j : similarity(i, j) >= threshold }|

where similarity is the fraction of identical positions between two
samples (the count includes i itself, so every weight is <= 1), and the
threshold is ``--sample-reweighting-threshold`` (default 0.9).  With
``--no-sample-reweighting`` all weights are 1.

Accelerator design: sample-sample identity is a per-state one-hot
matmul — ``match = Σ_s X_s · X_s^T`` where ``X_s = (codes == s)`` is the
0/1 indicator of state ``s`` — executed as GEMMs in column tiles over
the CODES-resident alignment (the (S, L*5) one-hot is never
materialised on host or device: 12 GB at 3000×200k, impossible at the
20k×1M class).  The 0/1 operands are bf16-exact and counts
stay below 2^24, so a DEFAULT-precision f32-accumulating dot is exact.
The same product yields the sample-sample Hamming distance matrix dump
(``output_sample_distance_matrix``, src/SpydrPick.cpp:367) for free.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from spydrpick_jax.core.alignment import Alignment
from spydrpick_jax.core.alphabet import N_STATES
from spydrpick_jax.utils.device import device_bytes_limit

DEFAULT_REWEIGHTING_THRESHOLD = 0.9

# column tile: (S, ct) bf16 per state — bounds device memory per step
_COL_TILE = 8192
# past this many codes bytes the codes stay on host and tiles stream
# per dispatch (the 20k x 1M class exceeds one device's memory): 1/4
# of the device's memory limit, this value where it reports none
_DEVICE_RESIDENT_BYTES = 4 << 30
# an f32 accumulator holds integer counts exactly only below 2^24; any
# single on-device f32 accumulation run must cover fewer columns than
# this, with cross-run sums carried in host float64 (exact to 2^53)
_EXACT_F32_COLS = 1 << 24


def _match_accum(sl: jnp.ndarray, acc: jnp.ndarray) -> jnp.ndarray:
    """acc += per-state identity counts of one (S, ct) codes tile.

    Five (S, ct) @ (ct, S) dots — one per state, each operand a 0/1
    indicator with the full tile as its minor (contraction) dimension
    (a (S, ct, 5) one-hot would put 5 in the minor dim).  Pad columns
    (code 255) match no state, contributing nothing."""
    for s in range(N_STATES):
        xs = (sl == s).astype(jnp.bfloat16)
        acc = acc + jax.lax.dot_general(
            xs, xs, dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
    return acc


@partial(jax.jit, static_argnames=("ct",))
def _match_counts_resident(codes: jnp.ndarray, ct: int) -> jnp.ndarray:
    S, Lp = codes.shape

    def body(c, acc):
        sl = jax.lax.dynamic_slice(codes, (0, c * ct), (S, ct))
        return _match_accum(sl, acc)

    return jax.lax.fori_loop(
        0, Lp // ct, body, jnp.zeros((S, S), jnp.float32)
    )


@jax.jit
def _match_counts_step(sl: jnp.ndarray, acc: jnp.ndarray) -> jnp.ndarray:
    return _match_accum(sl, acc)


def sample_match_counts(alignment: Alignment,
                        tile: int = _COL_TILE) -> np.ndarray:
    """(S, S) float64 matrix of identical-position counts between samples.

    Identity is computed over the current (filtered) alignment columns on
    the 5-state codes — gap==gap counts as a match, mirroring a Hamming
    distance over the stored states.  Runs codes-resident on device in
    column tiles (exact: 0/1 bf16 operands, f32 accumulation); for
    alignments whose codes exceed a quarter of the device's memory
    (4 GiB where the device reports no limit) the tiles stream from
    host instead, so width is bounded by host storage only.

    Exactness: per-pair counts are integers; an f32 accumulator holds
    them exactly only below 2^24.  Any single device accumulation run
    therefore covers < 2^24 columns (alignments at or past that width
    stream in bounded groups whose partial counts are summed in host
    float64 — exact for any realistic width, counts < 2^53).
    """
    codes = alignment.codes
    S, L = codes.shape
    ct = min(tile, max(((L + 127) // 128) * 128, 128))
    Lp = -(-L // ct) * ct
    lim = device_bytes_limit()
    resident_bytes = lim // 4 if lim else _DEVICE_RESIDENT_BYTES
    if codes.nbytes <= resident_bytes and L < _EXACT_F32_COLS:
        if Lp != L:  # pad code 255 matches no state
            codes = np.pad(codes, [(0, 0), (0, Lp - L)],
                           constant_values=255)
        out = _match_counts_resident(jnp.asarray(codes), ct)
        return np.asarray(out, dtype=np.float64)
    acc64 = np.zeros((S, S), np.float64)
    acc = jnp.zeros((S, S), jnp.float32)
    group_cols = 0
    for c0 in range(0, L, ct):
        sl = codes[:, c0 : c0 + ct]
        if sl.shape[1] < ct:
            sl = np.pad(sl, [(0, 0), (0, ct - sl.shape[1])],
                        constant_values=255)
        acc = _match_counts_step(jnp.asarray(sl), acc)
        group_cols += ct
        if group_cols + ct > _EXACT_F32_COLS:
            # flush before the f32 counts could reach 2^24
            acc64 += np.asarray(acc, dtype=np.float64)
            acc = jnp.zeros((S, S), jnp.float32)
            group_cols = 0
    acc64 += np.asarray(acc, dtype=np.float64)
    return acc64


def compute_sample_weights(
    alignment: Alignment,
    threshold: float = DEFAULT_REWEIGHTING_THRESHOLD,
) -> np.ndarray:
    """(S,) float64 weights: 1 / cluster size at the identity threshold."""
    L = alignment.n_loci
    matches = sample_match_counts(alignment)
    similar = matches >= threshold * L  # similarity fraction >= threshold
    cluster_sizes = similar.sum(axis=1)
    return 1.0 / cluster_sizes.astype(np.float64)


def hamming_distance_matrix(alignment: Alignment) -> np.ndarray:
    """(S, S) int64 Hamming distances (for --output-sample-distance-matrix)."""
    matches = sample_match_counts(alignment)
    return (alignment.n_loci - matches).round().astype(np.int64)


def cache_sample_weights(
    alignment: Alignment,
    weights_file: str | None = None,
    no_reweighting: bool = False,
    threshold: float = DEFAULT_REWEIGHTING_THRESHOLD,
) -> Alignment:
    """Attach sample weights to the alignment (src/SpydrPick.cpp:321).

    Priority: explicit file (``--sample-weights``) > disabled
    (``--no-sample-reweighting`` -> all ones) > computed.
    """
    if weights_file is not None:
        from spydrpick_jax.io.loci import parse_value_list

        w = parse_value_list(weights_file)
        if len(w) != alignment.n_samples:
            raise ValueError(
                f"sample-weights file has {len(w)} values, alignment has "
                f"{alignment.n_samples} samples"
            )
    elif no_reweighting:
        w = np.ones(alignment.n_samples, dtype=np.float64)
    else:
        w = compute_sample_weights(alignment, threshold)
    alignment.weights = w
    return alignment
