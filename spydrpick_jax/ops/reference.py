"""NumPy float64 golden model of the MI math.

This is the *test oracle*: a direct, unoptimised transliteration of the
reference semantics (include/mi.hpp:146-181 ``normalize_and_get_mi_single``
plus the weighted crosstable of apegrunt's
``Weighted_crosstable_2Dblock``, call site include/mi.hpp:126).  The
production path in :mod:`spydrpick_jax.ops.mi` is validated against
this model in the test suite.

Semantics, for a pair of columns (i, j) with per-column state-presence
masks IP, JP (5 bools each) and raw weighted counts
``C[a, b] = sum_s w_s [X_si == a][X_sj == b]``:

  A      = C + pc * outer(IP, JP)          # pseudocount only on present cells
  Z      = sum over {a in IP, b in JP} A
  P      = A / Z
  jointH = sum_{a in IP, b in JP} xlogx(P[a,b])
  icondH = sum_{b in JP} xlogx( sum_{a in ALL} P[a,b] )   # full-row sum quirk
  jcondH = sum_{a in IP} xlogx( sum_{b in JP} P[a,b] )
  MI     = jointH - icondH - jcondH        # natural log (nats)

Note the ``icondH`` marginal sums over *all* a (mi.hpp:173 sums the full
SIMD row); with full presence masks this is identical to the masked sum
because absent states have zero counts, but in gap-excluded mode
(presence masks with the gap bit cleared, same raw counts — mi.hpp's
crosstable cache at :123-129 is reused at :472) the gap-column raw
counts do leak into the row sums.  We preserve that behaviour exactly.
"""

from __future__ import annotations

import numpy as np

from spydrpick_jax.core.alphabet import N_STATES


def xlogx(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    out = np.zeros_like(x)
    pos = x > 0
    out[pos] = x[pos] * np.log(x[pos])
    return out


def crosstab_pair(codes_i, codes_j, weights) -> np.ndarray:
    """(5, 5) weighted joint counts C[a, b] for one column pair."""
    C = np.zeros((N_STATES, N_STATES), dtype=np.float64)
    np.add.at(C, (codes_i.astype(np.int64), codes_j.astype(np.int64)), weights)
    return C


def mi_single(C, ip, jp, pseudocount=0.5) -> float:
    """MI for one pair given crosstable + presence masks."""
    ip = np.asarray(ip, dtype=bool)
    jp = np.asarray(jp, dtype=bool)
    pm = np.outer(ip, jp).astype(np.float64)
    A = C + pseudocount * pm
    Z = float(np.sum(A * pm))
    P = A / Z
    jointH = float(np.sum(xlogx(P) * pm))
    icondH = float(np.sum(xlogx(np.sum(P, axis=0)) * jp))   # full-row sum over a
    jcondH = float(np.sum(xlogx(np.sum(P * jp[None, :], axis=1)) * ip))
    return jointH - icondH - jcondH


def mi_matrix(codes, weights, presence, pseudocount=0.5) -> np.ndarray:
    """(L, L) MI matrix, brute force (upper triangle mirrored). Test use only."""
    S, L = codes.shape
    out = np.zeros((L, L), dtype=np.float64)
    for i in range(L):
        for j in range(i + 1, L):
            C = crosstab_pair(codes[:, i], codes[:, j], weights)
            out[i, j] = out[j, i] = mi_single(C, presence[i], presence[j], pseudocount)
    return out
