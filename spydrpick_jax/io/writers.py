"""Output-file writers: couplings, outliers, state frequencies, weights.

Formats per reference README "Deciphering SpydrPick output" and the
formatters at apegrunt ``Graph_output_formatter`` (src/SpydrPick.cpp:
442-446) / ``Outlier_Graph_formatter`` (include/SpydrPick.hpp:89-129):

  couplings rows: ``pos1 pos2 genome_distance aracne_flag mi``
    (descending MI; positions are original-genome indices + output base;
    MI fixed 6 decimals per SpydrPick.hpp:119-121)
  outliers rows:  ``pos1 pos2 distance flag mi mi_wo_gaps gap_effect
    extreme_flag`` where gap_effect = (1 - mi_wo_gaps/mi)*100 at one
    decimal, rows restricted to weight >= outlier_threshold and
    distance > ld_threshold (SpydrPick.hpp:100-124).
"""

from __future__ import annotations

import numpy as np

from spydrpick_jax.core.alignment import Alignment
from spydrpick_jax.core.distance import genome_distance


def _translated(edges_pos: np.ndarray, translation: np.ndarray, base: int) -> np.ndarray:
    return translation[edges_pos] + base


def write_couplings(
    f,
    edges,                      # sorted-desc EdgeSet
    flags: np.ndarray,          # (E,) uint8 aracne flags (0 when --no-aracne)
    alignment: Alignment,
    output_base: int = 1,
    linear_genome: bool = False,
    use_native: bool = True,
) -> None:
    p1 = _translated(edges.ipos, alignment.translation, output_base)
    p2 = _translated(edges.jpos, alignment.translation, output_base)
    dist = genome_distance(p1, p2, alignment.n_original_positions, linear_genome)
    fl = flags.astype(np.uint8)
    # native OpenMP formatter (the apegrunt Graph_output_formatter role):
    # the earlier np.char pipeline ran ~25 us/row — 250 s at the 1e7-edge
    # default output.  Python fallback below is a chunked f-string loop
    # (~1.5 us/row); both produce byte-identical rows (locked by tests).
    if use_native:
        # Only the native build/format step may fall back to Python: the
        # actual file writes stay OUTSIDE the try so a partial write
        # (e.g. ENOSPC) surfaces as an error instead of being silently
        # re-emitted by the fallback after half the native rows landed.
        data = None
        try:
            from spydrpick_jax.native import format_native

            data = format_native.format_couplings(p1, p2, dist, fl, edges.mi)
        except Exception:
            pass  # fall back to Python formatting
        if data is not None:
            if hasattr(f, "buffer"):  # text file: skip the str round-trip
                f.flush()
                f.buffer.write(data)
            else:
                f.write(data.decode("ascii"))
            return
    mi = edges.mi
    out = []
    for c0 in range(0, len(mi), 1 << 18):
        hi = min(len(mi), c0 + (1 << 18))
        out.append("\n".join(
            f"{p1[k]} {p2[k]} {dist[k]} {fl[k]} {mi[k]:.6f}"
            for k in range(c0, hi)
        ))
        out.append("\n")
    f.write("".join(out))


def write_outliers(
    f,
    edges,                      # sorted-desc EdgeSet
    flags: np.ndarray,
    alignment: Alignment,
    outlier_threshold: float,
    extreme_outlier_threshold: float,
    ld_threshold: int = 0,
    output_base: int = 1,
    linear_genome: bool = False,
) -> int:
    """Returns the number of rows written."""
    p1 = _translated(edges.ipos, alignment.translation, output_base)
    p2 = _translated(edges.jpos, alignment.translation, output_base)
    dist = genome_distance(p1, p2, alignment.n_original_positions, linear_genome)
    n = 0
    for a, b, d, fl, w, wog in zip(p1, p2, dist, flags, edges.mi, edges.mi_wog):
        if w < outlier_threshold:
            break  # list is descending; reference breaks here (SpydrPick.hpp:100-103)
        if d <= ld_threshold:
            continue
        gap_effect = (1.0 - wog / w) * 100.0 if w != 0 else 0.0
        extreme = int(w > extreme_outlier_threshold)
        f.write(f"{a} {b} {d} {int(fl)} {w:.6f} {wog:.6f} {gap_effect:.1f} {extreme}\n")
        n += 1
    return n


def write_state_frequencies(f, alignment: Alignment, output_base: int = 1) -> None:
    """Per-column state frequency profile (apegrunt
    ``output_state_frequencies``, src/SpydrPick.cpp:333).  Columns:
    position A C G T gap frequencies (of n_samples).  Chunked join —
    the naive per-row loop cost ~1 min at the 1M-column class."""
    counts = alignment.state_counts
    freqs = counts / alignment.n_samples
    pos = alignment.translation + output_base
    L = alignment.n_loci
    for c0 in range(0, L, 1 << 16):
        hi = min(L, c0 + (1 << 16))
        f.write("\n".join(
            f"{pos[k]} " + " ".join(f"{x:.6f}" for x in freqs[k])
            for k in range(c0, hi)
        ))
        f.write("\n")


def write_sample_weights(f, alignment: Alignment) -> None:
    """One weight per line (apegrunt ``output_sample_weights``,
    src/SpydrPick.cpp:324)."""
    for w in alignment.weights:
        f.write(f"{w:.8f}\n")


def write_distance_matrix(f, dist: np.ndarray) -> None:
    """Sample-sample Hamming distance matrix
    (``output_sample_distance_matrix``, src/SpydrPick.cpp:367)."""
    for row in dist:
        f.write(" ".join(str(int(x)) for x in row) + "\n")
