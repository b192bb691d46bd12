"""The Alignment container — the engine's data model of an aligned dataset.

Re-designs the role of apegrunt's block-compressed
``Alignment_impl_block_compressed_storage`` (consumed by the reference
at include/SpydrPick.h:35-36, include/mi_parameters.hpp:48-59) as a
dense ``uint8`` code matrix plus derived per-column metadata.  The
accelerator's GEMMs want a *dense one-hot tensor*, not run-length
compression, so the canonical representation is:

  * ``codes``       — (n_samples, n_loci) uint8 state codes in host RAM,
  * ``translation`` — (n_loci,) int64 map filtered index -> original
                      genome position (apegrunt ``get_loci_translation``,
                      used at src/SpydrPick.cpp:228,472),
  * ``weights``     — (n_samples,) float64 sample weights
                      (apegrunt ``cache_sample_weights``,
                      src/SpydrPick.cpp:321),
  * per-column state presence/gap masks (apegrunt
    ``get_statepresence_blocks[_wo_gaps]`` / ``get_gappresence_blocks``,
    include/mi.hpp:64-68,114).

Device tensors (one-hot etc.) are materialised lazily by the engine.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

from spydrpick_jax.core.alphabet import GAP_STATE, N_STATES


@dataclasses.dataclass
class Alignment:
    codes: np.ndarray              # (n_samples, n_loci) uint8
    sample_names: list[str]
    id_string: str                 # alignment id (input file stem)
    translation: np.ndarray        # (n_loci,) int64, filtered -> original index
    n_original_positions: int      # original genome width (pre-filter / genome size)
    weights: np.ndarray | None = None  # (n_samples,) float64 sample weights

    def __post_init__(self):
        assert self.codes.ndim == 2 and self.codes.dtype == np.uint8
        assert len(self.translation) == self.n_loci

    # --- basic shape accessors (apegrunt Alignment::n_loci/size/effective_size,
    # call sites src/SpydrPick.cpp:187,255; include/mi.hpp:84,88) ---
    @property
    def n_samples(self) -> int:
        return self.codes.shape[0]

    @property
    def n_loci(self) -> int:
        return self.codes.shape[1]

    @property
    def effective_size(self) -> float:
        """Sum of sample weights (apegrunt ``effective_size``)."""
        w = self.weights if self.weights is not None else np.ones(self.n_samples)
        return float(np.sum(w))

    def size_string(self) -> str:
        """'<samples>x<loci>' used in output filenames (src/SpydrPick.cpp:429)."""
        return f"{self.n_samples}x{self.n_loci}"

    # --- per-column metadata ---
    @cached_property
    def state_counts(self) -> np.ndarray:
        """(n_loci, 5) int64 unweighted per-column state counts."""
        counts = np.zeros((self.n_loci, N_STATES), dtype=np.int64)
        for s in range(N_STATES):
            counts[:, s] = np.count_nonzero(self.codes == s, axis=0)
        return counts

    @cached_property
    def state_presence(self) -> np.ndarray:
        """(n_loci, 5) bool — which states occur in each column
        (apegrunt ``get_statepresence_blocks``)."""
        return self.state_counts > 0

    @cached_property
    def state_presence_wo_gaps(self) -> np.ndarray:
        """Presence mask with the gap state cleared
        (apegrunt ``get_statepresence_blocks_wo_gaps``, mi.hpp:114)."""
        p = self.state_presence.copy()
        p[:, GAP_STATE] = False
        return p

    @cached_property
    def gap_presence(self) -> np.ndarray:
        """(n_loci,) bool — column contains at least one gap
        (apegrunt ``get_gappresence_blocks``, mi.hpp:381)."""
        return self.state_presence[:, GAP_STATE]

    # --- subsetting (apegrunt subset/subsample, src/SpydrPick.cpp:207,269,315) ---
    def subset(self, keep: np.ndarray) -> "Alignment":
        """Column subset: ``keep`` is an array of filtered-column indices."""
        keep = np.asarray(keep, dtype=np.int64)
        return Alignment(
            codes=np.ascontiguousarray(self.codes[:, keep]),
            sample_names=self.sample_names,
            id_string=self.id_string,
            translation=self.translation[keep],
            n_original_positions=self.n_original_positions,
            weights=self.weights,
        )

    def subsample(self, keep_samples: np.ndarray) -> "Alignment":
        """Row (sample) subset."""
        keep_samples = np.asarray(keep_samples, dtype=np.int64)
        return Alignment(
            codes=np.ascontiguousarray(self.codes[keep_samples, :]),
            sample_names=[self.sample_names[i] for i in keep_samples],
            id_string=self.id_string,
            translation=self.translation,
            n_original_positions=self.n_original_positions,
            weights=self.weights[keep_samples] if self.weights is not None else None,
        )

    # --- statistics dump (apegrunt Alignment::statistics, SpydrPick.cpp:279) ---
    def statistics_string(self) -> str:
        """Multi-line alignment statistics (the role of apegrunt's
        ``Alignment::statistics(ostream)`` dumped by the reference when
        ``--output-state-frequencies`` is set, src/SpydrPick.cpp:275-282):
        shape, effective (weighted) size, overall and per-state symbol
        frequencies, gap occupancy, and the column allele-cardinality
        spectrum (how many columns are mono/bi/tri/quad/penta-state)."""
        counts = self.state_counts
        total = counts.sum()
        freqs = counts.sum(axis=0) / max(total, 1)
        n_states_per_col = self.state_presence.sum(axis=1)
        card = np.bincount(n_states_per_col, minlength=N_STATES + 1)
        gaps = counts[:, GAP_STATE].sum()
        cols_with_gaps = int(self.gap_presence.sum())
        lines = [
            f"alignment \"{self.id_string}\": {self.n_samples} samples x "
            f"{self.n_loci} loci ({self.n_original_positions} original positions)",
            f"effective (weighted) size: {self.effective_size:.2f}",
            "state frequencies: "
            + " ".join(f"{sym}={f:.4f}" for sym, f in zip("ACGT-", freqs)),
            f"gaps: {gaps} ({gaps / max(total, 1):.2%} of symbols); "
            f"{cols_with_gaps} of {self.n_loci} columns contain gaps",
            "column state cardinality: "
            + " ".join(f"{k}-state={int(card[k])}" for k in range(1, N_STATES + 1)),
        ]
        return "\n".join(lines)
