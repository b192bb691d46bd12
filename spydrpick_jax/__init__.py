"""spydrpick_jax — a JAX genome-wide epistasis (GWES) engine for GPUs.

A from-scratch JAX/XLA re-design of the SpydrPick method
(MI scoring of all position pairs in a categorical alignment + ARACNE
indirect-edge pruning; reference: santeripuranen/SpydrPick, see
/root/reference and doi:10.1093/nar/gkz656).

The pipeline (reference README.md:31):
  1. parse a FASTA alignment into a 5-state code matrix,
  2. filter positions by allele count / MAF / gap frequency,
  3. compute population-structure-correcting sample weights,
  4. auto-estimate an MI save threshold (tournament sampling),
  5. evaluate all pairwise position-position mutual information,
  6. estimate outlier / extreme-outlier thresholds (Tukey fences),
  7. prune indirect edges with ARACNE,
  8. write ranked edge lists.

Accelerator design notes:
  * the crosstable kernel is a blocked one-hot GEMM (f32, or exact
    int8 -> int32 counts),
  * the all-pairs sweep is an upper-triangular tile grid, processed
    block-row at a time under jit with on-device edge compaction,
  * multi-chip scaling shards block-rows over a jax.sharding.Mesh and
    merges colmax / top-k buffers with collectives,
  * everything under jit uses static shapes (fixed-capacity top-k
    buffers with overflow counters instead of dynamic edge lists).
"""

from spydrpick_jax.version import __version__

__all__ = ["__version__"]
