"""Command-line interface.

Mirrors the reference binary's merged flag surface (three option groups
combined into one parser with a positional alignment file,
src/SpydrPick.cpp:64-87; flag inventory SURVEY §2a rows 2-3 + §2b),
plus ``--seed`` (determinism fix) and engine-tuning flags.
"""

from __future__ import annotations

import argparse
import os
import sys

from spydrpick_jax.engine.aracne import DEFAULT_EDGE_THRESHOLD
from spydrpick_jax.pipeline import PipelineOptions, run_pipeline
from spydrpick_jax.utils.jax_cache import configure_compile_cache
from spydrpick_jax.version import TITLE, version_string


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spydrpick-jax",
        description=TITLE,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("alignmentfile", nargs="?", help="input FASTA alignment")
    p.add_argument("--version", action="store_true", help="print version information")
    p.add_argument("-v", "--verbose", action="store_true", help="be verbose")
    p.add_argument("-t", "--threads", type=int, default=-1,
                   help="host threads for the native (OpenMP) ARACNE/FASTA "
                        "kernels; -1 = all hardware threads (reference "
                        "SpydrPick_options.cpp:158 — the MI sweep itself "
                        "runs on the JAX device and ignores this)")

    g = p.add_argument_group("MI options")
    g.add_argument("--mi-threshold", type=float, default=-1.0,
                   help="MI save threshold (0=no threshold; -1=determine automatically)")
    g.add_argument("--mi-values", type=int, default=0,
                   help="approximate number of MI values to save (0=min(1e7, 100*n_loci))")
    g.add_argument("--mi-pseudocount", type=float, default=0.5, help="MI pseudocount value")
    g.add_argument("--mi-threshold-iterations", type=int, default=10,
                   help="iterations for estimating the save threshold")
    g.add_argument("--mi-threshold-pairs", type=int, default=0,
                   help="sampled pairs per iteration (0=auto)")
    g.add_argument("--ld-threshold", type=int, default=0,
                   help="linkage-disequilibrium distance threshold")
    g.add_argument("--no-aracne", action="store_true", help="skip ARACNE, only calculate MI")

    g = p.add_argument_group("alignment options (apegrunt group in the reference)")
    g.add_argument("--maf-threshold", type=float, default=0.01,
                   help="minor-allele frequency filter threshold")
    g.add_argument("--gap-threshold", type=float, default=0.15,
                   help="gap frequency filter threshold")
    g.add_argument("--no-filter-alignment", action="store_true",
                   help="do not apply position filters")
    g.add_argument("--include-list", help="file of position indices to include")
    g.add_argument("--exclude-list", help="file of position indices to exclude")
    g.add_argument("--sample-list", help="file of sample indices to include")
    g.add_argument("--mappings-list", help="file of original position indices per column")
    g.add_argument("--genome-size", type=int, help="genome size for circular distance")
    g.add_argument("--input-indexing-base", type=int, default=1)
    g.add_argument("--output-indexing-base", type=int, default=1)
    g.add_argument("--linear-genome", action="store_true",
                   help="treat the genome as linear (default: circular)")
    g.add_argument("--sample-reweighting-threshold", type=float, default=0.9,
                   help="sequence identity threshold for sample clustering")
    g.add_argument("--no-sample-reweighting", action="store_true",
                   help="all samples get weight 1")
    g.add_argument("--sample-weights", help="file of user-supplied sample weights")
    g.add_argument("--output-state-frequencies", action="store_true")
    g.add_argument("--output-sample-weights", action="store_true")
    g.add_argument("--output-sample-distance-matrix", action="store_true")
    g.add_argument("--output-alignment", action="store_true")
    g.add_argument("--output-filtered-alignment", action="store_true")

    g = p.add_argument_group("ARACNE options")
    g.add_argument("--aracne-edge-threshold", type=float, default=DEFAULT_EDGE_THRESHOLD,
                   help="equality tolerance for the DPI rule")
    g.add_argument("--aracne-block-size", type=int, default=16384,
                   help="accepted for compatibility (closed-form kernel needs no blocking)")
    g.add_argument("--aracne-node-grouping-size", type=int, default=16,
                   help="accepted for compatibility")
    g.add_argument("--aracne-outputfile", default="aracne.out",
                   help="accepted for compatibility (unused, as in the reference's "
                        "combined binary — ARACNE_options.cpp:180)")

    g = p.add_argument_group("engine options (new)")
    g.add_argument("--seed", type=int, default=42,
                   help="PRNG seed for threshold-pair sampling (reference used wall clock)")
    g.add_argument("--tile", type=int, default=512, help="MI tile width in columns")
    g.add_argument("--edge-capacity", type=int, default=1 << 19,
                   help="per-block-row on-device edge buffer capacity")
    g.add_argument("--store-capacity", type=int, default=1 << 24,
                   help="device-resident edge store capacity (the packed drain "
                        "recycles it in epochs, so this bounds drain lag, not "
                        "the run size)")
    g.add_argument("--onehot-storage", choices=["auto", "dense", "codes"],
                   default="auto",
                   help="alignment residency: dense (S x 5L one-hot in device "
                        "memory) or codes (S x L uint8, one-hot tiles expanded "
                        "on the fly; auto switches to codes past 1/16 of the "
                        "device's memory limit, 1 GiB where it reports none)")
    g.add_argument("--rows-per-dispatch", type=int, default=8,
                   help="block-rows swept per device dispatch")
    g.add_argument("--pipeline-depth", type=int, default=2,
                   help="counts-sync pipeline depth (2 = dispatch the next "
                        "group before reading the previous group's counts)")
    g.add_argument("--row-window", type=int, default=0,
                   help="j-window width for very wide alignments (the sweep "
                        "streams (block-row, j-window) items with fixed "
                        "device memory per item; 0 = auto: full-width rows "
                        "below ~131k columns, ~65k windows above; 1 = force "
                        "full-width)")
    g.add_argument("--compaction", choices=["auto", "route", "scatter"],
                   default="auto",
                   help="on-device edge compaction: scatter-free roll-routing "
                        "or cumsum+scatter (auto: the faster one, see PERF.md)")
    g.add_argument("--mxu-int8", choices=["auto", "on", "off"], default="auto",
                   help="int8 crosstable modes (exact int32 counts): auto = int8 "
                        "for unit weights only; on = also a 14-bit fixed-point "
                        "weight split for positive weights with max/min <= 32 "
                        "and fewer than ~131k samples (else f32)")
    g.add_argument("--matmul-precision", choices=["highest", "high", "default"],
                   default="highest",
                   help="weighted f32 crosstable matmul precision: highest = full "
                        "f32; on a GPU high and default run TF32 (10-bit weight "
                        "mantissas, unsafe for MI ranking); on the CPU all are f32")
    g.add_argument("--output-dir", default=".", help="directory for output files")
    g.add_argument("--checkpoint", help="sweep checkpoint file: resume a killed run")
    g.add_argument("--checkpoint-every", type=int, default=16,
                   help="checkpoint every N block-rows")
    g.add_argument("--profile-dir", help="write a jax.profiler trace here")
    g.add_argument("--jax-cache-dir",
                   help="persistent XLA compilation cache directory (repeat "
                        "runs skip the jit compiles); default: "
                        "$JAX_COMPILATION_CACHE_DIR, else <checkout>/.jax_cache; "
                        "'none' leaves the cache alone")
    g.add_argument("--sharded", action="store_true",
                   help="shard the sweep over all visible devices")
    g.add_argument("--sample-shards", type=int, default=1,
                   help="with --sharded: shard the alignment itself over this "
                        "many devices (2-D rows x samples mesh; for alignments "
                        "too large to replicate per chip)")

    g = p.add_argument_group("multi-host options")
    g.add_argument("--coordinator-address",
                   help="host:port of process 0 (jax.distributed)")
    g.add_argument("--num-processes", type=int, help="total process count")
    g.add_argument("--process-id", type=int, help="this process's id")
    return p


def main(argv=None, timings: dict | None = None) -> int:
    """Run the CLI; ``timings`` (optional) receives run_pipeline's
    per-stage seconds."""
    args = build_parser().parse_args(argv)
    if args.version:
        print(version_string())
        return 0
    if not args.alignmentfile:
        print("spydrpick-jax ERROR: No alignment file specified!", file=sys.stderr)
        return 1

    print(version_string())
    if args.threads and args.threads > 0:
        # an explicit -t overrides a pre-exported OMP_NUM_THREADS (the
        # reference's -t wins likewise; -1 leaves the environment alone)
        os.environ["OMP_NUM_THREADS"] = str(args.threads)
    configure_compile_cache(args.jax_cache_dir)
    if args.coordinator_address or (args.num_processes and args.num_processes > 1):
        from spydrpick_jax.parallel.distributed import initialize_multihost

        info = initialize_multihost(
            args.coordinator_address, args.num_processes, args.process_id
        )
        print(f"spydrpick-jax: process {info['process_index']}/{info['process_count']}, "
              f"{info['local_devices']} local / {info['global_devices']} global devices")
    opts = PipelineOptions(
        alignmentfile=args.alignmentfile,
        mi_threshold=args.mi_threshold,
        mi_values=args.mi_values,
        mi_pseudocount=args.mi_pseudocount,
        mi_threshold_iterations=args.mi_threshold_iterations,
        mi_threshold_pairs=args.mi_threshold_pairs,
        ld_threshold=args.ld_threshold,
        no_aracne=args.no_aracne,
        verbose=args.verbose,
        maf_threshold=args.maf_threshold,
        gap_threshold=args.gap_threshold,
        no_filter_alignment=args.no_filter_alignment,
        include_list=args.include_list,
        exclude_list=args.exclude_list,
        sample_list=args.sample_list,
        mappings_list=args.mappings_list,
        genome_size=args.genome_size,
        input_indexing_base=args.input_indexing_base,
        output_indexing_base=args.output_indexing_base,
        linear_genome=args.linear_genome,
        sample_reweighting_threshold=args.sample_reweighting_threshold,
        no_sample_reweighting=args.no_sample_reweighting,
        sample_weights=args.sample_weights,
        output_state_frequencies=args.output_state_frequencies,
        output_sample_weights=args.output_sample_weights,
        output_sample_distance_matrix=args.output_sample_distance_matrix,
        output_alignment=args.output_alignment,
        output_filtered_alignment=args.output_filtered_alignment,
        aracne_edge_threshold=args.aracne_edge_threshold,
        aracne_block_size=args.aracne_block_size,
        aracne_node_grouping_size=args.aracne_node_grouping_size,
        seed=args.seed,
        tile=args.tile,
        edge_capacity=args.edge_capacity,
        store_capacity=args.store_capacity,
        onehot_storage=args.onehot_storage,
        rows_per_dispatch=args.rows_per_dispatch,
        pipeline_depth=args.pipeline_depth,
        row_window=args.row_window,
        compaction=args.compaction,
        mxu_int8=args.mxu_int8,
        matmul_precision=args.matmul_precision,
        output_dir=args.output_dir,
        checkpoint=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        profile_dir=args.profile_dir,
        sharded=args.sharded,
        sample_shards=args.sample_shards,
    )
    try:
        run_pipeline(opts, timings=timings)
    except (FileNotFoundError, ValueError) as e:
        print(f"spydrpick-jax ERROR: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
