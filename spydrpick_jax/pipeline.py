"""End-to-end GWES pipeline — the accelerator counterpart of the
reference driver ``main()`` (src/SpydrPick.cpp:45-520).

Stages (call stack mirror of SURVEY §3.1):
  load -> include/exclude trim -> position filter -> sample trim ->
  sample weights -> MI save-threshold (auto) -> all-pairs MI sweep ->
  Tukey outlier thresholds -> sort -> ARACNE -> couplings/outlier
  outputs.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from spydrpick_jax.core.alignment import Alignment
from spydrpick_jax.core.filter import FilterParams, filter_list
from spydrpick_jax.core.weights import (
    DEFAULT_REWEIGHTING_THRESHOLD,
    cache_sample_weights,
    hamming_distance_matrix,
)
from spydrpick_jax.engine.aracne import DEFAULT_EDGE_THRESHOLD, run_aracne
from spydrpick_jax.engine.outliers import outlier_thresholds
from spydrpick_jax.engine.solver import EdgeSet, EngineConfig, MIEngine
from spydrpick_jax.engine.threshold import default_mi_values, determine_mi_threshold
from spydrpick_jax.io.fasta import read_fasta, write_fasta
from spydrpick_jax.io.loci import parse_loci_list
from spydrpick_jax.io.writers import (
    write_couplings,
    write_distance_matrix,
    write_outliers,
    write_sample_weights,
    write_state_frequencies,
)
from spydrpick_jax.utils.stopwatch import Stopwatch
from spydrpick_jax.utils.uniquefile import unique_path


@dataclasses.dataclass
class PipelineOptions:
    """Union of the reference's three flag groups (SpydrPick / apegrunt /
    ARACNE; inventory SURVEY §2a rows 2-3 and §2b) plus --seed."""

    alignmentfile: str = ""
    # SpydrPick options (src/SpydrPick_options.cpp:144-160)
    mi_threshold: float = -1.0
    mi_values: int = 0
    mi_pseudocount: float = 0.5
    mi_threshold_iterations: int = 10
    mi_threshold_pairs: int = 0
    ld_threshold: int = 0
    no_aracne: bool = False
    verbose: bool = False
    # apegrunt options (README "Advanced usage"; SURVEY §2b)
    maf_threshold: float = 0.01
    gap_threshold: float = 0.15
    no_filter_alignment: bool = False
    include_list: str | None = None
    exclude_list: str | None = None
    sample_list: str | None = None
    mappings_list: str | None = None
    genome_size: int | None = None
    input_indexing_base: int = 1
    output_indexing_base: int = 1
    linear_genome: bool = False
    sample_reweighting_threshold: float = DEFAULT_REWEIGHTING_THRESHOLD
    no_sample_reweighting: bool = False
    sample_weights: str | None = None
    output_state_frequencies: bool = False
    output_sample_weights: bool = False
    output_sample_distance_matrix: bool = False
    output_alignment: bool = False
    output_filtered_alignment: bool = False
    # ARACNE options (src/ARACNE_options.cpp:151-156)
    aracne_edge_threshold: float = DEFAULT_EDGE_THRESHOLD
    aracne_block_size: int = 16384       # accepted; the closed-form kernel needs no blocking
    aracne_node_grouping_size: int = 16  # accepted; no mutex striping needed
    # new (determinism fix, SURVEY §5)
    seed: int = 42
    # engine tuning
    tile: int = 512
    edge_capacity: int = 1 << 19
    store_capacity: int = 1 << 24
    onehot_storage: str = "auto"
    rows_per_dispatch: int = 8
    pipeline_depth: int = 1
    row_window: int = 0      # 0=auto: j-window very wide alignments
    compaction: str = "auto"  # edge compaction (solver.EngineConfig)
    mxu_int8: str = "auto"    # int8 crosstable modes (solver.EngineConfig)
    matmul_precision: str = "highest"
    output_dir: str = "."
    checkpoint: str | None = None       # sweep checkpoint file (resume support)
    checkpoint_every: int = 16
    profile_dir: str | None = None      # jax.profiler trace output dir
    sharded: bool = False               # multi-device sharded sweep
    sample_shards: int = 1              # 2-D mesh: shard the alignment itself


@dataclasses.dataclass
class PipelineResult:
    alignment: Alignment
    edges: EdgeSet
    flags: np.ndarray
    mi_threshold: float
    outlier_threshold: float
    extreme_outlier_threshold: float
    couplings_path: str | None = None
    outliers_path: str | None = None


def _log(opts, *msg):
    if opts.verbose:
        print("spydrpick-jax:", *msg, file=sys.stdout, flush=True)


def load_and_preprocess(opts: PipelineOptions) -> Alignment:
    """Stages 1-5 of the reference driver (SpydrPick.cpp:163-333)."""
    mappings = (
        parse_loci_list(opts.mappings_list, opts.input_indexing_base)
        if opts.mappings_list
        else None
    )
    alignment = read_fasta(opts.alignmentfile, mappings=mappings, genome_size=opts.genome_size)
    _log(opts, f'alignment "{alignment.id_string}": '
         f"{alignment.n_samples} samples x {alignment.n_loci} loci")

    if opts.output_alignment:
        out = unique_path(f"{opts.output_dir}/{alignment.id_string}.input.fasta")
        write_fasta(out, alignment)

    if opts.include_list:
        incl = set(parse_loci_list(opts.include_list, opts.input_indexing_base).tolist())
        # match against the loci translation, exactly like the exclude
        # path — in the reference both lists go through the same subset /
        # translation machinery (SpydrPick.cpp:191-231), which matters
        # when --mappings-list changes the position numbering
        keep = np.array(
            [k for k, t in enumerate(alignment.translation) if t in incl], dtype=np.int64
        )
        alignment = alignment.subset(keep)
        _log(opts, f"include list -> {alignment.n_loci} loci")
    if opts.exclude_list:
        excl = set(parse_loci_list(opts.exclude_list, opts.input_indexing_base).tolist())
        # set difference against the current translation (SpydrPick.cpp:228)
        keep = np.array(
            [k for k, t in enumerate(alignment.translation) if t not in excl], dtype=np.int64
        )
        alignment = alignment.subset(keep)
        _log(opts, f"exclude list -> {alignment.n_loci} loci")

    if not opts.no_filter_alignment:
        params = FilterParams(opts.maf_threshold, opts.gap_threshold)
        keep = filter_list(alignment, params)
        _log(opts, f"apply filter rules.. {len(keep)} positions fulfill filter criteria")
        if len(keep) == 0:
            _log(opts, "nothing to do")
            raise SystemExit(0)
        if len(keep) != alignment.n_loci:
            alignment = alignment.subset(keep)
        if opts.verbose:
            print(alignment.statistics_string(), flush=True)

    if opts.sample_list:
        keep_s = parse_loci_list(opts.sample_list, opts.input_indexing_base)
        alignment = alignment.subsample(keep_s)
        _log(opts, f"sample list -> {alignment.n_samples} samples")

    alignment = cache_sample_weights(
        alignment,
        weights_file=opts.sample_weights,
        no_reweighting=opts.no_sample_reweighting,
        threshold=opts.sample_reweighting_threshold,
    )
    _log(opts, f"effective sample size = {alignment.effective_size:.2f}")

    if opts.output_sample_weights:
        with open(unique_path(f"{opts.output_dir}/{alignment.id_string}.weights"), "w") as f:
            write_sample_weights(f, alignment)
    if opts.output_filtered_alignment:
        out = unique_path(f"{opts.output_dir}/{alignment.id_string}.filtered.fasta")
        write_fasta(out, alignment)
    if opts.output_state_frequencies:
        with open(
            unique_path(f"{opts.output_dir}/{alignment.id_string}.state_frequencies"), "w"
        ) as f:
            write_state_frequencies(f, alignment, opts.output_indexing_base)
    if opts.output_sample_distance_matrix:
        with open(
            unique_path(f"{opts.output_dir}/{alignment.id_string}.distance_matrix"), "w"
        ) as f:
            write_distance_matrix(f, hamming_distance_matrix(alignment))
    return alignment


def run_pipeline(opts: PipelineOptions, write_outputs: bool = True,
                 timings: dict | None = None) -> PipelineResult:
    """``timings`` (optional dict) receives per-stage wall seconds —
    preprocess/threshold/sweep/aracne/write — mirroring the reference
    driver's per-stage cputimer prints (src/SpydrPick.cpp:157-161,421);
    the sweep entry nests the engine's itemised phases."""
    import os
    import time as _time

    os.makedirs(opts.output_dir, exist_ok=True)
    tm = timings if timings is not None else {}

    def _stage(name: str, t0: float) -> float:
        t1 = _time.perf_counter()
        tm[name] = t1 - t0
        _log(opts, f"stage time: {name} {tm[name]:.2f}s")
        return t1

    timer = Stopwatch(sys.stdout if opts.verbose else None).start()
    t_st = _time.perf_counter()
    alignment = load_and_preprocess(opts)
    t_st = _stage("preprocess_s", t_st)

    config = EngineConfig(
        tile=opts.tile,
        edge_capacity=opts.edge_capacity,
        store_capacity=opts.store_capacity,
        onehot_storage=opts.onehot_storage,
        rows_per_dispatch=opts.rows_per_dispatch,
        pipeline_depth=opts.pipeline_depth,
        row_window=opts.row_window,
        compaction=opts.compaction,
        mxu_int8=opts.mxu_int8,
        matmul_precision=opts.matmul_precision,
        pseudocount=opts.mi_pseudocount,
        ld_threshold=opts.ld_threshold,
        linear_genome=opts.linear_genome,
        # the output surface reads wog only for outlier rows
        # (SpydrPick.hpp:100-124): lazy-wog mode skips the variant in
        # the hot sweep (single-chip and sharded) and resolves those few
        # edges post-hoc — checkpointed runs included (snapshots persist
        # mi placeholders; candidates resolve after the final colmax)
        wog_fetch="outliers",
        verbose=opts.verbose,
    )
    engine = MIEngine(alignment, config)
    st = engine.statics
    tm["engine"] = {
        "residency": "codes" if st.onehot_codes else "dense",
        "row_window": st.row_window,
        "int8_mode": st.int8_mode,
        "matmul_precision": st.matmul_precision,
        "compaction": st.compaction,
    }
    t_st = _stage("engine_build_s", t_st)

    # 2-D sample-sharded runs: build the mesh + sharded view up front so
    # the threshold tournament and the sweep's auxiliary paths (lazy-wog
    # resolution, overflow re-extraction) all run with the alignment
    # sharded over the samples axis — at the scales that mode exists
    # for, the unsharded pairs kernel cannot hold the alignment on one
    # device
    mesh = None
    view = None
    if opts.sharded and opts.sample_shards > 1:
        import jax

        if len(jax.devices()) > 1:
            from spydrpick_jax.parallel.mesh import (
                ShardedEngineView,
                make_mesh,
            )

            mesh = make_mesh(
                len(jax.devices()) // opts.sample_shards,
                n_samples=opts.sample_shards,
            )
            view = ShardedEngineView(engine, mesh)

    # --- MI save threshold (SpydrPick.cpp:336-364) ---
    mi_threshold = opts.mi_threshold
    if mi_threshold < 0:
        top_pairs = default_mi_values(alignment.n_loci, opts.mi_values)
        _log(opts, f"determine MI threshold for saving approx. {top_pairs} top pairs")
        mi_threshold = determine_mi_threshold(
            view if view is not None else engine,
            top_pairs,
            threshold_pairs=opts.mi_threshold_pairs,
            iterations=opts.mi_threshold_iterations,
            seed=opts.seed,
            verbose_out=sys.stdout if opts.verbose else None,
        )
        _log(opts, f"MI save threshold = {mi_threshold:.6f}")
    else:
        _log(opts, f"user-defined MI save threshold = {mi_threshold:.6f}")
    t_st = _stage("threshold_s", t_st)

    # --- all-pairs sweep (SpydrPick.cpp:384, SpydrPick.hpp:132-168) ---
    def progress(lo, hi, n_new, dt):
        _log(opts, f"  {lo + 1}-{hi} / {alignment.n_loci} ({n_new} new edges) time={dt:.3f}s")

    from spydrpick_jax.utils.profiling import profile_trace

    sweep_phases: dict = {}
    with profile_trace(opts.profile_dir):
        if opts.sharded:
            import jax

            from spydrpick_jax.parallel.mesh import sharded_sweep

            if len(jax.devices()) > 1:
                edges = sharded_sweep(
                    engine, mi_threshold, mesh,
                    progress=progress if opts.verbose else None,
                    checkpoint_path=opts.checkpoint,
                    checkpoint_every=opts.checkpoint_every,
                    view=view,
                    timings=sweep_phases,
                )
            else:
                _log(opts, "only one device visible; using single-device sweep")
                opts.sharded = False
        if not opts.sharded:
            edges = engine.sweep(
                mi_threshold,
                progress=progress if opts.verbose else None,
                checkpoint_path=opts.checkpoint,
                checkpoint_every=opts.checkpoint_every,
                timings=sweep_phases,
            )
    tm["sweep_phases"] = sweep_phases
    t_st = _stage("sweep_s", t_st)
    _log(opts, f"{edges.n_edges} edges stored")

    outlier_thr, extreme_thr = outlier_thresholds(edges.colmax)
    _log(opts, f"outlier threshold={outlier_thr:.6f}")
    _log(opts, f"extreme outlier threshold={extreme_thr:.6f}")

    edges = edges.sort_desc()
    t_st = _stage("sort_s", t_st)

    # --- ARACNE (SpydrPick.cpp:406-421) ---
    if not opts.no_aracne and edges.n_edges:
        _log(opts, "run ARACNE")
        aracne_t: dict = {}
        flags = run_aracne(
            edges.ipos, edges.jpos, edges.mi, opts.aracne_edge_threshold,
            timings=aracne_t,
            verbose_out=sys.stdout if opts.verbose else None,
        )
        tm["aracne_phases"] = aracne_t
    else:
        flags = np.zeros(edges.n_edges, dtype=np.uint8)  # all-zero flag column
    t_st = _stage("aracne_s", t_st)

    result = PipelineResult(
        alignment=alignment,
        edges=edges,
        flags=flags,
        mi_threshold=mi_threshold,
        outlier_threshold=outlier_thr,
        extreme_outlier_threshold=extreme_thr,
    )

    if write_outputs:
        _write_outputs(opts, result)
        _stage("write_s", t_st)

    tm["total_s"] = timer.stop()
    _log(opts, f"analysis completed in {timer}")
    return result


def _write_outputs(opts: PipelineOptions, res: PipelineResult) -> None:
    """Couplings + outliers + outlier-node FASTA (SpydrPick.cpp:423-510)."""
    al = res.alignment
    base = opts.output_indexing_base
    stem = f"{opts.output_dir}/{al.id_string}.{al.size_string()}.spydrpick_couplings"

    couplings_path = unique_path(f"{stem}.{base}-based.{res.edges.n_edges}edges")
    with open(couplings_path, "w") as f:
        write_couplings(f, res.edges, res.flags, al, base, opts.linear_genome)
    res.couplings_path = str(couplings_path)
    _log(opts, f'wrote network ({res.edges.n_edges} edges) to "{couplings_path}"')

    outliers_path = unique_path(f"{stem}.{base}-based.outliers")
    with open(outliers_path, "w") as f:
        n_rows = write_outliers(
            f, res.edges, res.flags, al,
            res.outlier_threshold, res.extreme_outlier_threshold,
            opts.ld_threshold, base, opts.linear_genome,
        )
    res.outliers_path = str(outliers_path)
    _log(opts, f'wrote outlier network ({n_rows} rows) to "{outliers_path}"')

    # outlier-node FASTA (SpydrPick.cpp:488-503)
    mask = res.edges.mi >= res.outlier_threshold
    nodes = np.unique(np.concatenate([res.edges.ipos[mask], res.edges.jpos[mask]]))
    _log(opts, f"extract nodes involved in outlier edges: found {len(nodes)} nodes")
    if 0 < len(nodes) < al.n_loci:
        sub = al.subset(nodes)
        out = unique_path(f"{opts.output_dir}/{al.id_string}.outlier_nodes.fasta")
        write_fasta(out, sub)
