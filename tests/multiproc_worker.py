"""Worker for the 2-process distributed sweep test.

Each process contributes its local CPU devices to a global mesh; the
sharded sweep's collective drain (all_gather) must make the merged
EdgeSet addressable on BOTH processes — the multi-host analogue of the
reference's thread-private ``Graph::join`` (include/mi.hpp:336-361).

usage: python multiproc_worker.py <coordinator> <n_procs> <proc_id> <outdir>
"""

import os
import sys


def main() -> int:
    coordinator, n_procs, proc_id, outdir = sys.argv[1:5]
    n_procs, proc_id = int(n_procs), int(proc_id)

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=2"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=n_procs,
        process_id=proc_id,
    )
    assert jax.process_count() == n_procs
    assert len(jax.devices()) == 2 * n_procs

    import numpy as np

    from spydrpick_jax.core.alignment import Alignment
    from spydrpick_jax.engine.solver import EngineConfig, MIEngine
    from spydrpick_jax.parallel.mesh import make_mesh, sharded_sweep

    rng = np.random.default_rng(7)
    S, L = 24, 96
    codes = rng.integers(0, 5, size=(S, L)).astype(np.uint8)
    al = Alignment(
        codes=codes,
        sample_names=[f"s{i}" for i in range(S)],
        id_string="multiproc",
        translation=np.arange(L, dtype=np.int64),
        n_original_positions=L,
        weights=rng.random(S) + 0.5,
    )
    engine = MIEngine(al, EngineConfig(tile=16, edge_capacity=512,
                                       store_capacity=1 << 16,
                                       rows_per_dispatch=2))
    mesh = make_mesh()  # all 2*n_procs global devices
    edges = sharded_sweep(engine, 0.01, mesh)
    edges = edges.sort_desc()

    # 2-D (rows x samples) mesh across processes: the alignment shards
    # over the samples axis spanning both hosts; per-tile crosstables
    # psum over DCN-in-miniature (the 20k x 1M configuration's shape)
    mesh2 = make_mesh(n_procs, n_samples=2)
    edges2 = sharded_sweep(engine, 0.01, mesh2).sort_desc()

    np.savez(
        os.path.join(outdir, f"proc{proc_id}.npz"),
        ipos=edges.ipos, jpos=edges.jpos, mi=edges.mi,
        mi_wog=edges.mi_wog, colmax=edges.colmax,
        ipos2=edges2.ipos, jpos2=edges2.jpos, mi2=edges2.mi,
    )
    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
