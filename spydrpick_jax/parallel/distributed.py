"""Multi-host startup.

The reference is single-process (SURVEY §5: "MPI" exists only in a help
string).  This rebuild scales across hosts with JAX's standard
multi-controller model: every host runs the same program,
``jax.distributed.initialize`` wires the cluster, and the sharded sweep
(parallel/mesh.py) runs over the global device mesh — XLA routes the
collectives (colmax pmax, store gathers) over the links within a host
and the network between hosts.

Per-host work division falls out of the row sharding: each step's
row_starts batch spans all global devices; hosts only materialise
their addressable shards.
"""

from __future__ import annotations

import jax


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> dict:
    """Initialise the JAX distributed runtime (no-op if single process).

    ``jax.distributed.initialize`` auto-detects its arguments only
    under cluster managers it knows; elsewhere pass the coordinator's
    ``host:port``, the process count and this process's id explicitly.
    Returns a summary dict.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    elif coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address)
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
