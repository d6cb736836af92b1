"""Multi-host initialisation for GPU clusters.

One host with several GPUs needs nothing: ``make_mesh`` sees all local
devices, and NVLink joins them all to all.  Across hosts,
``jax.distributed.initialize`` wires the processes together (one
process per host, or per GPU); afterwards ``jax.devices()`` spans every
host and the same ``Mesh``/``shard_map`` code runs unchanged — lay
meshes out so the busy axes (gradient pmean, candidate all_gather) stay
within a host, since the network between hosts is much slower than
NVLink.

The reference has no distributed anything (survey §2); this is the
standard JAX idiom, packaged so CLI users can flip it on via env vars.
"""

from __future__ import annotations

import os


def initialize_from_env() -> bool:
    """Initialise multi-host JAX when the standard env vars are present.

    Reads ``NLSH_COORDINATOR`` (host:port), ``NLSH_NUM_PROCESSES`` and
    ``NLSH_PROCESS_ID`` — or, with ``NLSH_AUTO_DISTRIBUTED=1``, defers
    to JAX's own detection of a cluster manager (e.g. SLURM or Open
    MPI; ``jax.distributed.initialize()`` with no args, which fails
    where no such manager describes the cluster).

    Returns True if distributed mode was initialised.
    """
    import jax

    coordinator = os.environ.get("NLSH_COORDINATOR")
    n_proc = os.environ.get("NLSH_NUM_PROCESSES")
    proc_id = os.environ.get("NLSH_PROCESS_ID")
    if coordinator and n_proc and proc_id:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=int(n_proc),
            process_id=int(proc_id),
        )
        return True
    if os.environ.get("NLSH_AUTO_DISTRIBUTED") == "1":
        jax.distributed.initialize()
        return True
    return False
