"""Child process for the multi-host test (run by test_multihost.py).

Joins a 2-process ``jax.distributed`` cluster via
:func:`nlsh_jax.parallel.multihost.initialize_from_env` (the env vars
the CLI path reads), then runs a data-parallel-shaped step over the
GLOBAL mesh: each process contributes its local shard of a batch, the
per-shard gradient of a toy quadratic loss is ``pmean``-ed inside
``shard_map`` — the exact collective pattern
:mod:`nlsh_jax.parallel.dp` uses for gradient reduction, here riding
Gloo across processes instead of NCCL.  Results are written as JSON for
the parent to assert on.
"""

import json
import sys
from functools import partial

import numpy as np


def main() -> None:
    out_path = sys.argv[1]
    import jax

    jax.config.update("jax_platforms", "cpu")
    from nlsh_jax.parallel.multihost import initialize_from_env

    initialized = initialize_from_env()

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nlsh_jax.parallel.mesh import make_mesh

    mesh = make_mesh(axis="data")  # spans every process's devices
    sharding = NamedSharding(mesh, P("data"))

    # each process supplies its local rows of the global batch
    local_devs = jax.local_device_count()
    rows_per_dev = 4
    local = np.full(
        (local_devs * rows_per_dev, 2),
        float(jax.process_index() + 1),
        np.float32,
    )
    batch = jax.make_array_from_process_local_data(sharding, local)
    w = jnp.asarray([2.0, -1.0])  # replicated params

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=(P(), P("data")),
             out_specs=(P(), P()))
    def dp_step(w, x):
        def loss(w):
            return jnp.sum((x @ w) ** 2) / x.shape[0]

        # w is replicated (P()): under shard_map's vma system the
        # transpose of its broadcast inserts the gradient psum across
        # the mesh automatically — the returned g is the GLOBAL
        # summed gradient (the dp.py collective), here riding Gloo
        # across the two processes
        _, g = jax.value_and_grad(loss)(w)
        return g, jax.lax.psum(jnp.sum(x), "data")

    grad, total = dp_step(w, batch)
    result = {
        "initialized": bool(initialized),
        "process_index": int(jax.process_index()),
        "n_processes": int(jax.process_count()),
        "n_global_devices": int(mesh.devices.size),
        "grad": np.asarray(grad).tolist(),
        "psum": float(np.asarray(total)),
    }
    with open(out_path, "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    main()
