"""Multi-device layer: mesh helpers, data-parallel training, sharded
bucket tables, multi-table ensembles.

The reference has no distributed code at all — its only device
management is ``.cuda()`` placement (survey §2).  This package is the
JAX-idiomatic equivalent: ``jax.sharding.Mesh`` + ``shard_map`` with
XLA collectives (``psum``/``all_gather``, lowered to NCCL on GPUs).
"""

from nlsh_jax.parallel.mesh import make_mesh  # noqa: F401
from nlsh_jax.parallel.sharded_index import ShardedIndexer  # noqa: F401
from nlsh_jax.parallel.multitable import MultiTableIndexer  # noqa: F401
