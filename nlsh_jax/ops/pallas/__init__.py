"""Bucket-contiguous serving layouts and their XLA scorers.

No Pallas kernel is left in this package; the module keeps its path so
imports stay stable."""

from nlsh_jax.ops.pallas.query_kernel import (  # noqa: F401
    block_scores,
    serving_layout,
    ServingLayout,
)
