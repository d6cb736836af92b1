"""Dense CSR bucket table — the inverted-list index.

Device-side replacement for the reference's Python dict of ragged CUDA
tensors (``build_index``, ``nlsh/indexer.py:6-24``).  The dict becomes
three dense arrays:

* ``row_ids``  ``(n,)``     corpus row ids sorted by bucket id
  (a stable argsort — the counting-sort of the build plan)
* ``starts``   ``(n_buckets,)`` offset of each bucket's slice
* ``counts``   ``(n_buckets,)`` bucket occupancy

so a bucket's members are ``row_ids[starts[b] : starts[b] + counts[b]]``
— exactly the dict semantics, but built by one argsort + scatter-add
under jit and queried with dense gathers.  Empty buckets have
``counts == 0`` (the dict simply lacked the key; reference
``indexer.py:67`` used a ``.get`` default).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jnp.ndarray


class BucketTable(NamedTuple):
    """CSR inverted lists over a corpus of ``n`` rows."""

    row_ids: Array  # (n,) int32, corpus rows sorted by bucket id
    starts: Array  # (n_buckets,) int32
    counts: Array  # (n_buckets,) int32

    @property
    def n_rows(self) -> int:
        return self.row_ids.shape[0]

    @property
    def n_buckets(self) -> int:
        return self.starts.shape[0]

    def max_count(self) -> Array:
        return jnp.max(self.counts)

    def n_nonempty(self) -> Array:
        """Number of occupied buckets (reference logs this as
        ``test/n_indexes``, ``trainers/base.py:87``)."""
        return jnp.sum(self.counts > 0)

    def occupancy_std(self) -> Array:
        """Std of occupied-bucket sizes (reference ``test/std_index_rows``,
        ``trainers/base.py:89``)."""
        occ = self.counts > 0
        n = jnp.maximum(jnp.sum(occ), 1)
        c = jnp.where(occ, self.counts, 0).astype(jnp.float32)
        mean = jnp.sum(c) / n
        var = jnp.sum(jnp.where(occ, (c - mean) ** 2, 0.0)) / n
        return jnp.sqrt(var)


@partial(jax.jit, static_argnames=("n_buckets",))
def build_bucket_table(bucket_ids: Array, n_buckets: int) -> BucketTable:
    """Build the CSR table from per-row hard bucket assignments.

    Args:
      bucket_ids: ``(n,)`` int32 in ``[0, n_buckets)`` — the hard hash of
        every corpus row (reference ``Indexer._build_index``,
        ``indexer.py:36-38``).
      n_buckets: static table width (``2**hash_size``).

    Returns:
      :class:`BucketTable`.
    """
    n = bucket_ids.shape[0]
    counts = (
        jnp.zeros((n_buckets,), dtype=jnp.int32)
        .at[bucket_ids]
        .add(1, mode="drop")
    )
    starts = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)[:-1]]
    )
    # Stable sort keeps rows within a bucket in corpus order, matching
    # the reference's insertion-order lists (indexer.py:9-13).
    order = jnp.argsort(bucket_ids, stable=True).astype(jnp.int32)
    return BucketTable(row_ids=order, starts=starts, counts=counts)
