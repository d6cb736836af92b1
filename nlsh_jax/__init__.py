"""nlsh_jax — a neural locality-sensitive hashing framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of
stegben/neural-locality-sensitive-hashing (PyTorch + CUDA, single GPU):
learned LSH space partitions trained end-to-end with metric-learning
losses, used to build an inverted-list index queried by
hash -> multi-probe candidate gather -> exact rerank -> top-k.

Key architectural departures from the reference (all accelerator-first):

* The Cython ``hash_codes`` bit-packing kernel (reference
  ``nlsh/utils.pyx:7-32``) becomes a jitted ``codes @ 2**arange``
  matmul with sort-based multi-probe dedupe (:mod:`nlsh_jax.ops.packing`),
  plus a C++ host kernel for host-side paths
  (:mod:`nlsh_jax.native`).
* The Python dict-of-ragged-CUDA-tensors inverted index (reference
  ``nlsh/indexer.py:6-24``) becomes a dense CSR bucket table built by
  argsort/scatter (:mod:`nlsh_jax.index.bucket_table`).
* The per-query Python loop (reference ``nlsh/indexer.py:56-96``)
  becomes one fully batched jitted gather -> mask -> exact rerank ->
  ``lax.top_k`` pipeline (:mod:`nlsh_jax.index.query`).
* ``.cuda()`` placement becomes ``jax.sharding.Mesh`` + ``shard_map``
  (:mod:`nlsh_jax.parallel`): data-parallel hash training with gradient
  ``psum``, corpus-sharded bucket tables with cross-device top-k
  merge, and multi-table ensembles.
"""

__version__ = "0.1.0"

from nlsh_jax import ops, models, index, data, utils  # noqa: F401
