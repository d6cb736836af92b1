"""Tiled brute-force k-nearest-neighbour search on the accelerator.

Batched replacement for the reference GT precompute
(``precompute.py:57-67``: batched GPU distance matrix + ``topk``) and
also the framework's exact-search baseline.  The distance matrix is
never materialised: we scan corpus chunks, computing one
``(query_tile, chunk)`` pairwise block per step (a single matmul)
and folding it into a running top-k.  Memory is
O(query_tile * chunk) regardless of corpus size, so the same code
handles the reference's 1M-row datasets and the 10M+ configs the
reference only stubs (``nlsh/data.py:204-209``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from nlsh_jax.ops import distances as D

Array = jnp.ndarray


def _pad_rows(x: Array, multiple: int) -> tuple[Array, int]:
    n = x.shape[0]
    padded = -(-n // multiple) * multiple
    if padded == n:
        return x, n
    pad = [(0, padded - n)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad), n


@partial(
    jax.jit,
    static_argnames=("k", "metric", "query_tile", "corpus_chunk", "exclude_self",
                     "precision"),
)
def knn(
    queries: Array,
    corpus: Array,
    k: int,
    metric: str = "cosine",
    query_tile: int = 512,
    corpus_chunk: int = 65536,
    exclude_self: bool = False,
    query_ids: Array | None = None,
    precision: str = "highest",
) -> tuple[Array, Array]:
    """Exact k-NN of ``queries`` against ``corpus``.

    Args:
      queries: ``(nq, d)``.
      corpus: ``(n, d)``.
      k: neighbours per query.
      metric: key into :data:`nlsh_jax.ops.distances.METRICS`.
      query_tile: queries per distance block.
      corpus_chunk: corpus rows per distance block (the streaming axis).
      exclude_self: mask candidates whose corpus row id equals the
        query's own id (requires ``query_ids``; the reference instead
        drops top-1 of top-(k+1), ``precompute.py:66``).
      query_ids: ``(nq,)`` global ids of the queries in ``corpus``.
      precision: matmul precision for the distance blocks.  The default
        ``"highest"`` makes GROUND TRUTH exact (true f32, matching the
        reference's precomputed hdf5 GT): a default-precision f32
        matmul may run in TF32 or bf16 passes on an accelerator and
        reorder near-tied neighbours at the rank-k boundary, i.e. the
        "ground truth" itself would be rounded.
        Training-time neighbour mining (:func:`self_knn` callers) may
        pass ``"default"`` — mined positives/negatives don't need
        boundary exactness and the fast path is ~3x cheaper.

    Returns:
      ``(dists, ids)`` of shape ``(nq, k)``, ascending distance.
    """
    pairwise = D.get_metric(metric)["pairwise"]
    nq, d = queries.shape
    n = corpus.shape[0]
    corpus_chunk = min(corpus_chunk, max(k, -(-n // 1)))

    corpus_p, n_real = _pad_rows(corpus, corpus_chunk)
    n_chunks = corpus_p.shape[0] // corpus_chunk

    queries_p, nq_real = _pad_rows(queries, query_tile)
    if query_ids is None:
        query_ids = jnp.full((nq,), -1, dtype=jnp.int32)
    qids_p, _ = _pad_rows(query_ids.astype(jnp.int32), query_tile)
    n_tiles = queries_p.shape[0] // query_tile

    chunk_iota = jnp.arange(corpus_chunk, dtype=jnp.int32)

    def tile_knn(args):
        q, qid = args  # (tile, d), (tile,)

        def body(carry, chunk_idx):
            best_d, best_i = carry
            chunk = jax.lax.dynamic_slice(
                corpus_p, (chunk_idx * corpus_chunk, 0), (corpus_chunk, d)
            )
            with jax.default_matmul_precision(precision):
                dist = pairwise(q, chunk)  # (tile, chunk) — one matmul block
            ids = chunk_idx * corpus_chunk + chunk_iota  # (chunk,)
            invalid = ids >= n_real
            if exclude_self:
                invalid = invalid[None, :] | (ids[None, :] == qid[:, None])
            else:
                invalid = jnp.broadcast_to(invalid[None, :], dist.shape)
            dist = jnp.where(invalid, jnp.inf, dist)

            all_d = jnp.concatenate([best_d, dist], axis=1)
            all_i = jnp.concatenate(
                [best_i, jnp.broadcast_to(ids[None, :], dist.shape).astype(jnp.int32)],
                axis=1,
            )
            neg_top, arg_top = jax.lax.top_k(-all_d, k)
            return (
                (-neg_top, jnp.take_along_axis(all_i, arg_top, axis=1)),
                None,
            )

        init = (
            jnp.full((q.shape[0], k), jnp.inf, dtype=jnp.float32),
            jnp.full((q.shape[0], k), -1, dtype=jnp.int32),
        )
        (best_d, best_i), _ = jax.lax.scan(
            body, init, jnp.arange(n_chunks, dtype=jnp.int32)
        )
        return best_d, best_i

    q_tiles = queries_p.reshape(n_tiles, query_tile, d)
    id_tiles = qids_p.reshape(n_tiles, query_tile)
    dists, ids = jax.lax.map(tile_knn, (q_tiles, id_tiles))
    dists = dists.reshape(-1, k)[:nq_real]
    ids = ids.reshape(-1, k)[:nq_real]
    return dists, ids


def self_knn(
    corpus: Array,
    k: int,
    metric: str = "cosine",
    query_tile: int = 512,
    corpus_chunk: int = 65536,
    precision: str = "highest",
) -> Array:
    """Self k-NN of a corpus, excluding each row itself.

    The JAX equivalent of the reference GT precompute
    (``precompute.py:57-67``, which takes ``topk(k+1)[:, 1:]``); here
    self-exclusion is an explicit id mask, which is robust even when
    duplicate rows make "self" not the unique nearest.
    Returns ``(n, k)`` int32 neighbour ids.
    """
    ids = jnp.arange(corpus.shape[0], dtype=jnp.int32)
    _, nbr = knn(
        corpus,
        corpus,
        k,
        metric=metric,
        query_tile=query_tile,
        corpus_chunk=corpus_chunk,
        exclude_self=True,
        query_ids=ids,
        precision=precision,
    )
    return nbr
