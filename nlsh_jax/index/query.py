"""Batched index query: probe gather -> mask -> exact rerank -> top-k.

Batched replacement for the reference's per-query Python loop
(``Indexer.query``, ``nlsh/indexer.py:56-96``: dict lookups +
``index_select`` into a reusable buffer + ``topk`` per query).  Here the
whole validation set is answered by one jitted pipeline:

1. probed bucket ids -> ``starts``/``counts`` lookups (dense gathers),
2. candidate row ids ``row_ids[start + iota]`` masked by occupancy and
   a static per-probe ``probe_budget``,
3. candidate vectors gathered from the corpus in device memory,
4. exact distance in the original space,
5. masked ``lax.top_k`` rerank.

Queries are processed in fixed-size chunks under ``lax.map`` so the
transient gather buffer is O(chunk * n_probes * budget * dim) no matter
how many queries arrive.

Semantics vs the reference:

* a probed bucket's candidates are gathered up to ``probe_budget`` rows;
  with ``probe_budget >= max bucket count`` the candidate set is
  *identical* to the reference dict walk (buckets partition the corpus
  under hard hashing, so cross-probe duplicates cannot occur once probe
  ids are deduped).
* ``n_candidates`` counts full bucket occupancies of deduped probes —
  the reference's ``query_size`` axis (``indexer.py:70-78``) — even if
  the budget truncates the reranked set.
* under-full results are padded with ``-1`` ids / ``+inf`` distances
  (never matching ground truth) instead of the reference's silent
  exception fallback that drops candidates (``indexer.py:92-93``, a
  known wart).

The kernel also returns the reranked top-k *distances* so sharded
deployments can merge per-shard results with a cross-chip top-k
(:mod:`nlsh_jax.parallel.sharded_index`), and accepts ``n_valid_rows``
so corpora padded up to a shard multiple exclude their padding rows.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from nlsh_jax.index.bucket_table import BucketTable
from nlsh_jax.ops import distances as D

Array = jnp.ndarray

# Transient candidate-gather buffer target, used to pick the query chunk.
_GATHER_BUDGET_BYTES = 256 * 1024 * 1024


def default_query_chunk(n_probes: int, probe_budget: int, dim: int) -> int:
    per_query = max(n_probes * probe_budget * dim * 4, 1)
    chunk = _GATHER_BUDGET_BYTES // per_query
    return int(max(8, min(1024, chunk)))


@partial(jax.jit, static_argnames=("k", "probe_budget", "metric", "query_chunk"))
def query_bucket_table(
    table: BucketTable,
    corpus: Array,
    queries: Array,
    probe_ids: Array,
    probe_valid: Array,
    k: int,
    probe_budget: int,
    metric: str = "cosine",
    query_chunk: int = 256,
    n_valid_rows: Array | None = None,
) -> tuple[Array, Array, Array]:
    """Answer ``queries`` against the indexed ``corpus``.

    Args:
      table: CSR bucket table over ``corpus``.
      corpus: ``(n, d)`` float32.
      queries: ``(nq, d)`` float32.
      probe_ids: ``(nq, n_probes)`` int32 bucket ids (sorted, deduped —
        the output of ``hashing.hash``).
      probe_valid: ``(nq, n_probes)`` bool dedupe mask.
      k: neighbours to return.
      probe_budget: static max rows gathered per probed bucket; set to
        the table's max occupancy for exact reference semantics.
      metric: rerank metric name (original vector space).
      query_chunk: queries per pipeline step.
      n_valid_rows: optional scalar — corpus rows >= this are padding
        and never returned (sharded corpora pad to a shard multiple).

    Returns:
      ``topk_ids``: ``(nq, k)`` int32 corpus rows, ascending distance,
      ``-1``-padded when a query has fewer than ``k`` candidates.
      ``topk_dists``: ``(nq, k)`` float32, ``+inf`` on padding.
      ``n_candidates``: ``(nq,)`` int32 — summed occupancy of probed
      buckets (the reference ``query_size`` axis).
    """
    rowwise = D.get_metric(metric)["rowwise"]
    nq, dim = queries.shape
    n_probes = probe_ids.shape[1]
    n_rows = table.n_rows
    if n_valid_rows is None:
        n_valid_rows = jnp.asarray(n_rows, jnp.int32)

    # Pad the query axis to a whole number of chunks.
    n_chunks = -(-nq // query_chunk)
    pad = n_chunks * query_chunk - nq
    queries_p = jnp.pad(queries, ((0, pad), (0, 0)))
    ids_p = jnp.pad(probe_ids, ((0, pad), (0, 0)))
    valid_p = jnp.pad(probe_valid, ((0, pad), (0, 0)))

    offs = jnp.arange(probe_budget, dtype=jnp.int32)

    def chunk_fn(args):
        q, pid, pvalid = args  # (c, d), (c, P), (c, P)
        safe_pid = jnp.clip(pid, 0, table.n_buckets - 1)
        counts = jnp.where(pvalid, table.counts[safe_pid], 0)  # (c, P)
        starts = table.starts[safe_pid]  # (c, P)

        cand_pos = starts[:, :, None] + offs  # (c, P, B)
        cand_valid = offs[None, None, :] < counts[:, :, None]
        cand_rows = table.row_ids[jnp.clip(cand_pos, 0, n_rows - 1)]
        cand_rows = cand_rows.reshape(q.shape[0], n_probes * probe_budget)
        cand_valid = cand_valid.reshape(q.shape[0], n_probes * probe_budget)
        cand_valid &= cand_rows < n_valid_rows

        cand_vecs = jnp.take(corpus, cand_rows, axis=0)  # (c, C, d) device gather
        dist = rowwise(q[:, None, :], cand_vecs)  # (c, C)
        dist = jnp.where(cand_valid, dist, jnp.inf)

        neg_top, arg_top = jax.lax.top_k(-dist, k)
        top_rows = jnp.take_along_axis(cand_rows, arg_top, axis=1)
        top_rows = jnp.where(jnp.isfinite(neg_top), top_rows, -1).astype(jnp.int32)
        return top_rows, -neg_top, jnp.sum(counts, axis=1, dtype=jnp.int32)

    q_c = queries_p.reshape(n_chunks, query_chunk, dim)
    ids_c = ids_p.reshape(n_chunks, query_chunk, n_probes)
    valid_c = valid_p.reshape(n_chunks, query_chunk, n_probes)
    topk_ids, topk_dists, n_cand = jax.lax.map(chunk_fn, (q_c, ids_c, valid_c))
    return (
        topk_ids.reshape(-1, k)[:nq],
        topk_dists.reshape(-1, k)[:nq],
        n_cand.reshape(-1)[:nq],
    )
