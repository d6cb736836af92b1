"""High-level Indexer: hash a corpus, build the bucket table, answer queries.

JAX counterpart of the reference ``Indexer``
(``nlsh/indexer.py:27-96``).  Building hashes the whole corpus under
jit (the reference batches 4096 rows at a time on the host,
``indexer.py:40-54``) and the per-query Python loop becomes the batched
pipeline in :mod:`nlsh_jax.index.query`.
"""

from __future__ import annotations

from functools import partial


import jax
import jax.numpy as jnp
import numpy as np

from nlsh_jax.index.bucket_table import build_bucket_table
from nlsh_jax.index.query import default_query_chunk, query_bucket_table

Array = jnp.ndarray

#: the engines that serve from the bucket-contiguous layout
SERVING_ENGINES = ("xla", "grouped", "windowed")
#: metrics the layout engines score (others always take ``xla``)
LAYOUT_METRICS = ("cosine", "euclidean", "sq_euclidean")
#: what ``engine="auto"`` resolves to, on every platform
AUTO_ENGINE = "grouped"
#: engine names older saved indexes carry
_LEGACY_ENGINES = {"pallas": "grouped", "pallas-compact": "grouped",
                   "pallas-grouped": "grouped",
                   "pallas-windowed": "windowed"}


def legacy_engine(name: str) -> str:
    """Map an engine name from an older saved index to today's name."""
    return _LEGACY_ENGINES.get(name, name)


def resolve_engine(name: str) -> str:
    """``"auto"`` -> :data:`AUTO_ENGINE`; any other name unchanged."""
    return AUTO_ENGINE if name == "auto" else name


@partial(jax.jit, static_argnames=("hashing", "chunk"))
def hash_corpus(hashing, params, corpus: Array, chunk: int = 65536) -> Array:
    """Hard-hash every corpus row to its bucket id, streaming in chunks
    so activation memory stays bounded for multi-million-row corpora."""
    n, d = corpus.shape
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    corpus_p = jnp.pad(corpus, ((0, pad), (0, 0)))
    codes = jax.lax.map(
        lambda c: hashing.hash_hard(params, c),
        corpus_p.reshape(n_chunks, chunk, d),
    )
    return codes.reshape(-1)[:n]


def hash_corpus_host(hashing, params, corpus_np, chunk: int = 262_144):
    """:func:`hash_corpus` for a HOST-resident numpy corpus: ships one
    chunk to the device at a time, so the device never holds the full
    corpus (at 10M x 96 f32 that is 3.8 GB of device memory the
    serving path never reads again).  Returns numpy ``(n,)`` int32 bucket ids."""
    n, d = corpus_np.shape
    step = jax.jit(hashing.hash_hard)
    out = np.empty((n,), np.int32)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        block = corpus_np[s:e]
        if e - s < chunk:  # one compiled shape for every chunk
            block = np.pad(block, ((0, chunk - (e - s)), (0, 0)))
        out[s:e] = np.asarray(
            step(params, jnp.asarray(block))
        )[: e - s]
    return out


@partial(jax.jit, static_argnames=("hashing", "k", "hash_times",
                                   "probe_mode", "engine"))
def _fused_serve(hashing, params, layout, full_counts, queries, key,
                 k: int, hash_times: int, probe_mode: str, engine: str):
    """Hash + probe + serve in ONE compiled program returning ONE packed
    array ``(nq, k+1)`` of ``[topk_ids, n_candidates]``.

    ``engine`` selects the layout scorer: ``"grouped"`` or
    ``"windowed"``.  One dispatch and one host fetch per query batch,
    instead of a hash dispatch, a serve dispatch and two fetches.
    """
    from nlsh_jax.index.serving import (
        serving_query_grouped, serving_query_windowed,
    )

    probe_ids, probe_valid = hashing.hash(
        params, queries, n_probes=hash_times, key=key, probe_mode=probe_mode
    )
    serve = {"grouped": serving_query_grouped,
             "windowed": serving_query_windowed}[engine]
    ids, _, n_cand = serve(
        layout, queries, probe_ids, probe_valid, full_counts, k=k
    )
    return jnp.concatenate([ids, n_cand[:, None]], axis=1)


@partial(jax.jit, static_argnames=("k", "metric"))
def _merge_fresh(corpus, fresh, queries, base_ids, n_cand,
                 k: int, metric: str):
    """Merge the table's top-k with an exact scan of the fresh-row
    buffer: gather the base winners' vectors, score them and every
    buffered row at HIGHEST precision, take the combined top-k.
    Buffered rows get ids ``n0 + i``; padded base slots (id ``-1``)
    rank last.  Cheap while the buffer is small (k + m candidates per
    query), exact always."""
    from nlsh_jax.ops.distances import METRICS

    pairwise = METRICS[metric]["pairwise"]
    n0 = corpus.shape[0]
    nq = queries.shape[0]
    m = fresh.shape[0]
    safe = jnp.clip(base_ids, 0, n0 - 1)
    base_vecs = corpus[safe]  # (nq, k, d)
    d_base = jax.vmap(lambda q, c: pairwise(q[None], c)[0])(
        queries, base_vecs
    )  # (nq, k)
    d_base = jnp.where(base_ids >= 0, d_base, jnp.inf)
    d_fresh = pairwise(queries, fresh)  # (nq, m)
    all_d = jnp.concatenate([d_base, d_fresh], axis=1)
    fresh_ids = jnp.broadcast_to(
        n0 + jnp.arange(m, dtype=jnp.int32), (nq, m))
    all_ids = jnp.concatenate([base_ids, fresh_ids], axis=1)
    neg_top, arg = jax.lax.top_k(-all_d, k)
    top = jnp.take_along_axis(all_ids, arg, axis=1)
    top = jnp.where(jnp.isfinite(neg_top), top, -1).astype(jnp.int32)
    return top, n_cand + m


@partial(jax.jit, static_argnames=("k",))
def _drop_deleted(ids, deleted_sorted, k: int):
    """Filter tombstoned ids out of an over-fetched top-``k_eff`` list,
    keeping score order (rows are already sorted by score, so a stable
    partition by deleted-ness preserves ranking).  Returns the first
    ``k`` survivors, ``-1``-padded."""
    pos = jnp.clip(
        jnp.searchsorted(deleted_sorted, ids),
        0, deleted_sorted.shape[0] - 1,
    )
    dead = (deleted_sorted[pos] == ids) | (ids < 0)
    order = jnp.argsort(dead, axis=1, stable=True)
    top = jnp.take_along_axis(ids, order[:, :k], axis=1)
    keep = ~jnp.take_along_axis(dead, order[:, :k], axis=1)
    return jnp.where(keep, top, -1)


@partial(jax.jit, static_argnames=("hashing", "k", "hash_times",
                                   "probe_mode", "engine", "repeats"))
def _fused_serve_batched(hashing, params, layout, full_counts, queries, key,
                         k: int, hash_times: int, probe_mode: str,
                         engine: str, repeats: int):
    """``repeats`` full :func:`_fused_serve` batches inside ONE compiled
    program (``lax.map``), returning ``(repeats, nq, k+1)``.

    One dispatch + one fetch amortise the per-call host cost over
    ``repeats * nq`` queries — the batched analogue of a pipelined
    serving loop.

    ``queries`` may be ``(nq, d)`` — each repeat then serves the same
    query set rolled to a different order (and a distinct PRNG fold, so
    the compiler cannot collapse the repeats) — or a FRESH-QUERY pool
    ``(repeats, nq, d)``: every repeat serves distinct queries, the
    strict serving-loop analogue (no repeat re-probes the previous
    repeat's working set).
    """

    if queries.ndim == 3 and queries.shape[0] != repeats:
        raise ValueError(
            f"fresh-query pool has {queries.shape[0]} batches "
            f"but repeats={repeats}"
        )

    def one(i):
        if queries.ndim == 3:
            qs = queries[i]
        else:
            qs = jnp.roll(queries, shift=i * 1009, axis=0)
        return _fused_serve(
            hashing, params, layout, full_counts, qs,
            jax.random.fold_in(key, i), k=k, hash_times=hash_times,
            probe_mode=probe_mode, engine=engine,
        )

    return jax.lax.map(one, jnp.arange(repeats, dtype=jnp.int32))


class Indexer:
    """Build-once, query-many inverted-list index.

    Args:
      hashing: a hashing model (:mod:`nlsh_jax.models.hashings`).
      params: its parameter pytree.
      corpus: ``(n, d)`` float32 candidate vectors (stays on device).
      metric: rerank metric in the original space (the dataset metric,
        reference ``data.distance`` passed at ``trainers/base.py:82-86``).
      probe_budget: max rows gathered per probed bucket; ``None`` uses
        the table's max occupancy (exact reference semantics).
    """

    #: corpora past this row count build the serving layout on the HOST
    #: (numpy permutation), keeping the full-corpus scatter and its
    #: transients off the device (a threshold chosen for a 16 GB
    #: device; ROADMAP lists it for re-measurement on the GPU)
    HOST_LAYOUT_ROWS = 2_000_000

    #: engines: ``xla`` (per-candidate gather + rerank), ``grouped``
    #: (bucket-contiguous layout, queries grouped per bucket block and
    #: scored with one batched matrix product per group), ``windowed``
    #: (dense layout + fixed windows — for tables whose mean bucket is
    #: far below the block size); ``auto`` is :data:`AUTO_ENGINE`
    ENGINES = ("auto",) + SERVING_ENGINES

    def __init__(
        self,
        hashing,
        params,
        corpus: Array,
        metric: str = "cosine",
        probe_budget: int | None = None,
        engine: str = "auto",
        serving_dtype=None,
        layout_mode: str = "auto",
        block_rows: int | None = None,
        table=None,
        int8_scale: str = "per_row",
    ):
        if engine not in self.ENGINES:
            raise ValueError(f"unknown engine {engine!r}")
        if layout_mode not in ("auto", "device", "host"):
            raise ValueError(f"unknown layout_mode {layout_mode!r}")
        if int8_scale not in ("global", "per_row"):
            raise ValueError(f"unknown int8_scale {int8_scale!r}")
        self.hashing = hashing
        self.params = params
        self.corpus = corpus
        self.metric = metric
        self._layout = None
        self.engine = engine
        self.layout_mode = layout_mode
        self.block_rows = block_rows  # None = module default
        # bf16 serving layout halves streamed bytes; rank flips only
        # among candidates whose distances differ below bf16 resolution
        self.serving_dtype = serving_dtype or jnp.float32
        # int8 quantisation granularity: "per_row" (default — each row
        # its own scale; ~half the storage-rounding recall cost at
        # 4 bytes/row) or "global" (one scale, the round-4 behaviour)
        self.int8_scale = int8_scale
        if table is None:
            codes = hash_corpus(hashing, params, corpus)
            table = build_bucket_table(codes, hashing.n_buckets)
        self.table = table
        self._fresh = None  # incremental-insert buffer (see :meth:`add`)
        self._deleted = None  # tombstoned ids (see :meth:`remove`)
        self._budget_user = probe_budget is not None
        if probe_budget is None:
            probe_budget = int(self.table.max_count())
        self.probe_budget = max(int(probe_budget), 1)

    # -- incremental inserts ------------------------------------------------
    def add(self, rows: Array) -> None:
        """Insert new corpus rows WITHOUT rebuilding the table: they go
        to a fresh-row buffer that every query scans exactly and merges
        with the table's top-k (the standard fresh-segment design —
        recall over new rows is 1.0 by construction).  New rows get ids
        ``n0 + i`` in insertion order.  The scan is O(buffer) per query
        batch: call :meth:`compact` to fold a grown buffer into the CSR
        table + serving layout."""
        from nlsh_jax.ops.distances import METRICS

        if self.metric not in METRICS:
            raise ValueError(
                f"incremental inserts need a registered metric, "
                f"got {self.metric!r}"
            )
        rows = jnp.asarray(rows)
        self._fresh = rows if self._fresh is None else jnp.concatenate(
            [self._fresh, rows])

    @property
    def n_fresh(self) -> int:
        return 0 if self._fresh is None else int(self._fresh.shape[0])

    def remove(self, ids) -> None:
        """Tombstone corpus rows (incl. fresh-buffer rows): queries
        over-fetch ``k + next_pow2(#deleted)`` from the engine and drop
        tombstones on device, so ranking stays exact without a rebuild.
        :meth:`compact` rebuilds the table without them (ids stay
        stable; the corpus slots are not reclaimed)."""
        ids = np.atleast_1d(np.asarray(ids, np.int32))
        hi = self.corpus.shape[0] + self.n_fresh
        if ids.size and (ids.min() < 0 or ids.max() >= hi):
            raise ValueError(f"ids out of range [0, {hi})")
        base = self._deleted if self._deleted is not None else \
            np.empty((0,), np.int32)
        self._deleted = np.unique(np.concatenate([base, ids]))

    @property
    def n_deleted(self) -> int:
        return 0 if self._deleted is None else int(self._deleted.shape[0])

    def compact(self) -> None:
        """Fold the fresh-row buffer into the corpus and rebuild the
        CSR table WITHOUT tombstoned rows (they hash to an out-of-range
        sentinel the scatter drops, so no bucket ever lists them).  Ids
        are stable: buffered rows already answered as ``n0 + i``, and
        deleted slots stay allocated (memory is reclaimed only by
        rebuilding the Indexer from a filtered corpus)."""
        if self._fresh is None and self._deleted is None:
            return
        corpus = jnp.asarray(self.corpus)
        if self._fresh is not None:
            corpus = jnp.concatenate([corpus, self._fresh])
        self.corpus = corpus
        self._fresh = None
        self._layout = None
        codes = hash_corpus(self.hashing, self.params, corpus)
        if self._deleted is not None:
            codes = jnp.asarray(codes).at[jnp.asarray(self._deleted)].set(
                self.hashing.n_buckets  # sentinel: dropped by the build
            )
            self._deleted = None
        self.table = build_bucket_table(codes, self.hashing.n_buckets)
        # a user-set budget persists; the default tracks the new table
        if not self._budget_user:
            self.probe_budget = max(int(self.table.max_count()), 1)

    # -- persistence: skip the corpus re-hash on a serving restart ---------
    def save(self, path: str) -> None:
        """Persist the built bucket table + serving knobs (NOT the
        corpus or params — the caller owns those, exactly as with the
        reference's model-only checkpoints).  A 10M-row corpus re-hash
        costs minutes at serving restart; the CSR table is 4 bytes/row.

        The corpus is fingerprinted (head + tail + strided sample,
        :func:`nlsh_jax.utils.fingerprint.corpus_fingerprint`) so
        :meth:`load` refuses a table built over different data —
        including appended/tail-edited corpora a head-only digest
        would accept."""
        from nlsh_jax.utils.fingerprint import corpus_fingerprint

        if self._fresh is not None or self._deleted is not None:
            raise ValueError(
                "pending inserts/deletes: compact() before save() so the "
                "persisted table reflects every update"
            )
        np.savez_compressed(
            path,
            row_ids=np.asarray(self.table.row_ids),
            starts=np.asarray(self.table.starts),
            counts=np.asarray(self.table.counts),
            meta=np.array([
                self.metric, str(self.probe_budget), self._engine,
                jnp.dtype(self.serving_dtype).name,
                str(self.block_rows), self.layout_mode,
                str(self.corpus.shape[0]), str(self.corpus.shape[1]),
                corpus_fingerprint(self.corpus),
                self.int8_scale,
            ]),
        )

    @classmethod
    def load(cls, path: str, hashing, params, corpus: Array) -> "Indexer":
        """Rebuild an :class:`Indexer` from :meth:`save` output without
        re-hashing the corpus.  Raises if ``corpus`` does not match the
        fingerprint the table was built over."""
        from nlsh_jax.index.bucket_table import BucketTable
        from nlsh_jax.utils.fingerprint import check_fingerprint

        with np.load(path, allow_pickle=False) as z:
            meta = [str(v) for v in z["meta"]]
            # round-4 archives predate the int8_scale knob: they served
            # global-scale int8, so load them that way
            int8_scale = meta[9] if len(meta) > 9 else "global"
            (metric, probe_budget, engine, sdtype, block_rows,
             layout_mode, n_rows, dim, digest) = meta[:9]
            if (int(n_rows), int(dim)) != tuple(corpus.shape):
                raise ValueError(
                    f"saved index is over a {n_rows}x{dim} corpus, "
                    f"got {tuple(corpus.shape)}"
                )
            check_fingerprint(digest, corpus)
            table = BucketTable(
                row_ids=jnp.asarray(z["row_ids"]),
                starts=jnp.asarray(z["starts"]),
                counts=jnp.asarray(z["counts"]),
            )
        return cls(
            hashing, params, corpus, metric=metric,
            probe_budget=int(probe_budget), engine=legacy_engine(engine),
            serving_dtype=jnp.dtype(sdtype),
            layout_mode=layout_mode,
            block_rows=None if block_rows == "None" else int(block_rows),
            table=table,
            int8_scale=int8_scale,
        )

    @property
    def engine(self) -> str:
        return self._engine

    @engine.setter
    def engine(self, value: str):
        if value not in self.ENGINES:
            raise ValueError(f"unknown engine {value!r}")
        self._engine = value

    def _layout_signature(self) -> tuple:
        """Everything the cached serving layout depends on.  The layout
        property rebuilds whenever this changes, so mutating ANY serving
        knob post-init (engine, probe_budget, serving_dtype, block_rows,
        layout_mode) invalidates correctly — the windowed engine reads a
        DENSE (8-row-aligned) layout, the grouped engine a block-aligned
        one, and a stale-knobbed layout either raises mid-serve or
        silently serves the wrong alignment/dtype/cap."""
        from nlsh_jax.ops.pallas.query_kernel import _br

        align = (8 if resolve_engine(self.engine) == "windowed"
                 else _br(self.block_rows))
        return (align, jnp.dtype(self.serving_dtype).name,
                int(self.probe_budget), self.block_rows, self.layout_mode,
                self.int8_scale)

    @property
    def layout(self):
        """Lazily-built bucket-contiguous serving layout, rebuilt when
        any serving knob changed since the last build."""
        sig = self._layout_signature()
        if self._layout is None or getattr(self, "_layout_sig", None) != sig:
            from nlsh_jax.ops.pallas.query_kernel import (
                serving_layout, serving_layout_host,
            )

            host = self.layout_mode == "host" or (
                self.layout_mode == "auto"
                and self.corpus.shape[0] >= self.HOST_LAYOUT_ROWS
            )
            build = serving_layout_host if host else serving_layout
            align, dtype_name, cap, block_rows, _, int8_scale = sig
            self._layout = build(
                self.table, self.corpus, metric=self.metric,
                cap=cap, dtype=jnp.dtype(dtype_name),
                block_rows=block_rows, align=align,
                scale_mode=int8_scale,
            )
            self._layout_sig = sig
            # one-per-process bitwise gather canary: the engines'
            # row-gather regroups are silently wrong on a backend that
            # miscompiles that gather class — fail the BUILD, never
            # serve wrong neighbours
            from nlsh_jax.index.canary import check_gather_integrity

            check_gather_integrity()
        return self._layout

    # -- observability (reference trainers/base.py:87-90) ------------------
    def n_buckets_used(self) -> int:
        return int(self.table.n_nonempty())

    def occupancy_std(self) -> float:
        return float(self.table.occupancy_std())

    def query_async(
        self,
        queries: Array,
        k: int = 10,
        hash_times: int = 10,
        key: Array | None = None,
        query_chunk: int | None = None,
        probe_mode: str = "sample",
    ):
        """Dispatch a multi-probe query WITHOUT fetching the result to
        host: returns device array(s) to pass to :meth:`fetch`.  Lets a
        serving loop pipeline batches — the next dispatch overlaps the
        previous batch's device execution and transfer.

        With tombstones pending (:meth:`remove`), the engine over-
        fetches ``k + next_pow2(#deleted)`` and drops tombstones on
        device — ranking stays exact; ``n_candidates`` still counts
        tombstoned candidates until :meth:`compact`."""
        m = self.n_deleted
        if m == 0:
            return self._query_async_raw(queries, k, hash_times, key,
                                         query_chunk, probe_mode)
        k_eff = k + (1 << (m - 1).bit_length())  # pow2: bounded recompiles
        res = self._query_async_raw(queries, k_eff, hash_times, key,
                                    query_chunk, probe_mode)
        dead = jnp.asarray(self._deleted)
        if isinstance(res, tuple):
            ids, n_cand = res
            return _drop_deleted(ids, dead, k=k), n_cand
        top = _drop_deleted(res[:, :-1], dead, k=k)
        return jnp.concatenate([top, res[:, -1:]], axis=1)

    def _query_async_raw(
        self,
        queries: Array,
        k: int = 10,
        hash_times: int = 10,
        key: Array | None = None,
        query_chunk: int | None = None,
        probe_mode: str = "sample",
    ):
        if key is None:
            key = jax.random.PRNGKey(0)
        engine = resolve_engine(self.engine)
        if engine != "xla" and self.metric in LAYOUT_METRICS:
            return self._with_fresh(_fused_serve(
                self.hashing, self.params, self.layout, self.table.counts,
                queries, key, k=k, hash_times=hash_times,
                probe_mode=probe_mode, engine=engine,
            ), queries, k)
        probe_ids, probe_valid = self.hashing.hash(
            self.params, queries, n_probes=hash_times, key=key,
            probe_mode=probe_mode,
        )
        if query_chunk is None:
            query_chunk = default_query_chunk(
                hash_times, self.probe_budget, queries.shape[1]
            )
        topk_ids, _, n_cand = query_bucket_table(
            self.table,
            self.corpus,
            queries,
            probe_ids,
            probe_valid,
            k=k,
            probe_budget=self.probe_budget,
            metric=self.metric,
            query_chunk=query_chunk,
        )
        return self._with_fresh((topk_ids, n_cand), queries, k)

    def _with_fresh(self, result, queries, k: int):
        """Merge a query result with the fresh-row buffer (no-op when
        empty).  Preserves the result's packed/tuple convention so
        :meth:`fetch` is unchanged."""
        if self._fresh is None:
            return result
        corpus = jnp.asarray(self.corpus)
        queries = jnp.asarray(queries)
        if isinstance(result, tuple):
            ids, n_cand = result
            return _merge_fresh(corpus, self._fresh, queries,
                                ids, n_cand, k=k, metric=self.metric)
        top, nc = _merge_fresh(corpus, self._fresh, queries,
                               result[:, :-1], result[:, -1],
                               k=k, metric=self.metric)
        return jnp.concatenate([top, nc[:, None]], axis=1)

    @staticmethod
    def fetch(result) -> tuple[np.ndarray, np.ndarray]:
        """Fetch a :meth:`query_async` result to host:
        ``(topk_ids (nq, k), n_candidates (nq,))`` numpy arrays."""
        if isinstance(result, tuple):
            ids, n_cand = result
            return np.asarray(ids), np.asarray(n_cand)
        packed = np.asarray(result)  # ONE host fetch of (nq, k+1)
        return packed[:, :-1], packed[:, -1]

    def query(
        self,
        queries: Array,
        k: int = 10,
        hash_times: int = 10,
        key: Array | None = None,
        query_chunk: int | None = None,
        probe_mode: str = "sample",
    ) -> tuple[np.ndarray, np.ndarray]:
        """Multi-probe query (reference ``Indexer.query``,
        ``indexer.py:56-96``; defaults k=10, hash_times=10 match).

        Returns ``(topk_ids (nq, k), n_candidates (nq,))`` as numpy.
        """
        return self.fetch(self.query_async(
            queries, k=k, hash_times=hash_times, key=key,
            query_chunk=query_chunk, probe_mode=probe_mode,
        ))
