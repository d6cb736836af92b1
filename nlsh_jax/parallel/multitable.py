"""Multi-table (L hashings) ensembles — classic LSH boosting, learned.

No reference counterpart (the reference trains exactly one hashing);
this is the idiomatic multi-table extension: ``L`` independently
initialised hashings share one architecture, their parameters stacked
on a leading table axis so every per-table computation is a ``vmap``.
A query probes all tables, the candidate union is deduped by row id
(sort + neighbour mask — no host sets), reranked exactly once, and
top-k'd.

With a mesh, tables are sharded across devices (axis ``"table"``):
each device reranks its local tables' candidates and per-device top-k
lists are merged with duplicate-id suppression.  The merged
*ids* are exact (equal to the unsharded ensemble); the reported
``n_candidates`` is the psum of per-device distinct counts and is
therefore an upper bound when the same corpus row is a candidate on
several devices — exchanging full candidate sets to dedupe across
chips would cost more traffic than the rerank it measures.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nlsh_jax.index.bucket_table import build_bucket_table
from nlsh_jax.index.indexer import (
    LAYOUT_METRICS, SERVING_ENGINES, hash_corpus, hash_corpus_host,
    legacy_engine,
)
from nlsh_jax.ops import distances as D

shard_map = jax.shard_map

Array = jnp.ndarray

_GATHER_BUDGET_BYTES = 256 * 1024 * 1024

#: what ``engine="auto"`` resolves to for an ensemble, on every platform
#: (ensemble buckets are far below the block size: the dense-window
#: engine's design point)
AUTO_ENGINE = "windowed"


def init_multi_table(hashing, n_tables: int, key) -> dict:
    """Stacked params for ``n_tables`` independent hashings:
    every leaf gains a leading ``(L, ...)`` axis."""
    keys = jax.random.split(key, n_tables)
    return jax.vmap(hashing.init)(keys)


def _mt_query_chunk(L: int, n_probes: int, budget: int, dim: int) -> int:
    per_query = max(L * n_probes * budget * dim * 4, 1)
    return int(max(4, min(512, _GATHER_BUDGET_BYTES // per_query)))


@partial(jax.jit, static_argnames=("hashing", "k", "hash_times", "engine",
                                   "n_rows", "g_override", "probe_mode"))
def _fused_mt_serve(hashing, stacked_params, layout, queries, key,
                    k: int, hash_times: int, engine: str, n_rows: int,
                    g_override: int | None = None,
                    probe_mode: str = "sample"):
    """Probe-hash all L tables + stacked serve + duplicate collapse +
    pack ``[topk_ids | n_cand]`` in ONE compiled program: one dispatch
    and one fetch instead of a dispatch per glue op.  Same design as
    the single-table ``_fused_serve`` (`index/indexer.py`).  Only usable
    when the group bound is static (no host-sync bound)."""
    from nlsh_jax.index.serving import (
        serving_query_grouped, serving_query_windowed,
    )

    L = jax.tree.leaves(stacked_params)[0].shape[0]
    nb = hashing.n_buckets
    keys = jax.random.split(key, L)
    if hash_times == 1:
        pids, pvalid = jax.vmap(
            lambda p: hashing.hash(p, queries, n_probes=1)
        )(stacked_params)
    else:
        pids, pvalid = jax.vmap(
            lambda p, k_: hashing.hash(p, queries, n_probes=hash_times,
                                       key=k_, probe_mode=probe_mode)
        )(stacked_params, keys)
    nq = queries.shape[0]
    gp = (jnp.moveaxis(pids, 0, 1)
          + (jnp.arange(L, dtype=jnp.int32) * nb)[None, :, None]
          ).reshape(nq, L * pids.shape[-1])
    gv = jnp.moveaxis(pvalid, 0, 1).reshape(nq, L * pids.shape[-1])
    k_fetch = min(k * L, pids.shape[-1] * L * layout.cap)
    if engine == "windowed":
        if g_override is not None:
            # calibrated group bound, GUARDED: prep drops overflow
            # groups silently, so compute the exact needed count on
            # device (one cheap scatter-add) and lax.cond to the
            # static-bound program when a batch exceeds calibration —
            # no host sync, no silent candidate loss
            import os

            from nlsh_jax.ops.pallas.query_kernel import (
                GROUP_W, windowed_needed_groups,
            )

            br = layout.br
            needed = windowed_needed_groups(
                layout.starts, layout.counts, gp, gv,
                jnp.asarray(layout.cap, jnp.int32),
                max_sub=layout.cap // br + 1,
                group_q=int(os.environ.get("NLSH_GROUP_Q", GROUP_W)),
                n_windows=-(-layout.data.shape[0] // br) + 1,
                block_rows=br,
            )
            ids, scores, n_cand = jax.lax.cond(
                needed <= g_override,
                lambda: serving_query_windowed(
                    layout, queries, gp, gv, layout.counts, k=k_fetch,
                    row_k=k, g_total_override=g_override,
                ),
                lambda: serving_query_windowed(
                    layout, queries, gp, gv, layout.counts, k=k_fetch,
                    row_k=k,
                ),
            )
        else:
            ids, scores, n_cand = serving_query_windowed(
                layout, queries, gp, gv, layout.counts, k=k_fetch, row_k=k,
            )
    else:
        ids, scores, n_cand = serving_query_grouped(
            layout, queries, gp, gv, layout.counts, k=k_fetch, row_k=k,
            g_total_override=g_override,
        )
    merged, _ = MultiTableIndexer._dedupe_topk(ids, scores, k, n_rows)
    return jnp.concatenate([merged, n_cand[:, None]], axis=1)


@partial(jax.jit, static_argnames=("hashing", "k", "hash_times", "engine",
                                   "n_rows", "g_override", "repeats",
                                   "probe_mode"))
def _fused_mt_serve_batched(hashing, stacked_params, layout, queries, key,
                            k: int, hash_times: int, engine: str, n_rows: int,
                            repeats: int, g_override: int | None = None,
                            probe_mode: str = "sample"):
    """``repeats`` full :func:`_fused_mt_serve` batches inside ONE
    compiled program (``lax.map``), returning ``(repeats, nq, k+1)`` —
    the multi-table analogue of the single-table
    ``_fused_serve_batched`` (`index/indexer.py`): one dispatch + one
    fetch amortise the per-call host cost over ``repeats * nq``
    queries.  ``queries`` may be ``(nq, d)`` (each repeat serves the
    same set rolled to a different order, distinct PRNG fold so the
    compiler cannot collapse the repeats) or a FRESH-QUERY pool
    ``(repeats, nq, d)`` — the strict serving-loop analogue."""

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
        return _fused_mt_serve(
            hashing, stacked_params, layout, qs, jax.random.fold_in(key, i),
            k=k, hash_times=hash_times, engine=engine, n_rows=n_rows,
            g_override=g_override, probe_mode=probe_mode,
        )

    return jax.lax.map(one, jnp.arange(repeats, dtype=jnp.int32))


class MultiTableIndexer:
    """L learned hash tables over one corpus (BASELINE config 4).

    Args:
      hashing: the shared hashing architecture.
      stacked_params: pytree with leading table axis (L, ...), e.g. from
        :func:`init_multi_table` or a multi-table trainer.
      corpus: ``(n, d)``.
      mesh: optional 1-D mesh to shard the table axis across devices
        (requires L divisible by the mesh size).
    """

    #: corpora past this row count build the stacked serving layout on
    #: the HOST (numpy permutation per table), keeping the traced
    #: builder's scatter transients off the device (same threshold as
    #: ``Indexer.HOST_LAYOUT_ROWS``, chosen for a 16 GB device)
    HOST_LAYOUT_ROWS = 2_000_000

    def __init__(self, hashing, stacked_params, corpus, metric="cosine",
                 probe_budget: int | None = None, mesh: Mesh | None = None,
                 engine: str = "auto", serving_dtype=None,
                 block_rows: int | None = None, tables=None,
                 int8_scale: str = "per_row"):
        self.block_rows = block_rows  # None = module default
        self.hashing = hashing
        self.params = stacked_params
        # host copy (when the caller has one): the >=2M-row stacked
        # layout builds on the HOST, so the traced builder's per-table
        # scatter transients never land on the device
        self._corpus_host = corpus if isinstance(corpus, np.ndarray) \
            else None
        # LAZY corpus: past the host-layout threshold the serving path
        # never reads the raw corpus from the device (the stacked layout
        # holds the data; dedupe is id-only), so a host-given 10M x 96
        # corpus stays in host memory — 3.84 GB of device memory.  Table
        # hashing streams chunks (hash_corpus_host); the XLA fallback
        # path uploads on use.
        if (self._corpus_host is not None
                and corpus.shape[0] >= self.HOST_LAYOUT_ROWS):
            self.corpus = self._corpus_host
        else:
            self.corpus = jnp.asarray(corpus)
        self.metric = metric
        self.mesh = mesh
        self.engine = engine  # setter: validates, resolves "auto"
        self.serving_dtype = serving_dtype or jnp.float32
        if int8_scale not in ("global", "per_row"):
            raise ValueError(f"unknown int8_scale {int8_scale!r}")
        # int8 works for cosine AND euclidean since round 5: scores come
        # out of the engines in dequantised units under either scale mode
        self.int8_scale = int8_scale
        self._query_cache: dict = {}
        self._stacked = None
        self._g_cal: int | None = None  # set by :meth:`calibrate`
        self.n_tables = jax.tree.leaves(stacked_params)[0].shape[0]
        if mesh is not None:
            (self.axis,) = mesh.axis_names
            if self.n_tables % mesh.devices.size != 0:
                raise ValueError(
                    f"n_tables {self.n_tables} not divisible by mesh size "
                    f"{mesh.devices.size}"
                )

        if tables is not None:
            # persistence path (:meth:`load`): stacked CSR provided
            self.row_ids = jnp.asarray(tables[0])
            self.starts = jnp.asarray(tables[1])
            self.counts = jnp.asarray(tables[2])
        else:
            # (L, n) hard codes -> L CSR tables, stacked.  SEQUENTIAL
            # over tables: a vmapped build holds L concurrent 10M-row
            # stable sorts at once; one table's sort transient at a time
            # keeps the peak small, and the module-level jitted builder
            # compiles once for all L tables AND all indexer instances
            # in the process.
            lazy = isinstance(self.corpus, np.ndarray)
            tabs = []
            for li in range(self.n_tables):
                p_l = jax.tree.map(lambda x, li=li: x[li], stacked_params)
                codes = (
                    jnp.asarray(hash_corpus_host(hashing, p_l, self.corpus))
                    if lazy else
                    hash_corpus(hashing, p_l, self.corpus)
                )
                t_l = build_bucket_table(codes, hashing.n_buckets)
                tabs.append(jax.block_until_ready(t_l))
            self.row_ids = jnp.stack([t.row_ids for t in tabs])
            self.starts = jnp.stack([t.starts for t in tabs])
            self.counts = jnp.stack([t.counts for t in tabs])
            del tabs  # (L, n), (L, nb), (L, nb)
        if mesh is not None:
            spec = NamedSharding(mesh, P(self.axis, None))
            self.row_ids = jax.device_put(self.row_ids, spec)
            self.starts = jax.device_put(self.starts, spec)
            self.counts = jax.device_put(self.counts, spec)
            self.params = jax.device_put(
                stacked_params,
                NamedSharding(mesh, P(self.axis)),
            )
        if probe_budget is None:
            probe_budget = int(jnp.max(self.counts))
        self.probe_budget = max(int(probe_budget), 1)

    @property
    def engine(self) -> str:
        return self._engine

    @engine.setter
    def engine(self, value: str):
        """Validates, resolves ``"auto"``, and drops the stacked layout
        (whose start alignment is engine-specific: grouped=block_rows,
        windowed=8) plus the windowed calibration bound on an engine
        change — a stale-aligned stack would silently serve the new
        engine without its layout's design point."""
        if value != "auto" and value not in SERVING_ENGINES:
            raise ValueError(f"unknown engine {value!r}")
        if value == "auto":
            value = AUTO_ENGINE if self.metric in LAYOUT_METRICS else "xla"
        old = getattr(self, "_engine", None)
        self._engine = value
        if old is not None and value != old:
            self._stacked = None
            self._g_cal = None

    # -- persistence --------------------------------------------------------
    def save(self, path: str) -> None:
        """Persist the L stacked CSR tables + serving knobs (NOT the
        corpus or stacked params — the caller owns those).  Restarting
        an L=8 ensemble re-hashes the corpus 8 times otherwise."""
        from nlsh_jax.utils.fingerprint import corpus_fingerprint

        np.savez_compressed(
            path,
            row_ids=np.asarray(self.row_ids),
            starts=np.asarray(self.starts),
            counts=np.asarray(self.counts),
            meta=np.array([
                self.metric, str(self.probe_budget), self._engine,
                jnp.dtype(self.serving_dtype).name,
                str(self.block_rows), str(self.n_tables),
                str(self.corpus.shape[0]),
                corpus_fingerprint(self.corpus),
                self.int8_scale,
            ]),
        )

    @classmethod
    def load(cls, path: str, hashing, stacked_params, corpus,
             mesh: Mesh | None = None) -> "MultiTableIndexer":
        """Rebuild from :meth:`save` output without re-hashing; refuses
        a different corpus, table count, or incompatible mesh.  The
        fingerprint samples head + tail + strided middle rows
        (:func:`nlsh_jax.utils.fingerprint.corpus_fingerprint`)."""
        from nlsh_jax.utils.fingerprint import check_fingerprint

        with np.load(path, allow_pickle=False) as z:
            meta = [str(v) for v in z["meta"]]
            # round-4 archives predate int8_scale: they were global
            int8_scale = meta[8] if len(meta) > 8 else "global"
            (metric, probe_budget, engine, sdtype, block_rows,
             n_tables, n_rows, digest) = meta[:8]
            L = jax.tree.leaves(stacked_params)[0].shape[0]
            if int(n_tables) != L:
                raise ValueError(
                    f"saved ensemble has {n_tables} tables, params have {L}"
                )
            if int(n_rows) != corpus.shape[0]:
                raise ValueError(
                    f"saved index is over {n_rows} corpus rows, got "
                    f"{corpus.shape[0]}"
                )
            check_fingerprint(digest, corpus)
            tables = (z["row_ids"], z["starts"], z["counts"])
            return cls(
                hashing, stacked_params, corpus, metric=metric,
                probe_budget=int(probe_budget), mesh=mesh,
                engine=legacy_engine(engine),
                serving_dtype=jnp.dtype(sdtype),
                block_rows=None if block_rows == "None" else int(block_rows),
                tables=tables,
                int8_scale=int8_scale,
            )

    # -- core rerank over the union of all tables' candidates ---------------

    @staticmethod
    def _gather_rerank(row_ids, starts, counts, corpus, q, pids, pvalid,
                       k, budget, metric, n_rows):
        """One query chunk against a stack of tables.

        row_ids (Lc, n), starts/counts (Lc, nb); q (c, d);
        pids/pvalid (Lc, c, P).  Returns (top_ids, top_d, n_distinct).
        """
        rowwise = D.get_metric(metric)["rowwise"]
        Lc, c, n_probes = pids.shape
        offs = jnp.arange(budget, dtype=jnp.int32)

        def per_table(rids, st, ct, pid, pv):
            safe = jnp.clip(pid, 0, st.shape[0] - 1)
            cnt = jnp.where(pv, ct[safe], 0)  # (c, P)
            pos = st[safe][:, :, None] + offs  # (c, P, B)
            valid = offs[None, None, :] < cnt[:, :, None]
            rows = rids[jnp.clip(pos, 0, n_rows - 1)]
            return rows.reshape(c, -1), valid.reshape(c, -1)

        rows, valid = jax.vmap(per_table)(row_ids, starts, counts, pids, pvalid)
        rows = jnp.moveaxis(rows, 0, 1).reshape(c, -1)  # (c, Lc*P*B)
        valid = jnp.moveaxis(valid, 0, 1).reshape(c, -1)

        # dedupe the union by row id: invalid -> sentinel, sort, mask dups
        sentinel = jnp.int32(n_rows)
        keyed = jnp.where(valid, rows, sentinel)
        keyed = jnp.sort(keyed, axis=1)
        first = jnp.ones_like(keyed[:, :1], dtype=bool)
        uniq = jnp.concatenate([first, keyed[:, 1:] != keyed[:, :-1]], axis=1)
        uniq &= keyed < sentinel
        n_distinct = jnp.sum(uniq, axis=1, dtype=jnp.int32)

        cand = jnp.clip(keyed, 0, n_rows - 1)
        vecs = jnp.take(corpus, cand, axis=0)  # (c, C, d)
        dist = rowwise(q[:, None, :], vecs)
        dist = jnp.where(uniq, dist, jnp.inf)
        neg_top, arg = jax.lax.top_k(-dist, k)
        top = jnp.take_along_axis(cand, arg, axis=1)
        top = jnp.where(jnp.isfinite(neg_top), top, -1).astype(jnp.int32)
        return top, -neg_top, n_distinct

    def _query_fn(self, k: int, hash_times: int, query_chunk: int):
        # probe_budget is closed over below — key on it so mutating it
        # post-init reaches the compiled path
        cache_key = (k, hash_times, query_chunk, self.probe_budget)
        if cache_key in self._query_cache:
            return self._query_cache[cache_key]

        hashing, metric, budget = self.hashing, self.metric, self.probe_budget
        n_rows = self.corpus.shape[0]
        gather_rerank = self._gather_rerank

        def chunked(row_ids, starts, counts, corpus, queries, pids, pvalid,
                    merge_axis=None):
            nq, dim = queries.shape
            n_chunks = -(-nq // query_chunk)
            pad = n_chunks * query_chunk - nq
            q_p = jnp.pad(queries, ((0, pad), (0, 0)))
            pid_p = jnp.pad(pids, ((0, 0), (0, pad), (0, 0)))
            pv_p = jnp.pad(pvalid, ((0, 0), (0, pad), (0, 0)))

            def f(args):
                q, pid, pv = args
                top, topd, nd = gather_rerank(
                    row_ids, starts, counts, corpus, q, pid, pv,
                    k, budget, metric, n_rows,
                )
                if merge_axis is not None:
                    # tables sharded: merge per-device top-k with dup-id
                    # suppression (same row can win on several devices)
                    all_d = jax.lax.all_gather(topd, merge_axis)
                    all_i = jax.lax.all_gather(top, merge_axis)
                    c = q.shape[0]
                    all_d = jnp.moveaxis(all_d, 0, 1).reshape(c, -1)
                    all_i = jnp.moveaxis(all_i, 0, 1).reshape(c, -1)
                    order = jnp.argsort(
                        jnp.where(all_i < 0, jnp.int32(n_rows), all_i), axis=1
                    )
                    si = jnp.take_along_axis(all_i, order, axis=1)
                    sd = jnp.take_along_axis(all_d, order, axis=1)
                    dup = jnp.concatenate(
                        [jnp.zeros_like(si[:, :1], bool),
                         si[:, 1:] == si[:, :-1]], axis=1,
                    )
                    sd = jnp.where(dup | (si < 0), jnp.inf, sd)
                    neg, arg = jax.lax.top_k(-sd, k)
                    top = jnp.where(
                        jnp.isfinite(neg),
                        jnp.take_along_axis(si, arg, axis=1), -1,
                    ).astype(jnp.int32)
                    topd = -neg
                    nd = jax.lax.psum(nd, merge_axis)
                return top, topd, nd

            L = pid_p.shape[0]
            n_pr = pid_p.shape[-1]
            top, topd, nd = jax.lax.map(
                f,
                (q_p.reshape(n_chunks, query_chunk, dim),
                 pid_p.reshape(L, n_chunks, query_chunk, n_pr).transpose(1, 0, 2, 3),
                 pv_p.reshape(L, n_chunks, query_chunk, n_pr).transpose(1, 0, 2, 3)),
            )
            return (
                top.reshape(-1, k)[:nq],
                topd.reshape(-1, k)[:nq],
                nd.reshape(-1)[:nq],
            )

        if self.mesh is None:
            def q_fn(row_ids, starts, counts, corpus, queries, pids, pvalid):
                return chunked(row_ids, starts, counts, corpus, queries,
                               pids, pvalid)
            fn = jax.jit(q_fn)
        else:
            axis = self.axis

            @jax.jit
            @partial(
                shard_map,
                mesh=self.mesh,
                in_specs=(P(axis), P(axis, None), P(axis, None), P(),
                          P(), P(axis), P(axis)),
                out_specs=(P(), P(), P()),
                check_vma=False,
            )
            def fn(row_ids, starts, counts, corpus, queries, pids, pvalid):
                return chunked(row_ids, starts, counts, corpus, queries,
                               pids, pvalid, merge_axis=axis)

        self._query_cache[cache_key] = fn
        return fn

    # -- layout serving path: ONE stacked bucket-contiguous layout ---------
    #
    # The L layouts live in ONE (L, n_aligned, d_pad) array — (table,
    # bucket) is a single flat bucket space of L*NB buckets — so the
    # whole ensemble is answered by ONE grouped/windowed serving call
    # whose rows read track the probed occupancy.  Per-query top-k runs across all tables' events at
    # once; cross-table duplicate ids are collapsed afterwards (same
    # row scores identically in every table, so fetching k*L covers the
    # worst duplication).  bf16 `serving_dtype` halves the L-copy memory
    # cost.  With a mesh the table axis is sharded: each device serves
    # its local tables' stack and per-device top-k lists are merged.

    def _stacked_signature(self) -> tuple:
        """Everything the stacked layout depends on: mutating any of
        these post-init (engine via its setter, probe_budget,
        serving_dtype, block_rows) forces a rebuild — and drops the
        windowed calibration bound, which was sized for the old
        layout's cap/grouping."""
        return (self.engine, jnp.dtype(self.serving_dtype).name,
                int(self.probe_budget), self.block_rows, self.int8_scale)

    def _build_stacked(self):
        sig = self._stacked_signature()
        if self._stacked is not None:
            if getattr(self, "_stacked_sig", None) == sig:
                return self._stacked
            self._g_cal = None  # calibrated for the stale layout
        from nlsh_jax.ops.pallas.query_kernel import (
            _br, aligned_rows, layout_arrays, round_cap,
        )

        br = _br(self.block_rows)
        # cap from probe_budget (default: the max bucket count), like the
        # single-table Indexer — so a custom budget truncates the layout
        # engines the same way it truncates the XLA path and the
        # exact_query_size metric, keeping query_size engine-independent
        cap = round_cap(self.probe_budget, br)
        # grouped engine: block-aligned bucket starts shrink the
        # stacked (L-copy!) layout ~cap/block_rows-fold vs cap
        # alignment; windowed engine: DENSE 8-row-aligned starts (its
        # whole point — ensemble buckets are far smaller than a block,
        # so block alignment is ~90% padding bytes AND a group per
        # probed bucket)
        align = 8 if self.engine == "windowed" else br
        counts_np = np.asarray(self.counts)  # (L, NB)
        # multiple of br so the stacked (table, window) space is exact
        n_aligned = -(-max(
            aligned_rows(c, cap, align=align) for c in counts_np
        ) // br) * br
        total_blocks = int(sum(
            (-(-np.minimum(c, cap) // br)).sum() for c in counts_np
        ))
        metric, dtype = self.metric, self.serving_dtype

        # int8 scales over the SHARED corpus (every table quantises the
        # same rows): "per_row" computes one scale per corpus row —
        # identical across tables, scattered per table's permutation —
        # and "global" keeps one scalar.  Either way engine scores come
        # out in dequantised units, so the cross-table (and table-
        # sharded cross-device) merges stay unit-consistent.
        is_int8 = jnp.dtype(dtype) == jnp.int8
        per_row = is_int8 and self.int8_scale == "per_row"
        scale = None
        host = self.corpus.shape[0] >= self.HOST_LAYOUT_ROWS
        if not host and is_int8:
            from nlsh_jax.ops.pallas.query_kernel import ext_scales

            scale = ext_scales(self.corpus, metric, self.int8_scale)
        if host:
            # HOST stacked build (the 10M path): the traced builder's
            # per-table scatter transients (corpus copy + (n, 2) sort
            # keys) grow with the corpus — permute each table in numpy
            # and ship dense arrays only
            from nlsh_jax.ops.pallas.query_kernel import (
                ext_scales_host, layout_arrays_host,
            )

            corpus_host = self._corpus_host
            if corpus_host is None:
                corpus_host = np.asarray(self.corpus)
            h_scale = None
            if jnp.dtype(dtype) == jnp.int8:
                h_scale = ext_scales_host(corpus_host, metric,
                                          self.int8_scale)
            rids = np.asarray(self.row_ids)
            sts = np.asarray(self.starts)
            cts = counts_np
            parts = [
                layout_arrays_host(
                    rids[li], sts[li], cts[li], corpus_host,
                    cap=cap, n_aligned=n_aligned, metric=metric,
                    dtype=dtype, align=align, scale=h_scale,
                )
                for li in range(self.n_tables)
            ]
            if self.mesh is None:
                # pre-flatten on the HOST: a device-side reshape of an
                # L-stacked multi-GB array in _flat_layout may
                # materialise a full copy; numpy concatenation is free
                # of device transients and _flat_layout passes 2-D data
                # straight through
                data = jnp.asarray(np.concatenate([p[0] for p in parts]))
                row_map = jnp.asarray(
                    np.concatenate([p[1] for p in parts]))
                norms = (jnp.asarray(np.concatenate(
                    [p[3] for p in parts]))
                    if parts[0][3] is not None else None)
                if per_row:
                    scale = jnp.asarray(
                        np.concatenate([p[4] for p in parts]))
                elif h_scale is not None:
                    scale = jnp.asarray(h_scale, jnp.float32)
            else:
                data = jnp.asarray(np.stack([p[0] for p in parts]))
                row_map = jnp.asarray(np.stack([p[1] for p in parts]))
                norms = (jnp.asarray(np.stack([p[3] for p in parts]))
                         if parts[0][3] is not None else None)
                if per_row:
                    scale = jnp.asarray(np.stack([p[4] for p in parts]))
                elif h_scale is not None:
                    scale = jnp.asarray(h_scale, jnp.float32)
            astarts = jnp.asarray(np.stack([p[2] for p in parts]))
        else:
            build = partial(layout_arrays, cap=cap, n_aligned=n_aligned,
                            metric=metric, dtype=dtype, align=align,
                            scale=scale)

            # sequential over tables (lax.map): peak transient memory
            # stays one table's sort+scatter, not L of them
            @jax.jit
            def build_all(row_ids, starts, counts, corpus):
                def one(args):
                    rid, st, ct = args
                    data, row_map, astarts, norms, scale_rows = build(
                        rid, st, ct, corpus)
                    if norms is None:
                        norms = jnp.zeros((0,), jnp.float32)
                    if scale_rows is None:
                        scale_rows = jnp.zeros((0,), jnp.float32)
                    return data, row_map, astarts, norms, scale_rows

                return jax.lax.map(one, (row_ids, starts, counts))

            data, row_map, astarts, norms, scale_rows = build_all(
                self.row_ids, self.starts, self.counts, self.corpus
            )
            if self.metric == "cosine":
                norms = None
            if per_row:
                scale = scale_rows  # (L, n_aligned) stacked scales
        if self.mesh is not None:
            spec = lambda *ax: NamedSharding(self.mesh, P(*ax))  # noqa: E731
            data = jax.device_put(data, spec(self.axis, None, None))
            row_map = jax.device_put(row_map, spec(self.axis, None))
            astarts = jax.device_put(astarts, spec(self.axis, None))
            if norms is not None:
                norms = jax.device_put(norms, spec(self.axis, None))
            if per_row:
                scale = jax.device_put(scale, spec(self.axis, None))
        self._stacked = (data, row_map, astarts, norms, cap, align,
                         n_aligned, total_blocks, scale)
        self._stacked_sig = sig
        return self._stacked

    @staticmethod
    def _flat_layout(data, row_map, astarts, norms, counts, cap, align,
                     n_aligned, total_blocks, metric,
                     block_rows: int = 0, scale=None):
        """Collapse a (Lc, ...) per-table stack into one flat layout over
        Lc * NB buckets (table-major).  Exact flat block indices need
        ``n_aligned % align == 0`` (aligned_rows guarantees it)."""
        from nlsh_jax.ops.pallas.query_kernel import ServingLayout

        lc = astarts.shape[0]
        offs = (jnp.arange(lc, dtype=jnp.int32) * n_aligned)[:, None]
        if data.ndim == 2:
            # host-prefolded stack (big-corpus path): already flat
            flat_data, flat_map = data, row_map
            flat_norms = norms
            flat_scale = scale
        else:
            flat_data = data.reshape(lc * n_aligned, data.shape[-1])
            flat_map = row_map.reshape(-1)
            flat_norms = None if norms is None else norms.reshape(-1)
            flat_scale = (scale if scale is None or scale.ndim == 0
                          else scale.reshape(-1))
        return ServingLayout(
            data=flat_data,
            row_map=flat_map,
            starts=(astarts + offs).reshape(-1),
            counts=counts.reshape(-1),
            cap=cap, d_pad=data.shape[-1], align=align, metric=metric,
            total_blocks=total_blocks,
            norms=flat_norms,
            block_rows=block_rows,
            scale=flat_scale,
        )

    @staticmethod
    def _dedupe_topk(ids, scores, k: int, n_rows: int):
        """Collapse duplicate candidate ids (same corpus row found via
        several tables scores identically) and re-top-k."""
        order = jnp.argsort(
            jnp.where(ids < 0, jnp.int32(n_rows), ids), axis=1
        )
        si = jnp.take_along_axis(ids, order, axis=1)
        ss = jnp.take_along_axis(scores, order, axis=1)
        dup = jnp.concatenate(
            [jnp.zeros_like(si[:, :1], bool), si[:, 1:] == si[:, :-1]],
            axis=1,
        )
        ss = jnp.where(dup | (si < 0), -jnp.inf, ss)
        top, arg = jax.lax.top_k(ss, k)
        merged = jnp.where(
            jnp.isfinite(top), jnp.take_along_axis(si, arg, axis=1), -1
        ).astype(jnp.int32)
        return merged, top

    # -- exact distinct-candidate count (engine-independent query_size) ----

    @staticmethod
    @partial(jax.jit, static_argnames=("n_rows", "budget", "query_chunk"))
    def _distinct_fn(row_ids, starts, counts, pids, pvalid,
                     n_rows: int, budget: int, query_chunk: int):
        """Exact ``|union over tables of probed bucket members|`` per
        query — the id-gather half of :meth:`_gather_rerank` without the
        vector gather/rerank (ids are 4 bytes/candidate, so the gather
        the hot serving path avoids is cheap as a metrics pass).
        Static (not ``self``-bound): jitting on ``self`` would pin every
        indexer instance — corpus included — in the jit cache for
        process lifetime and retrace per instance."""
        L, nq, n_probes = pids.shape
        offs = jnp.arange(budget, dtype=jnp.int32)
        n_chunks = -(-nq // query_chunk)
        pad = n_chunks * query_chunk - nq
        pid_p = jnp.pad(pids, ((0, 0), (0, pad), (0, 0)))
        pv_p = jnp.pad(pvalid, ((0, 0), (0, pad), (0, 0)))

        def f(args):
            pid, pv = args  # (L, c, P)
            c = pid.shape[1]

            def per_table(rids, st, ct, p, v):
                safe = jnp.clip(p, 0, st.shape[0] - 1)
                cnt = jnp.where(v, ct[safe], 0)
                pos = st[safe][:, :, None] + offs
                valid = offs[None, None, :] < cnt[:, :, None]
                rows = rids[jnp.clip(pos, 0, n_rows - 1)]
                return rows.reshape(c, -1), valid.reshape(c, -1)

            rows, valid = jax.vmap(per_table)(row_ids, starts, counts,
                                              pid, pv)
            rows = jnp.moveaxis(rows, 0, 1).reshape(c, -1)
            valid = jnp.moveaxis(valid, 0, 1).reshape(c, -1)
            keyed = jnp.sort(jnp.where(valid, rows, jnp.int32(n_rows)),
                             axis=1)
            uniq = jnp.concatenate(
                [jnp.ones_like(keyed[:, :1], bool),
                 keyed[:, 1:] != keyed[:, :-1]], axis=1,
            )
            uniq &= keyed < n_rows
            return jnp.sum(uniq, axis=1, dtype=jnp.int32)

        nd = jax.lax.map(
            f,
            (pid_p.reshape(L, n_chunks, query_chunk, n_probes)
             .transpose(1, 0, 2, 3),
             pv_p.reshape(L, n_chunks, query_chunk, n_probes)
             .transpose(1, 0, 2, 3)),
        )
        return nd.reshape(-1)[:nq]

    def exact_query_size(self, queries, hash_times: int = 1, key=None,
                         query_chunk: int | None = None,
                         probe_mode: str = "sample") -> np.ndarray:
        """Exact distinct-candidate count per query (``(nq,)`` int32) —
        the reference ``query_size`` axis, independent of the serving
        engine.

        The layout serving paths report summed per-table occupancy (an
        upper bound: the same corpus row counted once per table that
        hashes it into a probed bucket) because cross-table dedupe
        inside the hot dispatch would cost more than the serve it
        measures.  Metrics and eval reporting call this instead, so
        recall-at-query-size comparisons are engine-independent
        (round-2 VERDICT weak #7).  Uses the same probe path and key
        as :meth:`query`, so the counts describe exactly the batch a
        `query(..., key=key)` call served.  Truncation is at
        ``probe_budget`` (the stacked layout rounds its cap up to a
        whole block, so the layout engines can score up to
        ``round_cap(probe_budget) - probe_budget`` extra rows of an
        over-budget bucket; the default budget is the max bucket count,
        where no truncation happens anywhere)."""
        if key is None:
            key = jax.random.PRNGKey(0)
        queries = jnp.asarray(queries)
        pids, pvalid = self._probes(queries, hash_times, key, probe_mode)
        if query_chunk is None:
            query_chunk = _mt_query_chunk(
                self.n_tables, hash_times, self.probe_budget, 1
            )
        return np.asarray(self._distinct_fn(
            self.row_ids, self.starts, self.counts, pids, pvalid,
            n_rows=self.corpus.shape[0],
            budget=self.probe_budget, query_chunk=query_chunk,
        ))

    def calibrate(self, queries, hash_times: int = 1, key=None,
                  margin: float = 1.1, probe_mode: str = "sample") -> int:
        """One-time serving calibration for the windowed engine.

        The static windowed group bound must hold for ANY batch, so it
        charges every probe event ``cap//W + 1`` sub-events; balanced
        ensembles at ``hash_times=1`` really produce ~1 and share
        windows, leaving the group table (whose SIZE sets serve time)
        several-fold empty.  This computes the exact bound on a
        representative batch (ONE host sync, here, not on the serving
        path), pads it by ``margin``, rounds to a power-of-two group
        count and clamps to the static bound.  Subsequent fused
        windowed calls use it GUARDED: a device-side exact needed-count
        + ``lax.cond`` falls back to the static-bound program for any
        batch that exceeds calibration — overflow can never silently
        drop candidates.  Returns the calibrated group count."""
        import os

        from nlsh_jax.ops.pallas.query_kernel import (
            GROUP_W, windowed_exact_bound, windowed_static_bound,
        )

        if key is None:
            key = jax.random.PRNGKey(0)
        queries = jnp.asarray(queries)
        layout = self._serving_layout()
        br = layout.br
        pids, pvalid = self._probes(queries, hash_times, key, probe_mode)
        nb = self.hashing.n_buckets
        L = self.n_tables
        gp = (jnp.moveaxis(pids, 0, 1)
              + (jnp.arange(L, dtype=jnp.int32) * nb)[None, :, None]
              ).reshape(queries.shape[0], -1)
        gv = jnp.moveaxis(pvalid, 0, 1).reshape(queries.shape[0], -1)
        G = int(os.environ.get("NLSH_GROUP_Q", GROUP_W))
        needed = windowed_exact_bound(
            np.asarray(layout.starts), np.asarray(layout.counts),
            np.asarray(gp), np.asarray(gv), layout.cap, G, block_rows=br,
        )
        # no power-of-two rounding: calibration compiles exactly one
        # extra program either way, and pow2 can round a tighter bound
        # back to ~static
        g_cal = max(int(np.ceil(needed * margin)), 1)
        static = windowed_static_bound(
            gp.shape[0] * gp.shape[1], layout.cap // br + 1,
            layout.n_rows // br, G,
        )
        self._g_cal = int(min(g_cal, static))
        return self._g_cal

    def _serving_layout(self):
        """The flat stacked :class:`ServingLayout` (cached arrays; the
        wrapper itself is cheap to rebuild)."""
        from nlsh_jax.ops.pallas.query_kernel import _br

        (data, row_map, astarts, norms, cap, align, n_aligned,
         total_blocks, scale) = self._build_stacked()
        # bitwise gather canary (see nlsh_jax.index.canary): the stacked
        # engines share the row-gather regroup pattern with Indexer
        from nlsh_jax.index.canary import check_gather_integrity

        check_gather_integrity()
        return self._flat_layout(
            data, row_map, astarts, norms, self.counts, cap, align,
            n_aligned, total_blocks, self.metric,
            block_rows=_br(self.block_rows), scale=scale,
        )

    def _query_serving(self, queries, pids, pvalid, k: int, engine: str):
        """One windowed/grouped serving call over the stacked layout +
        duplicate-id collapse, with the host-computed exact
        group bound (the sync variants — the no-sync default is the
        fully fused :func:`_fused_mt_serve`).  ``n_candidates`` is the
        summed probed occupancy across tables (an upper bound on
        distinct candidates; the XLA engine and :meth:`exact_query_size`
        report the exact distinct count)."""
        from nlsh_jax.index.serving import (
            serving_query_grouped, serving_query_windowed,
        )

        layout = self._serving_layout()
        cap = layout.cap
        L = self.n_tables
        nb = self.hashing.n_buckets
        nq = queries.shape[0]
        n_probes = pids.shape[-1]
        # (L, nq, P) -> flat (nq, L*P) bucket ids in the stacked space
        gp = (jnp.moveaxis(pids, 0, 1)
              + (jnp.arange(L, dtype=jnp.int32) * nb)[None, :, None])
        gv = jnp.moveaxis(pvalid, 0, 1)
        gp = gp.reshape(nq, L * n_probes)
        gv = gv.reshape(nq, L * n_probes)
        k_fetch = min(k * L, n_probes * L * cap)

        from nlsh_jax.ops.pallas.query_kernel import _br

        br = _br(self.block_rows)
        if engine == "windowed":
            # dense windows already collapse the group floor from
            # probed buckets to probed windows, so the exact bound is
            # only modestly tighter than the static one, while the sync
            # (one host fetch + queue drain per call) costs every call.
            # Opt-in only; the no-sync default runs the fully fused
            # one-dispatch path instead.
            import os

            from nlsh_jax.ops.pallas.query_kernel import (
                GROUP_W, round_group_override, windowed_exact_bound,
                windowed_static_bound,
            )

            g_override = None
            if os.environ.get("NLSH_MT_SYNC_BOUND_WINDOWED", "0") != "0":
                G = int(os.environ.get("NLSH_GROUP_Q", GROUP_W))
                # layout geometry fetched ONCE and cached host-side;
                # per call only the probe ids ride one fused fetch
                # (each fetch drains the in-order device queue)
                if not hasattr(self, "_flat_geom_np"):
                    self._flat_geom_np = (
                        np.asarray(layout.starts), np.asarray(layout.counts)
                    )
                gpv = np.asarray(
                    jnp.concatenate([gp, gv.astype(jnp.int32)], axis=1)
                )
                g_exact = windowed_exact_bound(
                    self._flat_geom_np[0], self._flat_geom_np[1],
                    gpv[:, : gp.shape[1]],
                    gpv[:, gp.shape[1]:].astype(bool), cap, G,
                    block_rows=br,
                )
                max_sub = cap // br + 1
                static = windowed_static_bound(
                    nq * gp.shape[1], max_sub,
                    layout.n_rows // br, G,
                )
                g_override = round_group_override(g_exact, static)
            ids, scores, n_cand = serving_query_windowed(
                layout, queries, gp, gv, layout.counts, k=k_fetch, row_k=k,
                g_total_override=g_override,
            )
        else:
            # row_k=k keeps the fused in-kernel top-k: a block holds
            # distinct corpus rows, so k per block survives the
            # cross-table duplicate collapse that k_fetch=k*L guards.
            # hash_times=1 ensemble batches have LOW per-bucket
            # multiplicity (~nq*L/(L*NB) queries share a bucket), which
            # makes the no-sync static group bound several-fold loose —
            # and serve time is ~linear in the group table.  Pay one
            # small host sync for the exact bound, rounded up to powers
            # of two so compile variants stay logarithmic.
            import os

            from nlsh_jax.ops.pallas.query_kernel import (
                grouped_exact_bound, round_group_override,
            )

            g_override = None
            if os.environ.get("NLSH_MT_SYNC_BOUND", "1") != "0":
                G = int(os.environ.get("NLSH_GROUP_Q", 32))
                if not hasattr(self, "_flat_counts_np"):
                    self._flat_counts_np = np.asarray(layout.counts)
                # ONE fused fetch (each fetch drains the in-order
                # device queue)
                gpv = np.asarray(
                    jnp.concatenate([gp, gv.astype(jnp.int32)], axis=1)
                )
                g_exact = grouped_exact_bound(
                    self._flat_counts_np,
                    gpv[:, : gp.shape[1]],
                    gpv[:, gp.shape[1]:].astype(bool), cap, G,
                    block_rows=br,
                )
                from nlsh_jax.ops.pallas.query_kernel import (
                    grouped_static_bound,
                )

                static = grouped_static_bound(
                    nq * gp.shape[1], cap // br,
                    layout.total_blocks, G,
                )
                g_override = round_group_override(g_exact, static)
            ids, scores, n_cand = serving_query_grouped(
                layout, queries, gp, gv, layout.counts, k=k_fetch, row_k=k,
                g_total_override=g_override,
            )
        merged, _ = self._dedupe_topk(ids, scores, k, self.corpus.shape[0])
        return merged, n_cand

    def _query_serving_sharded(self, queries, pids, pvalid, k: int,
                               engine: str):
        """Table-sharded serving: each device answers its local tables'
        stacked layout, per-device (score, id) top lists are merged with
        duplicate-id suppression."""
        from nlsh_jax.index.serving import (
            serving_query_grouped, serving_query_windowed,
        )

        (data, row_map, astarts, norms, cap, align, n_aligned,
         total_blocks, scale) = self._build_stacked()
        from nlsh_jax.ops.pallas.query_kernel import _br

        br = _br(self.block_rows)
        # the cached program closes over the stacked layout's scalar
        # geometry (cap/align/n_aligned/total_blocks/br) AND the int8
        # dequant scale — key on geometry + dtype so a knob change that
        # rebuilt the stack cannot pair new arrays with a program
        # compiled for the old geometry (or a stale/missing scale)
        # per-row int8 scales are a stacked (L, n_aligned) ARRAY: ride
        # as a shard_map operand like norms (a closure capture would be
        # baked into the program as a constant)
        has_scale_rows = getattr(scale, "ndim", 0) == 2
        cache_key = ("serving", k, engine, queries.shape[0], pids.shape[-1],
                     cap, align, n_aligned, total_blocks, br,
                     jnp.dtype(self.serving_dtype).name, self.int8_scale)
        if cache_key not in self._query_cache:
            axis = self.axis
            nb = self.hashing.n_buckets
            metric = self.metric
            n_rows = self.corpus.shape[0]
            lc = self.n_tables // self.mesh.devices.size
            flat_layout = self._flat_layout
            dedupe_topk = self._dedupe_topk
            has_norms = norms is not None
            serve = {"grouped": serving_query_grouped,
                     "windowed": serving_query_windowed}[engine]

            g_scale = None if has_scale_rows else scale

            @jax.jit
            @partial(
                shard_map,
                mesh=self.mesh,
                in_specs=(P(axis, None, None), P(axis, None), P(axis, None),
                          P(axis, None), P(axis, None), P(axis, None), P(),
                          P(axis, None, None), P(axis, None, None)),
                out_specs=(P(), P(), P()),
                check_vma=False,
            )
            def q(data, row_map, astarts, norms, scales, counts, qs, pids,
                  pvalid):
                nq = qs.shape[0]
                n_probes = pids.shape[-1]
                layout = flat_layout(
                    data, row_map, astarts, norms if has_norms else None,
                    counts, cap, align, n_aligned, total_blocks, metric,
                    block_rows=br,
                    scale=scales if has_scale_rows else g_scale,
                )
                gp = (jnp.moveaxis(pids, 0, 1)
                      + (jnp.arange(lc, dtype=jnp.int32) * nb)[None, :, None])
                gv = jnp.moveaxis(pvalid, 0, 1)
                k_fetch = min(k * lc, n_probes * lc * cap)
                ids, scores, n_cand = serve(
                    layout, qs, gp.reshape(nq, -1), gv.reshape(nq, -1),
                    layout.counts, k=k_fetch, row_k=k,
                )
                # merge per-device candidates, collapse dups
                all_i = jax.lax.all_gather(ids, axis)     # (D, nq, k*lc)
                all_s = jax.lax.all_gather(scores, axis)
                all_i = jnp.moveaxis(all_i, 0, 1).reshape(nq, -1)
                all_s = jnp.moveaxis(all_s, 0, 1).reshape(nq, -1)
                merged, top = dedupe_topk(all_i, all_s, k, n_rows)
                return merged, top, jax.lax.psum(n_cand, axis)

            self._query_cache[cache_key] = q

        if norms is None:
            norms = jnp.zeros((data.shape[0], 0), jnp.float32)
        scales = scale if has_scale_rows else \
            jnp.zeros((data.shape[0], 0), jnp.float32)
        q = self._query_cache[cache_key]
        merged, _, n_cand = q(
            data, row_map, astarts, norms, scales, self.counts, queries,
            pids, pvalid
        )
        return merged, n_cand

    def _probes(self, queries, hash_times: int, key,
                probe_mode: str = "sample"):
        """Per-table probe ids/validity ``(L, nq, P)`` — shared by the
        query paths and :meth:`exact_query_size` so both see the same
        buckets for the same ``key``."""
        keys = jax.random.split(key, self.n_tables)

        def per_table_hash(p, k_):
            return self.hashing.hash(p, queries, n_probes=hash_times,
                                     key=k_, probe_mode=probe_mode)

        if hash_times == 1:
            return jax.vmap(
                lambda p: self.hashing.hash(p, queries, n_probes=1)
            )(self.params)
        return jax.vmap(per_table_hash)(self.params, keys)

    def query_async(self, queries, k: int = 10, hash_times: int = 1,
                    key=None, probe_mode: str = "sample"):
        """Dispatch an ensemble query without fetching (see
        :meth:`fetch`); ``hash_times=1`` (hard probe per table) is the
        typical multi-table operating point — the ensemble provides the
        recall that multi-probe provides a single table.

        ``probe_mode="flip"`` with ``hash_times>1`` probes each table's
        ``hash_times`` best-first bit-flip buckets deterministically —
        the single-table frontier finding (sampled probes collapse
        under dedupe) applies per table here too."""
        import os

        if key is None:
            key = jax.random.PRNGKey(0)
        queries = jnp.asarray(queries)

        engine = self.engine
        if engine != "xla" and self.metric in LAYOUT_METRICS:
            if self.mesh is None:
                # host-sync group bounds (opt-in for windowed, default
                # for grouped) cannot live inside one compiled program;
                # everything else runs the fused one-dispatch path
                sync = (
                    engine == "grouped"
                    and os.environ.get("NLSH_MT_SYNC_BOUND", "1") != "0"
                ) or (
                    engine == "windowed"
                    and os.environ.get("NLSH_MT_SYNC_BOUND_WINDOWED", "0")
                    != "0"
                )
                if not sync:
                    g_cal = self._g_cal if engine == "windowed" else None
                    return _fused_mt_serve(
                        self.hashing, self.params, self._serving_layout(),
                        queries, key, k=k, hash_times=hash_times,
                        engine=engine, n_rows=self.corpus.shape[0],
                        g_override=g_cal, probe_mode=probe_mode,
                    )
                pids, pvalid = self._probes(queries, hash_times, key,
                                            probe_mode)
                return self._query_serving(queries, pids, pvalid, k, engine)
            pids, pvalid = self._probes(queries, hash_times, key, probe_mode)
            return self._query_serving_sharded(
                queries, pids, pvalid, k, engine
            )
        pids, pvalid = self._probes(queries, hash_times, key, probe_mode)

        chunk = _mt_query_chunk(
            self.n_tables, hash_times, self.probe_budget, queries.shape[1]
        )
        fn = self._query_fn(k, hash_times, chunk)
        top, _, nd = fn(self.row_ids, self.starts, self.counts, self.corpus,
                        queries, pids, pvalid)
        return top, nd

    @staticmethod
    def fetch(result) -> tuple[np.ndarray, np.ndarray]:
        """Fetch a :meth:`query_async` result to host:
        ``(topk_ids (nq, k), n_candidates (nq,))`` numpy arrays.  The
        fused path returns ONE packed ``(nq, k+1)`` array so the fetch
        is a single transfer."""
        if isinstance(result, tuple):
            ids, n_cand = result
            return np.asarray(ids), np.asarray(n_cand)
        packed = np.asarray(result)  # ONE host fetch of (nq, k+1)
        return packed[:, :-1], packed[:, -1]

    def query(self, queries, k: int = 10, hash_times: int = 1, key=None,
              probe_mode: str = "sample"):
        """Query the ensemble (fetching variant of :meth:`query_async`).

        Returns ``(topk_ids (nq, k), n_candidates (nq,))`` —
        ``n_candidates`` is the exact distinct-candidate count on the
        XLA engine and the summed per-table occupancy (upper bound) on
        the layout engines.
        """
        return self.fetch(self.query_async(
            queries, k=k, hash_times=hash_times, key=key,
            probe_mode=probe_mode,
        ))
