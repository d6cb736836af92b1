"""Corpus-sharded bucket tables: the distributed inverted index.

For corpora beyond one device's memory (the scale axis the reference only
stubs — ``BigANN1B``/``Deep1B`` at ``nlsh/data.py:204-209``), the
corpus is sharded row-wise across the mesh.  Each device hashes its
rows and builds a *local* CSR bucket table; a query is broadcast to
every device, answered locally (probe gather -> exact rerank -> local
top-k), and the per-shard (distance, global-row-id) top-k lists are
merged with one ``all_gather`` followed by a final ``top_k``.
``query_size`` is the ``psum`` of local probed-bucket occupancies.

Exactness: hard hashing partitions every shard's rows among buckets, so
the union of per-shard candidate sets equals the single-chip candidate
set, and top-k of a union equals top-k of merged per-shard top-ks —
the merged result is bitwise the single-chip result (modulo fp
reduction order).
"""

from __future__ import annotations

import os

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nlsh_jax.index.bucket_table import BucketTable, build_bucket_table
from nlsh_jax.index.indexer import (
    LAYOUT_METRICS, SERVING_ENGINES, hash_corpus_host, legacy_engine,
    resolve_engine,
)
from nlsh_jax.index.query import default_query_chunk, query_bucket_table
from nlsh_jax.native import build_csr as _build_csr_host

shard_map = jax.shard_map

Array = jnp.ndarray


class ShardedIndexer:
    """Build-once, query-many inverted index sharded over a 1-D mesh.

    Args:
      hashing: hashing model (replicated).
      params: its params (replicated).
      corpus: ``(n, d)`` — will be padded to a multiple of the mesh size
        and sharded row-wise.
      mesh: 1-D ``Mesh``; its axis name is the shard axis.
    """

    #: local shard row counts past this build the serving layout on the
    #: host (numpy), keeping the full-shard scatter off the device (a
    #: threshold chosen for a 16 GB device; ROADMAP lists it for
    #: re-measurement on the GPU)
    HOST_LAYOUT_ROWS = 1_500_000

    def __init__(self, hashing, params, corpus, mesh: Mesh,
                 metric: str = "cosine", probe_budget: int | None = None,
                 engine: str = "auto", serving_dtype=None,
                 layout_mode: str = "auto", block_rows: int | None = None,
                 tables=None, int8_scale: str = "per_row"):
        self.block_rows = block_rows  # None = module default
        if layout_mode not in ("auto", "device", "host"):
            raise ValueError(f"unknown layout_mode {layout_mode!r}")
        if int8_scale not in ("global", "per_row"):
            raise ValueError(f"unknown int8_scale {int8_scale!r}")
        self.int8_scale = int8_scale
        self.hashing = hashing
        self.params = params
        self.mesh = mesh
        self.metric = metric
        self.engine = engine  # setter: validates, resolves "auto"
        self.serving_dtype = serving_dtype or jnp.float32
        self.layout_mode = layout_mode
        self._query_cache: dict = {}
        self._layouts = None
        (self.axis,) = mesh.axis_names
        n_dev = mesh.devices.size

        # keep a host copy when the caller already has one: the host
        # layout builder then never fetches the corpus back from the
        # device
        corpus_host = corpus if isinstance(corpus, np.ndarray) else None
        self.n_real = corpus.shape[0]
        pad = (-self.n_real) % n_dev
        if corpus_host is not None and pad:
            corpus_host = np.pad(corpus_host, ((0, pad), (0, 0)))
        self._corpus_host = corpus_host
        self.n_padded = self.n_real + pad
        self.n_local = self.n_padded // n_dev

        # the full f32 corpus only needs to live on-device when a traced
        # path consumes it (multi-device shard_map build/query, or the
        # XLA fallback engine); the 1-device host-layout serving path
        # never touches it — at 10M x 96 keeping it resident is 3.8 GB
        # of device memory for nothing
        lazy_corpus = (
            n_dev == 1 and corpus_host is not None
            and self.n_local >= self.HOST_LAYOUT_ROWS
            and layout_mode != "device" and engine != "xla"
        )
        if lazy_corpus:
            self.corpus = None
        else:
            corpus = jnp.asarray(corpus)
            if pad:
                corpus = jnp.pad(corpus, ((0, pad), (0, 0)))
            self.corpus = jax.device_put(
                corpus, NamedSharding(mesh, P(self.axis, None))
            )

        n_buckets = hashing.n_buckets
        axis = self.axis
        n_local = self.n_local
        n_real = self.n_real

        if tables is not None:
            # persistence path (:meth:`load`): per-shard CSR provided,
            # skip the corpus hash + build entirely
            row_ids = jnp.asarray(tables[0])
            starts = jnp.asarray(tables[1])
            counts = jnp.asarray(tables[2])
            if n_dev > 1:
                row_ids = jax.device_put(
                    row_ids, NamedSharding(mesh, P(axis)))
                starts = jax.device_put(
                    starts, NamedSharding(mesh, P(axis, None)))
                counts = jax.device_put(
                    counts, NamedSharding(mesh, P(axis, None)))
        elif n_dev == 1:
            # degenerate mesh: shard_map adds nothing but compile cost;
            # the chunked single-device hash + one sort compile in
            # seconds at multi-million rows
            from nlsh_jax.index.indexer import hash_corpus

            if self.corpus is None:
                codes = hash_corpus_host(hashing, params, corpus_host)
                row_ids, t_starts, t_counts = _build_csr_host(
                    codes, n_buckets
                )
                starts = jnp.asarray(t_starts)[None, :]
                counts = jnp.asarray(t_counts)[None, :]
                row_ids = jnp.asarray(row_ids)
            else:
                codes = hash_corpus(hashing, params, self.corpus)
                t = build_bucket_table(codes, n_buckets)
                row_ids = t.row_ids
                starts, counts = t.starts[None, :], t.counts[None, :]
        else:
            @jax.jit
            @partial(
                shard_map,
                mesh=mesh,
                in_specs=P(axis, None),
                out_specs=(P(axis), P(axis, None), P(axis, None)),
                check_vma=False,
            )
            def build_local(corpus_local):
                shard = jax.lax.axis_index(axis)
                codes = hashing.hash_hard(params, corpus_local)  # (n_local,)
                gid = shard * n_local + jnp.arange(n_local, dtype=jnp.int32)
                # padding rows get the out-of-range sentinel: dropped
                # from counts by the scatter's mode='drop', sorted last
                codes = jnp.where(gid < n_real, codes, n_buckets)
                t = build_bucket_table(codes, n_buckets)
                return t.row_ids, t.starts[None, :], t.counts[None, :]

            row_ids, starts, counts = build_local(self.corpus)
        # global shapes: (n_padded,), (n_dev, n_buckets), (n_dev, n_buckets)
        self.row_ids, self.starts, self.counts = row_ids, starts, counts
        if probe_budget is None:
            probe_budget = int(jnp.max(counts))
        self.probe_budget = max(int(probe_budget), 1)

    @property
    def engine(self) -> str:
        return self._engine

    @engine.setter
    def engine(self, value: str):
        """Validates, resolves ``"auto"``, and drops the per-shard
        layouts (whose start alignment is engine-specific) on an engine
        change — serving a new engine on stale-aligned layouts either
        raises mid-serve or silently forfeits the engine's design
        point."""
        if value != "auto" and value not in SERVING_ENGINES:
            raise ValueError(f"unknown engine {value!r}")
        if value == "auto":
            value = (resolve_engine(value)
                     if self.metric in LAYOUT_METRICS else "xla")
        old = getattr(self, "_engine", None)
        self._engine = value
        if old is not None and value != old:
            self._layouts = None

    # -- persistence: skip the 10M-row re-hash on a serving restart --------
    def save(self, path: str) -> None:
        """Persist the per-shard CSR tables + serving knobs (NOT the
        corpus/params).  At 10M rows the hash + CSR build is minutes of
        restart time for state deterministic in (params, corpus)."""
        from nlsh_jax.utils.fingerprint import corpus_fingerprint

        src = self._corpus_host if self._corpus_host is not None \
            else self.corpus
        np.savez_compressed(
            path,
            row_ids=np.asarray(self.row_ids),
            starts=np.asarray(self.starts),
            counts=np.asarray(self.counts),
            meta=np.array([
                self.metric, str(self.probe_budget), self._engine,
                jnp.dtype(self.serving_dtype).name,
                str(self.block_rows), self.layout_mode,
                str(int(self.mesh.devices.size)), str(self.n_real),
                corpus_fingerprint(src, n_real=self.n_real),
                self.int8_scale,
            ]),
        )

    @classmethod
    def load(cls, path: str, hashing, params, corpus, mesh: Mesh
             ) -> "ShardedIndexer":
        """Rebuild from :meth:`save` output without re-hashing.  The
        mesh must have the shard count the tables were built for, and
        the corpus must match the saved fingerprint (head + tail +
        strided sample; a head-only digest accepted appended/tail-edited
        corpora)."""
        from nlsh_jax.utils.fingerprint import check_fingerprint

        with np.load(path, allow_pickle=False) as z:
            meta = [str(v) for v in z["meta"]]
            # round-4 archives predate int8_scale: they were global
            int8_scale = meta[9] if len(meta) > 9 else "global"
            (metric, probe_budget, engine, sdtype, block_rows,
             layout_mode, n_dev, n_real, digest) = meta[:9]
            if int(n_dev) != int(mesh.devices.size):
                raise ValueError(
                    f"saved tables are sharded {n_dev}-way, mesh has "
                    f"{mesh.devices.size} device(s)"
                )
            if int(n_real) != corpus.shape[0]:
                raise ValueError(
                    f"saved index is over {n_real} corpus rows, got "
                    f"{corpus.shape[0]}"
                )
            check_fingerprint(digest, corpus, n_real=int(n_real))
            tables = (z["row_ids"], z["starts"], z["counts"])
            return cls(
                hashing, params, corpus, mesh, metric=metric,
                probe_budget=int(probe_budget), engine=legacy_engine(engine),
                serving_dtype=jnp.dtype(sdtype),
                layout_mode=layout_mode,
                block_rows=None if block_rows == "None" else int(block_rows),
                tables=tables,
                int8_scale=int8_scale,
            )

    # -- observability ----------------------------------------------------
    def n_buckets_used(self) -> int:
        """Occupied (shard, bucket) cells — each shard owns a slice of
        every bucket."""
        return int(jnp.sum(self.counts > 0))

    def occupancy_std(self) -> float:
        counts = np.asarray(self.counts).reshape(-1)
        occ = counts[counts > 0]
        return float(occ.std()) if occ.size else 0.0

    # -- serving layouts (one per shard, shared static shapes) --------------
    def _build_layouts(self):
        """Per-shard bucket-contiguous serving layouts with shard-uniform
        static shapes (cap from the global max bucket, rows padded to the
        largest shard's aligned size).  Small shards build inside
        shard_map; multi-million-row shards build on the HOST
        (:func:`layout_arrays_host`) so the device never holds the
        full-corpus scatter transients.

        The cap is deliberately GLOBAL: shard_map traces one program for
        every shard, so per-shard caps are not expressible, and under
        the grouped engine the rows read track probed occupancy anyway
        — a skewed shard costs only its own occupancy, not cap-many
        rows per probe."""
        sig = (self.engine, jnp.dtype(self.serving_dtype).name,
               self.block_rows, self.layout_mode, self.int8_scale)
        if self._layouts is not None \
                and getattr(self, "_layouts_sig", None) == sig:
            return self._layouts
        from nlsh_jax.ops.pallas.query_kernel import (
            _br, aligned_rows, layout_arrays, layout_arrays_host,
            round_cap,
        )

        br = _br(self.block_rows)
        cap = round_cap(int(jnp.max(self.counts)), br)
        # the grouped engine indexes blocks by start/block_rows, so its
        # layouts only need block-aligned bucket starts — several-fold
        # less memory than cap alignment at 10M rows x 16k buckets; the
        # windowed engine packs DENSE (8-row starts: its design point is
        # mean bucket << block, where block alignment is mostly padding)
        align = 8 if self.engine == "windowed" else br
        counts_np = np.asarray(self.counts)  # (D, n_buckets)
        # whole-window tail: every engine indexes br-row blocks/windows
        n_aligned = -(-max(
            aligned_rows(c, cap, align=align) for c in counts_np
        ) // br) * br
        # shard-uniform static group bound: the largest shard's blocks
        total_blocks = int(max(
            (-(-np.minimum(c, cap) // br)).sum() for c in counts_np
        ))
        axis, metric = self.axis, self.metric
        euclid = metric in ("euclidean", "sq_euclidean")
        dtype = self.serving_dtype
        host = self.layout_mode == "host" or (
            self.layout_mode == "auto" and self.n_local >= self.HOST_LAYOUT_ROWS
        )

        if host:
            n_dev = self.mesh.devices.size
            rids = np.asarray(self.row_ids).reshape(n_dev, self.n_local)
            starts_np = np.asarray(self.starts)
            corpus_host = self._corpus_host
            if corpus_host is None:
                corpus_host = np.asarray(self.corpus)
            # int8 scales: per-row mode gives every stored row its own
            # scale (scores come out in dequantised units either way,
            # so the cross-shard top-k merge stays unit-consistent);
            # global mode keeps ONE scale over all shards (padding rows
            # past n_real are zeros and cannot raise the max)
            scale = None
            if jnp.dtype(dtype) == jnp.int8:
                from nlsh_jax.ops.pallas.query_kernel import ext_scales_host

                scale = ext_scales_host(corpus_host, metric,
                                        self.int8_scale)
            per_row = isinstance(scale, np.ndarray)
            parts = [
                layout_arrays_host(
                    rids[s], starts_np[s], counts_np[s],
                    corpus_host[s * self.n_local:(s + 1) * self.n_local],
                    cap=cap, n_aligned=n_aligned, metric=metric, dtype=dtype,
                    align=align,
                    scale=(scale[s * self.n_local:(s + 1) * self.n_local]
                           if per_row else scale),
                )
                for s in range(n_dev)
            ]
            put = lambda arrs, spec: jax.device_put(  # noqa: E731
                np.stack(arrs), NamedSharding(self.mesh, spec)
            )
            data = put([p[0] for p in parts], P(axis, None, None))
            row_map = put([p[1] for p in parts], P(axis, None))
            astarts = put([p[2] for p in parts], P(axis, None))
            norms = (put([p[3] for p in parts], P(axis, None))
                     if euclid else None)
            if per_row:
                scale = put([p[4] for p in parts], P(axis, None))
            self._layouts = (data, row_map, astarts, norms, cap, align,
                             total_blocks, scale)
            self._layouts_sig = sig
            return self._layouts

        is_int8 = jnp.dtype(dtype) == jnp.int8
        per_row = is_int8 and self.int8_scale == "per_row"
        scale = None
        if is_int8 and not per_row:
            # global scale (see host path); one tiny eager reduction
            nrm = jnp.linalg.norm(self.corpus, axis=1, keepdims=True)
            scale = float(jnp.max(
                jnp.abs(self.corpus / jnp.maximum(nrm, 1e-12))) / 127.0)

        @jax.jit
        @partial(
            shard_map,
            mesh=self.mesh,
            in_specs=(P(axis), P(axis, None), P(axis, None), P(axis, None)),
            out_specs=(P(axis, None, None), P(axis, None), P(axis, None),
                       P(axis, None), P(axis, None)),
            check_vma=False,
        )
        def build(row_ids, starts, counts, corpus_local):
            from nlsh_jax.ops.pallas.query_kernel import ext_scales

            sc = (ext_scales(corpus_local, metric, "per_row") if per_row
                  else (None if scale is None else jnp.float32(scale)))
            data, row_map, astarts, norms, scale_rows = layout_arrays(
                row_ids, starts[0], counts[0], corpus_local,
                cap=cap, n_aligned=n_aligned, metric=metric, dtype=dtype,
                align=align, scale=sc,
            )
            if norms is None:  # uniform output structure across metrics
                norms = jnp.zeros((0,), jnp.float32)
            if scale_rows is None:
                scale_rows = jnp.zeros((0,), jnp.float32)
            return (data[None], row_map[None], astarts[None], norms[None],
                    scale_rows[None])

        data, row_map, astarts, norms, scale_rows = build(
            self.row_ids, self.starts, self.counts, self.corpus
        )
        if not euclid:
            norms = None
        if per_row:
            scale = scale_rows
        self._layouts = (data, row_map, astarts, norms, cap, align,
                         total_blocks, scale)
        self._layouts_sig = sig
        return self._layouts

    def _serving_query_fn(self, k: int, engine: str,
                          hash_times: int, probe_mode: str,
                          g_override: int | None = None):
        """ONE jitted program per query batch: probe-hash + serve (+
        cross-shard merge) + pack ``[topk_ids | n_cand]`` into a single
        int32 array — one dispatch and one fetch, exactly like the
        single-table Indexer's fused dispatch."""
        # the cached program closes over the layout ARRAYS, so the key
        # carries every knob the layout depends on — a serving_dtype or
        # block_rows change must not serve a program closed over the
        # stale arrays
        cache_key = ("serving", k, engine, hash_times, probe_mode,
                     g_override, jnp.dtype(self.serving_dtype).name,
                     self.block_rows, self.layout_mode, self.int8_scale)
        if cache_key in self._query_cache:
            return self._query_cache[cache_key]
        from nlsh_jax.index.serving import (
            serving_query_grouped, serving_query_windowed,
        )
        from nlsh_jax.ops.pallas.query_kernel import ServingLayout, _br

        serve = {"grouped": serving_query_grouped,
                 "windowed": serving_query_windowed}[engine]
        data, row_map, astarts, norms, cap, align, total_blocks, scale = (
            self._build_layouts()
        )
        # per-row int8 scales are a sharded (D, n_aligned) ARRAY and must
        # ride as an operand (a closure-captured device array would be
        # baked into the program as a constant); a global scale stays a
        # closed-over python float
        has_scale_rows = getattr(scale, "ndim", 0) == 2
        scale_const = None if (scale is None or has_scale_rows) \
            else jnp.float32(scale)
        br = _br(self.block_rows)
        d_pad = data.shape[-1]
        axis, metric, n_local = self.axis, self.metric, self.n_local
        hashing = self.hashing
        has_norms = norms is not None
        if not has_norms:  # shard_map needs an array operand regardless
            norms = jnp.zeros((data.shape[0], 0), jnp.float32)

        if self.mesh.devices.size == 1:
            # degenerate mesh: no merge to do — serve the single shard's
            # layout directly, without the shard_map wrapper

            @jax.jit
            def q1(params, data, row_map, astarts, norms, scales, counts,
                   qs, key):
                pids, pvalid = hashing.hash(
                    params, qs, n_probes=hash_times, key=key,
                    probe_mode=probe_mode,
                )
                layout = ServingLayout(
                    data=data[0], row_map=row_map[0], starts=astarts[0],
                    counts=counts[0], cap=cap, d_pad=d_pad, align=align,
                    metric=metric, norms=norms[0] if has_norms else None,
                    total_blocks=total_blocks, block_rows=br,
                    scale=scales[0] if has_scale_rows else scale_const,
                )
                ids, _, ncand = serve(
                    layout, qs, pids, pvalid, counts[0], k=k,
                    g_total_override=g_override,
                )
                return jnp.concatenate([ids, ncand[:, None]], axis=1)

            self._query_cache[cache_key] = q1
            return q1

        @partial(
            shard_map,
            mesh=self.mesh,
            in_specs=(P(axis, None, None), P(axis, None), P(axis, None),
                      P(axis, None), P(axis, None), P(axis, None), P(), P(),
                      P()),
            out_specs=P(),
            check_vma=False,
        )
        def q_shards(data, row_map, astarts, norms, scales, counts, qs,
                     pids, pvalid):
            shard = jax.lax.axis_index(axis)
            layout = ServingLayout(
                data=data[0], row_map=row_map[0], starts=astarts[0],
                counts=counts[0], cap=cap, d_pad=d_pad, align=align,
                metric=metric, norms=norms[0] if has_norms else None,
                total_blocks=total_blocks, block_rows=br,
                scale=scales[0] if has_scale_rows else scale_const,
            )
            ids, scores, ncand = serve(
                layout, qs, pids, pvalid, counts[0], k=k
            )
            gids = jnp.where(ids >= 0, ids + shard * n_local, -1)
            all_s = jax.lax.all_gather(scores, axis)  # (D, nq, k)
            all_i = jax.lax.all_gather(gids, axis)
            nq = qs.shape[0]
            all_s = jnp.moveaxis(all_s, 0, 1).reshape(nq, -1)
            all_i = jnp.moveaxis(all_i, 0, 1).reshape(nq, -1)
            top, arg = jax.lax.top_k(all_s, k)  # higher score = nearer
            merged_i = jnp.where(
                jnp.isfinite(top),
                jnp.take_along_axis(all_i, arg, axis=1), -1
            ).astype(jnp.int32)
            ncand = jax.lax.psum(ncand, axis)
            return jnp.concatenate([merged_i, ncand[:, None]], axis=1)

        @jax.jit
        def q(params, data, row_map, astarts, norms, scales, counts, qs,
              key):
            pids, pvalid = hashing.hash(
                params, qs, n_probes=hash_times, key=key,
                probe_mode=probe_mode,
            )
            return q_shards(data, row_map, astarts, norms, scales, counts,
                            qs, pids, pvalid)

        self._query_cache[cache_key] = q
        return q

    # -- query --------------------------------------------------------------
    def _query_fn(self, k: int, query_chunk: int):
        """Build (and cache) the jitted sharded query kernel for a given
        (k, query_chunk) — jit caches by function identity, so the
        closure must be constructed once per static configuration."""
        cache_key = (k, query_chunk)
        if cache_key in self._query_cache:
            return self._query_cache[cache_key]

        axis, n_local = self.axis, self.n_local
        metric, budget = self.metric, self.probe_budget

        @jax.jit
        @partial(
            shard_map,
            mesh=self.mesh,
            in_specs=(P(axis), P(axis, None), P(axis, None), P(axis, None),
                      P(), P(), P()),
            out_specs=P(),
            check_vma=False,
        )
        def q(row_ids, starts, counts, corpus_local, qs, pids, pvalid):
            shard = jax.lax.axis_index(axis)
            table = BucketTable(row_ids, starts[0], counts[0])
            top_ids, top_d, ncand = query_bucket_table(
                table, corpus_local, qs, pids, pvalid,
                k=k, probe_budget=budget, metric=metric,
                query_chunk=query_chunk,
            )
            gids = jnp.where(top_ids >= 0, top_ids + shard * n_local, -1)
            # cross-chip merge: gather every shard's top-k, re-top-k
            all_d = jax.lax.all_gather(top_d, axis)  # (D, nq, k)
            all_i = jax.lax.all_gather(gids, axis)
            nq = qs.shape[0]
            all_d = jnp.moveaxis(all_d, 0, 1).reshape(nq, -1)
            all_i = jnp.moveaxis(all_i, 0, 1).reshape(nq, -1)
            neg_top, arg = jax.lax.top_k(-all_d, k)
            merged_i = jnp.where(
                jnp.isfinite(neg_top),
                jnp.take_along_axis(all_i, arg, axis=1), -1
            ).astype(jnp.int32)
            ncand = jax.lax.psum(ncand, axis)
            return jnp.concatenate([merged_i, ncand[:, None]], axis=1)

        self._query_cache[cache_key] = q
        return q

    def query_async(self, queries, k: int = 10, hash_times: int = 10,
                    key=None, query_chunk: int | None = None,
                    probe_mode: str = "sample"):
        """Dispatch a multi-probe query against all shards without
        fetching; returns device arrays for :meth:`fetch`."""
        if key is None:
            key = jax.random.PRNGKey(0)
        queries = jnp.asarray(queries)
        engine = self.engine
        if engine != "xla" and self.metric in LAYOUT_METRICS:
            data, row_map, astarts, norms, cap, _, _, scale = (
                self._build_layouts())
            if norms is None:
                norms = jnp.zeros((data.shape[0], 0), jnp.float32)
            if getattr(scale, "ndim", 0) == 2:
                scales = scale  # per-row: sharded (D, n_aligned) operand
            else:
                scales = jnp.zeros((data.shape[0], 0), jnp.float32)
            g_override = None
            if (engine == "grouped"
                    and self.mesh.devices.size == 1
                    and os.environ.get("NLSH_SHARDED_SYNC_BOUND", "0")
                    != "0"):
                # OFF by default: the host fetch of the probe ids drains
                # the device queue (no pipelining); enable only for
                # probe batches where the static bound is several-fold
                # loose (see MultiTableIndexer).
                from nlsh_jax.ops.pallas.query_kernel import (
                    _br, grouped_exact_bound, grouped_static_bound,
                    round_group_override,
                )

                probe_ids, probe_valid = self.hashing.hash(
                    self.params, queries, n_probes=hash_times, key=key,
                    probe_mode=probe_mode,
                )
                G = int(os.environ.get("NLSH_GROUP_Q", 32))
                br = _br(self.block_rows)
                g_exact = grouped_exact_bound(
                    np.asarray(self.counts[0]), np.asarray(probe_ids),
                    np.asarray(probe_valid), cap, G, block_rows=br,
                )
                total_blocks = self._layouts[6]
                g_override = round_group_override(
                    g_exact, grouped_static_bound(
                        queries.shape[0] * probe_ids.shape[1], cap // br,
                        total_blocks, G,
                    ))
            q = self._serving_query_fn(k, engine, hash_times, probe_mode,
                                       g_override)
            return q(
                self.params, data, row_map, astarts, norms, scales,
                self.counts, queries, key,
            )
        probe_ids, probe_valid = self.hashing.hash(
            self.params, queries, n_probes=hash_times, key=key,
            probe_mode=probe_mode,
        )
        if self.corpus is None:  # lazily materialize for the XLA path
            self.corpus = jax.device_put(
                self._corpus_host,
                NamedSharding(self.mesh, P(self.axis, None)),
            )
        if query_chunk is None:
            query_chunk = default_query_chunk(
                hash_times, self.probe_budget, queries.shape[1]
            )
        q = self._query_fn(k, query_chunk)
        return q(
            self.row_ids, self.starts, self.counts, self.corpus,
            queries, probe_ids, probe_valid,
        )

    @staticmethod
    def fetch(result) -> tuple[np.ndarray, np.ndarray]:
        """Fetch a :meth:`query_async` result: ONE packed ``(nq, k+1)``
        transfer, split into ``(topk_ids, n_candidates)``."""
        arr = np.asarray(result)
        return arr[:, :-1], arr[:, -1]

    def query(self, queries, k: int = 10, hash_times: int = 10, key=None,
              query_chunk: int | None = None, probe_mode: str = "sample"):
        """Multi-probe query against all shards; returns
        ``(topk_ids (nq, k), n_candidates (nq,))`` as numpy (global row
        ids, merged across shards)."""
        return self.fetch(self.query_async(
            queries, k=k, hash_times=hash_times, key=key,
            query_chunk=query_chunk, probe_mode=probe_mode,
        ))
