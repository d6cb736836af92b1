"""Serving query path over the bucket-contiguous layout.

Glue over :mod:`nlsh_jax.ops.pallas.query_kernel`: extend queries for
the layout's metric, group probe events by the block (``grouped``) or
dense window (``windowed``) they read, score each group with one
batched matrix product, select top-k, and map sorted positions back to
original corpus row ids.  Score order
is exactly the exact-rerank distance order (build-time metric
extension makes score monotone in distance), so results match the
reference semantics whenever ``cap`` covers the largest probed bucket.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp

from nlsh_jax.ops.pallas.query_kernel import (
    GROUP_W,
    ServingLayout,
    _grouped_prep_v2,
    _windowed_prep,
    block_scores,
    extend_queries,
    grouped_static_bound,
    windowed_static_bound,
)

Array = jnp.ndarray


def _pack_panels(row_top, row_lane, kk: int):
    """Pack ``(rows, kk)`` score + lane panels into ONE lane-aligned
    ``(rows, W)`` f32 table (W = multiple of 128) for the event
    regroup's row gather.  Row gathers from lane-PADDED tables (minor
    dim kk < 128) were miscompiled past ~800k rows by the XLA backend
    of the accelerator this system was first built for; full-width
    tables follow the corpus-gather pattern that :mod:`~nlsh_jax.index.
    canary` checks bitwise.  The barrier stops XLA fusing the pad back
    into the consumer gather."""
    w = -(-2 * kk // 128) * 128
    packed = jnp.concatenate(
        [row_top, row_lane.astype(jnp.float32)], axis=1)
    packed = jnp.pad(packed, ((0, 0), (0, w - 2 * kk)))
    return jax.lax.optimization_barrier(packed)


def _chunked_serve(queries, probe_ids, probe_valid, query_chunk: int,
                   bound_fn, call_fn):
    """Shared pad/chunk/concat scaffold of the grouped and windowed
    wrappers: tail chunks are padded to the full chunk shape (one
    compiled variant regardless of nq), ``bound_fn(c_pad, pid)`` sizes
    the chunk's group table, ``call_fn(qs, pid, pv, g_total)`` serves
    it, and per-chunk results concatenate."""
    nq = queries.shape[0]
    out_ids, out_scores, out_cand = [], [], []
    for s in range(0, nq, query_chunk):
        e = min(s + query_chunk, nq)
        c = e - s
        c_pad = min(query_chunk, nq) if s == 0 else query_chunk
        pid = probe_ids[s:e]
        pv = probe_valid[s:e]
        qs = queries[s:e]
        if c < c_pad:
            pid = jnp.pad(pid, ((0, c_pad - c), (0, 0)))
            pv = jnp.pad(pv, ((0, c_pad - c), (0, 0)))
            qs = jnp.pad(qs, ((0, c_pad - c), (0, 0)))
        ids, scores, n_cand = call_fn(qs, pid, pv, bound_fn(c_pad, pid))
        out_ids.append(ids[:c])
        out_scores.append(scores[:c])
        out_cand.append(n_cand[:c])
    if len(out_ids) == 1:
        return out_ids[0], out_scores[0], out_cand[0]
    return (
        jnp.concatenate(out_ids, 0),
        jnp.concatenate(out_scores, 0),
        jnp.concatenate(out_cand, 0),
    )


def _row_topk_table(scores, k: int, row_k: int | None):
    """Per-score-row top-``min(row_k or k, br)`` of the masked
    ``(g, G, br)`` panels, packed for the event regroup.  ``row_k``
    per block suffices whenever the caller needs at most ``row_k``
    DISTINCT rows: every block holds distinct corpus rows."""
    g_total, group_q, br = scores.shape
    flat = scores.reshape(g_total * group_q, br)
    row_top, row_lane = jax.lax.top_k(flat, min(row_k or k, br))
    kk = row_top.shape[1]
    return _pack_panels(row_top, row_lane, kk), kk


def _dequant_bias(layout, scores, grp_block):
    """Per-row int8 dequant, then the euclidean ``-||c||^2`` bias, on
    ``(g, G, br)`` block scores — before any cross-block merge, so
    every score is in exact-dot units (norms are stored dequantised)."""
    br = layout.br
    if layout.scale is not None and layout.scale.ndim == 1:
        scores = scores * layout.scale.reshape(-1, br)[grp_block][:, None, :]
    if layout.norms is not None:  # euclidean: score = 2q.c - ||c||^2
        scores = scores - layout.norms.reshape(-1, br)[grp_block][:, None, :]
    return scores


@partial(jax.jit, static_argnames=("k", "g_total", "max_blocks", "group_q",
                                   "row_k"))
def _grouped_query_jit(layout, queries, probe_ids, probe_valid, full_counts,
                       k: int, g_total: int, max_blocks: int, group_q: int,
                       row_k: int | None = None):
    br = layout.br  # static (rides the layout's pytree aux)
    if layout.align % br:
        raise ValueError(
            "the grouped engine indexes blocks by start/block_rows and "
            f"needs block-aligned bucket starts (align={layout.align}, "
            f"block_rows={br}); dense layouts serve via the windowed "
            "engine"
        )
    # queries stay f32 (extend_queries): block_scores upcasts the corpus
    # block and dots at HIGHEST precision, so the only scoring error on
    # a bf16 layout is the corpus storage rounding itself
    qe = extend_queries(layout, queries)
    grp_block, grp_qvecs, grp_cnt, ev_row, ev_block, ev_valid = (
        _grouped_prep_v2(
            layout.starts, layout.counts, probe_ids, probe_valid, qe,
            jnp.asarray(layout.cap, jnp.int32), g_total=g_total,
            max_blocks=max_blocks, group_q=group_q, block_rows=br,
        )
    )
    scores = block_scores(layout.data, grp_qvecs, grp_block,
                          block_rows=br)  # (g, G, br)
    scores = _dequant_bias(layout, scores, grp_block)
    lane = jnp.arange(br, dtype=jnp.int32)
    scores = jnp.where(lane[None, None, :] < grp_cnt[:, :, None],
                       scores, -jnp.inf)
    # per-score-row top-k first (dense), then regroup per query
    table, kk = _row_topk_table(scores, k, row_k)

    nq, n_probes = probe_ids.shape
    ev_row3 = ev_row.reshape(nq, n_probes * max_blocks)
    ev_valid2 = ev_valid.reshape(nq, n_probes * max_blocks)
    safe_rows = jnp.clip(ev_row3, 0, g_total * group_q - 1)
    # full-width row gather (see _pack_panels for why the table is
    # 128-column aligned): one gather regroups scores AND lanes
    ev = table[safe_rows]               # (nq, maxBQ, W)
    ev_top = jnp.where(ev_valid2[:, :, None], ev[..., :kk], -jnp.inf)
    ev_lane = ev[..., kk:2 * kk].astype(jnp.int32)

    flat_top = ev_top.reshape(nq, -1)
    k_eff = min(k, flat_top.shape[1])  # row_k < k shrinks the pool
    top_scores, arg = jax.lax.top_k(flat_top, k_eff)
    which_ev = arg // kk
    lane_sel = jnp.take_along_axis(
        ev_lane.reshape(nq, -1), arg, axis=1
    )
    block_sel = jnp.take_along_axis(
        ev_block.reshape(nq, -1), which_ev, axis=1
    )
    pos = jnp.clip(block_sel * br + lane_sel, 0, layout.n_rows - 1)
    ids = layout.row_map[pos]
    ids = jnp.where(jnp.isfinite(top_scores), ids, -1).astype(jnp.int32)
    if k_eff < k:
        pad = k - k_eff
        ids = jnp.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        top_scores = jnp.pad(top_scores, ((0, 0), (0, pad)),
                             constant_values=-jnp.inf)

    safe = jnp.clip(probe_ids, 0, full_counts.shape[0] - 1)
    n_cand = jnp.sum(
        jnp.where(probe_valid, full_counts[safe], 0), axis=1, dtype=jnp.int32
    )
    # int8 scores are already dequantised (a global scale folds into
    # extend_queries, per-row scales multiply in _dequant_bias)
    return ids, top_scores, n_cand


def serving_query_grouped(
    layout: ServingLayout,
    queries: Array,
    probe_ids: Array,
    probe_valid: Array,
    full_counts: Array,
    k: int,
    query_chunk: int = 16384,
    group_q: int | None = None,
    row_k: int | None = None,
    g_total_override: int | None = None,
) -> tuple[Array, Array, Array]:
    """Bucket-grouped serving path: block events are sorted by bucket
    block and the queries sharing a block are scored against it with
    one batched matrix product (:func:`block_scores`).  Score dots run
    at precision HIGHEST with f32 queries — a bf16 layout only rounds
    corpus *storage* (halves the bytes read).  Exact whenever
    ``layout.cap`` covers the probed buckets.

    The group table is sized by a static bound (layout blocks + events
    / G) — NO host sync, one compiled shape per (layout, chunk shape).

    ``row_k`` (default ``k``) bounds the per-BLOCK top-k pre-filter —
    exact whenever the caller needs at most ``row_k`` DISTINCT corpus
    rows (multi-table stacks fetch ``k*L`` to survive cross-table
    duplicate collapse, but any single block holds distinct rows, so
    ``row_k=k`` per block suffices).

    ``g_total_override``: serve time is ~linear in the group-table size,
    and the no-sync static bound is tight only when many queries share
    each probed bucket (events/bucket >> group_q).  Low-multiplicity
    probe batches (e.g. multi-table ensembles at hash_times=1) can pass
    the EXACT group count (:func:`grouped_exact_bound` on the host) —
    one tiny host sync that halves-or-better the group table.
    """
    if group_q is None:
        group_q = int(os.environ.get("NLSH_GROUP_Q", 32))
    max_blocks = layout.cap // layout.br

    def bound(c_pad, pid):
        g_bound = (g_total_override if g_total_override is not None
                   else grouped_static_bound(
                       c_pad * pid.shape[1], max_blocks,
                       layout.total_blocks, group_q))
        return max(int(g_bound), 1)

    def call(qs, pid, pv, g_total):
        return _grouped_query_jit(
            layout, qs, pid, pv, full_counts,
            k=k, g_total=g_total, max_blocks=max_blocks, group_q=group_q,
            row_k=row_k,
        )

    return _chunked_serve(queries, probe_ids, probe_valid, query_chunk,
                          bound, call)


@partial(jax.jit, static_argnames=("k", "g_total", "max_sub", "group_q",
                                   "row_k"))
def _windowed_query_jit(layout, queries, probe_ids, probe_valid, full_counts,
                        k: int, g_total: int, max_sub: int, group_q: int,
                        row_k: int | None = None):
    br = layout.br  # static (rides the layout's pytree aux)
    qe = extend_queries(layout, queries)  # f32 (see grouped-path note)
    grp_window, grp_qvecs, grp_lo, grp_hi, ev_row, ev_window, ev_valid = (
        _windowed_prep(
            layout.starts, layout.counts, probe_ids, probe_valid, qe,
            jnp.asarray(layout.cap, jnp.int32), g_total=g_total,
            max_sub=max_sub, group_q=group_q, block_rows=br,
        )
    )

    scores = block_scores(layout.data, grp_qvecs, grp_window,
                          block_rows=br)  # (g, G, W)
    scores = _dequant_bias(layout, scores, grp_window)
    lane = jnp.arange(br, dtype=jnp.int32)
    scores = jnp.where(
        (lane[None, None, :] >= grp_lo[:, :, None])
        & (lane[None, None, :] < grp_hi[:, :, None]),
        scores, -jnp.inf,
    )
    table, kk = _row_topk_table(scores, k, row_k)

    nq, n_probes = probe_ids.shape
    ev_row3 = ev_row.reshape(nq, n_probes * max_sub)
    ev_valid2 = ev_valid.reshape(nq, n_probes * max_sub)
    safe_rows = jnp.clip(ev_row3, 0, g_total * group_q - 1)
    # full-width row gather (see _pack_panels)
    ev = table[safe_rows]               # (nq, maxPJ, W)
    ev_top = jnp.where(ev_valid2[:, :, None], ev[..., :kk], -jnp.inf)
    ev_lane = ev[..., kk:2 * kk].astype(jnp.int32)

    flat_top = ev_top.reshape(nq, -1)
    k_eff = min(k, flat_top.shape[1])
    top_scores, arg = jax.lax.top_k(flat_top, k_eff)
    which_ev = arg // kk
    lane_sel = jnp.take_along_axis(ev_lane.reshape(nq, -1), arg, axis=1)
    window_sel = jnp.take_along_axis(
        ev_window.reshape(nq, -1), which_ev, axis=1
    )
    pos = jnp.clip(window_sel * br + lane_sel, 0, layout.n_rows - 1)
    ids = layout.row_map[pos]
    ids = jnp.where(jnp.isfinite(top_scores), ids, -1).astype(jnp.int32)
    if k_eff < k:
        pad = k - k_eff
        ids = jnp.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        top_scores = jnp.pad(top_scores, ((0, 0), (0, pad)),
                             constant_values=-jnp.inf)

    safe = jnp.clip(probe_ids, 0, full_counts.shape[0] - 1)
    n_cand = jnp.sum(
        jnp.where(probe_valid, full_counts[safe], 0), axis=1, dtype=jnp.int32
    )
    # int8 scores are already dequantised (see the grouped path)
    return ids, top_scores, n_cand


def serving_query_windowed(
    layout: ServingLayout,
    queries: Array,
    probe_ids: Array,
    probe_valid: Array,
    full_counts: Array,
    k: int,
    query_chunk: int = 16384,
    group_q: int | None = None,
    row_k: int | None = None,
    g_total_override: int | None = None,
) -> tuple[Array, Array, Array]:
    """Dense-window serving path — the low-occupancy engine.

    Works on ANY layout alignment (windows are fixed ``block_rows``-row
    tiles of the data array; bucket starts ride as [lo, hi) mask values,
    not block offsets), but pays off on DENSE layouts (``align=8``) of
    tables whose mean bucket is far below the block size: neighbouring
    buckets share windows, so the group count collapses from
    #probed-buckets to #probed-windows and the rows read carry no
    per-bucket padding.  Multi-table ensembles and 10M-row tables
    (mean bucket far below the block size) are the targets;
    dense tables with big buckets should keep the grouped engine.
    Exact whenever ``layout.cap`` covers the probed buckets.
    """
    if group_q is None:
        group_q = int(os.environ.get("NLSH_GROUP_Q", GROUP_W))
    max_sub = layout.cap // layout.br + 1
    total_windows = layout.n_rows // layout.br

    def bound(c_pad, pid):
        g_bound = (g_total_override if g_total_override is not None
                   else windowed_static_bound(
                       c_pad * pid.shape[1], max_sub, total_windows,
                       group_q))
        return max(int(g_bound), 1)

    def call(qs, pid, pv, g_total):
        return _windowed_query_jit(
            layout, qs, pid, pv, full_counts,
            k=k, g_total=g_total, max_sub=max_sub, group_q=group_q,
            row_k=row_k,
        )

    return _chunked_serve(queries, probe_ids, probe_valid, query_chunk,
                          bound, call)
