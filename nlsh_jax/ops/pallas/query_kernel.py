"""Bucket-contiguous serving layouts and their XLA scorers.

The gather path (:mod:`nlsh_jax.index.query`) reads every candidate
row on its own.  The serving layout removes the scatter at its source:

* **Build time** (:func:`serving_layout`): corpus rows are *physically
  permuted into bucket order* and metric-extended, so every bucket is
  one contiguous run of rows.  Cosine rows are L2-normalised (score =
  q.c ranks by cosine distance); euclidean rows keep their values and
  carry ``||c||^2`` on ``norms``, with queries scaled by 2 (score =
  2q.c - ||c||^2 ranks by negative squared L2).  Higher score ==
  nearer, uniformly.
* **Query time**: probe events are grouped by the layout block (or
  dense window) they read, and each group's queries are scored against
  that block with one batched matrix product (:func:`block_scores`) at
  ``Precision.HIGHEST``.  Grouping, top-k selection and id mapping are
  in :mod:`nlsh_jax.index.serving`.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import os

import jax
import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray

LANE = 128  # feature dim padded to a multiple of this


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@jax.tree_util.register_pytree_node_class
class ServingLayout(NamedTuple):
    """Bucket-contiguous, metric-extended corpus for the serving path.

    Every bucket's run starts at an ``align``-row offset (a whole
    block for the grouped engine, 8 rows for the dense windowed one);
    ``row_map`` maps aligned positions back to original corpus rows
    (-1 on the alignment padding).  A pytree: array leaves (data, row_map, starts,
    counts); ``cap``/``d_pad``/``align``/``metric`` are static aux.
    """

    data: Array        # (n_aligned, d_pad) — bucket-major, aligned
    row_map: Array     # (n_aligned,) i32 — aligned pos -> corpus row, -1 pad
    starts: Array      # (n_buckets,) i32 — ALIGNED bucket offsets
    counts: Array      # (n_buckets,) i32
    cap: int           # static per-probe row cap (whole blocks)
    d_pad: int         # padded feature width
    align: int         # bucket start alignment in rows
    metric: str
    total_blocks: int = 0  # static sum_b ceil(min(count,cap)/BLOCK_ROWS);
    #                        0 = unknown (static group bounds fall back
    #                        to the event-count bound)
    norms: Array | None = None  # (n_aligned,) f32 ||c||^2 — euclidean
    #                             only; kept OUT of the feature block so
    #                             d=128 reads 128 columns, not 256, and
    #                             subtracted from the block scores
    block_rows: int = 0  # rows per scored block/window; 0 = the module
    #                      default at SERVE time.  Recorded per layout
    #                      (a layout built under one NLSH_BLOCK_ROWS and
    #                      served under another would mis-index blocks)
    #                      so low-occupancy tables (mean bucket << 512)
    #                      can use small blocks while dense ones keep 512
    scale: Array | None = None  # int8 dequant scale (int8 layouts only):
    #   () f32  — GLOBAL: data = round(ext / scale).  Folded into the
    #             query side by :func:`extend_queries` (qe *= scale), so
    #             block scores come out directly in dequantised-exact
    #             units — no post-top-k fixup, and euclidean works: the
    #             f32 ``norms`` (of the DEQUANTISED rows) subtract from
    #             already-dequantised dots.
    #   (n_aligned,) f32 — PER-ROW: each row quantised with its own
    #             ``max|ext_row|/127``; applied to the dots right after
    #             the score panels, BEFORE any cross-block merge.  Finer
    #             scales cut the storage-rounding recall cost of the
    #             global mode at 4 bytes/row.
    #   Either way every returned score is in exact-dot units and merges
    #   correctly with exactly-scored fresh rows, across shards and
    #   across ensemble tables — even when scales differ per shard.

    @property
    def n_rows(self) -> int:
        return self.row_map.shape[0]

    @property
    def br(self) -> int:
        """The layout's grouped-engine block size in rows."""
        return self.block_rows if self.block_rows else BLOCK_ROWS

    def tree_flatten(self):
        return (
            (self.data, self.row_map, self.starts, self.counts, self.norms,
             self.scale),
            (self.cap, self.d_pad, self.align, self.metric,
             self.total_blocks, self.block_rows),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        data, row_map, starts, counts, norms, scale = children
        cap, d_pad, align, metric, total_blocks, block_rows = aux
        return cls(data=data, row_map=row_map, starts=starts, counts=counts,
                   cap=cap, d_pad=d_pad, align=align, metric=metric,
                   total_blocks=total_blocks, norms=norms,
                   block_rows=block_rows, scale=scale)


def _check_scale_mode(scale_mode: str) -> None:
    if scale_mode not in ("global", "per_row"):
        raise ValueError(
            f"unknown int8 scale_mode {scale_mode!r} (global|per_row)"
        )
    # Euclidean int8 works in both modes: scores come out directly in
    # dequantised units (a global scale folds into the query side,
    # per-row scales apply before the norms subtraction), so the
    # ``2q.c - ||c||^2`` extension needs no post-hoc fixup.


def layout_arrays(row_ids: Array, starts: Array, counts: Array,
                  corpus: Array, cap: int, n_aligned: int,
                  metric: str, dtype=jnp.float32, align: int | None = None,
                  scale: Array | None = None):
    """Traceable layout-construction core (also used per-shard inside
    ``shard_map``): returns ``(data, row_map, aligned_starts, norms,
    scale_rows)`` with the static shapes ``(n_aligned, d_pad)`` /
    ``(n_aligned,)``; ``norms`` is None for cosine, ``scale_rows`` is
    None unless per-row int8.  See :func:`aligned_rows` for ``align``
    (must match the ``n_aligned`` it produced).

    ``dtype=jnp.int8`` quantises rows as ``round(ext / scale)`` clipped
    to [-127, 127]; ``scale`` is a () global scale (default
    ``max|ext| / 127`` over THIS corpus) or an ``(n,)`` per-corpus-row
    scale array (the per-row mode; scattered into aligned order exactly
    like ``norms``).  Euclidean ``norms`` are of the rows as STORED
    (dequantised int8, rounded bf16), so scores rank by exact distance
    to the stored points."""
    n, d = corpus.shape
    align = cap if align is None else align

    if metric == "cosine":
        nrm = jnp.linalg.norm(corpus, axis=1, keepdims=True)
        ext = corpus / jnp.maximum(nrm, 1e-12)
        sq = None
    elif metric in ("euclidean", "sq_euclidean"):
        # ||c||^2 rides a SEPARATE f32 array (subtracted from the block
        # scores) instead of a feature column — a d=128 corpus reads
        # 128 columns, not the 256 a d+1 column pads to
        ext = corpus
        sq = jnp.sum(corpus * corpus, axis=1)
    else:
        raise ValueError(f"unsupported serving metric {metric!r}")

    scale_per_row = None
    if jnp.dtype(dtype) == jnp.int8:
        if scale is None:
            scale = jnp.max(jnp.abs(ext)) / 127.0
        scale = jnp.asarray(scale, jnp.float32)
        div = scale if scale.ndim == 0 else \
            jnp.maximum(scale, 1e-30)[:, None]
        ext = jnp.clip(jnp.round(ext / div), -127, 127)
        if scale.ndim == 1:
            scale_per_row = jnp.maximum(scale, 1e-30)
        if sq is not None:  # norms of the dequantised rows (see above)
            eff = scale if scale.ndim == 0 else scale_per_row
            sq = jnp.sum(ext * ext, axis=1) * eff * eff
    elif sq is not None and jnp.dtype(dtype) != jnp.float32:
        # norms of the rows as stored (e.g. bf16-rounded), so scores
        # rank by exact distance to the stored points, as for int8
        stored = ext.astype(dtype).astype(jnp.float32)
        sq = jnp.sum(stored * stored, axis=1)

    d_ext = ext.shape[1]
    d_pad = _round_up(d_ext, LANE)

    # Aligned bucket offsets: each bucket run rounded up to `align`
    # rows so every bucket starts on a block boundary (≤ align-1 pad
    # rows per bucket; padding rows map to -1 and score -inf via counts).
    aligned_sizes = ((counts + align - 1) // align) * align
    aligned_starts = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32),
         jnp.cumsum(aligned_sizes, dtype=jnp.int32)[:-1]]
    )

    # aligned position of each bucket-sorted row
    i = jnp.arange(n, dtype=jnp.int32)
    bucket_of = (
        jnp.searchsorted(starts, i, side="right").astype(jnp.int32) - 1
    )
    aligned_pos = aligned_starts[bucket_of] + (i - starts[bucket_of])
    # rows past the real count (shard padding sorted to the tail) drop
    aligned_pos = jnp.where(
        i < jnp.sum(counts), aligned_pos, jnp.int32(n_aligned)
    )

    sorted_ext = jnp.take(ext, row_ids, axis=0)
    data = jnp.zeros((n_aligned, d_pad), dtype)
    data = data.at[aligned_pos, :d_ext].set(
        sorted_ext.astype(dtype), mode="drop"
    )
    row_map = jnp.full((n_aligned,), -1, jnp.int32)
    row_map = row_map.at[aligned_pos].set(row_ids, mode="drop")
    norms = None
    if sq is not None:
        norms = (
            jnp.zeros((n_aligned,), jnp.float32)
            .at[aligned_pos]
            .set(jnp.take(sq, row_ids).astype(jnp.float32), mode="drop")
        )
    scale_rows = None
    if scale_per_row is not None:
        # padding rows keep scale 1.0: their dots are garbage either way
        # and the occupancy mask lands AFTER the scale multiply, but a
        # 1.0 there can never manufacture inf/nan out of a masked lane
        scale_rows = (
            jnp.ones((n_aligned,), jnp.float32)
            .at[aligned_pos]
            .set(jnp.take(scale_per_row, row_ids), mode="drop")
        )
    return data, row_map, aligned_starts, norms, scale_rows


def ext_scales(corpus: Array, metric: str, scale_mode: str):
    """int8 quantisation scale(s) in metric-EXTENDED space: () f32 for
    ``"global"``, ``(n,)`` f32 for ``"per_row"``."""
    if metric == "cosine":
        nrm = jnp.linalg.norm(corpus, axis=1, keepdims=True)
        ext = corpus / jnp.maximum(nrm, 1e-12)
    else:
        ext = corpus
    if scale_mode == "global":
        return jnp.asarray(jnp.max(jnp.abs(ext)) / 127.0, jnp.float32)
    return (jnp.max(jnp.abs(ext), axis=1) / 127.0).astype(jnp.float32)


def ext_scales_host(corpus, metric: str, scale_mode: str):
    """Numpy twin of :func:`ext_scales` (bit-identical where it matters:
    both divide the same f32 maxima by 127)."""
    corpus = np.asarray(corpus)
    if metric == "cosine":
        nrm = np.linalg.norm(corpus, axis=1, keepdims=True)
        ext = corpus / np.maximum(nrm, 1e-12)
    else:
        ext = corpus
    if scale_mode == "global":
        return float(np.abs(ext).max() / 127.0)
    return (np.abs(ext).max(axis=1) / 127.0).astype(np.float32)


def round_cap(cap: int, block_rows: int | None = None) -> int:
    """cap is a whole number of block_rows-row blocks so the
    grouped/windowed engines (block index = start / block_rows) see
    exact block indices."""
    br = block_rows or BLOCK_ROWS
    return max(_round_up(cap, br), br)


def aligned_rows(counts, cap: int, align: int | None = None) -> int:
    """Static row count of a layout for given bucket counts.

    ``align`` is the per-bucket start alignment (default ``cap``).  The
    engines only index by ``start / BLOCK_ROWS``, so ``align=BLOCK_ROWS``
    shrinks the layout to ~``n + n_buckets*BLOCK_ROWS/2`` rows — at 10M
    rows x 16k buckets that is several-fold less device memory than
    ``align=cap``."""
    align = cap if align is None else align
    aligned_sizes = ((np.asarray(counts) + align - 1) // align) * align
    return int(aligned_sizes.sum()) + cap  # + cap: clamp slack


def serving_layout(table, corpus: Array, metric: str = "cosine",
                   cap: int | None = None,
                   dtype=jnp.float32, align: int | None = None,
                   block_rows: int | None = None,
                   scale_mode: str = "per_row") -> ServingLayout:
    """Build the serving layout from a CSR bucket table.

    ``cap`` is the per-probe row cap: buckets larger than ``cap`` are
    truncated at query time (the recall/bandwidth knob); default is
    the max bucket size rounded up to a whole block (exact).

    ``dtype=jnp.bfloat16`` halves the stored bytes at the cost of
    bf16 rerank precision — rank flips only among candidates whose
    distances differ below bf16 resolution.

    ``block_rows`` is the scored block size recorded on the layout
    (default: the module-level ``BLOCK_ROWS``); low-occupancy tables
    (mean bucket << 512) waste less padding with smaller blocks.

    ``scale_mode`` (int8 only): ``"per_row"`` (default — one scale per
    stored row, a smaller storage-rounding recall cost) or ``"global"``
    (one scale, zero per-row overhead — still exact-unit scores).
    """
    br = block_rows or BLOCK_ROWS
    if cap is None:
        cap = int(table.max_count())
    cap = round_cap(cap, br)
    align = cap if align is None else max(_round_up(align, 8), 8)
    counts_np = np.asarray(table.counts)
    # whole-window padding tail: every engine indexes blocks/windows of
    # br rows, so the data row count is a multiple of br
    n_aligned = _round_up(aligned_rows(counts_np, cap, align=align), br)
    total_blocks = int(
        (-(-np.minimum(counts_np, cap) // br)).sum()
    )
    scale = None
    if jnp.dtype(dtype) == jnp.int8:
        _check_scale_mode(scale_mode)
        scale = ext_scales(corpus, metric, scale_mode)
    data, row_map, aligned_starts, norms, scale_rows = layout_arrays(
        table.row_ids, table.starts, table.counts, corpus,
        cap=cap, n_aligned=n_aligned, metric=metric, dtype=dtype,
        align=align, scale=scale,
    )
    return ServingLayout(
        data=data, row_map=row_map, starts=aligned_starts,
        counts=table.counts, cap=cap, d_pad=data.shape[1], align=align,
        metric=metric, total_blocks=total_blocks, norms=norms,
        block_rows=br,
        scale=scale_rows if scale_rows is not None else scale,
    )


def layout_arrays_host(row_ids, starts, counts, corpus, cap: int,
                       n_aligned: int, metric: str, dtype=None,
                       align: int | None = None, scale=None):
    """Numpy twin of :func:`layout_arrays` for multi-million-row corpora.

    Permuting on the host keeps the full-corpus scatter and its
    transients off the device and out of the compiler — only dense,
    ready arrays are shipped.  Bit-identical to the traced builder
    (tested; int8 rounding is round-half-even on both sides)."""
    import ml_dtypes

    np_dtype = {None: np.float32, jnp.float32: np.float32,
                jnp.bfloat16: ml_dtypes.bfloat16,
                jnp.int8: np.int8}.get(dtype, dtype)
    row_ids = np.asarray(row_ids)
    starts = np.asarray(starts).astype(np.int64)
    counts = np.asarray(counts).astype(np.int64)
    corpus = np.asarray(corpus)
    align = cap if align is None else align

    if metric == "cosine":
        nrm = np.linalg.norm(corpus, axis=1, keepdims=True)
        ext = corpus / np.maximum(nrm, 1e-12)
        sq = None
    elif metric in ("euclidean", "sq_euclidean"):
        ext = corpus
        sq = np.einsum("nd,nd->n", corpus, corpus).astype(np.float32)
    else:
        raise ValueError(f"unsupported serving metric {metric!r}")

    scale_per_row = None
    if np.dtype(np_dtype) == np.int8:
        if scale is None:
            scale = float(np.abs(ext).max() / 127.0)
        scale = np.asarray(scale, np.float32)
        div = scale if scale.ndim == 0 else \
            np.maximum(scale, 1e-30)[:, None]
        ext = np.clip(np.round(ext / div), -127, 127)
        if scale.ndim == 1:
            scale_per_row = np.maximum(scale, np.float32(1e-30))
        if sq is not None:  # norms of the dequantised rows
            eff = scale if scale.ndim == 0 else scale_per_row
            sq = (np.einsum("nd,nd->n", ext, ext) * eff * eff
                  ).astype(np.float32)
    elif sq is not None and np.dtype(np_dtype) != np.float32:
        stored = ext.astype(np_dtype).astype(np.float32)  # as stored
        sq = np.einsum("nd,nd->n", stored, stored).astype(np.float32)

    d_ext = ext.shape[1]
    d_pad = _round_up(d_ext, LANE)

    aligned_sizes = ((counts + align - 1) // align) * align
    aligned_starts = np.concatenate(
        [[0], np.cumsum(aligned_sizes)[:-1]]
    ).astype(np.int64)

    i = np.arange(row_ids.shape[0], dtype=np.int64)
    bucket_of = np.searchsorted(starts, i, side="right") - 1
    aligned_pos = aligned_starts[bucket_of] + (i - starts[bucket_of])
    valid = i < counts.sum()  # shard padding sorts to the tail

    data = np.zeros((n_aligned, d_pad), np_dtype)
    row_map = np.full((n_aligned,), -1, np.int32)
    ap = aligned_pos[valid]
    rid = row_ids[valid]
    data[ap, :d_ext] = ext[rid].astype(np_dtype)
    row_map[ap] = rid
    norms = None
    if sq is not None:
        norms = np.zeros((n_aligned,), np.float32)
        norms[ap] = sq[rid]
    scale_rows = None
    if scale_per_row is not None:
        scale_rows = np.ones((n_aligned,), np.float32)
        scale_rows[ap] = scale_per_row[rid]
    return data, row_map, aligned_starts.astype(np.int32), norms, scale_rows


def serving_layout_host(table, corpus, metric: str = "cosine",
                        cap: int | None = None,
                        dtype=jnp.float32,
                        align: int | None = None,
                        block_rows: int | None = None,
                        scale_mode: str = "per_row") -> ServingLayout:
    """Host-built :func:`serving_layout`: same result, no device-side
    layout compile (the multi-million-row path, BASELINE config 5)."""
    br = block_rows or BLOCK_ROWS
    counts_np = np.asarray(table.counts)
    if cap is None:
        cap = int(counts_np.max())
    cap = round_cap(cap, br)
    align = cap if align is None else max(_round_up(align, 8), 8)
    n_aligned = _round_up(aligned_rows(counts_np, cap, align=align), br)
    total_blocks = int(
        (-(-np.minimum(counts_np, cap) // br)).sum()
    )
    scale = None
    if jnp.dtype(dtype) == jnp.int8:
        _check_scale_mode(scale_mode)
        scale = ext_scales_host(corpus, metric, scale_mode)
    data, row_map, aligned_starts, norms, scale_rows = layout_arrays_host(
        table.row_ids, table.starts, counts_np, corpus,
        cap=cap, n_aligned=n_aligned, metric=metric, dtype=dtype,
        align=align, scale=scale,
    )
    if scale_rows is not None:
        scale = jnp.asarray(scale_rows)
    elif scale is not None:
        scale = jnp.asarray(scale, jnp.float32)
    return ServingLayout(
        data=jnp.asarray(data), row_map=jnp.asarray(row_map),
        starts=jnp.asarray(aligned_starts),
        counts=jnp.asarray(counts_np.astype(np.int32)),
        cap=cap, d_pad=data.shape[1], align=align, metric=metric,
        total_blocks=total_blocks,
        norms=None if norms is None else jnp.asarray(norms),
        block_rows=br,
        scale=scale,
    )


def extend_queries(layout: ServingLayout, queries: Array) -> Array:
    """Metric-extend and pad queries to match :func:`serving_layout`.

    Euclidean queries are scaled by 2 (block score = 2q.c; the per-row
    ||c||^2 bias lives on ``layout.norms`` and is subtracted from the
    scores — together they rank by negative squared L2).

    A GLOBAL int8 scale folds in here (``qe *= scale``): the block
    dots then come out directly in dequantised units for every metric,
    so nothing downstream special-cases the global mode.  Per-row
    scales cannot fold (one query row serves many stored rows) and are
    applied at the score panels instead."""
    nq, d = queries.shape
    if layout.metric == "cosine":
        norms = jnp.linalg.norm(queries, axis=1, keepdims=True)
        ext = queries / jnp.maximum(norms, 1e-12)
    else:
        ext = 2.0 * queries
    if layout.scale is not None and layout.scale.ndim == 0:
        ext = ext * layout.scale
    # queries stay f32 regardless of layout dtype: the big side is the
    # corpus, and a bf16 query would add a second, avoidable rounding
    out = jnp.zeros((nq, layout.d_pad), jnp.float32)
    return out.at[:, : ext.shape[1]].set(ext.astype(jnp.float32))


# ---------------------------------------------------------------------------
# block size shared by the grouped/windowed engines
# ---------------------------------------------------------------------------

# DEFAULT rows per scored block.  NLSH_BLOCK_ROWS to experiment: bigger
# blocks mean fewer groups against more per-bucket padding rows.  512
# was chosen for an earlier accelerator and has not been re-measured on
# the GPU (ROADMAP).  The value is recorded per layout (``ServingLayout.block_rows``) at build time and
# every engine derives block indices from the layout's own value, so
# low-occupancy tables can be built with smaller blocks without any
# env coordination.
BLOCK_ROWS = int(os.environ.get("NLSH_BLOCK_ROWS", 512))


def _br(block_rows: int | None) -> int:
    """Resolve a per-call/per-layout block size to the module default."""
    return block_rows if block_rows else BLOCK_ROWS


GROUP_Q = 8  # default queries per group of :func:`_grouped_prep_v2`


def block_scores(data, grp_qvecs, grp_block, block_rows: int | None = None):
    """Score every group against its layout block: ``(g, G, block_rows)``.

    ``grp_qvecs`` ``(g, G, d_pad)`` f32 queries, ``grp_block`` ``(g,)``
    block (or window) index into ``data`` viewed as
    ``(n_aligned / block_rows, block_rows, d_pad)``.  A bf16 or int8
    layout is upcast before the product, so its only error is the
    storage rounding; the product runs at ``Precision.HIGHEST`` so an
    f32 layout scores exactly (no TF32 or bf16 passes).  The gathered
    ``(g, block_rows, d_pad)`` blocks are materialised."""
    br = _br(block_rows)
    blocks = data.reshape(-1, br, data.shape[-1])[grp_block]
    return jnp.einsum(
        "gqd,gbd->gqb", grp_qvecs.astype(jnp.float32),
        blocks.astype(jnp.float32),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )


def round_group_override(g_exact: int, static_bound: int) -> int:
    """Shared sync-bound recipe for the grouped/windowed serving paths:
    round a host-computed exact group bound up to a power of two
    (compile variants stay logarithmic across batch variation) and
    clamp to the no-sync static bound — a group table LARGER than
    static would cost more than the sync saves."""
    g = max(int(g_exact), 1)
    return int(min(1 << (g - 1).bit_length(), int(static_bound)))


def grouped_exact_bound(counts, probe_ids, probe_valid, cap: int,
                        group_q: int, block_rows: int | None = None) -> int:
    """EXACT group count of :func:`_grouped_prep_v2` for a concrete
    probe batch, computed on the host (numpy): ``sum_b nb_b *
    ceil(m_b/G)``.  Low-multiplicity batches (few queries per probed
    bucket) make :func:`grouped_static_bound` several-fold loose, and
    serve time is ~linear in the group table — the one small host sync
    (fetching the probe ids) pays for itself."""
    br = _br(block_rows)
    counts = np.asarray(counts)
    pid = np.asarray(probe_ids).reshape(-1)
    pv = np.asarray(probe_valid).reshape(-1)
    n_buckets = counts.shape[0]
    ok = pv & (pid >= 0) & (pid < n_buckets)
    m = np.bincount(pid[ok], minlength=n_buckets)
    nb = -(-np.minimum(counts, cap) // br)
    return int(np.sum(nb * -(-m // group_q)))


def grouped_static_bound(n_events: int, max_blocks: int, total_blocks: int,
                         group_q: int) -> int:
    """Static upper bound on the group count for ANY probe batch of
    ``n_events`` events against a layout with ``total_blocks`` occupied
    (bucket, block) cells: ``sum_b nb_b*ceil(m_b/G) <= sum_b nb_b*m_b/G
    + sum_{b probed} nb_b <= E*maxB/G + min(total_blocks, E*maxB)``.
    Needs no per-batch host sync to size the group tables.
    """
    block_events = n_events * max_blocks
    probed_blocks = min(total_blocks, block_events) if total_blocks > 0 \
        else block_events
    return int(-(-block_events // group_q) + probed_blocks)


# -- grouped prep v2: sort probe EVENTS (nq*P), never block events ---------
#
# The naive prep sorts the expanded block-event stream (nq*P*maxB keys);
# XLA's bitonic sort makes that the dominant cost.  All the grouping
# structure is derivable from the much smaller probe-event sort plus
# per-bucket histograms: within one bucket every event has the same
# count/blocks, so groups factor as (bucket, block j, rank-chunk).


def _sorted_probe_events(layout_starts, layout_counts, probe_ids,
                         probe_valid, cap):
    """Sort (query, probe) events by bucket id.  Returns per-sorted-event
    (bucket key, qidx, rank-in-bucket, m=bucket multiplicity, order)."""
    nq, n_probes = probe_ids.shape
    n_buckets = layout_counts.shape[0]
    safe = jnp.clip(probe_ids, 0, n_buckets - 1)
    counts = jnp.where(
        probe_valid, jnp.minimum(layout_counts[safe], cap), 0
    ).astype(jnp.int32)
    live = counts > 0  # contributes blocks

    key = jnp.where(live, safe, n_buckets).reshape(-1)  # (E,)
    order = jnp.argsort(key, stable=True).astype(jnp.int32)
    sk = key[order]
    sq = (jnp.repeat(jnp.arange(nq, dtype=jnp.int32), n_probes))[order]

    e = sk.shape[0]
    pos = jnp.arange(e, dtype=jnp.int32)
    unique = jnp.concatenate([jnp.ones((1,), bool), sk[1:] != sk[:-1]])
    first = jax.lax.associative_scan(jnp.maximum, jnp.where(unique, pos, -1))
    rank = pos - first

    # events per bucket (live only)
    hist = (
        jnp.zeros((n_buckets + 1,), jnp.int32)
        .at[key]
        .add(1, mode="drop")
    )
    m = hist[jnp.clip(sk, 0, n_buckets)]  # multiplicity of each event's bucket
    return sk, sq, rank, m, hist, order, counts


def _bucket_blocks(layout_counts, cap, block_rows: int | None = None):
    """Blocks per bucket under the cap: ceil(min(count, cap)/block_rows)."""
    capped = jnp.minimum(layout_counts, cap)
    return (-(-capped // _br(block_rows))).astype(jnp.int32)


@partial(jax.jit, static_argnames=("g_total", "max_blocks", "group_q",
                                   "block_rows"))
def _grouped_prep_v2(layout_starts, layout_counts, probe_ids, probe_valid,
                     queries_ext, cap, g_total: int, max_blocks: int,
                     group_q: int = GROUP_Q, block_rows: int | None = None):
    """Group tables + event->row map, with only an (nq*P)-key sort."""
    GROUP_Q = group_q
    BLOCK_ROWS = _br(block_rows)
    nq, n_probes = probe_ids.shape
    n_buckets = layout_counts.shape[0]
    sk, sq, rank, m, hist, order, counts = _sorted_probe_events(
        layout_starts, layout_counts, probe_ids, probe_valid, cap
    )
    nb_bucket = _bucket_blocks(layout_counts, cap, BLOCK_ROWS)  # (NB,)
    groups_per_j = -(-hist[:n_buckets] // GROUP_Q)  # ceil(m_b/G)
    groups_per_bucket = nb_bucket * groups_per_j
    group_base = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32),
         jnp.cumsum(groups_per_bucket, dtype=jnp.int32)[:-1]]
    )

    sk_safe = jnp.clip(sk, 0, n_buckets - 1)
    s_valid = sk < n_buckets
    base_block = (layout_starts[sk_safe] // BLOCK_ROWS).astype(jnp.int32)
    s_count = jnp.minimum(layout_counts[sk_safe], cap).astype(jnp.int32)
    s_nb = (-(-s_count // BLOCK_ROWS)).astype(jnp.int32)
    s_gpj = groups_per_j[sk_safe]
    s_gbase = group_base[sk_safe]

    # (sorted event, j) grid
    j = jnp.arange(max_blocks, dtype=jnp.int32)
    ev_valid_s = s_valid[:, None] & (j[None, :] < s_nb[:, None])  # (E, maxB)
    g = (
        s_gbase[:, None] + j[None, :] * s_gpj[:, None]
        + (rank // GROUP_Q)[:, None]
    )
    slot = (rank % GROUP_Q).astype(jnp.int32)
    g_safe = jnp.where(ev_valid_s, g, g_total)

    blockno = base_block[:, None] + j[None, :]
    cnt_ij = jnp.clip(s_count[:, None] - j[None, :] * BLOCK_ROWS, 0, BLOCK_ROWS)

    grp_block = (
        jnp.zeros((g_total,), jnp.int32)
        .at[g_safe.reshape(-1)].set(blockno.reshape(-1), mode="drop")
    )
    slot_b = jnp.broadcast_to(slot[:, None], g_safe.shape)
    grp_qidx = (
        jnp.zeros((g_total, GROUP_Q), jnp.int32)
        .at[g_safe.reshape(-1), slot_b.reshape(-1)]
        .set(jnp.broadcast_to(sq[:, None], g_safe.shape).reshape(-1),
             mode="drop")
    )
    grp_cnt = (
        jnp.zeros((g_total, GROUP_Q), jnp.int32)
        .at[g_safe.reshape(-1), slot_b.reshape(-1)]
        .set(cnt_ij.reshape(-1), mode="drop")
    )
    grp_qvecs = queries_ext[grp_qidx]

    # event rows back in ORIGINAL probe-event order: (E, maxB)
    row_sorted = jnp.where(ev_valid_s, g * GROUP_Q + slot[:, None], 0)
    e_total = nq * n_probes
    ev_row = (
        jnp.zeros((e_total, max_blocks), jnp.int32)
        .at[order].set(row_sorted)
    )
    ev_valid = (
        jnp.zeros((e_total, max_blocks), bool).at[order].set(ev_valid_s)
    )
    # block number per (event, j) in original order, for id mapping
    ev_block = (
        jnp.zeros((e_total, max_blocks), jnp.int32).at[order].set(blockno)
    )
    return grp_block, grp_qvecs, grp_cnt, ev_row, ev_block, ev_valid


# ---------------------------------------------------------------------------
# dense-window grouping — low-occupancy tables
# ---------------------------------------------------------------------------
#
# The grouped engine scores one group per (bucket block, <=G probing
# queries), so its floor is the number of DISTINCT PROBED (bucket,
# block) cells — and with block-aligned layouts every bucket owns at
# least one whole block.  Tables whose mean bucket is far below the
# block size (multi-table ensembles, 10M-row tables) therefore pay a
# full group AND a full block of mostly-padding rows per probed bucket.
#
# Here the layout is packed DENSE (bucket starts 8-row aligned, no
# per-bucket block padding) and the grouping unit is the fixed
# `block_rows`-row WINDOW of that dense layout: neighbouring buckets
# share windows, every query slot carries its bucket's [lo, hi) row
# range inside the window as data, and the scorer masks columns outside
# it.  Group count collapses from #probed-buckets to #probed-windows
# (~ n_rows/W of them in total), and the rows read are dense.
# A bucket spans at most cap//W + 1 windows (sub-events).

GROUP_W = 32  # default queries per windowed group


def windowed_exact_bound(starts, counts, probe_ids, probe_valid, cap: int,
                         group_q: int, block_rows: int | None = None) -> int:
    """EXACT group count of :func:`_windowed_prep` for a concrete probe
    batch, computed on the host (numpy): ``sum_w ceil(m_w/G)`` where
    ``m_w`` counts the window sub-events landing in window ``w``.

    The static bound charges every event ``max_sub`` sub-events plus one
    group per probed window; hash_times=1 ensemble batches (mean bucket
    far below the window) really produce ~1 sub-event per event and
    share windows heavily, leaving the static group table several-fold
    empty — and serve time is ~linear in the group TABLE, empty slots
    included.  Same trade as :func:`grouped_exact_bound`: one small
    host sync (fetching the probe ids) for a several-fold smaller
    dispatch."""
    W = _br(block_rows)
    starts = np.asarray(starts)
    counts = np.asarray(counts)
    pid = np.asarray(probe_ids).reshape(-1)
    pv = np.asarray(probe_valid).reshape(-1)
    n_buckets = counts.shape[0]
    ok = pv & (pid >= 0) & (pid < n_buckets)
    pid = pid[ok]
    ct = np.minimum(counts[pid], cap)
    st = starts[pid][ct > 0]
    ct = ct[ct > 0]
    w0 = st // W
    span = (st + ct - 1) // W - w0 + 1  # windows touched per event
    n_windows = int((starts[-1] + counts[-1] + W - 1) // W) + 1 \
        if starts.size else 1
    m = np.zeros(n_windows, np.int64)
    for j in range(int(span.max()) if span.size else 0):
        sel = span > j
        m += np.bincount(w0[sel] + j, minlength=n_windows)
    return int(np.sum(-(-m // group_q)))


@partial(jax.jit, static_argnames=("max_sub", "group_q", "n_windows",
                                   "block_rows"))
def windowed_needed_groups(layout_starts, layout_counts, probe_ids,
                           probe_valid, cap, max_sub: int, group_q: int,
                           n_windows: int, block_rows: int | None = None):
    """Device-side EXACT group count of :func:`_windowed_prep` for a
    probe batch — the same ``sum_w ceil(m_w/G)`` as
    :func:`windowed_exact_bound` but as a cheap jittable reduction
    (one scatter-add over ~n/W window bins), so a fused serving program
    can *guard* a calibrated group bound with ``lax.cond`` instead of
    paying a host sync per call (prep drops overflow groups silently —
    an unguarded too-small bound would lose candidates)."""
    W = _br(block_rows)
    n_buckets = layout_counts.shape[0]
    safe = jnp.clip(probe_ids, 0, n_buckets - 1)
    ct = jnp.where(
        probe_valid, jnp.minimum(layout_counts[safe], cap), 0
    ).astype(jnp.int32).reshape(-1)
    st = layout_starts[safe].astype(jnp.int32).reshape(-1)
    j = jnp.arange(max_sub, dtype=jnp.int32)
    wj = st[:, None] // W + j
    lo = jnp.maximum(st[:, None] - wj * W, 0)
    hi = jnp.minimum(st[:, None] + ct[:, None] - wj * W, W)
    sub_valid = (ct[:, None] > 0) & (hi > lo)
    m = (
        jnp.zeros((n_windows,), jnp.int32)
        .at[jnp.where(sub_valid, wj, n_windows)]
        .add(1, mode="drop")
    )
    return jnp.sum(-(-m // group_q))


def windowed_static_bound(n_events: int, max_sub: int, total_windows: int,
                          group_q: int) -> int:
    """Static upper bound on the windowed group count for ANY probe
    batch of ``n_events`` events: ``sum_w ceil(m_w/G) <= sum_w m_w/G +
    #probed windows <= E*maxJ/G + min(total_windows, E*maxJ)``.  Dense
    layouts make ``total_windows ~ n/W``, so this is tight without any
    host sync even at high query counts."""
    sub_events = n_events * max_sub
    probed = min(total_windows, sub_events) if total_windows > 0 \
        else sub_events
    return int(-(-sub_events // group_q) + probed)


@partial(jax.jit, static_argnames=("g_total", "max_sub", "group_q",
                                   "block_rows"))
def _windowed_prep(layout_starts, layout_counts, probe_ids, probe_valid,
                   queries_ext, cap, g_total: int, max_sub: int,
                   group_q: int = GROUP_W, block_rows: int | None = None):
    """Expand (query, probe) events into window sub-events, sort by
    window, and build the group tables.

    Returns ``(grp_window (g,), grp_qvecs (g, G, d), grp_lo (g, G),
    grp_hi (g, G), ev_row (E, maxJ), ev_window (E, maxJ),
    ev_valid (E, maxJ))`` — empty group slots carry lo=hi=0 (masked).
    The sort is over ``E*maxJ`` keys (maxJ = cap//W + 1, usually 2),
    unlike the deleted v1 block-event sort whose key count scaled with
    cap/W per event.
    """
    W = _br(block_rows)
    nq, n_probes = probe_ids.shape
    n_buckets = layout_counts.shape[0]
    safe = jnp.clip(probe_ids, 0, n_buckets - 1)
    counts = jnp.where(
        probe_valid, jnp.minimum(layout_counts[safe], cap), 0
    ).astype(jnp.int32)
    starts = layout_starts[safe].astype(jnp.int32)

    e = nq * n_probes
    st = starts.reshape(e)
    ct = counts.reshape(e)
    j = jnp.arange(max_sub, dtype=jnp.int32)
    wj = st[:, None] // W + j  # (E, maxJ) candidate windows
    lo = jnp.maximum(st[:, None] - wj * W, 0)
    hi = jnp.minimum(st[:, None] + ct[:, None] - wj * W, W)
    sub_valid = (ct[:, None] > 0) & (hi > lo)
    qidx = jnp.repeat(jnp.arange(nq, dtype=jnp.int32), n_probes)  # (E,)

    big = jnp.int32(2**30)
    key = jnp.where(sub_valid, wj, big).reshape(-1)  # (E*maxJ,)
    order = jnp.argsort(key, stable=True).astype(jnp.int32)
    sk = key[order]
    s_lo = lo.reshape(-1)[order]
    s_hi = jnp.where(sub_valid, hi, 0).reshape(-1)[order]
    s_q = jnp.broadcast_to(qidx[:, None], (e, max_sub)).reshape(-1)[order]

    t = sk.shape[0]
    svalid = sk < big
    pos = jnp.arange(t, dtype=jnp.int32)
    unique = jnp.concatenate([jnp.ones((1,), bool), sk[1:] != sk[:-1]])
    first = jax.lax.associative_scan(jnp.maximum, jnp.where(unique, pos, -1))
    rank = pos - first
    new_group = (unique | (rank % group_q == 0)) & svalid
    g = jnp.cumsum(new_group, dtype=jnp.int32) - 1
    slot = (rank % group_q).astype(jnp.int32)
    g_safe = jnp.where(svalid, g, g_total)

    grp_window = (
        jnp.zeros((g_total,), jnp.int32)
        .at[g_safe].set(jnp.where(svalid, sk, 0), mode="drop")
    )
    grp_qidx = (
        jnp.zeros((g_total, group_q), jnp.int32)
        .at[g_safe, slot].set(s_q, mode="drop")
    )
    grp_lo = (
        jnp.zeros((g_total, group_q), jnp.int32)
        .at[g_safe, slot].set(s_lo, mode="drop")
    )
    grp_hi = (  # zeros: empty slots mask every lane
        jnp.zeros((g_total, group_q), jnp.int32)
        .at[g_safe, slot].set(s_hi, mode="drop")
    )
    grp_qvecs = queries_ext[grp_qidx]

    row_sorted = jnp.where(svalid, g * group_q + slot, 0)
    ev_row = (
        jnp.zeros((t,), jnp.int32).at[order].set(row_sorted)
    ).reshape(e, max_sub)
    ev_valid = (
        jnp.zeros((t,), bool).at[order].set(svalid)
    ).reshape(e, max_sub)
    ev_window = (
        jnp.zeros((t,), jnp.int32)
        .at[order].set(jnp.where(svalid, sk, 0))
    ).reshape(e, max_sub)
    return grp_window, grp_qvecs, grp_lo, grp_hi, ev_row, ev_window, ev_valid
