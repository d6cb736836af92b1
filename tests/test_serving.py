"""Serving query path tests (grouped / windowed layout engines),
checked against the XLA gather reference pipeline."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nlsh_jax.index.bucket_table import build_bucket_table
from nlsh_jax.index.indexer import Indexer
from nlsh_jax.index.query import query_bucket_table
from nlsh_jax.index.serving import (
    serving_query_grouped,
    serving_query_windowed,
)
from nlsh_jax.models.encoders import MLPEncoder
from nlsh_jax.models.hashings import MultivariateBernoulli
from nlsh_jax.ops.pallas.query_kernel import serving_layout


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_serving_matches_xla_path(metric):
    rng = np.random.default_rng(0)
    n, d, nb, nq, P, k = 400, 24, 16, 33, 5, 7
    corpus = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    queries = jnp.asarray(rng.normal(size=(nq, d)).astype(np.float32))
    bucket_ids = jnp.asarray(rng.integers(0, nb, n).astype(np.int32))
    probe_raw = np.sort(rng.integers(0, nb, (nq, P)).astype(np.int32), axis=1)
    probe_valid = np.concatenate(
        [np.ones((nq, 1), bool), probe_raw[:, 1:] != probe_raw[:, :-1]], axis=1
    )
    probe_ids = jnp.asarray(probe_raw)
    probe_valid = jnp.asarray(probe_valid)

    table = build_bucket_table(bucket_ids, nb)
    x_top, x_dist, x_cand = query_bucket_table(
        table, corpus, queries, probe_ids, probe_valid, k=k,
        probe_budget=int(table.max_count()), metric=metric, query_chunk=8,
    )

    # the windowed engine on a cap-aligned layout (windows work on any
    # alignment)
    layout = serving_layout(table, corpus, metric=metric)
    s_top, s_scores, s_cand = serving_query_windowed(
        layout, queries, probe_ids, probe_valid, table.counts, k=k,
    )

    np.testing.assert_array_equal(np.asarray(s_cand), np.asarray(x_cand))
    # same candidates in the same distance order (ties aside)
    x_top, s_top = np.asarray(x_top), np.asarray(s_top)
    agree = (x_top == s_top).mean()
    assert agree > 0.98, f"only {agree:.3f} of top-k ids agree"
    # score monotonicity: scores descend where valid
    s_scores = np.asarray(s_scores)
    for i in range(nq):
        v = s_scores[i][np.isfinite(s_scores[i])]
        assert (np.diff(v) <= 1e-5).all()


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_grouped_matches_xla_path(metric):
    rng = np.random.default_rng(6)
    n, d, nb, nq, P, k = 600, 24, 16, 33, 5, 7
    corpus = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    queries = jnp.asarray(rng.normal(size=(nq, d)).astype(np.float32))
    bucket_ids = jnp.asarray(rng.integers(0, nb, n).astype(np.int32))
    probe_raw = np.sort(rng.integers(0, nb, (nq, P)).astype(np.int32), axis=1)
    probe_valid = np.concatenate(
        [np.ones((nq, 1), bool), probe_raw[:, 1:] != probe_raw[:, :-1]], axis=1
    )
    probe_ids = jnp.asarray(probe_raw)
    probe_valid = jnp.asarray(probe_valid)

    table = build_bucket_table(bucket_ids, nb)
    x_top, _, x_cand = query_bucket_table(
        table, corpus, queries, probe_ids, probe_valid, k=k,
        probe_budget=int(table.max_count()), metric=metric, query_chunk=8,
    )
    layout = serving_layout(table, corpus, metric=metric)
    g_top, g_scores, g_cand = serving_query_grouped(
        layout, queries, probe_ids, probe_valid, table.counts, k=k,
    )
    np.testing.assert_array_equal(np.asarray(g_cand), np.asarray(x_cand))
    assert (np.asarray(x_top) == np.asarray(g_top)).mean() > 0.98
    s = np.asarray(g_scores)
    for i in range(nq):
        v = s[i][np.isfinite(s[i])]
        assert (np.diff(v) <= 1e-5).all()


def test_serving_cap_truncation():
    """cap smaller than the biggest bucket truncates candidates but keeps
    full occupancy in n_candidates."""
    rng = np.random.default_rng(1)
    corpus = jnp.asarray(rng.normal(size=(64, 8)).astype(np.float32))
    bucket_ids = jnp.zeros(64, jnp.int32)  # all in bucket 0
    table = build_bucket_table(bucket_ids, 4)
    layout = serving_layout(table, corpus, metric="cosine", cap=16)
    probe_ids = jnp.zeros((3, 1), jnp.int32)
    probe_valid = jnp.ones((3, 1), bool)
    ids, scores, ncand = serving_query_grouped(
        layout, corpus[:3], probe_ids, probe_valid, table.counts, k=4,
    )
    assert (np.asarray(ncand) == 64).all()
    assert (np.asarray(ids) >= 0).all()
    assert np.isfinite(np.asarray(scores)).all()


def test_indexer_pallas_engine_matches_xla():
    rng = np.random.default_rng(2)
    corpus = rng.normal(size=(512, 16)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    hashing = MultivariateBernoulli(MLPEncoder(16, (32,)), 5)
    params = hashing.init(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(3)

    idx_x = Indexer(hashing, params, jnp.asarray(corpus), metric="cosine",
                    engine="xla")
    idx_p = Indexer(hashing, params, jnp.asarray(corpus), metric="cosine",
                    engine="grouped")
    t1, c1 = idx_x.query(jnp.asarray(corpus[:32]), k=5, hash_times=4, key=key)
    t2, c2 = idx_p.query(jnp.asarray(corpus[:32]), k=5, hash_times=4, key=key)
    np.testing.assert_array_equal(c1, c2)
    assert (t1 == t2).mean() > 0.98
    assert (t2[:, 0] == np.arange(32)).all()  # self-retrieval


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_host_layout_matches_device_layout(metric, dtype):
    """layout_arrays_host must be bit-identical to the traced builder —
    it replaces it above Indexer.HOST_LAYOUT_ROWS (config 5 path).
    int8 covers the quantisation too (round-half-even on both sides)."""
    from nlsh_jax.ops.pallas.query_kernel import serving_layout_host

    dt = {"bf16": jnp.bfloat16, "int8": jnp.int8,
          "f32": jnp.float32}[dtype]
    rng = np.random.default_rng(7)
    n, d, nb = 700, 20, 32
    corpus = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    bucket_ids = jnp.asarray(rng.integers(0, nb, n).astype(np.int32))
    table = build_bucket_table(bucket_ids, nb)

    dev = serving_layout(table, corpus, metric=metric, cap=128, dtype=dt)
    host = serving_layout_host(table, np.asarray(corpus), metric=metric,
                               cap=128, dtype=dt)
    assert host.cap == dev.cap and host.d_pad == dev.d_pad
    assert host.total_blocks == dev.total_blocks
    np.testing.assert_array_equal(np.asarray(host.row_map),
                                  np.asarray(dev.row_map))
    np.testing.assert_array_equal(np.asarray(host.starts),
                                  np.asarray(dev.starts))
    np.testing.assert_allclose(
        np.asarray(host.data, np.float32), np.asarray(dev.data, np.float32),
        rtol=1e-6,
        # int8: a last-ulp ext difference at a rounding boundary can
        # flip one quantisation level
        atol=1 if dtype == "int8" else 1e-7,
    )
    if metric == "euclidean":
        np.testing.assert_allclose(np.asarray(host.norms),
                                   np.asarray(dev.norms), rtol=1e-5)
    else:
        assert host.norms is None and dev.norms is None
    if dtype == "int8":  # per-row scales (the default) on both sides
        assert host.scale.ndim == 1 and dev.scale.ndim == 1
        np.testing.assert_allclose(np.asarray(host.scale),
                                   np.asarray(dev.scale), rtol=1e-6)


def test_indexer_host_layout_mode_matches_device():
    rng = np.random.default_rng(11)
    n, d = 3000, 16
    corpus = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    queries = jnp.asarray(rng.normal(size=(64, d)).astype(np.float32))
    enc = MLPEncoder(input_dim=d, hidden_dims=(16,))
    hashing = MultivariateBernoulli(enc, 5)
    params = hashing.init(jax.random.PRNGKey(0))

    tops = []
    for mode in ("device", "host"):
        idx = Indexer(hashing, params, corpus, metric="cosine",
                      engine="grouped", layout_mode=mode)
        top, n_cand = idx.query(queries, k=5, hash_times=4,
                                key=jax.random.PRNGKey(2))
        tops.append((top, n_cand))
    np.testing.assert_array_equal(tops[0][0], tops[1][0])
    np.testing.assert_array_equal(tops[0][1], tops[1][1])


def test_query_async_fetch_matches_query():
    """query_async + fetch must reproduce query() on both engines —
    the pipelined serving path is the benchmarked path."""
    rng = np.random.default_rng(5)
    corpus = rng.normal(size=(512, 16)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    hashing = MultivariateBernoulli(MLPEncoder(16, (32,)), 5)
    params = hashing.init(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(3)
    queries = jnp.asarray(corpus[:32])

    for engine in ("xla", "grouped", "windowed"):
        idx = Indexer(hashing, params, jnp.asarray(corpus), metric="cosine",
                      engine=engine)
        t1, c1 = idx.query(queries, k=5, hash_times=4, key=key)
        t2, c2 = idx.fetch(idx.query_async(queries, k=5, hash_times=4,
                                           key=key))
        np.testing.assert_array_equal(t1, t2)
        np.testing.assert_array_equal(c1, c2)


def test_fused_serve_batched_fresh_pool():
    """A ``(repeats, nq, d)`` fresh-query pool must serve each repeat
    exactly as a standalone ``_fused_serve`` of that batch (the bench's
    pipelined-timing path, VERDICT r3 weak #7), and reject a pool whose
    leading dim disagrees with ``repeats``."""
    from nlsh_jax.index.indexer import _fused_serve, _fused_serve_batched

    rng = np.random.default_rng(11)
    corpus = rng.normal(size=(512, 16)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    hashing = MultivariateBernoulli(MLPEncoder(16, (32,)), 5)
    params = hashing.init(jax.random.PRNGKey(0))
    idx = Indexer(hashing, params, jnp.asarray(corpus), metric="cosine",
                  engine="grouped")
    key = jax.random.PRNGKey(7)
    R, nq = 3, 32
    pool = jnp.asarray(
        rng.normal(size=(R, nq, 16)).astype(np.float32))
    pool = pool / jnp.linalg.norm(pool, axis=-1, keepdims=True)

    out = _fused_serve_batched(
        hashing, params, idx.layout, idx.table.counts, pool, key,
        k=5, hash_times=4, probe_mode="flip", engine="grouped", repeats=R,
    )
    assert out.shape == (R, nq, 6)
    for i in range(R):
        ref = _fused_serve(
            hashing, params, idx.layout, idx.table.counts, pool[i],
            jax.random.fold_in(key, i), k=5, hash_times=4,
            probe_mode="flip", engine="grouped",
        )
        np.testing.assert_array_equal(np.asarray(out[i]), np.asarray(ref))

    with pytest.raises(ValueError, match="fresh-query pool"):
        _fused_serve_batched(
            hashing, params, idx.layout, idx.table.counts, pool, key,
            k=5, hash_times=4, probe_mode="flip", engine="grouped",
            repeats=R + 1,
        )


def test_grouped_block_aligned_layout_matches_cap_aligned():
    """align=BLOCK_ROWS layouts (the 10M-scale memory fix) must serve
    identically to cap-aligned layouts through the grouped engine, for
    both the traced and the host builder."""
    from nlsh_jax.index.serving import serving_query_grouped
    from nlsh_jax.ops.pallas.query_kernel import (
        BLOCK_ROWS, serving_layout_host,
    )

    rng = np.random.default_rng(11)
    n, d, nb, nq, P, k = 900, 24, 8, 17, 4, 7
    corpus = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    queries = jnp.asarray(rng.normal(size=(nq, d)).astype(np.float32))
    # skewed buckets so cap (max bucket) >> BLOCK_ROWS-aligned sizes
    bucket_ids = jnp.asarray(
        np.minimum(rng.geometric(0.4, n) - 1, nb - 1).astype(np.int32)
    )
    probe_raw = np.sort(rng.integers(0, nb, (nq, P)).astype(np.int32), axis=1)
    probe_valid = jnp.asarray(np.concatenate(
        [np.ones((nq, 1), bool), probe_raw[:, 1:] != probe_raw[:, :-1]],
        axis=1,
    ))
    probe_ids = jnp.asarray(probe_raw)
    table = build_bucket_table(bucket_ids, nb)

    for metric in ("cosine", "euclidean"):
        ref_layout = serving_layout(table, corpus, metric=metric)
        r_top, r_scores, r_cand = serving_query_grouped(
            ref_layout, queries, probe_ids, probe_valid, table.counts, k=k,
        )
        for build in (serving_layout, serving_layout_host):
            layout = build(table, corpus, metric=metric, align=BLOCK_ROWS)
            assert layout.align == BLOCK_ROWS
            if BLOCK_ROWS < ref_layout.cap:  # else align == cap: same size
                assert layout.data.shape[0] < ref_layout.data.shape[0]
            g_top, g_scores, g_cand = serving_query_grouped(
                layout, queries, probe_ids, probe_valid, table.counts, k=k,
            )
            np.testing.assert_array_equal(np.asarray(g_cand),
                                          np.asarray(r_cand))
            np.testing.assert_array_equal(np.asarray(g_top),
                                          np.asarray(r_top))
            # host-built euclidean norms (np.einsum) differ from the
            # traced ones (jnp.sum) in the last ulps; ids above are the
            # exact check
            np.testing.assert_allclose(np.asarray(g_scores),
                                       np.asarray(r_scores),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("serve_name", ["grouped", "windowed"])
def test_chunked_serve_matches_single_chunk(serve_name):
    """The shared pad/chunk/concat scaffold (query_chunk smaller than
    nq, tail chunk padded to the full chunk shape) must return exactly
    the single-chunk results."""
    serve = {"grouped": serving_query_grouped,
             "windowed": serving_query_windowed}[serve_name]
    rng = np.random.default_rng(29)
    n, d, nb, nq, P, k = 500, 24, 16, 21, 5, 7
    corpus = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    queries = jnp.asarray(rng.normal(size=(nq, d)).astype(np.float32))
    bucket_ids = jnp.asarray(rng.integers(0, nb, n).astype(np.int32))
    probe_raw = np.sort(rng.integers(0, nb, (nq, P)).astype(np.int32), axis=1)
    probe_valid = jnp.asarray(np.concatenate(
        [np.ones((nq, 1), bool), probe_raw[:, 1:] != probe_raw[:, :-1]],
        axis=1,
    ))
    probe_ids = jnp.asarray(probe_raw)
    table = build_bucket_table(bucket_ids, nb)
    align = 8 if serve_name == "windowed" else None
    layout = serving_layout(table, corpus, metric="cosine", align=align)

    ref = serve(layout, queries, probe_ids, probe_valid, table.counts,
                k=k)
    out = serve(layout, queries, probe_ids, probe_valid, table.counts,
                k=k, query_chunk=8)  # 8 + 8 + tail 5
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_grouped_exact_bound_override_matches_static():
    """The host-computed exact group bound must allocate enough groups:
    serving with g_total_override=exact bound returns exactly the
    static-bound results (no event truncation)."""
    from nlsh_jax.index.serving import serving_query_grouped
    from nlsh_jax.ops.pallas.query_kernel import grouped_exact_bound

    rng = np.random.default_rng(21)
    n, d, nb, nq, P, k = 700, 24, 16, 29, 5, 7
    corpus = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    queries = jnp.asarray(rng.normal(size=(nq, d)).astype(np.float32))
    bucket_ids = jnp.asarray(
        np.minimum(rng.geometric(0.3, n) - 1, nb - 1).astype(np.int32)
    )
    probe_raw = np.sort(rng.integers(0, nb, (nq, P)).astype(np.int32), axis=1)
    probe_valid = jnp.asarray(np.concatenate(
        [np.ones((nq, 1), bool), probe_raw[:, 1:] != probe_raw[:, :-1]],
        axis=1,
    ))
    probe_ids = jnp.asarray(probe_raw)
    table = build_bucket_table(bucket_ids, nb)
    layout = serving_layout(table, corpus, metric="cosine")

    ref = serving_query_grouped(
        layout, queries, probe_ids, probe_valid, table.counts, k=k,
    )
    g_exact = grouped_exact_bound(
        np.asarray(table.counts), np.asarray(probe_ids),
        np.asarray(probe_valid), layout.cap, 32,
    )
    out = serving_query_grouped(
        layout, queries, probe_ids, probe_valid, table.counts, k=k,
        group_q=32, g_total_override=g_exact,
    )
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("block_rows", [128, 256])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_per_layout_block_rows(metric, block_rows):
    """Layouts built with a non-default block size must serve correctly
    through every engine that derives block indices from the layout
    (round-2 VERDICT #10: the 10M low-occupancy config wants 128-row
    blocks while glove-shape keeps 512)."""
    rng = np.random.default_rng(33)
    n, d, nb, nq, P, k = 900, 24, 16, 31, 5, 7
    corpus = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    queries = jnp.asarray(rng.normal(size=(nq, d)).astype(np.float32))
    bucket_ids = jnp.asarray(rng.integers(0, nb, n).astype(np.int32))
    probe_raw = np.sort(rng.integers(0, nb, (nq, P)).astype(np.int32), axis=1)
    probe_valid = jnp.asarray(np.concatenate(
        [np.ones((nq, 1), bool), probe_raw[:, 1:] != probe_raw[:, :-1]],
        axis=1,
    ))
    probe_ids = jnp.asarray(probe_raw)

    table = build_bucket_table(bucket_ids, nb)
    x_top, _, x_cand = query_bucket_table(
        table, corpus, queries, probe_ids, probe_valid, k=k,
        probe_budget=int(table.max_count()), metric=metric, query_chunk=8,
    )
    layout = serving_layout(table, corpus, metric=metric,
                            block_rows=block_rows)
    assert layout.block_rows == block_rows
    assert layout.cap % block_rows == 0

    g_top, _, g_cand = serving_query_grouped(
        layout, queries, probe_ids, probe_valid, table.counts, k=k,
    )
    np.testing.assert_array_equal(np.asarray(g_cand), np.asarray(x_cand))
    assert (np.asarray(x_top) == np.asarray(g_top)).mean() > 0.98

    # block-aligned (grouped-only) layout at the same block size
    layout_ba = serving_layout(table, corpus, metric=metric,
                               block_rows=block_rows, align=block_rows)
    g2_top, _, _ = serving_query_grouped(
        layout_ba, queries, probe_ids, probe_valid, table.counts, k=k,
    )
    assert (np.asarray(g_top) == np.asarray(g2_top)).mean() > 0.98


@pytest.mark.parametrize("block_rows", [128, 512])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_windowed_matches_xla_path(metric, block_rows):
    """Dense-window engine (v5) against the XLA reference: dense
    8-row-aligned layout, buckets sharing windows, per-slot [lo, hi)
    masks; exact whenever cap covers the probed buckets."""
    rng = np.random.default_rng(41)
    n, d, nb, nq, P, k = 900, 24, 32, 33, 6, 7
    corpus = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    queries = jnp.asarray(rng.normal(size=(nq, d)).astype(np.float32))
    # skewed buckets: some span multiple windows, most share one
    bucket_ids = jnp.asarray(
        np.minimum(rng.geometric(0.15, n) - 1, nb - 1).astype(np.int32)
    )
    probe_raw = np.sort(rng.integers(0, nb, (nq, P)).astype(np.int32), axis=1)
    probe_valid = jnp.asarray(np.concatenate(
        [np.ones((nq, 1), bool), probe_raw[:, 1:] != probe_raw[:, :-1]],
        axis=1,
    ))
    probe_ids = jnp.asarray(probe_raw)

    table = build_bucket_table(bucket_ids, nb)
    x_top, _, x_cand = query_bucket_table(
        table, corpus, queries, probe_ids, probe_valid, k=k,
        probe_budget=int(table.max_count()), metric=metric, query_chunk=8,
    )
    layout = serving_layout(table, corpus, metric=metric, align=8,
                            block_rows=block_rows)
    assert layout.align == 8
    assert layout.n_rows % block_rows == 0
    # dense: layout carries at most 7 pad rows per bucket + window tail
    assert layout.n_rows <= n + 7 * nb + layout.cap + 2 * block_rows

    for row_k in (k, 64):  # narrow and wide per-window top-k
        w_top, w_scores, w_cand = serving_query_windowed(
            layout, queries, probe_ids, probe_valid, table.counts, k=k,
            row_k=row_k,
        )
        np.testing.assert_array_equal(np.asarray(w_cand), np.asarray(x_cand))
        assert (np.asarray(x_top) == np.asarray(w_top)).mean() > 0.98
        s = np.asarray(w_scores)
        for i in range(nq):
            v = s[i][np.isfinite(s[i])]
            assert (np.diff(v) <= 1e-5).all()


def test_indexer_windowed_engine():
    rng = np.random.default_rng(17)
    n, d, nq, k = 800, 16, 40, 5
    corpus = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    queries = jnp.asarray(rng.normal(size=(nq, d)).astype(np.float32))
    enc = MLPEncoder(d, (32,))
    hashing = MultivariateBernoulli(enc, 6)
    params = hashing.init(jax.random.PRNGKey(0))

    ref = Indexer(hashing, params, corpus, engine="xla")
    r_top, r_cand = ref.query(queries, k=k, hash_times=4, probe_mode="flip")
    idx = Indexer(hashing, params, corpus, engine="windowed")
    w_top, w_cand = idx.query(queries, k=k, hash_times=4, probe_mode="flip")
    np.testing.assert_array_equal(w_cand, r_cand)
    assert (r_top == w_top).mean() > 0.98


def test_indexer_engine_switch_rebuilds_layout():
    """Switching windowed<->other engines must invalidate the cached
    serving layout: the windowed engine reads a DENSE (align=8) layout,
    the grouped engine a block-aligned one.  Before the engine setter,
    the switch either raised mid-serve or silently served windowed on a
    block-aligned layout."""
    rng = np.random.default_rng(23)
    n, d, nq, k = 600, 16, 24, 5
    corpus = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    queries = jnp.asarray(rng.normal(size=(nq, d)).astype(np.float32))
    enc = MLPEncoder(d, (32,))
    hashing = MultivariateBernoulli(enc, 6)
    params = hashing.init(jax.random.PRNGKey(0))

    idx = Indexer(hashing, params, corpus, engine="grouped")
    f_top, f_cand = idx.query(queries, k=k, hash_times=4, probe_mode="flip")
    assert idx._layout.align == idx._layout.br

    idx.engine = "windowed"  # must drop the block-aligned layout
    w_top, w_cand = idx.query(queries, k=k, hash_times=4, probe_mode="flip")
    assert idx._layout.align == 8
    np.testing.assert_array_equal(w_cand, f_cand)
    assert (f_top == w_top).mean() > 0.98

    idx.engine = "grouped"  # dense layout would raise mid-serve
    g_top, g_cand = idx.query(queries, k=k, hash_times=4, probe_mode="flip")
    assert idx._layout.align == idx._layout.br
    np.testing.assert_array_equal(g_cand, f_cand)
    assert (f_top == g_top).mean() > 0.98

    with pytest.raises(ValueError, match="unknown engine"):
        idx.engine = "nope"


def test_indexer_knob_mutation_rebuilds_layout():
    """Mutating serving_dtype / probe_budget / block_rows post-init
    must rebuild the serving layout on the next access — the layout
    property compares a knob signature instead of relying on callers
    poking the private ``_layout`` (round-3 review finding)."""
    rng = np.random.default_rng(29)
    n, d, nq, k = 600, 16, 24, 5
    corpus = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    queries = jnp.asarray(rng.normal(size=(nq, d)).astype(np.float32))
    enc = MLPEncoder(d, (32,))
    hashing = MultivariateBernoulli(enc, 6)
    params = hashing.init(jax.random.PRNGKey(0))

    idx = Indexer(hashing, params, corpus, engine="grouped")
    idx.query(queries, k=k, hash_times=4, probe_mode="flip")
    lay0 = idx._layout
    assert lay0.data.dtype == jnp.float32

    idx.serving_dtype = jnp.bfloat16
    idx.query(queries, k=k, hash_times=4, probe_mode="flip")
    assert idx._layout is not lay0
    assert idx._layout.data.dtype == jnp.bfloat16

    old_cap = idx._layout.cap
    idx.probe_budget = max(1, idx.probe_budget // 2)
    idx.query(queries, k=k, hash_times=4, probe_mode="flip")
    assert idx._layout.cap <= old_cap

    # unchanged knobs must NOT rebuild (the cache still caches)
    lay1 = idx._layout
    idx.query(queries, k=k, hash_times=4, probe_mode="flip")
    assert idx._layout is lay1


def test_indexer_save_load_roundtrip(tmp_path):
    """Index persistence: load() must skip the corpus re-hash, restore
    every serving knob, answer identically — and refuse a different
    corpus (serving-restart safety)."""
    rng = np.random.default_rng(31)
    n, d, nq, k = 500, 16, 20, 5
    corpus = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    queries = jnp.asarray(rng.normal(size=(nq, d)).astype(np.float32))
    enc = MLPEncoder(d, (32,))
    hashing = MultivariateBernoulli(enc, 6)
    params = hashing.init(jax.random.PRNGKey(0))

    idx = Indexer(hashing, params, corpus, engine="grouped",
                  serving_dtype=jnp.bfloat16, probe_budget=64)
    top, cand = idx.query(queries, k=k, hash_times=4, probe_mode="flip")
    path = str(tmp_path / "index.npz")
    idx.save(path)

    idx2 = Indexer.load(path, hashing, params, corpus)
    assert idx2.engine == "grouped"
    assert idx2.probe_budget == 64
    assert jnp.dtype(idx2.serving_dtype) == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(idx2.table.row_ids), np.asarray(idx.table.row_ids))
    top2, cand2 = idx2.query(queries, k=k, hash_times=4, probe_mode="flip")
    np.testing.assert_array_equal(top, top2)
    np.testing.assert_array_equal(cand, cand2)

    other = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    with pytest.raises(ValueError, match="different corpus"):
        Indexer.load(path, hashing, params, other)
    with pytest.raises(ValueError, match="corpus"):
        Indexer.load(path, hashing, params, corpus[: n - 1])
    # appended rows change the shape -> rejected
    appended = jnp.concatenate([corpus, corpus[:3]])
    with pytest.raises(ValueError, match="corpus"):
        Indexer.load(path, hashing, params, appended)
    # SAME-shape tail edit: only the head+tail+strided fingerprint
    # catches this (a head-only digest served wrong ids here, r3 weak #4)
    tail_edited = np.asarray(corpus).copy()
    tail_edited[-1, 0] += 1.0
    with pytest.raises(ValueError, match="different corpus"):
        Indexer.load(path, hashing, params, jnp.asarray(tail_edited))
    # same-shape middle edit on a strided-sample row
    mid_edited = np.asarray(corpus).copy()
    mid_edited[n // 2, 0] += 1.0
    with pytest.raises(ValueError, match="different corpus"):
        Indexer.load(path, hashing, params, jnp.asarray(mid_edited))


@pytest.mark.parametrize("engine", ["xla", "grouped", "windowed"])
def test_int8_layout_matches_f32_engine(engine):
    """int8 serving layouts (cosine): same engine on the same table at
    int8 storage must rank ~identically to f32 (quantisation moves only
    near-ties) and return DEQUANTISED scores in exact-dot units."""
    rng = np.random.default_rng(11)
    n, d, nq, k = 800, 32, 24, 5
    # clustered unit-sphere corpus: the realistic (hardest) case
    centers = rng.normal(size=(16, d)).astype(np.float32)
    pts = centers[rng.integers(0, 16, n + nq)] + 0.3 * rng.normal(
        size=(n + nq, d)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    corpus = jnp.asarray(pts[:n])
    queries = jnp.asarray(pts[n:])
    hashing = MultivariateBernoulli(MLPEncoder(d, (32,)), 5)
    params = hashing.init(jax.random.PRNGKey(0))

    key = jax.random.PRNGKey(1)
    idx32 = Indexer(hashing, params, corpus, engine=engine)
    top32, cand32 = idx32.query(queries, k=k, hash_times=4,
                                probe_mode="flip", key=key)
    idx8 = Indexer(hashing, params, corpus, engine=engine,
                   serving_dtype=jnp.int8)
    assert idx8.layout.scale is not None
    top8, cand8 = idx8.query(queries, k=k, hash_times=4,
                             probe_mode="flip", key=key)
    np.testing.assert_array_equal(np.asarray(cand8), np.asarray(cand32))
    a32, a8 = np.asarray(top32), np.asarray(top8)
    agree = np.mean([
        len(set(a32[i]) & set(a8[i])) / k for i in range(nq)
    ])
    assert agree >= 0.9, f"int8 vs f32 top-{k} agreement {agree:.3f}"

    # dequantised scores: the engine's top-1 score must match the exact
    # dot of the id it returned, within the quantisation error bound
    # (d * scale/2 per dot, loose); the xla engine ignores the layout,
    # so its case checks the grouped scorer on the cap-aligned layout
    serve = (serving_query_windowed if engine == "windowed"
             else serving_query_grouped)
    pids, pvalid = hashing.hash(params, queries, n_probes=4, key=key,
                                probe_mode="flip")
    ids, scores, _ = serve(idx8.layout, queries, pids, pvalid,
                           idx8.table.counts, k=k)
    ids, scores = np.asarray(ids), np.asarray(scores)
    qn = pts[n:]
    # per-row scales (the default): bound with the largest row's scale
    bound = d * float(np.max(idx8.layout.scale)) / 2 + 1e-4
    for i in range(nq):
        if ids[i, 0] < 0:
            continue
        exact = float(qn[i] @ pts[ids[i, 0]])
        assert abs(scores[i, 0] - exact) <= bound


@pytest.mark.parametrize("scale_mode", ["global", "per_row"])
@pytest.mark.parametrize("engine", ["xla", "grouped", "windowed"])
def test_int8_euclidean_matches_f32_engine(engine, scale_mode):
    """int8 layouts serve EUCLIDEAN too — a global scale folds into the
    query side, per-row scales apply to the block scores before the
    ``-||c||^2`` bias, and both modes return ids that agree with the
    f32 engine on clustered data."""
    rng = np.random.default_rng(12)
    n, nq, d, k = 4096, 64, 24, 8
    centers = rng.normal(size=(16, d)).astype(np.float32)
    pts = centers[rng.integers(0, 16, n + nq)] + 0.3 * rng.normal(
        size=(n + nq, d)).astype(np.float32)
    corpus = jnp.asarray(pts[:n])
    queries = jnp.asarray(pts[n:])
    hashing = MultivariateBernoulli(MLPEncoder(d, (32,)), 5)
    params = hashing.init(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)

    idx32 = Indexer(hashing, params, corpus, metric="euclidean",
                    engine=engine)
    top32, cand32 = idx32.query(queries, k=k, hash_times=4,
                                probe_mode="flip", key=key)
    idx8 = Indexer(hashing, params, corpus, metric="euclidean",
                   engine=engine, serving_dtype=jnp.int8,
                   int8_scale=scale_mode)
    lay = idx8.layout
    assert lay.scale is not None
    assert lay.scale.ndim == (1 if scale_mode == "per_row" else 0)
    assert lay.norms is not None  # euclidean bias present alongside
    top8, cand8 = idx8.query(queries, k=k, hash_times=4,
                             probe_mode="flip", key=key)
    np.testing.assert_array_equal(np.asarray(cand8), np.asarray(cand32))
    a32, a8 = np.asarray(top32), np.asarray(top8)
    agree = np.mean([
        len(set(a32[i]) & set(a8[i])) / k for i in range(nq)
    ])
    assert agree >= 0.85, f"int8 euclid top-{k} agreement {agree:.3f}"
    # rank-1 sanity: the int8 winner's true distance is within the
    # quantisation bound of the f32 winner's
    d32 = np.linalg.norm(pts[n:] - pts[a32[:, 0]], axis=1)
    d8 = np.linalg.norm(pts[n:] - pts[a8[:, 0]], axis=1)
    assert np.all(d8 <= d32 + 0.15)


def test_int8_per_row_beats_global_on_skewed_norms():
    """The point of per-row scales: rows much shorter than the longest
    row lose most of their int8 resolution under one global scale.
    Build a euclidean corpus with a few huge-norm rows and check the
    per-row layout quantises small rows ~losslessly where global
    visibly distorts them."""
    from nlsh_jax.ops.pallas.query_kernel import serving_layout
    from nlsh_jax.index.bucket_table import build_bucket_table
    from nlsh_jax.index.indexer import hash_corpus

    rng = np.random.default_rng(5)
    n, d = 512, 16
    base = rng.normal(size=(n, d)).astype(np.float32)
    base[:8] *= 100.0  # outlier rows dominate the global max
    corpus = jnp.asarray(base)
    hashing = MultivariateBernoulli(MLPEncoder(d, (16,)), 4)
    params = hashing.init(jax.random.PRNGKey(0))
    table = build_bucket_table(hash_corpus(hashing, params, corpus),
                               hashing.n_buckets)

    def dequant_err(mode):
        lay = serving_layout(table, corpus, metric="euclidean",
                             dtype=jnp.int8, scale_mode=mode)
        scale = np.asarray(lay.scale)
        data = np.asarray(lay.data).astype(np.float32)
        deq = data * (scale if np.ndim(scale) == 0 else scale[:, None])
        rm = np.asarray(lay.row_map)
        valid = rm >= 0
        err = np.abs(deq[valid][:, :d] - base[rm[valid]])
        # error on the NON-outlier rows only
        small = np.linalg.norm(base[rm[valid]], axis=1) < 50
        return float(err[small].max())

    e_global = dequant_err("global")
    e_row = dequant_err("per_row")
    assert e_row < e_global / 10, (e_row, e_global)


def test_indexer_load_stale_fingerprint_format(tmp_path):
    """An artifact saved under the round-3 head-only digest scheme must
    fail with a 'rebuild' message, not the misleading 'different
    corpus' (its digest can NEVER match the current scheme, even for
    the correct corpus)."""
    rng = np.random.default_rng(33)
    corpus = jnp.asarray(rng.normal(size=(200, 8)).astype(np.float32))
    hashing = MultivariateBernoulli(MLPEncoder(8, (16,)), 4)
    params = hashing.init(jax.random.PRNGKey(0))
    idx = Indexer(hashing, params, corpus)
    path = str(tmp_path / "index.npz")
    idx.save(path)
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = [str(v) for v in arrays["meta"]]
    # simulate a round-3 archive: 9 fields, digest last, bare-hex
    meta = meta[:9]
    meta[8] = "0123456789abcdef"  # a bare-hex (pre-v2) digest
    arrays["meta"] = np.array(meta)
    np.savez_compressed(path, **arrays)
    with pytest.raises(ValueError, match="older corpus-fingerprint"):
        Indexer.load(path, hashing, params, corpus)


@pytest.mark.parametrize("engine", ["xla", "grouped"])
def test_indexer_incremental_add_compact(engine):
    """add(): fresh rows answer immediately (exact over the buffer,
    recall 1.0 on them by construction) and n_candidates grows by the
    buffer size; compact() folds them into the table and the merged
    answers survive."""
    rng = np.random.default_rng(37)
    n, d, nq, k = 400, 16, 16, 5
    corpus = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    enc = MLPEncoder(d, (32,))
    hashing = MultivariateBernoulli(enc, 6)
    params = hashing.init(jax.random.PRNGKey(0))

    idx = Indexer(hashing, params, corpus, engine=engine)
    fresh = jnp.asarray(rng.normal(size=(8, d)).astype(np.float32))
    # query AT the fresh rows: after add() each must be its own top-1
    queries = fresh[:nq] if nq <= 8 else fresh
    queries = fresh

    base_top, base_cand = idx.query(queries, k=k, hash_times=4,
                                    probe_mode="flip")
    idx.add(fresh)
    assert idx.n_fresh == 8
    top, cand = idx.query(queries, k=k, hash_times=4, probe_mode="flip")
    np.testing.assert_array_equal(cand, np.asarray(base_cand) + 8)
    np.testing.assert_array_equal(top[:, 0], n + np.arange(8))

    idx.compact()
    assert idx.n_fresh == 0 and idx.corpus.shape[0] == n + 8
    top2, _ = idx.query(queries, k=k, hash_times=4, probe_mode="flip")
    # self-retrieval survives compaction (now served from the table)
    np.testing.assert_array_equal(top2[:, 0], n + np.arange(8))


@pytest.mark.parametrize("engine", ["xla", "grouped"])
def test_indexer_remove_and_compact(engine):
    """remove(): tombstoned rows vanish from answers immediately (exact
    over-fetch + on-device filter) and stay gone after compact();
    surviving ranking matches an indexer built without them."""
    rng = np.random.default_rng(41)
    n, d, k = 400, 16, 5
    corpus = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    enc = MLPEncoder(d, (32,))
    hashing = MultivariateBernoulli(enc, 6)
    params = hashing.init(jax.random.PRNGKey(0))

    idx = Indexer(hashing, params, corpus, engine=engine)
    # query AT corpus rows so each row is its own exact top-1
    queries = corpus[:12]
    top0, _ = idx.query(queries, k=k, hash_times=4, probe_mode="flip")
    victims = np.asarray(top0[:, 0])[:6]  # delete 6 queried rows' top-1

    idx.remove(victims)
    assert idx.n_deleted == len(set(victims.tolist()))
    top1, _ = idx.query(queries, k=k, hash_times=4, probe_mode="flip")
    assert not np.isin(np.asarray(top1), victims).any()

    idx.compact()
    assert idx.n_deleted == 0
    top2, _ = idx.query(queries, k=k, hash_times=4, probe_mode="flip")
    assert not np.isin(np.asarray(top2), victims).any()
    # post-compact answers match the pre-compact filtered answers
    agree = (np.asarray(top1) == np.asarray(top2)).mean()
    assert agree > 0.9

    with pytest.raises(ValueError, match="out of range"):
        idx.remove([n + 100])


def test_grouped_engine_rejects_dense_layout():
    rng = np.random.default_rng(12)
    n, d, nb = 300, 16, 8
    corpus = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    bucket_ids = jnp.asarray(rng.integers(0, nb, n).astype(np.int32))
    table = build_bucket_table(bucket_ids, nb)
    layout = serving_layout(table, corpus, metric="cosine", align=8)
    queries = jnp.asarray(rng.normal(size=(4, d)).astype(np.float32))
    pid = jnp.zeros((4, 2), jnp.int32)
    pv = jnp.ones((4, 2), bool)
    with pytest.raises(ValueError, match="windowed"):
        serving_query_grouped(layout, queries, pid, pv, table.counts, k=3)
