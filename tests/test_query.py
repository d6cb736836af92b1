"""End-to-end index query tests vs a numpy reimplementation of the
reference dict-walk (``nlsh/indexer.py:56-96``)."""

import jax
import jax.numpy as jnp
import numpy as np

from nlsh_jax.index.bucket_table import build_bucket_table
from nlsh_jax.index.query import query_bucket_table
from nlsh_jax.index.indexer import Indexer
from nlsh_jax.models.encoders import MLPEncoder
from nlsh_jax.models.hashings import MultivariateBernoulli


def _np_reference_query(bucket_ids, corpus, queries, probe_sets, k, metric):
    """Reference semantics: union of probed buckets' rows, exact rerank,
    top-k ascending; -1 padding for missing results."""
    index2row = {}
    for row, b in enumerate(bucket_ids):
        index2row.setdefault(int(b), []).append(row)

    def dist(q, x):
        if metric == "cosine":
            qn = q / np.linalg.norm(q)
            xn = x / np.linalg.norm(x, axis=1, keepdims=True)
            return 1.0 - xn @ qn
        return ((x - q) ** 2).sum(-1)

    all_top, all_ncand = [], []
    for qi, probes in enumerate(probe_sets):
        rows = []
        for b in sorted(probes):
            rows.extend(index2row.get(b, []))
        all_ncand.append(len(rows))
        if rows:
            d = dist(queries[qi], corpus[np.asarray(rows)])
            order = np.argsort(d, kind="stable")[:k]
            top = [rows[i] for i in order]
        else:
            top = []
        top = top + [-1] * (k - len(top))
        all_top.append(top)
    return np.asarray(all_top), np.asarray(all_ncand)


def test_query_matches_reference_dict_walk():
    rng = np.random.default_rng(0)
    n, d, n_buckets, nq, n_probes, k = 200, 8, 16, 23, 4, 5
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(nq, d)).astype(np.float32)
    bucket_ids = rng.integers(0, n_buckets, size=n).astype(np.int32)
    probe_raw = rng.integers(0, n_buckets, size=(nq, n_probes)).astype(np.int32)

    # dedupe the probes the framework way
    probe_sorted = np.sort(probe_raw, axis=1)
    probe_valid = np.concatenate(
        [np.ones((nq, 1), bool), probe_sorted[:, 1:] != probe_sorted[:, :-1]], axis=1
    )

    table = build_bucket_table(jnp.asarray(bucket_ids), n_buckets=n_buckets)
    got_top, got_dists, got_ncand = query_bucket_table(
        table,
        jnp.asarray(corpus),
        jnp.asarray(queries),
        jnp.asarray(probe_sorted),
        jnp.asarray(probe_valid),
        k=k,
        probe_budget=int(table.max_count()),
        metric="cosine",
        query_chunk=8,
    )
    probe_sets = [set(r.tolist()) for r in probe_raw]
    exp_top, exp_ncand = _np_reference_query(
        bucket_ids, corpus, queries, probe_sets, k, "cosine"
    )
    np.testing.assert_array_equal(np.asarray(got_ncand), exp_ncand)
    # distances can tie; compare distance-equivalence instead of raw ids
    got_top = np.asarray(got_top)
    for i in range(nq):
        assert set(got_top[i].tolist()) == set(exp_top[i].tolist())


def test_query_budget_truncation_counts_full_occupancy():
    """query_size must report full bucket occupancy even when
    probe_budget truncates the reranked candidate set."""
    corpus = np.eye(4, dtype=np.float32)
    bucket_ids = jnp.array([0, 0, 0, 0], dtype=jnp.int32)
    table = build_bucket_table(bucket_ids, n_buckets=2)
    probe_ids = jnp.array([[0]], dtype=jnp.int32)
    probe_valid = jnp.ones((1, 1), dtype=bool)
    top, _, ncand = query_bucket_table(
        table, jnp.asarray(corpus), jnp.asarray(corpus[:1]),
        probe_ids, probe_valid, k=2, probe_budget=2, metric="euclidean",
        query_chunk=8,
    )
    assert int(ncand[0]) == 4  # full occupancy
    top = np.asarray(top)[0]
    assert 0 in top.tolist()  # self row survives within budget


def test_indexer_end_to_end_smoke():
    rng = np.random.default_rng(1)
    corpus = rng.normal(size=(256, 16)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    enc = MLPEncoder(input_dim=16, hidden_dims=(32,))
    hashing = MultivariateBernoulli(enc, hash_size=4)
    params = hashing.init(jax.random.PRNGKey(0))

    idx = Indexer(hashing, params, jnp.asarray(corpus), metric="cosine")
    top, ncand = idx.query(jnp.asarray(corpus[:10]), k=3, hash_times=5,
                           key=jax.random.PRNGKey(1))
    assert top.shape == (10, 3)
    assert ncand.shape == (10,)
    assert (ncand >= 1).all()
    # the query vector is in the corpus: probing its own hard bucket must
    # return itself as nearest (distance 0)
    assert (top[:, 0] == np.arange(10)).all()


def test_hash_corpus_host_matches_device():
    """Chunked host hashing (the 10M no-device-corpus path) must produce
    the same codes as the jitted device path, including the ragged tail
    chunk."""
    import numpy as np

    from nlsh_jax.index.indexer import hash_corpus, hash_corpus_host
    from nlsh_jax.models.encoders import MLPEncoder
    from nlsh_jax.models.hashings import MultivariateBernoulli

    rng = np.random.default_rng(3)
    corpus = rng.normal(size=(1000, 12)).astype(np.float32)
    hashing = MultivariateBernoulli(MLPEncoder(12, (16,)), 5)
    params = hashing.init(jax.random.PRNGKey(0))
    dev = np.asarray(hash_corpus(hashing, params, jnp.asarray(corpus)))
    host = hash_corpus_host(hashing, params, corpus, chunk=256)
    np.testing.assert_array_equal(host, dev)
