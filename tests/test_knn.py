"""Tests for the tiled brute-force kNN (the GT precompute replacement)."""

import jax.numpy as jnp
import numpy as np

from nlsh_jax.ops.knn import knn, self_knn


def _np_knn(queries, corpus, k, metric):
    if metric == "cosine":
        qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
        cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
        d = 1.0 - qn @ cn.T
    else:
        d = ((queries[:, None, :] - corpus[None, :, :]) ** 2).sum(-1)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def test_knn_cosine_matches_numpy():
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(300, 8)).astype(np.float32)
    queries = rng.normal(size=(37, 8)).astype(np.float32)
    _, ids = knn(
        jnp.asarray(queries), jnp.asarray(corpus), k=5,
        metric="cosine", query_tile=16, corpus_chunk=64,
    )
    np.testing.assert_array_equal(np.asarray(ids), _np_knn(queries, corpus, 5, "cosine"))


def test_knn_euclidean_matches_numpy():
    rng = np.random.default_rng(1)
    corpus = rng.normal(size=(200, 12)).astype(np.float32)
    queries = rng.normal(size=(10, 12)).astype(np.float32)
    _, ids = knn(
        jnp.asarray(queries), jnp.asarray(corpus), k=7,
        metric="sq_euclidean", query_tile=8, corpus_chunk=50,
    )
    np.testing.assert_array_equal(
        np.asarray(ids), _np_knn(queries, corpus, 7, "euclidean")
    )


def test_self_knn_excludes_self():
    """Encodes the intent of the reference's stale tests/test_precompute.py
    (set-equality of 2-NN) with explicit self-exclusion."""
    vectors = np.array(
        [
            [1.2, 2, 3],
            [3, 2, 1],
            [1, 2, 4],
            [6, 4, 2.5],
            [2, 4, 6],
        ],
        dtype=np.float32,
    )
    nbr = np.asarray(self_knn(jnp.asarray(vectors), k=2, metric="cosine",
                              query_tile=2, corpus_chunk=2))
    got = [set(r) for r in nbr.tolist()]
    assert got == [{4, 2}, {3, 0}, {0, 4}, {1, 0}, {0, 2}]
    for i, row in enumerate(nbr):
        assert i not in row


def test_knn_distances_sorted_ascending():
    rng = np.random.default_rng(2)
    corpus = rng.normal(size=(128, 4)).astype(np.float32)
    queries = rng.normal(size=(5, 4)).astype(np.float32)
    d, _ = knn(jnp.asarray(queries), jnp.asarray(corpus), k=10, metric="cosine",
               query_tile=4, corpus_chunk=32)
    d = np.asarray(d)
    assert (np.diff(d, axis=1) >= -1e-6).all()
