"""Native HNSW baseline (nlsh_jax/native/hnsw.cpp) — the in-repo
backend for the reference's hnswlib yardstick (reference
``nlsh/trainers/hnsw.py:28-63``; hnswlib itself is not installable in
this image).  Tests run on CPU and validate the graph search against
numpy brute force."""

import numpy as np
import pytest

from nlsh_jax import native


pytestmark = pytest.mark.skipif(
    native._get_lib() is None, reason="no C++ toolchain"
)


def _clustered(rng, n, d, n_clusters=64):
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    pts = centers[rng.integers(0, n_clusters, n)] + 0.3 * rng.normal(
        size=(n, d)
    ).astype(np.float32)
    return pts.astype(np.float32)


def test_hnsw_recall_cosine():
    rng = np.random.default_rng(0)
    n, d, nq, k = 5000, 24, 200, 10
    corpus = _clustered(rng, n, d)
    queries = _clustered(rng, nq, d)
    cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    gt = np.argsort(-qn @ cn.T, axis=1)[:, :k]

    idx = native.NativeHNSW(space="cosine", dim=d)
    idx.init_index(max_elements=n, M=10, ef_construction=200)
    idx.add_items(corpus)
    idx.set_ef(100)
    ids, dists, counts = idx.knn_query(queries, k=k)

    recall = np.mean([len(set(gt[i]) & set(ids[i])) / k for i in range(nq)])
    assert recall > 0.9
    assert (counts > 0).all()
    # scores are cosine distance of the returned ids, ascending
    for i in range(5):
        got = 1.0 - qn[i] @ cn[ids[i]].T
        np.testing.assert_allclose(np.sort(dists[i]), dists[i], atol=1e-6)
        np.testing.assert_allclose(got, dists[i], atol=1e-5)


def test_hnsw_exact_at_full_ef_l2():
    """ef >= n degenerates to exhaustive layer-0 search of the
    connected graph: top-1 must be the true nearest neighbour."""
    rng = np.random.default_rng(1)
    n, d, nq = 300, 16, 100
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(nq, d)).astype(np.float32)
    gt = np.argmin(
        ((queries[:, None, :] - corpus[None]) ** 2).sum(-1), axis=1
    )
    idx = native.NativeHNSW(space="l2", dim=d)
    idx.init_index(max_elements=n, M=8, ef_construction=300)
    idx.add_items(corpus)
    idx.set_ef(n)
    ids, _, _ = idx.knn_query(queries, k=1)
    assert (ids[:, 0] == gt).mean() == 1.0


def test_hnsw_label_mapping_and_batches():
    """Shuffled external labels (the trainer inserts in shuffled
    batches, reference hnsw.py:42-48) map back through knn_query."""
    rng = np.random.default_rng(2)
    n, d = 1000, 8
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.permutation(n).astype(np.int64)
    idx = native.NativeHNSW(space="l2", dim=d)
    idx.init_index(max_elements=n, M=8, ef_construction=100)
    for s in range(0, n, 256):
        idx.add_items(corpus[s:s + 256], labels[s:s + 256])
    assert idx.get_current_count() == n
    idx.set_ef(64)
    # self-query: every corpus row must retrieve its own label first
    ids, dists, _ = idx.knn_query(corpus[:100], k=1)
    assert (ids[:, 0] == labels[:100]).all()
    assert (dists[:, 0] < 1e-5).all()
    with pytest.raises(RuntimeError):
        idx.add_items(corpus[:1])  # max_elements exceeded


def test_hnsw_trainer_uses_native_backend():
    """HNSWBaseline falls back to the in-repo backend and logs the
    reference's metric channels (hnsw.py:50-63)."""
    try:
        import hnswlib  # noqa: F401

        pytest.skip("hnswlib installed: trainer prefers it by design")
    except ImportError:
        pass
    from nlsh_jax.data import SyntheticDataset
    from nlsh_jax.train.hnsw import HNSWBaseline
    from nlsh_jax.utils.loggers import JSONLLogger

    data = SyntheticDataset(
        n_train=2000, n_test=100, dim=16, metric="cosine", seed=3
    ).load()
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        logger = JSONLLogger(f"{td}/hnsw.jsonl", run_name="hnsw-test")
        t = HNSWBaseline(data, logger, max_connections=10,
                         ef_construction=100, ef=50)
        assert t.backend == "native"
        recall = t.fit(K=10)
    assert recall > 0.8


def test_hnsw_wrapper_guards():
    """Misuse raises instead of corrupting native state (code-review
    round 3): pre-init query, dim mismatch, label-count mismatch, and
    re-init_index resetting the label mapping."""
    rng = np.random.default_rng(4)
    corpus = rng.normal(size=(50, 8)).astype(np.float32)
    idx = native.NativeHNSW(space="l2", dim=8)
    with pytest.raises(RuntimeError):
        idx.knn_query(corpus[:1])
    idx.init_index(max_elements=50, M=4, ef_construction=32)
    with pytest.raises(ValueError):
        idx.add_items(corpus[:, :4])  # wrong dim
    with pytest.raises(ValueError):
        idx.add_items(corpus[:5], labels=np.arange(3))  # wrong count
    idx.add_items(corpus, labels=np.arange(100, 150))
    ids, _, _ = idx.knn_query(corpus[:3], k=1)
    assert (ids[:, 0] == np.arange(100, 103)).all()
    # re-init drops the old graph and mapping entirely
    idx.init_index(max_elements=50, M=4, ef_construction=32)
    assert idx.get_current_count() == 0
    idx.add_items(corpus[:10], labels=np.arange(200, 210))
    ids, _, _ = idx.knn_query(corpus[:3], k=1)
    assert (ids[:, 0] == np.arange(200, 203)).all()
    with pytest.raises(ValueError):
        idx.knn_query(corpus[:2, :5])  # wrong query dim
