"""Tests of bench.py's keyed, self-verifying disk caches: a benchmark
number must never be produced from stale ground truth or stale params,
and must not be spent recomputing what is deterministic in SEED.

Runs the real cache helpers on tiny monkeypatched workload constants —
CPU-safe; the heavy bench main() itself needs a GPU.
"""

import numpy as np
import pytest

import bench


@pytest.fixture()
def tiny_bench(monkeypatch, tmp_path):
    monkeypatch.setattr(bench, "CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(bench, "N_CORPUS", 256)
    monkeypatch.setattr(bench, "DIM", 8)
    monkeypatch.setattr(bench, "N_QUERIES", 16)
    monkeypatch.setattr(bench, "K", 5)
    monkeypatch.setattr(bench, "TRAIN_SUBSET", 64)
    monkeypatch.setattr(bench, "TRAIN_STEPS", 3)
    monkeypatch.setattr(
        bench, "TRAIN_CFG",
        dict(bench.TRAIN_CFG, hidden=(16,), batch_size=16, positive_k=4),
    )
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(256, 8)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = corpus[:16]
    return corpus, queries


def test_gt_cache_roundtrip_and_meta_guard(tiny_bench, tmp_path):
    corpus, queries = tiny_bench
    sub_idx = np.arange(64)

    gt1, knn1, gt_s, knn_s = bench._load_or_compute_gt(corpus, queries,
                                                       sub_idx)
    assert gt_s > 0 and gt1.shape == (16, 5) and knn1.shape[0] == 64
    # self-queries: nearest neighbour of corpus[i] is i itself
    np.testing.assert_array_equal(gt1[:, 0], np.arange(16))

    gt2, knn2, gt_s2, _ = bench._load_or_compute_gt(corpus, queries, sub_idx)
    assert gt_s2 == 0.0  # served from disk
    np.testing.assert_array_equal(gt1, gt2)
    np.testing.assert_array_equal(knn1, knn2)

    # a workload-constant change must invalidate the old file even if
    # the key collided (meta stored in the npz and verified on load)
    path = tmp_path / f"gt_{bench._workload_key()}.npz"
    z = dict(np.load(path))
    z["meta"] = z["meta"] + 1
    np.savez(path, **z)
    _, _, gt_s3, _ = bench._load_or_compute_gt(corpus, queries, sub_idx)
    assert gt_s3 > 0  # recomputed, not served stale


def test_train_key_tracks_config(monkeypatch):
    k1 = bench._train_key()
    monkeypatch.setattr(bench, "TRAIN_CFG",
                        dict(bench.TRAIN_CFG, margin=0.123))
    k2 = bench._train_key()
    assert k1 != k2
    monkeypatch.setattr(bench, "TRAIN_STEPS", bench.TRAIN_STEPS + 1)
    assert bench._train_key() not in (k1, k2)


def test_params_cache_roundtrip(tiny_bench):
    import jax

    from nlsh_jax.models import get_encoder, get_hashing
    from nlsh_jax.ops.knn import self_knn

    corpus, queries = tiny_bench
    import jax.numpy as jnp
    sub = corpus[:64]
    sub_knn = np.asarray(self_knn(jnp.asarray(sub), k=8, metric="cosine"))
    data = bench._BenchData(sub, queries, np.zeros((16, 5), np.int32),
                            sub_knn, "cosine")
    enc = get_encoder("siren", bench.DIM, list(bench.TRAIN_CFG["hidden"]))
    hashing = get_hashing("MultivariateBernoulli", enc, 4)

    p1, t1 = bench._load_or_train_params(hashing, data)
    assert t1 > 0
    p2, t2 = bench._load_or_train_params(hashing, data)
    assert t2 == 0.0  # served from disk
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_configs_param_cache_meta_guard(tmp_path, monkeypatch):
    """benchmarks/configs.py _train: a cache hit requires the sidecar
    meta (every hyper-parameter + data fingerprint) to match — a tuned
    lr with unchanged param shapes must retrain, not silently serve the
    stale fit (round-3 review finding)."""
    import jax
    import jax.numpy as jnp

    from benchmarks.configs import _train
    from nlsh_jax.models import get_encoder, get_hashing
    from nlsh_jax.ops.knn import self_knn

    monkeypatch.setenv("NLSH_BENCH_CACHE_DIR", str(tmp_path))
    rng = np.random.default_rng(1)
    sub = rng.normal(size=(64, 8)).astype(np.float32)
    sub /= np.linalg.norm(sub, axis=1, keepdims=True)
    sub_knn = np.asarray(self_knn(jnp.asarray(sub), k=8, metric="cosine"))
    data = bench._BenchData(sub, sub[:8], np.zeros((8, 5), np.int32),
                            sub_knn, "cosine")

    def hashing():
        return get_hashing("MultivariateBernoulli",
                           get_encoder("mlp", 8, [16]), 4)

    s1, t1 = _train(hashing(), data, steps=2, batch_size=16,
                    cache_tag="testcfg")
    assert t1 > 0
    s2, t2 = _train(hashing(), data, steps=2, batch_size=16,
                    cache_tag="testcfg")
    assert t2 == 0.0  # hit
    for a, b in zip(jax.tree.leaves(s1.params), jax.tree.leaves(s2.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # same tag/steps/batch (same filename) but different lr: must MISS
    _, t3 = _train(hashing(), data, steps=2, batch_size=16, lr=5e-4,
                   cache_tag="testcfg")
    assert t3 > 0
    # and different data (same shapes): must MISS too
    data2 = bench._BenchData(sub[::-1].copy(), sub[:8],
                             np.zeros((8, 5), np.int32), sub_knn, "cosine")
    _, t4 = _train(hashing(), data2, steps=2, batch_size=16,
                   cache_tag="testcfg")
    assert t4 > 0


def test_id_agreement():
    a = np.array([[1, 2, 3], [4, 5, -1]])
    assert bench._id_agreement(a, a) == 1.0
    b = np.array([[1, 2, 9], [4, 5, -1]])
    # row 0: 2/3 overlap; row 1: padded to 2 valid ids, full overlap
    assert bench._id_agreement(a, b) == pytest.approx((2 / 3 + 1) / 2)
