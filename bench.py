#!/usr/bin/env python
"""Serving benchmark on one GPU: prints ONE JSON line.

Headline: query throughput (QPS) on a glove-100-angular-shaped workload
at the reference operating point (12-bit MultivariateBernoulli + SIREN
256,256 trunk, 16 flip probes, exact cosine rerank, k=10), with
recall@10 against exact ground truth and index build time alongside,
for every serving engine (``xla``, ``grouped``, ``windowed``) and
layout dtype (f32, bf16, per-row int8).

Dataset: synthetic clustered unit-sphere data with the exact glove-100
shape (1.18M corpus x 100 dims, 10k queries, cosine), generated from
SEED; ground truth from the exact brute-force search at matmul
precision ``highest``.  A short triplet fit on a corpus subset stands
in for the full training run.  Ground truth and the fitted params are
deterministic in SEED and cached on disk keyed by the workload
constants.

Every line names the device it ran on and the card's name and power
limit.  With no GPU, or on any failure, the script exits non-zero and
prints no result.  Times are host-clock wall times around work that
ends in ``block_until_ready``, after every shape has been warmed.

    python bench.py
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np

N_CORPUS = 1_183_514  # glove-100-angular training-set size
DIM = 100
N_QUERIES = 10_000
K = 10
HASH_SIZE = 12
HASH_TIMES = 16
TRAIN_SUBSET = 131_072
TRAIN_STEPS = 1000
SEED = 0
# trainer hyper-parameters (part of the params cache key)
TRAIN_CFG = dict(margin=0.5, positive_k=20, balance_lambda=1.5,
                 batch_size=2048, learning_rate=1e-3, encoder="siren",
                 hidden=(256, 256))

# timing: R serving batches fused into ONE dispatch per rep (layout
# engines), min over REPS reps
PIPELINE_DEPTH = int(os.environ.get("NLSH_BENCH_PIPELINE", 16))
REPS = int(os.environ.get("NLSH_BENCH_REPS", 10))

CACHE_DIR = os.environ.get(
    "NLSH_BENCH_CACHE_DIR",
    os.path.join(tempfile.gettempdir(), "nlsh_bench_cache"))
# small deterministic artifacts (the exact ground truth) also ship in
# the repo as a read-only cache
REPO_CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "benchmarks", "artifacts", "bench_cache")


def _workload_key() -> str:
    # v2: GT at matmul precision "highest" (exact f32 ranking; the v1
    # caches were single-pass-bf16-ranked at the top-k boundary)
    return (f"s{SEED}_n{N_CORPUS}_d{DIM}_q{N_QUERIES}_k{K}"
            f"_ts{TRAIN_SUBSET}_v2")


def _train_key() -> str:
    cfg = dict(TRAIN_CFG, hash_size=HASH_SIZE, hash_times=HASH_TIMES,
               steps=TRAIN_STEPS)
    blob = json.dumps(cfg, sort_keys=True).encode()
    return f"{_workload_key()}_{hashlib.sha1(blob).hexdigest()[:10]}"


class _BenchData:
    """Minimal Dataset-duck for the trainer: a corpus subset with
    self-kNN GT."""

    def __init__(self, training, testing, ground_truth, train_knn, metric):
        self.training = training
        self.testing = testing
        self.ground_truth = ground_truth
        self.training_self_knn = train_knn
        self.metric = metric
        self.prepared = True
        self.dim = training.shape[1]

    def load(self):
        return self


# ONE cluster model for corpus, GT queries and the fresh pipelined pool
# — any tweak here changes all three together (and bumps no cache key,
# so bump _workload_key's version suffix when touching these constants)
N_CLUSTERS = 4096
CLUSTER_NOISE = 0.35


def _cluster_points(centers, rng, n):
    """``n`` unit-sphere points from the bench cluster model, drawn from
    ``rng`` in the fixed order (assignments, then noise) every caller
    replays."""
    dim = centers.shape[1]
    assign = rng.integers(0, centers.shape[0], size=n)
    pts = centers[assign] + CLUSTER_NOISE * rng.normal(
        size=(n, dim)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    return pts


def glove100_workload(rng, n_corpus=N_CORPUS, n_queries=N_QUERIES, dim=DIM):
    """The bench workload: synthetic clustered unit-sphere data with the
    exact glove-100-angular shape (shared with benchmarks/frontier.py
    and benchmarks/train_full.py)."""
    centers = rng.normal(size=(N_CLUSTERS, dim)).astype(np.float32)
    pts = _cluster_points(centers, rng, n_corpus + n_queries)
    return pts[:n_corpus], pts[n_corpus:]


def glove100_fresh_pool(repeats, n_queries=N_QUERIES, dim=DIM, seed=SEED):
    """``(repeats, n_queries, dim)`` of FRESH queries from the same
    cluster model as :func:`glove100_workload` (identical centers —
    replayed from the same seed — new assignments and noise), so every
    pipelined repeat serves distinct queries with the workload's bucket
    distribution instead of re-probing one batch's working set."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(N_CLUSTERS, dim)).astype(np.float32)
    rng2 = np.random.default_rng(seed + 1_000_003)
    pts = _cluster_points(centers, rng2, repeats * n_queries)
    return pts.reshape(repeats, n_queries, dim)


# ---------------------------------------------------------------------------
# disk caches — every entry keyed by the workload constants and verified
# on load (a fixed path would silently serve stale GT when any constant
# changed)
# ---------------------------------------------------------------------------

def _load_or_compute_gt(corpus_np, queries_np, sub_idx):
    """(gt, sub_knn, gt_s, knn_s) with a keyed, self-verifying cache.

    ``sub_idx=None`` skips the training-subset self-kNN on a cache miss
    (returns ``sub_knn=None`` and writes no cache entry) — for callers
    that need only the query ground truth, e.g. ``train_full.py``'s
    full-corpus path, which mines neighbours over the whole corpus
    itself and would discard a ~minutes-long 131k self-kNN pass."""
    import jax
    import jax.numpy as jnp

    from nlsh_jax.ops.knn import knn, self_knn

    os.makedirs(CACHE_DIR, exist_ok=True)
    fname = f"gt_{_workload_key()}.npz"
    path = os.path.join(CACHE_DIR, fname)
    meta = np.array([SEED, N_CORPUS, DIM, N_QUERIES, K, TRAIN_SUBSET],
                    np.int64)
    for cand in (path, os.path.join(REPO_CACHE_DIR, fname)):
        if os.path.exists(cand):
            z = np.load(cand)
            if "meta" in z and np.array_equal(z["meta"], meta):
                return z["gt"], z["sub_knn"], 0.0, 0.0
    # (the round-2 legacy-cache migration is gone: v2 keys mean
    # "ranked at matmul precision highest", which the legacy bf16
    # cache is not — migrating it would silently defeat the version
    # bump, which is exactly what happened once)

    t0 = time.perf_counter()
    _, gt = knn(jnp.asarray(queries_np), jnp.asarray(corpus_np), k=K,
                metric="cosine", query_tile=1024, corpus_chunk=131_072)
    gt = np.asarray(jax.block_until_ready(gt))
    gt_s = time.perf_counter() - t0

    if sub_idx is None:
        return gt, None, gt_s, 0.0
    t0 = time.perf_counter()
    sub_knn = np.asarray(self_knn(jnp.asarray(corpus_np[sub_idx]), k=20,
                                  metric="cosine",
                                  query_tile=1024, corpus_chunk=131_072))
    knn_s = time.perf_counter() - t0
    np.savez(path, gt=gt, sub_knn=sub_knn, meta=meta)
    return gt, sub_knn, gt_s, knn_s

def _load_or_train_params(hashing, data):
    """(hashing params, train_s) — training is deterministic in SEED,
    so the fitted params are cached exactly like the ground truth."""
    import jax

    from nlsh_jax.utils.checkpoint import load_tree, save_tree

    os.makedirs(CACHE_DIR, exist_ok=True)
    path = os.path.join(CACHE_DIR, f"params_{_train_key()}.npz")
    like = hashing.init(jax.random.PRNGKey(0))
    if os.path.exists(path):
        return load_tree(path, like), 0.0

    from nlsh_jax.train import TripletTrainer

    trainer = TripletTrainer(
        hashing, data, CACHE_DIR, margin=TRAIN_CFG["margin"],
        positive_k=TRAIN_CFG["positive_k"],
        balance_lambda=TRAIN_CFG["balance_lambda"],
    )
    t0 = time.perf_counter()
    state = trainer.fit(K=K, batch_size=TRAIN_CFG["batch_size"],
                        learning_rate=TRAIN_CFG["learning_rate"],
                        epochs=100, test_every_updates=100_000,
                        max_steps=TRAIN_STEPS, hash_times=HASH_TIMES,
                        seed=SEED)
    train_s = time.perf_counter() - t0
    params = state.params["hashing"]
    save_tree(path, params)
    return params, train_s


# ---------------------------------------------------------------------------
# engine parity: a layout engine that disagrees with the XLA gather path
# fails the run
# ---------------------------------------------------------------------------

def _id_agreement(a_top: np.ndarray, b_top: np.ndarray) -> float:
    """Mean per-query top-k id set overlap."""
    return float(np.mean([
        len(set(ra[ra >= 0]) & set(rb[rb >= 0])) / max((ra >= 0).sum(), 1)
        for ra, rb in zip(a_top, b_top)
    ]))


LAYOUT_ENGINES = ("grouped", "windowed")


def _engine_parity(corpus_np, queries_np, hashing, params):
    """Run a ~65k-row slice through every engine for BOTH metrics.  Two
    checks per metric:

    * every layout engine >= 0.98 id agreement with the XLA path run
      under f32 matmul precision (a systematic layout/scorer corruption
      gives ~0 agreement; legitimate fp rank-boundary ties cost ~1%) —
      the reference-semantics anchor (``nlsh/indexer.py:56-96``);
    * the layout engines >= 0.999 agreement with EACH OTHER — they
      share the scorer but use independent layouts and preps.
    """
    import jax
    import jax.numpy as jnp

    from nlsh_jax.index import Indexer

    n_small, nq, k = 65_536, 512, K
    corpus = jnp.asarray(corpus_np[:n_small])
    queries = jnp.asarray(queries_np[:nq])
    qkey = jax.random.PRNGKey(SEED + 2)
    out, ok = {}, True
    for metric in ("cosine", "euclidean"):
        # ONE table per metric; engines are a serve-time switch
        idx = Indexer(hashing, params, corpus, metric=metric, engine="xla")
        with jax.default_matmul_precision("float32"):
            r_top, _ = idx.query(queries, k=k, hash_times=HASH_TIMES,
                                 key=qkey, probe_mode="flip")
        tops = {}
        for engine in LAYOUT_ENGINES:
            idx.engine = engine
            e_top, _ = idx.query(queries, k=k, hash_times=HASH_TIMES,
                                 key=qkey, probe_mode="flip")
            tops[engine] = np.asarray(e_top)
            agree = _id_agreement(np.asarray(r_top), tops[engine])
            out[f"{metric}:{engine}:xla"] = agree
            ok &= agree >= 0.98
        agree = _id_agreement(tops["grouped"], tops["windowed"])
        out[f"{metric}:grouped:windowed"] = agree
        ok &= agree >= 0.999
    return out, ok


def _timed(fn, reps: int) -> float:
    """Min wall time of ``fn()`` (which must end in device work) over
    ``reps`` runs, each waited for with ``block_until_ready``."""
    import jax

    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    import jax
    import jax.numpy as jnp

    from nlsh_jax.index import Indexer
    from nlsh_jax.index.indexer import _fused_serve, _fused_serve_batched
    from nlsh_jax.models import get_encoder, get_hashing
    from nlsh_jax.utils.device import card_info, require_gpu
    from nlsh_jax.utils.env import setup_compile_cache
    from nlsh_jax.utils.metrics import calculate_recall

    setup_compile_cache()
    device = require_gpu()
    card = card_info()
    print(f"device: {device} jax {jax.__version__}", file=sys.stderr)
    print(f"card: {card}", file=sys.stderr)
    t_start = time.perf_counter()
    rng = np.random.default_rng(SEED)

    corpus_np, queries_np = glove100_workload(rng)
    corpus = jnp.asarray(corpus_np)
    queries = jnp.asarray(queries_np)

    # -- exact ground truth (keyed disk cache) ---------------------------
    sub_idx = rng.choice(N_CORPUS, TRAIN_SUBSET, replace=False)
    gt, sub_knn, gt_s, knn_s = _load_or_compute_gt(
        corpus_np, queries_np, sub_idx
    )

    data = _BenchData(corpus_np[sub_idx], queries_np[:256], gt[:256],
                      sub_knn, "cosine")
    enc = get_encoder(TRAIN_CFG["encoder"], DIM, list(TRAIN_CFG["hidden"]))
    hashing = get_hashing("MultivariateBernoulli", enc, HASH_SIZE)
    params, train_s = _load_or_train_params(hashing, data)

    # -- index build on the FULL corpus: cold (with compiles), then warm
    t0 = time.perf_counter()
    indexer = Indexer(hashing, params, corpus, metric="cosine")
    jax.block_until_ready(indexer.table.row_ids)
    build_cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    indexer = Indexer(hashing, params, corpus, metric="cosine")
    jax.block_until_ready(indexer.table.row_ids)
    build_s = time.perf_counter() - t0
    max_bucket = indexer.probe_budget

    # serving operating point: cap = 1.2x the mean bucket, rounded up to
    # a power of two
    qkey = jax.random.PRNGKey(SEED + 1)
    mean_bucket = N_CORPUS / hashing.n_buckets
    cap = 1 << int(np.ceil(np.log2(1.2 * mean_bucket)))
    indexer.probe_budget = int(cap)
    # fresh-query pool for the pipelined timing: each of the R fused
    # repeats serves DISTINCT queries from the same cluster model
    qpool = jnp.asarray(glove100_fresh_pool(PIPELINE_DEPTH))
    counts = indexer.table.counts

    sweep = []
    for engine, sdtype in (("grouped", jnp.float32),
                           ("grouped", jnp.bfloat16),
                           ("grouped", jnp.int8),
                           ("windowed", jnp.float32),
                           ("xla", jnp.float32)):
        indexer.engine = engine
        indexer.serving_dtype = sdtype
        row = {"engine": engine, "dtype": jnp.dtype(sdtype).name,
               "cap": int(cap)}
        if engine == "xla":
            single = lambda: indexer.query_async(  # noqa: E731
                queries, k=K, hash_times=HASH_TIMES, key=qkey,
                probe_mode="flip")
        else:
            lay = indexer.layout
            single = lambda: _fused_serve(  # noqa: E731
                hashing, params, lay, counts, queries, qkey, k=K,
                hash_times=HASH_TIMES, probe_mode="flip", engine=engine)
            batched = lambda: _fused_serve_batched(  # noqa: E731
                hashing, params, lay, counts, qpool, qkey, k=K,
                hash_times=HASH_TIMES, probe_mode="flip", engine=engine,
                repeats=PIPELINE_DEPTH)
            jax.block_until_ready(batched())  # compile + warm
            row["qps"] = N_QUERIES * PIPELINE_DEPTH / _timed(batched, REPS)
        top, n_cand = indexer.fetch(single())  # compile + warm
        row["qps_unpipelined"] = N_QUERIES / _timed(single, REPS)
        row["recall"] = float(calculate_recall(gt, top, np.mean))
        row["query_size"] = float(np.mean(n_cand))
        sweep.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    indexer.engine, indexer.serving_dtype = "auto", jnp.float32

    parity, parity_ok = _engine_parity(corpus_np, queries_np, hashing,
                                       params)
    if not parity_ok:
        raise RuntimeError(f"engine parity failed: {parity}")

    layout_rows = [s for s in sweep if "qps" in s]
    exact_recall = max(s["recall"] for s in layout_rows)
    eligible = [s for s in layout_rows if s["recall"] >= exact_recall - 0.01]
    best = max(eligible, key=lambda s: s["qps"])
    result = {
        "metric": "qps_glove100_shape_1.18M_recall_constrained",
        "value": best["qps"],
        "unit": "queries/s",
        "engine": best["engine"],
        "dtype": best["dtype"],
        "recall_at_10": best["recall"],
        "query_size": best["query_size"],
        "cap": best["cap"],
        "max_bucket": int(max_bucket),
        "sweep": sweep,
        "engine_parity": parity,
        "reps": REPS,
        "pipeline_depth": PIPELINE_DEPTH,
        "build_s": build_s,
        "build_cold_s": build_cold_s,
        "train_s": train_s,
        "gt_s": gt_s,
        "subset_knn_s": knn_s,
        "total_s": time.perf_counter() - t_start,
        "device": device,
        "card": card,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
