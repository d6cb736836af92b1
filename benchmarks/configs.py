#!/usr/bin/env python
"""BASELINE.json experiment configs, runnable end-to-end.

The five north-star configurations:

1. glove-25-shape 100k subset — single 2-layer MLP hashing, 256 buckets
2. sift-128-shape 1M — euclidean rerank, larger table
3. glove-100-shape 1.18M — trained hashing + multi-probe (== bench.py)
4. glove-100-shape, L=8 multi-table ensemble, jointly trained
5. deep-image-96-shape 10M — bucket tables sharded across the mesh

Real ann-benchmarks files are used when the ``NLSH_PROCESSED_*`` env
vars point at them; otherwise each config runs on a synthetic clustered
stand-in with the same shape (see ``_data``).  Every config prints one
JSON line: ``{config, recall_at_10, query_size, qps, build_s, ...}``.

Usage:
    python benchmarks/configs.py 1          # run config 1
    python benchmarks/configs.py all        # run everything that fits
"""

from __future__ import annotations

import json
import os
import sys
import time
import types

import numpy as np


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


class _StderrLogger:
    """Trainer progress on STDERR: these scripts' stdout is a JSONL
    artifact, and the default NullLogger's stdout prints (reference
    parity) would contaminate it."""

    run_name = "bench"

    def __init__(self, every: int = 100):
        self._every = every

    def meta(self, params=None, **kw):
        pass

    def args(self, text):
        pass

    def log(self, name, value, step):
        if step % self._every == 0:
            _log(f"Step {step} {name}: {value}")


# config-5 cluster model (the rng draw ORDER here is part of the
# protocol: any change regenerates a different corpus under the same
# cache keys)
CFG5_CLUSTERS = 8192
CFG5_NOISE = 0.3


def deepimage96_points(centers, rng, n, dim=96):
    """``n`` unit-sphere points from the config-5 cluster model, drawn
    from ``rng`` as (assignments, then noise)."""
    assign = rng.integers(0, centers.shape[0], size=n)
    pts = centers[assign] + CFG5_NOISE * rng.normal(
        size=(n, dim)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    return pts


def deepimage96_workload(rng, n_corpus, n_test=2000, dim=96):
    """(centers, corpus, queries) for the config-5 protocol; centers are
    returned so callers can synthesize FRESH same-distribution queries
    (big-batch throughput without a hot working set)."""
    centers = rng.normal(size=(CFG5_CLUSTERS, dim)).astype(np.float32)
    pts = deepimage96_points(centers, rng, n_corpus + n_test, dim=dim)
    return centers, pts[:n_corpus], pts[n_corpus:]


def measure_qps_batch(idx, centers, rng, qbatch, probes, dim=96):
    """Big-batch serving throughput on FRESH cluster-model queries.

    The grouped/windowed engines pay a fixed cost per DISTINCT probed
    (bucket, block) cell; query multiplicity (nq*P/NB) amortises it
    linearly, so production-size batches are a lever at 10M.  Timing:
    warm once, then min over 3 rounds of 4 in-flight dispatches, each
    fetched to the host."""
    import jax
    import jax.numpy as jnp

    qbig = jnp.asarray(deepimage96_points(centers, rng, qbatch, dim=dim))
    serve = lambda: idx.query_async(  # noqa: E731
        qbig, k=10, hash_times=probes, key=jax.random.PRNGKey(1),
        probe_mode="flip")
    idx.fetch(serve())  # compile + warm
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        outs = [serve() for _ in range(4)]
        for o in outs:
            idx.fetch(o)
        times.append((time.perf_counter() - t0) / 4)
    return {"qps_batch": round(qbatch / min(times), 1), "qbatch": qbatch}


def _data(data_id, n_train, n_test, dim, metric, k=10, seed=0):
    """Real dataset if configured, else a synthetic stand-in."""
    from nlsh_jax.data import SyntheticDataset, get_data_by_id
    from nlsh_jax.utils.env import get_env

    env_keys = {
        "glove_25": "NLSH_PROCESSED_GLOVE_25_PATH",
        "glove_100": "NLSH_PROCESSED_GLOVE_100_PATH",
        "sift": "NLSH_PROCESSED_SIFT_PATH",
    }
    if data_id in env_keys and get_env(env_keys[data_id]):
        _log(f"using real dataset {data_id}")
        return get_data_by_id(data_id).load()
    _log(f"synthetic stand-in for {data_id}: {n_train}x{dim} {metric}")
    return SyntheticDataset(
        n_train=n_train, n_test=n_test, dim=dim,
        n_clusters=max(64, n_train // 512), metric=metric,
        k_ground_truth=max(k, 20), seed=seed,
        compute_self_knn=n_train <= 200_000,
    ).load()


def _train(hashing, data, steps, batch_size=1024, lr=1e-3, n_tables=None,
           cache_tag=None, balance_lambda=0.0, hash_times=10):
    """Deterministic-in-config fit with an optional keyed param cache
    (the bench.py pattern): re-measuring a config's serving path should
    not pay the training run again; training time is reported as 0 on
    a cache hit."""
    from nlsh_jax.train import MultiTableTrainer, TripletTrainer

    import bench
    from nlsh_jax.utils.checkpoint import load_tree, save_tree

    path = None
    margin, positive_k = 0.5, 20
    if cache_tag:
        cache_dir = os.environ.get("NLSH_BENCH_CACHE_DIR", bench.CACHE_DIR)
        os.makedirs(cache_dir, exist_ok=True)
        fname = (f"cfgparams_{cache_tag}_s{steps}_b{batch_size}"
                 f"_t{n_tables or 1}_v3.npz")
        path = os.path.join(cache_dir, fname)
    # self-verifying meta (the bench.py cache pattern): every training
    # hyper-parameter plus a data fingerprint rides a sidecar json —
    # a tag collision or a tuned hparam that kept the param SHAPES
    # (lr, margin, data regen) must recompute, never silently serve
    # a stale fit
    import hashlib

    tr_np = np.ascontiguousarray(data.training[:64], dtype=np.float32)
    meta = {
        "steps": steps, "batch_size": batch_size, "lr": lr,
        "n_tables": n_tables or 1, "margin": margin,
        "positive_k": positive_k,
        "hashing": type(hashing).__name__,
        "data_shape": list(np.asarray(data.training).shape),
        "data_digest": hashlib.sha1(tr_np.tobytes()).hexdigest()[:16],
    }
    if balance_lambda:  # keep old cache keys valid for unbalanced fits
        meta["balance_lambda"] = balance_lambda
    if hash_times != 10:
        meta["hash_times"] = hash_times
    tr = TripletTrainer(hashing, data,
                        os.path.join(bench.CACHE_DIR, "models"),
                        logger=_StderrLogger(),
                        margin=margin, positive_k=positive_k,
                        balance_lambda=balance_lambda)
    if n_tables:
        tr = MultiTableTrainer(tr, n_tables)
    if path and os.path.exists(path):
        import jax

        stored = None
        if os.path.exists(path + ".meta.json"):
            with open(path + ".meta.json") as f:
                stored = json.load(f)
        if stored == meta:
            key = jax.random.PRNGKey(0)
            like = {"hashing": tr.init_hashing_params(key),
                    "extra": tr.init_extra(key)}
            state = types.SimpleNamespace(params=load_tree(path, like))
            return state, 0.0
        _log(f"param cache meta mismatch for {path}: retraining")
    t0 = time.perf_counter()
    state = tr.fit(K=10, batch_size=batch_size, learning_rate=lr,
                   epochs=1000, test_every_updates=10**9, max_steps=steps,
                   hash_times=hash_times)
    train_s = time.perf_counter() - t0
    if path:
        save_tree(path, state.params)
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)
    return state, train_s


def _measure(idx, async_fn, queries, gt, n_runs=2, pipeline=4):
    """Pipelined throughput: R back-to-back ``query_async`` dispatches
    with all fetches at the END of the timed region (host dispatch cost
    overlaps device execution; per-call-fetch timing is reported
    alongside)."""
    from nlsh_jax.utils.metrics import calculate_recall

    top, n_cand = idx.fetch(async_fn(queries))  # compile + warm
    times, times1 = [], []
    for _ in range(n_runs):
        t0 = time.perf_counter()
        outs = [async_fn(queries) for _ in range(pipeline)]
        for o in outs:
            idx.fetch(o)
        times.append((time.perf_counter() - t0) / pipeline)
        t0 = time.perf_counter()
        top, n_cand = idx.fetch(async_fn(queries))
        times1.append(time.perf_counter() - t0)
    return {
        "recall_at_10": round(float(calculate_recall(gt[:, :10], top, np.mean)), 4),
        "query_size": round(float(np.mean(n_cand)), 1),
        "qps": round(queries.shape[0] / min(times), 1),
        "qps_unpipelined": round(queries.shape[0] / min(times1), 1),
    }


def config_1():
    """glove-25 100k subset, MLP trunk, 8-bit (256-bucket) hashing."""
    import jax, jax.numpy as jnp
    from nlsh_jax.index import Indexer
    from nlsh_jax.models import get_encoder, get_hashing

    data = _data("glove_25", 100_000, 10_000, 25, "cosine")
    hashing = get_hashing(
        "MultivariateBernoulli", get_encoder("mlp", data.dim, [256, 256]), 8
    )
    state, train_s = _train(hashing, data, steps=400, cache_tag="cfg1_glove25")
    t0 = time.perf_counter()
    idx = Indexer(hashing, state.params["hashing"],
                  jnp.asarray(data.training), metric=data.metric)
    build_s = time.perf_counter() - t0
    m = _measure(
        idx,
        lambda q: idx.query_async(q, k=10, hash_times=10,
                                  key=jax.random.PRNGKey(1)),
        jnp.asarray(data.testing), np.asarray(data.ground_truth),
    )
    return {"config": "1_glove25_100k", "train_s": round(train_s, 1),
            "build_s": round(build_s, 2), **m}


def config_2():
    """sift-128 1M, euclidean rerank."""
    import jax, jax.numpy as jnp
    from nlsh_jax.index import Indexer
    from nlsh_jax.models import get_encoder, get_hashing
    from nlsh_jax.ops.knn import self_knn

    data = _data("sift", 1_000_000, 10_000, 128, "euclidean")
    # train on a subset (self-kNN of the full 1M is the offline
    # precompute path; keep this config bounded)
    rng = np.random.default_rng(0)
    sub = rng.choice(data.training.shape[0], 131_072, replace=False)
    subset = data.training[sub]
    sub_knn = np.asarray(self_knn(jnp.asarray(subset), k=20,
                                  metric="euclidean"))

    class _Sub:
        training = subset
        testing = data.testing[:256]
        ground_truth = data.ground_truth[:256]
        training_self_knn = sub_knn
        metric = "euclidean"
        prepared = True
        dim = data.dim

        def load(self):
            return self

    # the euclidean config gets the cosine playbook — balance
    # regulariser, deterministic flip probes, f32 serving layout (bf16
    # storage rounding scrambles near-tied euclidean top-10s exactly as
    # it does cosine ones).  Knobs ride the env for probe sweeps.
    bits = int(os.environ.get("NLSH_CONFIG2_BITS", 12))
    bl = float(os.environ.get("NLSH_CONFIG2_BL", 1.5))
    probes = int(os.environ.get("NLSH_CONFIG2_PROBES", 16))
    hashing = get_hashing(
        "MultivariateBernoulli",
        get_encoder("siren", data.dim, [256, 256]), bits
    )
    state, train_s = _train(hashing, _Sub(), steps=400, batch_size=2048,
                            cache_tag=f"cfg2_sift_h{bits}" if bits != 12
                            else "cfg2_sift",
                            balance_lambda=bl, hash_times=16)
    t0 = time.perf_counter()
    # ||c||^2 rides a separate array, so d=128 reads 128 columns (not
    # the 256 a d+1 column would pad to); the grouped engine reads
    # occupancy-proportional bytes
    idx = Indexer(hashing, state.params["hashing"],
                  jnp.asarray(data.training), metric="euclidean",
                  serving_dtype=jnp.float32, engine="grouped")
    build_s = time.perf_counter() - t0
    m = _measure(
        idx,
        lambda q: idx.query_async(q, k=10, hash_times=probes,
                                  key=jax.random.PRNGKey(1),
                                  probe_mode="flip"),
        jnp.asarray(data.testing), np.asarray(data.ground_truth),
    )
    return {"config": "2_sift_1M", "bits": bits, "probes": probes,
            "balance_lambda": bl, "train_s": round(train_s, 1),
            "build_s": round(build_s, 2), **m}


def config_3():
    """glove-100 1.18M end-to-end — delegated to bench.py."""
    import bench

    r = bench.main()
    r["config"] = "3_glove100_1.18M"
    return r


def config_4(n_train=200_000):
    """glove-100-shape, L=8 jointly-trained multi-table ensemble."""
    import jax, jax.numpy as jnp
    from nlsh_jax.models import get_encoder, get_hashing
    from nlsh_jax.parallel import MultiTableIndexer

    import os
    n_train = int(os.environ.get("NLSH_CONFIG4_N", n_train))
    # 10k queries (same as config 3): ensemble probes have ~L*nq/(L*NB)
    # per-bucket multiplicity, so serving throughput needs a real batch
    # to fill query groups
    n_test = 10_000 if n_train >= 100_000 else 2000
    data = _data("glove_100_mt", n_train, n_test, 100, "cosine")
    hashing = get_hashing(
        "MultivariateBernoulli", get_encoder("siren", data.dim, [128, 128]), 10
    )
    state, train_s = _train(hashing, data, steps=300, batch_size=1024,
                            n_tables=8, cache_tag="cfg4_glove100mt")
    t0 = time.perf_counter()
    # f32 serving layout: no bf16 storage rounding to scramble
    # near-tied top-10s; ONE stacked layout served by one windowed call
    idx = MultiTableIndexer(hashing, state.params["hashing"],
                            jnp.asarray(data.training), metric="cosine",
                            serving_dtype=jnp.float32)
    # one-time serving calibration on corpus rows as stand-in traffic
    # (guarded: a batch exceeding the calibrated group bound falls back
    # to the static-bound program on device, never drops candidates)
    if idx.engine == "windowed":
        g_cal = idx.calibrate(jnp.asarray(data.training[:n_test]),
                              hash_times=1)
        print(f"calibrated windowed group bound: {g_cal}", flush=True)
    build_s = time.perf_counter() - t0
    m = _measure(
        idx,
        lambda q: idx.query_async(q, k=10, hash_times=1),
        jnp.asarray(data.testing), np.asarray(data.ground_truth),
    )
    # one-dispatch pipelined timing (the bench methodology): R repeats
    # inside ONE compiled program, one fetch — the per-call host cost
    # amortises over R*nq queries
    if idx.engine == "windowed":
        from nlsh_jax.parallel.multitable import _fused_mt_serve_batched

        queries = jnp.asarray(data.testing)
        R = 16
        batched = lambda: _fused_mt_serve_batched(  # noqa: E731
            idx.hashing, idx.params, idx._serving_layout(), queries,
            jax.random.PRNGKey(0), k=10, hash_times=1,
            engine=idx.engine, n_rows=idx.corpus.shape[0], repeats=R,
            g_override=idx._g_cal,
        )
        np.asarray(batched())  # compile + warm
        times = []
        for _ in range(6):
            t0 = time.perf_counter()
            np.asarray(batched())
            times.append((time.perf_counter() - t0) / R)
        m["qps_one_dispatch"] = round(queries.shape[0] / min(times), 1)
    # engine-independent query_size: the timed path reports an
    # occupancy upper bound on the layout engines
    m["query_size"] = round(float(np.mean(
        idx.exact_query_size(jnp.asarray(data.testing), hash_times=1)
    )), 1)
    return {"config": "4_multitable_L8", "train_s": round(train_s, 1),
            "build_s": round(build_s, 2), **m}


def config_5(n_corpus=None):
    """deep-image-96-shape 10M, bucket tables sharded across the mesh.

    ``NLSH_CONFIG5_N`` overrides the corpus size (e.g. for CPU smoke)."""
    import os

    import jax, jax.numpy as jnp

    if n_corpus is None:
        n_corpus = int(os.environ.get("NLSH_CONFIG5_N", 10_000_000))
    from nlsh_jax.models import get_encoder, get_hashing
    from nlsh_jax.ops.knn import knn
    from nlsh_jax.parallel import ShardedIndexer, make_mesh

    dim, n_test = 96, 2000
    rng = np.random.default_rng(0)
    _log(f"generating {n_corpus} x {dim} corpus")
    # corpus stays numpy: ShardedIndexer keeps the host copy so the
    # host layout builder never fetches 4 GB back from the device
    centers, corpus, queries = deepimage96_workload(rng, n_corpus,
                                                    n_test=n_test, dim=dim)
    queries = jnp.asarray(queries)

    _log("exact GT")
    _, gt = knn(queries, corpus, k=10, metric="cosine",
                query_tile=1024, corpus_chunk=131_072)
    gt = np.asarray(gt)

    # hash bits are the recall-priced lever at 10M — 2 more bits ~ 4x
    # smaller mean bucket
    bits = int(os.environ.get("NLSH_CONFIG5_BITS", 14))
    hashing = get_hashing(
        "MultivariateBernoulli", get_encoder("siren", dim, [256, 256]), bits
    )
    # short balance-regularised fit on a subset: an untrained hash on
    # clustered data is so skewed (max bucket ~300x mean) that the
    # cap-aligned serving layout and probe budget explode
    from nlsh_jax.ops.knn import self_knn

    _log("subset fit")
    n_sub = int(os.environ.get("NLSH_CONFIG5_SUB", 131_072))
    sub = rng.choice(n_corpus, n_sub, replace=False)
    subset = corpus[sub]
    sub_knn = np.asarray(self_knn(jnp.asarray(subset), k=20, metric="cosine"))
    d0 = dim

    class _Sub:
        training = subset
        testing = np.asarray(queries[:256])
        ground_truth = gt[:256]
        training_self_knn = sub_knn
        metric = "cosine"
        prepared = True
        dim = d0

        def load(self):
            return self

    from nlsh_jax.train import TripletTrainer

    steps = int(os.environ.get("NLSH_CONFIG5_STEPS", 400))
    import bench

    tr = TripletTrainer(hashing, _Sub(),
                        os.path.join(bench.CACHE_DIR, "models"),
                        margin=0.5, positive_k=20, balance_lambda=1.5)
    state = tr.fit(K=10, batch_size=2048, learning_rate=1e-3, epochs=100,
                   test_every_updates=10**9, max_steps=steps, hash_times=10)
    params = state.params["hashing"]

    mesh = make_mesh(axis="shard")
    _log(f"sharding over {mesh.devices.size} device(s)")
    # engine/block_rows sweepable from the env — the windowed engine's
    # dense 8-row layout is built for exactly this config's low
    # occupancy (mean bucket ~122 pads ~4x inside 512-row blocks)
    engine = os.environ.get("NLSH_CONFIG5_ENGINE", "grouped")
    block_rows = os.environ.get("NLSH_CONFIG5_BR")
    # matched-candidate bits sweeps: +2 bits needs ~4x the probes to
    # hold the candidate budget (the recall axis of the 10M roofline)
    probes = int(os.environ.get("NLSH_CONFIG5_PROBES", 16))
    t0 = time.perf_counter()
    # host-built serving layout (keeps the full-corpus scatter off the
    # device) + grouped engine + bf16
    idx = ShardedIndexer(hashing, params, corpus, mesh, metric="cosine",
                         engine=engine,
                         serving_dtype=jnp.bfloat16,
                         block_rows=int(block_rows) if block_rows else None)
    build_s = time.perf_counter() - t0
    m = _measure(
        idx,
        lambda q: idx.query_async(q, k=10, hash_times=probes,
                                  key=jax.random.PRNGKey(1),
                                  probe_mode="flip"),
        queries, gt,
    )
    # big-batch serving throughput: the grouped/windowed engines pay a
    # fixed cost per DISTINCT probed (bucket, block) cell, so at 2^16
    # buckets a 2k-query batch pays it for few queries, while query
    # multiplicity (m_b = nq*P/NB) amortises it linearly.
    # Recall comes from the exact-GT 2k batch above (same distribution).
    qbatch = int(os.environ.get("NLSH_CONFIG5_QBATCH", 0))
    if qbatch > n_test:
        m.update(measure_qps_batch(idx, centers, rng, qbatch, probes,
                                   dim=dim))
    return {"config": "5_deepimage96_10M_sharded",
            "n_corpus": int(n_corpus), "engine": engine, "bits": bits,
            "probes": probes,
            "n_shards": int(mesh.devices.size),
            "build_s": round(build_s, 2), **m}


def config_pq(n_train=200_000):
    """glove-100-shape 200k with the ProductQuantization head (12 bits
    = 3 bands x 4 bits): the hashing family the reference declares but
    leaves an empty stub (``nlsh/hashings.py:142-145``), trained and
    served end-to-end."""
    import jax, jax.numpy as jnp
    from nlsh_jax.index import Indexer
    from nlsh_jax.models import get_encoder, get_hashing

    data = _data("glove_100_pq", n_train, 2000, 100, "cosine")
    hashing = get_hashing(
        "ProductQuantization", get_encoder("siren", data.dim, [256, 256]), 12
    )
    state, train_s = _train(hashing, data, steps=400, batch_size=2048)
    t0 = time.perf_counter()
    idx = Indexer(hashing, state.params["hashing"],
                  jnp.asarray(data.training), metric="cosine",
                  serving_dtype=jnp.bfloat16, engine="grouped")
    build_s = time.perf_counter() - t0
    m = _measure(
        idx,
        lambda q: idx.query_async(q, k=10, hash_times=10,
                                  key=jax.random.PRNGKey(1)),
        jnp.asarray(data.testing), np.asarray(data.ground_truth),
    )
    return {"config": "pq_glove100_200k", "train_s": round(train_s, 1),
            "build_s": round(build_s, 2), **m}


CONFIGS = {"1": config_1, "2": config_2, "3": config_3, "4": config_4,
           "5": config_5, "pq": config_pq}


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "1"
    keys = list(CONFIGS) if which == "all" else [which]
    for key in keys:
        result = CONFIGS[key]()
        print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
