#!/usr/bin/env python
"""High-recall ensemble at headline scale.

A single 12-bit table saturates in recall at practical probe counts.
This measures the framework's answer: an L-table jointly-trained
ensemble (`parallel/multitable.py`, BASELINE config-4 machinery) on the
FULL 1.18M headline corpus, swept over per-table flip probes — L
independent learned partitions push the candidate-union recall ceiling
far above one table's, while the stacked windowed engine serves all L
tables in one call.

Sweep: hash_times (deterministic flip probes per table) x the bench
exact GT; one JSON line per operating point with recall@10, exact
distinct query_size, pipelined + per-call QPS, the device and the
card's name and power limit.

Env knobs: NLSH_MTHR_L (tables, default 8), NLSH_MTHR_BITS (hash bits,
default 12), NLSH_MTHR_STEPS (train steps, default 600), NLSH_MTHR_HT
(comma probe sweep, default "1,2,4"), NLSH_MTHR_DTYPE (serving layout,
default float32).

Usage: python benchmarks/mt_highrecall.py   (needs a GPU)
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import (
    N_CORPUS,
    SEED,
    TRAIN_CFG,
    TRAIN_SUBSET,
    _BenchData,
    _load_or_compute_gt,
    glove100_fresh_pool,
    glove100_workload,
)
from benchmarks.configs import _measure, _train


def main():
    import jax
    import jax.numpy as jnp

    from nlsh_jax.models import get_encoder, get_hashing
    from nlsh_jax.parallel import MultiTableIndexer
    from nlsh_jax.parallel.multitable import _fused_mt_serve_batched
    from nlsh_jax.utils.device import card_info, require_gpu
    from nlsh_jax.utils.env import setup_compile_cache

    L = int(os.environ.get("NLSH_MTHR_L", 8))
    bits = int(os.environ.get("NLSH_MTHR_BITS", 12))
    steps = int(os.environ.get("NLSH_MTHR_STEPS", 600))
    ht_sweep = tuple(
        int(s) for s in os.environ.get("NLSH_MTHR_HT", "1,2,4").split(",")
    )
    sdtype = jnp.dtype(os.environ.get("NLSH_MTHR_DTYPE", "float32"))

    setup_compile_cache()
    device = require_gpu()
    card = card_info()
    rng = np.random.default_rng(SEED)
    corpus_np, queries_np = glove100_workload(rng)
    sub_idx = rng.choice(N_CORPUS, TRAIN_SUBSET, replace=False)
    gt, sub_knn, _, _ = _load_or_compute_gt(corpus_np, queries_np, sub_idx)

    enc = get_encoder(TRAIN_CFG["encoder"], corpus_np.shape[1],
                      list(TRAIN_CFG["hidden"]))
    hashing = get_hashing("MultivariateBernoulli", enc, bits)
    data = _BenchData(corpus_np[sub_idx], queries_np[:256], gt[:256],
                      sub_knn, "cosine")
    state, train_s = _train(
        hashing, data, steps=steps, batch_size=TRAIN_CFG["batch_size"],
        lr=TRAIN_CFG["learning_rate"], n_tables=L,
        cache_tag=f"mthr_glove100_b{bits}",
        balance_lambda=TRAIN_CFG["balance_lambda"], hash_times=16,
    )
    print(f"trained L={L} bits={bits} in {train_s:.1f}s",
          file=sys.stderr, flush=True)

    corpus = jnp.asarray(corpus_np)
    queries = jnp.asarray(queries_np)
    t0 = time.perf_counter()
    idx = MultiTableIndexer(hashing, state.params["hashing"], corpus,
                            metric="cosine", serving_dtype=sdtype)
    jax.block_until_ready(idx.row_ids)
    build_s = time.perf_counter() - t0
    print(f"built {L}x{N_CORPUS} in {build_s:.1f}s "
          f"(layout {idx._serving_layout().data.nbytes / 2**30:.2f} GiB)",
          file=sys.stderr, flush=True)

    key = jax.random.PRNGKey(SEED + 1)
    for ht in ht_sweep:
        if idx.engine == "windowed":
            g_cal = idx.calibrate(corpus[:queries.shape[0]], hash_times=ht,
                                  probe_mode="flip")
            print(f"ht={ht}: calibrated group bound {g_cal}",
                  file=sys.stderr, flush=True)
        m = _measure(
            idx,
            lambda q: idx.query_async(q, k=10, hash_times=ht, key=key,
                                      probe_mode="flip"),
            queries, gt,
        )
        # one-dispatch pipelined timing (bench methodology): R repeats
        # in ONE compiled program, one fetch
        engine = idx.engine
        if engine != "xla":
            R = int(os.environ.get("NLSH_MTHR_R", 8))
            batched = lambda: _fused_mt_serve_batched(  # noqa: E731
                idx.hashing, idx.params, idx._serving_layout(), queries,
                key, k=10, hash_times=ht, engine=engine,
                n_rows=idx.corpus.shape[0], repeats=R,
                g_override=idx._g_cal, probe_mode="flip",
            )
            np.asarray(batched())  # compile + warm
            times = []
            for _ in range(6):
                t1 = time.perf_counter()
                np.asarray(batched())
                times.append((time.perf_counter() - t1) / R)
            m["qps_one_dispatch"] = queries.shape[0] / min(times)
        m["query_size"] = round(float(np.mean(
            idx.exact_query_size(queries, hash_times=ht, key=key,
                                 probe_mode="flip")
        )), 1)
        # production-batch throughput (the grouped/windowed cost is per
        # DISTINCT probed cell, so big batches amortise it): FRESH-query
        # pool, recall/query_size unchanged (same trained index, same
        # probes — only the batch size moves)
        qbatch = int(os.environ.get("NLSH_MTHR_QBATCH", 0))
        if qbatch and engine != "xla":
            R2 = int(os.environ.get("NLSH_MTHR_QBATCH_R", 4))
            pool = jnp.asarray(glove100_fresh_pool(R2, n_queries=qbatch))
            g_cal = idx.calibrate(pool[0], hash_times=ht,
                                  probe_mode="flip")
            print(f"ht={ht} qbatch={qbatch}: group bound {g_cal}",
                  file=sys.stderr, flush=True)
            bb = lambda: _fused_mt_serve_batched(  # noqa: E731
                idx.hashing, idx.params, idx._serving_layout(), pool,
                key, k=10, hash_times=ht, engine=engine,
                n_rows=idx.corpus.shape[0], repeats=R2,
                g_override=idx._g_cal, probe_mode="flip",
            )
            np.asarray(bb())  # compile + warm
            times = []
            for _ in range(6):
                t1 = time.perf_counter()
                np.asarray(bb())
                times.append((time.perf_counter() - t1) / R2)
            m["qbatch"] = qbatch
            m["qps_batch"] = qbatch / min(times)
        row = {
            "config": f"mt_highrecall_L{L}_b{bits}_1.18M",
            "n_corpus": int(N_CORPUS), "n_tables": L, "hash_size": bits,
            "hash_times": ht, "probe_mode": "flip",
            "serving_dtype": sdtype.name,
            "group_q": int(os.environ.get("NLSH_GROUP_Q", 32)),
            "train_s": train_s, "build_s": build_s,
            **m, "device": device, "card": card,
        }
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
