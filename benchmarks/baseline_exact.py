#!/usr/bin/env python
"""Non-learned baseline: the exact brute-force scan on the GPU.

The reference's recall/QPS yardstick is hnswlib
(``nlsh/trainers/hnsw.py:36-63``); the accelerator's own non-learned
baseline is the exact tiled brute-force kNN (:mod:`nlsh_jax.ops.knn` —
the same code that produces ground truth).  It answers every query at
recall 1.0; the learned index's value is the throughput multiple it
buys at its recall operating point.  Needs a GPU; prints one JSON line
with the device and the card's name and power limit.

Scale note: brute force is O(n) per query, the learned index is
O(candidates), so the gap widens linearly with corpus size.

    python benchmarks/baseline_exact.py
"""

from __future__ import annotations

import json
import time

import numpy as np

import bench


def main():
    import jax.numpy as jnp

    from nlsh_jax.ops.knn import knn
    from nlsh_jax.utils.device import card_info, require_gpu
    from nlsh_jax.utils.env import setup_compile_cache

    setup_compile_cache()
    device = require_gpu()
    rng = np.random.default_rng(bench.SEED)
    corpus_np, queries_np = bench.glove100_workload(rng)
    corpus = jnp.asarray(corpus_np)
    queries = jnp.asarray(queries_np)
    nq = queries.shape[0]

    # same tiling as the GT precompute; one warm-up for compile
    t_compile = time.perf_counter()
    _, ids = knn(queries, corpus, k=bench.K, metric="cosine",
                 query_tile=1024, corpus_chunk=131_072)
    ids = np.asarray(ids)
    compile_s = time.perf_counter() - t_compile

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, ids = knn(queries, corpus, k=bench.K, metric="cosine",
                     query_tile=1024, corpus_chunk=131_072)
        ids = np.asarray(ids)  # host fetch ends the timed region
        times.append(time.perf_counter() - t0)

    qps = nq / min(times)
    print(json.dumps({
        "config": "baseline_exact_bruteforce_1.18M",
        "qps": qps,
        "recall_at_10": 1.0,
        "scan_rows_per_query": corpus.shape[0],
        "compile_s": compile_s,
        "device": device,
        "card": card_info(),
    }))


if __name__ == "__main__":
    main()
