#!/usr/bin/env python
"""HNSW baseline on the headline workload (CPU only).

The reference's non-learned yardstick is hnswlib at cosine, M=10,
ef_construction=500, ef=40 (``nlsh/trainers/hnsw.py:28-34``); hnswlib
is not installable here, so this measures the in-repo native C++
implementation (``nlsh_jax/native/hnsw.cpp``) on the SAME corpus,
queries, and exact ground truth as ``bench.py`` — recall/QPS/
query_size rows directly comparable with the learned index's.

Host CPU measurement on ONE core (hnswlib numbers in ann-benchmarks
are also single-CPU-core); no accelerator is involved.  Emits one JSON
line per ef operating point.

``NLSH_HNSW_N`` bounds the corpus (default: full 1.18M); the build is
O(N · ef_construction) single-core, measured ~1-2k inserts/s at d=100.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import (
    N_QUERIES,
    SEED,
    TRAIN_SUBSET,
    _load_or_compute_gt,
    glove100_workload,
)
from nlsh_jax.native import NativeHNSW, _get_lib
from nlsh_jax.utils.metrics import calculate_recall


def main():
    if _get_lib() is None:
        print(json.dumps({"config": "baseline_hnsw", "error": "no toolchain"}))
        return
    n = int(os.environ.get("NLSH_HNSW_N", 0)) or None
    rng = np.random.default_rng(SEED)
    corpus, queries = glove100_workload(rng)
    # same rng draw position + size as bench.main so a cache MISS here
    # writes the byte-identical entry bench.py would
    sub_idx = rng.choice(corpus.shape[0], TRAIN_SUBSET, replace=False)
    if n is None or n >= corpus.shape[0]:
        n = corpus.shape[0]
        gt, _, gt_s, _ = _load_or_compute_gt(corpus, queries, sub_idx)
    else:
        # subsampled corpus: brute-force GT on host numpy (BLAS) — no
        # device touch, so this CPU-only baseline needs no accelerator
        corpus = corpus[:n]
        t0 = time.perf_counter()
        gt = np.empty((queries.shape[0], 10), dtype=np.int64)
        for s in range(0, queries.shape[0], 512):
            sims = queries[s:s + 512] @ corpus.T  # unit vectors: cosine
            part = np.argpartition(-sims, 10, axis=1)[:, :10]
            psims = np.take_along_axis(sims, part, axis=1)
            gt[s:s + 512] = np.take_along_axis(
                part, np.argsort(-psims, axis=1), axis=1)
        gt_s = time.perf_counter() - t0

    idx = NativeHNSW(space="cosine", dim=corpus.shape[1])
    idx.init_index(max_elements=n, M=10, ef_construction=500, seed=100)
    order = np.random.default_rng(SEED).permutation(n)  # shuffled inserts
    t0 = time.perf_counter()
    for s in range(0, n, 65_536):
        sel = order[s:s + 65_536]
        idx.add_items(corpus[sel], sel.astype(np.int64))
        el = time.perf_counter() - t0
        done = min(s + 65_536, n)
        print(f"built {done}/{n} ({done / el:.0f}/s)",
              file=sys.stderr, flush=True)
    build_s = time.perf_counter() - t0

    for ef in (40, 100, 200, 400):
        idx.set_ef(ef)
        t0 = time.perf_counter()
        ids, _, counts = idx.knn_query(queries, k=10)
        q_s = time.perf_counter() - t0
        row = {
            "config": "baseline_hnsw_native_1CPUcore",
            "n_corpus": int(n),
            "M": 10, "ef_construction": 500, "ef": ef,
            "build_s": round(build_s, 1),
            "gt_s": round(gt_s, 1),
            "recall_at_10": round(
                float(calculate_recall(gt[:, :10], ids, np.mean)), 4),
            "query_size": round(float(counts.mean()), 1),
            "qps": round(N_QUERIES / q_s, 1),
        }
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
