#!/usr/bin/env python
"""Recall / candidates frontier at reference scale.

The reference's core deliverable is ``eval.py``'s multi-probe sweep:
``(avg_n_candidates, recall)`` for probe counts 1..N
(``eval.py:148,196``).  This script produces that curve on the GPU at
the bench operating point (1.18M corpus, 10k
queries) for BOTH probe modes — the reference's Bernoulli sampling and
this framework's deterministic flip probing — using the trained model
saved by benchmarks/train_full.py (or training a bench-grade model if
absent).

Usage:  python benchmarks/frontier.py   (needs a GPU)
Writes: benchmarks/artifacts/frontier_glove100_{sample,flip}.jsonl
Prints: one JSON summary line per mode.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MAX_PROBES = 64
SEED = 0


def main():
    import jax
    import jax.numpy as jnp

    import bench
    from nlsh_jax.cli.evaluate import run_sweep
    from nlsh_jax.ops.knn import knn
    from nlsh_jax.utils import checkpoint as ckpt
    from nlsh_jax.utils.device import require_gpu
    from nlsh_jax.utils.env import setup_compile_cache

    setup_compile_cache()
    require_gpu()
    rng = np.random.default_rng(SEED)
    corpus_np, queries_np = bench.glove100_workload(rng)
    corpus = jnp.asarray(corpus_np)
    queries = jnp.asarray(queries_np)

    _, gt = knn(queries, corpus, k=bench.K, metric="cosine",
                query_tile=1024, corpus_chunk=131_072)
    gt = np.asarray(jax.block_until_ready(gt))

    model_path = os.environ.get(
        "NLSH_FRONTIER_MODEL", os.path.join(bench.CACHE_DIR, "nlsh_full_model"))
    if os.path.exists(model_path + ".json"):
        hashing, params = ckpt.load_model(model_path)
        print(f"# using trained model {model_path}", file=sys.stderr)
    else:
        print("# no saved model; running the bench-grade 1000-step fit",
              file=sys.stderr, flush=True)
        from nlsh_jax.models import get_encoder, get_hashing
        from nlsh_jax.ops.knn import self_knn
        from nlsh_jax.train import TripletTrainer

        sub_idx = rng.choice(bench.N_CORPUS, bench.TRAIN_SUBSET,
                             replace=False)
        subset = corpus_np[sub_idx]
        sub_knn = np.asarray(self_knn(jnp.asarray(subset), k=20,
                                      metric="cosine", query_tile=1024,
                                      corpus_chunk=131_072))
        data = bench._BenchData(subset, queries_np[:256], gt[:256],
                                sub_knn, "cosine")
        enc = get_encoder("siren", bench.DIM, [256, 256])
        hashing = get_hashing("MultivariateBernoulli", enc, bench.HASH_SIZE)
        trainer = TripletTrainer(hashing, data, bench.CACHE_DIR, margin=0.5,
                                 positive_k=20, balance_lambda=1.5)
        state = trainer.fit(K=bench.K, batch_size=2048, learning_rate=1e-3,
                            epochs=100, test_every_updates=100_000,
                            max_steps=bench.TRAIN_STEPS,
                            hash_times=bench.HASH_TIMES, seed=SEED)
        params = state.params["hashing"]

    art_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "artifacts")
    os.makedirs(art_dir, exist_ok=True)
    mean_bucket = bench.N_CORPUS / hashing.n_buckets
    cap = 1 << int(np.ceil(np.log2(1.2 * mean_bucket)))
    for mode in ("flip", "sample"):
        t0 = time.perf_counter()
        sweep = run_sweep(
            hashing, params, corpus, queries, gt, bench.K,
            max_probes=MAX_PROBES, metric="cosine", seed=SEED,
            probe_budget=int(cap), engine="grouped",
            probe_mode=mode, serving_dtype=jnp.bfloat16,
        )
        out = os.path.join(art_dir, f"frontier_glove100_{mode}.jsonl")
        with open(out, "w") as f:
            for r in sweep:
                f.write(json.dumps(r) + "\n")
        print(json.dumps({
            "run": f"frontier_glove100_{mode}",
            "max_probes": MAX_PROBES,
            "sweep_s": round(time.perf_counter() - t0, 1),
            "artifact": os.path.relpath(out, "/root/repo"),
            "points": [
                {k2: round(v, 4) for k2, v in r.items()}
                for r in sweep if r["n_probes"] in
                (1, 2, 4, 8, 16, 32, 64)
            ],
        }), flush=True)


if __name__ == "__main__":
    main()
