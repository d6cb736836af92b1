#!/usr/bin/env python
"""Full-scale training run on the bench workload.

bench.py's 1000-step/131k-subset fit measures the serving path; this
script demonstrates the TRAINING axis at reference scale: a long
triplet fit on a 512k subset of the 1.18M-corpus workload with
periodic full-corpus evals, logging loss/recall curves to a committed
JSONL artifact, then a final serving-grade measurement.

Reference anchor: the 100-epoch loop at ``nlsh/trainers/base.py:36-115``.

Usage:  python benchmarks/train_full.py   (needs a GPU)
Writes: benchmarks/artifacts/train_full_glove100.jsonl (loss/recall curves)
        <bench cache>/nlsh_full_model.* (the trained model, reusable by
        frontier.py)
Prints: one JSON summary line with the device and the card's name and
        power limit.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# default is the FULL 1.18M corpus — the fit the reference's 100-epoch
# loop implies; NLSH_TRAIN_FULL_N=524288 gives a subset run.
TRAIN_SUBSET = int(os.environ.get("NLSH_TRAIN_FULL_N", 1_183_514))
MAX_STEPS = int(os.environ.get("NLSH_TRAIN_FULL_STEPS", 6000))
# cosine decay by default — a fixed-LR run peaks mid-run and its recall
# decays afterwards; NLSH_TRAIN_FULL_SCHED=constant gives the fixed-LR
# curve.
LR_SCHEDULE = os.environ.get("NLSH_TRAIN_FULL_SCHED", "cosine")
# decay floor as a fraction of peak LR (smaller floors + linear decay
# pull LR down faster through the mid-run window)
LR_END_FRAC = float(os.environ.get("NLSH_TRAIN_FULL_END_FRAC", 0.05))
EVAL_EVERY = 1000
BATCH = 2048
HASH_TIMES = 16
SEED = 0


def _self_knn_sliced(corpus_np, k, metric, cache_tag, slice_rows=131_072,
                     precision="default"):
    """Self-kNN of the full corpus, one query slice per device call,
    each slice fetched to host and checkpointed to disk.

    Slicing turns the one-shot 1.18M self-kNN into ~10 resumable calls:
    a rerun after a crash skips finished slices.

    Mining GT does not need rank-boundary exactness, so the default
    precision here is the fast single-pass matmul (``knn``'s docstring;
    3x cheaper than the ``highest`` GT passes).
    """
    import jax.numpy as jnp

    from nlsh_jax.ops.knn import knn

    import bench

    n = corpus_np.shape[0]
    cache_dir = bench.CACHE_DIR
    os.makedirs(cache_dir, exist_ok=True)
    out_path = os.path.join(cache_dir, f"selfknn_{cache_tag}_n{n}_k{k}.npy")
    done_path = out_path[:-len(".npy")] + "_done.npy"
    n_slices = -(-n // slice_rows)
    if os.path.exists(out_path):
        out = np.lib.format.open_memmap(out_path, mode="r+")
        done = (np.load(done_path) if os.path.exists(done_path)
                else np.zeros(n_slices, bool))
    else:
        out = np.lib.format.open_memmap(out_path, mode="w+",
                                        dtype=np.int32, shape=(n, k))
        done = np.zeros(n_slices, bool)
    if done.all():
        return np.asarray(out)
    corpus = jnp.asarray(corpus_np)  # no-op if already on device
    ids = np.arange(n, dtype=np.int32)
    for s in range(n_slices):
        if done[s]:
            continue
        lo, hi = s * slice_rows, min((s + 1) * slice_rows, n)
        t0 = time.perf_counter()
        _, nbr = knn(corpus[lo:hi], corpus, k=k, metric=metric,
                     query_tile=1024, corpus_chunk=131_072,
                     exclude_self=True, query_ids=jnp.asarray(ids[lo:hi]),
                     precision=precision)
        out[lo:hi] = np.asarray(nbr)
        done[s] = True
        np.save(done_path, done)
        print(f"# self-knn slice {s + 1}/{n_slices} "
              f"({time.perf_counter() - t0:.0f}s)",
              file=sys.stderr, flush=True)
    out.flush()
    return np.asarray(out)


class _Data:
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


def main():
    import jax
    import jax.numpy as jnp

    import bench
    from nlsh_jax.index import Indexer
    from nlsh_jax.models import get_encoder, get_hashing
    from nlsh_jax.ops.knn import knn, self_knn
    from nlsh_jax.train import TripletTrainer
    from nlsh_jax.utils import checkpoint as ckpt
    from nlsh_jax.utils.device import card_info, require_gpu
    from nlsh_jax.utils.env import setup_compile_cache
    from nlsh_jax.utils.loggers import JSONLLogger
    from nlsh_jax.utils.metrics import calculate_recall

    setup_compile_cache()
    device = require_gpu()
    work_dir = os.path.join(bench.CACHE_DIR, "train_full")
    os.makedirs(work_dir, exist_ok=True)
    model_path = os.path.join(bench.CACHE_DIR, "nlsh_full_model")
    t_start = time.perf_counter()
    rng = np.random.default_rng(SEED)
    corpus_np, queries_np = bench.glove100_workload(rng)
    corpus = jnp.asarray(corpus_np)
    queries = jnp.asarray(queries_np)

    full = TRAIN_SUBSET >= bench.N_CORPUS
    if full:
        # same workload + constants as bench.py: reuse its keyed GT
        # cache (the committed repo copy makes this a disk read);
        # sub_idx=None skips bench's 131k subset self-kNN on a miss —
        # this path mines neighbours over the whole corpus below
        gt, _, gt_s, _ = bench._load_or_compute_gt(
            corpus_np, queries_np, None)
        subset = corpus_np
        t0 = time.perf_counter()
        sub_knn = _self_knn_sliced(corpus, k=20, metric="cosine",
                                   cache_tag=f"trainfull_s{SEED}")
        knn_s = time.perf_counter() - t0
    else:
        t0 = time.perf_counter()
        _, gt = knn(queries, corpus, k=bench.K, metric="cosine",
                    query_tile=1024, corpus_chunk=131_072)
        gt = np.asarray(jax.block_until_ready(gt))
        gt_s = time.perf_counter() - t0
        sub_idx = rng.choice(bench.N_CORPUS, TRAIN_SUBSET, replace=False)
        subset = corpus_np[sub_idx]
        t0 = time.perf_counter()
        sub_knn = np.asarray(self_knn(jnp.asarray(subset), k=20,
                                      metric="cosine",
                                      query_tile=1024,
                                      corpus_chunk=131_072))
        knn_s = time.perf_counter() - t0
    print(f"# gt {gt_s:.0f}s, self-knn({subset.shape[0]}) {knn_s:.0f}s",
          file=sys.stderr, flush=True)

    # during-training evals index the training subset, so their GT must
    # be vs the SUBSET corpus (a consistent recall curve); the final
    # measurement below uses the full-corpus GT.  XLA eval engine skips
    # the per-eval serving-layout rebuild (layout only matters for QPS).
    if full:
        sub_gt = gt[:2000]  # training corpus == full corpus
    else:
        _, sub_gt = knn(jnp.asarray(queries_np[:2000]), jnp.asarray(subset),
                        k=bench.K, metric="cosine",
                        query_tile=1024, corpus_chunk=131_072)
        sub_gt = np.asarray(sub_gt)
    data = _Data(subset, queries_np[:2000], sub_gt, sub_knn, "cosine")
    art_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "artifacts")
    run_name = ("train_full_glove100_1.18M" if full
                else "train_full_glove100")
    if LR_SCHEDULE != "constant":
        run_name += f"_{LR_SCHEDULE}"
        if LR_END_FRAC != 0.05:
            run_name += f"_e{LR_END_FRAC}"
    logger = JSONLLogger(os.path.join(art_dir, f"{run_name}.jsonl"),
                         run_name=run_name)
    logger.meta({"corpus": bench.N_CORPUS, "train_subset": TRAIN_SUBSET,
                 "max_steps": MAX_STEPS, "batch": BATCH,
                 "hash_times": HASH_TIMES, "probe_mode": "flip",
                 "balance_lambda": 1.5, "lr_schedule": LR_SCHEDULE})

    enc = get_encoder("siren", bench.DIM, [256, 256])
    hashing = get_hashing("MultivariateBernoulli", enc, bench.HASH_SIZE)
    trainer = TripletTrainer(hashing, data, work_dir, logger=logger,
                             margin=0.5, positive_k=20, balance_lambda=1.5)
    trainer.eval_engine = "xla"

    t0 = time.perf_counter()
    state = trainer.fit(K=bench.K, batch_size=BATCH, learning_rate=1e-3,
                        epochs=1000, test_every_updates=EVAL_EVERY,
                        max_steps=MAX_STEPS, hash_times=HASH_TIMES,
                        probe_mode="flip", seed=SEED,
                        lr_schedule=LR_SCHEDULE, lr_end_frac=LR_END_FRAC)
    train_s = time.perf_counter() - t0

    # serve the BEST checkpoint, not the last step: the recall curve
    # peaks mid-run and decays (overtraining collapses the partition),
    # which is exactly what the best-recall checkpoint gate is for
    # (reference ``trainers/base.py:100-103``)
    import glob
    import re

    best_recall, best_path = -1.0, None
    # anchor the WHOLE basename: 'train_full_glove100' is a prefix of
    # 'train_full_glove100_1.18M', so a loose suffix match would let a
    # subset rerun silently serve the full run's checkpoints
    pat = re.compile(rf"^{re.escape(run_name)}_(\d+)_([0-9.]+)\.json$")
    for p in glob.glob(os.path.join(work_dir, f"{run_name}_*.json")):
        m = pat.match(os.path.basename(p))
        if m and float(m.group(2)) > best_recall:
            best_recall, best_path = float(m.group(2)), p[: -len(".json")]
    if best_path is not None:
        hashing, params = ckpt.load_model(best_path)
        print(f"# best checkpoint {best_path} (subset recall {best_recall})",
              file=sys.stderr, flush=True)
    else:
        params = state.params["hashing"]
    ckpt.save_model(model_path, hashing, params)

    # final serving-grade measurement on the FULL corpus
    t0 = time.perf_counter()
    indexer = Indexer(hashing, params, corpus, metric="cosine",
                      engine="grouped", serving_dtype=jnp.bfloat16)
    mean_bucket = bench.N_CORPUS / hashing.n_buckets
    cap = 1 << int(np.ceil(np.log2(1.2 * mean_bucket)))
    indexer.probe_budget = int(cap)
    jax.block_until_ready(indexer.table.row_ids)
    build_s = time.perf_counter() - t0
    qkey = jax.random.PRNGKey(SEED + 1)
    top, n_cand = indexer.query(queries, k=bench.K, hash_times=HASH_TIMES,
                                key=qkey, probe_mode="flip")  # warm
    t0 = time.perf_counter()
    top, n_cand = indexer.query(queries, k=bench.K, hash_times=HASH_TIMES,
                                key=qkey, probe_mode="flip")
    query_s = time.perf_counter() - t0
    recall = float(calculate_recall(gt, top, np.mean))
    logger.log("final/recall", recall, int(state.step))
    logger.log("final/query_size", float(np.mean(n_cand)), int(state.step))
    logger.log("final/qps", queries.shape[0] / query_s, int(state.step))
    logger.close()

    print(json.dumps({
        "run": run_name,
        "lr_schedule": LR_SCHEDULE,
        "n_train": int(subset.shape[0]),
        "steps": int(state.step),
        "train_s": train_s,
        "final_recall_at_10": recall,
        "final_query_size": float(np.mean(n_cand)),
        "final_qps": queries.shape[0] / query_s,
        "build_s": build_s,
        "total_s": time.perf_counter() - t_start,
        "artifact": f"benchmarks/artifacts/{run_name}.jsonl",
        "model": model_path,
        "device": device,
        "card": card_info(),
    }))


if __name__ == "__main__":
    main()
