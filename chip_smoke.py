#!/usr/bin/env python
"""Smoke run of the main path on one GPU, at the flagship width.

The flagship configuration (the README's): a glove-100-angular-shaped
corpus of 1,183,514 x 100 float32 rows generated from a seed
(``bench.glove100_workload``), cosine metric, a SIREN 256,256 encoder
with a 12-bit MultivariateBernoulli head (4096 buckets), 10k queries,
k=10, 16 flip probes.  Weights come from a short seeded fit.

Phases, in order, each printing its own line:

1. device  — JAX's devices are GPUs; the card's name and power limit.
2. gather  — the bitwise gather canary, forced on this card.
3. train   — ``TripletTrainer.fit`` for a few steps (``bench.TRAIN_CFG``)
             on a 131,072-row subset with its exact self-kNN.
4. build   — ``Indexer`` over the full corpus: table and layout build
             times, the serve step's ``memory_analysis()``, peak memory.
5. serve   — every engine and layout through ``query_async``/``fetch``:
             recall@10 against exact ground truth, top-10 parity with a
             float64 rerank of the same candidates for cosine and
             euclidean, one warm smoke timing per engine (not a
             benchmark), and an L=8 ensemble timing.
6. persist — model and index save/load round trips; the training and
             serving CLIs in-process at the synthetic dataset's size.

``--four`` runs only the paths that span four GPUs, each beside the
one-card run it is compared with: a data-parallel fit, a corpus-sharded
index and a table-sharded ensemble.

Any failure raises (non-zero exit) before the last line, which is one
JSON object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
With no GPU the script fails before any phase.

    python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

K = 10
HASH_TIMES = 16
TRAIN_STEPS = 20
#: parity rule: a top-10 id that differs from the float64 reference
#: must score within this relative distance of the reference's k-th
#: score (dots run at Precision.HIGHEST, so no TF32; sums may run in
#: another order than numpy's)
PARITY_RTOL = 1e-5
#: f32 recall@10 of every layout engine must be this close to xla's
RECALL_ATOL = 0.002
#: data-parallel vs one-card losses, every step (at matmul precision
#: highest): same params and rows, so only the summation order of the
#: loss and of the averaged gradients differs.  A wrong batch slice, or
#: a gradient missing a device's part, moves them by far more.
DP_RTOL = 1e-4
#: engines and layout dtypes served in phase 5 (xla reads the raw corpus)
ENGINE_LAYOUTS = (("xla", "float32"),
                  ("grouped", "float32"), ("grouped", "bfloat16"),
                  ("grouped", "int8"),
                  ("windowed", "float32"), ("windowed", "bfloat16"),
                  ("windowed", "int8"))


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"[{name}] start")
    yield
    log(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)")


class _LossLog:
    """Trainer logger that keeps the per-step training loss."""

    run_name = "chip_smoke"

    def __init__(self):
        self.losses = []

    def meta(self, params=None, **kw):
        pass

    def args(self, text):
        pass

    def log(self, name, value, step):
        if name == "training/loss":
            self.losses.append(float(value))


# ---------------------------------------------------------------------------
# 1-2. device and gather canary
# ---------------------------------------------------------------------------

def phase_device(n_devices: int = 1) -> dict:
    """Raise unless JAX's devices are GPUs, at least ``n_devices``."""
    import jax

    from nlsh_jax.utils.device import card_info, require_gpu

    with phase("device"):
        dev = require_gpu()
        if dev["count"] < n_devices:
            raise RuntimeError(
                f"needs {n_devices} GPUs, JAX sees {dev['count']}")
        log(f"device: platform={dev['platform']} kind={dev['kind']} "
            f"count={dev['count']} jax={jax.__version__}")
        log("nvidia-smi name, power.limit:")
        log(card_info())
    return dict(dev, count=n_devices)


def phase_gather(n_rows: int | None = None) -> None:
    import jax

    from nlsh_jax.index import canary

    with phase("gather"):
        canary.check_gather_integrity(n_rows=n_rows, force=True)
        rows = n_rows or int(os.environ.get("NLSH_GATHER_CANARY_ROWS",
                                            canary._CANARY_ROWS))
        log(f"gather canary: bitwise clean on {jax.default_backend()} "
            f"({rows} x {canary._CANARY_WIDTH} int32 table, "
            f"{canary._CANARY_IDX} index)")


# ---------------------------------------------------------------------------
# 3. train
# ---------------------------------------------------------------------------

def workload(n_corpus: int, n_queries: int, dim: int, seed: int = 0):
    """The bench corpus and queries (seeded), and the generator after
    drawing them."""
    import bench

    rng = np.random.default_rng(seed)
    corpus, queries = bench.glove100_workload(
        rng, n_corpus=n_corpus, n_queries=n_queries, dim=dim)
    return rng, corpus, queries


def make_hashing(dim: int, hidden, hash_size: int):
    import bench
    from nlsh_jax.models import get_encoder, get_hashing

    enc = get_encoder(bench.TRAIN_CFG["encoder"], dim, list(hidden))
    return get_hashing("MultivariateBernoulli", enc, hash_size)


def train_data(corpus, rng, n_sub: int):
    """The training subset with its exact self-kNN (the trainer's
    positives), as the dataset the trainer reads."""
    import jax.numpy as jnp

    import bench
    from nlsh_jax.ops.knn import self_knn

    sub = corpus[rng.choice(corpus.shape[0], n_sub, replace=False)]
    knn = np.asarray(self_knn(
        jnp.asarray(sub), k=bench.TRAIN_CFG["positive_k"], metric="cosine",
        query_tile=1024, corpus_chunk=131_072, precision="highest"))
    # no eval runs inside these fits: testing/ground truth are shape-only
    return bench._BenchData(sub, sub[:256], np.zeros((256, K), np.int32),
                            knn, "cosine")


def fit(hashing, data, steps: int, batch_size: int, workdir: str,
        mesh=None, balance_lambda: float | None = None, seed: int = 0):
    """A few flagship-config triplet steps; returns (params, losses)."""
    import bench
    from nlsh_jax.train import TripletTrainer

    cfg = bench.TRAIN_CFG
    logger = _LossLog()
    trainer = TripletTrainer(
        hashing, data, workdir, logger=logger, margin=cfg["margin"],
        positive_k=cfg["positive_k"],
        balance_lambda=(cfg["balance_lambda"] if balance_lambda is None
                        else balance_lambda))
    state = trainer.fit(K=K, batch_size=batch_size,
                        learning_rate=cfg["learning_rate"], epochs=1000,
                        test_every_updates=10**9, max_steps=steps,
                        hash_times=HASH_TIMES, seed=seed, mesh=mesh)
    assert int(state.step) == steps, int(state.step)
    return state.params["hashing"], np.asarray(logger.losses)


def phase_train(corpus, rng, dim: int, hidden, hash_size: int, n_sub: int,
                steps: int, batch_size: int, workdir: str):
    with phase("train"):
        hashing = make_hashing(dim, hidden, hash_size)
        t0 = time.perf_counter()
        data = train_data(corpus, rng, n_sub)
        knn_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        params, losses = fit(hashing, data, steps, batch_size, workdir)
        fit_s = time.perf_counter() - t0
        if not np.isfinite(losses).all():
            raise AssertionError(f"non-finite training loss: {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(
                f"loss did not fall: first {losses[0]}, last {losses[-1]}")
        log(f"train: {steps} steps x {batch_size} rows on {n_sub} rows "
            f"(self-kNN {knn_s:.1f} s, fit {fit_s:.1f} s with compile); "
            f"loss {losses[0]:.6f} -> {losses[-1]:.6f}")
    return hashing, params


# ---------------------------------------------------------------------------
# 4. build
# ---------------------------------------------------------------------------

def serving_cap(n_corpus: int, n_buckets: int) -> int:
    """bench.py's operating point: 1.2x the mean bucket, rounded up to
    a power of two."""
    return 1 << int(np.ceil(np.log2(1.2 * n_corpus / n_buckets)))


def peak_bytes() -> str:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return "not reported" if peak is None else f"{peak / 2**30:.2f} GiB"


def phase_build(hashing, params, corpus, queries, cap: int):
    import jax
    import jax.numpy as jnp

    from nlsh_jax.index import Indexer
    from nlsh_jax.index.indexer import _fused_serve

    with phase("build"):
        corpus_dev = jnp.asarray(corpus)
        times = []
        for _ in range(2):  # cold (compiles), then warm
            t0 = time.perf_counter()
            idx = Indexer(hashing, params, corpus_dev, metric="cosine",
                          probe_budget=cap)
            jax.block_until_ready(idx.table.row_ids)
            times.append(time.perf_counter() - t0)
        lay_times = []
        for _ in range(2):
            idx._layout = None
            t0 = time.perf_counter()
            jax.block_until_ready(idx.layout.data)
            lay_times.append(time.perf_counter() - t0)
        log(f"build: {corpus.shape[0]} x {corpus.shape[1]} rows, "
            f"{hashing.n_buckets} buckets, max bucket "
            f"{int(idx.table.max_count())}, cap {cap}; table cold "
            f"{times[0]:.2f} s warm {times[1]:.3f} s; f32 layout cold "
            f"{lay_times[0]:.2f} s warm {lay_times[1]:.3f} s "
            f"({idx.layout.data.shape[0]} rows)")
        compiled = _fused_serve.lower(
            hashing, params, idx.layout, idx.table.counts,
            jnp.asarray(queries), jax.random.PRNGKey(1), k=K,
            hash_times=HASH_TIMES, probe_mode="flip", engine="grouped",
        ).compile()
        ma = compiled.memory_analysis()
        if ma is None:
            log("build: serve-step memory_analysis not reported")
        else:
            log("build: grouped serve step memory_analysis "
                f"temp {ma.temp_size_in_bytes / 2**30:.3f} GiB, "
                f"arguments {ma.argument_size_in_bytes / 2**30:.3f} GiB, "
                f"output {ma.output_size_in_bytes / 2**20:.3f} MiB, "
                f"code {ma.generated_code_size_in_bytes / 2**20:.2f} MiB")
        log(f"build: peak_bytes_in_use {peak_bytes()}")
    return idx, corpus_dev


# ---------------------------------------------------------------------------
# 5. serve: recall, parity against a float64 rerank, smoke timings
# ---------------------------------------------------------------------------

def candidate_rows(table, probe_ids, probe_valid, cap: int):
    """Per query: the corpus rows every engine scores — the first
    ``min(count, cap)`` rows of each valid probed bucket, in table
    order."""
    row_ids = np.asarray(table.row_ids)
    starts = np.asarray(table.starts)
    counts = np.asarray(table.counts)
    out = []
    for pid, pv in zip(np.asarray(probe_ids), np.asarray(probe_valid)):
        parts = [row_ids[starts[b]: starts[b] + min(counts[b], cap)]
                 for b in pid[pv]]
        out.append(np.concatenate(parts) if parts
                   else np.zeros((0,), np.int64))
    return out


def stored_rows(layout, corpus):
    """A function mapping corpus rows to the float64 vectors the engine
    scores: the layout's stored rows after dequantisation, or (no
    layout: the xla engine) the raw corpus rows."""
    if layout is None:
        return lambda rows: corpus[rows].astype(np.float64)
    row_map = np.asarray(layout.row_map)
    pos_of = np.empty(corpus.shape[0], np.int64)
    live = np.nonzero(row_map >= 0)[0]
    pos_of[row_map[live]] = live
    data = np.asarray(layout.data)[:, : corpus.shape[1]].astype(np.float64)
    if layout.scale is not None:
        scale = np.asarray(layout.scale, np.float64)
        data = data * (scale[:, None] if scale.ndim else scale)
    return lambda rows: data[pos_of[rows]]


def reference_scores(vecs, q, metric: str, from_layout: bool):
    """Float64 scores, higher = nearer, in the metric's exact order."""
    if metric == "cosine":
        qn = q / np.linalg.norm(q)
        if from_layout:  # layout rows are stored normalised
            return vecs @ qn
        return (vecs @ qn) / np.maximum(np.linalg.norm(vecs, axis=1),
                                        1e-12)
    return 2.0 * (vecs @ q) - np.einsum("nd,nd->n", vecs, vecs)


def check_parity(label, ids, cands, rows_fn, queries, metric: str,
                 from_layout: bool) -> int:
    """Top-k ids against the float64 rerank of the same candidates.
    Rule: equal id sets, or every differing id scores within
    ``PARITY_RTOL`` (relative) of the reference's k-th score.  Returns
    the number of queries whose sets differed only within the rule."""
    near_ties = 0
    for qi, (row, cand) in enumerate(zip(np.asarray(ids), cands)):
        got = set(int(i) for i in row if i >= 0)
        if not cand.size:
            if got:
                raise AssertionError(f"{label}: query {qi} has ids "
                                     "but no candidates")
            continue
        score = reference_scores(rows_fn(cand), queries[qi].astype(
            np.float64), metric, from_layout)
        kk = min(K, cand.size)
        order = np.argsort(-score, kind="stable")
        want = set(int(cand[j]) for j in order[:kk])
        if len(got) != kk:
            raise AssertionError(f"{label}: query {qi} returned "
                                 f"{len(got)} ids, expected {kk}")
        if got == want:
            continue
        by_row = dict(zip(cand.tolist(), score.tolist()))
        kth = score[order[kk - 1]]
        for rid in got ^ want:
            if rid not in by_row:
                raise AssertionError(f"{label}: query {qi} returned row "
                                     f"{rid}, not a candidate")
            if abs(by_row[rid] - kth) > PARITY_RTOL * max(abs(kth), 1e-12):
                raise AssertionError(
                    f"{label}: query {qi} ids {sorted(got)} vs reference "
                    f"{sorted(want)}; row {rid} scores {by_row[rid]!r}, "
                    f"k-th {kth!r}")
        near_ties += 1
    return near_ties


def engine_topk(engine, layout, table, corpus_dev, queries, pids, pvalid,
                cap: int, metric: str):
    """Top-k ids of one engine for explicit probe ids (the same probes
    the reference reranks)."""
    import jax.numpy as jnp

    from nlsh_jax.index.query import default_query_chunk, query_bucket_table
    from nlsh_jax.index.serving import (
        serving_query_grouped, serving_query_windowed,
    )

    qs = jnp.asarray(queries)
    if engine == "xla":
        ids, _, _ = query_bucket_table(
            table, corpus_dev, qs, pids, pvalid, k=K, probe_budget=cap,
            metric=metric,
            query_chunk=default_query_chunk(pids.shape[1], cap, qs.shape[1]))
    else:
        serve = {"grouped": serving_query_grouped,
                 "windowed": serving_query_windowed}[engine]
        ids, _, _ = serve(layout, qs, pids, pvalid, table.counts, k=K)
    return np.asarray(ids)


def timed(fn, reps: int = 3) -> float:
    import jax

    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def phase_serve(hashing, params, idx, corpus, corpus_dev, queries, cap: int,
                n_parity: int, mt_tables: int):
    import jax
    import jax.numpy as jnp

    from nlsh_jax.index import Indexer
    from nlsh_jax.ops.knn import knn
    from nlsh_jax.utils.metrics import calculate_recall

    with phase("serve"):
        qs = jnp.asarray(queries)
        qkey = jax.random.PRNGKey(1)
        t0 = time.perf_counter()
        _, gt = knn(qs, corpus_dev, k=K, metric="cosine", query_tile=1024,
                    corpus_chunk=131_072, precision="highest")
        gt = np.asarray(gt)
        log(f"serve: exact ground truth for {queries.shape[0]} queries "
            f"in {time.perf_counter() - t0:.1f} s (precision highest)")

        # parity probes: one explicit probe set shared by every engine
        # and the float64 reference
        q_par = queries[:n_parity]
        pids, pvalid = hashing.hash(params, jnp.asarray(q_par),
                                    n_probes=HASH_TIMES, key=qkey,
                                    probe_mode="flip")
        cands = candidate_rows(idx.table, pids, pvalid, cap)
        log(f"serve: parity set {n_parity} queries, mean "
            f"{np.mean([c.size for c in cands]):.0f} candidates")

        recall = {}
        for metric in ("cosine", "euclidean"):
            ix = idx if metric == "cosine" else Indexer(
                hashing, params, corpus_dev, metric="euclidean",
                table=idx.table, probe_budget=cap)
            for engine, dtype in ENGINE_LAYOUTS:
                ix.engine = engine
                ix.serving_dtype = jnp.dtype(dtype)
                label = f"{metric}/{engine}/{dtype}"
                line = f"serve {label}:"
                if metric == "cosine":
                    run = lambda: ix.query_async(  # noqa: E731
                        qs, k=K, hash_times=HASH_TIMES, key=qkey,
                        probe_mode="flip")
                    top, n_cand = ix.fetch(run())  # compile + warm
                    recall[(engine, dtype)] = float(
                        calculate_recall(gt, top, np.mean))
                    t = timed(run)
                    line += (f" recall@10 {recall[(engine, dtype)]:.4f},"
                             f" mean candidates {np.mean(n_cand):.0f},"
                             f" smoke timing {t * 1e3:.2f} ms per "
                             f"{queries.shape[0]} queries"
                             f" ({queries.shape[0] / t:.0f} q/s, not a "
                             "benchmark);")
                layout = None if engine == "xla" else ix.layout
                ids = engine_topk(engine, layout, ix.table, corpus_dev,
                                  q_par, pids, pvalid, cap, metric)
                ties = check_parity(label, ids, cands,
                                    stored_rows(layout, corpus), q_par,
                                    metric, layout is not None)
                log(f"{line} parity ok ({ties} of {n_parity} queries "
                    f"differ only within {PARITY_RTOL:g} of the k-th "
                    "score)")
        base = recall[("xla", "float32")]
        for (engine, dtype), r in recall.items():
            if dtype == "float32" and abs(r - base) > RECALL_ATOL:
                raise AssertionError(
                    f"{engine} f32 recall {r:.4f} vs xla {base:.4f}")
        idx.engine, idx.serving_dtype = "auto", jnp.float32
        phase_ensemble_timing(hashing, corpus_dev, qs, cap, mt_tables)


def phase_ensemble_timing(hashing, corpus_dev, qs, cap: int, n_tables: int):
    """xla against the layout engines on an L-table stack over the same
    corpus (random tables; the timing is what is compared)."""
    import jax

    from nlsh_jax.parallel import MultiTableIndexer
    from nlsh_jax.parallel.multitable import init_multi_table

    stacked = init_multi_table(hashing, n_tables, jax.random.PRNGKey(5))
    mt = MultiTableIndexer(hashing, stacked, corpus_dev, metric="cosine",
                           probe_budget=cap, engine="xla")
    tops = {}
    for engine in ("xla", "windowed", "grouped"):
        mt.engine = engine
        run = lambda: mt.query_async(qs, k=K, hash_times=1)  # noqa: E731
        tops[engine] = mt.fetch(run())[0]  # compile + warm
        t = timed(run)
        log(f"serve ensemble L={n_tables} {engine}: smoke timing "
            f"{t * 1e3:.2f} ms per {qs.shape[0]} queries "
            f"({qs.shape[0] / t:.0f} q/s, not a benchmark)")
    for engine in ("windowed", "grouped"):
        same = (np.sort(tops[engine], 1) == np.sort(tops["xla"], 1)).mean()
        if same < 0.99:
            raise AssertionError(
                f"ensemble {engine} agrees with xla on {same:.4f} of ids")


# ---------------------------------------------------------------------------
# 6. persistence and CLIs
# ---------------------------------------------------------------------------

def phase_persist(hashing, params, idx, corpus_dev, queries, workdir: str,
                  synth_steps: int = 4):
    import jax
    import jax.numpy as jnp

    from nlsh_jax.cli import serve as serve_cli
    from nlsh_jax.cli import train as train_cli
    from nlsh_jax.data import get_data_by_id
    from nlsh_jax.index import Indexer
    from nlsh_jax.utils.checkpoint import load_model, save_model

    with phase("persist"):
        base = os.path.join(workdir, "flagship")
        save_model(base, hashing, params)
        hashing2, params2 = load_model(base)
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(params2)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        qs = jnp.asarray(queries)
        key = jax.random.PRNGKey(3)
        idx.engine = "grouped"
        top1, cand1 = idx.query(qs, k=K, hash_times=HASH_TIMES, key=key,
                                probe_mode="flip")
        path = os.path.join(workdir, "index.npz")
        idx.save(path)
        idx2 = Indexer.load(path, hashing2, params2, corpus_dev)
        top2, cand2 = idx2.query(qs, k=K, hash_times=HASH_TIMES, key=key,
                                 probe_mode="flip")
        np.testing.assert_array_equal(top1, top2)
        np.testing.assert_array_equal(cand1, cand2)
        log(f"persist: model + index round trip, {queries.shape[0]} "
            "identical answers")

        os.environ["NLSH_SYNTH_CACHE_DIR"] = os.path.join(workdir, "synth")
        models = os.path.join(workdir, "models")
        with contextlib.redirect_stdout(io.StringIO()) as out:
            state = train_cli.main([
                "--data_id", "synthetic", "--learner_type", "triplet",
                "--debug", "--max_steps", str(synth_steps),
                "--test_every_updates", "2", "--model_save_dir", models])
        if int(state.step) != synth_steps:
            raise AssertionError(f"train CLI ran {int(state.step)} steps")
        log(f"persist: main.py --data_id synthetic --learner_type triplet "
            f"--debug ran {synth_steps} steps "
            f"({len(out.getvalue().splitlines())} lines of output)")

        data = get_data_by_id("synthetic").load()
        small = make_hashing(data.dim, (64, 64), 8)
        base2 = os.path.join(workdir, "synthetic")
        save_model(base2, small, small.init(jax.random.PRNGKey(0)))
        test = np.asarray(data.testing)
        requests = "".join(
            json.dumps({"id": i, "queries": test[i * 4:(i + 1) * 4].tolist()})
            + "\n" for i in range(3))
        stdin = sys.stdin
        try:
            sys.stdin = io.StringIO(requests)
            with contextlib.redirect_stdout(io.StringIO()) as out:
                stats = serve_cli.main([
                    "--model_path", base2, "--data_id", "synthetic",
                    "--loop", "-k", str(K), "--hash_times", "4"])
        finally:
            sys.stdin = stdin
        answers = [json.loads(l) for l in out.getvalue().splitlines()]
        replies = [a for a in answers if "id" in a]
        if [a.get("id") for a in replies] != [0, 1, 2] or any(
                "error" in a or len(a["topk_ids"]) != 4 for a in replies):
            raise AssertionError(f"serve --loop answered {answers}")
        log(f"persist: serve.py --loop answered 3 requests "
            f"(engine {stats['engine']}, p50 "
            f"{stats['latency_ms_p50']} ms, smoke timing)")


# ---------------------------------------------------------------------------
# 7. four GPUs
# ---------------------------------------------------------------------------

def devices_of(arr) -> set:
    return {s.device for s in arr.addressable_shards}


def sharded_codes(sh, n_buckets: int) -> np.ndarray:
    """Each corpus row's bucket, read back from a ShardedIndexer's
    per-shard CSR tables."""
    row_ids = np.asarray(sh.row_ids).reshape(-1, sh.n_local)
    starts, counts = np.asarray(sh.starts), np.asarray(sh.counts)
    codes = np.full(sh.n_padded, n_buckets, np.int64)
    for s, (rid, st, ct) in enumerate(zip(row_ids, starts, counts)):
        pos = np.arange(int(ct.sum()))
        bucket = np.searchsorted(st, pos, side="right") - 1
        codes[s * sh.n_local + rid[pos]] = bucket
    return codes[: sh.n_real]


def phase_four(corpus, queries, rng, dim: int, hidden, hash_size: int,
               n_sub: int, steps: int, batch_size: int, n_shard_queries: int,
               cap: int, workdir: str):
    """Four devices against one.  Runs at matmul precision highest: at
    the default, f32 matmuls may run in TF32, and the one-device and
    four-device programs (other shapes, other fusions) then hash a few
    near-threshold rows into other buckets, which is numerics, not a
    sharding fault."""
    import jax
    import jax.numpy as jnp

    from nlsh_jax.index import Indexer
    from nlsh_jax.index.bucket_table import build_bucket_table
    from nlsh_jax.index.indexer import hash_corpus
    from nlsh_jax.parallel import MultiTableIndexer, ShardedIndexer, make_mesh
    from nlsh_jax.parallel.multitable import init_multi_table

    with phase("four"), jax.default_matmul_precision("highest"):
        hashing = make_hashing(dim, hidden, hash_size)
        data = train_data(corpus, rng, n_sub)
        # the bucket-balance term is a batch statistic, computed per
        # device under data parallelism: compare without it
        p1, l1 = fit(hashing, data, steps, batch_size, workdir,
                     balance_lambda=0.0)
        mesh = make_mesh(4, axis="data")
        if len(set(mesh.devices.flat)) != 4:
            raise AssertionError(f"data mesh devices {mesh.devices}")
        p4, l4 = fit(hashing, data, steps, batch_size, workdir, mesh=mesh,
                     balance_lambda=0.0)
        rel = np.abs(l4 - l1) / np.abs(l1)
        if not (np.isfinite(l4).all() and rel.max() <= DP_RTOL):
            raise AssertionError(f"data-parallel losses {l4} vs {l1}")
        log(f"four: data-parallel fit on {mesh.devices.size} devices, "
            f"global batch {batch_size}, {steps} steps: loss rel diff "
            f"step 0 {rel[0]:.2e}, max {rel.max():.2e} (<= {DP_RTOL:g})")

        # corpus-sharded index vs one device, exact budget (no
        # truncation: sharding splits buckets, so a cap would truncate
        # differently)
        params = p1
        qs = jnp.asarray(queries[:n_shard_queries])
        key = jax.random.PRNGKey(1)
        smesh = make_mesh(4, axis="shard")
        sh = ShardedIndexer(hashing, params, corpus, smesh, metric="cosine")
        if len(devices_of(sh.corpus)) != 4:
            raise AssertionError(f"sharded corpus on {devices_of(sh.corpus)}")
        codes4 = sharded_codes(sh, hashing.n_buckets)
        codes1 = np.asarray(hash_corpus(hashing, params, jnp.asarray(corpus)))
        moved = int(np.sum(codes4 != codes1))
        if moved > corpus.shape[0] // 100_000:
            raise AssertionError(f"sharded hash moved {moved} rows")
        # the one-device index over the sharded build's own codes, so
        # the comparison isolates sharded serving and the merge
        one = Indexer(hashing, params, jnp.asarray(corpus), metric="cosine",
                      table=build_bucket_table(jnp.asarray(codes4, jnp.int32),
                                               hashing.n_buckets))
        t1, c1 = one.query(qs, k=K, hash_times=HASH_TIMES, key=key,
                           probe_mode="flip")
        t4, c4 = sh.query(qs, k=K, hash_times=HASH_TIMES, key=key,
                          probe_mode="flip")
        np.testing.assert_array_equal(c1, c4)
        ties = check_ids_up_to_ties("sharded", t1, t4, corpus, queries)
        log(f"four: corpus-sharded {sh.engine} index on 4 devices "
            f"(budget {one.probe_budget}/{sh.probe_budget}; {moved} of "
            f"{corpus.shape[0]} rows hashed to another bucket than on one "
            f"device) matches one device on {qs.shape[0]} queries ({ties} "
            "differ only by exact ties)")

        # table-sharded ensemble vs the same stack unsharded
        stacked = init_multi_table(hashing, 4, jax.random.PRNGKey(2))
        m1 = MultiTableIndexer(hashing, stacked, jnp.asarray(corpus),
                               metric="cosine", probe_budget=cap)
        tmesh = make_mesh(4, axis="table")
        m4 = MultiTableIndexer(hashing, stacked, jnp.asarray(corpus),
                               metric="cosine", probe_budget=cap, mesh=tmesh)
        if len(devices_of(m4.row_ids)) != 4:
            raise AssertionError(f"tables on {devices_of(m4.row_ids)}")
        e1, n1 = m1.query(qs, k=K)
        e4, n4 = m4.query(qs, k=K)
        np.testing.assert_array_equal(n1, n4)
        ties = check_ids_up_to_ties("table-sharded", e1, e4, corpus, queries)
        log(f"four: table-sharded {m4.engine} ensemble L=4 on 4 devices "
            f"matches the unsharded stack on {qs.shape[0]} queries "
            f"({ties} differ only by exact ties)")


def check_ids_up_to_ties(label, a_top, b_top, corpus, queries) -> int:
    """Equal id sets per query, except where the differing ids' float64
    cosine scores are within PARITY_RTOL of each other's k-th score."""
    ties = 0
    for qi, (a, b) in enumerate(zip(np.asarray(a_top), np.asarray(b_top))):
        sa, sb = set(a[a >= 0].tolist()), set(b[b >= 0].tolist())
        if sa == sb:
            continue
        q = queries[qi].astype(np.float64)
        q /= np.linalg.norm(q)

        def cos(rows):
            v = corpus[sorted(rows)].astype(np.float64)
            return np.sort(v @ q / np.linalg.norm(v, axis=1))

        ka, kb = cos(sa), cos(sb)
        if ka.size != kb.size or not np.allclose(
                ka, kb, rtol=PARITY_RTOL, atol=0):
            raise AssertionError(f"{label}: query {qi} ids {sorted(sa)} vs "
                                 f"{sorted(sb)} (scores {ka} vs {kb})")
        ties += 1
    return ties


# ---------------------------------------------------------------------------

def run(n_corpus: int, n_queries: int, dim: int, hidden, hash_size: int,
        n_sub: int, steps: int, batch_size: int, n_parity: int,
        mt_tables: int, canary_rows: int | None, four: bool,
        n_shard_queries: int) -> dict:
    """All phases at the given sizes (the tests call this at tiny ones
    on the CPU, past :func:`phase_device`)."""
    from nlsh_jax.ops.pallas.query_kernel import round_cap

    rng, corpus, queries = workload(n_corpus, n_queries, dim)
    # every engine scores the same rows: the layouts round their cap up
    # to whole blocks, so the xla budget gets the rounded value too
    cap = round_cap(serving_cap(n_corpus, 2 ** hash_size))
    with tempfile.TemporaryDirectory() as workdir:
        if four:
            phase_four(corpus, queries, rng, dim, hidden, hash_size, n_sub,
                       steps, batch_size, n_shard_queries, cap, workdir)
            return {"cap": cap}
        phase_gather(canary_rows)
        hashing, params = phase_train(corpus, rng, dim, hidden, hash_size,
                                      n_sub, steps, batch_size, workdir)
        idx, corpus_dev = phase_build(hashing, params, corpus, queries, cap)
        phase_serve(hashing, params, idx, corpus, corpus_dev, queries, cap,
                    n_parity, mt_tables)
        phase_persist(hashing, params, idx, corpus_dev,
                      queries[:n_parity], workdir)
    return {"cap": cap}


def main(argv=None) -> int:
    import bench
    from nlsh_jax.utils.env import setup_compile_cache

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-GPU paths and their one-card "
                        "comparisons")
    args = p.parse_args(argv)
    setup_compile_cache()
    device = phase_device(4 if args.four else 1)
    run(n_corpus=bench.N_CORPUS, n_queries=bench.N_QUERIES, dim=bench.DIM,
        hidden=bench.TRAIN_CFG["hidden"], hash_size=bench.HASH_SIZE,
        n_sub=bench.TRAIN_SUBSET, steps=TRAIN_STEPS,
        batch_size=bench.TRAIN_CFG["batch_size"], n_parity=1000,
        mt_tables=8, canary_rows=None, four=args.four, n_shard_queries=2000)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
