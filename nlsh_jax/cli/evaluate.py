"""Offline evaluation CLI — the multi-probe sweep.

Re-design of reference ``eval.py``: load a saved model artifact, hash
the corpus, build the index once, then sweep the number of probes
``n = 1..100`` and report ``(avg_n_candidates, recall)`` per probe
count (reference ``eval.py:148,196``).

The reference re-samples codes and walks a per-query Python dict loop
for every sweep value on CPU (``eval.py:156-188``); here one batch of
100 sampled probe codes is drawn once, and each sweep value ``n``
masks probes ``>= n`` down to the hard code before the shared jitted
dedupe + query pipeline — so the whole sweep is 100 calls into a
single compiled kernel.  (Probe samples are iid Bernoulli draws, so
prefixes of one sample batch are distributionally identical to the
reference's fresh draws.)
"""

from __future__ import annotations

import argparse
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from nlsh_jax.data import get_data_by_id
from nlsh_jax.index.bucket_table import build_bucket_table
from nlsh_jax.index.indexer import (
    LAYOUT_METRICS, SERVING_ENGINES, hash_corpus, resolve_engine,
)
from nlsh_jax.index.query import default_query_chunk, query_bucket_table
from nlsh_jax.ops import packing
from nlsh_jax.utils.checkpoint import load_model, model_base
from nlsh_jax.utils.env import get_env
from nlsh_jax.utils.metrics import calculate_recall


def nlsh_eval_argparse() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--data_id", type=str, required=True)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--max_probes", type=int, default=100)
    p.add_argument("--engine", default="auto",
                   choices=("auto",) + SERVING_ENGINES)
    p.add_argument("--probe_mode", default="sample",
                   choices=("sample", "flip"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json_out", type=str, default=None,
                   help="also write the sweep as JSON lines")
    return p


def sample_probe_codes(hashing, params, queries, max_probes: int, key,
                       probe_mode: str = "sample"):
    """Draw the full probe-code batch once: ``(nq, max_probes)`` packed
    int32, probe 0 the deterministic hard code (reference
    ``sample_and_collect``, eval.py:65-83).

    ``probe_mode="flip"`` enumerates least-confident-bit flips instead
    (deterministic best-first; probes are nested prefixes by
    construction, so the sweep's prefix masking applies unchanged).
    """
    if probe_mode == "flip":
        import numpy as _np

        p = hashing.probs(params, queries)
        bits = hashing.hash_size
        n_flip = min(max(int(_np.ceil(_np.log2(max_probes))), 1), bits)
        base = packing.pack_bits((p > 0.5).astype(jnp.int32))
        conf = jnp.abs(p - 0.5)
        _, flip_pos = jax.lax.top_k(-conf, n_flip)
        weights = (1 << (bits - 1 - flip_pos)).astype(jnp.int32)
        masks = jnp.arange(max_probes, dtype=jnp.int32)
        take = ((masks[None, :, None] >> jnp.arange(n_flip)) & 1).astype(
            jnp.int32
        )
        xor = jnp.sum(take * weights[:, None, :], axis=-1)
        return jnp.bitwise_xor(base[:, None], xor)
    p = hashing.probs(params, queries)
    hard = (p > 0.5).astype(jnp.int32)[:, None, :]
    sampled = jax.random.bernoulli(
        key, p[:, None, :], (queries.shape[0], max_probes - 1, p.shape[-1])
    ).astype(jnp.int32)
    return packing.pack_bits(jnp.concatenate([hard, sampled], axis=1))


@partial(jax.jit, static_argnames=("k", "probe_budget", "metric", "query_chunk"))
def _sweep_step(table, corpus, queries, raw_codes, n, k, probe_budget, metric,
                query_chunk):
    """One sweep value: mask probes >= n down to the hard code (probe 0),
    dedupe, query.  ``n`` is a traced scalar so all 100 sweep values
    share one compilation."""
    n_probes = raw_codes.shape[1]
    live = jnp.arange(n_probes)[None, :] < n
    ids = jnp.where(live, raw_codes, raw_codes[:, :1])
    probe_ids, probe_valid = packing.dedupe_codes(ids)
    topk_ids, _, n_cand = query_bucket_table(
        table, corpus, queries, probe_ids, probe_valid,
        k=k, probe_budget=probe_budget, metric=metric, query_chunk=query_chunk,
    )
    return topk_ids, n_cand


def run_sweep(hashing, params, corpus, queries, ground_truth, k,
              max_probes=100, metric="cosine", seed=0, probe_budget=None,
              engine="auto", probe_mode="sample", serving_dtype=None):
    """Returns a list of dicts {n_probes, avg_n_candidates, recall}."""
    codes = hash_corpus(hashing, params, corpus)
    table = build_bucket_table(codes, hashing.n_buckets)
    if probe_budget is None:
        probe_budget = max(int(table.max_count()), 1)
    raw = sample_probe_codes(
        hashing, params, queries, max_probes, jax.random.PRNGKey(seed),
        probe_mode=probe_mode,
    )

    engine = resolve_engine(engine)
    if engine != "xla" and metric in LAYOUT_METRICS:
        from nlsh_jax.index.serving import (
            serving_query_grouped, serving_query_windowed,
        )
        from nlsh_jax.ops.pallas.query_kernel import (
            BLOCK_ROWS, serving_layout, serving_layout_host,
        )

        build = (serving_layout_host
                 if corpus.shape[0] >= 2_000_000 else serving_layout)
        windowed = engine == "windowed"
        layout = build(table, corpus, metric=metric, cap=probe_budget,
                       dtype=serving_dtype or jnp.float32,
                       align=8 if windowed else BLOCK_ROWS)
        serve = serving_query_windowed if windowed else serving_query_grouped

        def step(n):
            live = jnp.arange(max_probes)[None, :] < n
            ids = jnp.where(live, raw, raw[:, :1])
            probe_ids, probe_valid = packing.dedupe_codes(ids)
            topk, _, n_cand = serve(
                layout, queries, probe_ids, probe_valid, table.counts, k=k
            )
            return topk, n_cand
    else:
        chunk = default_query_chunk(max_probes, probe_budget, queries.shape[1])

        def step(n):
            return _sweep_step(
                table, corpus, queries, raw, n, k=k,
                probe_budget=probe_budget, metric=metric, query_chunk=chunk,
            )

    results = []
    for n in range(1, max_probes + 1):
        topk, n_cand = step(jnp.asarray(n))
        recall = calculate_recall(ground_truth[:, :k], np.asarray(topk), np.mean)
        results.append({
            "n_probes": n,
            "avg_n_candidates": float(np.mean(np.asarray(n_cand))),
            "recall": float(recall),
        })
    return results


def run_sweep_multitable(hashing, stacked_params, corpus, queries,
                         ground_truth, k, n_tables, max_probes=100,
                         metric="cosine", seed=0, engine="auto",
                         probe_mode="sample", serving_dtype=None):
    """Ensemble sweep: per-table probe count ``ht = 1..max_probes/L``
    (each step adds L buckets to the union, so the candidate axis grows
    at the same rate as the single-table sweep's).  No reference
    counterpart (the reference trains exactly one hashing);
    ``avg_n_candidates`` is the exact distinct union size
    (`MultiTableIndexer.exact_query_size`), engine-independent."""
    from nlsh_jax.parallel import MultiTableIndexer

    idx = MultiTableIndexer(hashing, stacked_params, corpus, metric=metric,
                            engine=engine, serving_dtype=serving_dtype)
    key = jax.random.PRNGKey(seed)
    results = []
    for ht in range(1, max(max_probes // n_tables, 1) + 1):
        topk, _ = idx.query(queries, k=k, hash_times=ht, key=key,
                            probe_mode=probe_mode)
        n_cand = idx.exact_query_size(queries, hash_times=ht, key=key,
                                      probe_mode=probe_mode)
        recall = calculate_recall(ground_truth[:, :k], np.asarray(topk),
                                  np.mean)
        results.append({
            "n_probes": ht * n_tables,
            "hash_times": ht,
            "avg_n_candidates": float(np.mean(n_cand)),
            "recall": float(recall),
        })
    return results


def main(argv: list[str] | None = None):
    args = nlsh_eval_argparse().parse_args(argv)
    model_path = args.model_path
    import os

    if not (os.path.exists(model_path) or os.path.exists(model_path + ".json")):
        model_path = os.path.join(
            get_env("NLSH_MODEL_SAVE_DIR", "/tmp/nlsh_models"), model_path
        )

    hashing, params = load_model(model_path)
    data = get_data_by_id(args.data_id).load()

    with open(model_base(model_path) + ".json") as f:
        n_tables = json.load(f).get("n_tables")

    if n_tables and n_tables > 1:
        results = run_sweep_multitable(
            hashing, params,
            jnp.asarray(data.training), jnp.asarray(data.testing),
            np.asarray(data.ground_truth), args.k, n_tables,
            max_probes=args.max_probes, metric=data.metric, seed=args.seed,
            engine=args.engine, probe_mode=args.probe_mode,
        )
    else:
        results = run_sweep(
            hashing, params,
            jnp.asarray(data.training), jnp.asarray(data.testing),
            np.asarray(data.ground_truth), args.k,
            max_probes=args.max_probes, metric=data.metric, seed=args.seed,
            engine=args.engine, probe_mode=args.probe_mode,
        )
    for r in results:
        print(r["avg_n_candidates"], r["recall"])
    if args.json_out:
        with open(args.json_out, "w") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    return results


if __name__ == "__main__":
    main()
