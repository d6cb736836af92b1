"""Jointly-trained multi-table ensembles (BASELINE config 4).

No reference counterpart (the reference trains one hashing).  Wraps any
extra-model-free learner (triplet / siamese / proposed): ``n_tables``
hashings share one architecture, their params stacked on a leading
table axis; every optimisation step runs all tables' losses in ONE
jitted computation (``vmap`` over the table axis, summed loss), with
each table drawing independent batch compositions so the ensemble
decorrelates.  Evaluation builds a
:class:`nlsh_jax.parallel.MultiTableIndexer` and logs the same metric
channels as single-table training.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from nlsh_jax.train.base import Trainer
from nlsh_jax.utils import checkpoint as ckpt
from nlsh_jax.utils.metrics import calculate_recall


class MultiTableTrainer(Trainer):
    """Train ``n_tables`` hashings jointly from a single-table learner.

    Args:
      inner: a constructed trainer (e.g. ``TripletTrainer``) whose
        ``loss_fn``/``epoch_arrays`` define the per-table objective;
        must not use extra models.
      n_tables: ensemble size L.
    """

    def __init__(self, inner: Trainer, n_tables: int):
        super().__init__(inner.hashing, inner.data, inner.model_save_dir,
                         inner.logger)
        if type(inner).init_extra is not Trainer.init_extra:
            raise ValueError(
                "MultiTableTrainer supports extra-model-free learners only "
                f"(got {type(inner).__name__})"
            )
        self.inner = inner
        self.n_tables = n_tables

    def init_hashing_params(self, key):
        from nlsh_jax.parallel.multitable import init_multi_table

        return init_multi_table(self.hashing, self.n_tables, key)

    def epoch_arrays(self, key, params):
        """Independent per-table epoch compositions, stacked on axis 1 so
        the base runner's per-step row slicing (axis 0) still applies."""
        per_table = []
        for t in range(self.n_tables):
            tp = {
                "hashing": jax.tree.map(lambda x: x[t], params["hashing"]),
                "extra": params["extra"],
            }
            per_table.append(
                self.inner.epoch_arrays(jax.random.fold_in(key, t), tp)
            )
        return {
            name: jnp.stack([a[name] for a in per_table], axis=1)
            for name in per_table[0]
        }

    def loss_fn(self, hashing_params, extra, corpus, knn, batch, key):
        inner_loss = self.inner.loss_fn
        keys = jax.random.split(key, self.n_tables)

        def per_table(params_t, batch_t, key_t):
            return inner_loss(params_t, extra, corpus, knn, batch_t, key_t)

        batch_by_table = {
            name: jnp.moveaxis(arr, 1, 0) for name, arr in batch.items()
        }  # (bs, L, ...) -> (L, bs, ...)
        losses = jax.vmap(per_table)(hashing_params, batch_by_table, keys)
        return jnp.sum(losses)

    # -- ensemble evaluation + checkpointing --------------------------------
    def _evaluate(self, params, corpus, val_gpu, ground_truth, probe_train,
                  probe_gt, K, hash_times, step, eval_key,
                  probe_mode: str = "sample"):
        from nlsh_jax.parallel.multitable import MultiTableIndexer

        indexer = MultiTableIndexer(
            self.hashing, params["hashing"], corpus, metric=self.data.metric
        )
        self.logger.log("test/n_indexes", int(jnp.sum(indexer.counts > 0)), step)
        self.logger.log(
            "test/std_index_rows",
            float(jnp.std(jnp.where(indexer.counts > 0, indexer.counts, 0))),
            step,
        )
        t1 = time.perf_counter()
        topk, _ = indexer.query(val_gpu, k=K, hash_times=1, key=eval_key)
        t2 = time.perf_counter()
        recall = calculate_recall(ground_truth, topk, np.mean)
        # logged query_size is the EXACT distinct-candidate count, so
        # the metric does not depend on which serving engine answered
        # (Pallas paths return an occupancy upper bound inline)
        query_size = float(np.mean(indexer.exact_query_size(
            val_gpu, hash_times=1, key=eval_key
        )))
        self.logger.log("test/recall", recall, step)
        self.logger.log("test/query_size", query_size, step)
        self.logger.log("test/qps", val_gpu.shape[0] / (t2 - t1), step)

        topk_t, _ = indexer.query(probe_train, k=K, hash_times=1,
                                  key=eval_key)
        self.logger.log(
            "training/recall", calculate_recall(probe_gt, topk_t, np.mean), step
        )
        self.logger.log(
            "training/query_size",
            float(np.mean(indexer.exact_query_size(
                probe_train, hash_times=1, key=eval_key
            ))),
            step,
        )
        return recall, query_size

    def save_checkpoint(self, state, recall):
        base = (
            f"{self.model_save_dir}/{self.logger.run_name}"
            f"_{int(state.step)}_{recall:.4f}_L{self.n_tables}"
        )
        ckpt.save_model(base, self.hashing, state.params["hashing"],
                        n_tables=self.n_tables)
        ckpt.save_train_state(base + ckpt.STATE_SUFFIX, state)
