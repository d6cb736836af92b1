"""Triplet trainer (reference ``nlsh/trainers/triplet.py``).

Batches are (anchor, positive, negative) where the positive is a random
column of the anchor's precomputed GT kNN and the negative is sampled
by one of:

* ``random`` — uniform corpus row (reference ``triplet.py:109``),
* ``nearest`` — the corpus row whose *code* is closest to the anchor's,
  excluding the anchor itself and its positives (reference
  ``nearest_exclude_positive``, ``triplet.py:44-74``).  The reference
  walks the corpus in Python batches of 32 with scatter-masking; here
  mining is one jitted ``lax.map`` over anchor chunks doing a masked
  argmin against the full encoded corpus.

``hard`` / ``semi-hard`` are named but unimplemented in the reference
(``triplet.py:12-13``); implemented here for completeness:

* ``hard`` — within-batch: nearest in-code negative among batch anchors
  whose row id is not in the anchor's positive set,
* ``semi-hard`` — within-batch: nearest such negative with
  ``d(a, n) > d(a, p)`` (falls back to hard when none qualifies).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from nlsh_jax.train.base import Trainer

Array = jnp.ndarray

NSM_RANDOM = "random"
NSM_NEAREST = "nearest"
NSM_HARD = "hard"
NSM_SEMI_HARD = "semi-hard"


def triplet_loss(anchor, pos, neg, distance_rowwise, margin: float = 0.1) -> Array:
    """Margin hinge over code distances (reference ``triplet_loss``,
    ``triplet.py:16-26``)."""
    d_pos = distance_rowwise(anchor, pos)
    d_neg = distance_rowwise(anchor, neg)
    return jnp.mean(jnp.clip(d_pos - d_neg + margin, min=0))


@partial(jax.jit, static_argnames=("hashing", "k", "chunk"))
def nearest_exclude_positive(
    hashing, params, corpus: Array, positive_idx: Array, k: int, chunk: int = 256
) -> Array:
    """Mine, per corpus row, the id of the nearest-in-code-space row that
    is neither itself nor one of its top-``k`` positives (reference
    ``nearest_exclude_positive``, ``triplet.py:44-74``).

    Returns ``(n,)`` int32 negative ids.
    """
    n, d = corpus.shape
    codes = hashing.predict(params, corpus)  # (n, bits); fits device memory easily
    pairwise = hashing.code_distance.pairwise

    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    codes_p = jnp.pad(codes, ((0, pad), (0, 0)))
    pos_p = jnp.pad(positive_idx[:, :k], ((0, pad), (0, 0)))
    base = jnp.arange(n_chunks, dtype=jnp.int32) * chunk

    def mine(args):
        c, pos, start = args  # (chunk, bits), (chunk, k), scalar
        dist = pairwise(c, codes)  # (chunk, n)
        rows = start + jnp.arange(chunk, dtype=jnp.int32)
        col = jnp.arange(n, dtype=jnp.int32)
        is_self = col[None, :] == rows[:, None]
        is_pos = jnp.any(col[None, None, :] == pos[:, :, None], axis=1)
        dist = jnp.where(is_self | is_pos, jnp.inf, dist)
        return jnp.argmin(dist, axis=1).astype(jnp.int32)

    neg = jax.lax.map(
        mine,
        (codes_p.reshape(n_chunks, chunk, -1),
         pos_p.reshape(n_chunks, chunk, k),
         base),
    )
    return neg.reshape(-1)[:n]


class TripletTrainer(Trainer):
    """Reference ``TripletTrainer`` (triplet.py:134-182).

    ``lambda1`` is accepted-but-unused in the reference loss
    (``triplet.py:171-182``) — kept in the signature for CLI parity,
    documented as inert.
    """

    def __init__(
        self,
        hashing,
        data,
        model_save_dir="/tmp",
        logger=None,
        lambda1: float = 0.001,
        margin: float = 0.1,
        positive_k: int | None = None,
        negative_sampling_method: str = NSM_RANDOM,
        balance_lambda: float = 0.0,
    ):
        super().__init__(hashing, data, model_save_dir, logger)
        self.lambda1 = lambda1  # inert, reference parity
        self.margin = margin
        self.positive_k = positive_k
        # bucket-balance regulariser weight (no reference counterpart;
        # skewed buckets bound serving throughput)
        self.balance_lambda = balance_lambda
        if negative_sampling_method not in (
            NSM_RANDOM, NSM_NEAREST, NSM_HARD, NSM_SEMI_HARD,
        ):
            raise ValueError(negative_sampling_method)
        self.negative_sampling_method = negative_sampling_method

    def _k(self, knn_cols: int) -> int:
        return self.positive_k or knn_cols

    def epoch_arrays(self, key, params):
        n = self.data.training.shape[0]
        k = self._k(self.data.training_self_knn.shape[1])
        pk, ck, nk = jax.random.split(key, 3)
        arrays = {
            "anchor": jax.random.permutation(pk, n).astype(jnp.int32),
            "col": jax.random.randint(ck, (n,), 0, k, dtype=jnp.int32),
        }
        if self.negative_sampling_method == NSM_RANDOM:
            arrays["neg"] = jax.random.randint(nk, (n,), 0, n, dtype=jnp.int32)
        elif self.negative_sampling_method == NSM_NEAREST:
            knn = jnp.asarray(self.data.training_self_knn, dtype=jnp.int32)
            arrays["neg"] = nearest_exclude_positive(
                self.hashing, params["hashing"], jnp.asarray(self.data.training),
                knn, k=min(k, knn.shape[1]),
            )
        # hard / semi-hard mine within the batch inside loss_fn
        return arrays

    def loss_fn(self, hashing_params, extra, corpus, knn, batch, key):
        anchor_idx = batch["anchor"]
        pos_idx = knn[anchor_idx, batch["col"]]
        a = self.hashing.predict(hashing_params, corpus[anchor_idx])
        p = self.hashing.predict(hashing_params, corpus[pos_idx])
        dist = self.hashing.code_distance

        balance = 0.0
        if self.balance_lambda > 0:
            from nlsh_jax.ops.code_distances import (
                band_balance_loss, bucket_balance_loss,
            )

            if hasattr(self.hashing, "_band_probs"):
                # PQ heads: the bucket histogram factorises over bands
                balance = self.balance_lambda * band_balance_loss(
                    self.hashing._band_probs(hashing_params,
                                             corpus[anchor_idx])
                )
            else:
                balance = self.balance_lambda * bucket_balance_loss(
                    self.hashing.probs(hashing_params, corpus[anchor_idx])
                )

        if self.negative_sampling_method in (NSM_RANDOM, NSM_NEAREST):
            n_code = self.hashing.predict(hashing_params, corpus[batch["neg"]])
            return triplet_loss(a, p, n_code, dist.rowwise, self.margin) + balance

        # Batch-mined negatives (hard / semi-hard).
        k = self._k(knn.shape[1])
        pairwise_d = dist.pairwise(a, jax.lax.stop_gradient(a))  # (b, b)
        bs = anchor_idx.shape[0]
        # candidate j is invalid for anchor i if j == i or row_j in pos(i)
        cand_rows = anchor_idx  # (b,)
        is_self = jnp.eye(bs, dtype=bool)
        pos_rows = knn[anchor_idx, :k]  # (b, k)
        is_pos = jnp.any(
            cand_rows[None, None, :] == pos_rows[:, :, None], axis=1
        )  # (b, b)
        invalid = is_self | is_pos
        d_pos = dist.rowwise(a, p)  # (b,)
        if self.negative_sampling_method == NSM_SEMI_HARD:
            semi_invalid = invalid | (pairwise_d <= d_pos[:, None])
            has_semi = jnp.any(~semi_invalid, axis=1)
            masked = jnp.where(semi_invalid, jnp.inf, pairwise_d)
            masked_hard = jnp.where(invalid, jnp.inf, pairwise_d)
            neg_j = jnp.where(
                has_semi, jnp.argmin(masked, axis=1), jnp.argmin(masked_hard, axis=1)
            )
        else:
            neg_j = jnp.argmin(jnp.where(invalid, jnp.inf, pairwise_d), axis=1)
        n_code = a[neg_j]
        d_neg = dist.rowwise(a, n_code)
        return jnp.mean(jnp.clip(d_pos - d_neg + self.margin, min=0)) + balance
