"""Siamese / contrastive trainer (reference ``nlsh/trainers/siamese.py``).

Per epoch each anchor is labelled positive with probability
``positive_rate``; positives are a random column of the anchor's GT
kNN, negatives are uniform corpus rows, blended by label arithmetic
(reference ``KNearestNeighborSiamese.batch_generator``,
``siamese.py:42-67``).  ``locally`` mode implements the reference's
unused ``KNearestNeighborLocallySiamese`` variant (negatives drawn
from the kNN ring ``inner_k..outer_k``, ``siamese.py:70-117``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nlsh_jax.train.base import Trainer

Array = jnp.ndarray


def contrastive_loss(
    anchor: Array,
    other: Array,
    label: Array,
    distance_rowwise,
    negative_margin: float = 0.1,
    positive_margin: float = 0.0,
) -> Array:
    """Reference ``contrastive_loss`` (siamese.py:9-20)."""
    d = distance_rowwise(anchor, other)
    positive_loss = label * jnp.clip(d - positive_margin, min=0) ** 2
    negative_loss = (1.0 - label) * jnp.clip(d - negative_margin, max=0) ** 2
    return jnp.mean(positive_loss + negative_loss) / 2.0


class SiameseTrainer(Trainer):
    """Reference ``SiameseTrainer`` (siamese.py:120-167).  The reference
    hardcodes k=100 for the positive pool (``siamese.py:150``); here
    ``positive_k`` defaults to the GT width but is configurable."""

    def __init__(
        self,
        hashing,
        data,
        model_save_dir="/tmp",
        logger=None,
        lambda1: float = 0.001,
        positive_margin: float = 0.0,
        negative_margin: float = 0.1,
        positive_rate: float = 0.1,
        positive_k: int | None = None,
        locally: bool = False,
        inner_k: int | None = None,
        outer_k: int | None = None,
    ):
        super().__init__(hashing, data, model_save_dir, logger)
        self.lambda1 = lambda1  # inert, reference parity
        self.positive_margin = positive_margin
        self.negative_margin = negative_margin
        self.positive_rate = positive_rate
        self.positive_k = positive_k
        self.locally = locally
        self.inner_k = inner_k
        self.outer_k = outer_k

    def epoch_arrays(self, key, params):
        n = self.data.training.shape[0]
        knn_cols = self.data.training_self_knn.shape[1]
        pk, lk, ck, nk = jax.random.split(key, 4)
        arrays = {
            "anchor": jax.random.permutation(pk, n).astype(jnp.int32),
            "label": jax.random.bernoulli(lk, self.positive_rate, (n,)).astype(
                jnp.float32
            ),
        }
        if self.locally:
            inner = self.inner_k or knn_cols // 2
            outer = self.outer_k or knn_cols
            if outer <= inner:
                raise ValueError(
                    f"Outer K (got {outer}) should be larger than inner K (got {inner})."
                )
            arrays["pos_col"] = jax.random.randint(ck, (n,), 0, inner, dtype=jnp.int32)
            arrays["neg_col"] = jax.random.randint(
                nk, (n,), inner, outer, dtype=jnp.int32
            )
        else:
            k = self.positive_k or knn_cols
            arrays["pos_col"] = jax.random.randint(ck, (n,), 0, k, dtype=jnp.int32)
            arrays["neg"] = jax.random.randint(nk, (n,), 0, n, dtype=jnp.int32)
        return arrays

    def loss_fn(self, hashing_params, extra, corpus, knn, batch, key):
        anchor_idx = batch["anchor"]
        pos_idx = knn[anchor_idx, batch["pos_col"]]
        if self.locally:
            neg_idx = knn[anchor_idx, batch["neg_col"]]
        else:
            neg_idx = batch["neg"]
        label = batch["label"]
        other_idx = jnp.where(label > 0.5, pos_idx, neg_idx)

        a = self.hashing.predict(hashing_params, corpus[anchor_idx])
        o = self.hashing.predict(hashing_params, corpus[other_idx])
        return contrastive_loss(
            a,
            o,
            label,
            self.hashing.code_distance.rowwise,
            negative_margin=self.negative_margin,
            positive_margin=self.positive_margin,
        )
