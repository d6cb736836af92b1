"""The "proposed" trainer — the reference repo's own method
(``nlsh/trainers/proposed.py``).

Loss = sum of code distances from each anchor to *all* of its top-k GT
neighbours, plus ``lambda1`` times a query-size regulariser: sample a
pool of corpus rows, and for every sampled row whose hard bucket is not
probed by any anchor in the batch, penalise its least-confident bit
(``min_bits |p - 0.5|``) — pushing non-neighbours toward confident,
far-away codes (reference ``proposed.py:85-121``).

The reference computes bucket membership by round-tripping through the
Cython packer and Python sets/`np.isin` on the host per step
(``proposed.py:101-117``); here the whole term is a dense on-device
comparison of packed int codes, so it stays inside the jitted scan.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nlsh_jax.train.base import Trainer

Array = jnp.ndarray


class ProposedTrainer(Trainer):
    """Reference ``ProposedTrainer`` (proposed.py:56-121)."""

    def __init__(
        self,
        hashing,
        data,
        model_save_dir="/tmp",
        logger=None,
        train_k: int = 10,
        lambda1: float = 0.001,
        n_reg_samples: int = 65536,
    ):
        super().__init__(hashing, data, model_save_dir, logger)
        self.train_k = train_k
        self.lambda1 = lambda1
        # reference hardcodes 65536 sampled candidates per step
        # (proposed.py:96); configurable here for small corpora/tests
        self.n_reg_samples = n_reg_samples

    def epoch_arrays(self, key, params):
        n = self.data.training.shape[0]
        return {"anchor": jax.random.permutation(key, n).astype(jnp.int32)}

    def loss_fn(self, hashing_params, extra, corpus, knn, batch, key):
        anchor_idx = batch["anchor"]
        k = min(self.train_k, knn.shape[1])
        pos_idx = knn[anchor_idx, :k]  # (bs, k)

        hashed_anchor = self.hashing.predict(hashing_params, corpus[anchor_idx])
        bs = anchor_idx.shape[0]
        pos_vecs = corpus[pos_idx.reshape(-1)]  # (bs*k, d)
        hashed_pos = self.hashing.predict(hashing_params, pos_vecs).reshape(
            bs, k, -1
        )

        # kNNs should have smaller code distance (proposed.py:103-106):
        # row_pairwise((bs,1,bits),(bs,k,bits)) -> (bs,1,k), summed over
        # the singleton then averaged.
        positive_loss = jnp.mean(
            self.hashing.code_distance.row_pairwise(
                hashed_anchor[:, None, :], hashed_pos
            )[:, 0, :]
        )

        # Query-size regulariser (proposed.py:108-119), dense on device.
        n = corpus.shape[0]
        samp_idx = jax.random.randint(key, (self.n_reg_samples,), 0, n)
        sampled = corpus[samp_idx]
        hashed_cand = self.hashing.predict(hashing_params, sampled)

        from nlsh_jax.ops.packing import pack_bits

        query_codes = pack_bits(
            (jax.lax.stop_gradient(hashed_anchor) > 0.5).astype(jnp.int32)
        )  # (bs,)
        cand_codes = pack_bits(
            (jax.lax.stop_gradient(hashed_cand) > 0.5).astype(jnp.int32)
        )  # (ns,)
        in_probed = jnp.any(
            cand_codes[:, None] == query_codes[None, :], axis=1
        )  # (ns,) — the dense np.isin (proposed.py:117)

        confidence = jnp.min(jnp.abs(hashed_cand - 0.5), axis=1)  # (ns,)
        query_size_loss = jnp.sum(confidence * (~in_probed).astype(jnp.float32))

        return positive_loss + self.lambda1 * query_size_loss
