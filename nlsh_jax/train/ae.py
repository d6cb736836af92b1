"""Autoencoder trainer (reference ``nlsh/trainers/ae.py``).

The hashing's probability code is decoded back to the input space by a
2-layer ReLU decoder (reference ``Decoder``, ``ae.py:35-48`` — ReLU on
the output layer too, parity kept) and trained with the squared
dataset distance between reconstruction and input (``ae.py:73-78``).
The decoder parameters ride in the trainer's ``extra`` pytree and are
jointly optimised, as in the reference (``ae.py:80-87``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nlsh_jax.models.encoders import _linear_apply, _linear_init
from nlsh_jax.ops import distances as D
from nlsh_jax.train.base import Trainer

Array = jnp.ndarray


class AETrainer(Trainer):
    """Reference ``AE`` (ae.py:51-87)."""

    def __init__(self, hashing, data, model_save_dir="/tmp", logger=None,
                 decoder_hidden: int = 256):
        super().__init__(hashing, data, model_save_dir, logger)
        self.decoder_hidden = decoder_hidden

    def init_extra(self, key):
        if not self.data.prepared:
            self.data.load()
        k1, k2 = jax.random.split(key)
        return {
            "fc1": _linear_init(k1, self.hashing.output_dim, self.decoder_hidden, True),
            "fc2": _linear_init(k2, self.decoder_hidden, self.data.dim, True),
        }

    def _decode(self, extra, code: Array) -> Array:
        h = jax.nn.relu(_linear_apply(extra["fc1"], code))
        return jax.nn.relu(_linear_apply(extra["fc2"], h))

    def epoch_arrays(self, key, params):
        n = self.data.training.shape[0]
        return {"anchor": jax.random.permutation(key, n).astype(jnp.int32)}

    def loss_fn(self, hashing_params, extra, corpus, knn, batch, key):
        x = corpus[batch["anchor"]]
        probs = self.hashing.predict(hashing_params, x)
        recon = self._decode(extra, probs)
        dist = D.get_metric(self.data.metric)["rowwise"](recon, x)
        return jnp.mean(dist**2)
