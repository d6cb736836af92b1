"""VQ-VAE trainer (reference ``nlsh/trainers/vqvae.py``).

The hashing's bucket probabilities select a codebook row by argmax; the
loss is the squared L2 between the codebook vector and the input.  The
straight-through backward matches the reference's custom autograd
``StraightThroughCodebookLookup`` (``vqvae.py:34-71``) exactly — NOT a
plain STE:

* grad wrt probs: the *norm* of the incoming gradient scattered into
  each row's argmax slot (``vqvae.py:59-60``),
* grad wrt codebook: ``index_add`` of the incoming gradient at the
  selected rows (``vqvae.py:63-70``).

Parity quirk kept: the codebook has ``hash_size`` rows (not
``2**hash_size``) because the reference builds
``nn.Embedding(hash_size, dim)`` (``vqvae.py:105-112``) over the
Bernoulli head's per-bit probabilities.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nlsh_jax.train.base import Trainer

Array = jnp.ndarray


@jax.custom_vjp
def st_codebook_lookup(probs: Array, codebook: Array) -> Array:
    """Forward: ``codebook[argmax(probs, -1)]`` (vqvae.py:42-52)."""
    idx = jnp.argmax(probs, axis=-1)
    return codebook[idx]


def _st_fwd(probs, codebook):
    idx = jnp.argmax(probs, axis=-1)
    return codebook[idx], (idx, probs.shape, codebook.shape)


def _st_bwd(res, g):
    idx, probs_shape, codebook_shape = res
    bs = probs_shape[0]
    g_norm = jnp.linalg.norm(g, axis=-1)  # (bs,)
    grad_probs = (
        jnp.zeros(probs_shape, dtype=g.dtype)
        .at[jnp.arange(bs), idx]
        .set(g_norm)
    )
    grad_codebook = jnp.zeros(codebook_shape, dtype=g.dtype).at[idx].add(g)
    return grad_probs, grad_codebook


st_codebook_lookup.defvjp(_st_fwd, _st_bwd)


class VQVAETrainer(Trainer):
    """Reference ``VQVAE`` (vqvae.py:74-112)."""

    def init_extra(self, key):
        if not self.data.prepared:
            self.data.load()
        # torch nn.Embedding default init: N(0, 1) (vqvae.py:105-109)
        return {
            "codebook": jax.random.normal(
                key, (self.hashing.output_dim, self.data.dim), jnp.float32
            )
        }

    def epoch_arrays(self, key, params):
        n = self.data.training.shape[0]
        return {"anchor": jax.random.permutation(key, n).astype(jnp.int32)}

    def loss_fn(self, hashing_params, extra, corpus, knn, batch, key):
        x = corpus[batch["anchor"]]
        probs = self.hashing.predict(hashing_params, x)
        codes = st_codebook_lookup(probs, extra["codebook"])
        d = codes - x
        return jnp.mean(jnp.sum(d * d, axis=-1))
