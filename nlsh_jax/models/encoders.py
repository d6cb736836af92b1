"""Encoder trunks mapping input vectors to hash-head features.

JAX re-design of the reference ``encoders.py``: instead of
``nn.Module`` objects holding state, every encoder is a small frozen
config whose ``init`` returns a params pytree and whose ``apply`` is a
pure function — so models compose freely with ``jit``/``vmap``/``grad``
and stacked-parameter multi-table ensembles (vmap over the params
leading axis) come for free.

Families (reference parity):

* :class:`MLPEncoder` — ``MultiLayerRelu`` (``encoders.py:24-55``),
  optional layer-norm standing in for the reference's optional
  batch-norm (running batch statistics don't fit a pure functional
  training step and layer-norm is the functional equivalent).
* :class:`TwoLayer256Relu` — ``encoders.py:8-21``.
* :class:`SirenEncoder` — the ``siren-torch`` wrapper
  (``encoders.py:58-79``); sinusoidal layers with the standard SIREN
  initialisation, the default trunk in the reference CLI
  (``main.py:388-391``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp

Array = jnp.ndarray
Params = dict


def _linear_init(key, fan_in: int, fan_out: int, with_bias: bool) -> Params:
    """Kaiming-uniform, the torch.nn.Linear default, for behavioural parity."""
    wk, bk = jax.random.split(key)
    bound = 1.0 / jnp.sqrt(fan_in)
    p = {"w": jax.random.uniform(wk, (fan_in, fan_out), jnp.float32, -bound, bound)}
    if with_bias:
        p["b"] = jax.random.uniform(bk, (fan_out,), jnp.float32, -bound, bound)
    return p


def _linear_apply(p: Params, x: Array) -> Array:
    y = jnp.dot(x, p["w"], preferred_element_type=jnp.float32)
    if "b" in p:
        y = y + p["b"]
    return y


@dataclasses.dataclass(frozen=True)
class MLPEncoder:
    """ReLU MLP trunk (reference ``MultiLayerRelu``, encoders.py:24-55)."""

    input_dim: int
    hidden_dims: tuple[int, ...]
    with_bias: bool = True
    with_layernorm: bool = False

    def __post_init__(self):
        object.__setattr__(self, "hidden_dims", tuple(self.hidden_dims))

    @property
    def output_dim(self) -> int:
        return self.hidden_dims[-1]

    def init(self, key) -> Params:
        keys = jax.random.split(key, len(self.hidden_dims))
        layers = []
        prev = self.input_dim
        for k, dim in zip(keys, self.hidden_dims):
            layers.append(_linear_init(k, prev, dim, self.with_bias))
            prev = dim
        return {"layers": layers}

    def apply(self, params: Params, x: Array) -> Array:
        for p in params["layers"]:
            x = _linear_apply(p, x)
            if self.with_layernorm:
                mean = jnp.mean(x, axis=-1, keepdims=True)
                var = jnp.var(x, axis=-1, keepdims=True)
                x = (x - mean) * jax.lax.rsqrt(var + 1e-5)
            x = jax.nn.relu(x)
        return x


def TwoLayer256Relu(input_dim: int, with_bias: bool = True) -> MLPEncoder:
    """Reference ``TwoLayer256Relu`` (encoders.py:8-21)."""
    return MLPEncoder(input_dim, (256, 256), with_bias=with_bias)


@dataclasses.dataclass(frozen=True)
class SirenEncoder:
    """Sinusoidal-representation trunk (reference ``Siren``,
    encoders.py:58-79, wrapping the ``siren-torch`` package).

    Layers compute ``sin(w0 * (Wx + b))`` with the standard SIREN
    initialisation: first layer ``U(-1/fan_in, 1/fan_in)`` with
    ``w0 = w0_initial``; hidden layers
    ``U(-sqrt(6/fan_in)/w0, sqrt(6/fan_in)/w0)``.  The final layer is
    linear (features feed the hashing head's own output layer).
    """

    input_dim: int
    hidden_dims: tuple[int, ...]
    w0: float = 1.0
    w0_initial: float = 30.0

    def __post_init__(self):
        object.__setattr__(self, "hidden_dims", tuple(self.hidden_dims))

    @property
    def output_dim(self) -> int:
        return self.hidden_dims[-1]

    def init(self, key) -> Params:
        keys = jax.random.split(key, len(self.hidden_dims))
        layers = []
        prev = self.input_dim
        for i, (k, dim) in enumerate(zip(keys, self.hidden_dims)):
            wk, bk = jax.random.split(k)
            if i == 0:
                bound = 1.0 / prev
            else:
                bound = jnp.sqrt(6.0 / prev) / self.w0
            layers.append(
                {
                    "w": jax.random.uniform(wk, (prev, dim), jnp.float32, -bound, bound),
                    "b": jax.random.uniform(bk, (dim,), jnp.float32, -bound, bound),
                }
            )
            prev = dim
        return {"layers": layers}

    def apply(self, params: Params, x: Array) -> Array:
        n = len(params["layers"])
        for i, p in enumerate(params["layers"]):
            z = _linear_apply(p, x)
            if i == n - 1:
                x = z  # final layer linear
            else:
                w0 = self.w0_initial if i == 0 else self.w0
                x = jnp.sin(w0 * z)
        return x


ENCODERS = {
    "mlp": MLPEncoder,
    "siren": SirenEncoder,
}


def get_encoder(name: str, input_dim: int, hidden_dims: Sequence[int], **kw):
    """Factory keyed like the reference CLI's encoder choice
    (``main.py:388-391`` hardcodes Siren; MultiLayerRelu is the
    commented-out alternative)."""
    try:
        cls = ENCODERS[name]
    except KeyError:
        raise ValueError(f"unknown encoder {name!r}; one of {sorted(ENCODERS)}")
    return cls(input_dim=input_dim, hidden_dims=tuple(hidden_dims), **kw)
