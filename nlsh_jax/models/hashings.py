"""Learned hash functions (hashing heads).

JAX re-design of the reference ``nlsh/hashings.py``.  A hashing
combines an encoder trunk with an output layer producing a probability
code; ``predict`` is the differentiable forward used by losses and
``hash`` is the discrete bucket assignment used by the index:

* hard hash:      per-bit threshold ``prob > 0.5``
  (reference ``hashings.py:72``)
* multi-probe:    the hard code plus ``n - 1`` Bernoulli samples
  (reference ``hashings.py:74-81``), here drawn with ``jax.random``
  inside jit instead of ``torch.distributions`` + Cython host packing.

Bucket ids come back as a fixed-width ``(n, n_probes)`` int32 array
plus a dedupe mask (:func:`nlsh_jax.ops.packing.hash_codes`) — the
static-shape equivalent of the reference's ``List[Set[int]]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from nlsh_jax.models.encoders import _linear_apply, _linear_init
from nlsh_jax.ops import packing

Array = jnp.ndarray
Params = dict


@dataclasses.dataclass(frozen=True)
class MultivariateBernoulli:
    """Per-bit Bernoulli hashing (reference ``MultivariateBernoulli``,
    ``hashings.py:11-92``): encoder -> Linear -> sigmoid gives per-bit
    probabilities; ``tanh_output`` uses tanh rescaled to [0, 1] for
    hashing (reference ``hashings.py:23-26,68-69``).
    """

    encoder: Any
    hash_size: int
    code_distance: Any = None  # carried for trainer convenience, as in the reference
    tanh_output: bool = False

    def __post_init__(self):
        if self.code_distance is None:
            from nlsh_jax.ops.code_distances import get_code_distance

            object.__setattr__(
                self,
                "code_distance",
                get_code_distance("Cosine" if self.tanh_output else "L2"),
            )

    @property
    def n_buckets(self) -> int:
        return 2 ** self.hash_size

    @property
    def output_dim(self) -> int:
        return self.hash_size

    def init(self, key) -> Params:
        ek, ok = jax.random.split(key)
        return {
            "encoder": self.encoder.init(ek),
            "out": _linear_init(ok, self.encoder.output_dim, self.hash_size, True),
        }

    def predict(self, params: Params, x: Array) -> Array:
        """Differentiable code: sigmoid probs, or raw tanh when
        ``tanh_output`` (losses see tanh codes; reference
        ``hashings.py:21-27``)."""
        z = _linear_apply(params["out"], self.encoder.apply(params["encoder"], x))
        return jnp.tanh(z) if self.tanh_output else jax.nn.sigmoid(z)

    def probs(self, params: Params, x: Array) -> Array:
        """Bernoulli probabilities in [0, 1] (tanh rescaled as in
        reference ``hashings.py:68-69``)."""
        p = self.predict(params, x)
        return p / 2.0 + 0.5 if self.tanh_output else p

    def hash(
        self,
        params: Params,
        x: Array,
        n_probes: int = 1,
        key: Array | None = None,
        probe_mode: str = "sample",
    ) -> tuple[Array, Array]:
        """Bucket ids for ``x``: ``(ids, valid)`` of shape ``(n, n_probes)``.

        Probe 0 is the deterministic hard code; probes 1..n-1 come from

        * ``probe_mode="sample"`` — Bernoulli samples of the code
          distribution (reference ``hashings.py:66-85``), or
        * ``probe_mode="flip"`` — deterministic best-first multi-probe:
          enumerate flips of the least-confident bits (classic
          multi-probe LSH; no reference counterpart).  Probes are
          distinct by construction, needs no PRNG key, and typically
          dominates sampling on the recall/candidates frontier.

        ids are sorted per row with duplicates masked out of ``valid``.
        """
        if n_probes < 1:
            raise ValueError(f"`n_probes` should be a positive integer, got {n_probes}")
        p = self.probs(params, x)
        if probe_mode == "flip" and n_probes > 1:
            return self._hash_flip(p, n_probes)
        hard = (p > 0.5).astype(jnp.int32)[:, None, :]  # (n, 1, bits)
        if n_probes == 1:
            codes = hard
        else:
            if key is None:
                raise ValueError("multi-probe sampling needs a PRNG `key`")
            sampled = jax.random.bernoulli(
                key, p[:, None, :], (x.shape[0], n_probes - 1, self.hash_size)
            ).astype(jnp.int32)
            codes = jnp.concatenate([hard, sampled], axis=1)
        return packing.hash_codes(codes)

    def _hash_flip(self, p: Array, n_probes: int) -> tuple[Array, Array]:
        """Best-first probes: flip subsets of the ceil(log2(n_probes))
        least-confident bits of the hard code, ordered by flip mask
        (mask 0 = the hard code itself)."""
        bits = self.hash_size
        n_flip = max(int(np.ceil(np.log2(n_probes))), 1)
        n_flip = min(n_flip, bits)
        base = packing.pack_bits((p > 0.5).astype(jnp.int32))  # (n,)
        conf = jnp.abs(p - 0.5)  # (n, bits)
        # positions of the n_flip least-confident bits (bit i has weight
        # 2^(bits-1-i))
        _, flip_pos = jax.lax.top_k(-conf, n_flip)  # (n, n_flip)
        weights = (1 << (bits - 1 - flip_pos)).astype(jnp.int32)  # (n, n_flip)
        masks = jnp.arange(n_probes, dtype=jnp.int32)  # enumerate subsets
        take = ((masks[None, :, None] >> jnp.arange(n_flip)) & 1).astype(
            jnp.int32
        )  # (1, n_probes, n_flip)
        xor = jnp.sum(take * weights[:, None, :], axis=-1)  # (n, n_probes)
        ids = jnp.bitwise_xor(base[:, None], xor)
        return packing.dedupe_codes(ids)

    def hash_hard(self, params: Params, x: Array) -> Array:
        """Deterministic single bucket id per row: ``(n,)`` int32."""
        p = self.probs(params, x)
        return packing.pack_bits((p > 0.5).astype(jnp.int32))


@dataclasses.dataclass(frozen=True)
class Categorical:
    """Softmax-over-buckets hashing (reference ``Categorical``,
    ``hashings.py:95-139``; disabled in the reference CLI,
    ``main.py:89``, but fully supported here).

    ``hash_size`` is the number of buckets directly.  Multi-probe is
    the natural extension of the reference's argmax: probe the top
    ``n_probes`` most probable buckets.
    """

    encoder: Any
    hash_size: int
    code_distance: Any = None

    def __post_init__(self):
        if self.code_distance is None:
            from nlsh_jax.ops.code_distances import get_code_distance

            object.__setattr__(
                self, "code_distance", get_code_distance("CategoricalL2")
            )

    @property
    def n_buckets(self) -> int:
        return self.hash_size

    @property
    def output_dim(self) -> int:
        return self.hash_size

    def init(self, key) -> Params:
        ek, ok = jax.random.split(key)
        return {
            "encoder": self.encoder.init(ek),
            "out": _linear_init(ok, self.encoder.output_dim, self.hash_size, True),
        }

    def predict(self, params: Params, x: Array) -> Array:
        z = _linear_apply(params["out"], self.encoder.apply(params["encoder"], x))
        return jax.nn.softmax(z, axis=-1)

    probs = predict

    def hash(
        self, params: Params, x: Array, n_probes: int = 1,
        key: Array | None = None, probe_mode: str = "sample",
    ) -> tuple[Array, Array]:
        # top-n probing is already deterministic best-first; probe_mode
        # is accepted for interface uniformity
        if n_probes < 1:
            raise ValueError(
                f"`n_probes` should be a positive integer, got {n_probes}"
            )
        p = self.predict(params, x)
        # only hash_size distinct buckets exist: clamp the top-k width
        # and mark excess probe slots invalid instead of crashing inside
        # jit with an opaque shape error
        k_eff = min(n_probes, self.hash_size)
        _, ids = jax.lax.top_k(p, k_eff)  # (n, k_eff)
        ids = ids.astype(jnp.int32)
        if k_eff < n_probes:
            pad = jnp.broadcast_to(
                ids[:, -1:], (ids.shape[0], n_probes - k_eff)
            )
            ids = jnp.concatenate([ids, pad], axis=-1)
        ids = jnp.sort(ids, axis=-1)
        valid = jnp.concatenate(
            [jnp.ones_like(ids[:, :1], bool),
             ids[:, 1:] != ids[:, :-1]], axis=-1,
        )
        return ids, valid

    def hash_hard(self, params: Params, x: Array) -> Array:
        return jnp.argmax(self.predict(params, x), axis=-1).astype(jnp.int32)


@dataclasses.dataclass(frozen=True)
class ProductQuantization:
    """Learned product-quantisation hashing.

    The reference declares this class but leaves it an empty stub
    (``hashings.py:142-145``); implemented here: the encoder output
    feeds ``n_bands`` independent softmax heads of ``2**bits_per_band``
    sub-buckets each; the bucket id concatenates the per-band argmax
    codes (band 0 highest bits).  Multi-probe samples each band's
    categorical independently.

    ``predict`` returns the concatenated band probabilities
    ``(n, n_bands * 2**bits_per_band)`` so the generic code distances
    (L2 / cosine on probability vectors) apply unchanged.
    """

    encoder: Any
    n_bands: int
    bits_per_band: int
    code_distance: Any = None

    def __post_init__(self):
        if self.code_distance is None:
            from nlsh_jax.ops.code_distances import get_code_distance

            object.__setattr__(
                self, "code_distance", get_code_distance("CategoricalL2")
            )

    @property
    def band_size(self) -> int:
        return 2 ** self.bits_per_band

    @property
    def hash_size(self) -> int:
        return self.n_bands * self.bits_per_band

    @property
    def n_buckets(self) -> int:
        return 2 ** self.hash_size

    @property
    def output_dim(self) -> int:
        return self.n_bands * self.band_size

    def init(self, key) -> Params:
        ek, ok = jax.random.split(key)
        return {
            "encoder": self.encoder.init(ek),
            "out": _linear_init(
                ok, self.encoder.output_dim, self.n_bands * self.band_size, True
            ),
        }

    def _band_probs(self, params: Params, x: Array) -> Array:
        z = _linear_apply(params["out"], self.encoder.apply(params["encoder"], x))
        z = z.reshape(x.shape[0], self.n_bands, self.band_size)
        return jax.nn.softmax(z, axis=-1)

    def predict(self, params: Params, x: Array) -> Array:
        return self._band_probs(params, x).reshape(x.shape[0], -1)

    probs = predict

    def _pack_bands(self, band_codes: Array) -> Array:
        """(..., n_bands) sub-codes -> packed int32, band 0 high bits."""
        shifts = self.bits_per_band * jnp.arange(
            self.n_bands - 1, -1, -1, dtype=jnp.int32
        )
        return jnp.sum(
            band_codes.astype(jnp.int32) << shifts, axis=-1, dtype=jnp.int32
        )

    def hash_hard(self, params: Params, x: Array) -> Array:
        codes = jnp.argmax(self._band_probs(params, x), axis=-1)  # (n, M)
        return self._pack_bands(codes)

    def hash(
        self, params: Params, x: Array, n_probes: int = 1,
        key: Array | None = None, probe_mode: str = "sample",
    ) -> tuple[Array, Array]:
        p = self._band_probs(params, x)  # (n, M, B)
        hard = jnp.argmax(p, axis=-1)[:, None, :]  # (n, 1, M)
        if probe_mode == "flip" and n_probes > 1:
            return self._hash_flip(p, n_probes)
        if n_probes == 1:
            codes = hard
        else:
            if key is None:
                raise ValueError("multi-probe hashing needs a PRNG `key`")
            sampled = jax.random.categorical(
                key, jnp.log(p[:, None, :, :] + 1e-20),
                axis=-1, shape=(x.shape[0], n_probes - 1, self.n_bands),
            )
            codes = jnp.concatenate([hard, sampled], axis=1)  # (n, probes, M)
        ids = self._pack_bands(codes)
        s = jnp.sort(ids, axis=-1)
        first = jnp.ones_like(s[:, :1], dtype=bool)
        valid = jnp.concatenate([first, s[:, 1:] != s[:, :-1]], axis=-1)
        return s, valid

    def _hash_flip(self, p: Array, n_probes: int) -> tuple[Array, Array]:
        """Deterministic best-first PQ multi-probe (round 5 — the r4
        playbook piece PQ never got): the band analogue of the MVB
        bit-flip probes above.  Bands are ordered least-confident first
        (smallest top1/top2 log-margin) and probe ``m``'s base-``B``
        digits (B = band_size) pick each band's ``digit``-th best
        sub-code — digit 0 varies fastest, so early probes sweep the
        least-confident band through its ranked alternatives before
        touching better-separated bands.  Probes are deterministic,
        pairwise distinct (distinct digit vectors -> distinct codes),
        and earlier probes are a fixed prefix as ``n_probes`` grows."""
        n = p.shape[0]
        B = self.band_size
        if n_probes > self.n_buckets:
            raise ValueError(
                f"n_probes {n_probes} exceeds n_buckets {self.n_buckets}"
            )
        vals, ranked = jax.lax.top_k(p, B)  # (n, M, B): per-band ranking
        margin = jnp.log(vals[..., 0] + 1e-20) - jnp.log(vals[..., 1] + 1e-20)
        order = jnp.argsort(margin, axis=-1)  # least-confident band first
        # digits[probe, slot]: base-B digit of the probe index
        probes = np.arange(n_probes, dtype=np.int64)
        n_slots = max(int(np.ceil(np.log(max(n_probes, 2))
                                  / np.log(B))), 1)
        n_slots = min(n_slots, self.n_bands)
        digits = jnp.asarray(
            (probes[:, None] // (B ** np.arange(n_slots))) % B,
            jnp.int32)  # (P, n_slots)
        # slot j = the j-th least-confident band of each query
        slot_band = order[:, :n_slots]  # (n, n_slots)
        # per (query, probe, band): which rank to take (0 = hard code)
        one_hot = jax.nn.one_hot(slot_band, self.n_bands,
                                 dtype=jnp.int32)  # (n, n_slots, M)
        rank = jnp.einsum("pj,njm->npm", digits, one_hot)  # (n, P, M)
        codes = jnp.take_along_axis(
            ranked[:, None], rank[..., None], axis=-1
        )[..., 0]  # (n, P, M): rank -> actual sub-code
        ids = self._pack_bands(codes)
        valid = jnp.ones((n, n_probes), bool)  # distinct by construction
        return ids, valid


def get_hashing(
    hashing_type: str,
    encoder: Any,
    hash_size: int,
    code_distance: Any = None,
):
    """Factory keyed by the reference CLI's --hashing_type
    (``main.py:77-127``).  ``code_distance`` defaults per head the way
    the reference CLI defaults ``--distance_type`` to L2."""
    from nlsh_jax.ops.code_distances import get_code_distance

    if hashing_type == "MultivariateBernoulli":
        return MultivariateBernoulli(
            encoder, hash_size, code_distance or get_code_distance("L2")
        )
    if hashing_type == "MultivariateBernoulliTanh":
        return MultivariateBernoulli(
            encoder,
            hash_size,
            code_distance or get_code_distance("Cosine"),
            tanh_output=True,
        )
    if hashing_type == "Categorical":
        return Categorical(
            encoder, hash_size, code_distance or get_code_distance("CategoricalL2")
        )
    if hashing_type == "ProductQuantization":
        # hash_size total bits split into 4-bit bands by default
        bits_per_band = 4 if hash_size % 4 == 0 else (
            2 if hash_size % 2 == 0 else 1
        )
        return ProductQuantization(
            encoder, hash_size // bits_per_band, bits_per_band,
            code_distance or get_code_distance("CategoricalL2"),
        )
    raise ValueError(f"{hashing_type!r} is not a valid hashing type")
