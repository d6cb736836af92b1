"""Distances in *code / probability* space, used by the training losses.

JAX re-build of the reference ``nlsh/learning/distances.py``.
Each distance family exposes three shapes, mirroring the reference
``_Distance`` ABC (``distances.py:13-43``):

* ``rowwise(p, q)``:      ``(n, k) x (n, k)     -> (n,)``
* ``pairwise(p, q)``:     ``(n, k) x (m, k)     -> (n, m)``
* ``row_pairwise(p, q)``: ``(n, m, k) x (n, p, k) -> (n, m, p)``

All functions are pure jnp and jit/vmap/grad-safe.  Pairwise forms are
written as single contractions (einsum / matmul) so XLA maps them onto
matrix products instead of materialising broadcast intermediates where it can.

Behavioural-parity notes (kept deliberately, documented so they are not
"fixed" by accident — losses were tuned against these semantics):

* Bernoulli KL ``rowwise`` takes the **mean** over bits
  (``distances.py:76-85``) while ``pairwise``/``row_pairwise`` take the
  **sum** (``distances.py:88-124``) — the reference is internally
  inconsistent by a factor of ``k`` and we preserve each form.
* ``MVBernoulliL2.rowwise`` is the true L2 norm while ``.pairwise``
  returns **squared** distances (``distances.py:245-276``); preserved.
* The reference ``hellinger_categorical`` has a typo
  (``F.pariwise_distance``, ``distances.py:73``) making it dead code;
  here it is implemented correctly.
* The reference ``MVBernoulliTanhCosine.row_pairwise`` normalises along
  the wrong axis (``distances.py:300-312``); here the k-axis is used.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray

_DEFAULT_EPS = 1e-16
_Q_FLOOR = 1e-20  # the reference's hardcoded denominator guard


# ---------------------------------------------------------------------------
# Functional forms (reference distances.py:46-131)
# ---------------------------------------------------------------------------

def jsd_categorical(p: Array, q: Array) -> Array:
    """Jensen-Shannon divergence between rows of categorical distributions.

    ``(n, k) x (n, k) -> (n,)``.  Matches ``JSD_categorical``
    (``distances.py:46-61``) including the 0*log(0) = 0 convention of
    ``torch.distributions.kl_divergence``.
    """
    m = (p + q) / 2.0

    def _kl(a: Array, b: Array) -> Array:
        ratio = jnp.log(a) - jnp.log(b)
        return jnp.sum(jnp.where(a > 0, a * ratio, 0.0), axis=-1)

    return (_kl(p, m) + _kl(q, m)) / 2.0


def hellinger_categorical(p: Array, q: Array) -> Array:
    """Hellinger distance between rows of categoricals: ``(n, k)^2 -> (n,)``.

    Correct implementation of the intent of ``distances.py:64-73``
    (whose ``F.pariwise_distance`` typo makes it unusable upstream).
    """
    diff = jnp.sqrt(p) - jnp.sqrt(q)
    return jnp.linalg.norm(diff, axis=-1) / jnp.sqrt(2.0)


def kl_multivariate_bernoulli(p: Array, q: Array, epsilon: float = _DEFAULT_EPS) -> Array:
    """Mean-over-bits KL between multivariate Bernoullis: ``(..., k) -> (...)``.

    Bit-exact port of the reference formula (``distances.py:76-85``),
    including the asymmetric epsilon placement.
    """
    positive = p * jnp.log(epsilon + p / (q + _Q_FLOOR))
    negative = (1.0 - p) * jnp.log(epsilon + (1.0 - p) / (1.0 - q + _Q_FLOOR))
    return jnp.mean(positive + negative, axis=-1)


def _pairwise_kl_mvb(p: Array, q: Array, epsilon: float) -> Array:
    """Sum-over-bits pairwise Bernoulli KL: ``(n, k) x (m, k) -> (n, m)``.

    Reference ``distances.py:88-106`` (einsum + broadcast).
    """
    log_p_q = jnp.log(epsilon + jnp.einsum("nk,mk->nmk", p, 1.0 / (q + _Q_FLOOR)))
    positive = jnp.sum(p[:, None, :] * log_p_q, axis=-1)
    log_np_nq = jnp.log(
        epsilon + jnp.einsum("nk,mk->nmk", 1.0 - p, 1.0 / (1.0 - q + _Q_FLOOR))
    )
    negative = jnp.sum((1.0 - p[:, None, :]) * log_np_nq, axis=-1)
    return positive + negative


def _row_pairwise_kl_mvb(p: Array, q: Array, epsilon: float) -> Array:
    """``(n, m, k) x (n, p, k) -> (n, m, p)`` (reference distances.py:109-124)."""
    log_p_q = jnp.log(
        epsilon + jnp.einsum("nmk,npk->nmpk", p, 1.0 / (q + _Q_FLOOR))
    )
    positive = jnp.sum(p[:, :, None, :] * log_p_q, axis=-1)
    log_np_nq = jnp.log(
        epsilon + jnp.einsum("nmk,npk->nmpk", 1.0 - p, 1.0 / (1.0 - q + _Q_FLOOR))
    )
    negative = jnp.sum((1.0 - p[:, :, None, :]) * log_np_nq, axis=-1)
    return positive + negative


def entropy_multivariate_bernoulli(p: Array, epsilon: float = _DEFAULT_EPS) -> Array:
    """Mean-over-bits entropy (reference distances.py:127-130)."""
    positive = -p * jnp.log(p + epsilon)
    negative = -(1.0 - p) * jnp.log(1.0 - p + epsilon)
    return jnp.mean(positive + negative, axis=-1)


def cross_entropy_multivariate_bernoulli(
    p: Array, q: Array, epsilon: float = _Q_FLOOR
) -> Array:
    """KL + entropy (reference distances.py:128-131)."""
    return kl_multivariate_bernoulli(p, q, epsilon) + entropy_multivariate_bernoulli(
        p, epsilon
    )


# ---------------------------------------------------------------------------
# Distance families (reference distances.py:134-312)
# ---------------------------------------------------------------------------

class MVBernoulliKLDivergence:
    """Reference ``MVBernoulliKLDivergence`` (distances.py:134-164)."""

    def __init__(self, epsilon: float = _Q_FLOOR):
        self.epsilon = epsilon

    def rowwise(self, p: Array, q: Array) -> Array:
        return kl_multivariate_bernoulli(p, q, self.epsilon)

    def pairwise(self, p: Array, q: Array) -> Array:
        return _pairwise_kl_mvb(p, q, self.epsilon)

    def row_pairwise(self, p: Array, q: Array) -> Array:
        return _row_pairwise_kl_mvb(p, q, self.epsilon)


class MVBernoulliMeanKLDivergence:
    """Symmetrised KL (reference distances.py:167-203).

    Deviation (a FIX, listed in PARITY.md): ``pairwise``/``row_pairwise``
    add the q→p term **transposed** so cell (i, j) is
    ``(KL(p_i‖q_j) + KL(q_j‖p_i)) / 2`` — the correct symmetrisation.
    The reference adds it untransposed (``distances.py:183-203``), which
    for square batches mixes row i with an unrelated q_i.
    """

    def __init__(self, epsilon: float = _Q_FLOOR):
        self.epsilon = epsilon

    def rowwise(self, p: Array, q: Array) -> Array:
        return (
            kl_multivariate_bernoulli(p, q, self.epsilon)
            + kl_multivariate_bernoulli(q, p, self.epsilon)
        ) / 2.0

    def pairwise(self, p: Array, q: Array) -> Array:
        return (
            _pairwise_kl_mvb(p, q, self.epsilon)
            + _pairwise_kl_mvb(q, p, self.epsilon).T
        ) / 2.0

    def row_pairwise(self, p: Array, q: Array) -> Array:
        kl_pq = _row_pairwise_kl_mvb(p, q, self.epsilon)
        kl_qp = _row_pairwise_kl_mvb(q, p, self.epsilon)
        return (kl_pq + jnp.swapaxes(kl_qp, -1, -2)) / 2.0


class MVBernoulliCrossEntropy:
    """KL + entropy-of-p (reference distances.py:206-242)."""

    def __init__(self, epsilon: float = _Q_FLOOR):
        self.epsilon = epsilon

    def rowwise(self, p: Array, q: Array) -> Array:
        return kl_multivariate_bernoulli(
            p, q, self.epsilon
        ) + entropy_multivariate_bernoulli(p, self.epsilon)

    def pairwise(self, p: Array, q: Array) -> Array:
        kl = _pairwise_kl_mvb(p, q, self.epsilon)
        ent = entropy_multivariate_bernoulli(p, self.epsilon)
        return kl + ent[:, None]

    def row_pairwise(self, p: Array, q: Array) -> Array:
        kl = _row_pairwise_kl_mvb(p, q, self.epsilon)
        ent = entropy_multivariate_bernoulli(p, self.epsilon)
        return kl + ent[:, :, None]


class MVBernoulliL2:
    """L2 in probability space (reference distances.py:245-276).

    Parity wart preserved: ``pairwise`` returns *squared* distances
    while ``rowwise``/``row_pairwise`` return true L2.
    """

    def rowwise(self, p: Array, q: Array) -> Array:
        d = p - q
        return jnp.sqrt(jnp.sum(d * d, axis=-1) + 1e-12)

    def pairwise(self, p: Array, q: Array) -> Array:
        p_sq = jnp.sum(p * p, axis=-1, keepdims=True)
        q_sq = jnp.sum(q * q, axis=-1, keepdims=True).T
        cross = jnp.dot(p, q.T, preferred_element_type=jnp.float32)
        return p_sq + q_sq - 2.0 * cross

    def row_pairwise(self, p: Array, q: Array) -> Array:
        p_sq = jnp.sum(p * p, axis=-1)[:, :, None]
        q_sq = jnp.sum(q * q, axis=-1)[:, None, :]
        cross = jnp.einsum("nmk,npk->nmp", p, q)
        return jnp.sqrt(jnp.maximum(p_sq + q_sq - 2.0 * cross, 0.0) + 1e-12)


class MVBernoulliTanhCosine:
    """Cosine distance on tanh codes (reference distances.py:279-312,
    with the row_pairwise normalisation-axis bug fixed)."""

    @staticmethod
    def _normalize(x: Array) -> Array:
        return x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-12)

    def rowwise(self, p: Array, q: Array) -> Array:
        pn, qn = self._normalize(p), self._normalize(q)
        return 1.0 - jnp.sum(pn * qn, axis=-1)

    def pairwise(self, p: Array, q: Array) -> Array:
        pn, qn = self._normalize(p), self._normalize(q)
        return 1.0 - jnp.dot(pn, qn.T, preferred_element_type=jnp.float32)

    def row_pairwise(self, p: Array, q: Array) -> Array:
        pn, qn = self._normalize(p), self._normalize(q)
        return 1.0 - jnp.einsum("nmk,npk->nmp", pn, qn)


class CategoricalL2:
    """L2 between categorical probability rows (reference ``L2_categorical``,
    distances.py:9-10), for the Categorical hashing head."""

    def rowwise(self, p: Array, q: Array) -> Array:
        d = p - q
        return jnp.sqrt(jnp.sum(d * d, axis=-1) + 1e-12)

    def pairwise(self, p: Array, q: Array) -> Array:
        p_sq = jnp.sum(p * p, axis=-1, keepdims=True)
        q_sq = jnp.sum(q * q, axis=-1, keepdims=True).T
        cross = jnp.dot(p, q.T, preferred_element_type=jnp.float32)
        return jnp.sqrt(jnp.maximum(p_sq + q_sq - 2.0 * cross, 0.0) + 1e-12)

    def row_pairwise(self, p: Array, q: Array) -> Array:
        p_sq = jnp.sum(p * p, axis=-1)[:, :, None]
        q_sq = jnp.sum(q * q, axis=-1)[:, None, :]
        cross = jnp.einsum("nmk,npk->nmp", p, q)
        return jnp.sqrt(jnp.maximum(p_sq + q_sq - 2.0 * cross, 0.0) + 1e-12)


class CategoricalJSD:
    """JSD between categorical rows, for the Categorical head
    (reference wires ``JSD_categorical`` in main.py:84-88)."""

    def rowwise(self, p: Array, q: Array) -> Array:
        return jsd_categorical(p, q)

    def pairwise(self, p: Array, q: Array) -> Array:
        return jsd_categorical(p[:, None, :], q[None, :, :])

    def row_pairwise(self, p: Array, q: Array) -> Array:
        return jsd_categorical(p[:, :, None, :], q[:, None, :, :])


# Registry keyed by the CLI's --distance_type values (reference
# main.py:77-127).
CODE_DISTANCES = {
    "L2": MVBernoulliL2,
    "KL": MVBernoulliKLDivergence,
    "MeanKL": MVBernoulliMeanKLDivergence,
    "CrossEntropy": MVBernoulliCrossEntropy,
    "Cosine": MVBernoulliTanhCosine,
    "JS": CategoricalJSD,
    "CategoricalL2": CategoricalL2,
}


def bucket_balance_loss(
    probs: Array, confidence_weight: float = 0.3, epsilon: float = 1e-12
) -> Array:
    """Bucket load-balancing regulariser for Bernoulli bit codes.

    No reference counterpart — an added regulariser: skewed buckets are
    the serving bottleneck (probe cost scales with the largest probed
    bucket), so the trainer can penalise imbalance directly.  The
    expected bucket distribution under the per-bit Bernoulli code is
    computed exactly with one log-space matmul:

      log P(bucket b | x) = sum_i [ b_i log p_i + (1-b_i) log(1-p_i) ]

    Two terms (the MoE load-balancing shape): the batch-mean bucket
    distribution should be uniform — KL(q_bar || U) — AND each sample's
    own distribution should be confident — mean per-sample entropy —
    otherwise the soft histogram flattens while hard assignments stay
    collapsed (every bit hovering at 0.5 satisfies the first term
    alone).

    Args:
      probs: ``(batch, bits)`` per-bit probabilities (bits <= 16).
      confidence_weight: weight of the per-sample entropy term.
    """
    bits = probs.shape[-1]
    if bits > 16:
        raise ValueError(f"balance loss materialises 2^bits buckets; {bits} > 16")
    n_buckets = 2 ** bits
    shifts = jnp.arange(bits - 1, -1, -1, dtype=jnp.int32)
    codes = (
        (jnp.arange(n_buckets, dtype=jnp.int32)[:, None] >> shifts) & 1
    ).astype(jnp.float32)  # (NB, bits)
    # clamp away from saturation: 1/p gradients explode once the
    # confidence term drives bits hard to 0/1
    probs = jnp.clip(probs, 1e-6, 1.0 - 1e-6)
    log_p = jnp.log(probs)
    log_np = jnp.log(1.0 - probs)
    log_bucket = (
        jnp.dot(log_p, codes.T, preferred_element_type=jnp.float32)
        + jnp.dot(log_np, (1.0 - codes).T, preferred_element_type=jnp.float32)
    )  # (batch, NB)
    p_bucket = jnp.exp(log_bucket)
    q = jnp.mean(p_bucket, axis=0)  # expected histogram
    kl_uniform = jnp.sum(q * jnp.log(q * n_buckets + epsilon))
    # per-sample entropy, equals mean per-bit binary entropy * bits
    sample_entropy = -jnp.mean(jnp.sum(p_bucket * log_bucket, axis=1))
    return kl_uniform + confidence_weight * sample_entropy


def band_balance_loss(
    band_probs: Array, confidence_weight: float = 0.3,
    epsilon: float = 1e-12,
) -> Array:
    """:func:`bucket_balance_loss` for PRODUCT-QUANTISATION heads.

    The JOINT bucket histogram is what serving skew depends on, and per-
    band marginal uniformity does NOT imply joint uniformity — bands
    can each be uniform while strongly correlated, concentrating the
    joint mass on a thin diagonal (measured round 5: a marginals-only
    balance left 1341 of 4096 buckets used, occupancy std 1979, recall
    0.06).  So this computes the exact joint distribution where
    feasible: ``log P(bucket) = sum_m log p_m(code_m(bucket))`` over
    all ``B^M`` buckets (one einsum against the enumerated band-code
    table — 12-bit PQ = 4096 buckets, one small matrix product), with the
    same two terms as the Bernoulli loss: KL(mean joint || uniform) +
    per-sample confidence entropy.  Past ``MAX_JOINT_BITS`` total bits
    it falls back to per-band marginals + confidence (a weaker proxy,
    documented).

    Args:
      band_probs: ``(batch, n_bands, band_size)`` per-band softmaxes.
    """
    p = jnp.clip(band_probs, 1e-9, 1.0)
    batch, n_bands, band_size = p.shape
    bits_per_band = int(np.log2(band_size))
    total_bits = n_bands * bits_per_band
    MAX_JOINT_BITS = 14  # (batch, 2^bits) histogram memory cap
    if 2 ** total_bits == band_size ** n_bands and \
            total_bits <= MAX_JOINT_BITS:
        nb = band_size ** n_bands
        # codes[j, m] = band m's sub-code of bucket j (band 0 high bits)
        shifts = bits_per_band * np.arange(n_bands - 1, -1, -1)
        codes = ((np.arange(nb)[:, None] >> shifts) & (band_size - 1))
        onehot = jax.nn.one_hot(jnp.asarray(codes), band_size)  # (NB,M,B)
        log_p = jnp.log(p)
        log_bucket = jnp.einsum("bmc,nmc->bn", log_p, onehot)  # (batch,NB)
        p_bucket = jnp.exp(log_bucket)
        q = jnp.mean(p_bucket, axis=0)
        kl_uniform = jnp.sum(q * jnp.log(q * nb + epsilon))
        sample_entropy = -jnp.mean(jnp.sum(p_bucket * log_bucket, axis=1))
        return kl_uniform + confidence_weight * sample_entropy
    # fallback: marginals + confidence (joint histogram too large)
    q = jnp.mean(p, axis=0)  # (M, B) mean band distributions
    q = q / jnp.sum(q, axis=-1, keepdims=True)
    kl_uniform = jnp.sum(q * jnp.log(q * band_size + epsilon))
    sample_entropy = -jnp.mean(
        jnp.sum(jnp.sum(p * jnp.log(p), axis=-1), axis=-1)
    )
    return kl_uniform + confidence_weight * sample_entropy


def get_code_distance(name: str):
    try:
        return CODE_DISTANCES[name]()
    except KeyError:
        raise ValueError(
            f"unknown code distance {name!r}; one of {sorted(CODE_DISTANCES)}"
        )
