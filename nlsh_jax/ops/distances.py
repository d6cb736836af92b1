"""Vector-space (data) metrics: cosine and Euclidean.

JAX counterpart of the distance helpers scattered through the
reference (``nlsh/data.py:91-110`` cosine, ``nlsh/data.py:178-201``
euclidean, ``precompute.py:22-54``).  Everything here is a pure jnp
function of arrays; pairwise forms are expressed as one matmul so XLA
tiles them onto matrix products.

Shape conventions (mirroring the reference ``_Distance`` ABC,
``nlsh/learning/distances.py:13-43``):

* ``rowwise(p, q)``:   ``(n, d) x (n, d)   -> (n,)``
* ``pairwise(p, q)``:  ``(n, d) x (m, d)   -> (n, m)``

``rowwise`` also broadcasts a single vector against a matrix
(``(d,) x (m, d) -> (m,)``), matching the reference ``distance``
staticmethods (``nlsh/data.py:103-110``).
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp

Array = jnp.ndarray

_EPS = 1e-12


def l2_normalize(x: Array, axis: int = -1, eps: float = _EPS) -> Array:
    """Project rows onto the unit sphere (reference ``norm_to_unit_sphere``,
    ``nlsh/data.py:9-10``)."""
    norm = jnp.linalg.norm(x, axis=axis, keepdims=True)
    return x / jnp.maximum(norm, eps)


# ---------------------------------------------------------------------------
# Cosine distance (Glove metric, reference nlsh/data.py:91-110)
# ---------------------------------------------------------------------------

def cosine_rowwise(p: Array, q: Array) -> Array:
    """1 - cos(p_i, q_i); broadcasts ``(d,) x (m, d) -> (m,)``."""
    dot = jnp.sum(p * q, axis=-1)
    pn = jnp.linalg.norm(p, axis=-1)
    qn = jnp.linalg.norm(q, axis=-1)
    return 1.0 - dot / jnp.maximum(pn * qn, _EPS)


def cosine_pairwise(p: Array, q: Array) -> Array:
    """All-pairs cosine distance as one matmul: ``(n, d) x (m, d) -> (n, m)``."""
    p = l2_normalize(p)
    q = l2_normalize(q)
    return 1.0 - jnp.dot(p, q.T, preferred_element_type=jnp.float32)


# ---------------------------------------------------------------------------
# Squared Euclidean / Euclidean (SIFT metric, reference nlsh/data.py:178-201,
# precompute.py:37-54 — the reference uses *squared* L2 for GT precompute)
# ---------------------------------------------------------------------------

def sq_l2_rowwise(p: Array, q: Array) -> Array:
    d = p - q
    return jnp.sum(d * d, axis=-1)


def sq_l2_pairwise(p: Array, q: Array) -> Array:
    """||p_i - q_j||^2 via the matmul expansion (one dot + rank-1 adds),
    the JAX analogue of the reference's ``torch.addmm`` trick
    (``precompute.py:47-53``)."""
    p_sq = jnp.sum(p * p, axis=-1, keepdims=True)          # (n, 1)
    q_sq = jnp.sum(q * q, axis=-1, keepdims=True).T        # (1, m)
    cross = jnp.dot(p, q.T, preferred_element_type=jnp.float32)
    out = p_sq + q_sq - 2.0 * cross
    return jnp.maximum(out, 0.0)


def l2_rowwise(p: Array, q: Array) -> Array:
    return jnp.sqrt(sq_l2_rowwise(p, q) + _EPS)


def l2_pairwise(p: Array, q: Array) -> Array:
    return jnp.sqrt(sq_l2_pairwise(p, q) + _EPS)


# ---------------------------------------------------------------------------
# Registry used by datasets / CLI (reference DISTANCE_FUNC, precompute.py:70-76)
# ---------------------------------------------------------------------------

METRICS: dict[str, dict[str, Callable[[Array, Array], Array]]] = {
    "cosine": {"rowwise": cosine_rowwise, "pairwise": cosine_pairwise},
    "euclidean": {"rowwise": l2_rowwise, "pairwise": l2_pairwise},
    # squared L2 ranks identically to L2 and skips the sqrt; used for GT
    # precompute parity with the reference's _l2 (precompute.py:37-54).
    "sq_euclidean": {"rowwise": sq_l2_rowwise, "pairwise": sq_l2_pairwise},
}


def get_metric(name: str) -> dict[str, Callable[[Array, Array], Array]]:
    try:
        return METRICS[name]
    except KeyError:
        raise ValueError(f"unknown metric {name!r}; one of {sorted(METRICS)}")
