"""Evaluation metrics.

JAX counterpart of the reference ``nlsh/metrics.py``: recall is
computed as one vectorised membership test on fixed-shape id arrays
instead of per-query Python set intersections
(``nlsh/metrics.py:4-25``), so it can run jitted on device right after
the query kernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray


@jax.jit
def recall_matrix(y_true: Array, y_pred: Array) -> Array:
    """Per-query recall of predicted ids against ground truth.

    Args:
      y_true: ``(n, k_true)`` int ids (no duplicates within a row).
      y_pred: ``(n, k_pred)`` int ids; entries < 0 mean "no prediction"
        (padding from under-full candidate sets) and never match.

    Returns:
      ``(n,)`` float32: |true ∩ pred| / k_true per row, matching the
      reference ``_recall`` (``nlsh/metrics.py:4-7``).
    """
    matches = (y_true[:, :, None] == y_pred[:, None, :]) & (y_true[:, :, None] >= 0)
    hit = jnp.any(matches, axis=-1)  # (n, k_true)
    return jnp.mean(hit.astype(jnp.float32), axis=-1)


def calculate_recall(y_true, y_pred, reduce_func=None):
    """Drop-in analogue of the reference ``calculate_recall``
    (``nlsh/metrics.py:10-25``): accepts arrays or lists of id lists,
    returns per-query recalls or a reduction of them."""
    y_true = jnp.asarray(np.asarray(y_true))
    y_pred = jnp.asarray(np.asarray(y_pred))
    assert y_true.shape[0] == y_pred.shape[0]
    recalls = np.asarray(recall_matrix(y_true, y_pred))
    if reduce_func is not None:
        return reduce_func(recalls)
    return list(recalls)
