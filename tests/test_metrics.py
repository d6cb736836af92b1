"""Tests for recall (reference nlsh/metrics.py semantics)."""

import numpy as np

from nlsh_jax.utils.metrics import calculate_recall, recall_matrix
import jax.numpy as jnp


def test_recall_exact_match():
    y_true = [[1, 2, 3], [4, 5, 6]]
    y_pred = [[3, 2, 1], [4, 5, 6]]
    assert calculate_recall(y_true, y_pred, np.mean) == 1.0


def test_recall_partial():
    y_true = [[1, 2, 3, 4]]
    y_pred = [[1, 2, 9, 9]]
    assert calculate_recall(y_true, y_pred) == [0.5]


def test_recall_negative_padding_never_matches():
    y_true = jnp.array([[0, 1]])
    y_pred = jnp.array([[-1, -1]])
    assert float(recall_matrix(y_true, y_pred)[0]) == 0.0


def test_recall_pred_wider_than_true():
    y_true = [[7]]
    y_pred = [[1, 7, 3]]
    assert calculate_recall(y_true, y_pred, np.mean) == 1.0
