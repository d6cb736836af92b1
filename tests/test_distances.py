"""Tests for vector-space metrics against numpy brute force."""

import jax.numpy as jnp
import numpy as np
import pytest

from nlsh_jax.ops import distances as D


@pytest.fixture
def vecs():
    rng = np.random.default_rng(0)
    p = rng.normal(size=(6, 16)).astype(np.float32)
    q = rng.normal(size=(9, 16)).astype(np.float32)
    return p, q


def _np_cosine(p, q):
    pn = p / np.linalg.norm(p, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    return 1.0 - pn @ qn.T


def test_cosine_pairwise(vecs):
    p, q = vecs
    got = np.asarray(D.cosine_pairwise(jnp.asarray(p), jnp.asarray(q)))
    np.testing.assert_allclose(got, _np_cosine(p, q), rtol=1e-5, atol=1e-5)


def test_cosine_rowwise_broadcast(vecs):
    p, q = vecs
    got = np.asarray(D.cosine_rowwise(jnp.asarray(p[0]), jnp.asarray(q)))
    np.testing.assert_allclose(got, _np_cosine(p[:1], q)[0], rtol=1e-5, atol=1e-5)


def test_sq_l2_pairwise(vecs):
    p, q = vecs
    expected = ((p[:, None, :] - q[None, :, :]) ** 2).sum(-1)
    got = np.asarray(D.sq_l2_pairwise(jnp.asarray(p), jnp.asarray(q)))
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-4)


def test_l2_rowwise(vecs):
    p, q = vecs
    expected = np.linalg.norm(p - q[:6], axis=1)
    got = np.asarray(D.l2_rowwise(jnp.asarray(p), jnp.asarray(q[:6])))
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-4)


def test_metric_registry():
    assert set(D.METRICS) == {"cosine", "euclidean", "sq_euclidean"}
    with pytest.raises(ValueError):
        D.get_metric("manhattan")
