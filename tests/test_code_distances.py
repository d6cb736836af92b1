"""Golden tests for code distances.

Numeric fixtures come from the reference test suite
(``nlsh/learning/tests/test_distances.py:11-38``) so the jnp
implementations are value-compatible with the torch originals; the
extra cases pin down the pairwise/row_pairwise forms against the
rowwise ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from nlsh_jax.ops import code_distances as cd


def test_jsd_categorical_golden():
    p = jnp.array([[0.1, 0.9], [0.1, 0.9], [1.0, 0.0]])
    q = jnp.array([[0.5, 0.5], [0.1, 0.9], [0.0, 1.0]])
    np.testing.assert_array_almost_equal(
        np.asarray(cd.jsd_categorical(p, q)),
        np.array([0.101749, 0.0, 0.693147]),
        decimal=4,
    )


def test_kl_multivariate_bernoulli_golden():
    p = jnp.array([[0.5, 0.5], [0.1, 0.9], [0.1, 0.9], [0.1, 0.9], [1.0, 0.0]])
    q = jnp.array([[0.1, 0.9], [0.5, 0.5], [0.9, 0.1], [0.1, 0.9], [0.0, 1.0]])
    np.testing.assert_array_almost_equal(
        np.asarray(cd.kl_multivariate_bernoulli(p, q)),
        np.array([0.510826, 0.368064, 1.757779, 0.0, 46.0517]),
        decimal=4,
    )


def test_cross_entropy_multivariate_bernoulli_golden():
    p = jnp.array(
        [[0.5, 0.5], [0.1, 0.9], [0.1, 0.9], [0.1, 0.9], [0.2, 0.8], [1.0, 0.0]]
    )
    q = jnp.array(
        [[0.1, 0.9], [0.5, 0.5], [0.9, 0.1], [0.1, 0.9], [0.2, 0.8], [0.0, 1.0]]
    )
    np.testing.assert_array_almost_equal(
        np.asarray(cd.cross_entropy_multivariate_bernoulli(p, q)),
        np.array([1.203973, 0.693147, 2.082862, 0.325083, 0.500402, 46.0517]),
        decimal=4,
    )


def test_hellinger_categorical():
    p = jnp.array([[1.0, 0.0], [0.5, 0.5]])
    q = jnp.array([[1.0, 0.0], [0.5, 0.5]])
    np.testing.assert_allclose(np.asarray(cd.hellinger_categorical(p, q)), [0.0, 0.0])
    p = jnp.array([[1.0, 0.0]])
    q = jnp.array([[0.0, 1.0]])
    # Max Hellinger distance is 1.
    np.testing.assert_allclose(np.asarray(cd.hellinger_categorical(p, q)), [1.0])


@pytest.mark.parametrize(
    "dist_name", ["L2", "KL", "MeanKL", "CrossEntropy", "Cosine"]
)
def test_pairwise_consistent_with_rowwise(dist_name):
    """pairwise(p, q)[i, i] must equal the family's own self-pairing,
    modulo the documented parity warts (KL: pairwise sums over bits
    where rowwise means; L2: pairwise is squared)."""
    rng = np.random.default_rng(0)
    k = 8
    p = jnp.asarray(rng.uniform(0.05, 0.95, (5, k)).astype(np.float32))
    q = jnp.asarray(rng.uniform(0.05, 0.95, (5, k)).astype(np.float32))

    d = cd.get_code_distance(dist_name)
    row = np.asarray(d.rowwise(p, q))
    pair_diag = np.asarray(d.pairwise(p, q)).diagonal()

    if dist_name in ("KL", "MeanKL", "CrossEntropy"):
        # pairwise sums over bits, rowwise means — reference parity wart
        kl_part_row = row
        if dist_name == "CrossEntropy":
            ent = np.asarray(cd.entropy_multivariate_bernoulli(p, d.epsilon))
            kl_part_row = row - ent
            pair_diag = pair_diag - ent
        np.testing.assert_allclose(pair_diag, k * kl_part_row, rtol=1e-4)
    elif dist_name == "L2":
        np.testing.assert_allclose(pair_diag, row**2, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(pair_diag, row, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "dist_name", ["L2", "KL", "MeanKL", "CrossEntropy", "Cosine"]
)
def test_row_pairwise_shapes_and_diag(dist_name):
    rng = np.random.default_rng(1)
    n, m, pp, k = 3, 4, 4, 6
    p = jnp.asarray(rng.uniform(0.05, 0.95, (n, m, k)).astype(np.float32))
    q = jnp.asarray(rng.uniform(0.05, 0.95, (n, pp, k)).astype(np.float32))
    d = cd.get_code_distance(dist_name)
    out = np.asarray(d.row_pairwise(p, q))
    assert out.shape == (n, m, pp)
    if dist_name in ("L2", "Cosine"):
        # self-distance along the diagonal when q == p
        out_self = np.asarray(d.row_pairwise(p, p))
        diag = np.diagonal(out_self, axis1=1, axis2=2)
        np.testing.assert_allclose(diag, np.zeros_like(diag), atol=1e-3)


def test_mean_kl_is_symmetric():
    rng = np.random.default_rng(2)
    p = jnp.asarray(rng.uniform(0.05, 0.95, (4, 8)).astype(np.float32))
    q = jnp.asarray(rng.uniform(0.05, 0.95, (4, 8)).astype(np.float32))
    d = cd.MVBernoulliMeanKLDivergence()
    np.testing.assert_allclose(
        np.asarray(d.rowwise(p, q)), np.asarray(d.rowwise(q, p)), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(d.pairwise(p, q)), np.asarray(d.pairwise(q, p)).T, rtol=1e-5
    )
