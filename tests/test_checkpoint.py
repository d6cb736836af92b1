"""Checkpoint roundtrip tests: inference artifact + full train state."""

import jax
import jax.numpy as jnp
import numpy as np

from nlsh_jax.models.encoders import MLPEncoder, SirenEncoder
from nlsh_jax.models.hashings import Categorical, MultivariateBernoulli
from nlsh_jax.ops.code_distances import MVBernoulliKLDivergence, MVBernoulliL2
from nlsh_jax.utils import checkpoint as ckpt


def test_model_roundtrip_mvb(tmp_path):
    h = MultivariateBernoulli(
        MLPEncoder(input_dim=6, hidden_dims=(16, 8)), 5, MVBernoulliL2()
    )
    params = h.init(jax.random.PRNGKey(0))
    base = str(tmp_path / "model")
    ckpt.save_model(base, h, params)

    h2, params2 = ckpt.load_model(base)
    assert h2.hash_size == 5
    assert type(h2.code_distance).__name__ == "MVBernoulliL2"
    x = jnp.asarray(np.random.default_rng(0).normal(size=(4, 6)).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(h.predict(params, x)), np.asarray(h2.predict(params2, x)),
        rtol=1e-6,
    )


def test_model_roundtrip_siren_tanh(tmp_path):
    h = MultivariateBernoulli(
        SirenEncoder(input_dim=6, hidden_dims=(16, 8)), 4,
        MVBernoulliKLDivergence(), tanh_output=True,
    )
    params = h.init(jax.random.PRNGKey(1))
    base = str(tmp_path / "m2")
    ckpt.save_model(base, h, params)
    h2, params2 = ckpt.load_model(base + ".json")  # suffix accepted
    assert h2.tanh_output
    assert type(h2.code_distance).__name__ == "MVBernoulliKLDivergence"
    x = jnp.ones((2, 6))
    np.testing.assert_allclose(
        np.asarray(h.predict(params, x)), np.asarray(h2.predict(params2, x)),
        rtol=1e-6,
    )


def test_model_roundtrip_categorical(tmp_path):
    h = Categorical(MLPEncoder(input_dim=3, hidden_dims=(8,)), 16)
    params = h.init(jax.random.PRNGKey(2))
    base = str(tmp_path / "cat")
    ckpt.save_model(base, h, params)
    h2, params2 = ckpt.load_model(base)
    assert h2.n_buckets == 16
    x = jnp.ones((2, 3))
    np.testing.assert_allclose(
        np.asarray(h.predict(params, x)), np.asarray(h2.predict(params2, x)),
        rtol=1e-6,
    )


def test_train_state_roundtrip(tmp_path):
    import optax
    from nlsh_jax.train.base import TrainState

    h = MultivariateBernoulli(MLPEncoder(input_dim=4, hidden_dims=(8,)), 3)
    params = {"hashing": h.init(jax.random.PRNGKey(0)), "extra": {}}
    tx = optax.amsgrad(1e-3)
    state = TrainState(params, tx.init(params), jnp.asarray(7, jnp.int32))
    path = str(tmp_path / "state.npz")
    ckpt.save_train_state(path, state)

    like = TrainState(params, tx.init(params), jnp.asarray(0, jnp.int32))
    loaded = ckpt.load_train_state(path, like)
    assert int(loaded.step) == 7
    orig = jax.tree.leaves(state.params)
    got = jax.tree.leaves(loaded.params)
    for a, b in zip(orig, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
