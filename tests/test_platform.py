"""What the program needs from its platform: a compile cache at a fixed
path, checkpoints without flax, and an ``auto`` engine that resolves the
same way on every backend."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nlsh_jax.models.encoders import SirenEncoder
from nlsh_jax.models.hashings import MultivariateBernoulli
from nlsh_jax.utils import env


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(env_set, tmp_path, monkeypatch):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(env, "REPO_ROOT", tmp_path)
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                               str(tmp_path / "from_env"))
            assert env.setup_compile_cache() == str(tmp_path / "from_env")
            # the variable is JAX's own: nothing else is set in code
            assert jax.config.jax_compilation_cache_dir == old
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = env.setup_compile_cache()
            assert path == str(tmp_path / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_checkpoint_roundtrip_without_flax(tmp_path, monkeypatch):
    """Model artifacts and train states save and load with numpy alone:
    an import of flax fails here."""
    import optax

    from nlsh_jax.train.base import TrainState
    from nlsh_jax.utils import checkpoint as ckpt

    monkeypatch.setitem(sys.modules, "flax", None)
    monkeypatch.setitem(sys.modules, "flax.serialization", None)
    with pytest.raises(ImportError):
        import flax  # noqa: F401

    h = MultivariateBernoulli(SirenEncoder(input_dim=12, hidden_dims=(16,)),
                              6)
    params = h.init(jax.random.PRNGKey(4))
    base = str(tmp_path / "m")
    ckpt.save_model(base, h, params)
    assert (tmp_path / ("m" + ckpt.PARAMS_SUFFIX)).exists()
    h2, params2 = ckpt.load_model(base + ckpt.PARAMS_SUFFIX)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(params2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    x = jnp.asarray(np.random.default_rng(0).normal(size=(8, 12)),
                    jnp.float32)
    np.testing.assert_array_equal(np.asarray(h.hash_hard(params, x)),
                                  np.asarray(h2.hash_hard(params2, x)))

    tx = optax.amsgrad(1e-3)
    full = {"hashing": params, "extra": {}}
    state = TrainState(full, tx.init(full), jnp.asarray(5, jnp.int32))
    path = str(tmp_path / ("m" + ckpt.STATE_SUFFIX))
    ckpt.save_train_state(path, state)
    like = TrainState(full, tx.init(full), jnp.asarray(0, jnp.int32))
    loaded = ckpt.load_train_state(path, like)
    assert int(loaded.step) == 5
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_tree(base + ckpt.PARAMS_SUFFIX, MultivariateBernoulli(
            SirenEncoder(input_dim=12, hidden_dims=(8,)), 6
        ).init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_auto_engine_is_platform_free(backend, monkeypatch):
    """``engine="auto"`` resolves to the same engine whatever backend
    JAX reports."""
    from nlsh_jax.index.indexer import AUTO_ENGINE, Indexer, resolve_engine
    from nlsh_jax.parallel import MultiTableIndexer, ShardedIndexer, make_mesh
    from nlsh_jax.parallel import multitable
    from nlsh_jax.parallel.multitable import init_multi_table

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    rng = np.random.default_rng(1)
    corpus = jnp.asarray(rng.normal(size=(256, 12)).astype(np.float32))
    h = MultivariateBernoulli(SirenEncoder(input_dim=12, hidden_dims=(16,)),
                              4)
    params = h.init(jax.random.PRNGKey(0))

    idx = Indexer(h, params, corpus)
    assert idx.engine == "auto" and resolve_engine(idx.engine) == AUTO_ENGINE
    assert AUTO_ENGINE == "grouped"
    sh = ShardedIndexer(h, params, corpus, make_mesh(2, axis="shard"))
    assert sh.engine == AUTO_ENGINE
    mt = MultiTableIndexer(h, init_multi_table(h, 2, jax.random.PRNGKey(1)),
                           corpus)
    assert mt.engine == multitable.AUTO_ENGINE == "windowed"
