"""Regression: checkpoint base names containing dots (recall values in
filenames, as the trainer writes) must roundtrip intact."""

import jax
import jax.numpy as jnp
import numpy as np

from nlsh_jax.models.encoders import MLPEncoder
from nlsh_jax.models.hashings import MultivariateBernoulli
from nlsh_jax.utils import checkpoint as ckpt


def test_dotted_base_name(tmp_path):
    h = MultivariateBernoulli(MLPEncoder(input_dim=4, hidden_dims=(8,)), 3)
    params = h.init(jax.random.PRNGKey(0))
    base = str(tmp_path / "run_300_0.6528")
    ckpt.save_model(base, h, params)
    assert (tmp_path / "run_300_0.6528.json").exists()
    assert (tmp_path / "run_300_0.6528.params.npz").exists()
    h2, p2 = ckpt.load_model(base)
    x = jnp.ones((2, 4))
    np.testing.assert_allclose(
        np.asarray(h.predict(params, x)), np.asarray(h2.predict(p2, x))
    )
