"""Jointly-trained multi-table ensemble tests."""

import glob

import jax
import numpy as np
import pytest

from nlsh_jax.data import SyntheticDataset
from nlsh_jax.models.encoders import MLPEncoder
from nlsh_jax.models.hashings import MultivariateBernoulli
from nlsh_jax.train import AETrainer, MultiTableTrainer, TripletTrainer
from nlsh_jax.utils.checkpoint import load_model


@pytest.fixture(scope="module")
def data():
    return SyntheticDataset(n_train=512, n_test=64, dim=8, n_clusters=16,
                            metric="cosine", k_ground_truth=10, seed=0).load()


def test_multitable_fit_and_checkpoint(data, tmp_path):
    hashing = MultivariateBernoulli(MLPEncoder(8, (16,)), 4)
    inner = TripletTrainer(hashing, data, str(tmp_path), positive_k=5)
    tr = MultiTableTrainer(inner, n_tables=3)
    state = tr.fit(K=5, batch_size=64, epochs=1, test_every_updates=4,
                   max_steps=8, hash_times=3)
    assert int(state.step) == 8
    # stacked params: every hashing leaf has leading table axis 3
    for leaf in jax.tree.leaves(state.params["hashing"]):
        assert leaf.shape[0] == 3

    # checkpoint saved with the table marker and loads back stacked
    cks = glob.glob(str(tmp_path / "*_L3.json"))
    assert cks
    h2, p2 = load_model(cks[0])
    for leaf in jax.tree.leaves(p2):
        assert leaf.shape[0] == 3


def test_multitable_tables_diverge(data, tmp_path):
    """Independent init + independent batches => tables must not be
    identical after training."""
    hashing = MultivariateBernoulli(MLPEncoder(8, (16,)), 4)
    tr = MultiTableTrainer(
        TripletTrainer(hashing, data, str(tmp_path), positive_k=5), 2
    )
    state = tr.fit(K=5, batch_size=64, epochs=1, test_every_updates=8,
                   max_steps=8, hash_times=3)
    leaf = jax.tree.leaves(state.params["hashing"])[0]
    assert not np.allclose(np.asarray(leaf[0]), np.asarray(leaf[1]))


def test_multitable_rejects_extra_model_learners(data, tmp_path):
    hashing = MultivariateBernoulli(MLPEncoder(8, (16,)), 4)
    with pytest.raises(ValueError):
        MultiTableTrainer(AETrainer(hashing, data, str(tmp_path)), 2)
