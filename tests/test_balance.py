"""Bucket-balance regulariser tests."""

import jax
import jax.numpy as jnp
import numpy as np

from nlsh_jax.data import SyntheticDataset
from nlsh_jax.index.bucket_table import build_bucket_table
from nlsh_jax.index.indexer import hash_corpus
from nlsh_jax.models.encoders import MLPEncoder
from nlsh_jax.models.hashings import MultivariateBernoulli
from nlsh_jax.ops.code_distances import bucket_balance_loss
from nlsh_jax.train import TripletTrainer


def test_balance_loss_zero_on_uniform():
    # KL term alone: uniform soft histogram -> 0
    probs = jnp.full((64, 4), 0.5)
    assert abs(float(bucket_balance_loss(probs, confidence_weight=0.0))) < 1e-4
    # the confidence term penalises the soft (max-entropy) solution
    assert float(bucket_balance_loss(probs)) > 0.5


def test_balance_loss_positive_on_collapse():
    probs = jnp.full((64, 4), 0.999)  # everything in one bucket
    v = float(bucket_balance_loss(probs))
    # collapsed -> KL approaches log(n_buckets) = log 16
    assert v > 2.0


def test_balance_loss_differentiable():
    g = jax.grad(lambda p: bucket_balance_loss(jax.nn.sigmoid(p)))(
        jnp.ones((8, 5))
    )
    assert np.isfinite(np.asarray(g)).all()


def test_balance_regulariser_flattens_table(tmp_path):
    data = SyntheticDataset(n_train=2048, n_test=64, dim=8, n_clusters=4,
                            metric="cosine", k_ground_truth=10, seed=0).load()
    # few clusters + small table -> unregularised training collapses
    # onto few buckets

    def train(balance):
        hashing = MultivariateBernoulli(MLPEncoder(8, (32,)), 6)
        tr = TripletTrainer(hashing, data, str(tmp_path), positive_k=5,
                            margin=0.5, balance_lambda=balance)
        state = tr.fit(K=5, batch_size=256, learning_rate=3e-3, epochs=80,
                       test_every_updates=10**9, max_steps=400, hash_times=3)
        codes = hash_corpus(hashing, state.params["hashing"],
                            jnp.asarray(data.training))
        return build_bucket_table(codes, hashing.n_buckets)

    t_plain = train(0.0)
    t_bal = train(3.0)
    # measured: max bucket ~507 -> ~122, occupied buckets 12 -> 60
    assert int(t_bal.max_count()) < int(t_plain.max_count()) // 2
    assert int(t_bal.n_nonempty()) > int(t_plain.n_nonempty())
