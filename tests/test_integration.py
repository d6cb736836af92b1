"""Cross-component integration tests: PQ end-to-end, training resume."""

import glob

import jax
import jax.numpy as jnp
import numpy as np

from nlsh_jax.data import SyntheticDataset
from nlsh_jax.index import Indexer
from nlsh_jax.models import ProductQuantization, get_encoder
from nlsh_jax.train import TripletTrainer
from nlsh_jax.utils.metrics import calculate_recall


def test_pq_hashing_trains_and_serves(tmp_path):
    """ProductQuantization through the full stack: trainer -> index ->
    multi-probe query."""
    data = SyntheticDataset(n_train=1024, n_test=64, dim=8, n_clusters=16,
                            metric="cosine", k_ground_truth=10, seed=0).load()
    pq = ProductQuantization(get_encoder("mlp", 8, [32]), n_bands=2,
                             bits_per_band=3)
    tr = TripletTrainer(pq, data, str(tmp_path), positive_k=5, margin=0.5)
    state = tr.fit(K=5, batch_size=128, learning_rate=3e-3, epochs=5,
                   test_every_updates=16, max_steps=32, hash_times=3)

    idx = Indexer(pq, state.params["hashing"], jnp.asarray(data.training),
                  metric="cosine")
    top, ncand = idx.query(jnp.asarray(data.testing), k=5, hash_times=4,
                           key=jax.random.PRNGKey(1))
    recall = calculate_recall(np.asarray(data.ground_truth)[:, :5], top, np.mean)
    assert 0.0 <= recall <= 1.0
    assert (ncand >= 1).all()
    # corpus rows retrieve themselves via their hard bucket
    t_self, _ = idx.query(jnp.asarray(data.training[:16]), k=1, hash_times=1)
    assert (t_self[:, 0] == np.arange(16)).all()


def test_training_resume_continues(tmp_path):
    """Optimizer-state resume: a checkpointed run continues from its
    saved step with identical parameters at the handoff."""
    data = SyntheticDataset(n_train=512, n_test=32, dim=8, metric="cosine",
                            k_ground_truth=10, seed=0).load()

    from nlsh_jax.models.encoders import MLPEncoder
    from nlsh_jax.models.hashings import MultivariateBernoulli

    hashing = MultivariateBernoulli(MLPEncoder(8, (16,)), 4)
    tr = TripletTrainer(hashing, data, str(tmp_path), positive_k=5)
    state1 = tr.fit(K=5, batch_size=64, epochs=1, test_every_updates=4,
                    max_steps=4, hash_times=3, seed=7)
    assert int(state1.step) == 4
    ckpts = sorted(glob.glob(str(tmp_path / "*.state.npz")))
    assert ckpts

    hashing2 = MultivariateBernoulli(MLPEncoder(8, (16,)), 4)
    tr2 = TripletTrainer(hashing2, data, str(tmp_path), positive_k=5)
    state2 = tr2.fit(K=5, batch_size=64, epochs=1, test_every_updates=100,
                     max_steps=6, hash_times=3, seed=7,
                     resume_from=ckpts[-1])
    # resumed from step 4, ran to max_steps 6
    assert int(state2.step) == 6
    for a, b in zip(jax.tree.leaves(state1.params),
                    jax.tree.leaves(state2.params)):
        assert a.shape == b.shape
