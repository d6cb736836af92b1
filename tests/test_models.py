"""Tests for encoders and hashing heads."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nlsh_jax.models.encoders import MLPEncoder, SirenEncoder, TwoLayer256Relu, get_encoder
from nlsh_jax.models.hashings import Categorical, MultivariateBernoulli, get_hashing
from nlsh_jax.ops.packing import pack_bits


@pytest.fixture
def x():
    rng = np.random.default_rng(0)
    return jnp.asarray(rng.normal(size=(32, 10)).astype(np.float32))


def test_mlp_encoder_shapes(x):
    enc = MLPEncoder(input_dim=10, hidden_dims=(64, 32))
    params = enc.init(jax.random.PRNGKey(0))
    out = enc.apply(params, x)
    assert out.shape == (32, 32)
    assert (np.asarray(out) >= 0).all()  # relu output


def test_two_layer_256(x):
    enc = TwoLayer256Relu(input_dim=10)
    assert enc.output_dim == 256
    out = enc.apply(enc.init(jax.random.PRNGKey(0)), x)
    assert out.shape == (32, 256)


def test_siren_encoder(x):
    enc = SirenEncoder(input_dim=10, hidden_dims=(64, 64, 16))
    out = enc.apply(enc.init(jax.random.PRNGKey(0)), x)
    assert out.shape == (32, 16)
    assert np.isfinite(np.asarray(out)).all()


def test_encoder_factory():
    e = get_encoder("siren", 10, [32, 32])
    assert isinstance(e, SirenEncoder)
    with pytest.raises(ValueError):
        get_encoder("transformer", 10, [32])


def test_mvb_predict_range_and_hard_hash(x):
    h = MultivariateBernoulli(MLPEncoder(10, (32,)), hash_size=6)
    params = h.init(jax.random.PRNGKey(1))
    p = np.asarray(h.predict(params, x))
    assert ((p > 0) & (p < 1)).all()
    hard = h.hash_hard(params, x)
    assert hard.shape == (32,)
    assert ((np.asarray(hard) >= 0) & (np.asarray(hard) < 64)).all()
    # hard hash must equal packing of thresholded probs
    np.testing.assert_array_equal(
        np.asarray(hard), np.asarray(pack_bits((h.probs(params, x) > 0.5).astype(jnp.int32)))
    )


def test_mvb_tanh_probs_rescaled(x):
    h = MultivariateBernoulli(MLPEncoder(10, (32,)), hash_size=6, tanh_output=True)
    params = h.init(jax.random.PRNGKey(1))
    raw = np.asarray(h.predict(params, x))
    assert ((raw > -1) & (raw < 1)).all()
    p = np.asarray(h.probs(params, x))
    assert ((p > 0) & (p < 1)).all()
    np.testing.assert_allclose(p, raw / 2 + 0.5, rtol=1e-6)


def test_mvb_multiprobe_includes_hard_code(x):
    h = MultivariateBernoulli(MLPEncoder(10, (32,)), hash_size=5)
    params = h.init(jax.random.PRNGKey(2))
    hard = np.asarray(h.hash_hard(params, x))
    ids, valid = h.hash(params, x, n_probes=8, key=jax.random.PRNGKey(3))
    ids, valid = np.asarray(ids), np.asarray(valid)
    assert ids.shape == (32, 8)
    for i in range(32):
        assert hard[i] in set(ids[i][valid[i]].tolist())


def test_mvb_single_probe_deterministic(x):
    h = MultivariateBernoulli(MLPEncoder(10, (32,)), hash_size=5)
    params = h.init(jax.random.PRNGKey(2))
    ids, valid = h.hash(params, x, n_probes=1)
    assert np.asarray(valid).all()
    np.testing.assert_array_equal(np.asarray(ids)[:, 0], np.asarray(h.hash_hard(params, x)))


def test_mvb_requires_key_for_multiprobe(x):
    h = MultivariateBernoulli(MLPEncoder(10, (32,)), hash_size=5)
    params = h.init(jax.random.PRNGKey(2))
    with pytest.raises(ValueError):
        h.hash(params, x, n_probes=3)


def test_mvb_flip_probe_mode(x):
    h = MultivariateBernoulli(MLPEncoder(10, (32,)), hash_size=6)
    params = h.init(jax.random.PRNGKey(2))
    ids, valid = h.hash(params, x, n_probes=8, probe_mode="flip")
    ids, valid = np.asarray(ids), np.asarray(valid)
    assert valid.all()  # flips of distinct masks are distinct buckets
    hard = np.asarray(h.hash_hard(params, x))
    probs = np.asarray(h.probs(params, x))
    for i in range(x.shape[0]):
        row = set(ids[i].tolist())
        assert hard[i] in row
        # every probe differs from the hard code only on the 3 least
        # confident bits (n_probes=8 -> 3 flip bits)
        conf_order = np.argsort(np.abs(probs[i] - 0.5))[:3]
        allowed = 0
        for b in conf_order:
            allowed |= 1 << (6 - 1 - b)
        for v in row:
            assert (v ^ hard[i]) & ~allowed == 0


def test_flip_beats_sampling_on_recall():
    """Deterministic best-first probing should match or beat Bernoulli
    sampling at equal probe count."""
    from nlsh_jax.data import SyntheticDataset
    from nlsh_jax.index import Indexer
    from nlsh_jax.utils.metrics import calculate_recall

    data = SyntheticDataset(n_train=4096, n_test=256, dim=16, n_clusters=64,
                            metric="cosine", k_ground_truth=10, seed=0).load()
    h = MultivariateBernoulli(MLPEncoder(16, (32,)), 7)
    params = h.init(jax.random.PRNGKey(0))
    idx = Indexer(h, params, jnp.asarray(data.training), metric="cosine")
    gt = np.asarray(data.ground_truth)[:, :10]
    t_s, c_s = idx.query(jnp.asarray(data.testing), k=10, hash_times=8,
                         key=jax.random.PRNGKey(1), probe_mode="sample")
    t_f, c_f = idx.query(jnp.asarray(data.testing), k=10, hash_times=8,
                         probe_mode="flip")
    r_s = calculate_recall(gt, t_s, np.mean)
    r_f = calculate_recall(gt, t_f, np.mean)
    # allow small noise, but flip shouldn't lose
    assert r_f >= r_s - 0.02, (r_f, r_s)


def test_categorical_hash(x):
    h = Categorical(MLPEncoder(10, (32,)), hash_size=7)
    assert h.n_buckets == 7
    params = h.init(jax.random.PRNGKey(4))
    p = np.asarray(h.predict(params, x))
    np.testing.assert_allclose(p.sum(-1), 1.0, rtol=1e-5)
    hard = np.asarray(h.hash_hard(params, x))
    np.testing.assert_array_equal(hard, p.argmax(-1))
    ids, valid = h.hash(params, x, n_probes=3)
    assert np.asarray(valid).all()
    for i in range(32):
        assert hard[i] in np.asarray(ids)[i].tolist()


def test_hashing_factory():
    enc = MLPEncoder(10, (16,))
    assert isinstance(get_hashing("MultivariateBernoulli", enc, 4), MultivariateBernoulli)
    assert get_hashing("MultivariateBernoulliTanh", enc, 4).tanh_output
    assert isinstance(get_hashing("Categorical", enc, 4), Categorical)
    with pytest.raises(ValueError):
        get_hashing("SimHash", enc, 4)


def test_product_quantization():
    from nlsh_jax.models.hashings import ProductQuantization, get_hashing

    enc = MLPEncoder(10, (16,))
    pq = get_hashing("ProductQuantization", enc, 8)  # 2 bands x 4 bits
    assert isinstance(pq, ProductQuantization)
    assert pq.n_bands == 2 and pq.bits_per_band == 4
    assert pq.n_buckets == 256

    params = pq.init(jax.random.PRNGKey(0))
    x = jnp.asarray(np.random.default_rng(0).normal(size=(16, 10)).astype(np.float32))
    p = np.asarray(pq.predict(params, x))
    assert p.shape == (16, 2 * 16)
    # per-band probabilities sum to 1
    np.testing.assert_allclose(p.reshape(16, 2, 16).sum(-1), 1.0, rtol=1e-5)

    hard = np.asarray(pq.hash_hard(params, x))
    assert ((hard >= 0) & (hard < 256)).all()
    # hard code = packed per-band argmaxes
    band_arg = p.reshape(16, 2, 16).argmax(-1)
    np.testing.assert_array_equal(hard, band_arg[:, 0] * 16 + band_arg[:, 1])

    ids, valid = pq.hash(params, x, n_probes=5, key=jax.random.PRNGKey(1))
    assert ids.shape == (16, 5)
    for i in range(16):
        assert hard[i] in np.asarray(ids)[i][np.asarray(valid)[i]].tolist()


def test_categorical_nprobes_validation():
    """n_probes < 1 raises; n_probes > n_buckets clamps (excess slots
    masked invalid) instead of crashing inside jit (round-1 advisor)."""
    import jax

    from nlsh_jax.models.encoders import MLPEncoder
    from nlsh_jax.models.hashings import Categorical

    h = Categorical(MLPEncoder(input_dim=8, hidden_dims=(16,)), 4)
    params = h.init(jax.random.PRNGKey(0))
    x = jnp.asarray(np.random.default_rng(0).normal(size=(5, 8)),
                    jnp.float32)
    with pytest.raises(ValueError):
        h.hash(params, x, n_probes=0)
    ids, valid = h.hash(params, x, n_probes=9)  # > 4 buckets
    assert ids.shape == (5, 9) and valid.shape == (5, 9)
    # exactly 4 valid probes per row (all distinct buckets)
    assert np.all(np.asarray(valid.sum(axis=1)) == 4)
    v = np.asarray(valid)
    i = np.asarray(ids)
    for r in range(5):
        assert len(set(i[r][v[r]])) == 4


def test_pq_flip_probes_deterministic_and_superset():
    """Round-5 PQ flip probes: deterministic (no key), probe 0 == hard
    code, all probes distinct, and growing n_probes keeps earlier
    probes as a prefix (supersets, like the MVB bit-flip mode)."""
    import jax
    import jax.numpy as jnp

    from nlsh_jax.models import get_encoder, get_hashing

    pq = get_hashing("ProductQuantization", get_encoder("mlp", 12, [16]), 8)
    params = pq.init(jax.random.PRNGKey(0))
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(64, 12)).astype(np.float32))

    hard = np.asarray(pq.hash_hard(params, x))
    ids4, v4 = pq.hash(params, x, n_probes=4, probe_mode="flip")
    ids8, v8 = pq.hash(params, x, n_probes=8, probe_mode="flip")
    ids4, ids8 = np.asarray(ids4), np.asarray(ids8)
    assert np.asarray(v4).all() and np.asarray(v8).all()
    np.testing.assert_array_equal(ids4[:, 0], hard)  # mask 0 = no swap
    np.testing.assert_array_equal(ids8[:, :4], ids4)  # prefix property
    for i in range(64):  # distinct by construction
        assert len(set(ids8[i])) == 8
    # determinism across calls
    ids4b, _ = pq.hash(params, x, n_probes=4, probe_mode="flip")
    np.testing.assert_array_equal(np.asarray(ids4b), ids4)


def test_pq_flip_probes_lift_recall_of_indexer():
    """Flip probes must find strictly more candidates than the hard
    code alone and lift recall (the point of the playbook)."""
    import jax
    import jax.numpy as jnp

    from nlsh_jax.index import Indexer
    from nlsh_jax.models import get_encoder, get_hashing
    from nlsh_jax.utils.metrics import calculate_recall
    from nlsh_jax.ops.knn import knn

    rng = np.random.default_rng(3)
    pts = rng.normal(size=(4096 + 64, 16)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    corpus, queries = jnp.asarray(pts[:4096]), jnp.asarray(pts[4096:])
    _, gt = knn(queries, corpus, k=5, metric="cosine")
    pq = get_hashing("ProductQuantization", get_encoder("mlp", 16, [16]), 8)
    params = pq.init(jax.random.PRNGKey(1))
    idx = Indexer(pq, params, corpus, engine="xla")
    r = {}
    for ht in (1, 8):
        top, ncand = idx.query(queries, k=5, hash_times=ht,
                               probe_mode="flip",
                               key=jax.random.PRNGKey(2))
        r[ht] = (calculate_recall(np.asarray(gt), top, np.mean),
                 float(np.mean(ncand)))
    assert r[8][1] > r[1][1]  # more candidates probed
    assert r[8][0] >= r[1][0]  # recall monotone in probes


def test_band_balance_loss_prefers_uniform_confident():
    from nlsh_jax.ops.code_distances import band_balance_loss

    # uniform-and-confident: each band's hard assignment spread evenly
    eye = np.eye(4, dtype=np.float32) * 0.97 + 0.01
    balanced = jnp.asarray(np.tile(eye, (8, 1))[:, None, :])  # (32,1,4)
    collapsed = jnp.asarray(np.tile(eye[:1], (32, 1))[:, None, :])
    soft = jnp.full((32, 1, 4), 0.25)
    lb = float(band_balance_loss(balanced))
    lc = float(band_balance_loss(collapsed))
    ls = float(band_balance_loss(soft))
    assert lb < lc  # collapse penalised
    assert lb < ls  # hovering-soft penalised (confidence term)


def test_band_balance_loss_penalises_correlated_bands():
    """Joint-histogram balance (round-5 fix): two per-band-uniform but
    perfectly CORRELATED bands concentrate the joint mass on the
    diagonal (16 of 256 buckets) and must score much worse than
    independent uniform bands — the marginals-only loss cannot see
    this (it produced a 1341/4096-bucket collapse at 1.18M)."""
    from nlsh_jax.ops.code_distances import band_balance_loss

    rng = np.random.default_rng(0)
    n, B = 256, 16
    eye = np.eye(B, dtype=np.float32) * 0.97 + 0.03 / B
    a = rng.integers(0, B, n)
    b = rng.integers(0, B, n)
    independent = jnp.asarray(np.stack([eye[a], eye[b]], axis=1))
    correlated = jnp.asarray(np.stack([eye[a], eye[a]], axis=1))
    li = float(band_balance_loss(independent))
    lc = float(band_balance_loss(correlated))
    assert lc > li + 1.0, (li, lc)
