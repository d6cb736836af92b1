"""Dataset layer tests: hdf5 loading, normalisation variants, retry."""

import numpy as np
import pytest

from nlsh_jax.data import Dataset, Glove, SIFT, SyntheticDataset, get_data_by_id
from nlsh_jax.data.datasets import norm_to_unit_sphere


@pytest.fixture
def h5file(tmp_path):
    import h5py

    rng = np.random.default_rng(0)
    path = str(tmp_path / "toy.hdf5")
    with h5py.File(path, "w") as f:
        f.create_dataset("train", data=rng.normal(size=(100, 8)).astype(np.float32))
        f.create_dataset("test", data=rng.normal(size=(20, 8)).astype(np.float32))
        f.create_dataset("neighbors", data=rng.integers(0, 100, (20, 10)))
        f.create_dataset("train_knn", data=rng.integers(0, 100, (100, 5)))
    return path


def test_dataset_load(h5file):
    d = Glove(h5file)
    assert not d.prepared
    with pytest.raises(ValueError):
        _ = d.training  # must load first (reference data.py:52-55)
    d.load()
    assert d.prepared
    assert d.dim == 8
    assert d.training.shape == (100, 8)
    assert d.training_self_knn.shape == (100, 5)
    assert d.metric == "cosine"
    assert SIFT(h5file).metric == "euclidean"


def test_unit_ball_normalisation(h5file):
    d = Glove(h5file, unit_ball=True).load()
    np.testing.assert_allclose(
        np.linalg.norm(d.training, axis=1), 1.0, rtol=1e-5
    )


def test_unit_norm_standardisation(h5file):
    d = Glove(h5file, unit_norm=True).load()
    np.testing.assert_allclose(d.training.mean(0), 0.0, atol=1e-5)
    np.testing.assert_allclose(d.training.std(0), 1.0, atol=1e-4)


def test_missing_train_knn_raises(tmp_path):
    import h5py

    path = str(tmp_path / "no_knn.hdf5")
    with h5py.File(path, "w") as f:
        f.create_dataset("train", data=np.zeros((4, 2), np.float32))
        f.create_dataset("test", data=np.zeros((2, 2), np.float32))
        f.create_dataset("neighbors", data=np.zeros((2, 2), np.int64))
    d = Glove(path).load()
    with pytest.raises(ValueError, match="train_knn"):
        _ = d.training_self_knn


def test_load_retries_on_transient_error(h5file, monkeypatch):
    import h5py

    d = Glove(h5file)
    monkeypatch.setattr(type(d), "_RETRY_WAIT_S", 0.0)
    calls = {"n": 0}
    real_file = h5py.File

    def flaky(path, mode):
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return real_file(path, mode)

    monkeypatch.setattr(h5py, "File", flaky)
    d.load()
    assert calls["n"] == 3
    assert d.prepared


def test_load_gives_up_after_retries(tmp_path, monkeypatch):
    d = Dataset(str(tmp_path / "missing.hdf5"))
    monkeypatch.setattr(type(d), "_RETRY_WAIT_S", 0.0)
    with pytest.raises(OSError, match="after 3 attempts"):
        d.load()


def test_get_data_by_id_synthetic():
    d = get_data_by_id("synthetic_euclidean")
    assert isinstance(d, SyntheticDataset)
    assert d.metric == "euclidean"
    with pytest.raises(ValueError):
        get_data_by_id("imagenet")


def test_norm_to_unit_sphere():
    x = np.array([[3.0, 4.0], [0.0, 2.0]])
    out = norm_to_unit_sphere(x)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0)


# -- big-ann binary formats (reference stubs BigANN1B/Deep1B, data.py:204-209)

def test_bin_roundtrip_all_formats(tmp_path):
    from nlsh_jax.data.binformats import read_bin, read_bin_header, write_bin

    rng = np.random.default_rng(0)
    for suffix, gen in [
        (".fbin", lambda: rng.normal(size=(37, 5)).astype(np.float32)),
        (".u8bin", lambda: rng.integers(0, 255, (37, 5)).astype(np.uint8)),
        (".i8bin", lambda: rng.integers(-127, 127, (37, 5)).astype(np.int8)),
    ]:
        arr = gen()
        path = str(tmp_path / f"vecs{suffix}")
        write_bin(path, arr)
        assert read_bin_header(path) == (37, 5)
        out = read_bin(path)
        assert out.dtype == np.float32
        np.testing.assert_array_equal(out, arr.astype(np.float32))


def test_bin_slicing(tmp_path):
    from nlsh_jax.data.binformats import read_bin, write_bin

    arr = np.arange(100, dtype=np.float32).reshape(20, 5)
    path = str(tmp_path / "v.fbin")
    write_bin(path, arr)
    np.testing.assert_array_equal(read_bin(path, max_rows=4), arr[:4])
    np.testing.assert_array_equal(
        read_bin(path, max_rows=3, offset_rows=10), arr[10:13])
    np.testing.assert_array_equal(read_bin(path, offset_rows=18), arr[18:])
    with pytest.raises(ValueError):
        read_bin(path, offset_rows=21)
    with pytest.raises(ValueError):
        read_bin(str(path) + ".weird")


def test_gt_bin_roundtrip(tmp_path):
    from nlsh_jax.data.binformats import read_gt_bin, write_gt_bin

    rng = np.random.default_rng(1)
    ids = rng.integers(0, 1000, (8, 10)).astype(np.int32)
    dist = rng.normal(size=(8, 10)).astype(np.float32)
    path = str(tmp_path / "gt.bin")
    write_gt_bin(path, ids, dist)
    ids2, dist2 = read_gt_bin(path)
    np.testing.assert_array_equal(ids2, ids)
    np.testing.assert_array_equal(dist2, dist)


def test_big_binary_dataset(tmp_path):
    from nlsh_jax.data.binformats import (
        BigBinaryDataset, write_bin, write_gt_bin,
    )

    rng = np.random.default_rng(2)
    base = rng.normal(size=(64, 6)).astype(np.float32)
    queries = rng.normal(size=(9, 6)).astype(np.float32)
    gt = rng.integers(0, 64, (9, 5)).astype(np.int32)
    bp, qp, gp = (str(tmp_path / n) for n in
                  ("base.fbin", "q.fbin", "gt.bin"))
    write_bin(bp, base)
    write_bin(qp, queries)
    write_gt_bin(gp, gt, np.zeros((9, 5), np.float32))

    ds = BigBinaryDataset(bp, qp, gp, max_rows=50).load()
    assert ds.dim == 6
    assert ds.training.shape == (50, 6)
    np.testing.assert_array_equal(ds.training, base[:50])
    np.testing.assert_array_equal(ds.testing, queries)
    np.testing.assert_array_equal(ds.ground_truth, gt)
    with pytest.raises(ValueError):
        _ = ds.training_self_knn

    ds2 = BigBinaryDataset(bp, qp, gt_path=None).load()
    with pytest.raises(ValueError):
        _ = ds2.ground_truth


def test_get_data_by_id_bigann(tmp_path, monkeypatch):
    from nlsh_jax.data.binformats import write_bin

    rng = np.random.default_rng(3)
    bp, qp = str(tmp_path / "b.u8bin"), str(tmp_path / "q.u8bin")
    write_bin(bp, rng.integers(0, 255, (30, 4)).astype(np.uint8))
    write_bin(qp, rng.integers(0, 255, (5, 4)).astype(np.uint8))
    monkeypatch.setenv("NLSH_BIGANN_BASE_PATH", bp)
    monkeypatch.setenv("NLSH_BIGANN_QUERY_PATH", qp)
    ds = get_data_by_id("bigann_10K").load()
    assert ds.metric == "euclidean"
    assert ds.training.shape == (30, 4)  # max_rows bounds, file smaller
    assert ds._max_rows == 10_000
