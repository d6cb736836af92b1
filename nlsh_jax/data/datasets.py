"""ann-benchmarks-style datasets.

JAX counterpart of the reference ``nlsh/data.py``: hdf5 files
with ``train`` / ``test`` / ``neighbors`` (+ ``distances``) datasets and
an optional precomputed ``train_knn`` self-kNN (written by
:mod:`nlsh_jax.data.precompute`).  One generic :class:`Dataset` carries
the per-dataset metric (cosine for Glove, euclidean for SIFT —
reference ``data.py:91-110,178-201``) plus the two normalisation
variants (``unit_norm`` standardise, ``unit_ball`` L2-normalise —
``data.py:28-36``).  A :class:`SyntheticDataset` generates clustered
Gaussian data with exact GT on the fly for tests and benchmarks.
"""

from __future__ import annotations

import numpy as np

from nlsh_jax.utils.env import get_env

_METRIC_BY_FAMILY = {"glove": "cosine", "sift": "euclidean"}


def norm_to_unit_sphere(arr: np.ndarray) -> np.ndarray:
    """Reference ``norm_to_unit_sphere`` (``data.py:9-10``)."""
    return arr / np.linalg.norm(arr, axis=1)[:, np.newaxis]


class Dataset:
    """hdf5-backed dataset with lazy :meth:`load` (reference
    ``Glove``/``SIFT``, ``data.py:14-201``, unified — the two reference
    classes are copy-paste twins differing only in metric)."""

    def __init__(
        self,
        path: str,
        metric: str = "cosine",
        unit_norm: bool = False,
        unit_ball: bool = False,
    ):
        self._path = path
        self.metric = metric
        self._unit_norm = unit_norm
        self._unit_ball = unit_ball
        self._prepared = False

    # retry policy the reference left as a TODO (data.py:20,116)
    _LOAD_RETRIES = 3
    _RETRY_WAIT_S = 5.0

    def load(self):
        import time

        import h5py

        last_err = None
        for attempt in range(self._LOAD_RETRIES):
            try:
                with h5py.File(self._path, "r") as f:
                    self._training = np.asarray(f["train"], dtype=np.float32)
                    self._testing = np.asarray(f["test"], dtype=np.float32)
                    self._ground_truth = np.asarray(f["neighbors"])
                    self._training_self_knn = (
                        np.asarray(f["train_knn"]) if "train_knn" in f else None
                    )
                break
            except OSError as e:  # transient FS/NFS errors
                last_err = e
                if attempt + 1 < self._LOAD_RETRIES:
                    time.sleep(self._RETRY_WAIT_S)
        else:
            raise OSError(
                f"failed to read {self._path} after {self._LOAD_RETRIES} attempts"
            ) from last_err

        if self._unit_norm:
            mean = self._training.mean(0)
            std = self._training.std(0)
            self._training = (self._training - mean) / std
            self._testing = (self._testing - mean) / std
        if self._unit_ball:
            self._training = norm_to_unit_sphere(self._training)
            self._testing = norm_to_unit_sphere(self._testing)

        self._dim = self._training.shape[1]
        self._prepared = True
        return self

    def _check_prepared(self):
        if not self._prepared:
            raise ValueError(
                f"{type(self).__name__} is not prepared. call `load` beforehand."
            )

    @property
    def prepared(self) -> bool:
        return self._prepared

    @property
    def dim(self) -> int:
        self._check_prepared()
        return self._dim

    @property
    def training(self) -> np.ndarray:
        self._check_prepared()
        return self._training

    @property
    def testing(self) -> np.ndarray:
        self._check_prepared()
        return self._testing

    @property
    def ground_truth(self) -> np.ndarray:
        self._check_prepared()
        return self._ground_truth

    @property
    def training_self_knn(self) -> np.ndarray:
        self._check_prepared()
        if self._training_self_knn is None:
            raise ValueError(
                "train_knn missing — run `python precompute.py <data_id>` first "
                "(reference parity: data.py:41-45)"
            )
        return self._training_self_knn


def Glove(path: str, unit_norm: bool = False, unit_ball: bool = False) -> Dataset:
    """Cosine-metric dataset (reference ``Glove``, data.py:14-109)."""
    return Dataset(path, metric="cosine", unit_norm=unit_norm, unit_ball=unit_ball)


def SIFT(path: str, unit_norm: bool = False) -> Dataset:
    """Euclidean-metric dataset (reference ``SIFT``, data.py:112-201)."""
    return Dataset(path, metric="euclidean", unit_norm=unit_norm)


class SyntheticDataset(Dataset):
    """Clustered Gaussian data with brute-force ground truth, for tests
    and for benchmarking without ann-benchmarks files on disk.

    The cluster structure gives a learned hashing something to learn,
    unlike uniform noise.
    """

    def __init__(
        self,
        n_train: int = 4096,
        n_test: int = 256,
        dim: int = 32,
        n_clusters: int = 64,
        metric: str = "cosine",
        k_ground_truth: int = 100,
        seed: int = 0,
        unit_ball: bool = True,
        compute_self_knn: bool = True,
    ):
        super().__init__(path="<synthetic>", metric=metric)
        self._cfg = dict(
            n_train=n_train,
            n_test=n_test,
            dim=dim,
            n_clusters=n_clusters,
            k=k_ground_truth,
            seed=seed,
            unit_ball=unit_ball,
            compute_self_knn=compute_self_knn,
        )

    def _cache_path(self):
        """On-disk cache of the (deterministic) generated arrays + GT:
        the brute-force kNN is recomputed bit-identically on every
        load, which costs minutes per benchmark run at large sizes.  Disable by setting
        ``NLSH_SYNTH_CACHE_DIR=``."""
        import os

        cache_dir = os.environ.get("NLSH_SYNTH_CACHE_DIR",
                                   "/tmp/nlsh_synth_cache")
        if not cache_dir:
            return None
        c = self._cfg
        key = "_".join(
            str(c[f]) for f in ("n_train", "n_test", "dim", "n_clusters",
                                "k", "seed", "unit_ball",
                                "compute_self_knn")
        )
        # v2: GT/self-kNN computed at matmul precision "highest" (true
        # f32) — the v1 caches held single-pass-bf16-ranked neighbours,
        # which scramble the rank-k boundary on near-tied data
        return os.path.join(cache_dir, f"synth_{self.metric}_{key}_v2.npz")

    def load(self):
        import os

        from nlsh_jax.ops.knn import knn, self_knn

        c = self._cfg
        cache = self._cache_path()
        if cache and os.path.exists(cache):
            z = np.load(cache)
            self._training = z["training"]
            self._testing = z["testing"]
            self._ground_truth = z["ground_truth"]
            self._training_self_knn = (
                z["training_self_knn"] if "training_self_knn" in z else None
            )
            self._dim = c["dim"]
            self._prepared = True
            return self

        rng = np.random.default_rng(c["seed"])
        centers = rng.normal(size=(c["n_clusters"], c["dim"])).astype(np.float32)
        assign = rng.integers(0, c["n_clusters"], size=c["n_train"] + c["n_test"])
        pts = centers[assign] + 0.15 * rng.normal(
            size=(c["n_train"] + c["n_test"], c["dim"])
        ).astype(np.float32)
        if c["unit_ball"]:
            pts = norm_to_unit_sphere(pts).astype(np.float32)

        self._training = pts[: c["n_train"]]
        self._testing = pts[c["n_train"] :]
        k = min(c["k"], c["n_train"] - 1)
        _, gt = knn(self._testing, self._training, k=k, metric=self.metric)
        self._ground_truth = np.asarray(gt)
        if c["compute_self_knn"]:
            self._training_self_knn = np.asarray(
                self_knn(self._training, k=k, metric=self.metric)
            )
        else:
            self._training_self_knn = None
        self._dim = c["dim"]
        self._prepared = True
        if cache:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            arrays = dict(training=self._training, testing=self._testing,
                          ground_truth=self._ground_truth)
            if self._training_self_knn is not None:
                arrays["training_self_knn"] = self._training_self_knn
            np.savez(cache, **arrays)
        return self


def get_data_by_id(data_id: str) -> Dataset:
    """Resolve a data id like ``glove_100_norm_sphere`` to a dataset,
    mirroring the reference's substring-flag scheme
    (``main.py:41-54``): paths come from ``NLSH_PROCESSED_<NAME>_PATH``
    env vars / ``.env``; ``norm`` enables standardisation, ``sphere``
    L2-normalisation.  ``synthetic[_<metric>]`` is new here.
    """
    parts = data_id.split("_")
    family = parts[0]
    if family == "synthetic":
        metric = parts[1] if len(parts) > 1 else "cosine"
        return SyntheticDataset(metric=metric)
    if family == "glove":
        glove_dim = parts[1]
        assert glove_dim in ("25", "50", "100", "200"), data_id
        path = get_env(f"NLSH_PROCESSED_GLOVE_{glove_dim}_PATH")
        return Glove(path, unit_norm="norm" in data_id, unit_ball="sphere" in data_id)
    if family == "sift":
        path = get_env("NLSH_PROCESSED_SIFT_PATH")
        return SIFT(path, unit_norm="norm" in data_id)
    if family in ("bigann", "deep"):
        # the scale axis the reference stubs (BigANN1B/Deep1B,
        # data.py:204-209): raw big-ann binary files, optional row
        # bound as a suffix (``bigann_10M``, ``deep_100M``)
        from nlsh_jax.data.binformats import BigBinaryDataset

        max_rows = None
        if len(parts) > 1:
            import re

            m = re.fullmatch(r"(\d+)([KMB]?)", parts[1].upper())
            if m is None:
                raise ValueError(
                    f"unknown data id {data_id!r}: size suffix "
                    f"{parts[1]!r} must match <digits>[K|M|B] "
                    "(e.g. bigann_10M)"
                )
            mult = {"": 1, "K": 10**3, "M": 10**6, "B": 10**9}[m.group(2)]
            max_rows = int(m.group(1)) * mult
        name = family.upper()
        return BigBinaryDataset(
            base_path=get_env(f"NLSH_{name}_BASE_PATH"),
            query_path=get_env(f"NLSH_{name}_QUERY_PATH"),
            gt_path=get_env(f"NLSH_{name}_GT_PATH", None),
            max_rows=max_rows,
            metric="euclidean",
            unit_ball=family == "deep",
        )
    raise ValueError(f"unknown data id {data_id!r}")
