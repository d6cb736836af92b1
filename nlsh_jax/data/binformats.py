"""big-ann-benchmarks binary formats (fbin / u8bin / i8bin).

The reference declares ``BigANN1B`` and ``Deep1B`` as empty stubs
(``nlsh/data.py:204-209``) — the billion-scale datasets at
big-ann-benchmarks.com ship in these raw binary formats, not hdf5:

* vector files (``.fbin``/``.u8bin``/``.i8bin``): two little-endian
  int32s ``n, d`` followed by ``n*d`` values (float32 / uint8 / int8);
* ground-truth files: int32s ``n, k``, then ``n*k`` int32 neighbour
  ids, then ``n*k`` float32 distances.

Readers memory-map the payload so a 10M-row slice of a billion-row
file costs only the touched pages, and ``max_rows`` bounds what is
materialised.  :class:`BigBinaryDataset` adapts a (base, query, gt)
file triple to the :class:`~nlsh_jax.data.datasets.Dataset` duck used
by trainers and indexers.
"""

from __future__ import annotations

import os

import numpy as np

_DTYPES = {
    ".fbin": np.float32,
    ".u8bin": np.uint8,
    ".i8bin": np.int8,
}


def _dtype_for(path: str):
    for suffix, dt in _DTYPES.items():
        if path.endswith(suffix):
            return np.dtype(dt)
    raise ValueError(
        f"unknown binary vector format {path!r} "
        f"(expected one of {sorted(_DTYPES)})"
    )


def read_bin_header(path: str) -> tuple[int, int]:
    """``(n_rows, dim)`` of a big-ann vector file."""
    with open(path, "rb") as f:
        n, d = np.fromfile(f, dtype="<i4", count=2)
    return int(n), int(d)


def read_bin(path: str, max_rows: int | None = None,
             offset_rows: int = 0) -> np.ndarray:
    """Read ``[offset_rows, offset_rows + max_rows)`` of a vector file
    as float32 ``(rows, dim)`` (the whole file when ``max_rows`` is
    None).  The payload is memory-mapped; only the requested slice is
    copied/converted."""
    dt = _dtype_for(path)
    n, d = read_bin_header(path)
    if offset_rows < 0 or offset_rows > n:
        raise ValueError(f"offset_rows {offset_rows} outside [0, {n}]")
    rows = n - offset_rows if max_rows is None else min(max_rows, n - offset_rows)
    mm = np.memmap(path, dtype=dt, mode="r", offset=8, shape=(n, d))
    return np.asarray(mm[offset_rows:offset_rows + rows], dtype=np.float32)


def write_bin(path: str, arr: np.ndarray) -> None:
    """Write ``(n, d)`` vectors in the format implied by the suffix."""
    dt = _dtype_for(path)
    arr = np.ascontiguousarray(arr, dtype=dt)
    with open(path, "wb") as f:
        np.asarray(arr.shape, dtype="<i4").tofile(f)
        arr.tofile(f)


def read_gt_bin(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a big-ann ground-truth file: ``(ids (n, k) int32,
    distances (n, k) float32)``."""
    with open(path, "rb") as f:
        n, k = (int(x) for x in np.fromfile(f, dtype="<i4", count=2))
        ids = np.fromfile(f, dtype="<i4", count=n * k).reshape(n, k)
        dist = np.fromfile(f, dtype="<f4", count=n * k).reshape(n, k)
    return ids, dist


def write_gt_bin(path: str, ids: np.ndarray, dist: np.ndarray) -> None:
    ids = np.ascontiguousarray(ids, dtype="<i4")
    dist = np.ascontiguousarray(dist, dtype="<f4")
    if ids.shape != dist.shape:
        raise ValueError(f"ids {ids.shape} != distances {dist.shape}")
    with open(path, "wb") as f:
        np.asarray(ids.shape, dtype="<i4").tofile(f)
        ids.tofile(f)
        dist.tofile(f)


class BigBinaryDataset:
    """Dataset over big-ann binary files (the scale axis the reference
    stubs at ``nlsh/data.py:204-209``).

    Args:
      base_path: ``.fbin``/``.u8bin``/``.i8bin`` corpus vectors.
      query_path: query vectors (same formats).
      gt_path: optional big-ann ground-truth file; when absent,
        ``ground_truth`` raises (precompute it with
        :func:`nlsh_jax.ops.knn.knn` and :func:`write_gt_bin`).
      max_rows: bound the corpus slice (e.g. 10M of BigANN-1B).
      metric: rerank metric ("euclidean" for BigANN/SIFT-style u8bin,
        "cosine" for normalised deep features).
      unit_ball: L2-normalise rows after load (Deep1B convention).
    """

    def __init__(self, base_path: str, query_path: str,
                 gt_path: str | None = None, max_rows: int | None = None,
                 metric: str = "euclidean", unit_ball: bool = False):
        self._base_path = base_path
        self._query_path = query_path
        self._gt_path = gt_path
        self._max_rows = max_rows
        self.metric = metric
        self._unit_ball = unit_ball
        self._prepared = False

    def load(self):
        from nlsh_jax.data.datasets import norm_to_unit_sphere

        self._training = read_bin(self._base_path, max_rows=self._max_rows)
        self._testing = read_bin(self._query_path)
        if self._unit_ball:
            self._training = norm_to_unit_sphere(self._training)
            self._testing = norm_to_unit_sphere(self._testing)
        if self._gt_path and os.path.exists(self._gt_path):
            self._ground_truth, _ = read_gt_bin(self._gt_path)
        else:
            self._ground_truth = None
        self._training_self_knn = None
        self._dim = self._training.shape[1]
        self._prepared = True
        return self

    def _check_prepared(self):
        if not self._prepared:
            raise ValueError(
                f"{type(self).__name__} is not prepared. call `load` "
                "beforehand."
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
        if self._ground_truth is None:
            raise ValueError(
                f"no ground-truth file for {self._base_path!r} — "
                "precompute with nlsh_jax.ops.knn.knn + write_gt_bin"
            )
        return self._ground_truth

    @property
    def training_self_knn(self) -> np.ndarray:
        self._check_prepared()
        raise ValueError(
            "big binary datasets carry no self-kNN; train on a subset "
            "(see benchmarks/configs.py config_5) or precompute one"
        )
