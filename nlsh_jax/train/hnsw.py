"""HNSW baseline (reference ``nlsh/trainers/hnsw.py``) — a non-learned
comparison point.

Backends, in preference order:

* the external C++ ``hnswlib`` when importable (gated optional dep) —
  the reference's exact dependency;
* the in-repo native C++ implementation
  (:class:`nlsh_jax.native.NativeHNSW`, ``native/hnsw.cpp``) — same
  algorithm, same hyper-parameter surface, built with the system
  toolchain, so the baseline is measurable in images where pip is
  unavailable (this one).  It also returns per-query visited counts,
  the ``query_size`` channel the reference could only get from an
  hnswlib *fork* (``hnsw.py:52``); with stock hnswlib that channel is
  logged as NaN.

An always-available exact baseline lives at
:func:`nlsh_jax.ops.knn.knn` (brute force on the accelerator).
"""

from __future__ import annotations

import time

import numpy as np

from nlsh_jax.utils.loggers import NullLogger
from nlsh_jax.utils.metrics import calculate_recall


class HNSWBaseline:
    """Reference ``HierarchicalNavigableSmallWorldGraph``
    (hnsw.py:12-63): cosine index, M=10, ef_construction=500, ef=40."""

    def __init__(
        self,
        data,
        logger=None,
        max_connections: int = 10,
        ef_construction: int = 500,
        ef: int = 40,
        **_: object,
    ):
        try:
            import hnswlib

            self._make_index = hnswlib.Index
            self.backend = "hnswlib"
        except ImportError:
            from nlsh_jax import native
            from nlsh_jax.native import NativeHNSW

            native._get_lib()  # attempt the build so HAVE_NATIVE is current
            if not native.HAVE_NATIVE:
                raise ImportError(
                    "HNSWBaseline needs either the optional `hnswlib` "
                    "package or a C++ toolchain for the in-repo backend"
                )
            self._make_index = NativeHNSW
            self.backend = "native"

        self.data = data
        self.logger = logger or NullLogger()
        if not self.data.prepared:
            self.data.load()

        self.candidate_vectors = self.data.training
        self.validation_data = self.data.testing
        self.ground_truth = self.data.ground_truth[:, :10]

        space = "cosine" if self.data.metric == "cosine" else "l2"
        self.index = self._make_index(space=space,
                                      dim=self.candidate_vectors.shape[1])
        self.index.init_index(
            max_elements=self.candidate_vectors.shape[0],
            M=max_connections,
            ef_construction=ef_construction,
        )
        self.index.set_ef(ef)

    def fit(self, K: int = 10, batch_size: int = 4096, **_: object):
        n = self.candidate_vectors.shape[0]
        idxs = np.arange(n)
        np.random.shuffle(idxs)
        for start in range(0, n, batch_size):
            sel = idxs[start : start + batch_size]
            self.index.add_items(self.candidate_vectors[sel, :], sel)

        t1 = time.perf_counter()
        out = self.index.knn_query(self.validation_data, k=K)
        t2 = time.perf_counter()
        if len(out) == 3:  # forked hnswlib with visit counts (hnsw.py:52)
            predict_knns, _, counts = out
            query_size = float(np.mean(counts))
        else:
            predict_knns, _ = out
            query_size = float("nan")

        recall = calculate_recall(self.ground_truth[:, :K], predict_knns, np.mean)
        self.logger.log("test/recall", recall, 1)
        self.logger.log("test/query_size", query_size, 1)
        self.logger.log("test/qps", self.validation_data.shape[0] / (t2 - t1), 1)
        return recall
