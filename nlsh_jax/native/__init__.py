"""Native host kernels: C++ pack/dedupe + CSR build.

The reference compiles a Cython kernel at import time via ``pyximport``
(``nlsh/__init__.py:1-3``); here a small C++ library is built once with
the system toolchain and cached next to the source.  Two access paths:

* **ctypes** — :func:`pack_codes`, :func:`hash_codes`,
  :func:`build_csr`: plain numpy in/out for host-side pipelines
  (offline index build on CPU, eval tooling).
* **XLA FFI** — :func:`pack_dedupe_ffi`, :func:`build_csr_ffi`: the same
  kernels registered as XLA custom calls on the CPU platform, callable
  under ``jit``.

Everything degrades gracefully: if no C++ toolchain is available the
numpy/jnp fallbacks are used and :data:`HAVE_NATIVE` is False.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).parent / "nlsh_native.cpp"
_HNSW_SRC = Path(__file__).parent / "hnsw.cpp"
_LIB_DIR = Path(
    os.environ.get("NLSH_NATIVE_CACHE", Path.home() / ".cache" / "nlsh_jax")
)
_lock = threading.Lock()
_lib = None
_build_error: str | None = None
_ffi_registered = False

HAVE_NATIVE = False


def _build_library() -> Path | None:
    """Compile the shared library if needed; returns its path or None."""
    global _build_error
    import jax.ffi

    _LIB_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = _LIB_DIR / "libnlsh_native.so"
    srcs = [_SRC, _HNSW_SRC]
    if lib_path.exists() and lib_path.stat().st_mtime >= max(
        s.stat().st_mtime for s in srcs
    ):
        return lib_path
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O3", "-shared", "-fPIC", "-std=c++17",
        f"-I{jax.ffi.include_dir()}",
        *[str(s) for s in srcs], "-o", str(lib_path),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        _build_error = getattr(e, "stderr", str(e)) or str(e)
        print(f"nlsh_jax: native build failed, using fallbacks:\n{_build_error}",
              file=sys.stderr)
        return None
    return lib_path


def _get_lib():
    global _lib, HAVE_NATIVE
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        path = _build_library()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.nlsh_pack_codes.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.nlsh_pack_dedupe.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.nlsh_build_csr.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.nlsh_hnsw_create.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
        ]
        lib.nlsh_hnsw_create.restype = ctypes.c_void_p
        lib.nlsh_hnsw_free.argtypes = [ctypes.c_void_p]
        lib.nlsh_hnsw_add.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.nlsh_hnsw_add.restype = ctypes.c_int64
        lib.nlsh_hnsw_count.argtypes = [ctypes.c_void_p]
        lib.nlsh_hnsw_count.restype = ctypes.c_int64
        lib.nlsh_hnsw_search.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
        HAVE_NATIVE = True
        return _lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


# ---------------------------------------------------------------------------
# ctypes path (numpy in / numpy out)
# ---------------------------------------------------------------------------

def pack_codes(codes: np.ndarray) -> np.ndarray:
    """Pack ``(..., bits)`` {0,1} int32 codes -> ``(...,)`` int32 ids
    (MSB-first; reference ``binarr_to_int``, utils.pyx:7-15)."""
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    bits = codes.shape[-1]
    lead = codes.shape[:-1]
    lib = _get_lib()
    if lib is None:
        w = (2 ** np.arange(bits - 1, -1, -1, dtype=np.int64)).astype(np.int32)
        return (codes * w).sum(-1).astype(np.int32)
    flat = codes.reshape(-1, bits)
    out = np.empty((flat.shape[0],), dtype=np.int32)
    lib.nlsh_pack_codes(_ptr(flat), flat.shape[0], bits, _ptr(out))
    return out.reshape(lead)


def hash_codes(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pack + per-row sorted dedupe of ``(n, p, bits)`` codes ->
    ``(ids (n, p) int32, valid (n, p) bool)`` — bit-exact with the
    jitted :func:`nlsh_jax.ops.packing.hash_codes` and set-equal with
    the reference Cython ``hash_codes`` (utils.pyx:19-32)."""
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    n, p, bits = codes.shape
    lib = _get_lib()
    if lib is None:
        ids = np.sort(pack_codes(codes), axis=-1)
        valid = np.concatenate(
            [np.ones((n, 1), bool), ids[:, 1:] != ids[:, :-1]], axis=1
        )
        return ids, valid
    ids = np.empty((n, p), dtype=np.int32)
    valid = np.empty((n, p), dtype=np.uint8)
    lib.nlsh_pack_dedupe(_ptr(codes), n, p, bits, _ptr(ids), _ptr(valid))
    return ids, valid.astype(bool)


def build_csr(bucket_ids: np.ndarray, n_buckets: int):
    """Host CSR bucket-table build; returns ``(row_ids, starts, counts)``
    matching :func:`nlsh_jax.index.bucket_table.build_bucket_table`."""
    bucket_ids = np.ascontiguousarray(bucket_ids, dtype=np.int32)
    n = bucket_ids.shape[0]
    lib = _get_lib()
    if lib is None:
        counts = np.bincount(
            bucket_ids[(bucket_ids >= 0) & (bucket_ids < n_buckets)],
            minlength=n_buckets,
        ).astype(np.int32)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
        in_range = (bucket_ids >= 0) & (bucket_ids < n_buckets)
        keys = np.where(in_range, bucket_ids, n_buckets)
        order = np.argsort(keys, kind="stable").astype(np.int32)
        return order, starts, counts
    row_ids = np.empty((n,), dtype=np.int32)
    starts = np.empty((n_buckets,), dtype=np.int32)
    counts = np.empty((n_buckets,), dtype=np.int32)
    lib.nlsh_build_csr(_ptr(bucket_ids), n, n_buckets,
                       _ptr(row_ids), _ptr(starts), _ptr(counts))
    return row_ids, starts, counts


# ---------------------------------------------------------------------------
# XLA FFI path (CPU platform, under jit)
# ---------------------------------------------------------------------------

def _register_ffi() -> bool:
    global _ffi_registered
    if _ffi_registered:
        return True
    if _get_lib() is None:
        return False
    import jax.ffi

    lib = _lib
    for py_name, sym in (("nlsh_pack_dedupe_ffi", "NlshPackDedupe"),
                         ("nlsh_build_csr_ffi", "NlshBuildCsr")):
        handler = jax.ffi.pycapsule(getattr(lib, sym))
        jax.ffi.register_ffi_target(py_name, handler, platform="cpu")
    _ffi_registered = True
    return True


def pack_dedupe_ffi(codes):
    """Jit-compatible XLA custom call (CPU): ``(n, p, bits)`` int32 ->
    ``(ids (n, p) int32, valid (n, p) bool)``."""
    import jax
    import jax.numpy as jnp

    if not _register_ffi():
        raise RuntimeError(f"native library unavailable: {_build_error}")
    n, p, _ = codes.shape
    return jax.ffi.ffi_call(
        "nlsh_pack_dedupe_ffi",
        (jax.ShapeDtypeStruct((n, p), jnp.int32),
         jax.ShapeDtypeStruct((n, p), jnp.bool_)),
    )(codes.astype(jnp.int32))


def build_csr_ffi(bucket_ids, n_buckets: int):
    """Jit-compatible XLA custom call (CPU): CSR build."""
    import jax
    import jax.numpy as jnp

    if not _register_ffi():
        raise RuntimeError(f"native library unavailable: {_build_error}")
    (n,) = bucket_ids.shape
    return jax.ffi.ffi_call(
        "nlsh_build_csr_ffi",
        (jax.ShapeDtypeStruct((n,), jnp.int32),
         jax.ShapeDtypeStruct((n_buckets,), jnp.int32),
         jax.ShapeDtypeStruct((n_buckets,), jnp.int32)),
    )(bucket_ids.astype(jnp.int32))


# ---------------------------------------------------------------------------
# Native HNSW baseline (hnsw.cpp) — hnswlib-shaped API
# ---------------------------------------------------------------------------

class NativeHNSW:
    """In-repo HNSW graph index (``hnsw.cpp``) with the subset of the
    hnswlib API the baseline trainer uses (reference
    ``nlsh/trainers/hnsw.py:28-63``): ``init_index`` / ``add_items`` /
    ``set_ef`` / ``knn_query``.  ``knn_query`` returns
    ``(ids, dists, counts)`` — per-query DISTANCE-EVALUATION counts
    (upper-layer descent re-evaluations included; see ``hnsw.cpp``
    ``visit_count``), the ``query_size`` channel the reference could
    only get from an hnswlib fork (``hnsw.py:52``).

    Labels: external int labels are mapped through an internal dense
    id space (insert order), like hnswlib's label lookup."""

    def __init__(self, space: str, dim: int):
        if space not in ("cosine", "l2"):
            raise ValueError(f"unknown space {space!r}")
        self.space = space
        self.dim = dim
        self._h = None
        self._labels: np.ndarray | None = None
        self._n = 0
        self.ef = 10

    def init_index(self, max_elements: int, M: int = 10,
                   ef_construction: int = 500, seed: int = 100):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_build_error}")
        if self._h is not None:  # re-init: drop the old graph + mapping
            lib.nlsh_hnsw_free(self._h)
            self._h = None
            self._n = 0
        self.ef = 10  # hnswlib parity: init_index resets to the default ef
        self._h = lib.nlsh_hnsw_create(
            self.dim, 0 if self.space == "cosine" else 1,
            int(max_elements), int(M), int(ef_construction), int(seed),
        )
        if self._h is None:  # C side rejects capacities the uint32 ids can't hold
            raise ValueError(
                f"max_elements must be in [1, 2**32 - 1), got {max_elements}"
            )
        self._labels = np.empty(int(max_elements), dtype=np.int64)

    def set_ef(self, ef: int):
        self.ef = int(ef)

    def add_items(self, data: np.ndarray, labels=None):
        if self._h is None:
            raise RuntimeError("init_index first")
        data = np.ascontiguousarray(data, dtype=np.float32)
        if data.ndim != 2 or data.shape[1] != self.dim:
            raise ValueError(f"expected (n, {self.dim}) data, "
                             f"got {data.shape}")
        n = data.shape[0]
        if labels is None:
            labels = np.arange(self._n, self._n + n, dtype=np.int64)
        labels = np.asarray(labels, dtype=np.int64)
        if labels.shape != (n,):
            raise ValueError(f"expected {n} labels, got {labels.shape}")
        new_n = _get_lib().nlsh_hnsw_add(self._h, _ptr(data), n)
        if new_n < 0:
            raise RuntimeError("index full (max_elements exceeded)")
        self._labels[self._n:self._n + n] = labels
        self._n = int(new_n)

    def get_current_count(self) -> int:
        return self._n

    def knn_query(self, queries: np.ndarray, k: int = 10):
        if self._h is None:
            raise RuntimeError("init_index first")
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        if queries.ndim != 2 or queries.shape[1] != self.dim:
            raise ValueError(f"expected (n, {self.dim}) queries, "
                             f"got {queries.shape}")
        nq = queries.shape[0]
        ids = np.empty((nq, k), dtype=np.int64)
        dists = np.empty((nq, k), dtype=np.float32)
        counts = np.empty((nq,), dtype=np.int64)
        _get_lib().nlsh_hnsw_search(
            self._h, _ptr(queries), nq, int(k), int(self.ef),
            _ptr(ids), _ptr(dists), _ptr(counts),
        )
        found = ids >= 0
        ids[found] = self._labels[ids[found]]
        return ids, dists, counts

    def __del__(self):
        h, self._h = self._h, None
        if h is not None and _lib is not None:
            _lib.nlsh_hnsw_free(h)
