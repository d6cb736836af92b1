"""Ground-truth precompute CLI.

Re-design of reference ``precompute.py``: self-kNN (k=100) of the
training set as a tiled brute-force distance matmul + running top-k on
the accelerator (:func:`nlsh_jax.ops.knn.self_knn`) instead of batched GPU
``topk(k+1)[:, 1:]``.  Writes the same ``.processed`` hdf5 layout
(``train``, ``train_knn``, ``test``, ``neighbors``, ``distances`` —
reference ``precompute.py:89-98``).
"""

from __future__ import annotations

import argparse
import sys

import jax.numpy as jnp
import numpy as np

from nlsh_jax.ops.knn import self_knn
from nlsh_jax.utils.env import get_env

# reference DATA_PATHS (precompute.py:12-19)
DATA_PATH_KEYS = {
    "glove_25": "NLSH_GLOVE_25_PATH",
    "glove_50": "NLSH_GLOVE_50_PATH",
    "glove_100": "NLSH_GLOVE_100_PATH",
    "glove_200": "NLSH_GLOVE_200_PATH",
    "sift": "NLSH_SIFT_PATH",
}

# reference DISTANCE_FUNC (precompute.py:70-76); sq_euclidean ranks
# identically to the reference's sqrt-free _l2
METRIC_BY_KEY = {
    "glove_25": "cosine",
    "glove_50": "cosine",
    "glove_100": "cosine",
    "glove_200": "cosine",
    "sift": "sq_euclidean",
}


def precompute(data_path: str, metric: str, k: int = 100,
               out_path: str | None = None) -> str:
    import h5py

    with h5py.File(data_path, "r") as f:
        train = np.asarray(f["train"], dtype=np.float32)
        test = np.asarray(f["test"])
        neighbors = np.asarray(f["neighbors"])
        distances = np.asarray(f["distances"]) if "distances" in f else None

    train_knn = np.asarray(self_knn(jnp.asarray(train), k=k, metric=metric))

    out_path = out_path or data_path + ".processed"
    with h5py.File(out_path, "w") as f:
        f.create_dataset("train", data=train)
        f.create_dataset("train_knn", data=train_knn)
        f.create_dataset("test", data=test)
        f.create_dataset("neighbors", data=neighbors)
        if distances is not None:
            f.create_dataset("distances", data=distances)
    return out_path


def main(argv: list[str] | None = None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("data_key", choices=sorted(DATA_PATH_KEYS))
    p.add_argument("-k", type=int, default=100)
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)

    data_path = get_env(DATA_PATH_KEYS[args.data_key])
    if not data_path:
        print(f"env var {DATA_PATH_KEYS[args.data_key]} is not set", file=sys.stderr)
        raise SystemExit(2)
    out = precompute(data_path, METRIC_BY_KEY[args.data_key], k=args.k,
                     out_path=args.out)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
