"""Checkpointing: params + optimizer state with resume, and exported
inference artifacts for the query engine.

The reference only saves best TorchScript models inside the training
loop and acknowledges ``load`` as a TODO (``hashings.py:53-58``,
``trainers/base.py:100-103``); optimizer state is never saved.  Here:

* :func:`save_train_state` / :func:`load_train_state` — full resume
  (params, extra-model params, optimizer state, step).
* :func:`save_model` / :func:`load_model` — a self-describing inference
  artifact: the hashing architecture config as JSON next to the params,
  so ``eval.py`` can rebuild the jitted forward without the training
  script (the TorchScript-export analogue).

Pytrees are stored with numpy alone (:func:`save_tree`): one ``.npz``
entry per leaf, keyed by the leaf's ``jax.tree_util.keystr`` path, and
restored against a ``like`` tree of the same structure.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import jax
import numpy as np

from nlsh_jax.models.encoders import MLPEncoder, SirenEncoder
from nlsh_jax.models.hashings import (
    Categorical,
    MultivariateBernoulli,
    ProductQuantization,
)
from nlsh_jax.ops.code_distances import get_code_distance

_ENCODERS = {"MLPEncoder": MLPEncoder, "SirenEncoder": SirenEncoder}
_HASHINGS = {
    "MultivariateBernoulli": MultivariateBernoulli,
    "Categorical": Categorical,
    "ProductQuantization": ProductQuantization,
}


#: suffix of an inference artifact's params file (beside ``<base>.json``)
PARAMS_SUFFIX = ".params.npz"
#: suffix of a full training state written beside an artifact
STATE_SUFFIX = ".state.npz"


def save_tree(path: str, tree: Any) -> None:
    """Write every leaf of ``tree`` to the ``.npz`` file ``path`` (the
    name is used as given), keyed by its ``keystr`` path."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    arrays = {jax.tree_util.keystr(kp): np.asarray(leaf)
              for kp, leaf in leaves}
    if len(arrays) != len(leaves):
        raise ValueError("pytree has leaves with colliding key paths")
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "wb") as f:
        np.savez(f, **arrays)


def load_tree(path: str, like: Any) -> Any:
    """Read a :func:`save_tree` file back into the structure of ``like``.
    Every leaf of ``like`` must be present with the same shape."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(like)
    out = []
    with np.load(path, allow_pickle=False) as z:
        for kp, leaf in leaves:
            key = jax.tree_util.keystr(kp)
            if key not in z.files:
                raise KeyError(f"{path} has no entry for leaf {key}")
            arr = z[key]
            want = np.asarray(leaf)
            if arr.shape != want.shape:
                raise ValueError(
                    f"leaf {key}: saved shape {arr.shape}, expected "
                    f"{want.shape}")
            if arr.dtype != want.dtype and arr.dtype.kind == "V":
                arr = arr.view(want.dtype)  # e.g. bfloat16 stored raw
            out.append(arr)
    return jax.tree_util.tree_unflatten(treedef, out)


def model_base(path: str) -> str:
    """An artifact's base path, with a ``.json`` or params suffix
    stripped if given."""
    base = str(path)
    for suffix in (".json", PARAMS_SUFFIX):
        if base.endswith(suffix):
            return base[: -len(suffix)]
    return base


# ---------------------------------------------------------------------------
# Inference artifact (architecture + params)
# ---------------------------------------------------------------------------

# registry keys (ops.code_distances.CODE_DISTANCES) by implementation class
_DISTANCE_KEYS = {
    "MVBernoulliL2": "L2",
    "MVBernoulliKLDivergence": "KL",
    "MVBernoulliMeanKLDivergence": "MeanKL",
    "MVBernoulliCrossEntropy": "CrossEntropy",
    "MVBernoulliTanhCosine": "Cosine",
    "CategoricalJSD": "JS",
    "CategoricalL2": "CategoricalL2",
}


def hashing_config(hashing) -> dict:
    """Serialise a hashing model's architecture to plain JSON."""
    enc = hashing.encoder
    enc_cfg = {
        "type": type(enc).__name__,
        "input_dim": enc.input_dim,
        "hidden_dims": list(enc.hidden_dims),
    }
    if isinstance(enc, MLPEncoder):
        enc_cfg.update(with_bias=enc.with_bias, with_layernorm=enc.with_layernorm)
    else:
        enc_cfg.update(w0=enc.w0, w0_initial=enc.w0_initial)
    cd = hashing.code_distance
    cfg = {
        "type": type(hashing).__name__,
        "hash_size": hashing.hash_size,
        "encoder": enc_cfg,
        "code_distance": _DISTANCE_KEYS.get(type(cd).__name__) if cd else None,
    }
    if isinstance(hashing, MultivariateBernoulli):
        cfg["tanh_output"] = hashing.tanh_output
    if isinstance(hashing, ProductQuantization):
        cfg["n_bands"] = hashing.n_bands
        cfg["bits_per_band"] = hashing.bits_per_band
    return cfg


def build_hashing(cfg: dict):
    """Rebuild a hashing model from :func:`hashing_config` output."""
    ec = dict(cfg["encoder"])
    enc_cls = _ENCODERS[ec.pop("type")]
    ec["hidden_dims"] = tuple(ec["hidden_dims"])
    enc = enc_cls(**ec)
    dist = get_code_distance(cfg["code_distance"]) if cfg.get("code_distance") else None
    if cfg["type"] == "ProductQuantization":
        return ProductQuantization(
            enc, cfg["n_bands"], cfg["bits_per_band"], dist
        )
    kwargs = {}
    if cfg["type"] == "MultivariateBernoulli":
        kwargs["tanh_output"] = cfg.get("tanh_output", False)
    return _HASHINGS[cfg["type"]](enc, cfg["hash_size"], dist, **kwargs)


def save_model(base_path: str, hashing, params, n_tables: int | None = None) -> None:
    """Export ``<base>.json`` + ``<base>.params.npz`` — the analogue of
    the reference's TorchScript ``save`` (``hashings.py:53-57``), but
    loadable.  ``n_tables`` marks multi-table stacked params."""
    base = Path(base_path)
    base.parent.mkdir(parents=True, exist_ok=True)
    cfg = hashing_config(hashing)
    if n_tables is not None:
        cfg["n_tables"] = int(n_tables)
    # NB: append, don't Path.with_suffix — base names may contain dots
    # (e.g. a recall value like `run_300_0.6528`).
    Path(str(base) + ".json").write_text(json.dumps(cfg, indent=2))
    save_tree(str(base) + PARAMS_SUFFIX, params)


def load_model(base_path: str):
    """Load an inference artifact: returns ``(hashing, params)``.
    Implements the reference's TODO ``load`` classmethod
    (``hashings.py:58``)."""
    base = model_base(base_path)
    cfg = json.loads(Path(base + ".json").read_text())
    hashing = build_hashing(cfg)
    if cfg.get("n_tables"):
        from nlsh_jax.parallel.multitable import init_multi_table

        like = init_multi_table(hashing, cfg["n_tables"], jax.random.PRNGKey(0))
    else:
        like = hashing.init(jax.random.PRNGKey(0))
    params = load_tree(base + PARAMS_SUFFIX, like)
    return hashing, params


# ---------------------------------------------------------------------------
# Full training state (resume)
# ---------------------------------------------------------------------------

def save_train_state(path: str, state: Any) -> None:
    save_tree(path, state)


def load_train_state(path: str, like: Any) -> Any:
    return load_tree(path, like)
