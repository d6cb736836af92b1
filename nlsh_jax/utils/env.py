"""Minimal .env + environment config (reference uses python-dotenv,
``main.py:31-38`` / ``.env.sample``).  We parse ``.env`` ourselves so
there is no extra dependency."""

from __future__ import annotations

import os
from pathlib import Path

_loaded = False


def load_dotenv(path: str | None = None) -> None:
    """Load ``KEY=VALUE`` lines from ``.env`` into ``os.environ``
    (existing environment wins, matching python-dotenv defaults)."""
    global _loaded
    candidates = [Path(path)] if path else [Path.cwd() / ".env"]
    for p in candidates:
        if p.is_file():
            for line in p.read_text().splitlines():
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                key, _, value = line.partition("=")
                os.environ.setdefault(key.strip(), value.strip().strip("'\""))
    _loaded = True


def get_env(name: str, default: str | None = None) -> str | None:
    if not _loaded:
        load_dotenv()
    return os.environ.get(name, default)


#: the checkout this package was imported from
REPO_ROOT = Path(__file__).resolve().parents[2]


def setup_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache before first device
    use; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as is (JAX reads it
    itself).  Otherwise the cache lives at ``<repo>/.jax_cache``: a
    fixed path, since the path is part of what a cache hit matches."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax

    path = str(REPO_ROOT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
