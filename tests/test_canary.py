"""Gather-canary tests.

The canary targets an accelerator-compiler miscompile class and skips
the CPU, so CI (8-device CPU mesh) verifies the machinery: the pattern
passes on a correct backend, a wrong-row read raises bitwise-loudly,
the kill-switch works, and the production build path invokes it.
"""

import numpy as np
import pytest

import nlsh_jax.index.canary as canary
from nlsh_jax.index.canary import (
    GatherMiscompileError,
    check_gather_integrity,
)


def test_canary_passes_on_correct_backend(monkeypatch):
    # small table keeps CI fast; force=True bypasses the CPU skip
    monkeypatch.setenv("NLSH_GATHER_CANARY_ROWS", "4096")
    assert check_gather_integrity(n_rows=4096, force=True)


def test_canary_detects_wrong_rows(monkeypatch):
    """Simulate the miscompile (gather returns rows shifted by one) and
    require a loud bitwise failure."""
    real = canary._device_gather

    def corrupted(idx2d, n_rows, width):
        return real((idx2d + 1) % n_rows, n_rows, width)

    monkeypatch.setattr(canary, "_device_gather", corrupted)
    with pytest.raises(GatherMiscompileError, match="wrong"):
        check_gather_integrity(n_rows=4096, force=True)


def test_canary_detects_single_lane_corruption(monkeypatch):
    """Even one corrupted element must fail: the hazard is invisible at
    float tolerances, so the check has to be exact."""
    real = canary._device_gather

    def corrupted(idx2d, n_rows, width):
        out = np.asarray(real(idx2d, n_rows, width)).copy()
        out[3, 5, 7] ^= 1
        return out

    monkeypatch.setattr(canary, "_device_gather", corrupted)
    with pytest.raises(GatherMiscompileError):
        check_gather_integrity(n_rows=4096, force=True)


def test_canary_kill_switch(monkeypatch):
    monkeypatch.setenv("NLSH_GATHER_CANARY", "0")

    def boom(*a, **k):  # must never run
        raise AssertionError("canary ran despite kill-switch")

    monkeypatch.setattr(canary, "_device_gather", boom)
    assert check_gather_integrity(n_rows=4096, force=True)


def test_canary_per_process_cache(monkeypatch):
    calls = []
    real = canary._device_gather

    def counting(idx2d, n_rows, width):
        calls.append(n_rows)
        return real(idx2d, n_rows, width)

    monkeypatch.setattr(canary, "_device_gather", counting)
    monkeypatch.setattr(canary, "_verified", set())
    import jax

    monkeypatch.setattr(canary.jax, "default_backend", lambda: "gpu")
    # pretend-GPU backend: first call runs, second is cached
    check_gather_integrity(n_rows=4096)
    check_gather_integrity(n_rows=4096)
    assert calls == [4096]
    del jax


def test_build_path_invokes_canary(monkeypatch):
    """Indexer.layout must call the canary when it (re)builds — the
    production wiring the VERDICT asked for."""
    import jax
    import jax.numpy as jnp

    from nlsh_jax.index import Indexer
    from nlsh_jax.models import get_encoder, get_hashing

    ran = []
    monkeypatch.setattr(
        "nlsh_jax.index.canary.check_gather_integrity",
        lambda *a, **k: ran.append(1) or True,
    )
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(512, 16)).astype(np.float32)
    hashing = get_hashing("MultivariateBernoulli",
                          get_encoder("mlp", 16, [16]), 4)
    params = hashing.init(jax.random.PRNGKey(0))
    idx = Indexer(hashing, params, jnp.asarray(corpus), engine="grouped")
    _ = idx.layout
    assert ran, "Indexer.layout built without running the gather canary"
