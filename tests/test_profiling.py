"""Tests for the phase timer / tracing utilities."""

import jax.numpy as jnp

from nlsh_jax.utils.profiling import PhaseTimer, trace


def test_phase_timer_accumulates():
    timer = PhaseTimer(sync=False)
    with timer("a"):
        _ = jnp.ones((8, 8)).sum()
    with timer("a"):
        pass
    with timer("b"):
        pass
    s = timer.summary()
    assert s["a"]["count"] == 2
    assert s["b"]["count"] == 1
    assert s["a"]["total_s"] >= 0
    report = timer.report()
    assert "a" in report and "b" in report


def test_trace_noop_without_dir():
    with trace(None):
        _ = jnp.ones(4) + 1
