"""Test configuration: the platform the tests run on.

By default the tests run on an 8-virtual-device CPU platform: the
multi-device sharding paths are tested against a fake 8-device CPU mesh
(the standard way to test pjit/shard_map without several accelerators).
The environment may pin jax to an accelerator via a hook that imports
jax before pytest starts, so the env var alone is not enough — we also
override via jax.config, which takes effect because backends initialise
lazily.

``NLSH_TEST_PLATFORM=gpu`` leaves JAX on its default platform instead;
tests marked ``gpu`` then run on the card:

    NLSH_TEST_PLATFORM=gpu python -m pytest tests/ -m gpu

Whether a GPU is present is decided inside the ``gpu_device`` fixture,
at test time, never while test modules are imported.
"""

import os

import pytest

ON_GPU = os.environ.get("NLSH_TEST_PLATFORM", "cpu") == "gpu"

if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)


def pytest_sessionstart(session):
    if not ON_GPU:
        assert jax.default_backend() == "cpu"
        assert len(jax.devices()) == 8, jax.devices()


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip("needs a GPU (run with NLSH_TEST_PLATFORM=gpu on a "
                    "machine with one)")
    return device
