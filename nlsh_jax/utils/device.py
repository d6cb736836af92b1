"""What the program runs on: the accelerator check every measurement
starts with, and the card's name and power limit printed beside every
number it reports."""

from __future__ import annotations

import subprocess


def require_gpu() -> dict:
    """``{"platform", "kind", "count"}`` of JAX's devices.  Raises
    unless JAX's default devices are GPUs: a measurement that finds no
    GPU fails, it does not fall back to the CPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's devices are {devices} "
            f"(platform {devices[0].platform!r})")
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def card_info() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    as printed (one line per card).  A card may be set below its top
    power limit and then runs slower under load, so every number is
    reported beside this."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()
