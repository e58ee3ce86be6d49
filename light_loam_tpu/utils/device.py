"""What the measuring entry points record about the device they ran on."""

from __future__ import annotations

import subprocess

import jax


def require_gpu(what: str) -> jax.Device:
    """The first device, or SystemExit when JAX found no GPU: a
    measurement never falls back to the CPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"{what} needs a GPU; JAX found platform {dev.platform!r}")
    return dev


def nvidia_smi_line() -> str:
    """Each card's name and power limit as nvidia-smi reports them, one
    line per card (a card set below its maximum power runs slower under
    load)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out or "nvidia-smi printed nothing"
