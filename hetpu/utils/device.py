"""The accelerator a measurement runs on.

Every number a script here prints names its device: platform, device
kind and count as JAX reports them, plus the card's name and power limit
from ``nvidia-smi`` (a card set below its maximum runs slower under
load).  A measurement path that finds no GPU stops: it never falls back
to the CPU.
"""

from __future__ import annotations

import subprocess


def require_gpu() -> dict:
    """JAX's view of the device, or SystemExit when it is not a GPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is "
                         f"{devs[0].platform!r} ({devs[0].device_kind})")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of each card, one line per card, read by a
    child process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
