"""What the program runs on: JAX's view of the devices, and the card's name
and power limit as ``nvidia-smi`` reports them.

Every measurement the entry points print carries these fields, so a number
is never read without the device it came from.
"""

from __future__ import annotations

import subprocess
from typing import Dict, Optional


def nvidia_smi_name_power() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` (one line per card), or
    None where there is no ``nvidia-smi``. Runs as a child process that
    does not touch JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (FileNotFoundError, subprocess.CalledProcessError,
            subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def device_fields(card: Optional[str] = None) -> Dict[str, object]:
    """platform, device_kind and device count as JAX reports them, plus the
    card's ``name, power.limit`` line (first card)."""
    import jax

    dev = jax.devices()[0]
    if card is None:
        card = nvidia_smi_name_power()
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": jax.device_count(),
        "card": card.splitlines()[0] if card else "not available",
    }


def require_gpu() -> None:
    """Raise unless JAX's first device is a GPU. JAX falls back to the CPU
    silently when its CUDA plugin cannot start; a measurement must not."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is on platform {platform!r}")
