"""What the default device reports about itself."""

from __future__ import annotations

import os
import subprocess

import jax


def device_bytes_limit() -> int | None:
    """Memory limit of the first device as its allocator reports it
    (``memory_stats()["bytes_limit"]``), or None where the device
    reports none (the CPU)."""
    stats = jax.devices()[0].memory_stats()
    if not stats or "bytes_limit" not in stats:
        return None
    return int(stats["bytes_limit"])


def gpu_name_and_power_limit() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit`` of the host's cards
    (one line per card), or None where there is no nvidia-smi.  Run as
    a child process that never touches JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def describe_devices() -> dict:
    """What a measurement ran on: JAX's platform, device kind and device
    count, ``XLA_FLAGS``, and the card's name and power limit."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "card": gpu_name_and_power_limit(),
    }
