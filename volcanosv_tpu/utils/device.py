"""What a measurement ran on: JAX's devices and, on NVIDIA cards, the
card's name and power limit (a card set below its maximum power runs
slower under load, so every timing carries both)."""
from __future__ import annotations

import subprocess


def device_info() -> dict:
    """{"platform", "kind", "count"} as JAX reports them."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """device_info(), or SystemExit when JAX found no GPU: a measurement
    never falls back to the CPU."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {info['platform']!r} "
                         f"({info['kind']})")
    return info


def gpu_name_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`,
    run in a child process that stays off JAX."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()
