"""Which accelerator a measurement ran on, and its published peak rates.

Every number a measurement entry point (``bench.py``, ``chip_smoke.py``,
``scripts/``) reports names the device it came from.  Those entry points
refuse to run anywhere but on the GPU they measure: a CPU fallback would
report the speed of XLA's CPU backend under a device metric's name.
"""

from __future__ import annotations

import subprocess
from typing import Dict

# Published dense peaks (no sparsity), keyed by ``jax.Device.device_kind``.
# NVIDIA H100 SXM5 data sheet, at the card's full 700 W power limit; a card
# set below it cannot hold these clocks under matrix-heavy load, so report
# the power limit (``nvidia-smi``) beside any share of these peaks.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0,
        "tf32_tflops": 495.0,
        "f32_tflops": 67.0,
        "hbm_gbps": 3350.0,
    },
}


def peak_rates(device_kind: str) -> Dict[str, float]:
    """Published peaks of ``device_kind``; an unknown device is an error,
    never a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peak rates for device kind {device_kind!r}; add "
            "them to radar_slam_tpu/utils/device.py:PEAKS with their "
            "source") from None


def require_gpu(count: int = 1) -> Dict[str, object]:
    """The JAX device identity ``{"platform", "kind", "count"}``; exits with
    a message (and no result) unless JAX's default devices are at least
    ``count`` GPUs."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"refusing to run: JAX found no GPU (default platform "
            f"{devices[0].platform!r}); this program measures an NVIDIA GPU "
            "and does not fall back to another device")
    if len(devices) < count:
        raise SystemExit(f"refusing to run: needs {count} GPUs, JAX found "
                         f"{len(devices)}")
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices)}


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of each card as ``nvidia-smi`` reports them,
    read in a child process that does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())
