"""Device mesh helpers.

The reference has zero distributed computing (SURVEY.md section 2 row 17 --
its only parallelism is intra-process thread pools); this layer is new
design: SPMD over ``jax.sharding.Mesh`` with XLA collectives.  On a host
whose cards are joined all to all (NVLink), a 1-D mesh over the frame or
factor axis is the natural shape: every device reaches every other at the
same rate.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "f") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (frame/data axis)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), (axis_name,))


def frame_sharding(mesh: Mesh, axis_name: str = "f") -> NamedSharding:
    """Shard the leading (frame) axis across the mesh."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_frames_to_devices(n_frames: int, n_devices: int) -> int:
    """Frames per device after padding to divisibility."""
    return -(-n_frames // n_devices)
