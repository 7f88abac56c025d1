"""Multi-host initialization helpers.

Single-process usage needs nothing from this module: one process drives
all the GPUs of its host.  Across hosts, call :func:`initialize` once per
process before any jax call; mesh axes then span all hosts' devices and the
SPMD code in ``parallel/`` (frame-parallel pipeline, factor-sharded GN,
Schur step, sequence-sharded batches) runs unchanged, with collectives
scheduled by XLA (NCCL on GPUs).

The multi-process paths are exercised on the virtual CPU mesh (tests/) and
via ``__graft_entry__.dryrun_multichip``.
"""

from __future__ import annotations

import os
from typing import Optional


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> dict:
    """Initialize jax.distributed from args or standard env vars.

    Recognized env vars: JAX_COORDINATOR_ADDRESS (or COORDINATOR_ADDRESS),
    JAX_NUM_PROCESSES, JAX_PROCESS_ID.  Without a cluster manager that
    jax detects, pass all three (the coordinator as ``host:port``).

    Returns a dict describing the resulting topology."""
    import jax

    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR_ADDRESS")
                           or os.environ.get("COORDINATOR_ADDRESS"))
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address or num_processes:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)

    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def is_multihost() -> bool:
    import jax
    return jax.process_count() > 1
