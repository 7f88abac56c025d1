"""Persistent XLA compilation cache location.

Compiling the full pipeline takes far longer than running it, so every
entry point (the CLI, ``bench.py``, ``chip_smoke.py``) keeps compiled
programs in one persistent cache.  The directory is part of what a later
process must find again, so it is fixed: ``$JAX_COMPILATION_CACHE_DIR``
when the environment sets it, else ``<checkout>/.jax_cache``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Mapping

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = Path(__file__).resolve().parents[2]


def cache_dir(environ: Mapping[str, str] = os.environ) -> Path:
    """The compile-cache directory for this environment."""
    configured = environ.get(ENV_VAR)
    return Path(configured) if configured else CHECKOUT / ".jax_cache"


def enable_compile_cache() -> Path:
    """Point JAX's persistent compilation cache at :func:`cache_dir` and
    return that directory."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", str(path))
    return path
