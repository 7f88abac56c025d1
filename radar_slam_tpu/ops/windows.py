"""FFT window functions (pure jnp, no scipy dependency).

Replaces ``scipy.signal.windows.{hann,hamming,blackman}`` used at
``src/radar_signal/dechirp.py:99-106``.  The reference uses scipy's default
*symmetric* windows; we default to symmetric for parity and expose
``periodic=True`` for the DFT-proper variant.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _cosine_window(n: int, coeffs, periodic: bool) -> jax.Array:
    denom = n if periodic else max(n - 1, 1)
    x = 2.0 * jnp.pi * jnp.arange(n, dtype=jnp.float32) / denom
    w = jnp.zeros(n, jnp.float32)
    for k, a in enumerate(coeffs):
        w = w + a * jnp.cos(k * x) * (-1.0) ** k
    return w


def hann(n: int, periodic: bool = False) -> jax.Array:
    return _cosine_window(n, (0.5, 0.5), periodic)


def hamming(n: int, periodic: bool = False) -> jax.Array:
    return _cosine_window(n, (0.54, 0.46), periodic)


def blackman(n: int, periodic: bool = False) -> jax.Array:
    return _cosine_window(n, (0.42, 0.5, 0.08), periodic)


_WINDOWS = {"hann": hann, "hamming": hamming, "blackman": blackman}


def get_window(name: str, n: int, periodic: bool = False) -> jax.Array:
    if name == "rect" or name is None:
        return jnp.ones(n, jnp.float32)
    try:
        return _WINDOWS[name](n, periodic)
    except KeyError:
        raise ValueError(f"Unknown window type: {name}") from None
