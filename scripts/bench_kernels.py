#!/usr/bin/env python3
"""Per-kernel microbenchmarks with roofline context (BASELINE "kernel
quality" reporting): 2-D FFT, batched eigh, batched ridge LSQ, beamforming
matmul, synthesis matmul.

Each entry reports achieved throughput and the utilization of the
published peaks of the device's kind (radar_slam_tpu/utils/device.py:
PEAKS; an unknown device is an error).  Batched small ops (eigh on 8x8)
are latency-bound -- their "roofline" is reported as op rate, not FLOPs.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np


def _scalar(out):
    leaf = jax.tree.leaves(out)[0]
    return jnp.sum(jnp.real(leaf).reshape(-1)[:8]).astype(jnp.float32)


def timeit(fn, *args, iters=64):
    """Device time per kernel call via in-program chaining: the kernel is
    iterated ``iters`` times INSIDE one jitted program -- each iteration's
    input is scaled by a loop-dependent factor so XLA cannot hoist the
    loop-invariant call -- and the single dispatch+fetch overhead is
    cancelled by differencing iters vs iters//4.
    """
    x0 = args[0]
    rest = args[1:]

    @jax.jit
    def chained(x, n, *r):               # n is traced: one compile total
        def body(i, acc):
            xi = x * (1.0 + 1e-7 * i)    # loop-dependent: prevents LICM
            return acc + _scalar(fn(xi, *r))
        return jax.lax.fori_loop(0, n, body, jnp.float32(0.0))

    def t(n):
        v = chained(x0, n, *rest)
        float(np.asarray(v))             # compile/warm, real barrier
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            v = chained(x0, n, *rest)
            float(np.asarray(v))
            best = min(best, time.perf_counter() - t0)
        return best

    base = max(iters // 4, 1)
    return max(t(iters) - t(base), 1e-9) / (iters - base)


def main():
    from radar_slam_tpu.utils.device import peak_rates, require_gpu
    device = require_gpu()
    peaks = peak_rates(device["kind"])
    results = []
    key = jax.random.key(0)

    @jax.jit
    def make_cube(key):
        a, b = jax.random.split(key)
        return (jax.random.normal(a, (64, 8, 400, 64))
                + 1j * jax.random.normal(b, (64, 8, 400, 64))
                ).astype(jnp.complex64)

    cube = make_cube(key)           # 64 frames x [A, R, D]

    # --- 2-D FFT over the cube (range 400 + doppler 64 per antenna) -------
    fft2 = jax.jit(lambda x: jnp.fft.fftshift(
        jnp.fft.fft(jnp.fft.ifft(x, axis=-2), axis=-1), axes=-1))
    t = timeit(fft2, cube)
    n = 64 * 8
    flops = n * (5 * 400 * 64 * np.log2(400) + 5 * 64 * 400 * np.log2(64))
    bytes_ = 2 * cube.size * 8
    results.append({
        "kernel": "fft2_range_doppler", "time_us": round(t * 1e6, 1),
        "gflops": round(flops / t / 1e9, 1),
        "hbm_gbs": round(bytes_ / t / 1e9, 1),
        "hbm_util": round(bytes_ / t / 1e9 / peaks["hbm_gbps"], 3),
    })

    # --- batched 8x8 Hermitian eigendecomposition -------------------------
    @jax.jit
    def make_herm(key):
        a, b = jax.random.split(key)
        s = (jax.random.normal(a, (4096, 8, 8))
             + 1j * jax.random.normal(b, (4096, 8, 8))).astype(jnp.complex64)
        return s @ jnp.conj(jnp.swapaxes(s, -1, -2))

    H = make_herm(key)
    eigh = jax.jit(lambda h: jnp.linalg.eigh(h))
    t = timeit(eigh, H, iters=256)
    results.append({
        "kernel": "batched_eigh_8x8_c64", "batch": 4096,
        "time_us": round(t * 1e6, 1),
        "eigh_per_sec": round(4096 / t / 1e6, 2),
        "unit": "M ops/s",
    })

    # --- batched ridge LSQ solve (the velocity normal equations) ----------
    @jax.jit
    def make_lsq(key):
        a, b = jax.random.split(key)
        A = jax.random.normal(a, (4096, 64, 6))
        y = jax.random.normal(b, (4096, 64))
        return A, y

    A, y = make_lsq(key)
    solve = jax.jit(lambda A, y: jnp.linalg.solve(
        jnp.einsum("bki,bkj->bij", A, A) + 0.01 * jnp.eye(6),
        jnp.einsum("bki,bk->bi", A, y)[..., None]).squeeze(-1))
    t = timeit(solve, A, y)
    results.append({
        "kernel": "batched_ridge_lsq_64x6", "batch": 4096,
        "time_us": round(t * 1e6, 1),
        "solves_per_sec": round(4096 / t / 1e6, 2), "unit": "M ops/s",
    })

    # --- beamforming matmul |S A^H|^2 -------------------------------------
    @jax.jit
    def make_bf(key):
        a, b, c = jax.random.split(key, 3)
        S = (jax.random.normal(a, (4096, 8))
             + 1j * jax.random.normal(b, (4096, 8))).astype(jnp.complex64)
        G = (jax.random.normal(c, (361, 8))
             + 1j * jax.random.normal(c, (361, 8))).astype(jnp.complex64)
        return S, G

    S, G = make_bf(key)
    bf = jax.jit(lambda s, g: jnp.abs(s @ jnp.conj(g).T) ** 2)
    t = timeit(bf, S, G, iters=8192)
    flops = 8 * 4096 * 361 * 8
    results.append({
        "kernel": "beamforming_spectra", "time_us": round(t * 1e6, 1),
        "tflops": round(flops / t / 1e12, 3),
        "f32_util": round(flops / t / 1e12 / peaks["f32_tflops"], 4),
    })

    # --- synthesis contraction (the per-frame matmul) ----------------------
    @jax.jit
    def make_synth(key):
        a, b = jax.random.split(key)
        eac = (jax.random.normal(a, (64, 512, 256))
               + 1j * jax.random.normal(a, (64, 512, 256))).astype(jnp.complex64)
        ef = (jax.random.normal(b, (64, 512, 400))
              + 1j * jax.random.normal(b, (64, 512, 400))).astype(jnp.complex64)
        return eac, ef

    eac, ef = make_synth(key)
    synth = jax.jit(lambda a, b: jnp.einsum("fxp,fxs->fps", a, b))
    t = timeit(synth, eac, ef)
    flops = 8 * 64 * 512 * 256 * 400      # 4 real mul + 4 add per cMAC
    results.append({
        "kernel": "synthesis_matmul_64frames", "time_us": round(t * 1e6, 1),
        "tflops": round(flops / t / 1e12, 2),
        "f32_util": round(flops / t / 1e12 / peaks["f32_tflops"], 3),
    })

    print(json.dumps({"device": device, "peaks": peaks,
                      "kernels": results}, indent=2))


if __name__ == "__main__":
    main()
