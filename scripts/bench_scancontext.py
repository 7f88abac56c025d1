#!/usr/bin/env python3
"""Scan-context retrieval throughput: keyframes/s for descriptor build +
full two-stage retrieval, on the active platform.

Workload: F keyframes x K detections -> [F, R, S] descriptors (vmapped
segment_sum), ring-key [F, F] matmul + static top-M, FFT shift search over
the F*M survivors.  The whole retrieval is ONE jitted program; timing
amortizes dispatch by chaining `chain` independent retrievals inside one
program (same methodology as scripts/bench_kernels.py), so the dispatch
overhead does not dominate.

Usage: python scripts/bench_scancontext.py [--frames 1024] [--chain 8]
"""

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np

from radar_slam_tpu.parallel.scancontext import (ScanContextConfig,
                                                 _stage2_scores,
                                                 build_descriptors)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--detections", type=int, default=50)
    ap.add_argument("--chain", type=int, default=8)
    args = ap.parse_args()

    from radar_slam_tpu.utils.device import require_gpu
    require_gpu()

    cfg = ScanContextConfig()
    rng = np.random.default_rng(0)
    pts = jnp.asarray(rng.uniform(-40, 40, (args.frames, args.detections, 2))
                      .astype(np.float32))
    valid = jnp.asarray(rng.uniform(size=(args.frames, args.detections))
                        < 0.8)

    @jax.jit
    def retrieval_chain(pts, valid):
        """`chain` dependency-chained retrievals in one program."""
        def one(p):
            desc = build_descriptors(p, valid, cfg)
            ok, ii, sim, shift = _stage2_scores(
                desc, cfg.top_m, cfg.min_separation, cfg.min_overlap)
            return sim
        def body(carry, _):
            p, acc = carry
            sim = one(p)
            # Feed a scalar of the result back into the input so XLA cannot
            # hoist or dedup iterations.
            return (p + jnp.max(sim) * 1e-9, acc + jnp.sum(sim)), None
        (_, acc), _ = jax.lax.scan(body, (pts, 0.0), None,
                                   length=args.chain)
        return acc

    # Warm + force with a real fetch.
    float(jax.device_get(retrieval_chain(pts, valid)))
    best = float("inf")
    for _ in range(4):
        t0 = time.perf_counter()
        float(jax.device_get(retrieval_chain(pts, valid)))
        best = min(best, time.perf_counter() - t0)
    per_retrieval = best / args.chain

    print(f"device: {jax.devices()[0]}")
    print(f"F={args.frames} K={args.detections} R={cfg.n_rings} "
          f"S={cfg.n_sectors} top_m={cfg.top_m} chain={args.chain}")
    print(f"full retrieval (desc + stage1 + stage2): "
          f"{per_retrieval * 1e3:.2f} ms "
          f"({args.frames / per_retrieval:,.0f} keyframes/s)")


if __name__ == "__main__":
    main()
