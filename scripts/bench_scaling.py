#!/usr/bin/env python3
"""Frame-parallel scaling harness: frames/s at mesh sizes 1..N GPUs.

Measures the scaling efficiency of the frame-parallel SPMD pipeline
(``parallel/dp.py``) over the host's GPUs.  Refuses to run without a GPU;
the collective paths are rehearsed on a virtual CPU mesh by the tests and
``__graft_entry__.py``, which time nothing.

Usage: python scripts/bench_scaling.py [--frames 64] [--sizes 1,2,4]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--sizes", default=None,
                    help="comma-separated mesh sizes (default: 1..n_devices)")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    from radar_slam_tpu.utils.device import require_gpu
    device = require_gpu()

    import jax
    import numpy as np

    from radar_slam_tpu.core.config import complete_analysis_config
    from radar_slam_tpu.io.synthetic import SceneConfig, constant_motion_scene
    from radar_slam_tpu.parallel import dp
    from radar_slam_tpu.parallel.mesh import make_mesh
    from radar_slam_tpu.signal.synth import synthesize_frames_batch

    n_dev = len(jax.devices())
    sizes = ([int(s) for s in args.sizes.split(",")] if args.sizes
             else [s for s in (1, 2, 4, 8, 16) if s <= n_dev])

    cfg = complete_analysis_config()
    F = args.frames
    batches, gt = constant_motion_scene(
        7, num_frames=F, dt=cfg.frame_dt,
        v_body=(8.0, 0.5), yaw_rate=0.05,
        scene=SceneConfig(num_points=96, max_scatterers=cfg.max_scatterers))
    signals = synthesize_frames_batch(batches, cfg.radar, jax.random.key(0))
    jax.block_until_ready(signals)

    results = []
    fps1 = None
    for n in sizes:
        if F % n:
            continue
        mesh = make_mesh(n)
        run = lambda: dp.process_frames_dp(signals, cfg, mesh)
        out = run()
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = run()
        jax.block_until_ready(out)
        fps = F / ((time.perf_counter() - t0) / args.reps)
        if fps1 is None:
            fps1 = fps
        eff = fps / (fps1 * n)
        ok = float(np.asarray(out["success"])[1:].mean())
        results.append({"devices": n, "frames_per_sec": round(fps, 1),
                        "scaling_efficiency_vs_1dev": round(eff, 3),
                        "success_rate": round(ok, 3)})
        print(json.dumps(results[-1]), flush=True)

    print(json.dumps({
        "metric": "frame_parallel_scaling",
        "device": device,
        "results": results,
    }))


if __name__ == "__main__":
    main()
