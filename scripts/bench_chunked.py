#!/usr/bin/env python3
"""Chunked (software-pipelined) driver throughput vs the per-frame scan
driver, across window sizes (VERDICT r04 item 4).  Methodology = bench.py
interleaved differencing."""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import numpy as np

from radar_slam_tpu.core.config import complete_analysis_config
from radar_slam_tpu.io.synthetic import SceneConfig, constant_motion_scene
from radar_slam_tpu.pipeline import frame as pipe


def force(out):
    return float(np.asarray(out.pose[-1, 0]))


def time_pair(run1, run2, trials=6):
    force(run1())
    force(run2())
    t1 = t2 = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        force(run1())
        t1 = min(t1, time.perf_counter() - t0)
        t0 = time.perf_counter()
        force(run2())
        t2 = min(t2, time.perf_counter() - t0)
    return t1, t2


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, nargs=2, default=(64, 512))
    ap.add_argument("--windows", type=str, default="8,16,32")
    ap.add_argument("--scan", action="store_true")
    args = ap.parse_args()

    from radar_slam_tpu.utils.device import require_gpu
    require_gpu()

    cfg = dataclasses.replace(complete_analysis_config(), max_scatterers=128)
    f1, f2 = args.frames

    def scene(n):
        return constant_motion_scene(
            7, num_frames=n, dt=cfg.frame_dt, v_body=(8.0, 0.5),
            yaw_rate=0.05, scene=SceneConfig(
                num_points=96, max_scatterers=cfg.max_scatterers))[0]

    b1, b2 = scene(f1), scene(f2)
    key = jax.random.key(0, impl="rbg")
    res = {}
    for w in [int(x) for x in args.windows.split(",")]:
        t1, t2 = time_pair(
            lambda: pipe.process_sequence_chunked(b1, key, cfg, window=w),
            lambda: pipe.process_sequence_chunked(b2, key, cfg, window=w))
        res[f"chunked_w{w}_fps"] = round((f2 - f1) / max(t2 - t1, 1e-9), 1)
    if args.scan:
        t1, t2 = time_pair(
            lambda: pipe.process_sequence(b1, key, cfg),
            lambda: pipe.process_sequence(b2, key, cfg))
        res["scan_fps"] = round((f2 - f1) / max(t2 - t1, 1e-9), 1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
