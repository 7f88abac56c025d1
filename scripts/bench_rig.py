#!/usr/bin/env python3
"""Measure the batched rig driver vs the sequential rig scan driver on chip.

The rig path is what real RadarScenes data runs (the CLI auto-routes
datasets with sensors.json mounts to ``pipeline/rig.py``; docs/PARITY.md),
so its throughput is a first-class number (VERDICT r04 item 1).  Workload:
the reference's four-sensor RadarScenes-like mounting geometry at the
complete-analysis operating point; one "frame" = one 4-sensor rig frame
(4x the single-sensor front-end work + the merged 200-target solve).

Methodology = bench.py: data-fetch barriers, interleaved differencing of
two sequence lengths, best of trials.
"""
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
from radar_slam_tpu.evaluate.pose_metrics import planar_pose_errors
from radar_slam_tpu.io.synthetic import (SceneConfig,
                                         constant_motion_scene_rig)
from radar_slam_tpu.pipeline import rig as rigmod

# Four mounted sensors ~ RadarScenes' layout (two front corner, two side).
RIG4 = ((3.6, 0.8, 0.55), (3.6, -0.8, -0.55),
        (2.4, 0.9, 1.48), (2.4, -0.9, -1.48))


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
    ap.add_argument("--frames", type=int, nargs=2, default=(32, 160))
    ap.add_argument("--scan", action="store_true",
                    help="also time the sequential rig scan driver")
    ap.add_argument("--prefetch", action="store_true",
                    help="also time the host-resident chunked-batched "
                         "prefetch driver (the real-data ingest path)")
    args = ap.parse_args()

    from radar_slam_tpu.utils.device import require_gpu
    require_gpu()

    cfg = dataclasses.replace(complete_analysis_config(), max_scatterers=128)

    def scene(n):
        return constant_motion_scene_rig(
            7, num_frames=n, dt=cfg.frame_dt, v_body=(8.0, 0.5),
            yaw_rate=0.05,
            scene=SceneConfig(num_points=96,
                              max_scatterers=cfg.max_scatterers), rig=RIG4)

    f1, f2 = args.frames
    b1, gt1 = scene(f1)
    b2, _ = scene(f2)
    key = jax.random.key(0, impl="rbg")

    t1, t2 = time_pair(
        lambda: rigmod.process_sequence_rig_batched(b1, key, cfg, RIG4),
        lambda: rigmod.process_sequence_rig_batched(b2, key, cfg, RIG4))
    fps_b = (f2 - f1) / max(t2 - t1, 1e-9)

    out = rigmod.process_sequence_rig_batched(b1, key, cfg, RIG4)
    ok = np.asarray(out.motion.success)
    m = planar_pose_errors(np.asarray(out.pose), np.asarray(gt1["poses"]))

    res = {
        "rig_batched_fps": round(fps_b, 1),
        "sensors": len(RIG4),
        "frames_delta": f2 - f1,
        "dispatch_s_f1": round(t1, 4),
        "success_rate": round(float(ok[1:].mean()), 3),
        "pos_rmse_m": round(float(m["position_rmse"]), 3),
    }
    if args.scan:
        t1s, t2s = time_pair(
            lambda: rigmod.process_sequence_rig(b1, key, cfg, RIG4),
            lambda: rigmod.process_sequence_rig(b2, key, cfg, RIG4))
        res["rig_scan_fps"] = round((f2 - f1) / max(t2s - t1s, 1e-9), 1)
    if args.prefetch:
        import jax as _jax

        from radar_slam_tpu.io.prefetch import (
            process_sequence_rig_batched_prefetch as pf)
        h1 = _jax.tree.map(np.asarray, b1)
        h2 = _jax.tree.map(np.asarray, b2)
        t1p, t2p = time_pair(lambda: pf(h1, key, cfg, RIG4, chunk=32),
                             lambda: pf(h2, key, cfg, RIG4, chunk=32))
        res["rig_prefetch_fps"] = round((f2 - f1) / max(t2p - t1p, 1e-9), 1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
