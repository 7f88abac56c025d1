#!/usr/bin/env python3
"""Single-frame streaming latency on the GPU (VERDICT round-1 item 9: the
metric a real-time layer exists for, never reported in round 1).

Measures the per-frame wall latency of the streaming step
(``pipeline.frame.process_scatterers`` with donated state + one batched
host fetch, i.e. exactly what ``StreamingAnalyzer.process_frame`` pays) and
reports p50 / p90 / p99 over N frames, with the pure dispatch round-trip
(an empty jitted identity) as the dispatch floor for context.

Usage: python scripts/bench_latency.py [--frames 200]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=200)
    args = ap.parse_args()

    from radar_slam_tpu.utils.device import require_gpu
    require_gpu()

    from radar_slam_tpu.core.config import complete_analysis_config
    from radar_slam_tpu.io.synthetic import SceneConfig, constant_motion_scene
    from radar_slam_tpu.pipeline import frame as pipe

    cfg = complete_analysis_config()
    F = args.frames
    batches, _ = constant_motion_scene(
        7, num_frames=F, dt=cfg.frame_dt, v_body=(8.0, 0.5), yaw_rate=0.05,
        scene=SceneConfig(num_points=96, max_scatterers=cfg.max_scatterers))
    keys = jax.random.split(jax.random.key(0), F)

    # Dispatch floor: empty jitted identity + scalar fetch.
    @jax.jit
    def ident(x):
        return x + 1.0

    z = jnp.float32(0.0)
    float(np.asarray(ident(z)))
    floor = []
    for _ in range(100):
        t0 = time.perf_counter()
        float(np.asarray(ident(z)))
        floor.append(time.perf_counter() - t0)

    def fetch(out):
        return jax.device_get(
            (out.pose, out.motion.velocity, out.motion.angular_velocity,
             out.motion.success, out.num_reliable, out.num_associations))

    # Warm: compile + first frames.
    state = pipe.init_state(cfg)
    for i in range(3):
        sc = jax.tree.map(lambda x: x[i], batches)
        state, out = pipe.process_scatterers(state, sc, keys[i], cfg)
        fetch(out)

    lat = []
    for i in range(3, F):
        sc = jax.tree.map(lambda x: x[i], batches)
        t0 = time.perf_counter()
        state, out = pipe.process_scatterers(state, sc, keys[i], cfg)
        fetch(out)
        lat.append(time.perf_counter() - t0)
    lat = np.array(lat)

    def pct(x):
        return {"p50_ms": round(float(np.percentile(x, 50)) * 1e3, 3),
                "p90_ms": round(float(np.percentile(x, 90)) * 1e3, 3),
                "p99_ms": round(float(np.percentile(x, 99)) * 1e3, 3),
                "mean_ms": round(float(np.mean(x)) * 1e3, 3)}

    print(json.dumps({
        "device": str(jax.devices()[0]),
        "frames": len(lat),
        "frame_step_latency": pct(lat),
        "dispatch_floor": pct(np.array(floor)),
        "net_of_floor_p50_ms": round(
            (float(np.percentile(lat, 50))
             - float(np.percentile(floor, 50))) * 1e3, 3),
        "realtime_budget_ms": 100.0,   # one RadarScenes frame window
        "meets_realtime": bool(np.percentile(lat, 99) < 0.1),
    }, indent=2))


if __name__ == "__main__":
    main()
