#!/usr/bin/env python3
"""Measure host->device ingest overlap on the active device (VERDICT
round-2 item 8 / r03 item 4: publish the measured overlap table).

Three schedules over the same HOST-resident scatterer sequence (the
production ingest payload -- the CLI's dataset loaders emit host numpy
batches and the streaming/rig drivers prefetch them since r04):

- ``resident``: everything pre-uploaded; pure compute (the floor).
- ``serial``: per chunk, block on the upload, then block on compute --
  the no-overlap upper bound (what a naive loader does).
- ``prefetch``: ``io/prefetch.py`` double buffering -- chunk i+1's DMA
  enqueued while chunk i computes.

overlap_pct = how much of the serial schedule's upload cost the prefetch
schedule hides: (serial - prefetch) / (serial - resident).

The uploaded data are scatterer batches (all float), the input real
RadarScenes runs stream.

Usage: python scripts/bench_prefetch.py [--frames 256] [--chunk 16]
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--scatterers", type=int, default=512,
                    help="static scatterer capacity (upload volume knob; "
                         "512 = the library default for dense RadarScenes "
                         "frames)")
    args = ap.parse_args()

    from radar_slam_tpu.utils.device import require_gpu
    require_gpu()

    from radar_slam_tpu.core.config import complete_analysis_config
    from radar_slam_tpu.io import prefetch
    from radar_slam_tpu.io.synthetic import SceneConfig, constant_motion_scene
    from radar_slam_tpu.pipeline import frame as frame_mod

    cfg = dataclasses.replace(complete_analysis_config(),
                              max_scatterers=args.scatterers)
    F, C = args.frames, args.chunk
    batches, _ = constant_motion_scene(
        7, num_frames=F, dt=cfg.frame_dt, v_body=(8.0, 0.5), yaw_rate=0.05,
        scene=SceneConfig(num_points=96, max_scatterers=cfg.max_scatterers))
    host = jax.tree.map(np.asarray, batches)     # all-float host pytree
    mb = sum(x.nbytes for x in jax.tree.leaves(host)) / 1e6
    key = jax.random.key(0, impl="rbg")
    keys = jax.random.split(key, ((F + C - 1) // C) * C)

    def force(out):
        return float(np.asarray(out.pose[-1, 0]))

    # Warm compiles on one chunk.
    state0 = frame_mod.init_state(cfg)
    warm = jax.device_put(jax.tree.map(lambda x: x[:C], host))
    _, out = prefetch._chunk_step(state0, warm, keys[:C], cfg)
    force(out)

    def run_resident():
        dev = jax.device_put(host)
        jax.block_until_ready(jax.tree.leaves(dev))
        t0 = time.perf_counter()
        state = frame_mod.init_state(cfg)
        outs = []
        for i in range(F // C):
            state, out = prefetch._chunk_step(
                state, jax.tree.map(lambda x: x[i * C:(i + 1) * C], dev),
                keys[i * C:(i + 1) * C], cfg)
            outs.append(out)
        force(outs[-1])
        return time.perf_counter() - t0

    def run_serial():
        t0 = time.perf_counter()
        state = frame_mod.init_state(cfg)
        outs = []
        for i in range(F // C):
            buf = jax.device_put(
                jax.tree.map(lambda x: x[i * C:(i + 1) * C], host))
            jax.block_until_ready(jax.tree.leaves(buf))   # no overlap
            state, out = prefetch._chunk_step(
                state, buf, keys[i * C:(i + 1) * C], cfg)
            jax.block_until_ready(out.pose)
            outs.append(out)
        force(outs[-1])
        return time.perf_counter() - t0

    def run_prefetch():
        t0 = time.perf_counter()
        out = prefetch.process_sequence_prefetch(host, key, cfg, chunk=C)
        force(out)
        return time.perf_counter() - t0

    res = {}
    for name, fn in [("resident", run_resident), ("serial", run_serial),
                     ("prefetch", run_prefetch)]:
        best = min(fn() for _ in range(args.trials))
        res[name] = round(best, 4)

    upload_cost = res["serial"] - res["resident"]
    hidden = res["serial"] - res["prefetch"]
    out = {
        "device": str(jax.devices()[0]),
        "frames": F, "chunk": C, "host_mb": round(mb, 1),
        "resident_s": res["resident"], "serial_s": res["serial"],
        "prefetch_s": res["prefetch"],
        "upload_cost_s": round(upload_cost, 4),
        "overlap_pct": round(100.0 * hidden / max(upload_cost, 1e-9), 1),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
