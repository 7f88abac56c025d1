#!/usr/bin/env python3
"""Per-AoA-method end-to-end throughput + isolated estimator cost on the
active device (VERDICT round-2 item 3: MUSIC/ESPRIT "measured per-method
frames/s published").

The reference's batch pipeline runs MUSIC as its step-3 estimator
(``scripts/run_ego_motion_pipeline.py:183`` ->
``src/angle_estimation/angle_estimation.py:253``); this measures what each
estimator costs at the production operating point (64-frame batches,
top-50 targets, 2 deg grid -> 91-point MUSIC spectrum per target).

Usage: python scripts/bench_aoa_methods.py [--f1 64] [--f2 256]
"""

import argparse
import dataclasses
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
    return jnp.sum(jnp.real(leaf).reshape(-1)[:4]).astype(jnp.float32)


def chained_time(fn, x0, iters=32):
    @jax.jit
    def chained(x, n):
        def body(i, acc):
            xi = jax.tree.map(lambda a: a * (1 + 1e-7 * i)
                              if jnp.issubdtype(a.dtype, jnp.inexact) else a,
                              x)
            return acc + _scalar(fn(xi))
        return jax.lax.fori_loop(0, n, body, jnp.float32(0.0))

    def t(n):
        float(np.asarray(chained(x0, n)))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            float(np.asarray(chained(x0, n)))
            best = min(best, time.perf_counter() - t0)
        return best

    base = max(iters // 4, 1)
    return max(t(iters) - t(base), 1e-12) / (iters - base)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--f1", type=int, default=64)
    ap.add_argument("--f2", type=int, default=256)
    ap.add_argument("--method", default=None,
                    choices=("beamforming", "music", "esprit"),
                    help="run ONE method in this process (default: spawn "
                         "a subprocess per method so a backend crash "
                         "cannot take down the other measurements)")
    args = ap.parse_args()

    from radar_slam_tpu.utils.device import require_gpu
    require_gpu()

    if args.method is None:
        import subprocess
        for m in ("beamforming", "music", "esprit"):
            r = subprocess.run(
                [sys.executable, __file__, "--f1", str(args.f1),
                 "--f2", str(args.f2), "--method", m],
                timeout=2400)
            if r.returncode != 0:
                print(f"{m}: FAILED (rc={r.returncode})", flush=True)
        return

    from radar_slam_tpu.aoa import estimators
    from radar_slam_tpu.core.config import complete_analysis_config
    from radar_slam_tpu.evaluate.pose_metrics import planar_pose_errors
    from radar_slam_tpu.io.synthetic import SceneConfig, constant_motion_scene
    from radar_slam_tpu.pipeline import frame as pipe

    base = dataclasses.replace(complete_analysis_config(), max_scatterers=128)
    key = jax.random.key(0, impl="rbg")

    def scene(n):
        return constant_motion_scene(
            7, num_frames=n, dt=base.frame_dt, v_body=(8.0, 0.5),
            yaw_rate=0.05,
            scene=SceneConfig(num_points=96, max_scatterers=base.max_scatterers))

    b1, gt1 = scene(args.f1)
    b2, _ = scene(args.f2)

    def time_one(cfg, batches, trials=4):
        def force():
            return float(jax.device_get(
                pipe.process_sequence_batched(batches, key, cfg).pose)[-1, 0])
        force()
        best = float("inf")
        for _ in range(trials):
            t0 = time.perf_counter()
            force()
            best = min(best, time.perf_counter() - t0)
        return best

    # Isolated estimator cost on a realistic signature batch.
    rng = np.random.default_rng(0)
    A = base.radar.num_antennas
    n_sig = args.f1 * base.aoa.max_targets
    sigs = (rng.standard_normal((n_sig, A)).astype(np.float32)
            + 1j * rng.standard_normal((n_sig, A)).astype(np.float32))
    sigs = sigs / np.linalg.norm(sigs, axis=-1, keepdims=True)
    sigs = jax.device_put(sigs.astype(np.complex64))

    iso = {
        "beamforming": lambda s: estimators.estimate_beamforming(
            s, base.radar, base.aoa),
        "music": lambda s: estimators.estimate_music(s, base.radar, base.aoa),
        "esprit": lambda s: estimators.estimate_esprit(s, base.radar),
    }

    out = {"device": str(jax.devices()[0]), "f1": args.f1, "f2": args.f2,
           "methods": {}}
    for method in (args.method,):
        cfg = dataclasses.replace(
            base, aoa=dataclasses.replace(base.aoa, method=method))
        t1 = time_one(cfg, b1)
        t2 = time_one(cfg, b2)
        fps = (args.f2 - args.f1) / max(t2 - t1, 1e-9)
        o = pipe.process_sequence_batched(b1, key, cfg)
        m = planar_pose_errors(jax.device_get(o.pose), np.asarray(gt1["poses"]))
        iso_us = (chained_time(iso[method], sigs) * 1e6
                  if method in iso else None)
        out["methods"][method] = {
            "e2e_fps": round(fps, 1),
            "pos_rmse_m": round(float(m["position_rmse"]), 3),
            "estimator_us_per_3200_signatures": round(iso_us, 1),
        }
        print(f"{method}: {out['methods'][method]}", flush=True)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
