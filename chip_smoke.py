#!/usr/bin/env python3
"""Smoke test: the radar ego-motion main path on one NVIDIA GPU.

Everything runs in this one process, through the entry points a user
calls, at ``complete_analysis_config()`` as shipped (32 chirps x 8
antennas x 400 samples, ``max_scatterers=512``):

1. device: refuse anything but a GPU; print the JAX device identity, the
   card's name and power limit (``nvidia-smi``) and the compile cache;
2. compare: each front-end and back-end stage on the GPU against the same
   stage on the host CPU, at real widths on a 16-frame corridor, each
   worst error beside its stated tolerance and the stage's matmul
   precisions;
3. main path: ``process_sequence_batched`` under the accuracy gates of
   ``bench.py`` and on a 2,048-frame corridor, ``process_sequence_chunked``
   and ``process_sequence`` on 512 frames, the 4-sensor
   ``process_sequence_rig_batched``, and in-process CLI calls; each with
   wall time (``block_until_ready``), compile time and peak device memory;
4. the ``gpu``-marked tests.

Any failed phase makes the exit code non-zero.  On success the last line
of standard output is ``{"ok": true, "device": {...}}``.

    python chip_smoke.py                     # one card
    python chip_smoke.py --four-gpus         # the 4-card mesh path only
    python chip_smoke.py --report out.json   # also write every number
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Accuracy gates of bench.py (the benchmark only counts if the pipeline
# works): final open-loop pose error and trajectory RMSE of the 64-frame
# corridor, MUSIC on the same scene, the movers+clutter mismatch scene
# inside the reference's parity bound, and the 4-sensor rig.
GATES = {"final_pose_err_m": 0.35, "pos_rmse_m": 0.16,
         "music_pos_rmse_m": 0.15, "adversarial_rmse_m": 0.777,
         "rig_pos_rmse_m": 0.10, "solve_success_rate": 0.9}

# GPU-vs-CPU tolerances, per stage, with the reason for each.
TOLERANCES = {
    # f32 rounding of the 512-term HIGHEST contraction and ulp-level
    # differences of the transcendentals, relative to the cube's peak.
    "synth_cube_rel": 1e-4,
    # f32 FFT rounding (cuFFT vs the CPU FFT), relative to the map's peak.
    "rds_power_rel": 1e-4,
    # Same power map in, elementwise f32 thresholds: the set is identical.
    "detection_mismatched_cells": 0,
    # Unit-norm signatures from a HIGHEST contraction.
    "signatures_abs": 1e-4,
    # 0.05 deg is 4 cm across-range at 50 m, a quarter of the 0.16 m RMSE
    # gate; the 2 deg grid's parabolic refinement is continuous, so a
    # near-tie moving the argmax one cell moves the angle far less.
    "angle_deg": 0.05,
    # 1 mm/s and 1 mrad/s: an order below the cm/s scale the carrier-phase
    # refinement resolves.
    "solve_velocity": 1e-3,
    # 16-frame end-to-end poses: 1 cm, under a tenth of the RMSE gate.
    "pose_m": 1e-2,
}


def _import_repo():
    sys.path.insert(0, str(ROOT))
    try:
        import radar_slam_tpu  # noqa: F401
    except ImportError as e:
        raise SystemExit(
            f"chip_smoke.py: cannot import the radar_slam_tpu package beside "
            f"this script ({e}); run it from a checkout of the repository")


# ---------------------------------------------------------------- helpers

def timed(fn, reps: int = 3):
    """(output, times) of ``fn()``: the first call (compile + run) and the
    median of ``reps`` further calls, each ended by ``block_until_ready``;
    compile time is the difference."""
    import jax
    import numpy as np

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    steady = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        steady.append(time.perf_counter() - t0)
    med = float(np.median(steady))
    return out, {"first_s": first, "steady_s": med,
                 "compile_s": max(first - med, 0.0)}


def peak_bytes(device=None):
    """``peak_bytes_in_use`` of the device so far in this process (the
    allocator's high-water mark; it never decreases), or None where the
    backend keeps no statistics."""
    import jax

    stats = (device or jax.devices()[0]).memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


def dot_precisions(fn, *args):
    """The matmul precisions a stage compiles with, read from its jaxpr:
    ``{"dot_general": sorted precisions, "fft": count}``.  ``DEFAULT`` on
    an NVIDIA GPU lets XLA run f32 dots in TF32."""
    import jax

    precisions, ffts = set(), [0]

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            name = eqn.primitive.name
            if name == "dot_general":
                p = eqn.params.get("precision")
                if p is None:
                    precisions.add("DEFAULT")
                else:
                    precisions.update(str(q).split(".")[-1] for q in p)
            elif name == "fft":
                ffts[0] += 1
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return {"dot_general": sorted(precisions), "fft": ffts[0]}


def corridor(cfg, frames: int, seed: int = 7):
    """The bench corridor: 96 static points along a path driven at
    (8, 0.5) m/s with a 0.05 rad/s yaw rate."""
    from radar_slam_tpu.io.synthetic import SceneConfig, constant_motion_scene
    return constant_motion_scene(
        seed, num_frames=frames, dt=cfg.frame_dt, v_body=(8.0, 0.5),
        yaw_rate=0.05,
        scene=SceneConfig(num_points=96, max_scatterers=cfg.max_scatterers))


def _pose_metrics(pose, gt_poses):
    import numpy as np

    from radar_slam_tpu.evaluate.pose_metrics import planar_pose_errors
    pose, gt = np.asarray(pose), np.asarray(gt_poses)
    return (float(np.linalg.norm(pose[-1, :2] - gt[-1, :2])),
            float(planar_pose_errors(pose, gt)["position_rmse"]))


# ----------------------------------------------------------- phase: compare

def compare_stages(cfg, frames: int, accel, ref) -> dict:
    """Every stage of the batched driver on ``accel`` against the same
    stage on ``ref`` (the host CPU), each fed the SAME reference inputs so
    errors do not compound.  Noise comes from a threefry key: its bits are
    the same on every backend."""
    import jax
    import numpy as np

    from radar_slam_tpu.pipeline import frame as pipe
    from radar_slam_tpu.signal.detect import detect_peaks_from_power
    from radar_slam_tpu.signal.rds import detection_signatures, rds_power
    from radar_slam_tpu.signal.synth import synthesize_frame

    batches, _ = corridor(cfg, frames)
    batches = jax.device_get(batches)
    key = jax.random.key(0, impl="threefry2x32")
    keydata = np.asarray(jax.device_get(
        jax.random.key_data(jax.random.split(key, frames))))
    radar = cfg.radar

    def on(dev, fn, *args):
        args = jax.device_put(args, dev)
        return jax.device_get(jax.jit(fn)(*args))

    def both(fn, *args):
        return on(accel, fn, *args), on(ref, fn, *args)

    def synth(b, kd):
        return jax.vmap(lambda sc, k: synthesize_frame(
            sc, radar, jax.random.wrap_key_data(k, impl="threefry2x32"),
            fidelity=cfg.synth_fidelity))(b, kd)

    def power(cube):
        return rds_power(cube, radar, window=cfg.window,
                         chirp_subset=cfg.chirp_subset,
                         doppler_window=cfg.doppler_window)

    def detect(p):
        return jax.vmap(lambda x: detect_peaks_from_power(
            x, radar, cfg.detection))(p)

    def signatures(cube, rb, db):
        return jax.vmap(lambda x, r, d: detection_signatures(
            x, r, d, radar, window=cfg.window,
            chirp_subset=cfg.chirp_subset,
            doppler_window=cfg.doppler_window))(cube, rb, db)

    stages = {}

    def record(name, err, tol, fn, *args):
        stages[name] = {"err": float(err), "tol": tol,
                        "ok": bool(err <= tol),
                        "precision": dot_precisions(fn, *args)}

    cube_a, cube = both(synth, batches, keydata)
    record("synth_cube", np.abs(cube_a - cube).max() / np.abs(cube).max(),
           TOLERANCES["synth_cube_rel"], synth, batches, keydata)

    p_a, p = both(power, cube)
    record("rds_power", np.abs(p_a - p).max() / np.abs(p).max(),
           TOLERANCES["rds_power_rel"], power, cube)

    det_a, det = both(detect, p)
    v = np.asarray(det.valid)
    mism = int(np.sum(v != np.asarray(det_a.valid))
               + np.sum((np.asarray(det_a.range_bin) != det.range_bin) & v)
               + np.sum((np.asarray(det_a.doppler_bin) != det.doppler_bin)
                        & v))
    record("detection", mism, TOLERANCES["detection_mismatched_cells"],
           detect, p)
    stages["detection"]["detections"] = int(v.sum())

    s_a, sigs = both(signatures, cube, det.range_bin, det.doppler_bin)
    record("signatures", np.abs(s_a - sigs)[v].max() if v.any() else 0.0,
           TOLERANCES["signatures_abs"], signatures, cube, det.range_bin,
           det.doppler_bin)

    features = None
    for method in ("beamforming", "music", "esprit"):
        cfg_m = dataclasses.replace(
            cfg, aoa=dataclasses.replace(cfg.aoa, method=method))

        def aoa(d, s, cfg_m=cfg_m):
            return jax.vmap(lambda dd, ss: pipe._aoa_features(dd, ss, cfg_m))(
                d, s)

        f_a, f = both(aoa, det, sigs)
        keep = np.asarray(f[2])
        err = (np.abs(np.asarray(f_a[5]) - np.asarray(f[5]))[keep].max()
               if keep.any() else 0.0)
        record(f"angles_{method}", err, TOLERANCES["angle_deg"], aoa, det,
               sigs)
        if method == cfg.aoa.method:
            features = f

    def phase_b(feats):
        return pipe._sequence_from_features(feats, cfg, True)

    o_a, o = both(phase_b, features)
    err = max(np.abs(o_a.motion.velocity - o.motion.velocity).max(),
              np.abs(o_a.motion.angular_velocity
                     - o.motion.angular_velocity).max())
    record("solve", err, TOLERANCES["solve_velocity"], phase_b, features)

    def e2e(b, k):
        return pipe.process_sequence_batched(
            b, jax.random.wrap_key_data(k, impl="threefry2x32"), cfg)

    kd0 = np.asarray(jax.device_get(jax.random.key_data(key)))
    e_a, e = both(e2e, batches, kd0)
    record("poses", np.abs(np.asarray(e_a.pose) - np.asarray(e.pose)).max(),
           TOLERANCES["pose_m"], e2e, batches, kd0)

    return {"ok": all(s["ok"] for s in stages.values()), "frames": frames,
            "stages": stages}


# -------------------------------------------------------- phase: main path

def batched_gates(cfg, frames: int = 64) -> dict:
    """``process_sequence_batched`` on the bench corridor, MUSIC on the same
    scene and the movers+clutter mismatch scene, held to ``GATES`` with
    bench.py's noise key (``rbg``, seed 0).  The gates hold one noise
    realization; ``spread`` reports the same metrics for threefry seeds
    0-3, ungated, to show how much the realization alone moves them."""
    import jax
    import numpy as np

    from radar_slam_tpu.io.synthetic import (MismatchConfig, SceneConfig,
                                             mismatch_scene)
    from radar_slam_tpu.pipeline import frame as pipe

    key = jax.random.key(0, impl="rbg")
    batches, gt = corridor(cfg, frames)
    out, t = timed(lambda: pipe.process_sequence_batched(batches, key, cfg))
    final_err, rmse = _pose_metrics(out.pose, gt["poses"])
    success = float(np.asarray(out.motion.success)[1:].mean())

    cfg_music = dataclasses.replace(
        cfg, aoa=dataclasses.replace(cfg.aoa, method="music"))
    out_m, t_m = timed(
        lambda: pipe.process_sequence_batched(batches, key, cfg_music))
    _, music_rmse = _pose_metrics(out_m.pose, gt["poses"])

    mm = MismatchConfig(num_movers=4, mover_points=3, mover_oncoming=True,
                        clutter_per_frame=10)
    adv_b, adv_gt = mismatch_scene(
        3, 12, cfg.frame_dt, (8.0, 0.5), 0.1,
        SceneConfig(num_points=48, max_scatterers=cfg.max_scatterers), mm)
    out_a = pipe.process_sequence_batched(adv_b, key, cfg)
    _, adv_rmse = _pose_metrics(out_a.pose, adv_gt["poses"])

    spread = []
    for seed in range(4):
        o = pipe.process_sequence_batched(
            batches, jax.random.key(seed, impl="threefry2x32"), cfg)
        spread.append(dict(zip(("final_pose_err_m", "pos_rmse_m"),
                               _pose_metrics(o.pose, gt["poses"]))))

    metrics = {"final_pose_err_m": final_err, "pos_rmse_m": rmse,
               "music_pos_rmse_m": music_rmse,
               "adversarial_rmse_m": adv_rmse,
               "solve_success_rate": success}
    ok = (final_err <= GATES["final_pose_err_m"]
          and rmse <= GATES["pos_rmse_m"]
          and music_rmse <= GATES["music_pos_rmse_m"]
          and adv_rmse <= GATES["adversarial_rmse_m"]
          and success > GATES["solve_success_rate"])
    return {"ok": bool(ok), "frames": frames, **metrics, "spread": spread,
            "time": t, "time_music": t_m, "peak_bytes": peak_bytes()}


def batched_long(cfg, frames: int = 2048) -> dict:
    """The batched driver over a long corridor: a few windows of real work
    (one [F, 8, 32, 400] complex64 cube pass is ~1.7 GB at 2,048 frames).
    Over 1.6 km the 96-point corridor leaves only a few points in view per
    frame, so accuracy is gated on the 64-frame scene; here every output
    must be finite, and the solve success rate and the forward-velocity
    error of the solved frames are reported."""
    import jax
    import numpy as np

    from radar_slam_tpu.pipeline import frame as pipe

    key = jax.random.key(0)
    batches, gt = corridor(cfg, frames)
    out, t = timed(lambda: pipe.process_sequence_batched(batches, key, cfg))
    success = np.asarray(out.motion.success)
    vel = np.asarray(out.motion.velocity)
    v_err = np.abs(vel[success, 0] - float(gt["velocity_body"][0]))
    finite = all(np.isfinite(np.asarray(x)).all() for x in
                 (out.pose, out.motion.velocity,
                  out.motion.angular_velocity))
    return {"ok": bool(finite), "frames": frames,
            "solve_success_rate": float(success[1:].mean()),
            "solved_vx_err_median_mps": (float(np.median(v_err))
                                         if v_err.size else None),
            "frames_per_s": frames / t["steady_s"], "time": t,
            "peak_bytes": peak_bytes()}


def sequential_drivers(cfg, frames: int = 512) -> dict:
    """``process_sequence_chunked`` (batched phase A per 16-frame window,
    Jacobi-relaxed prior) against ``process_sequence`` (the exact scan):
    both carry the temporal prior, so they differ by the prior's
    second-order relaxation and float reassociation."""
    import jax
    import numpy as np

    from radar_slam_tpu.pipeline import frame as pipe

    key = jax.random.key(0)
    batches, gt = corridor(cfg, frames)
    out_c, t_c = timed(lambda: pipe.process_sequence_chunked(
        batches, key, cfg))
    out_s, t_s = timed(lambda: pipe.process_sequence(batches, key, cfg),
                       reps=1)
    diff = float(np.abs(np.asarray(out_c.pose)
                        - np.asarray(out_s.pose)).max())
    _, rmse_c = _pose_metrics(out_c.pose, gt["poses"])
    _, rmse_s = _pose_metrics(out_s.pose, gt["poses"])
    succ = [float(np.asarray(o.motion.success)[1:].mean())
            for o in (out_c, out_s)]
    # The 5 mm per 16 frames that tests/test_xla_frontend.py holds the
    # drivers to at the main config, grown with the path (open-loop pose
    # integrates every frame's difference).
    tol = 5e-3 * frames / 16
    ok = bool(diff <= tol and min(succ) > GATES["solve_success_rate"]
              and np.isfinite(np.asarray(out_c.pose)).all())
    return {"ok": ok, "frames": frames, "chunked_vs_scan_pose_m": diff,
            "tol_m": tol, "chunked_pos_rmse_m": rmse_c,
            "scan_pos_rmse_m": rmse_s, "solve_success_rate": min(succ),
            "chunked_frames_per_s": frames / t_c["steady_s"],
            "scan_frames_per_s": frames / t_s["steady_s"],
            "time_chunked": t_c, "time_scan": t_s,
            "peak_bytes": peak_bytes()}


RIG4 = ((3.6, 0.8, 0.55), (3.6, -0.8, -0.55),
        (2.4, 0.9, 1.48), (2.4, -0.9, -1.48))


def rig_batched(cfg, frames: int = 32) -> dict:
    """The 4-sensor mounted rig (RadarScenes-like mounts, as in bench.py)
    through ``process_sequence_rig_batched``."""
    import jax

    from radar_slam_tpu.io.synthetic import (SceneConfig,
                                             constant_motion_scene_rig)
    from radar_slam_tpu.pipeline import rig as rigmod

    batches, gt = constant_motion_scene_rig(
        7, num_frames=frames, dt=cfg.frame_dt, v_body=(8.0, 0.5),
        yaw_rate=0.05,
        scene=SceneConfig(num_points=96, max_scatterers=cfg.max_scatterers),
        rig=RIG4)
    key = jax.random.key(0, impl="rbg")
    out, t = timed(lambda: rigmod.process_sequence_rig_batched(
        batches, key, cfg, RIG4))
    _, rmse = _pose_metrics(out.pose, gt["poses"])
    return {"ok": bool(rmse <= GATES["rig_pos_rmse_m"]), "frames": frames,
            "rig_pos_rmse_m": rmse,
            "rig_frames_per_s": frames / t["steady_s"], "time": t,
            "peak_bytes": peak_bytes()}


CLI_CALLS = (("quick-compare", "--frames", "10"),
             ("analyze", "--max-frames", "16", "--slam", "--slam-solver",
              "schur"))


def cli_calls(calls=CLI_CALLS) -> dict:
    """In-process calls of the CLI entry point, each twice: the first pays
    compilation, the second is the steady wall time."""
    from radar_slam_tpu.pipeline import cli

    runs = {}
    for argv in calls:
        walls, rcs, text = [], [], ""
        for _ in range(2):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rcs.append(cli.main(list(argv)))
            walls.append(time.perf_counter() - t0)
            text = buf.getvalue()
        runs[" ".join(argv)] = {
            "rc": rcs, "first_s": walls[0], "steady_s": walls[1],
            "compile_s": max(walls[0] - walls[1], 0.0),
            "last_line": text.strip().splitlines()[-1] if text else ""}
    return {"ok": all(r["rc"] == [0, 0] for r in runs.values()),
            "calls": runs, "peak_bytes": peak_bytes()}


class _Outcomes:
    """pytest plugin: node ids by outcome, and each module that failed to
    import with the last line of its error."""

    def __init__(self):
        self.passed, self.failed, self.skipped = [], [], []
        self.errors = {}

    def pytest_runtest_logreport(self, report):
        if report.failed:
            self.failed.append(report.nodeid)
        elif report.skipped:
            self.skipped.append(report.nodeid)
        elif report.when == "call":
            self.passed.append(report.nodeid)

    def pytest_collectreport(self, report):
        if report.failed:
            lines = str(report.longrepr).strip().splitlines()
            self.errors[report.nodeid] = lines[-1] if lines else ""


def gpu_tests() -> dict:
    """The ``gpu``-marked tests, in this process (one JAX process holds
    the card).  Every test module must import and every selected test
    must pass: on the card a skip means the test did not find it."""
    import pytest

    seen = _Outcomes()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          str(ROOT / "tests")], plugins=[seen])
    ok = (int(rc) == 0 and bool(seen.passed) and not seen.failed
          and not seen.skipped and not seen.errors)
    return {"ok": ok, "rc": int(rc), "passed": len(seen.passed),
            "failed": seen.failed, "skipped": seen.skipped,
            "collection_errors": seen.errors}


# ------------------------------------------------------- phase: four cards

def four_gpu_mesh(cfg, frames: int = 512, n: int = 4) -> dict:
    """The paths users run across devices, on an ``n``-card 1-D mesh, each
    against its single-device form: the frame-parallel scatterer driver
    vs ``process_sequence_batched``; the distributed GN-CG vs
    ``mesh=None``; the Schur step and the batched full-mesh Schur solve
    vs a 1-device mesh."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from radar_slam_tpu.parallel import ba, dp, multiseq, posegraph
    from radar_slam_tpu.parallel.mesh import make_mesh
    from radar_slam_tpu.pipeline import frame as pipe

    mesh, mesh1 = make_mesh(n), make_mesh(1)
    key = jax.random.key(7)
    batches, _ = corridor(cfg, frames)
    out_n, t_n = timed(lambda: dp.process_frames_dp_scatterers(
        batches, key, cfg, mesh))
    out_1, t_1 = timed(lambda: pipe.process_sequence_batched(
        batches, key, cfg))
    checks = {"dp_pose_m": float(np.abs(np.asarray(out_n["pose"])
                                        - np.asarray(out_1.pose)).max()),
              "dp_velocity_mps": float(np.abs(
                  np.asarray(out_n["velocity"])
                  - np.asarray(out_1.motion.velocity)).max())}

    # Pose graph of the same run, with one loop closure between its ends
    # (exercises the Woodbury correction of the Schur step).
    N = frames
    graph = posegraph.from_velocities(
        out_1.motion.velocity[:N - 1],
        out_1.motion.angular_velocity[:N - 1, 2],
        out_1.motion.success[:N - 1], cfg.frame_dt, loop_capacity=1)
    gt_delta = jnp.asarray(graph.poses[-1] - graph.poses[0])
    graph = posegraph.add_loop_closure(graph, 0, 0, N - 1, gt_delta,
                                       jnp.array([50.0, 50.0, 200.0]))
    (p_n, c_n), t_cg = timed(lambda: ba.gauss_newton_cg(graph, mesh=mesh))
    p_1, c_1 = ba.gauss_newton_cg(graph, mesh=None)
    checks["gn_cg_pose_m"] = float(np.abs(np.asarray(p_n)
                                          - np.asarray(p_1)).max())
    s_n, t_schur = timed(lambda: ba.schur_gn_step(graph, mesh))
    s_1 = ba.schur_gn_step(graph, mesh1)
    checks["schur_pose_m"] = float(np.abs(np.asarray(s_n)
                                          - np.asarray(s_1)).max())
    batch = jax.tree.map(lambda x: jnp.stack([x, x]), graph)
    (b_n, bc_n), t_ms = timed(
        lambda: multiseq.solve_graphs_mesh(batch, mesh, steps=2))
    b_1, _ = multiseq.solve_graphs_mesh(batch, mesh1, steps=2)
    checks["solve_graphs_mesh_pose_m"] = float(np.abs(
        np.asarray(b_n) - np.asarray(b_1)).max())
    # Sums over blocks in another order: the frame-parallel driver holds
    # 1e-5 on the CPU mesh (tests/test_parallel.py); a pose-graph solve of
    # 512 keyframes amplifies f32 reassociation, so 1 mm.
    tol = {"dp_pose_m": 1e-3, "dp_velocity_mps": 1e-3,
           "gn_cg_pose_m": 1e-3, "schur_pose_m": 1e-3,
           "solve_graphs_mesh_pose_m": 1e-3}
    ok = all(np.isfinite(v) and v <= tol[k] for k, v in checks.items())
    return {"ok": bool(ok), "devices": n, "frames": frames,
            "checks": checks, "tol": tol,
            "time_dp": t_n, "time_single": t_1, "time_gn_cg": t_cg,
            "time_schur": t_schur, "time_solve_graphs_mesh": t_ms,
            "dp_frames_per_s": frames / t_n["steady_s"],
            "single_frames_per_s": frames / t_1["steady_s"],
            "peak_bytes": [peak_bytes(d) for d in jax.devices()[:n]]}


# ------------------------------------------------------------------ driver

def _run(name, fn, report):
    t0 = time.perf_counter()
    try:
        res = fn()
    except Exception:  # a phase that raises is a failed phase
        res = {"ok": False, "error": traceback.format_exc(limit=8)}
    res["wall_s"] = time.perf_counter() - t0
    report[name] = res
    print(f"[{name}] {'PASS' if res['ok'] else 'FAIL'} "
          f"{json.dumps(res, default=str)}", flush=True)
    return res["ok"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-card mesh path and its "
                         "single-device comparison")
    ap.add_argument("--report", default=None,
                    help="also write every phase's numbers to this JSON file")
    args = ap.parse_args(argv)

    _import_repo()
    import jax

    from radar_slam_tpu.core.config import complete_analysis_config
    from radar_slam_tpu.utils.compile_cache import enable_compile_cache
    from radar_slam_tpu.utils.device import (card_name_and_power_limit,
                                             require_gpu)

    n = 4 if args.four_gpus else 1
    device = require_gpu(n)
    cache = enable_compile_cache()
    card = card_name_and_power_limit()
    print(f"jax {jax.__version__}; devices: {json.dumps(device)}; "
          f"compile cache: {cache}", flush=True)
    print(f"nvidia-smi: {card}", flush=True)

    cfg = complete_analysis_config()
    report = {"device": device, "card": card, "jax": jax.__version__,
              "compile_cache": str(cache)}
    if args.four_gpus:
        phases = [("four_gpu_mesh", lambda: four_gpu_mesh(cfg, n=n))]
    else:
        cpu = jax.devices("cpu")[0]
        phases = [
            ("compare", lambda: compare_stages(cfg, 16, jax.devices()[0],
                                               cpu)),
            ("batched_gates", lambda: batched_gates(cfg)),
            ("batched_long", lambda: batched_long(cfg)),
            ("sequential_drivers", lambda: sequential_drivers(cfg)),
            ("rig_batched", lambda: rig_batched(cfg)),
            ("cli", cli_calls),
            ("gpu_tests", gpu_tests),
        ]
    t0 = time.perf_counter()
    ok = all([_run(name, fn, report) for name, fn in phases])
    report["total_s"] = time.perf_counter() - t0
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(report, indent=2,
                                                default=str))
    if not ok:
        failed = [k for k, v in report.items()
                  if isinstance(v, dict) and v.get("ok") is False]
        print(f"chip_smoke.py: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
