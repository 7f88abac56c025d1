#!/usr/bin/env python3
"""End-to-end benchmark: full radar ego-motion pipeline frames/s on one GPU.

Workload = BASELINE.json config 2 (synthetic raw FMCW): point-cloud
scatterers -> ADC cube synthesis -> range-Doppler power map -> CA-CFAR
detection -> signatures of the detected cells -> robust AoA (beamforming +
confidence + MDL + smoothing) -> association -> two-step 6-DoF velocity
solve -> pose integration, at the reference's complete-analysis operating
point (32 chirps, 8 antennas, 400 samples, 2 deg grid, top-50 targets;
radarscenes_complete_analysis.py:47-87).

Refuses to run unless JAX's default device is an NVIDIA GPU, and prints
the device kind, count, card name and power limit beside the result.

Timing methodology:
- completion is forced by fetching real output data;
- per-frame device time is obtained by DIFFERENCING two sequence lengths
  (one dispatch each), cancelling the constant dispatch/fetch overhead;
- the reported frames/s is (frames_delta) / (T_long - T_short), best of
  several INTERLEAVED trials: 512 vs 2048 frames for the batched-family
  drivers, 64 vs 512 frames for the sequential scan driver;
- per-stage times chain iterations inside one program (fori_loop) and
  difference two iteration counts.

Accuracy gates (the benchmark only counts if the pipeline works):
- ``pos_err_bound_ok``: final open-loop pose error <= 0.35 m over the 51 m /
  64-frame path;
- ``pos_rmse_ok``: trajectory position RMSE <= 0.16 m;
- ``adversarial_ok``: a movers+clutter mismatch scene must stay inside the
  reference parity bound (position RMSE <= 0.777 m);
- ``music_ok``: the same scene with the REFERENCE'S step-3 default
  estimator (MUSIC) must hold <= 0.15 m position RMSE;
- ``rig_ok``: the batched 4-sensor mounted-rig driver (the path real
  RadarScenes data auto-routes to) must hold <= 0.10 m position RMSE on
  its 32-frame scene;
- ``sane`` requires all of the above plus >90 % solve success.

Baseline: the reference's real pipeline runs 3.28-4.14 s/frame on CPU
(results/analysis/output_radarscenes/sequence_9_results.json; BASELINE.md)
-> 0.27 frames/s.  vs_baseline = our frames/s / 0.27.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": "frames/s", "vs_baseline": N, ...}
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def scene(cfg, n_frames):
    from radar_slam_tpu.io.synthetic import SceneConfig, constant_motion_scene
    return constant_motion_scene(
        7, num_frames=n_frames, dt=cfg.frame_dt,
        v_body=(8.0, 0.5), yaw_rate=0.05,
        scene=SceneConfig(num_points=96, max_scatterers=cfg.max_scatterers))


def force(out):
    return float(np.asarray(out.pose[-1, 0]))


def time_one(run, trials=4):
    """Wall time of one dispatch + data-fetch, best of trials."""
    out = run()
    force(out)                            # compile + warm
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        out = run()
        force(out)
        best = min(best, time.perf_counter() - t0)
    return out, best


def time_pair(run1, run2, trials=6):
    """Best wall times of two runs with INTERLEAVED trials.

    The differencing estimate (t2 - t1) is only valid when both
    measurements see the same dispatch conditions; alternating trials
    makes any slow window hit both sides."""
    out1 = run1()
    force(out1)                           # compile + warm both programs
    out2 = run2()
    force(out2)
    b1 = b2 = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        out1 = run1()
        force(out1)
        b1 = min(b1, time.perf_counter() - t0)
        t0 = time.perf_counter()
        out2 = run2()
        force(out2)
        b2 = min(b2, time.perf_counter() - t0)
    return out1, b1, out2, b2


def chained_time(fn, x0, iters=24):
    """Per-call device time: iterate inside one program, difference two
    iteration counts."""
    @jax.jit
    def chained(x, n):
        def body(i, acc):
            xi = jax.tree.map(
                lambda a: a * (1 + 1e-7 * i)
                if jnp.issubdtype(a.dtype, jnp.inexact) else a, x)
            leaf = jax.tree.leaves(fn(xi))[0]
            return acc + jnp.sum(jnp.real(leaf).reshape(-1)[:4]
                                 ).astype(jnp.float32)
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


def stage_breakdown(cfg, batches, key):
    """Device time of the heavy per-frame stages over the 64-frame batch:
    synthesis, power map, detection, signatures."""
    from radar_slam_tpu.signal.detect import detect_peaks_from_power
    from radar_slam_tpu.signal.rds import detection_signatures, rds_power
    from radar_slam_tpu.signal.synth import synthesize_frames_batch

    signals = synthesize_frames_batch(batches, cfg.radar, key)
    p_lin = rds_power(signals, cfg.radar, window=cfg.window,
                      doppler_window=cfg.doppler_window)
    det = jax.jit(jax.vmap(lambda p: detect_peaks_from_power(
        p, cfg.radar, cfg.detection)))(p_lin)

    stages = {
        "synth": chained_time(
            lambda b: synthesize_frames_batch(b, cfg.radar, key), batches),
        "power_fused": chained_time(
            lambda s: rds_power(s, cfg.radar, window=cfg.window,
                                doppler_window=cfg.doppler_window), signals),
        "detect": chained_time(
            lambda p: jax.vmap(lambda x: detect_peaks_from_power(
                x, cfg.radar, cfg.detection))(p), p_lin),
        "signatures": chained_time(
            lambda s: jax.vmap(lambda x, r, d: detection_signatures(
                x, r, d, cfg.radar, window=cfg.window,
                doppler_window=cfg.doppler_window))(
                    s, det.range_bin, det.doppler_bin), signals),
    }
    return {k: round(v * 1e6, 1) for k, v in stages.items()}


def rig_check(cfg):
    """Batched 4-sensor mounted-rig driver: frames/s (differenced) and
    position RMSE on a RadarScenes-like mounting geometry.  The CLI
    auto-routes real datasets with sensors.json to this path."""
    from radar_slam_tpu.evaluate.pose_metrics import planar_pose_errors
    from radar_slam_tpu.io.synthetic import (SceneConfig,
                                             constant_motion_scene_rig)
    from radar_slam_tpu.pipeline import rig as rigmod

    rig4 = ((3.6, 0.8, 0.55), (3.6, -0.8, -0.55),
            (2.4, 0.9, 1.48), (2.4, -0.9, -1.48))

    def rig_scene(n):
        return constant_motion_scene_rig(
            7, num_frames=n, dt=cfg.frame_dt, v_body=(8.0, 0.5),
            yaw_rate=0.05,
            scene=SceneConfig(num_points=96,
                              max_scatterers=cfg.max_scatterers), rig=rig4)

    # The accuracy gate stays on the 32-frame scene it was calibrated on
    # (open-loop drift grows with path length).
    f0, f1, f2 = 32, 64, 512
    b0, gt0 = rig_scene(f0)
    b1, _ = rig_scene(f1)
    b2, _ = rig_scene(f2)
    key = jax.random.key(0, impl="rbg")
    out0 = rigmod.process_sequence_rig_batched(b0, key, cfg, rig4)
    force(out0)
    _, t1, _, t2 = time_pair(
        lambda: rigmod.process_sequence_rig_batched(b1, key, cfg, rig4),
        lambda: rigmod.process_sequence_rig_batched(b2, key, cfg, rig4))
    fps = (f2 - f1) / max(t2 - t1, 1e-9)
    m = planar_pose_errors(np.asarray(out0.pose), np.asarray(gt0["poses"]))
    rmse = round(float(m["position_rmse"]), 3)
    return round(fps, 1), rmse, bool(rmse <= 0.10)


def adversarial_check(cfg):
    """Movers + clutter mismatch scene through the batched driver; the
    parity bound (0.777 m position RMSE) is the pass line."""
    from radar_slam_tpu.evaluate.pose_metrics import planar_pose_errors
    from radar_slam_tpu.io.synthetic import (MismatchConfig, SceneConfig,
                                             mismatch_scene)
    from radar_slam_tpu.pipeline import frame as pipe

    mm = MismatchConfig(num_movers=4, mover_points=3, mover_oncoming=True,
                        clutter_per_frame=10)
    batches, gt = mismatch_scene(
        3, 12, cfg.frame_dt, (8.0, 0.5), 0.1,
        SceneConfig(num_points=48, max_scatterers=cfg.max_scatterers), mm)
    out = pipe.process_sequence_batched(batches, jax.random.key(0), cfg)
    m = planar_pose_errors(np.asarray(out.pose), np.asarray(gt["poses"]))
    return round(float(m["position_rmse"]), 3), bool(
        m["position_rmse"] <= 0.777)


def main():
    import dataclasses

    from radar_slam_tpu.utils.compile_cache import enable_compile_cache
    from radar_slam_tpu.utils.device import (card_name_and_power_limit,
                                             require_gpu)

    device = require_gpu()
    card = card_name_and_power_limit()
    print(f"device: {json.dumps(device)}; nvidia-smi: {card}",
          file=sys.stderr)
    enable_compile_cache()

    from radar_slam_tpu.core.config import complete_analysis_config
    from radar_slam_tpu.evaluate.pose_metrics import planar_pose_errors
    from radar_slam_tpu.pipeline import frame as pipe

    # Right-size the static scatterer capacity to the workload (96 points);
    # the library default of 512 exists for dense RadarScenes frames and
    # spends most of the synthesis matmul multiplying padding at this
    # operating point.  Capacity is a static-shape knob, not physics: the
    # 96 observed scatterers are identical either way.
    cfg = dataclasses.replace(complete_analysis_config(), max_scatterers=128)
    # Batched-family drivers (headline, MUSIC, chunked) difference
    # f2=512 vs f3=2048; the scan driver differences f1=64 vs f2=512.  The
    # 64-frame batch feeds the accuracy gates.
    f1, f2, f3 = 64, 512, 2048
    batches1, gt1 = scene(cfg, f1)
    batches2, _ = scene(cfg, f2)
    batches3, _ = scene(cfg, f3)

    # RBG PRNG for the synthesis AWGN (the key's impl propagates through
    # every split); which generator is cheaper on the card is open
    # (ROADMAP.md, queue 1).
    key = jax.random.key(0, impl="rbg")
    out1, t1 = time_one(
        lambda: pipe.process_sequence_batched(batches1, key, cfg))
    _, t2b, _, t3b = time_pair(
        lambda: pipe.process_sequence_batched(batches2, key, cfg),
        lambda: pipe.process_sequence_batched(batches3, key, cfg))
    fps = (f3 - f2) / max(t3b - t2b, 1e-9)

    _, t1s, _, t2s = time_pair(
        lambda: pipe.process_sequence(batches1, key, cfg),
        lambda: pipe.process_sequence(batches2, key, cfg))
    fps_scan = (f2 - f1) / max(t2s - t1s, 1e-9)

    # Chunked (sequential-semantics) driver: batched phase A per 16-frame
    # window + Jacobi-relaxed prior chain (pipeline/frame.py:
    # process_sequence_chunked).
    _, t2c, _, t3c = time_pair(
        lambda: pipe.process_sequence_chunked(batches2, key, cfg),
        lambda: pipe.process_sequence_chunked(batches3, key, cfg))
    fps_chunked = (f3 - f2) / max(t3c - t2c, 1e-9)

    # Accuracy gates: the benchmark only counts if the pipeline works.
    ok = np.asarray(out1.motion.success)
    pose_np = np.asarray(out1.pose)
    gt_np = np.asarray(gt1["poses"])
    pose_err = float(np.linalg.norm(pose_np[-1][:2] - gt_np[-1][:2]))
    pos_rmse = round(float(
        planar_pose_errors(pose_np, gt_np)["position_rmse"]), 3)
    pos_err_bound_ok = pose_err <= 0.35
    pos_rmse_ok = pos_rmse <= 0.16
    adv_rmse, adversarial_ok = adversarial_check(cfg)

    # Reference's step-3 default estimator (MUSIC) regression guard, with
    # its throughput.
    cfg_music = dataclasses.replace(
        cfg, aoa=dataclasses.replace(cfg.aoa, method="music"))
    out_music = pipe.process_sequence_batched(batches1, key, cfg_music)
    force(out_music)
    _, t2m, _, t3m = time_pair(
        lambda: pipe.process_sequence_batched(batches2, key, cfg_music),
        lambda: pipe.process_sequence_batched(batches3, key, cfg_music))
    fps_music = (f3 - f2) / max(t3m - t2m, 1e-9)
    music_rmse = round(float(planar_pose_errors(
        np.asarray(out_music.pose), gt_np)["position_rmse"]), 3)
    music_ok = music_rmse <= 0.15

    rig_fps, rig_rmse, rig_ok = rig_check(cfg)
    sane = (bool(ok[1:].mean() > 0.9) and pos_err_bound_ok and pos_rmse_ok
            and adversarial_ok and music_ok and rig_ok)

    stage_us = stage_breakdown(cfg, batches1, key)

    baseline_fps = 1.0 / 3.7   # reference complete-analysis s/frame midpoint
    result = {
        "metric": "e2e_pipeline_frames_per_sec_1chip",
        "value": round(fps, 1),
        "unit": "frames/s",
        "vs_baseline": round(fps / baseline_fps, 1),
        "frames_delta": f3 - f2,
        "scan_driver_fps": round(fps_scan, 1),
        "dispatch_s_64f": round(t1, 4),
        "sane": sane,
        "final_pose_err_m": round(pose_err, 3),
        "pos_rmse_m": pos_rmse,
        "pos_err_bound_ok": pos_err_bound_ok,
        "pos_rmse_ok": pos_rmse_ok,
        "adversarial_rmse_m": adv_rmse,
        "adversarial_ok": adversarial_ok,
        "music_pos_rmse_m": music_rmse,
        "music_fps": round(fps_music, 1),
        "music_ok": music_ok,
        "chunked_driver_fps": round(fps_chunked, 1),
        "rig_fps_4sensor": rig_fps,
        "rig_pos_rmse_m": rig_rmse,
        "rig_ok": rig_ok,
        "stage_us_per_64f": stage_us,
        "device": device,
        "card": card,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
