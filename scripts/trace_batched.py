#!/usr/bin/env python3
"""Where the batched driver's device time goes, from a profiler trace.

At ``complete_analysis_config()`` over a ``--frames`` corridor:

1. the end-to-end ``process_sequence_batched`` step, warmed, timed with
   ``block_until_ready`` (median of ``--reps``);
2. the same work split into one jitted program per stage -- synthesis,
   power map, CFAR/top-K, signatures (the front-end chain), then AoA
   (MDL + angles + confidence) and phase B (smoothing, association,
   solve, pose) -- each timed the same way;
3. one ``jax.profiler`` trace holding one call of the end-to-end step and
   one of each stage program: device time per program (``hlo_module``)
   summed over the GPU's kernel events, and the end-to-end program's
   device busy / idle share over its own window;
4. per front-end stage, the least time the card could take -- the larger
   of its FLOPs over the f32 peak and its bytes over the HBM peak -- over
   the measured time, from three counts of FLOPs and bytes: ``padded``
   counts every scatterer slot (what the program computes), ``useful``
   only the valid scatterers (the work the scene asks for), both from
   shapes by :func:`stage_costs`; ``xla`` is the compiled program's own
   cost model (``cost_analysis``).  The synthesis contraction is linear
   in the slot count, so padded / useful is how much of it multiplies
   padding.

``--max-scatterers`` overrides the config's slot count (512, sized for
dense RadarScenes frames; the corridor has 96 points).  Refuses to run
without a GPU.  Writes JSON to ``--out``/stages.json and keeps the trace
under ``--out``.

Usage: python scripts/trace_batched.py --out DIR [--frames 2048]
       [--max-scatterers N]
"""

import argparse
import dataclasses
import glob
import json
import math
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import numpy as np

FRONT_END = ("stage_synth", "stage_power", "stage_detect",
             "stage_signatures")


def stage_costs(cfg, frames: int, scatterers: float) -> dict:
    """(FLOPs, bytes) the front-end stages need at least, from shapes, with
    ``scatterers`` per frame entering the synthesis contraction.

    A complex multiply-add is 8 real FLOPs and an N-point complex FFT
    5 N log2 N.  Bytes are the stage's unavoidable device-memory traffic:
    synthesis writes the complex64 ADC cube; the power map reads it and
    writes the f32 map; CFAR reads the map; signatures read the cube."""
    A, C, S = (cfg.radar.total_antennas, cfg.radar.num_chirps,
               cfg.radar.samples_per_chirp)
    Sc, K = scatterers, cfg.detection.max_detections
    cube, pmap = A * C * S * 8, S * C * 4
    per_frame = {
        "stage_synth": (8.0 * Sc * A * C * S, cube),
        "stage_power": (5.0 * A * C * S * math.log2(S)
                        + 5.0 * A * S * C * math.log2(C), cube + pmap),
        "stage_detect": (0.0, pmap),
        "stage_signatures": (8.0 * A * C * S * K + 8.0 * A * C * K, cube),
    }
    return {k: (f * frames, b * frames) for k, (f, b) in per_frame.items()}


def xla_costs(jitted, *args) -> tuple:
    """(FLOPs, bytes) of a jitted program from XLA's compiled cost model."""
    ca = jitted.lower(*args).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return float(ca.get("flops", 0.0)), float(ca.get("bytes accessed", 0.0))


def roofline_entry(flops, nbytes, measured_s, peaks) -> dict:
    t_c = flops / (peaks["f32_tflops"] * 1e12)
    t_m = nbytes / (peaks["hbm_gbps"] * 1e9)
    return {"gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            "bound": "f32 compute" if t_c >= t_m else "memory",
            "least_s": max(t_c, t_m),
            "share_of_roofline": max(t_c, t_m) / measured_s}


def timed(fn, reps):
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def device_events(trace_dir):
    """Kernel/memcpy events of the GPU planes: (module, start_ns, dur_ns,
    name), plus a few raw samples for reading by hand."""
    from jax.profiler import ProfileData

    files = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))
    if not files:
        raise RuntimeError(f"no trace written under {trace_dir}")
    events, samples = [], []
    for plane in ProfileData.from_file(files[-1]).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = {k: str(v) for k, v in ev.stats}
                module = stats.get("hlo_module", "?")
                events.append((module, ev.start_ns, ev.duration_ns, ev.name))
                if len(samples) < 12:
                    samples.append({"plane": plane.name, "line": line.name,
                                    "name": ev.name,
                                    "dur_ns": ev.duration_ns,
                                    "stats": stats})
    return events, samples, files[-1]


def busy_ns(intervals):
    total, end = 0.0, -math.inf
    for s, d in sorted(intervals):
        if s + d <= end:
            continue
        total += s + d - max(s, end)
        end = s + d
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--max-scatterers", type=int, default=None,
                    help="scatterer slots per frame (default: the config's)")
    ap.add_argument("--out", required=True,
                    help="directory for the trace and stages.json")
    args = ap.parse_args()

    from radar_slam_tpu.core.config import complete_analysis_config
    from radar_slam_tpu.io.synthetic import SceneConfig, constant_motion_scene
    from radar_slam_tpu.pipeline import frame as pipe
    from radar_slam_tpu.signal.detect import detect_peaks_from_power
    from radar_slam_tpu.signal.rds import detection_signatures, rds_power
    from radar_slam_tpu.signal.synth import synthesize_frame
    from radar_slam_tpu.utils.compile_cache import enable_compile_cache
    from radar_slam_tpu.utils.device import (card_name_and_power_limit,
                                             peak_rates, require_gpu)

    device = require_gpu()
    peaks = peak_rates(device["kind"])
    card = card_name_and_power_limit()
    enable_compile_cache()

    cfg = complete_analysis_config()
    if args.max_scatterers:
        cfg = dataclasses.replace(cfg, max_scatterers=args.max_scatterers)
    F = args.frames
    batches, _ = constant_motion_scene(
        7, num_frames=F, dt=cfg.frame_dt, v_body=(8.0, 0.5), yaw_rate=0.05,
        scene=SceneConfig(num_points=96, max_scatterers=cfg.max_scatterers))
    key = jax.random.key(0)
    keys = jax.random.split(key, F)
    r = cfg.radar

    def stage_synth(b, k):
        return jax.vmap(lambda sc, kk: synthesize_frame(
            sc, r, kk, fidelity=cfg.synth_fidelity))(b, k)

    def stage_power(cube):
        return rds_power(cube, r, window=cfg.window,
                         doppler_window=cfg.doppler_window)

    def stage_detect(p):
        return jax.vmap(lambda x: detect_peaks_from_power(
            x, r, cfg.detection))(p)

    def stage_signatures(cube, rb, db):
        return jax.vmap(lambda x, a, d: detection_signatures(
            x, a, d, r, window=cfg.window,
            doppler_window=cfg.doppler_window))(cube, rb, db)

    def stage_aoa(det, sigs):
        return jax.vmap(lambda d, s: pipe._aoa_features(d, s, cfg))(det, sigs)

    def stage_phase_b(feats):
        return pipe._sequence_from_features(feats, cfg, True)

    jits = {f.__name__: jax.jit(f) for f in (
        stage_synth, stage_power, stage_detect, stage_signatures, stage_aoa,
        stage_phase_b)}
    cube = jits["stage_synth"](batches, keys)
    p_lin = jits["stage_power"](cube)
    det = jits["stage_detect"](p_lin)
    sigs = jits["stage_signatures"](cube, det.range_bin, det.doppler_bin)
    feats = jits["stage_aoa"](det, sigs)
    calls = {
        "stage_synth": lambda: jits["stage_synth"](batches, keys),
        "stage_power": lambda: jits["stage_power"](cube),
        "stage_detect": lambda: jits["stage_detect"](p_lin),
        "stage_signatures": lambda: jits["stage_signatures"](
            cube, det.range_bin, det.doppler_bin),
        "stage_aoa": lambda: jits["stage_aoa"](det, sigs),
        "stage_phase_b": lambda: jits["stage_phase_b"](feats),
    }
    e2e = lambda: pipe.process_sequence_batched(batches, key, cfg)

    wall = {"e2e": timed(e2e, args.reps)}
    wall.update({k: timed(fn, args.reps) for k, fn in calls.items()})

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    with jax.profiler.trace(str(out_dir)):
        jax.block_until_ready(e2e())
        for fn in calls.values():
            jax.block_until_ready(fn())
    events, samples, trace_file = device_events(str(out_dir))

    per_module = defaultdict(float)
    spans = defaultdict(list)
    for module, start, dur, _ in events:
        per_module[module] += dur
        spans[module].append((start, dur))
    e2e_mod = next((m for m in per_module
                    if "process_sequence_batched" in m), None)
    e2e_busy = e2e_window = None
    if e2e_mod:
        iv = spans[e2e_mod]
        e2e_busy = busy_ns(iv)
        e2e_window = max(s + d for s, d in iv) - min(s for s, _ in iv)

    def module_ns(stage):
        return sum(v for m, v in per_module.items() if stage in m)

    stage_ns = {k: module_ns(k) for k in calls}
    staged_total = sum(stage_ns.values())
    front_ns = sum(stage_ns[k] for k in FRONT_END)
    valid_per_frame = float(np.asarray(batches.valid).sum()) / F
    counts = {"padded": stage_costs(cfg, F, cfg.max_scatterers),
              "useful": stage_costs(cfg, F, valid_per_frame)}
    stage_args = {"stage_synth": (batches, keys), "stage_power": (cube,),
                  "stage_detect": (p_lin,),
                  "stage_signatures": (cube, det.range_bin, det.doppler_bin)}
    counts["xla"] = {k: xla_costs(jits[k], *stage_args[k]) for k in FRONT_END}
    roofline = {}
    for k in FRONT_END:
        meas = stage_ns[k] * 1e-9 or wall[k]
        roofline[k] = {"measured_s": meas}
        roofline[k].update({name: roofline_entry(*c[k], meas, peaks)
                            for name, c in counts.items()})

    result = {
        "device": device, "card": card, "frames": F, "peaks": peaks,
        "max_scatterers": cfg.max_scatterers,
        "valid_scatterers_per_frame": valid_per_frame,
        "wall_s": wall,
        "e2e_frames_per_s": F / wall["e2e"],
        "device_ns_per_program": dict(per_module),
        "stage_device_ns": stage_ns,
        "front_end_share_of_staged_device_time": (
            front_ns / staged_total if staged_total else None),
        "e2e_device_busy_ns": e2e_busy, "e2e_window_ns": e2e_window,
        "e2e_idle_share": (1.0 - e2e_busy / e2e_window
                           if e2e_window else None),
        "roofline": roofline, "trace_file": trace_file,
        "event_samples": samples,
    }
    (out_dir / "stages.json").write_text(json.dumps(result, indent=2,
                                                    default=str))
    brief = {k: v for k, v in result.items() if k != "event_samples"}
    print(json.dumps(brief, indent=1, default=str))


if __name__ == "__main__":
    main()
