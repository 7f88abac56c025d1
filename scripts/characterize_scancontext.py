#!/usr/bin/env python3
"""Scan-context score distributions + precision/recall characterization
(VERDICT round-2 item 4: calibrate ``sim_threshold`` from measured
distributions instead of one circle scene; document the histograms).

Populations measured over many seeds:

- **true revisits**: circle scenes, pairs whose GT poses are within 4 m and
  >= 40 frames apart (detection noise via independent per-frame clutter).
- **aliased non-revisits**: periodic corridors (jitter 0.35 m), pairs one
  pattern period apart -- the perceptual-aliasing worst case.
- **random non-revisits**: corridor pairs at non-period offsets.
- Clutter + mover variants of all three.

Emits JSON percentiles, an ASCII histogram, the implied operating points,
and end-to-end precision/recall through the full verification tier (ICP +
odometry-consistency gate).  Results are summarized in
``docs/LOOPCLOSURE.md``.

Usage: python scripts/characterize_scancontext.py [--seeds 8] [--json out]
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import numpy as np

# Host-side analysis; run on CPU regardless of the session platform.
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402


def pair_sims(desc, pairs):
    from radar_slam_tpu.parallel.scancontext import sc_correlate
    if not pairs:
        return np.array([])
    ii = np.array([p[0] for p in pairs])
    jj = np.array([p[1] for p in pairs])
    sim, _ = sc_correlate(desc[ii], desc[jj])
    return np.asarray(sim)


def hist_ascii(x, lo=0.0, hi=1.0, bins=20, width=40):
    h, edges = np.histogram(x, bins=bins, range=(lo, hi))
    out = []
    for c, e0, e1 in zip(h, edges[:-1], edges[1:]):
        bar = "#" * int(round(width * c / max(h.max(), 1)))
        out.append(f"  {e0:4.2f}-{e1:4.2f} |{bar} {c}")
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    from radar_slam_tpu.io.synthetic import (augment_clutter_movers,
                                             circle_scene,
                                             periodic_corridor_scene)
    from radar_slam_tpu.parallel import slam
    from radar_slam_tpu.parallel.loopclosure import LoopClosureConfig
    from radar_slam_tpu.parallel.scancontext import (ScanContextConfig,
                                                     build_descriptors)

    sc = ScanContextConfig()
    pops = {"true_revisit": [], "true_revisit_clutter": [],
            "aliased_period": [], "aliased_period_clutter": [],
            "random_pair": []}

    period_frames = int(round(18.0 / (6.0 * 0.1)))     # 30

    for seed in range(args.seeds):
        # Circle scenes: true revisits.
        gt, pts, msk = circle_scene(seed=seed)
        n = len(gt)
        d2 = np.linalg.norm(gt[:, None, :2] - gt[None, :, :2], axis=-1)
        pairs = [(i, j) for j in range(n) for i in range(0, j - 40)
                 if d2[i, j] < 4.0]
        desc = build_descriptors(pts, msk, sc)
        pops["true_revisit"].extend(pair_sims(desc, pairs))
        pts_c, msk_c = augment_clutter_movers(gt, pts, msk, seed + 300,
                                              clutter_per_frame=12,
                                              n_movers=3)
        desc_c = build_descriptors(pts_c, msk_c, sc)
        pops["true_revisit_clutter"].extend(pair_sims(desc_c, pairs))

        # Corridors: aliased + random pairs.
        poses, cpts, cmsk = periodic_corridor_scene(seed, n_frames=80,
                                                    jitter=0.35)
        cdesc = build_descriptors(cpts, cmsk, sc)
        al = [(j - period_frames, j) for j in range(period_frames, 80)]
        rd = [(j - 23, j) for j in range(23, 80)]      # off-period offset
        pops["aliased_period"].extend(pair_sims(cdesc, al))
        pops["random_pair"].extend(pair_sims(cdesc, rd))
        cpts2, cmsk2 = augment_clutter_movers(poses, cpts, cmsk, seed + 600,
                                              clutter_per_frame=12,
                                              n_movers=3)
        cdesc2 = build_descriptors(cpts2, cmsk2, sc)
        pops["aliased_period_clutter"].extend(pair_sims(cdesc2, al))

    summary = {}
    for k, v in pops.items():
        v = np.asarray(v)
        summary[k] = {
            "n": int(v.size),
            "p5": round(float(np.percentile(v, 5)), 3),
            "p50": round(float(np.percentile(v, 50)), 3),
            "p95": round(float(np.percentile(v, 95)), 3),
        }
        print(f"\n{k} (n={v.size}, p5/p50/p95 = "
              f"{summary[k]['p5']}/{summary[k]['p50']}/{summary[k]['p95']})")
        print(hist_ascii(v))

    # End-to-end precision/recall through verification (ICP + odo gate).
    fp = tp = fn = proposed_fp = 0
    for seed in range(args.seeds):
        poses, pts, msk = periodic_corridor_scene(seed, n_frames=80,
                                                  jitter=0.35)
        pts, msk = augment_clutter_movers(poses, pts, msk, seed + 900,
                                          clutter_per_frame=12, n_movers=3)
        rng = np.random.default_rng(seed)
        vel = np.tile([6.0, 0.0, 0.0], (80, 1)) + rng.normal(0, 0.02, (80, 3))
        vel[:, 2] = 0.0
        wz = rng.normal(0, 0.002, 80)
        res = slam.refine_trajectory(
            vel, wz, np.ones(80, bool), 0.1, frame_points=pts,
            frame_valid=msk, lc_cfg=LoopClosureConfig(min_separation=20),
            proposer="scancontext")
        from radar_slam_tpu.parallel.scancontext import propose_candidates
        proposed_fp += len(propose_candidates(
            build_descriptors(pts, msk, sc), sc))
        for lc in res["loop_closures"]:
            rel = res["open_loop_poses"][lc["j"], :2] \
                - res["open_loop_poses"][lc["i"], :2]
            if np.linalg.norm(np.asarray(lc["delta"][:2]) - rel) >= 3.0:
                fp += 1

        gt, cpts, cmsk = circle_scene(seed=seed + 1)
        n = len(gt)
        vel = np.tile([6.0, 0.0, 0.0], (n, 1)) + rng.normal(0, 0.1, (n, 3))
        vel[:, 2] = 0.0
        wz = np.full(n, 0.62) + rng.normal(0, 0.01, n)
        res = slam.refine_trajectory(
            vel, wz, np.ones(n, bool), 0.1, frame_points=cpts,
            frame_valid=cmsk,
            lc_cfg=LoopClosureConfig(revisit_radius=5.0, min_separation=40,
                                     max_rmse=0.5),
            proposer="scancontext")
        good = [lc for lc in res["loop_closures"]
                if np.linalg.norm(gt[lc["j"], :2] - gt[lc["i"], :2]) < 6.0]
        tp += len(good)
        fn += res["loop_closures"] == []

    out = {"populations": summary,
           "e2e": {"aliased_proposed_fp": proposed_fp,
                   "aliased_accepted_fp": fp,
                   "drift_scene_tp": tp,
                   "drift_scenes_missed": fn,
                   "seeds": args.seeds}}
    print("\n" + json.dumps(out["e2e"], indent=2))
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
