"""Scan-context false-positive characterization (VERDICT round-2 item 4).

A wrong accepted loop is the most damaging failure a SLAM back-end can
have.  The worst case for descriptor retrieval is perceptual aliasing —
``io/synthetic.py:periodic_corridor_scene`` repeats the same wall geometry
every ``period`` metres, so non-revisit frames one period apart score
0.87-0.95 similarity (well above the 0.55 acceptance threshold) and, for
moderate repeat jitter, even ALIGN under ICP (rmse ~0.59 < the 0.7 gate).
Geometry alone cannot reject these; the odometry-consistency gate
(``LoopClosureConfig.odo_gate_frac``) can and must: an aliased "revisit"
disagrees with the integrated odometry by a full pattern period (~100 % of
the path), genuine loop-closing drift only by the accumulated error
(~13 % in the calibration scene).  Distribution data:
``scripts/characterize_scancontext.py`` / ``docs/LOOPCLOSURE.md``.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from radar_slam_tpu.io.synthetic import (augment_clutter_movers,
                                         circle_scene,
                                         periodic_corridor_scene)
from radar_slam_tpu.parallel import scancontext, slam
from radar_slam_tpu.parallel.loopclosure import LoopClosureConfig
from radar_slam_tpu.parallel.scancontext import (ScanContextConfig,
                                                 build_descriptors,
                                                 find_loop_closures_sc,
                                                 propose_candidates)

N_FRAMES = 80
V, DT = 6.0, 0.1
LC = LoopClosureConfig(min_separation=20)


def corridor_velocities(rng):
    """Near-perfect straight-line odometry for the corridor scenes."""
    vel = np.tile([V, 0.0, 0.0], (N_FRAMES, 1)) \
        + rng.normal(0, 0.02, (N_FRAMES, 3))
    vel[:, 2] = 0.0
    wz = rng.normal(0, 0.002, N_FRAMES)
    return vel, wz


@pytest.mark.parametrize("jitter", [0.0, 0.35, 0.6])
@pytest.mark.slow
def test_aliased_corridor_no_corrupting_loop(jitter):
    """Across seeds, clutter, and movers: no accepted loop may pull the
    trajectory away from odometry (there are NO true revisits here).

    jitter=0 is the degenerate limit (repeats are bitwise-identical, so the
    clouds genuinely align; an accepted factor can only ever agree with
    odometry and is harmless); 0.35 is the dangerous regime where ICP
    passes but the claim is wrong; 0.6 is rejected by ICP alone."""
    for seed in range(4):
        poses, pts, msk = periodic_corridor_scene(
            seed, n_frames=N_FRAMES, v=V, dt=DT, jitter=jitter)
        pts, msk = augment_clutter_movers(poses, pts, msk, seed + 100,
                                          clutter_per_frame=12, n_movers=3,
                                          dt=DT)
        rng = np.random.default_rng(seed + 50)
        vel, wz = corridor_velocities(rng)
        res = slam.refine_trajectory(vel, wz, np.ones(N_FRAMES, bool), DT,
                                     frame_points=pts, frame_valid=msk,
                                     lc_cfg=LC, proposer="scancontext")
        for lc in res["loop_closures"]:
            # An accepted loop must agree with odometry (harmless); the
            # aliased identity-claiming kind must have been gated out.
            rel = res["open_loop_poses"][lc["j"], :2] \
                - res["open_loop_poses"][lc["i"], :2]
            claimed = np.asarray(lc["delta"][:2])
            assert np.linalg.norm(claimed - rel) < 3.0, \
                (seed, jitter, lc["i"], lc["j"], claimed, rel)
        # And the refined trajectory must not have been dragged off the
        # (near-perfect) odometry.
        err = np.linalg.norm(res["poses"][:N_FRAMES, :2] - poses[:, :2],
                             axis=1)
        assert err.max() < 1.0, (seed, jitter, err.max())


def test_true_loop_survives_odometry_gate():
    """The drift scene that motivates loop closure (yaw-rate bias, ~7 m
    endpoint error over a 53 m path) must STILL close with the consistency
    gate active — the gate separates ~13 % genuine-drift disagreement from
    ~100 % aliased disagreement."""
    poses, pts, msk = circle_scene()
    n = len(poses)
    rng = np.random.default_rng(7)
    vel = np.tile([6.0, 0.0, 0.0], (n, 1)) + rng.normal(0, 0.1, (n, 3))
    vel[:, 2] = 0.0
    wz = np.full(n, 0.6) + rng.normal(0, 0.01, n)
    lc = LoopClosureConfig(revisit_radius=5.0, min_separation=40,
                           max_rmse=0.5)
    res = slam.refine_trajectory(vel, wz, np.ones(n, bool), 0.1,
                                 frame_points=pts, frame_valid=msk,
                                 lc_cfg=lc, proposer="scancontext")
    assert res["loop_closures"]
    open_err = np.linalg.norm(res["open_loop_poses"][:n, :2] - poses[:, :2],
                              axis=1)
    ref_err = np.linalg.norm(res["poses"][:n, :2] - poses[:, :2], axis=1)
    assert ref_err[-1] < 0.6 * open_err[-1]


def test_injected_wrong_candidate_rejected(monkeypatch):
    """A deliberately-injected wrong retrieval (two genuinely different
    frames of the circle scene, with a fabricated high similarity) must not
    survive verification into the accepted list."""
    poses, pts, msk = circle_scene()
    n = len(poses)
    # Frames a quarter-circle apart: different geometry, different pose.
    fake = [{"i": 10, "j": 55, "sim": 0.99, "yaw": 0.3}]
    monkeypatch.setattr(scancontext, "propose_candidates",
                        lambda desc, cfg: fake)
    loops = find_loop_closures_sc(pts, msk, poses,
                                  cfg=LoopClosureConfig(min_separation=20))
    assert loops == [], loops


@pytest.mark.slow
def test_retrieval_precision_recall_documented():
    """Post-verification precision must be 1.0 (zero false accepts) over
    the corridor suite, and recall >= 3/4 over drifted circle scenes.

    Raw stage-2 retrieval precision under aliasing is ~0 BY DESIGN (the
    descriptor cannot distinguish a repeated corridor); the verification
    tier is what carries it to 1.0 — this test pins that division of
    labour quantitatively."""
    false_proposed = false_accepted = 0
    for seed in range(4):
        gt_poses, pts, msk = periodic_corridor_scene(
            seed, n_frames=N_FRAMES, v=V, dt=DT, jitter=0.35)
        desc = build_descriptors(pts, msk, ScanContextConfig())
        false_proposed += len(propose_candidates(desc, ScanContextConfig()))
        rng = np.random.default_rng(seed)
        vel, wz = corridor_velocities(rng)
        res = slam.refine_trajectory(vel, wz, np.ones(N_FRAMES, bool), DT,
                                     frame_points=pts, frame_valid=msk,
                                     lc_cfg=LC, proposer="scancontext")
        for lc in res["loop_closures"]:
            # On this scene every possible loop is false unless it merely
            # restates odometry.
            rel = res["open_loop_poses"][lc["j"], :2] \
                - res["open_loop_poses"][lc["i"], :2]
            if np.linalg.norm(np.asarray(lc["delta"][:2]) - rel) >= 3.0:
                false_accepted += 1
    assert false_proposed > 0      # aliasing really does defeat retrieval
    assert false_accepted == 0

    recalled = 0
    for seed in range(4):
        poses, pts, msk = circle_scene(seed=seed + 1)
        n = len(poses)
        rng = np.random.default_rng(seed)
        vel = np.tile([6.0, 0.0, 0.0], (n, 1)) + rng.normal(0, 0.1, (n, 3))
        vel[:, 2] = 0.0
        wz = np.full(n, 0.62) + rng.normal(0, 0.01, n)
        lc = LoopClosureConfig(revisit_radius=5.0, min_separation=40,
                               max_rmse=0.5)
        res = slam.refine_trajectory(vel, wz, np.ones(n, bool), 0.1,
                                     frame_points=pts, frame_valid=msk,
                                     lc_cfg=lc, proposer="scancontext")
        recalled += bool(res["loop_closures"])
    assert recalled >= 3, recalled
