"""Loop-closure SLAM tests: SE(2) ICP, revisit detection, drift correction."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radar_slam_tpu.io.synthetic import circle_scene
from radar_slam_tpu.parallel import slam
from radar_slam_tpu.parallel.loopclosure import (LoopClosureConfig,
                                                 find_loop_closures, icp_se2)


def random_cloud(rng, n=40, spread=25.0):
    return rng.uniform(-spread, spread, (n, 2)).astype(np.float32)


def test_icp_recovers_known_transform():
    rng = np.random.default_rng(0)
    dst = random_cloud(rng)
    true = np.array([1.2, -0.8, 0.15], np.float32)
    # src = points expressed in a frame offset by `true` from dst's frame.
    c, s = np.cos(true[2]), np.sin(true[2])
    R = np.array([[c, -s], [s, c]])
    src = ((dst - true[:2]) @ R).astype(np.float32)  # inverse transform
    src_noisy = src + rng.normal(0, 0.03, src.shape).astype(np.float32)
    valid = jnp.ones(len(src), bool)
    pose, rmse, n = icp_se2(jnp.asarray(src_noisy), valid,
                            jnp.asarray(dst), valid,
                            jnp.zeros(3), iters=10, gate=3.0)
    np.testing.assert_allclose(np.asarray(pose), true, atol=0.05)
    assert float(rmse) < 0.1 and int(n) == len(src)


def test_icp_partial_overlap_and_masks():
    rng = np.random.default_rng(1)
    dst = random_cloud(rng, n=50)
    src = dst.copy()
    src[:20] = rng.uniform(-60, 60, (20, 2))      # 40% outlier points
    sv = jnp.ones(50, bool)
    dv = jnp.ones(50, bool).at[45:].set(False)    # some dst points invalid
    pose, rmse, n = icp_se2(jnp.asarray(src), sv, jnp.asarray(dst), dv,
                            jnp.zeros(3), iters=8, gate=1.5)
    assert int(n) >= 25                            # inliers found
    np.testing.assert_allclose(np.asarray(pose), 0.0, atol=0.2)


def test_loop_closure_detection_on_circle():
    poses, pts, msk = circle_scene()
    loops = find_loop_closures(pts, msk, poses,
                               LoopClosureConfig(revisit_radius=4.0,
                                                 min_separation=40))
    assert loops, "revisit at the end of the circle should be detected"
    lc = loops[0]
    assert lc["j"] - lc["i"] > 40
    # True relative pose between the matched keyframes:
    pi, pj = poses[lc["i"]], poses[lc["j"]]
    c, s = np.cos(pi[2]), np.sin(pi[2])
    d = pj[:2] - pi[:2]
    true_delta = np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                           pj[2] - pi[2]])
    got = lc["delta"].copy()
    got[2] = np.arctan2(np.sin(got[2] - true_delta[2]), np.cos(got[2] - true_delta[2])) + true_delta[2]
    np.testing.assert_allclose(got[:2], true_delta[:2], atol=0.3)


def test_refinement_corrects_drift():
    poses, pts, msk = circle_scene()
    n = len(poses)
    dt = 0.1
    rng = np.random.default_rng(5)
    # Odometry = true body velocity + bias + noise -> drifting open loop.
    vel = np.tile([6.0, 0.0, 0.0], (n, 1)) + rng.normal(0, 0.15, (n, 3))
    vel[:, 0] += 0.25                       # forward bias
    vel[:, 2] = 0.0
    wz = np.full(n, 0.7) + rng.normal(0, 0.01, n)
    res = slam.refine_trajectory(
        vel, wz, np.ones(n, bool), dt, frame_points=pts, frame_valid=msk,
        lc_cfg=LoopClosureConfig(revisit_radius=6.0, min_separation=40,
                                 max_rmse=1.0))
    assert res["loop_closures"], "needs at least one accepted loop"
    open_err = np.linalg.norm(res["open_loop_poses"][:n, :2] - poses[:, :2],
                              axis=1)
    ref_err = np.linalg.norm(res["poses"][:n, :2] - poses[:, :2], axis=1)
    # Loop closure should cut the endpoint drift substantially.
    assert ref_err[-1] < 0.6 * open_err[-1], (open_err[-1], ref_err[-1])
    assert ref_err.max() <= open_err.max() + 1e-6


@pytest.mark.slow
def test_refinement_schur_solver_on_mesh(eight_devices):
    """The --slam path through the distributed Schur solver (VERDICT round-1
    item 6 done criterion): same drift correction as the CG solver on the
    8-device mesh, including keyframe padding to the mesh size."""
    from radar_slam_tpu.parallel.mesh import make_mesh

    poses, pts, msk = circle_scene()
    n = len(poses)
    rng = np.random.default_rng(5)
    vel = np.tile([6.0, 0.0, 0.0], (n, 1)) + rng.normal(0, 0.15, (n, 3))
    vel[:, 0] += 0.25
    vel[:, 2] = 0.0
    wz = np.full(n, 0.7) + rng.normal(0, 0.01, n)
    lc = LoopClosureConfig(revisit_radius=6.0, min_separation=40,
                           max_rmse=1.0)
    res_cg = slam.refine_trajectory(vel, wz, np.ones(n, bool), 0.1,
                                    frame_points=pts, frame_valid=msk,
                                    lc_cfg=lc)
    res_sc = slam.refine_trajectory(vel, wz, np.ones(n, bool), 0.1,
                                    frame_points=pts, frame_valid=msk,
                                    lc_cfg=lc, mesh=make_mesh(8),
                                    solver="schur", gn_iters=12)
    assert res_sc["loop_closures"], "needs at least one accepted loop"
    assert res_sc["poses"].shape == res_cg["poses"].shape == (n + 1, 3)
    err_cg = np.linalg.norm(res_cg["poses"][:n, :2] - poses[:, :2], axis=1)
    err_sc = np.linalg.norm(res_sc["poses"][:n, :2] - poses[:, :2], axis=1)
    open_err = np.linalg.norm(res_sc["open_loop_poses"][:n, :2]
                              - poses[:, :2], axis=1)
    assert err_sc[-1] < 0.6 * open_err[-1], (open_err[-1], err_sc[-1])
    # Both solvers land on comparable refined trajectories.
    assert abs(err_sc.max() - err_cg.max()) < 0.3, (err_sc.max(),
                                                    err_cg.max())


def test_optimize_trajectory_z_aware():
    """use_z=True (refine_trajectory): a trajectory with a vertical rate is recovered in z
    while xy/yaw match the planar result (VERDICT r04 item 8)."""
    rng = np.random.default_rng(3)
    F = 24
    v = np.tile(np.array([5.0, 0.0, 0.25], np.float32), (F, 1))
    v += rng.normal(0, 0.02, v.shape).astype(np.float32)
    wz = np.full(F, 0.05, np.float32)
    ok = np.ones(F, bool)
    out = slam.refine_trajectory(v, wz, ok, dt=0.1, use_z=True)
    poses = np.asarray(out["poses"])
    assert poses.shape == (F + 1, 4)
    # z integrates ~0.025 m/frame
    np.testing.assert_allclose(poses[-1, 2], 0.025 * F, atol=0.05)
    out_planar = slam.refine_trajectory(v, wz, ok, dt=0.1)
    np.testing.assert_allclose(poses[:, :2],
                               np.asarray(out_planar["poses"])[:, :2],
                               atol=1e-3)
