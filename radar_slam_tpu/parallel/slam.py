"""Trajectory refinement: odometry chain + loop closures -> pose-graph GN.

Composes the pieces into the SLAM back-end the reference never had:
per-frame velocity solves become odometry factors
(``posegraph.from_velocities``), radar scan matching adds loop-closure
factors (``loopclosure.find_loop_closures``), and the distributed
Gauss-Newton solver (``ba.gauss_newton_cg``; optionally over a device mesh)
produces the refined trajectory.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from radar_slam_tpu.parallel import ba, posegraph
from radar_slam_tpu.parallel.loopclosure import (LoopClosureConfig,
                                                 find_loop_closures)


def targets_to_points(range_m: np.ndarray, azimuth_rad: np.ndarray,
                      valid: np.ndarray):
    """Per-frame body-frame detection positions [F, K, 2] + mask."""
    x = np.asarray(range_m) * np.cos(np.asarray(azimuth_rad))
    y = np.asarray(range_m) * np.sin(np.asarray(azimuth_rad))
    return (jnp.asarray(np.stack([x, y], axis=-1), jnp.float32),
            jnp.asarray(np.asarray(valid)))


def refine_sequence_output(out, dt: float,
                           lc_cfg: LoopClosureConfig = LoopClosureConfig(),
                           mesh=None, solver: str = "cg",
                           proposer: str = "pose",
                           use_z: bool = False) -> Dict:
    """Refine a pipeline :class:`~radar_slam_tpu.pipeline.frame.FrameOutput`
    sequence (scan or batched driver) with loop-closure pose-graph GN;
    ``use_z`` feeds the solver's vertical rate into the z-aware graph."""

    vel = jax.device_get(out.motion.velocity)
    wz = jax.device_get(out.motion.angular_velocity)[:, 2]
    ok = jax.device_get(out.motion.success)
    return refine_trajectory(
        vel, wz, ok, dt,
        frame_points=out.target_xy, frame_valid=out.target_valid,
        lc_cfg=lc_cfg, mesh=mesh, solver=solver, proposer=proposer,
        use_z=use_z)


def propose_weighted_loops(frame_points, frame_valid, open_poses,
                           lc_cfg: LoopClosureConfig = LoopClosureConfig(),
                           proposer: str = "pose"):
    """Retrieve loop-closure candidates for ONE sequence and convert each
    into a weighted factor.

    Returns (raw candidate dicts, [(i, j, delta [3], info [3]), ...]).
    Shared by :func:`refine_trajectory` and the config-5 batch round trip
    (``multiseq.refine_sequences_mesh``)."""
    F = len(open_poses)
    if proposer == "scancontext":
        from radar_slam_tpu.parallel.scancontext import find_loop_closures_sc
        loops = find_loop_closures_sc(frame_points, frame_valid,
                                      open_poses[:F], lc_cfg)
    elif proposer == "pose":
        loops = find_loop_closures(frame_points, frame_valid,
                                   open_poses[:F], lc_cfg)
    else:
        raise ValueError(f"Unknown loop-closure proposer: {proposer}")
    # Lever arm for the angular information: a yaw error d_theta moves a
    # point at radius r by r*d_theta, so the registration's positional
    # variance maps to an angular variance of var / r_bar^2 (r_bar =
    # mean radius of the scene points actually matched).
    pv = np.asarray(frame_valid)
    pr = np.linalg.norm(np.asarray(frame_points), axis=-1)
    weighted = []
    for lc in loops:
        # Information from the ICP fit quality: var ~ rmse^2 / inliers
        # (standard error of the registration), capped at info_scale.
        # A tight revisit (rmse ~ mm) gets the full weight; a long-
        # baseline noisy match constrains the graph only as much as its
        # measurement supports instead of overruling good odometry.
        var = max(lc["rmse"] ** 2 / max(lc["inliers"], 1),
                  1.0 / lc_cfg.info_scale)
        vj = pv[lc["j"]]
        r_bar = float(pr[lc["j"]][vj].mean()) if vj.any() else 1.0
        var_theta = max(var / max(r_bar, 1.0) ** 2,
                        1.0 / lc_cfg.info_scale)
        info = jnp.array([1.0 / var, 1.0 / var, 1.0 / var_theta])
        weighted.append((lc["i"], lc["j"], np.asarray(lc["delta"]), info))
    return loops, weighted


def refine_trajectory(velocities: np.ndarray, yaw_rates: np.ndarray,
                      success: np.ndarray, dt: float,
                      frame_points: Optional[jax.Array] = None,
                      frame_valid: Optional[jax.Array] = None,
                      lc_cfg: LoopClosureConfig = LoopClosureConfig(),
                      mesh=None, gn_iters: int = 10, cg_iters: int = 60,
                      solver: str = "cg", proposer: str = "pose",
                      use_z: bool = False) -> Dict:
    """Build + solve the pose graph for one sequence.

    Args:
        velocities: [F, 3] per-frame body velocities (from the solver).
        yaw_rates: [F].
        success: [F] bool.
        frame_points / frame_valid: [F, K, 2] / [F, K] detection positions
            for loop-closure scan matching (None disables loop closures).
        solver: "cg" -- distributed GN with CG inner solves
            (``ba.gauss_newton_cg``); "schur" -- iterated keyframe-block
            Schur elimination with the Woodbury loop correction
            (``ba.schur_gn_step``; requires ``mesh``).  Keyframes are padded
            with weak zero-motion factors to a multiple of the mesh size.
        proposer: "pose" -- revisit candidates gated on the open-loop pose
            estimates (``loopclosure.find_loop_closures``); "scancontext"
            -- descriptor retrieval independent of odometric drift
            (``scancontext.find_loop_closures_sc``).
        use_z: optimize the z-aware (x, y, z, yaw) graph, consuming
            ``velocities[:, 2]`` (VERDICT r04 item 8).  Loop-closure
            proposals stay planar (xy scan matching); their z component
            enters as a zero-delta row at 1% of the xy information, i.e. a
            weak z-consistency hint rather than a measurement.

    Returns dict with open-loop poses [F+1, 3], refined poses [F+1, 3],
    accepted loop closures, and final graph cost.
    """
    F = len(velocities)
    velocities = np.asarray(velocities, np.float32)
    yaw_rates = np.asarray(yaw_rates, np.float32)
    success = np.asarray(success, bool)
    if solver == "schur":
        if mesh is None:
            raise ValueError("solver='schur' needs a device mesh")
        n_dev = mesh.devices.size
        n_poses = -(-(F + 1) // n_dev) * n_dev
        pad = n_poses - 1 - F
        if pad:
            velocities = np.concatenate(
                [velocities, np.zeros((pad, 3), np.float32)])
            yaw_rates = np.concatenate(
                [yaw_rates, np.zeros(pad, np.float32)])
            success = np.concatenate([success, np.zeros(pad, bool)])
    elif solver != "cg":
        raise ValueError(f"Unknown pose-graph solver: {solver}")

    cap = lc_cfg.max_candidates if frame_points is not None else 1
    graph = posegraph.from_velocities(
        jnp.asarray(velocities), jnp.asarray(yaw_rates),
        jnp.asarray(success), dt, loop_capacity=cap, use_z=use_z)
    open_poses = np.asarray(graph.poses)

    loops = []
    if frame_points is not None:
        lc_poses = (open_poses[:F][:, [0, 1, 3]] if use_z
                    else open_poses[:F])
        loops, weighted = propose_weighted_loops(
            frame_points, frame_valid, lc_poses, lc_cfg, proposer)
        for slot, (i, j, delta, info) in enumerate(weighted[:cap]):
            delta = np.asarray(delta, np.float32)
            info = np.asarray(info, np.float32)
            if use_z:
                delta = np.array([delta[0], delta[1], 0.0, delta[2]],
                                 np.float32)
                info = np.array([info[0], info[1], 0.01 * info[0],
                                 info[2]], np.float32)
            graph = posegraph.add_loop_closure(graph, slot, i, j,
                                               jnp.asarray(delta),
                                               jnp.asarray(info))

    if solver == "schur":
        poses = graph.poses
        for _ in range(gn_iters):
            poses = ba.schur_gn_step(graph._replace(poses=poses), mesh)
        cost = posegraph.total_cost(poses, graph)
    else:
        poses, cost = ba.gauss_newton_cg(graph, mesh=mesh,
                                         gn_iters=gn_iters,
                                         cg_iters=cg_iters)
    return {
        "open_loop_poses": open_poses[:F + 1],
        "poses": np.asarray(poses)[:F + 1],
        "loop_closures": loops,
        "cost": float(cost),
        "graph": graph._replace(poses=poses),
    }
