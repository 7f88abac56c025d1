"""Pose-graph construction (keyframes + odometry + loop factors).

New design -- the reference integrates velocities open-loop
(``pose_integration.py``) and has no pose-graph / bundle-adjustment layer at
all (SURVEY.md section 5, "long-context" row).  Here a trajectory becomes a
factor graph over keyframe poses, in either of two parameterizations
(selected by the trailing dimension of ``poses``; yaw is always LAST):

- planar SE(2): p_i = (x, y, yaw);
- z-aware (VERDICT r04 item 8 -- the solver estimates full 6-DoF motion
  and the reference integrates 3-D positions,
  ``pose_integration.py:169-220``): p_i = (x, y, z, yaw), with the yaw
  rotation acting on (x, y) and z a pure translation (radar yaw is the
  only Doppler-observable rotation; roll/pitch stay external priors).

- odometry factors from the per-frame velocity solves:
  r_i = [R(yaw_i)^T (t_{i+1} - t_i) - dt_i ; (dz_i - dz_meas) ;
         wrap(yaw_{i+1} - yaw_i - dyaw_i)]
- an anchor prior on p_0;
- optional loop-closure factors of the same form between arbitrary (i, j).

All factor arrays are static-shape with validity masks so the graph jits and
shards (factors partition across devices in ``parallel.ba``, which is
dimension-generic over the trailing axis).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from radar_slam_tpu.core.geometry import wrap_angle


class PoseGraph(NamedTuple):
    poses: jax.Array        # [N, D] estimates; D=3 (x,y,yaw) or 4 (x,y,z,yaw)
    fi: jax.Array           # [M] int32 factor endpoint i
    fj: jax.Array           # [M] int32 factor endpoint j
    delta: jax.Array        # [M, D] measured body-frame motion i -> j
    info: jax.Array         # [M, D] diagonal information (weights)
    factor_valid: jax.Array  # [M] bool
    anchor: jax.Array       # [D] prior pose for p_0
    anchor_info: jax.Array  # [D] prior information


def from_velocities(velocities: jax.Array, yaw_rates: jax.Array,
                    success: jax.Array, dt: float,
                    odo_info: Tuple[float, ...] = (100.0, 100.0, 400.0),
                    loop_capacity: int = 0,
                    initial_poses: Optional[jax.Array] = None,
                    use_z: bool = False) -> PoseGraph:
    """Build a chain graph from per-frame velocity estimates.

    Args:
        velocities: [F, 3] body velocities (frame f covers [t_f, t_{f+1})).
        yaw_rates: [F].
        success: [F] bool; failed frames get zero-motion factors with weak
            information (the masked equivalent of the reference's
            keep-previous-pose fallback).
        use_z: build the z-aware (x, y, z, yaw) graph, consuming
            ``velocities[:, 2]`` as the vertical rate (the solver's full
            6-DoF output; the reference integrates 3-D positions,
            pose_integration.py:169-220).  ``odo_info`` may then have 4
            entries (x, y, z, yaw); a 3-entry tuple reuses the x weight
            for z.
    Returns a graph with N = F + 1 poses.
    """
    F = velocities.shape[0]
    n_t = 3 if use_z else 2
    d_t = jnp.where(success[:, None], velocities[:, :n_t], 0.0) * dt
    d_yaw = jnp.where(success, yaw_rates, 0.0) * dt
    delta = jnp.concatenate([d_t, d_yaw[:, None]], axis=-1)   # [F, D]

    oi = tuple(odo_info)
    if use_z and len(oi) == 3:
        oi = (oi[0], oi[1], oi[0], oi[2])
    info = jnp.where(success[:, None], jnp.array(oi)[None, :],
                     jnp.array(oi)[None, :] * 1e-2)

    # Initial poses: open-loop integration of the deltas (yaw rotates the
    # xy plane only; z accumulates directly).
    if initial_poses is None:
        yaw = jnp.concatenate([jnp.zeros(1), jnp.cumsum(d_yaw)])
        c, s = jnp.cos(yaw[:-1]), jnp.sin(yaw[:-1])
        step = jnp.stack([c * delta[:, 0] - s * delta[:, 1],
                          s * delta[:, 0] + c * delta[:, 1]], axis=-1)
        if use_z:
            step = jnp.concatenate([step, delta[:, 2:3]], axis=-1)
        t = jnp.concatenate([jnp.zeros((1, n_t)), jnp.cumsum(step, axis=0)])
        initial_poses = jnp.concatenate([t, yaw[:, None]], axis=-1)

    fi = jnp.arange(F, dtype=jnp.int32)
    fj = fi + 1
    valid = jnp.ones(F, bool)
    if loop_capacity:
        pad = lambda x, fill: jnp.concatenate(
            [x, jnp.full((loop_capacity,) + x.shape[1:], fill, x.dtype)])
        fi, fj = pad(fi, 0), pad(fj, 0)
        delta = pad(delta, 0.0)
        info = pad(info, 0.0)
        valid = jnp.concatenate([valid, jnp.zeros(loop_capacity, bool)])

    return PoseGraph(
        poses=initial_poses, fi=fi, fj=fj, delta=delta, info=info,
        factor_valid=valid,
        anchor=initial_poses[0],
        anchor_info=jnp.full((n_t + 1,), 1e6),
    )


def add_loop_closure(graph: PoseGraph, slot: int, i: int, j: int,
                     delta: jax.Array, info: jax.Array) -> PoseGraph:
    """Fill one pre-allocated loop-closure slot (after the chain factors)."""
    F = graph.poses.shape[0] - 1
    k = F + slot
    return graph._replace(
        fi=graph.fi.at[k].set(i), fj=graph.fj.at[k].set(j),
        delta=graph.delta.at[k].set(delta),
        info=graph.info.at[k].set(info),
        factor_valid=graph.factor_valid.at[k].set(True))


def factor_residuals(poses: jax.Array, graph: PoseGraph) -> jax.Array:
    """Residuals [M, D] of all factors at the given pose estimates.

    Yaw (last component) rotates the xy plane; with D=4 the z component is
    a pure translation residual."""
    D = poses.shape[-1]
    pi = poses[graph.fi]
    pj = poses[graph.fj]
    c, s = jnp.cos(pi[:, -1]), jnp.sin(pi[:, -1])
    dx = pj[:, 0] - pi[:, 0]
    dy = pj[:, 1] - pi[:, 1]
    r_x = c * dx + s * dy - graph.delta[:, 0]
    r_y = -s * dx + c * dy - graph.delta[:, 1]
    r_t = wrap_angle(pj[:, -1] - pi[:, -1] - graph.delta[:, -1])
    if D == 4:
        r_z = pj[:, 2] - pi[:, 2] - graph.delta[:, 2]
        return jnp.stack([r_x, r_y, r_z, r_t], axis=-1)
    return jnp.stack([r_x, r_y, r_t], axis=-1)


def factor_jacobians(poses: jax.Array, graph: PoseGraph):
    """Jacobian blocks (Ji [M, D, D], Jj [M, D, D]) of the residuals."""
    D = poses.shape[-1]
    pi = poses[graph.fi]
    pj = poses[graph.fj]
    c, s = jnp.cos(pi[:, -1]), jnp.sin(pi[:, -1])
    dx = pj[:, 0] - pi[:, 0]
    dy = pj[:, 1] - pi[:, 1]
    zeros = jnp.zeros_like(c)
    ones = jnp.ones_like(c)
    # d r_xy / d theta_i = d(R^T)/dtheta @ (tj - ti)
    drx_dth = -s * dx + c * dy
    dry_dth = -c * dx - s * dy
    if D == 4:
        Ji = jnp.stack([
            jnp.stack([-c, -s, zeros, drx_dth], axis=-1),
            jnp.stack([s, -c, zeros, dry_dth], axis=-1),
            jnp.stack([zeros, zeros, -ones, zeros], axis=-1),
            jnp.stack([zeros, zeros, zeros, -ones], axis=-1)], axis=-2)
        Jj = jnp.stack([
            jnp.stack([c, s, zeros, zeros], axis=-1),
            jnp.stack([-s, c, zeros, zeros], axis=-1),
            jnp.stack([zeros, zeros, ones, zeros], axis=-1),
            jnp.stack([zeros, zeros, zeros, ones], axis=-1)], axis=-2)
        return Ji, Jj
    Ji = jnp.stack([
        jnp.stack([-c, -s, drx_dth], axis=-1),
        jnp.stack([s, -c, dry_dth], axis=-1),
        jnp.stack([zeros, zeros, -ones], axis=-1)], axis=-2)
    Jj = jnp.stack([
        jnp.stack([c, s, zeros], axis=-1),
        jnp.stack([-s, c, zeros], axis=-1),
        jnp.stack([zeros, zeros, ones], axis=-1)], axis=-2)
    return Ji, Jj


def total_cost(poses: jax.Array, graph: PoseGraph) -> jax.Array:
    r = factor_residuals(poses, graph)
    w = graph.factor_valid[:, None] * graph.info
    cost = jnp.sum(w * r * r)
    ra = poses[0] - graph.anchor
    ra = ra.at[-1].set(wrap_angle(ra[-1]))
    return cost + jnp.sum(graph.anchor_info * ra * ra)
