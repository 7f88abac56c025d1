"""Cross-frame target association (static-shape masked greedy NN).

Re-design of ``ImprovedVelocitySolver.associate_targets_across_frames``
(``src/algorithms/velocity_solver_improved.py:74-129``): greedy
nearest-neighbour on Cartesian target positions with a distance gate
(5 m default; the reference docstring claims Hungarian but the code is
greedy, ``:100``).  Current targets claim previous targets in power order
(the detection sets arrive sorted by descending power, matching the
reference's ``filtered_peaks.sort`` order), each taking the nearest unused
previous target inside the gate -- implemented as a ``lax.scan`` over the
[K, K] distance matrix with a usage mask, no dynamic shapes.

Also computes, per association, everything the velocity solver needs
(temporal phase difference on the reference antenna,
``velocity_solver_improved.py:131-152`` / ``radarscenes_complete_analysis.py:
293-303``; apparent velocity for the smart initial guess, ``:268-323``).
"""

from __future__ import annotations

import functools


import jax
import jax.numpy as jnp

from radar_slam_tpu.core.config import VelocityConfig
from radar_slam_tpu.core.geometry import direction_vector
from radar_slam_tpu.core.types import Associations, Targets


@functools.partial(jax.jit, static_argnames=("cfg", "metric"))
def associate_targets(current: Targets, previous: Targets, dt: float | jax.Array,
                      cfg: VelocityConfig, metric: str = "cartesian",
                      sensor_pos: jax.Array | None = None,
                      group: jax.Array | None = None) -> Associations:
    """Greedy gated NN association between consecutive frames.

    Args:
        metric: "cartesian" -- Euclidean distance between (x, y) positions
            (velocity_solver_improved.py:92-98);  "polar" -- the
            complete-analysis variant sqrt(d_range^2 + d_azimuth^2) mixing
            metres and radians (radarscenes_complete_analysis.py:285-287).
        sensor_pos: optional [K, 3] vehicle-frame origin of the sensor that
            observed each *current* target.  When given, solver line-of-sight
            directions are (position - sensor_pos) normalized instead of the
            vehicle-origin LOS -- required for mounted (non-colocated) radars,
            where the lever arm s x d makes yaw rate observable from Doppler
            alone (the reference ignores mounting; SURVEY/ROADMAP item 2).
        group: optional [K] int32 sensor/block id shared by both frames'
            target layouts; matches are restricted to equal ids (temporal
            phase differences are only meaningful within one physical sensor).
    """
    K = current.range_m.shape[0]

    cur_ok = current.valid & current.is_reliable
    prev_ok = previous.valid & previous.is_reliable

    if metric == "cartesian":
        cp = current.position[:, :2]
        pp = previous.position[:, :2]
        diff = cp[:, None, :] - pp[None, :, :]
        dist = jnp.sqrt(jnp.sum(diff * diff, axis=-1) + 1e-12)
    elif metric == "polar":
        dr = current.range_m[:, None] - previous.range_m[None, :]
        da = current.azimuth_rad[:, None] - previous.azimuth_rad[None, :]
        dist = jnp.sqrt(dr * dr + da * da)
    else:
        raise ValueError(f"Unknown association metric: {metric}")

    BIG = jnp.float32(1e9)
    ok = cur_ok[:, None] & prev_ok[None, :]
    if group is not None:
        ok = ok & (group[:, None] == group[None, :])
    dist = jnp.where(ok, dist, BIG)

    if cfg.association_method == "greedy":
        # Reference-faithful: current targets claim in power order, each
        # taking the nearest unused previous target (sequential scan).
        def step(used, row):
            d, ok = row
            d = jnp.where(used, BIG, d)
            j = jnp.argmin(d)
            best = d[j]
            hit = ok & (best < cfg.association_gate)
            used = used | (jnp.arange(K) == j) & hit
            return used, (j.astype(jnp.int32), best, hit)

        _, (prev_idx, best_dist, hit) = jax.lax.scan(
            step, jnp.zeros(K, bool), (dist, cur_ok))
    elif cfg.association_method == "mutual":
        # Mutual nearest neighbours: i <-> j match iff each is the other's
        # argmin.  One shot, fully parallel (the sequential greedy scan costs
        # K tiny serialized device steps per frame); at most as many matches
        # as greedy but never a crossed pair.
        j_of_i = jnp.argmin(dist, axis=1)                       # [K]
        i_of_j = jnp.argmin(dist, axis=0)                       # [K]
        best_dist = jnp.min(dist, axis=1)
        mutual = i_of_j[j_of_i] == jnp.arange(K)
        hit = cur_ok & mutual & (best_dist < cfg.association_gate)
        prev_idx = j_of_i.astype(jnp.int32)
    else:
        raise ValueError(
            f"Unknown association method: {cfg.association_method}")

    # Temporal phase diff on reference antenna 0:
    # angle(s_t[0] * conj(s_{t-1}[0]))  (velocity_solver_improved.py:150).
    # Every previous-frame lookup (signature, position, confidence) rides
    # ONE stacked gather at prev_idx instead of one gather op each.
    prev_sig0 = previous.spatial_signature[:, 0]
    prev_stack = jnp.concatenate(
        [jnp.real(prev_sig0)[:, None], jnp.imag(prev_sig0)[:, None],
         previous.position, previous.confidence[:, None]], axis=-1)  # [K, 6]
    g = prev_stack[prev_idx]
    s_cur = current.spatial_signature[:, 0]
    s_prev = (g[:, 0] + 1j * g[:, 1]).astype(jnp.complex64)
    phase = jnp.angle(s_cur * jnp.conj(s_prev))

    dt = jnp.maximum(jnp.float32(dt), 1e-6)
    apparent_v = (current.position - g[:, 2:5]) / dt

    el = (current.elevation_rad if current.elevation_rad is not None
          else jnp.zeros_like(current.azimuth_rad))
    if sensor_pos is None:
        direction = direction_vector(current.azimuth_rad, el)
    else:
        rel = current.position - sensor_pos
        direction = rel / jnp.maximum(
            jnp.linalg.norm(rel, axis=-1, keepdims=True), 1e-6)
    return Associations(
        prev_index=prev_idx,
        distance=jnp.where(hit, best_dist, 0.0),
        temporal_phase_diff=jnp.where(hit, phase, 0.0),
        position=current.position,
        direction=direction,
        vr_mps=current.vr_mps,
        apparent_velocity=jnp.where(hit[:, None], apparent_v, 0.0),
        weight=jnp.where(hit, current.confidence * g[:, 5], 0.0),
        valid=hit,
    )
