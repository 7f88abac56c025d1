"""Multi-sensor (mounted radar rig) pipeline.

The reference loops over RadarScenes' four mounted sensors per frame
(``radarscenes_complete_analysis.py:161-201``) but erases the mounting
geometry: scatterers are re-expressed about the vehicle origin and the
measured sensor-radial velocities are treated as vehicle-radial
(``src/datasets/radarscenes_loader.py:226-254`` keeps sensor-frame polar
coordinates and the per-frame loop never applies ``sensors.json`` mounts).
That approximation costs accuracy at short range and -- more fundamentally --
discards the only Doppler path to yaw rate: for a colocated sensor the
radial rate satisfies d.(w x r) = 0 identically, while a mounted sensor at s
sees -d.(v + w x p) with a nonzero lever arm s x d.

This module processes each sensor IN ITS OWN FRAME (synthesis, RDS,
detection, AoA, temporal smoothing all per sensor, batched with ``vmap``
over the sensor axis), then merges targets into the vehicle frame carrying
per-target sensor origins, so association and the 6-DoF solve see the exact
geometry.  With >= 2 sensors, yaw rate becomes observable from Doppler
alone (hard-asserted in ``tests/test_rig.py``).

Rig layout is static: sensor b owns target slots [b*K, (b+1)*K) of the
merged set, so cross-sensor temporal-phase associations are excluded by a
block-id mask, with no dynamic shapes anywhere.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from radar_slam_tpu.aoa import robust as aoa_robust
from radar_slam_tpu.aoa import smoothing
from radar_slam_tpu.core.config import PipelineConfig
from radar_slam_tpu.core.types import ScattererBatch, Targets
from radar_slam_tpu.motion.associate import associate_targets
from radar_slam_tpu.motion.pose import planar_pose_step
from radar_slam_tpu.motion.velocity import solve_velocity
from radar_slam_tpu.pipeline import frame as frame_mod
from radar_slam_tpu.pipeline.frame import (FrameOutput, FrameState,
                                           detect_frame)
from radar_slam_tpu.signal.synth import synthesize_frame

Rig = Tuple[Tuple[float, float, float], ...]  # ((x, y, yaw) per sensor)

COLOCATED: Rig = ((0.0, 0.0, 0.0),)


def rig_arrays(rig: Rig):
    """Static rig -> (mount_xy [B, 2], mount_yaw [B]) device constants."""
    m = jnp.asarray(rig, jnp.float32)
    return m[:, :2], m[:, 2]


@functools.partial(jax.jit, static_argnames=("cfg", "rig"))
def init_rig_state(cfg: PipelineConfig, rig: Rig,
                   initial_pose: Optional[jax.Array] = None) -> FrameState:
    """FrameState whose smoother + prev_targets carry a sensor axis /
    merged-K layout."""
    from radar_slam_tpu.pipeline.frame import _empty_targets

    B = len(rig)
    smoother = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape),
        smoothing.init_state(cfg.aoa))
    empty = _empty_targets(cfg)
    merged = jax.tree.map(
        lambda x: jnp.concatenate([x] * B, axis=0), empty)
    from radar_slam_tpu.pipeline.frame import _clutter_shape
    return FrameState(
        smoother=smoother,
        prev_targets=merged,
        prev_valid=jnp.array(False),
        prev_motion=jnp.zeros(6, jnp.float32),
        pose=(initial_pose if initial_pose is not None
              else jnp.zeros(3, jnp.float32)),
        clutter=(jnp.zeros((B,) + _clutter_shape(cfg), jnp.float32)
                 if cfg.detection.clutter_map_alpha > 0 else None),
    )


def _to_vehicle_frame(targets: Targets, mount_xy: jax.Array,
                      mount_yaw: jax.Array) -> Targets:
    """Re-express one sensor's targets in the vehicle frame.

    range_m / azimuth_rad become vehicle-origin polar (so
    ``Targets.position`` is the true vehicle-frame position); vr_mps stays
    sensor-radial -- the solver consumes it with the sensor LOS direction.
    With a URA the horizontal projection range*cos(el) is used; sensor
    mounts are planar (z = 0)."""
    ce = (jnp.cos(targets.elevation_rad)
          if targets.elevation_rad is not None else 1.0)
    az_v = targets.azimuth_rad + mount_yaw
    rh = targets.range_m * ce
    x = mount_xy[0] + rh * jnp.cos(az_v)
    y = mount_xy[1] + rh * jnp.sin(az_v)
    rh_v = jnp.hypot(x, y)
    if targets.elevation_rad is None:
        return targets._replace(range_m=rh_v, azimuth_rad=jnp.arctan2(y, x))
    z = targets.range_m * jnp.sin(targets.elevation_rad)
    return targets._replace(
        range_m=jnp.hypot(rh_v, z),
        azimuth_rad=jnp.arctan2(y, x),
        elevation_rad=jnp.arctan2(z, rh_v),
    )


@functools.partial(jax.jit, static_argnames=("cfg", "rig", "rotate_pose"))
def process_scatterers_rig(state: FrameState, scatterers: ScattererBatch,
                           key: jax.Array, cfg: PipelineConfig, rig: Rig,
                           rotate_pose: bool = True
                           ) -> Tuple[FrameState, FrameOutput]:
    """One frame step from per-sensor scatterer batches [B, S] (sensor frame).

    Per-sensor heavy stages are vmapped over the sensor axis; targets are
    merged into a [B*K] vehicle-frame set with per-target sensor origins for
    the association + velocity solve.
    """
    B = len(rig)
    K = cfg.detection.max_detections
    mount_xy, mount_yaw = rig_arrays(rig)
    keys = jax.random.split(key, B)

    def per_sensor(sc, k, sm, cl):
        sig = synthesize_frame(sc, cfg.radar, k, fidelity=cfg.synth_fidelity)
        det, sigs, cl, doppler_bins = detect_frame(sig, cfg, cl)
        targets, sm = aoa_robust.process_targets_robust(
            None, det, sm, cfg.radar, cfg.aoa, method=cfg.aoa.method,
            signatures=sigs, doppler_bins=doppler_bins)
        return targets, sm, cl

    targets_b, smoother, clutter = jax.vmap(per_sensor)(
        scatterers, keys, state.smoother, state.clutter)         # [B, K, ...]
    return _rig_tail(state, targets_b, smoother, clutter, cfg, rig,
                     mount_xy, mount_yaw, rotate_pose)


def _rig_tail(state, targets_b, smoother, clutter, cfg, rig, mount_xy,
              mount_yaw, rotate_pose):
    """Stateful tail of the rig step: vehicle-frame merge, association,
    6-DoF solve, pose, state update."""
    B = len(rig)
    K = cfg.detection.max_detections
    targets_b = jax.vmap(_to_vehicle_frame)(targets_b, mount_xy, mount_yaw)

    # Merge sensors: [B, K] -> [B*K]; static block layout.
    merged = jax.tree.map(
        lambda x: x.reshape((B * K,) + x.shape[2:]), targets_b)
    group = jnp.repeat(jnp.arange(B, dtype=jnp.int32), K)
    sensor_pos = jnp.repeat(
        jnp.concatenate([mount_xy, jnp.zeros((B, 1))], axis=-1), K, axis=0)

    assoc = associate_targets(merged, state.prev_targets, cfg.frame_dt,
                              cfg.velocity, sensor_pos=sensor_pos,
                              group=group)
    assoc = assoc._replace(valid=assoc.valid & state.prev_valid)

    motion = solve_velocity(assoc, jnp.float32(cfg.frame_dt),
                            cfg.radar.lambda_c, cfg.velocity,
                            prev_motion=state.prev_motion,
                            v_unambiguous=cfg.radar.max_unambiguous_velocity)

    # Failed solves return the previous motion, so stepping unconditionally
    # dead-reckons through gaps (PoseConfig.coast_on_failure; see frame.py).
    stepped = planar_pose_step(state.pose, motion.velocity,
                               motion.angular_velocity[2],
                               jnp.float32(cfg.frame_dt), rotate_pose)
    if cfg.pose.coast_on_failure:
        pose = stepped
    else:
        pose = jnp.where(motion.success, stepped, state.pose)

    new_state = FrameState(
        smoother=smoother,
        prev_targets=merged,
        prev_valid=merged.num_valid > 0,
        prev_motion=jnp.where(motion.success, motion.params,
                              state.prev_motion),
        pose=pose,
        clutter=clutter,
    )
    out = FrameOutput(
        motion=motion,
        pose=pose,
        num_detections=jnp.sum(targets_b.valid).astype(jnp.int32),
        num_reliable=jnp.sum(merged.is_reliable).astype(jnp.int32),
        num_associations=assoc.num_valid.astype(jnp.int32),
        target_xy=merged.position[:, :2],
        target_valid=merged.valid & merged.is_reliable,
    )
    return new_state, out


def sequence_features_rig(scatterers: ScattererBatch, key: jax.Array,
                          cfg: PipelineConfig, rig: Rig):
    """Phase A of the batched rig driver: per-(frame, sensor) heavy stages
    over the FLATTENED [F*B] frame axis (``frame.scatterer_features``, the
    phase A of every scatterer driver), amortizing every dispatch over the
    whole sequence.

    Noise realizations match :func:`process_sequence_rig` bit-for-bit: the
    per-(f, b) key is split(split(key, F)[f], B)[b], the same derivation
    the sequential driver performs frame by frame.

    Returns the ``frame_features`` tuple with leading axes [F, B, ...].
    """
    return _features_from_frame_keys(scatterers,
                                     jax.random.split(
                                         key, scatterers.range_m.shape[0]),
                                     cfg, rig)


@functools.partial(jax.jit, static_argnames=("cfg", "rig"))
def _features_from_frame_keys(scatterers: ScattererBatch, keys_f: jax.Array,
                              cfg: PipelineConfig, rig: Rig):
    """Phase A from PRE-SPLIT per-frame keys [F] (the prefetch driver
    feeds chunks of the same global key sequence, so chunked phase A is
    exactly the one-shot phase A restricted to those frames)."""
    F, B = scatterers.range_m.shape[:2]
    keys_fb = jax.vmap(lambda k: jax.random.split(k, B))(keys_f)  # [F, B]
    flat = jax.tree.map(
        lambda x: x.reshape((F * B,) + x.shape[2:]), scatterers)

    features = jax.vmap(
        lambda sc, k: frame_mod.scatterer_features(sc, k, cfg))(
            flat, keys_fb.reshape(F * B))
    return jax.tree.map(
        lambda x: x.reshape((F, B) + x.shape[1:]), features)


@functools.partial(jax.jit, static_argnames=("cfg", "rig", "rotate_pose"))
def process_sequence_rig_batched(scatterers: ScattererBatch, key: jax.Array,
                                 cfg: PipelineConfig, rig: Rig,
                                 rotate_pose: bool = True) -> FrameOutput:
    """Throughput-oriented rig driver: the two-phase split of
    ``frame.process_sequence_batched`` applied to the mounted-sensor path
    (VERDICT r04 item 1 -- the rig path is what real RadarScenes data runs,
    and through r04 it only had the sequential scan driver).

    Phase A batches the per-(frame, sensor) heavy stages over [F*B] at
    once (:func:`sequence_features_rig`); phase B runs per-sensor windowed
    temporal smoothing (scan-free), the vehicle-frame merge with exact
    mounting geometry, shift-association restricted to same-sensor blocks,
    the batched 6-DoF solve with per-target sensor origins, and the
    prefix-sum pose.  Matches :func:`process_sequence_rig` up to the same
    documented deltas as the merged batched driver: the temporal motion
    prior is dropped (1e-3x weight; set ``temporal_weight=0`` for algebraic
    equality) and the clutter map EMA -- strictly sequential through
    detection -- is ignored (``clutter_map_alpha`` defaults 0).
    """
    features = sequence_features_rig(scatterers, key, cfg, rig)  # [F, B, ..]
    return _rig_sequence_from_features(features, cfg, rig, rotate_pose)


@functools.partial(jax.jit, static_argnames=("cfg", "rig", "rotate_pose"))
def _rig_sequence_from_features(features, cfg: PipelineConfig, rig: Rig,
                                rotate_pose: bool = True) -> FrameOutput:
    """Phase B of the batched rig driver (smoothing -> merge -> solve ->
    pose) from phase-A features [F, B, ...]; shared with the prefetch
    driver, which accumulates features chunk by chunk."""
    from radar_slam_tpu.pipeline.frame import (_batched_assoc_solve,
                                               _pose_prefix)

    (det, sigs, keep, num_sources, is_multi, angles_deg, el_deg,
     conf) = features
    F, B = det.range_bin.shape[:2]
    K = cfg.detection.max_detections
    mount_xy, mount_yaw = rig_arrays(rig)

    # Phase B1: temporal smoothing per sensor (each sensor owns its own
    # track table in the sequential driver; vmap over the sensor axis).
    D = cfg.radar.num_chirps if cfg.chirp_subset is None else (
        cfg.chirp_subset[1] - cfg.chirp_subset[0])
    det_keys = det.range_bin * D + det.doppler_bin              # [F, B, K]
    angles_s, conf_s = jax.vmap(
        lambda dk, an, cf, kp: smoothing.smooth_windowed(dk, an, cf, kp,
                                                         cfg.aoa),
        in_axes=1, out_axes=1)(det_keys, angles_deg, conf, keep)

    reliable = keep & (conf_s >= cfg.aoa.confidence_threshold) & ~is_multi
    targets_fb = Targets(
        range_bin=det.range_bin, doppler_bin=det.doppler_bin,
        range_m=det.range_m, doppler_hz=det.doppler_hz,
        vr_mps=det.vr_mps, power_db=det.power_db,
        azimuth_rad=jnp.deg2rad(angles_s), confidence=conf_s,
        num_sources=num_sources, is_multipath=is_multi,
        is_reliable=reliable, spatial_signature=sigs, valid=keep,
        elevation_rad=jnp.deg2rad(el_deg))                      # [F, B, K]

    # Vehicle-frame merge with exact mounting geometry (same as _rig_tail).
    targets_fb = jax.vmap(jax.vmap(_to_vehicle_frame, in_axes=(0, 0, 0)),
                          in_axes=(0, None, None))(
        targets_fb, mount_xy, mount_yaw)
    merged = jax.tree.map(
        lambda x: x.reshape((F, B * K) + x.shape[3:]), targets_fb)
    group = jnp.repeat(jnp.arange(B, dtype=jnp.int32), K)
    sensor_pos = jnp.repeat(
        jnp.concatenate([mount_xy, jnp.zeros((B, 1))], axis=-1), K, axis=0)

    # Phase B2 + B3 shared with the merged batched driver.
    n_assoc, motion = _batched_assoc_solve(merged, cfg,
                                           sensor_pos=sensor_pos,
                                           group=group)
    pose = _pose_prefix(motion, cfg, rotate_pose)

    return FrameOutput(
        motion=motion, pose=pose,
        num_detections=jnp.sum(keep, axis=(1, 2)).astype(jnp.int32),
        num_reliable=jnp.sum(merged.is_reliable, axis=-1).astype(jnp.int32),
        num_associations=n_assoc.astype(jnp.int32),
        target_xy=merged.position[..., :2],
        target_valid=merged.valid & merged.is_reliable)


@functools.partial(jax.jit, static_argnames=("cfg", "rig", "rotate_pose"))
def process_sequence_rig(scatterers: ScattererBatch, key: jax.Array,
                         cfg: PipelineConfig, rig: Rig,
                         rotate_pose: bool = True,
                         initial_pose: Optional[jax.Array] = None
                         ) -> FrameOutput:
    """Whole-sequence multi-sensor pipeline as one ``lax.scan``.

    Args:
        scatterers: stacked per-sensor batches [F, B, S] (sensor frame).
    """
    F = scatterers.range_m.shape[0]
    keys = jax.random.split(key, F)
    state = init_rig_state(cfg, rig, initial_pose)

    def step(st, inp):
        sc, k = inp
        return process_scatterers_rig(st, sc, k, cfg, rig, rotate_pose)

    _, outputs = jax.lax.scan(step, state, (scatterers, keys))
    return outputs
