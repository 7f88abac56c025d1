"""Temporal angle smoothing as a functional, static-shape track table.

Re-design of ``RobustAngleEstimator.apply_temporal_smoothing``
(``src/algorithms/robust_angle_estimation.py:274-330``): the reference keys
per-target Python deques by the string id ``f"target_{r_bin}_{d_bin}"``
(``:380``); here the state is a fixed-capacity slot table (a pytree usable
inside ``jit`` / ``lax.scan``):

- integer track keys  key = range_bin * n_doppler + doppler_bin;
- per-slot ring buffers of the last W (angle, confidence) measurements;
- slot allocation by eviction priority (free first, then oldest) computed
  with one ``top_k`` -- no data-dependent control flow.

The smoothing math matches the reference: confidence-weighted circular mean
over the window (``:299-316``), blended with the previous raw angle by the
smoothing factor (``:318-322``), confidence smoothed by the window mean
(``:325``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from radar_slam_tpu.core.config import AoAConfig


class SmootherState(NamedTuple):
    keys: jax.Array     # [C] int32, -1 = free slot
    angles: jax.Array   # [C, W] float32 ring buffer [deg]
    confs: jax.Array    # [C, W] float32 ring buffer
    count: jax.Array    # [C] int32 measurements ever written to the slot
    age: jax.Array      # [C] int32 frames since last update


def init_state(aoa: AoAConfig) -> SmootherState:
    C, W = aoa.track_capacity, aoa.temporal_window
    return SmootherState(
        keys=jnp.full((C,), -1, jnp.int32),
        angles=jnp.zeros((C, W), jnp.float32),
        confs=jnp.zeros((C, W), jnp.float32),
        count=jnp.zeros((C,), jnp.int32),
        age=jnp.zeros((C,), jnp.int32),
    )


def _window_smooth(angles: jax.Array, confs: jax.Array, count: jax.Array,
                   write_pos: jax.Array, smoothing_factor: float
                   ) -> Tuple[jax.Array, jax.Array]:
    """Smoothed (angle_deg, conf) per slot row from its ring buffer.

    ``write_pos`` is the ring index of the newest entry."""
    W = angles.shape[-1]
    idx = jnp.arange(W)[None, :]
    valid = idx < count[:, None]                          # [K, W]
    weights = jnp.where(valid, confs, 0.0)
    wsum = jnp.sum(weights, axis=-1, keepdims=True)
    n_valid = jnp.maximum(jnp.sum(valid, axis=-1, keepdims=True), 1)
    weights = jnp.where(wsum > 0, weights / jnp.maximum(wsum, 1e-30),
                        valid / n_valid)

    ang_rad = jnp.deg2rad(angles)
    mean_cos = jnp.sum(weights * jnp.cos(ang_rad), axis=-1)
    mean_sin = jnp.sum(weights * jnp.sin(ang_rad), axis=-1)
    circ_deg = jnp.rad2deg(jnp.arctan2(mean_sin, mean_cos))

    # Previous raw angle = entry at write_pos - 1 (robust_angle_estimation.py:320).
    prev_pos = jnp.mod(write_pos - 1, W)
    prev = jnp.take_along_axis(angles, prev_pos[:, None], axis=-1)[:, 0]
    blended = smoothing_factor * circ_deg + (1.0 - smoothing_factor) * prev

    conf = jnp.sum(jnp.where(valid, confs, 0.0), axis=-1) / n_valid[:, 0]

    newest = jnp.take_along_axis(angles, write_pos[:, None], axis=-1)[:, 0]
    newest_conf = jnp.take_along_axis(confs, write_pos[:, None], axis=-1)[:, 0]
    single = count <= 1
    return (jnp.where(single, newest, blended),
            jnp.where(single, newest_conf, conf))


def update(state: SmootherState, det_keys: jax.Array, angles_deg: jax.Array,
           confidences: jax.Array, valid: jax.Array, aoa: AoAConfig
           ) -> Tuple[SmootherState, jax.Array, jax.Array]:
    """Ingest one frame's detections; return smoothed angles/confidences.

    Args:
        det_keys: [K] int32 track keys (r_bin * n_doppler + d_bin).
        angles_deg, confidences, valid: [K] per-detection measurements.

    Returns:
        (new_state, smoothed_angles_deg [K], smoothed_confs [K]).
    """
    C = state.keys.shape[0]
    W = state.angles.shape[1]
    K = det_keys.shape[0]

    # --- match detections to existing tracks -------------------------------
    # Stale tracks (not updated within track_max_age frames) are unmatchable:
    # their bin may now hold a different physical target.
    fresh = state.age <= aoa.track_max_age
    key_eq = ((state.keys[None, :] == det_keys[:, None])
              & (state.keys[None, :] >= 0) & fresh[None, :])
    matched = jnp.any(key_eq, axis=1) & valid                       # [K]
    match_slot = jnp.argmax(key_eq, axis=1)                         # [K]

    # --- allocate slots for new tracks -------------------------------------
    # Eviction priority: free slots first, then stalest; slots matched this
    # frame are protected.
    slot_matched = jnp.any(key_eq & valid[:, None], axis=0)         # [C]
    priority = jnp.where(state.keys < 0, jnp.int32(1 << 30), state.age)
    priority = jnp.where(slot_matched, jnp.int32(-1), priority)
    _, evict_order = jax.lax.top_k(priority, min(K, C))             # [K]

    need_alloc = valid & ~matched
    alloc_rank = jnp.cumsum(need_alloc.astype(jnp.int32)) - 1       # [K]
    alloc_slot = evict_order[jnp.clip(alloc_rank, 0, evict_order.shape[0] - 1)]

    slot = jnp.where(matched, match_slot, alloc_slot)               # [K]
    write = valid
    slot_w = jnp.where(write, slot, C)  # C = out-of-bounds -> dropped scatter

    # --- write measurements into ring buffers ------------------------------
    new_count_val = jnp.where(matched, state.count[slot] + 1, 1)
    pos = jnp.mod(new_count_val - 1, W)

    keys = state.keys.at[slot_w].set(det_keys, mode="drop")
    count = state.count.at[slot_w].set(
        jnp.minimum(new_count_val, jnp.int32(2 ** 30)), mode="drop")
    angles = state.angles.at[slot_w, pos].set(angles_deg, mode="drop")
    confs = state.confs.at[slot_w, pos].set(confidences, mode="drop")
    age = (state.age + 1).at[slot_w].set(0, mode="drop")

    # Reset ring history for freshly allocated slots beyond position 0 is
    # unnecessary: count==1 masks stale entries in _window_smooth.

    # --- compute smoothed outputs for this frame's detections --------------
    sm_angle, sm_conf = _window_smooth(
        angles[jnp.clip(slot, 0, C - 1)], confs[jnp.clip(slot, 0, C - 1)],
        jnp.minimum(count[jnp.clip(slot, 0, C - 1)], W), pos,
        aoa.smoothing_factor)
    sm_angle = jnp.where(valid, sm_angle, angles_deg)
    sm_conf = jnp.where(valid, sm_conf, confidences)

    return (SmootherState(keys=keys, angles=angles, confs=confs,
                          count=count, age=age),
            sm_angle, sm_conf)


def smooth_windowed(det_keys: jax.Array, angles_deg: jax.Array,
                    confidences: jax.Array, valid: jax.Array,
                    aoa: AoAConfig) -> Tuple[jax.Array, jax.Array]:
    """Scan-free temporal smoothing over a whole sequence at once.

    Equivalent to scanning :func:`update` over frames, re-derived as a
    parallel windowed gather: the slot table only ever feeds the smoother the
    last W RAW measurements of each track, and a track is a backward chain of
    same-key detections with consecutive frame gaps <= track_max_age + 1.
    So for every detection we (a) find its predecessor (same key, nearest
    frame within the gap bound) with one batched comparison per lag, then
    (b) follow that pointer W-1 times -- all embarrassingly parallel over
    [F, K], no sequential state.

    Exactness caveat: assumes the slot table never evicts a *fresh* track
    (capacity pressure), which holds whenever track_capacity >= the number
    of tracks updated within the last track_max_age frames (default 256 slots
    vs <= 50 reliable targets/frame x 3 frames).

    Args:
        det_keys: [F, K] int32 track keys (r_bin * n_doppler + d_bin).
        angles_deg, confidences: [F, K] raw per-detection measurements.
        valid: [F, K] detections that participate (matches the ``valid``
            argument of :func:`update`).

    Returns:
        (smoothed_angles_deg [F, K], smoothed_confs [F, K]).
    """
    F, K = det_keys.shape
    L = aoa.track_max_age + 1            # max frame gap within a track
    W = aoa.temporal_window

    key_v = jnp.where(valid, det_keys, jnp.int32(-1))

    # --- predecessor pointers: nearest same-key detection within L frames --
    pred_f = jnp.zeros((F, K), jnp.int32)
    pred_j = jnp.zeros((F, K), jnp.int32)
    found = jnp.zeros((F, K), bool)
    frame_idx = jnp.arange(F, dtype=jnp.int32)[:, None]
    for g in range(1, L + 1):
        prev_keys = jnp.concatenate(
            [jnp.full((min(g, F), K), -2, jnp.int32), key_v[:-g]], axis=0)[:F]
        eq = (key_v[:, :, None] == prev_keys[:, None, :]) & (key_v >= 0)[:, :, None]
        m = jnp.any(eq, axis=-1)
        j = jnp.argmax(eq, axis=-1).astype(jnp.int32)
        new = m & ~found
        pred_f = jnp.where(new, frame_idx - g, pred_f)
        pred_j = jnp.where(new, j, pred_j)
        found |= new

    # --- follow the chain W-1 hops, gathering raw (angle, conf) entries ----
    # All per-hop lookups (angle, confidence, predecessor pointers, found
    # flag) ride ONE stacked gather instead of one gather op each, and the
    # scalar channels round-trip f32 exactly (values < 2^24).
    src = jnp.stack([angles_deg, confidences,
                     pred_f.astype(jnp.float32),
                     pred_j.astype(jnp.float32),
                     found.astype(jnp.float32)], axis=-1)    # [F, K, 5]
    entries_ang = [angles_deg]           # newest first
    entries_conf = [confidences]
    entries_ok = [jnp.ones((F, K), bool)]
    cur_f, cur_j, cur_ok = pred_f, pred_j, found
    for w in range(1, W):
        cf = jnp.clip(cur_f, 0, F - 1)
        g = src[cf, cur_j]                                   # one gather
        entries_ang.append(g[..., 0])
        entries_conf.append(g[..., 1])
        entries_ok.append(cur_ok)
        if w < W - 1:
            cur_ok = cur_ok & (g[..., 4] > 0)
            cur_f = g[..., 2].astype(jnp.int32)
            cur_j = g[..., 3].astype(jnp.int32)

    ang = jnp.stack(entries_ang, axis=-1)        # [F, K, W] newest first
    cnf = jnp.stack(entries_conf, axis=-1)
    ok = jnp.stack(entries_ok, axis=-1)

    # --- same math as _window_smooth ---------------------------------------
    weights = jnp.where(ok, cnf, 0.0)
    wsum = jnp.sum(weights, axis=-1, keepdims=True)
    n_ok = jnp.maximum(jnp.sum(ok, axis=-1, keepdims=True), 1)
    weights = jnp.where(wsum > 0, weights / jnp.maximum(wsum, 1e-30),
                        ok / n_ok)
    ang_rad = jnp.deg2rad(ang)
    circ_deg = jnp.rad2deg(jnp.arctan2(
        jnp.sum(weights * jnp.sin(ang_rad), axis=-1),
        jnp.sum(weights * jnp.cos(ang_rad), axis=-1)))
    prev = ang[..., 1]                           # previous raw measurement
    blended = (aoa.smoothing_factor * circ_deg
               + (1.0 - aoa.smoothing_factor) * prev)
    conf = jnp.sum(jnp.where(ok, cnf, 0.0), axis=-1) / n_ok[..., 0]

    single = ~found                              # count <= 1
    sm_angle = jnp.where(single, angles_deg, blended)
    sm_conf = jnp.where(single, confidences, conf)
    sm_angle = jnp.where(valid, sm_angle, angles_deg)
    sm_conf = jnp.where(valid, sm_conf, confidences)
    return sm_angle, sm_conf
