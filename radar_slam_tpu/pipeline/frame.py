"""The per-frame pipeline step and whole-sequence scan driver.

This is the equivalent of the reference's per-frame hot loop
(``results/ground_truth_comparison/radarscenes_complete_analysis.py:144-213``:
synthesize -> RDS -> peaks -> robust angles -> associate -> optimize ->
integrate).  The entire chain is ONE traced XLA program per frame, and
:func:`process_sequence` runs a full sequence as a single ``lax.scan`` --
no host round-trips between stages (the reference's stages exchange
``.npy`` files on disk, SURVEY.md section 1).

State carried across frames (all static-shape pytrees):
- the AoA temporal-smoother track table,
- the previous frame's targets (for association),
- the previous motion estimate (temporal prior),
- the integrated planar pose.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from radar_slam_tpu.aoa import robust as aoa_robust
from radar_slam_tpu.aoa import smoothing
from radar_slam_tpu.core.config import PipelineConfig
from radar_slam_tpu.core.types import (Associations, Detections,
                                       MotionEstimate, ScattererBatch, Targets)
from radar_slam_tpu.motion.associate import associate_targets
from radar_slam_tpu.motion.pose import planar_pose_step
from radar_slam_tpu.motion.velocity import solve_velocity
from radar_slam_tpu.signal import detect as detect_mod
from radar_slam_tpu.signal.detect import detect_peaks, detect_peaks_from_power
from radar_slam_tpu.signal.rds import (detection_signatures,
                                       range_doppler_spectrum, rds_power)
from radar_slam_tpu.signal.synth import synthesize_frame


class FrameState(NamedTuple):
    smoother: smoothing.SmootherState
    prev_targets: Targets
    prev_valid: jax.Array        # scalar bool
    prev_motion: jax.Array       # [6]
    pose: jax.Array              # [3] planar (x, y, yaw)
    # EMA background power map [R, D] (rig: [B, R, D]); present only when
    # cfg.detection.clutter_map_alpha > 0 (cfg is static, so the pytree
    # structure is consistent within any trace).
    clutter: Optional[jax.Array] = None


class FrameOutput(NamedTuple):
    motion: MotionEstimate
    pose: jax.Array              # [3] pose AFTER this frame's update
    num_detections: jax.Array
    num_reliable: jax.Array
    num_associations: jax.Array
    target_xy: jax.Array         # [K, 2] reliable-target positions (body)
    target_valid: jax.Array      # [K] bool (valid & reliable)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _empty_targets(cfg: PipelineConfig) -> Targets:
    # Jitted so that every field is its own buffer: the streaming drivers
    # donate the state, and one buffer cannot be donated twice.
    K = cfg.detection.max_detections
    A = cfg.radar.total_antennas
    zf = jnp.zeros(K, jnp.float32)
    zi = jnp.zeros(K, jnp.int32)
    zb = jnp.zeros(K, bool)
    return Targets(range_bin=zi, doppler_bin=zi, range_m=zf, doppler_hz=zf,
                   vr_mps=zf, power_db=zf, azimuth_rad=zf, confidence=zf,
                   num_sources=zi, is_multipath=zb, is_reliable=zb,
                   spatial_signature=jnp.zeros((K, A), jnp.complex64),
                   valid=zb, elevation_rad=zf)


def _clutter_shape(cfg: PipelineConfig):
    R = cfg.radar.samples_per_chirp
    D = (cfg.radar.num_chirps if cfg.chirp_subset is None
         else cfg.chirp_subset[1] - cfg.chirp_subset[0])
    return (R, D)


def init_state(cfg: PipelineConfig,
               initial_pose: Optional[jax.Array] = None) -> FrameState:
    return FrameState(
        smoother=smoothing.init_state(cfg.aoa),
        prev_targets=_empty_targets(cfg),
        prev_valid=jnp.array(False),
        prev_motion=jnp.zeros(6, jnp.float32),
        pose=(initial_pose if initial_pose is not None
              else jnp.zeros(3, jnp.float32)),
        clutter=(jnp.zeros(_clutter_shape(cfg), jnp.float32)
                 if cfg.detection.clutter_map_alpha > 0 else None),
    )


@functools.partial(jax.jit, static_argnames=("cfg", "rotate_pose"),
                   donate_argnames=("state",))
def process_signals(state: FrameState, signals: jax.Array, cfg: PipelineConfig,
                    rotate_pose: bool = True
                    ) -> Tuple[FrameState, FrameOutput]:
    """One frame step from an ADC cube [A, C, S] (baseband domain).

    ``state`` is DONATED: the streaming drivers replace it every step, so
    XLA reuses its buffers in place (smoother table, prev targets) instead
    of allocating per frame -- callers must not read a state object after
    passing it in."""
    det, sigs, clutter, doppler_bins = detect_frame(signals, cfg,
                                                    state.clutter)
    targets, smoother = aoa_robust.process_targets_robust(
        None, det, state.smoother, cfg.radar, cfg.aoa,
        method=cfg.aoa.method, signatures=sigs, doppler_bins=doppler_bins)

    return _step_from_targets(state, det, targets, smoother, clutter, cfg,
                              rotate_pose)


def _step_from_targets(state: FrameState, det, targets, smoother, clutter,
                       cfg: PipelineConfig, rotate_pose: bool
                       ) -> Tuple[FrameState, FrameOutput]:
    """The stateful tail of one frame step (association -> 6-DoF solve ->
    pose -> state update)."""
    assoc = associate_targets(targets, state.prev_targets,
                              cfg.frame_dt, cfg.velocity)
    assoc = assoc._replace(valid=assoc.valid & state.prev_valid)

    motion = solve_velocity(assoc, jnp.float32(cfg.frame_dt),
                            cfg.radar.lambda_c, cfg.velocity,
                            prev_motion=state.prev_motion,
                            v_unambiguous=cfg.radar.max_unambiguous_velocity)

    # On solve failure the returned motion already falls back to the
    # previous estimate (solve_velocity), so stepping with it dead-reckons
    # through gaps (coast_on_failure; frame 0's prev motion is zero, so it
    # stays put either way).  The reference freezes instead.
    stepped = planar_pose_step(state.pose, motion.velocity,
                               motion.angular_velocity[2],
                               jnp.float32(cfg.frame_dt), rotate_pose)
    if cfg.pose.coast_on_failure:
        pose = stepped
    else:
        pose = jnp.where(motion.success, stepped, state.pose)

    new_state = FrameState(
        smoother=smoother,
        prev_targets=targets,
        prev_valid=targets.num_valid > 0,
        prev_motion=jnp.where(motion.success, motion.params,
                              state.prev_motion),
        pose=pose,
        clutter=clutter,
    )
    out = FrameOutput(
        motion=motion,
        pose=pose,
        num_detections=det.num_valid.astype(jnp.int32),
        num_reliable=jnp.sum(targets.is_reliable).astype(jnp.int32),
        num_associations=assoc.num_valid.astype(jnp.int32),
        target_xy=targets.position[:, :2],
        target_valid=targets.valid & targets.is_reliable,
    )
    return new_state, out


@functools.partial(jax.jit, static_argnames=("cfg", "rotate_pose"),
                   donate_argnames=("state",))
def process_scatterers(state: FrameState, scatterers: ScattererBatch,
                       key: jax.Array, cfg: PipelineConfig,
                       rotate_pose: bool = True
                       ) -> Tuple[FrameState, FrameOutput]:
    """One frame step from point-cloud scatterers (synthesis included).
    ``state`` is donated (see :func:`process_signals`)."""
    signals = synthesize_frame(scatterers, cfg.radar, key,
                               fidelity=cfg.synth_fidelity)
    return process_signals(state, signals, cfg, rotate_pose)


@functools.partial(jax.jit, static_argnames=("cfg", "rotate_pose"))
def process_sequence(scatterers: ScattererBatch, key: jax.Array,
                     cfg: PipelineConfig, rotate_pose: bool = True,
                     initial_pose: Optional[jax.Array] = None
                     ) -> FrameOutput:
    """Whole-sequence pipeline as one ``lax.scan``.

    Args:
        scatterers: stacked batches with leading frame axis [F, S_max].

    Returns:
        FrameOutput with leading frame axis [F, ...].
    """
    F = scatterers.range_m.shape[0]
    keys = jax.random.split(key, F)
    state = init_state(cfg, initial_pose)

    def step(st, inp):
        sc, k = inp
        return process_scatterers(st, sc, k, cfg, rotate_pose)

    _, outputs = jax.lax.scan(step, state, (scatterers, keys))
    return outputs


@functools.partial(jax.jit, static_argnames=("cfg", "rotate_pose", "window",
                                             "prior"))
def process_sequence_chunked(scatterers: ScattererBatch, key: jax.Array,
                             cfg: PipelineConfig, rotate_pose: bool = True,
                             initial_pose: Optional[jax.Array] = None,
                             window: int = 16,
                             prior: str = "jacobi") -> FrameOutput:
    """Sequential-SEMANTICS driver at near-batched throughput: software-
    pipelined in windows of ``window`` frames (the scan driver serializes
    every stage, and it is the path the streaming/checkpoint runtime
    uses).

    Structure: an outer ``lax.scan`` over F/window chunks; per chunk,
    EVERYTHING frame-independent runs batched over the window -- the
    front end (:func:`scatterer_features`), MDL, the AoA
    grid search, confidence (``_aoa_features``), temporal smoothing (the
    scan-free windowed form over the chunk's raw angle tables prepended
    with the carried last-H-frames history, H = (temporal_window - 1) *
    (track_max_age + 1), so track chains cross chunk boundaries exactly),
    and association (an in-chunk shift with the previous chunk's last
    targets carried in).  Only the 6-DoF solve's temporal-prior /
    failure-fallback chain is genuinely sequential, and ``prior`` selects
    how it runs:

    - ``"exact"``: an inner ``lax.scan`` chains prev_motion [6] + pose [3]
      exactly as :func:`process_sequence` does.  The cost of exactness is
      that the scanned solve runs frame after frame instead of batched.
    - ``"jacobi"`` (default): two batched sweeps.  Sweep 1 solves every
      frame without the prior; the prior for frame t is then the params of
      the last sweep-1-successful frame before t (an associative
      last-success carry -- one cummax + one gather), and sweep 2 re-solves
      with it.  The prior's weight is temporal_weight *
      regularization_weight = 1e-3 of the data terms, so the difference
      from the exact chain is second-order (asserted < 1e-3 m on the bench
      scene); failure fallback and pose coasting keep scan semantics via
      the same last-success carry.

    Equals :func:`process_sequence` (same per-frame key derivation, same
    tail math WITH the temporal prior) up to float reassociation of the
    vmapped phase A, ``smoothing.smooth_windowed``'s no-capacity-
    eviction condition (holds whenever track_capacity >= live tracks; 256
    vs <= 150 at the production operating point), and -- for
    ``prior="jacobi"`` -- the second-order prior relaxation above.
    Requires ``clutter_map_alpha == 0`` (the clutter EMA feeds detection,
    making phase A itself sequential).  Latency: results arrive in
    ``window``-frame groups -- use :func:`process_scatterers` for
    frame-at-a-time streaming.
    """
    if prior not in ("exact", "jacobi"):
        raise ValueError(f"Unknown prior mode: {prior}")
    if cfg.detection.clutter_map_alpha > 0:
        raise ValueError("process_sequence_chunked requires "
                         "clutter_map_alpha == 0 (the clutter EMA makes "
                         "detection sequential); use process_sequence")
    F = scatterers.range_m.shape[0]
    W = min(window, F)
    n_chunks = -(-F // W)
    Fp = n_chunks * W
    keys = jax.random.split(key, F)
    if Fp > F:
        pad = lambda x: jnp.concatenate(
            [x, jnp.repeat(x[-1:], Fp - F, axis=0)])
        scatterers = jax.tree.map(pad, scatterers)
        keys = pad(keys)
    sc_c = jax.tree.map(
        lambda x: x.reshape((n_chunks, W) + x.shape[1:]), scatterers)
    keys_c = keys.reshape(n_chunks, W)
    state = init_state(cfg, initial_pose)
    D = (cfg.radar.num_chirps if cfg.chirp_subset is None
         else cfg.chirp_subset[1] - cfg.chirp_subset[0])

    K = cfg.detection.max_detections
    H = (cfg.aoa.temporal_window - 1) * (cfg.aoa.track_max_age + 1)
    dtf = jnp.float32(cfg.frame_dt)
    hist0 = (jnp.full((H, K), -1, jnp.int32),      # keys (-1 = no match)
             jnp.zeros((H, K), jnp.float32),       # raw angles
             jnp.zeros((H, K), jnp.float32),       # raw confidences
             jnp.zeros((H, K), bool))              # keep masks
    carry0 = (hist0, state.prev_targets, state.prev_valid,
              state.prev_motion, state.pose)

    def chunk_step(carry, inp):
        (hk, ha, hc, hv), prev_t, prev_ok, prev_m, pose0 = carry
        sc, ks = inp
        (det, sigs, keep, num_sources, is_multi, angles_deg, el_deg,
         conf) = jax.vmap(lambda s1, k1: scatterer_features(s1, k1, cfg))(
             sc, ks)

        # Windowed temporal smoothing with carried history: track chains
        # may look back up to H frames into the previous chunks.
        det_keys = det.range_bin * D + det.doppler_bin          # [W, K]
        sm_ang, sm_conf = smoothing.smooth_windowed(
            jnp.concatenate([hk, det_keys]),
            jnp.concatenate([ha, angles_deg]),
            jnp.concatenate([hc, conf]),
            jnp.concatenate([hv, keep]), cfg.aoa)
        sm_ang, sm_conf = sm_ang[H:], sm_conf[H:]

        reliable = (keep & (sm_conf >= cfg.aoa.confidence_threshold)
                    & ~is_multi)
        targets = Targets(
            range_bin=det.range_bin, doppler_bin=det.doppler_bin,
            range_m=det.range_m, doppler_hz=det.doppler_hz,
            vr_mps=det.vr_mps, power_db=det.power_db,
            azimuth_rad=jnp.deg2rad(sm_ang), confidence=sm_conf,
            num_sources=num_sources, is_multipath=is_multi,
            is_reliable=reliable, spatial_signature=sigs, valid=keep,
            elevation_rad=jnp.deg2rad(el_deg))                  # [W, K]

        # Association: in-chunk shift + previous chunk's last targets.
        prev_b = jax.tree.map(
            lambda c, x: jnp.concatenate([c[None], x[:-1]]), prev_t,
            targets)
        nv = jnp.sum(targets.valid, axis=1) > 0                 # [W]
        has_prev = jnp.concatenate([prev_ok[None], nv[:-1]])

        def assoc_one(cur, prv, hp):
            a = associate_targets(cur, prv, cfg.frame_dt, cfg.velocity)
            return a._replace(valid=a.valid & hp)

        assoc_b = jax.vmap(assoc_one)(targets, prev_b, has_prev)

        if prior == "exact":
            # Inner scan: the prior-seeded solve + pose (state [6] + [3]).
            def solve_step(c2, a_t):
                pm, ps = c2
                motion = solve_velocity(
                    a_t, dtf, cfg.radar.lambda_c, cfg.velocity,
                    prev_motion=pm,
                    v_unambiguous=cfg.radar.max_unambiguous_velocity)
                stepped = planar_pose_step(ps, motion.velocity,
                                           motion.angular_velocity[2], dtf,
                                           rotate_pose)
                pose_new = (stepped if cfg.pose.coast_on_failure
                            else jnp.where(motion.success, stepped, ps))
                pm_new = jnp.where(motion.success, motion.params, pm)
                return (pm_new, pose_new), (motion, pose_new)

            (pm_f, pose_f), (motion_b, pose_b) = jax.lax.scan(
                solve_step, (prev_m, pose0), assoc_b)
        else:
            # Two-sweep Jacobi relaxation of the prior chain (see
            # docstring): both sweeps vmap over the window's frames.
            W_ = has_prev.shape[0]
            idx = jnp.arange(W_)
            m1 = jax.vmap(lambda a: solve_velocity(
                a, dtf, cfg.radar.lambda_c, cfg.velocity,
                v_unambiguous=cfg.radar.max_unambiguous_velocity))(assoc_b)
            # prior_t = params of the last sweep-1 success BEFORE t (the
            # carried prev_m before the chunk's first success).
            p1 = jnp.concatenate([m1.velocity, m1.angular_velocity],
                                 axis=-1)                       # [W, 6]
            j1 = jax.lax.cummax(jnp.where(m1.success, idx, -1))
            j1p = jnp.concatenate([jnp.array([-1]), j1[:-1]])
            prior_t = jnp.where((j1p >= 0)[:, None],
                                p1[jnp.clip(j1p, 0)], prev_m[None])
            motion_b = jax.vmap(lambda a, pm: solve_velocity(
                a, dtf, cfg.radar.lambda_c, cfg.velocity, prev_motion=pm,
                v_unambiguous=cfg.radar.max_unambiguous_velocity))(
                    assoc_b, prior_t)
            # Next-chunk motion carry: last sweep-2 success (scan's
            # prev_motion update rule), else the carried prev_m.
            p2 = jnp.concatenate([motion_b.velocity,
                                  motion_b.angular_velocity], axis=-1)
            j2 = jax.lax.cummax(jnp.where(motion_b.success, idx, -1))
            pm_f = jnp.where(j2[-1] >= 0, p2[jnp.clip(j2[-1], 0)], prev_m)
            # Pose prefix with scan-coast semantics: failed frames already
            # carry the fallback (prior_t) velocity inside MotionEstimate,
            # so coasting is just the prefix sum of the substituted steps;
            # with coast_on_failure=False failed steps freeze instead.
            wz = motion_b.angular_velocity[:, 2]
            v2 = motion_b.velocity[:, :2]
            if not cfg.pose.coast_on_failure:
                wz = jnp.where(motion_b.success, wz, 0.0)
                v2 = jnp.where(motion_b.success[:, None], v2, 0.0)
            yaw_after = pose0[2] + jnp.cumsum(wz * dtf)
            yaw_before = yaw_after - wz * dtf
            if rotate_pose:
                c_, s_ = jnp.cos(yaw_before), jnp.sin(yaw_before)
                step_xy = jnp.stack([c_ * v2[:, 0] - s_ * v2[:, 1],
                                     s_ * v2[:, 0] + c_ * v2[:, 1]],
                                    axis=-1) * dtf
            else:
                step_xy = v2 * dtf
            xy_after = pose0[None, :2] + jnp.cumsum(step_xy, axis=0)
            pose_b = jnp.concatenate([xy_after, yaw_after[:, None]],
                                     axis=-1)
            pose_f = pose_b[-1]

        out = FrameOutput(
            motion=motion_b, pose=pose_b,
            num_detections=jnp.sum(det.valid, axis=1).astype(jnp.int32),
            num_reliable=jnp.sum(reliable, axis=1).astype(jnp.int32),
            num_associations=jnp.sum(assoc_b.valid,
                                     axis=1).astype(jnp.int32),
            target_xy=targets.position[..., :2],
            target_valid=targets.valid & targets.is_reliable)

        new_hist = tuple(
            jnp.concatenate([h, x])[-H:] if H > 0 else h
            for h, x in ((hk, jnp.where(keep, det_keys, -1)),
                         (ha, angles_deg), (hc, conf), (hv, keep)))
        last_t = jax.tree.map(lambda x: x[-1], targets)
        return (new_hist, last_t, nv[-1], pm_f, pose_f), out

    _, outs = jax.lax.scan(chunk_step, carry0, (sc_c, keys_c))
    return jax.tree.map(
        lambda x: x.reshape((Fp,) + x.shape[2:])[:F], outs)


@functools.partial(jax.jit, static_argnames=("cfg", "rotate_pose"))
def process_signal_sequence(signals: jax.Array, cfg: PipelineConfig,
                            rotate_pose: bool = True) -> FrameOutput:
    """Whole-sequence pipeline over pre-synthesized ADC cubes [F, A, C, S]."""
    state = init_state(cfg)

    def step(st, sig):
        return process_signals(st, sig, cfg, rotate_pose)

    _, outputs = jax.lax.scan(step, state, signals)
    return outputs


def detect_frame(signals: jax.Array, cfg: PipelineConfig,
                 clutter_lin: Optional[jax.Array] = None):
    """RDS -> detection -> spatial signatures for ONE frame's ADC cube
    [A, C, S]; the one place the ``fft_mode`` branch lives.

    ``fft_mode="fused"`` detects on the power map straight from the cube
    and recomputes f32 signatures for only the detected cells (see
    ``signal/rds.py:rds_power``); the other modes materialize the complex
    RDS cube.  ``clutter_lin`` (or None) is the clutter map subtracted
    before CFAR; it comes back updated with this frame.

    Returns (det, sigs [K, A], clutter_lin, doppler_bins)."""
    alpha = cfg.detection.clutter_map_alpha
    if cfg.fft_mode == "fused":
        p_lin = rds_power(signals, cfg.radar, window=cfg.window,
                          chirp_subset=cfg.chirp_subset,
                          doppler_window=cfg.doppler_window)
        det = detect_peaks_from_power(p_lin, cfg.radar, cfg.detection,
                                      clutter_lin=clutter_lin)
        sigs = detection_signatures(signals, det.range_bin, det.doppler_bin,
                                    cfg.radar, window=cfg.window,
                                    chirp_subset=cfg.chirp_subset,
                                    doppler_window=cfg.doppler_window)
        if clutter_lin is not None:
            clutter_lin = detect_mod.clutter_map_update_from_power(
                clutter_lin, p_lin, alpha)
        return det, sigs, clutter_lin, p_lin.shape[-1]
    rds = range_doppler_spectrum(signals, cfg.radar, window=cfg.window,
                                 chirp_subset=cfg.chirp_subset,
                                 doppler_window=cfg.doppler_window,
                                 fft_mode=cfg.fft_mode,
                                 dft_precision=cfg.dft_precision)
    det = detect_peaks(rds, cfg.radar, cfg.detection, clutter_lin=clutter_lin)
    sigs = detect_mod.extract_spatial_signatures(rds, det)
    if clutter_lin is not None:
        clutter_lin = detect_mod.clutter_map_update(clutter_lin, rds, alpha)
    return det, sigs, clutter_lin, rds.shape[-1]


def frame_features(signals: jax.Array, cfg: PipelineConfig):
    """Frame-independent heavy stages for ONE frame's ADC cube [A, C, S]:
    RDS -> detection -> signatures -> MDL -> angles -> confidence.

    Shared by the batched sequence driver (vmap over frames) and the
    frame-parallel SPMD driver (``parallel/dp.py``); everything sequential
    (temporal smoothing, association, prior, pose) stays with the caller.

    Returns (det, sigs, keep, num_sources, is_multi, angles_deg, el_deg,
    conf)."""
    det, sigs, _, _ = detect_frame(signals, cfg)
    return _aoa_features(det, sigs, cfg)


def scatterer_features(scatterers: ScattererBatch, key: jax.Array,
                       cfg: PipelineConfig):
    """Phase A for ONE frame of point-cloud scatterers: synthesis with the
    frame's noise key, then :func:`frame_features`.  Every scatterer driver
    (batched, chunked, rig, frame-parallel) vmaps this one function, so
    the per-frame keys give the same noise realization in all of them."""
    sig = synthesize_frame(scatterers, cfg.radar, key,
                           fidelity=cfg.synth_fidelity)
    return frame_features(sig, cfg)


def _aoa_features(det, sigs, cfg: PipelineConfig):
    """The AoA tail of :func:`frame_features` for one frame: MDL model
    order, angles, confidence from detections + signatures."""
    from radar_slam_tpu.aoa import confidence as conf_mod
    from radar_slam_tpu.aoa import estimators

    K = det.range_bin.shape[0]
    keep = (det.valid & (det.power_db > cfg.aoa.power_filter_db)
            & (jnp.arange(K) < cfg.aoa.max_targets))
    # Rank-1 analytic spectrum instead of a 32k-batch eigh (see
    # estimators.rank1_eigenvalues; MDL consumes eigenvalues only).
    eigvals = estimators.rank1_eigenvalues(sigs)
    num_sources, is_multi, _ = conf_mod.mdl_model_order(eigvals)
    angles_deg, el_deg, _ = estimators.estimate_angles_2d(
        sigs, cfg.radar, cfg.aoa, method=cfg.aoa.method,
        num_sources=num_sources)
    conf = conf_mod.angle_confidence(sigs, angles_deg, cfg.radar, el_deg)
    return det, sigs, keep, num_sources, is_multi, angles_deg, el_deg, conf


@functools.partial(jax.jit, static_argnames=("cfg", "rotate_pose"))
def process_sequence_batched(scatterers: ScattererBatch, key: jax.Array,
                             cfg: PipelineConfig,
                             rotate_pose: bool = True) -> FrameOutput:
    """Throughput-oriented sequence driver: two-phase split.

    The per-frame chain is mostly frame-independent; only the temporal
    smoother, association, temporal prior and pose are sequential.  Phase A
    vmaps the heavy stages (synthesis, RDS, detection, signatures, angles,
    confidence, MDL) over ALL frames at once -- large batched FFTs/matmuls/
    eigh instead of a serialized scan -- and phase B scans only the tiny
    state machine.  Semantics match :func:`process_sequence` exactly (the
    smoother consumes the same raw angles); results differ only by float
    reassociation.
    """
    F = scatterers.range_m.shape[0]
    keys = jax.random.split(key, F)

    # ---- phase A: batched per-frame heavy compute -------------------------
    features = jax.vmap(lambda sc, k: scatterer_features(sc, k, cfg))(
        scatterers, keys)
    return _sequence_from_features(features, cfg, rotate_pose)


@functools.partial(jax.jit, static_argnames=("cfg", "rotate_pose"))
def process_signal_sequence_batched(signals: jax.Array, cfg: PipelineConfig,
                                    rotate_pose: bool = True) -> FrameOutput:
    """Batched (two-phase) driver over pre-synthesized cubes [F, A, C, S];
    the semantics reference for ``parallel/dp.py``."""
    features = jax.vmap(lambda s: frame_features(s, cfg))(signals)
    return _sequence_from_features(features, cfg, rotate_pose)


def _batched_assoc_solve(targets: Targets, cfg: PipelineConfig,
                         sensor_pos: Optional[jax.Array] = None,
                         group: Optional[jax.Array] = None):
    """Phase B2 shared by the batched drivers: association + velocity solve,
    batched over frames.  Association only needs the PREVIOUS frame's
    targets -- a shift, not a scan.  The temporal motion prior is dropped
    here (weight is 0.001x the data terms; the scan drivers keep it).

    ``sensor_pos`` [K, 3] / ``group`` [K] are the mounted-rig extensions
    (per-target sensor origins and sensor-block ids; pipeline/rig.py)."""
    F = targets.range_m.shape[0]
    prev = jax.tree.map(lambda x: jnp.concatenate([x[:1], x[:-1]]), targets)
    has_prev = jnp.arange(F) > 0

    def solve_one(cur, prv, hp):
        assoc = associate_targets(cur, prv, cfg.frame_dt, cfg.velocity,
                                  sensor_pos=sensor_pos, group=group)
        assoc = assoc._replace(valid=assoc.valid & hp)
        return assoc.num_valid, solve_velocity(
            assoc, jnp.float32(cfg.frame_dt), cfg.radar.lambda_c,
            cfg.velocity,
            v_unambiguous=cfg.radar.max_unambiguous_velocity)

    return jax.vmap(solve_one)(targets, prev, has_prev)


def _pose_prefix(motion: MotionEstimate, cfg: PipelineConfig,
                 rotate_pose: bool) -> jax.Array:
    """Phase B3 shared by the batched drivers: planar pose composition as
    vectorized prefix sums over per-frame increments."""
    dtf = jnp.float32(cfg.frame_dt)
    wz = jnp.where(motion.success, motion.angular_velocity[:, 2], 0.0)
    yaw_after = jnp.cumsum(wz * dtf)
    yaw_before = yaw_after - wz * dtf
    v = jnp.where(motion.success[:, None], motion.velocity[:, :2], 0.0)
    if rotate_pose:
        c, s = jnp.cos(yaw_before), jnp.sin(yaw_before)
        step_xy = jnp.stack([c * v[:, 0] - s * v[:, 1],
                             s * v[:, 0] + c * v[:, 1]], axis=-1) * dtf
    else:
        step_xy = v * dtf
    xy_after = jnp.cumsum(step_xy, axis=0)
    return jnp.concatenate([xy_after, yaw_after[:, None]], axis=-1)


def _sequence_from_features(features, cfg: PipelineConfig,
                            rotate_pose: bool) -> FrameOutput:
    """Phase B shared by the batched drivers: windowed temporal smoothing,
    shift-association, batched solves, prefix-sum pose."""
    (det, sigs, keep, num_sources, is_multi, angles_deg, el_deg,
     conf) = features
    F = det.range_bin.shape[0]
    D = cfg.radar.num_chirps if cfg.chirp_subset is None else (
        cfg.chirp_subset[1] - cfg.chirp_subset[0])

    # ---- phase B1: temporal smoothing, scan-free -- the slot-table scan is
    # re-derived as a parallel windowed gather over [F, K] (exact under the
    # no-capacity-eviction condition; see smoothing.smooth_windowed) --------
    det_keys = det.range_bin * D + det.doppler_bin            # [F, K]
    angles_s, conf_s = smoothing.smooth_windowed(
        det_keys, angles_deg, conf, keep, cfg.aoa)

    reliable = keep & (conf_s >= cfg.aoa.confidence_threshold) & ~is_multi
    targets = Targets(
        range_bin=det.range_bin, doppler_bin=det.doppler_bin,
        range_m=det.range_m, doppler_hz=det.doppler_hz,
        vr_mps=det.vr_mps, power_db=det.power_db,
        azimuth_rad=jnp.deg2rad(angles_s), confidence=conf_s,
        num_sources=num_sources, is_multipath=is_multi,
        is_reliable=reliable, spatial_signature=sigs, valid=keep,
        elevation_rad=jnp.deg2rad(el_deg))                         # [F, ...]

    n_assoc, motion = _batched_assoc_solve(targets, cfg)
    pose = _pose_prefix(motion, cfg, rotate_pose)

    return FrameOutput(
        motion=motion, pose=pose,
        num_detections=jnp.sum(det.valid, axis=-1).astype(jnp.int32),
        num_reliable=jnp.sum(reliable, axis=-1).astype(jnp.int32),
        num_associations=n_assoc.astype(jnp.int32),
        target_xy=targets.position[..., :2],
        target_valid=targets.valid & targets.is_reliable)
