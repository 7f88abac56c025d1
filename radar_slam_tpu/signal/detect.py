"""Static-shape range-Doppler peak detection (local-max / CA-CFAR + top-K).

Replaces the reference's dynamic peak extraction
(``src/radar_signal/dechirp.py:215-271``: per-antenna power dB, 3x3
``maximum_filter`` local maxima above a dB threshold, range gate 1-200 m,
variable-length dict list) with a fixed top-K detection set + validity mask so
the stage jits and batches.

Differences from the reference (deliberate, SURVEY.md section 7 decision 2):
- power is integrated non-coherently across antennas (mean |rds|^2) instead of
  detecting per antenna; the reference emits up to A duplicate peaks per
  physical target (one per antenna) which all collapse to the same
  (range_bin, doppler_bin) spatial signature downstream.
- an optional cell-averaging CFAR offset over a local training band replaces
  the fixed global threshold when ``cfar_train_cells > 0``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from radar_slam_tpu.core.config import DetectionConfig, RadarConfig
from radar_slam_tpu.core.types import Detections
from radar_slam_tpu.signal.rds import (doppler_axis_hz,
                                       doppler_to_radial_velocity,
                                       range_axis_m)


def _window1d(x: jax.Array, size: int, axis: int, init, op) -> jax.Array:
    pad = size // 2
    win = [1, 1]
    win[axis] = size
    padding = [(0, 0), (0, 0)]
    padding[axis] = (pad, pad)
    return jax.lax.reduce_window(x, init, op, tuple(win), (1, 1),
                                 tuple(padding))


def _maxpool2d_same(x: jax.Array, size: int) -> jax.Array:
    """Max filter with SAME padding (scipy.ndimage.maximum_filter parity).

    Separable: two 1-D passes (2*size ops/cell instead of size^2 -- the 2-D
    reduce_window also constant-folds pathologically slowly in XLA for the
    21x21 CFAR windows)."""
    x = _window1d(x, size, 0, -jnp.inf, jax.lax.max)
    return _window1d(x, size, 1, -jnp.inf, jax.lax.max)


def _box_sum2d(x: jax.Array, size: int) -> jax.Array:
    x = _window1d(x, size, 0, 0.0, jax.lax.add)
    return _window1d(x, size, 1, 0.0, jax.lax.add)


def _box_mean2d(x: jax.Array, size: int) -> jax.Array:
    """Box mean with SAME (zero-extended) padding; separable (see
    :func:`_maxpool2d_same`).  The per-cell valid count is the outer product
    of the 1-D counts (rectangular window intersection), computed in closed
    form instead of reduce_window over ones."""
    R, D = x.shape
    pad = size // 2

    def counts(n):
        i = jnp.arange(n)
        return (jnp.minimum(i + pad, n - 1) - jnp.maximum(i - pad, 0) + 1.0)

    n = counts(R)[:, None] * counts(D)[None, :]
    return _box_sum2d(x, size) / n


def _os_noise(p_lin: jax.Array, train: int, guard: int,
              rank: float) -> jax.Array:
    """Order-statistic noise estimate per cell [R, D].

    Training cells are a cross of ``train`` cells per side beyond the guard
    band along both axes (4*train samples per cell); the estimate is the
    ``rank``-quantile order statistic -- unlike the CA mean it ignores up to
    (1-rank) of the training cells being contaminated by other targets.

    Rolled (wrap-around) shifts keep everything static-shape, but a wrapped
    sample trains an edge cell on the OPPOSITE border -- on the Doppler axis
    (fast ego folds targets to the spectrum edges) that border often holds
    real target energy (round-1 weak item 10).  Wrapped samples are
    therefore masked to +inf and the order statistic adapts to each cell's
    true training count."""
    R, D = p_lin.shape
    row = jnp.arange(R)[:, None]
    col = jnp.arange(D)[None, :]
    shifts, valids = [], []
    for o in range(guard + 1, guard + train + 1):
        shifts += [jnp.roll(p_lin, o, axis=0), jnp.roll(p_lin, -o, axis=0),
                   jnp.roll(p_lin, o, axis=1), jnp.roll(p_lin, -o, axis=1)]
        valids += [jnp.broadcast_to(row >= o, (R, D)),
                   jnp.broadcast_to(row < R - o, (R, D)),
                   jnp.broadcast_to(col >= o, (R, D)),
                   jnp.broadcast_to(col < D - o, (R, D))]
    stack = jnp.stack(shifts)                                  # [4T, R, D]
    valid = jnp.stack(valids)
    stack = jnp.where(valid, stack, jnp.inf)
    n_valid = jnp.sum(valid, axis=0)                           # [R, D]
    k = jnp.clip(jnp.round(rank * (n_valid - 1)).astype(jnp.int32),
                 0, stack.shape[0] - 1)
    est = jnp.take_along_axis(jnp.sort(stack, axis=0), k[None], axis=0)[0]
    # A cell with no valid training samples (degenerate tiny maps) falls
    # back to the global mean so downstream thresholds stay finite.
    return jnp.where(jnp.isfinite(est), est, jnp.mean(p_lin))


def power_spectrum_db(rds: jax.Array) -> jax.Array:
    """Non-coherent power map [R, D] in dB from RDS [A, R, D]
    (dechirp.py:234-238, integrated over antennas)."""
    p = jnp.mean(jnp.abs(rds) ** 2, axis=0)
    return 10.0 * jnp.log10(p + 1e-12)


def clutter_map_update(clutter_lin: jax.Array, rds: jax.Array,
                       alpha: float) -> jax.Array:
    """Exponential-moving-average background power map (linear domain).

    Persistent returns (direct coupling, stationary clutter for a parked
    ego) accumulate into the map and are suppressed by the clutter
    threshold; transient targets do not.  The map starts at zero (no effect)
    and warms up over ~1/alpha frames."""
    p = jnp.mean(jnp.abs(rds) ** 2, axis=0)
    return clutter_map_update_from_power(clutter_lin, p, alpha)


def clutter_map_update_from_power(clutter_lin: jax.Array, p_lin: jax.Array,
                                  alpha: float) -> jax.Array:
    """:func:`clutter_map_update` from a precomputed power map (the fused
    detection path already has ``mean_a |rds|^2``)."""
    return (1.0 - alpha) * clutter_lin + alpha * p_lin


@functools.partial(jax.jit, static_argnames=("cfg", "det"))
def detect_peaks(rds: jax.Array, cfg: RadarConfig,
                 det: DetectionConfig,
                 clutter_lin: jax.Array | None = None) -> Detections:
    """Extract the top-K range-Doppler peaks from an RDS cube [A, R, D].

    Returns a masked static-shape :class:`Detections` (K = det.max_detections),
    sorted by descending power.  ``clutter_lin`` is an optional [R, D]
    background power map (see :func:`clutter_map_update`); cells must additionally exceed it by
    ``det.clutter_offset_db``.
    """
    # Linear power once; dB derived from it (round 1 recomputed
    # p_lin = 10^(dB/10), an 800k-cell transcendental round trip).
    p_lin = jnp.mean(jnp.abs(rds) ** 2, axis=0) + 1e-12      # [R, D]
    power_db, is_peak_above = _threshold_power(p_lin, det)
    return _finalize_detections(power_db, is_peak_above, cfg, det,
                                clutter_lin)


def _threshold_power(p_lin: jax.Array, det: DetectionConfig):
    """Local-max + (CFAR-relative) threshold mask from a linear power map.

    Returns (power_db [R, D], is_peak_above [R, D])."""
    power_db = 10.0 * jnp.log10(p_lin)
    # Local maxima (3x3 by default; dechirp.py:250-254).
    is_peak = _maxpool2d_same(power_db, det.neighborhood) == power_db
    # Detection threshold: fixed dB level, optionally CFAR-relative.
    if det.cfar_train_cells > 0:
        if det.cfar_mode == "os":
            noise = _os_noise(p_lin, det.cfar_train_cells,
                              det.guard_cells, det.os_rank)
        elif det.cfar_mode == "ca":
            train = 2 * det.cfar_train_cells + 2 * det.guard_cells + 1
            guard = 2 * det.guard_cells + 1
            noise = _box_mean2d(p_lin, train)
            if det.guard_cells > 0:
                # Exclude the guard+cell region from the training average.
                g = _box_mean2d(p_lin, guard)
                n_train = train * train
                n_guard = guard * guard
                noise = (noise * n_train - g * n_guard) / (n_train - n_guard)
        else:
            raise ValueError(f"Unknown cfar_mode: {det.cfar_mode}")
        noise_db = 10.0 * jnp.log10(jnp.maximum(noise, 1e-12))
        thresh = jnp.maximum(noise_db + det.cfar_offset_db,
                             det.threshold_db)
    else:
        thresh = jnp.float32(det.threshold_db)
    return power_db, is_peak & (power_db > thresh)


@functools.partial(jax.jit, static_argnames=("cfg", "det"))
def detect_peaks_from_power(p_lin: jax.Array, cfg: RadarConfig,
                            det: DetectionConfig,
                            clutter_lin: jax.Array | None = None
                            ) -> Detections:
    """:func:`detect_peaks` from a precomputed linear power map [R, D]
    (``mean_a |rds|^2``) -- the fused detection path, fed by
    ``signal/rds.py:rds_power`` so the complex RDS cube is never built."""
    power_db, is_peak_above = _threshold_power(p_lin + 1e-12, det)
    return _finalize_detections(power_db, is_peak_above, cfg, det,
                                clutter_lin)


def _finalize_detections(power_db: jax.Array, is_peak_above: jax.Array,
                         cfg: RadarConfig, det: DetectionConfig,
                         clutter_lin: jax.Array | None) -> Detections:
    """Shared tail of the detectors: range gate, clutter gate, top-K, NMS,
    sub-bin interpolation (see :func:`detect_peaks`)."""
    K = det.max_detections
    R, D = power_db.shape

    # Range gate (dechirp.py:263).
    ranges = range_axis_m(cfg, R)                           # [R]
    gate = (ranges >= det.min_range) & (ranges <= det.max_range)
    mask = is_peak_above & gate[:, None]

    if clutter_lin is not None:
        clutter_db = 10.0 * jnp.log10(jnp.maximum(clutter_lin, 1e-12))
        mask = mask & (power_db > clutter_db + det.clutter_offset_db)

    # Top-K by power over the masked map (static shape).
    score = jnp.where(mask, power_db, -jnp.inf).reshape(-1)
    top_vals, top_idx = jax.lax.top_k(score, K)
    r_bin = (top_idx // D).astype(jnp.int32)
    d_bin = (top_idx % D).astype(jnp.int32)
    return _detections_from_bins(power_db, r_bin, d_bin, top_vals, cfg, det)


def _detections_from_bins(power_db: jax.Array, r_bin: jax.Array,
                          d_bin: jax.Array, top_vals: jax.Array,
                          cfg: RadarConfig, det: DetectionConfig
                          ) -> Detections:
    """Shared [K]-shaped tail: validity, NMS, sub-bin interpolation,
    axis conversion (see :func:`detect_peaks`)."""
    K = det.max_detections
    R, D = power_db.shape
    valid = jnp.isfinite(top_vals)

    if det.nms_radius > 0:
        # Cross-detection NMS: the top-K list is power-sorted, so detection i
        # is suppressed if any j < i lies within the Chebyshev radius.
        dr = jnp.abs(r_bin[:, None] - r_bin[None, :])
        dd = jnp.abs(d_bin[:, None] - d_bin[None, :])
        close = (dr <= det.nms_radius) & (dd <= det.nms_radius)
        stronger = jnp.arange(K)[None, :] < jnp.arange(K)[:, None]
        suppressed = jnp.any(close & stronger & valid[None, :], axis=1)
        valid = valid & ~suppressed

    # Sub-bin refinement: parabolic interpolation of the dB power through the
    # peak and its neighbours, along both axes.  The Doppler fraction matters
    # most -- one Doppler bin is lambda/(2 C PRI) of radial velocity (0.3 m/s
    # at 64 chirps), while the cross-frame phase observable wraps every
    # lambda/(4 dt) ~ 2 cm/s; sub-bin interpolation bridges that gap.  The
    # reference reports integer bins only (dechirp.py:258-271).
    # One contiguous ROW gather + one-hot masked reductions: rows r-1..r+1
    # are contiguous in the minor axis, so whole [D]-rows are gathered
    # instead of 5 scattered elements; the within-row taps are bit-exact
    # one-hot sums (single nonzero) that fuse with the surrounding
    # arithmetic.
    rows3 = jnp.take(power_db,
                     jnp.clip(jnp.stack([r_bin - 1, r_bin, r_bin + 1],
                                        axis=-1), 0, R - 1).reshape(-1),
                     axis=0).reshape(K, 3, D)               # [K, 3, D]
    cols = jnp.arange(D)[None, :]
    tap_row = lambda r3, dd: jnp.sum(
        jnp.where(cols == jnp.clip(dd, 0, D - 1)[:, None], r3, 0.0),
        axis=-1)
    y0 = tap_row(rows3[:, 1], d_bin)

    def parabolic_frac(ym, yp):
        denom = ym - 2.0 * y0 + yp
        frac = jnp.where(jnp.abs(denom) > 1e-9,
                         0.5 * (ym - yp) / jnp.where(jnp.abs(denom) > 1e-9,
                                                     denom, 1.0), 0.0)
        return jnp.clip(frac, -0.5, 0.5)

    r_frac = parabolic_frac(tap_row(rows3[:, 0], d_bin),
                            tap_row(rows3[:, 2], d_bin))
    r_frac = jnp.where((r_bin > 0) & (r_bin < R - 1), r_frac, 0.0)
    d_frac = parabolic_frac(tap_row(rows3[:, 1], d_bin - 1),
                            tap_row(rows3[:, 1], d_bin + 1))
    d_frac = jnp.where((d_bin > 0) & (d_bin < D - 1), d_frac, 0.0)

    # Axis lookups computed arithmetically instead of gathered from the
    # [R]/[D] axis tables: both axes are affine in the bin index with the
    # SAME f32 operations the tables are built from (range_axis_m is
    # arange(R) * step; doppler_axis_hz is (d - D//2) * (1/(D*pri)) for
    # even D), so values are bit-equal and two more gathers disappear.
    ranges = range_axis_m(cfg, R)       # table kept for the step; no gather
    dop_step = jnp.float32(cfg.prf) / D
    rng_step = ranges[1] - ranges[0] if R > 1 else jnp.float32(0.0)
    doppler_hz = ((d_bin - D // 2).astype(jnp.float32)
                  * jnp.float32(1.0 / (D * cfg.pri)) + d_frac * dop_step)
    range_m = r_bin.astype(jnp.float32) * rng_step + r_frac * rng_step
    return Detections(
        range_bin=jnp.where(valid, r_bin, 0),
        doppler_bin=jnp.where(valid, d_bin, 0),
        range_m=jnp.where(valid, range_m, 0.0),
        doppler_hz=jnp.where(valid, doppler_hz, 0.0),
        vr_mps=jnp.where(valid, doppler_to_radial_velocity(doppler_hz, cfg), 0.0),
        power_db=jnp.where(valid, top_vals, -jnp.inf),
        valid=valid,
    )


def extract_spatial_signatures(rds: jax.Array, detections: Detections) -> jax.Array:
    """Unit-power spatial signatures [K, A] for each detection.

    signature_k = rds[:, r_k, d_k] / ||.||  (angle_estimation.py:67-90)."""
    sig = rds[:, detections.range_bin, detections.doppler_bin]       # [A, K]
    sig = jnp.swapaxes(sig, 0, 1)                                    # [K, A]
    power = jnp.sum(jnp.abs(sig) ** 2, axis=-1, keepdims=True)
    sig = jnp.where(power > 0, sig / jnp.sqrt(jnp.maximum(power, 1e-30)), sig)
    return sig.astype(jnp.complex64)
