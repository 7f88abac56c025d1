"""Known-truth tests for synthesis -> RDS -> detection.

Models the reference's ``tests/test_synth_raw.py`` scenarios (single target at
50 m found within tolerance, moving target with nonzero Doppler, multi-target
recovery) but with hard asserts on range, Doppler AND radial velocity, which
the reference cannot assert because its synthesizer never applies a slow-time
Doppler ramp (simulate_raw.py:192 unused)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radar_slam_tpu.core.config import DetectionConfig, RadarConfig
from radar_slam_tpu.core.types import ScattererBatch
from radar_slam_tpu.signal.detect import detect_peaks, extract_spatial_signatures
from radar_slam_tpu.signal.rds import (doppler_axis_hz, range_axis_m,
                                       range_doppler_spectrum)
from radar_slam_tpu.signal.synth import synthesize_frame

# Quiet-radar test config: the reference amplitude model sqrt(rcs)/(4 pi R^2)
# (simulate_raw.py:125-126) puts a lone mid-range target ~16 dB *below* the
# default noise_power=0.01 floor even after 2-D FFT processing gain; the
# reference's own synth test only "finds" its target because noise local
# maxima blanket the map.  We test detection physics at a sane SNR.
CFG = RadarConfig(noise_power=1e-6)
DET = DetectionConfig(threshold_db=-12.0, max_detections=16)



def make_scatterers(rows, size=8):
    n = len(rows)
    pad = size - n
    def col(i, fill=0.0):
        return jnp.array([r[i] for r in rows] + [fill] * pad, jnp.float32)
    return ScattererBatch(
        range_m=col(0), azimuth_rad=col(1), rcs_db=col(2), vr=col(3),
        valid=jnp.array([True] * n + [False] * pad))


def run_chain(rows, cfg=CFG, det=DET, seed=0, add_noise=True):
    sc = make_scatterers(rows)
    sig = synthesize_frame(sc, cfg, jax.random.key(seed), add_noise=add_noise)
    rds = range_doppler_spectrum(sig, cfg)
    return rds, detect_peaks(rds, cfg, det)


def test_config_derived_parameters():
    assert CFG.samples_per_chirp == 400
    assert CFG.range_resolution == pytest.approx(0.15)
    assert CFG.velocity_resolution == pytest.approx(0.3043, abs=1e-3)  # 64 chirps
    assert RadarConfig(num_chirps=32).velocity_resolution == pytest.approx(0.6087, abs=1e-3)
    assert CFG.lambda_c == pytest.approx(3.896e-3, rel=1e-3)
    assert CFG.prf == pytest.approx(10e3)


def test_single_stationary_target_range():
    rds, det = run_chain([(50.0, 0.1, 5.0, 0.0)])
    assert rds.shape == (8, 400, 64)
    best = int(jnp.argmax(det.power_db))
    assert bool(det.valid[best])
    assert float(det.range_m[best]) == pytest.approx(50.0, abs=0.5)
    # Stationary -> zero-Doppler bin.
    assert abs(float(det.doppler_hz[best])) < 1.5 * CFG.prf / CFG.num_chirps
    assert float(det.vr_mps[best]) == pytest.approx(0.0, abs=1.5 * CFG.velocity_resolution)


def test_moving_target_doppler_and_velocity():
    vr = 5.0  # receding at 5 m/s
    rds, det = run_chain([(30.0, -0.2, 10.0, vr)])
    best = int(jnp.argmax(det.power_db))
    assert float(det.range_m[best]) == pytest.approx(30.0, abs=0.5)
    assert float(det.vr_mps[best]) == pytest.approx(vr, abs=1.2 * CFG.velocity_resolution)
    # Receding -> negative Doppler under the physical convention.
    assert float(det.doppler_hz[best]) < 0


def test_multi_target_recovery():
    rows = [(20.0, 0.3, 10.0, -3.0), (45.0, -0.4, 12.0, 2.0), (57.0, 0.0, 15.0, 0.0)]
    _, det = run_chain(rows)
    found = 0
    for r, _, _, v in rows:
        hit = (jnp.abs(det.range_m - r) < 1.0) & \
              (jnp.abs(det.vr_mps - v) < 2 * CFG.velocity_resolution) & det.valid
        found += int(jnp.any(hit))
    assert found >= 3


def test_detection_range_gate_and_mask():
    det_cfg = DetectionConfig(threshold_db=-12.0, max_detections=16,
                              min_range=10.0, max_range=40.0)
    _, det = run_chain([(5.0, 0.0, 20.0, 0.0), (30.0, 0.0, 10.0, 0.0)],
                       det=det_cfg)
    r = np.asarray(det.range_m)[np.asarray(det.valid)]
    assert np.all((r >= 10.0) & (r <= 40.0))
    assert np.any(np.abs(r - 30.0) < 0.5)
    assert not np.any(np.abs(r - 5.0) < 0.5)


def test_dechirp_of_raw_equals_baseband():
    sc = make_scatterers([(25.0, 0.2, 10.0, 1.0)])
    base = synthesize_frame(sc, CFG, jax.random.key(1), output="baseband",
                            add_noise=False)
    raw = synthesize_frame(sc, CFG, jax.random.key(1), output="raw",
                           add_noise=False)
    rds_b = range_doppler_spectrum(base, CFG, input_domain="baseband")
    rds_r = range_doppler_spectrum(raw, CFG, input_domain="raw")
    np.testing.assert_allclose(np.asarray(rds_b), np.asarray(rds_r),
                               rtol=1e-3, atol=1e-3)


def test_spatial_signature_matches_steering_vector():
    from radar_slam_tpu.core.geometry import steering_vector
    az = 0.35
    rds, det = run_chain([(40.0, az, 15.0, 0.0)], add_noise=False)
    best = int(jnp.argmax(det.power_db))
    sig = extract_spatial_signatures(rds, det)[best]
    sv = steering_vector(az, CFG.num_antennas, CFG.spacing, CFG.lambda_c)
    corr = jnp.abs(jnp.vdot(sv, sig)) / jnp.sqrt(
        jnp.vdot(sv, sv).real * jnp.vdot(sig, sig).real)
    assert float(corr) > 0.99


def test_axes_shapes():
    assert range_axis_m(CFG).shape == (400,)
    assert float(range_axis_m(CFG)[1]) == pytest.approx(0.15)
    d = doppler_axis_hz(CFG)
    assert d.shape == (64,)
    assert float(d[0]) == pytest.approx(-CFG.prf / 2)


def test_chirp_subset():
    sc = make_scatterers([(30.0, 0.0, 10.0, 0.0)])
    sig = synthesize_frame(sc, CFG, jax.random.key(0))
    rds = range_doppler_spectrum(sig, CFG, chirp_subset=(0, 32))
    assert rds.shape == (8, 400, 32)


def test_fft_mode_matmul_matches_fft():
    """DFT-as-matmul RDS must match the XLA FFT path."""
    k1, k2 = jax.random.split(jax.random.key(3))
    sig = (jax.random.normal(k1, (8, 32, 400))
           + 1j * jax.random.normal(k2, (8, 32, 400))).astype(jnp.complex64)
    cfg32 = dataclasses.replace(CFG, num_chirps=32)
    for dw in (None, "hann"):
        a = np.asarray(range_doppler_spectrum(sig, cfg32, doppler_window=dw))
        b = np.asarray(range_doppler_spectrum(sig, cfg32, doppler_window=dw,
                                              fft_mode="matmul"))
        rel = np.abs(a - b).max() / np.abs(a).max()
        assert rel < 1e-3, rel
