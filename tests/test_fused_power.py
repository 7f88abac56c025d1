"""Fused detection path (signal/rds.py:rds_power + detection_signatures):
the complex RDS cube is not kept.

Equivalence targets: the default fft pipeline (power maps identical;
signatures f32-recomputed; end-to-end pose within float reassociation)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radar_slam_tpu.core.config import complete_analysis_config
from radar_slam_tpu.signal.detect import (detect_peaks,
                                          detect_peaks_from_power,
                                          extract_spatial_signatures)
from radar_slam_tpu.signal.rds import (detection_signatures,
                                       range_doppler_spectrum, rds_power)



def _cfg():
    return complete_analysis_config()


def _signals(cfg, frames=2, seed=0):
    from radar_slam_tpu.io.synthetic import SceneConfig, constant_motion_scene
    from radar_slam_tpu.signal.synth import synthesize_frames_batch
    batches, _ = constant_motion_scene(
        seed, num_frames=frames, dt=cfg.frame_dt, v_body=(8.0, 0.5),
        yaw_rate=0.05,
        scene=SceneConfig(num_points=64, max_scatterers=cfg.max_scatterers))
    return synthesize_frames_batch(batches, cfg.radar, jax.random.key(1))


def test_rds_power_xla_matches_fft_power():
    cfg = _cfg()
    sig = _signals(cfg)
    rds = range_doppler_spectrum(sig, cfg.radar, window=cfg.window,
                                 doppler_window=cfg.doppler_window)
    want = jnp.mean(jnp.abs(rds) ** 2, axis=-3)
    got = rds_power(sig, cfg.radar, window=cfg.window,
                    doppler_window=cfg.doppler_window)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-8)


def test_detection_signatures_match_cube_gather():
    cfg = _cfg()
    sig = _signals(cfg, frames=1)[0]
    rds = range_doppler_spectrum(sig, cfg.radar, window=cfg.window,
                                 doppler_window=cfg.doppler_window)
    det = detect_peaks(rds, cfg.radar, cfg.detection)
    want = np.asarray(extract_spatial_signatures(rds, det))
    got = np.asarray(detection_signatures(
        sig, det.range_bin, det.doppler_bin, cfg.radar, window=cfg.window,
        doppler_window=cfg.doppler_window))
    valid = np.asarray(det.valid)
    np.testing.assert_allclose(got[valid], want[valid], rtol=2e-4, atol=2e-4)


def test_fused_detections_match_fft_path():
    cfg = _cfg()
    sig = _signals(cfg, frames=1)[0]
    rds = range_doppler_spectrum(sig, cfg.radar, window=cfg.window,
                                 doppler_window=cfg.doppler_window)
    want = detect_peaks(rds, cfg.radar, cfg.detection)
    p_lin = rds_power(sig, cfg.radar, window=cfg.window,
                      doppler_window=cfg.doppler_window)
    got = detect_peaks_from_power(p_lin, cfg.radar, cfg.detection)
    assert np.array_equal(np.asarray(got.valid), np.asarray(want.valid))
    v = np.asarray(want.valid)
    assert np.array_equal(np.asarray(got.range_bin)[v],
                          np.asarray(want.range_bin)[v])
    assert np.array_equal(np.asarray(got.doppler_bin)[v],
                          np.asarray(want.doppler_bin)[v])
    np.testing.assert_allclose(np.asarray(got.range_m)[v],
                               np.asarray(want.range_m)[v], rtol=1e-5)


@pytest.mark.parametrize("driver", ["scan", "batched"])
@pytest.mark.slow
def test_fused_pipeline_end_to_end_matches_fft(driver):
    """Both sequence drivers, fused mode vs default: same trajectory."""
    import dataclasses

    from radar_slam_tpu.io.synthetic import SceneConfig, constant_motion_scene
    from radar_slam_tpu.pipeline import frame as pipe

    cfg = _cfg()
    batches, gt = constant_motion_scene(
        3, num_frames=10, dt=cfg.frame_dt, v_body=(8.0, 0.5), yaw_rate=0.05,
        scene=SceneConfig(num_points=64, max_scatterers=cfg.max_scatterers))
    cfg_fused = dataclasses.replace(cfg, fft_mode="fused")
    key = jax.random.key(0)
    run = (pipe.process_sequence if driver == "scan"
           else pipe.process_sequence_batched)
    out_fft = run(batches, key, cfg)
    out_fus = run(batches, key, cfg_fused)
    np.testing.assert_allclose(np.asarray(out_fus.pose),
                               np.asarray(out_fft.pose),
                               rtol=1e-3, atol=5e-3)
    # And the fused trajectory itself tracks ground truth.
    err = np.linalg.norm(np.asarray(out_fus.pose)[-1, :2]
                         - np.asarray(gt["poses"])[-1, :2])
    assert err < 0.5, err
