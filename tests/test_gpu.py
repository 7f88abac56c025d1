"""Numerics on the card: the XLA front end and estimators at real widths
on an NVIDIA GPU against NumPy and the host CPU.  Marked ``gpu``; they skip
where JAX finds no GPU and run on the card through ``chip_smoke.py``."""

import jax
import numpy as np
import pytest

from radar_slam_tpu.core.config import complete_analysis_config

pytestmark = pytest.mark.gpu


def _on(dev, fn, *args):
    return jax.device_get(jax.jit(fn)(*jax.device_put(args, dev)))


def test_rds_power_on_gpu_matches_numpy_dft(gpu_device):
    """The main config's power map ([8, 32, 400] cube) from cuFFT against
    explicit float64 DFTs."""
    from radar_slam_tpu.signal.rds import rds_power

    cfg = complete_analysis_config()
    rng = np.random.default_rng(0)
    sig = (rng.standard_normal((8, 32, 400))
           + 1j * rng.standard_normal((8, 32, 400))).astype(np.complex64)
    got = _on(gpu_device, lambda x: rds_power(
        x, cfg.radar, window=cfg.window,
        doppler_window=cfg.doppler_window), sig)
    S, C = 400, 32
    x = sig.astype(np.complex128) * np.hanning(S)
    x = (x - x.mean(-1, keepdims=True)) * np.hanning(C)[:, None]
    s, c = np.arange(S), np.arange(C)
    rd = np.einsum("acs,sr,ck->ark", x,
                   np.exp(2j * np.pi * np.outer(s, s) / S),
                   np.exp(-2j * np.pi * np.outer(c, c) / C))
    want = np.mean(np.abs(np.fft.fftshift(rd, axes=-1)) ** 2, axis=0)
    assert np.abs(got - want).max() / want.max() < 1e-5


@pytest.mark.parametrize("method", ["beamforming", "music", "esprit"])
def test_aoa_on_gpu_matches_cpu(gpu_device, method):
    """Angles of 512 single-target signatures agree with the CPU to 0.05
    deg (a quarter of the RMSE gate at 50 m), whatever precision the
    card's f32 dots run at."""
    import dataclasses

    from radar_slam_tpu.aoa.estimators import estimate_angles_2d
    from radar_slam_tpu.core.geometry import steering_vector

    cfg = complete_analysis_config()
    aoa = dataclasses.replace(cfg.aoa, method=method)
    rng = np.random.default_rng(1)
    az = rng.uniform(-1.2, 1.2, 512)
    sig = np.asarray(jax.vmap(lambda a: steering_vector(
        a, cfg.radar.num_antennas, cfg.radar.spacing,
        cfg.radar.lambda_c))(az))
    sig = sig + 0.05 * (rng.standard_normal(sig.shape)
                        + 1j * rng.standard_normal(sig.shape))
    sig = (sig / np.linalg.norm(sig, axis=-1, keepdims=True)).astype(
        np.complex64)

    def angles(s):
        return estimate_angles_2d(s, cfg.radar, aoa, method=method)[0]

    got = _on(gpu_device, angles, sig)
    want = _on(jax.devices("cpu")[0], angles, sig)
    assert np.abs(got - want).max() < 0.05


def test_batched_driver_on_gpu_matches_cpu(gpu_device):
    """The main path end to end (16-frame corridor, threefry noise, whose
    bits are the same on every backend): GPU and CPU poses within 1 cm."""
    from radar_slam_tpu.io.synthetic import SceneConfig, constant_motion_scene
    from radar_slam_tpu.pipeline import frame as pipe

    cfg = complete_analysis_config()
    batches, _ = constant_motion_scene(
        7, num_frames=16, dt=cfg.frame_dt, v_body=(8.0, 0.5),
        yaw_rate=0.05,
        scene=SceneConfig(num_points=96, max_scatterers=cfg.max_scatterers))
    batches = jax.device_get(batches)
    kd = np.asarray(jax.device_get(jax.random.key_data(
        jax.random.key(0, impl="threefry2x32"))))

    def run(b, k):
        return pipe.process_sequence_batched(
            b, jax.random.wrap_key_data(k, impl="threefry2x32"), cfg).pose

    got = _on(gpu_device, run, batches, kd)
    want = _on(jax.devices("cpu")[0], run, batches, kd)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < 1e-2
