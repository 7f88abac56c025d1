"""The XLA front end against independent NumPy references: windows,
dechirp/window/DC + range-Doppler transform, the power map, CA-CFAR and
detection signatures at the map's edge cells."""

import jax
import numpy as np
import pytest
from numpy.lib.stride_tricks import sliding_window_view

from radar_slam_tpu.core.config import DetectionConfig, RadarConfig
from radar_slam_tpu.ops.windows import get_window
from radar_slam_tpu.signal import detect
from radar_slam_tpu.signal.rds import (detection_signatures,
                                       range_doppler_spectrum, rds_power)

NP_WINDOWS = {"hann": np.hanning, "hamming": np.hamming,
              "blackman": np.blackman, "rect": np.ones}


def _np_window(name, n):
    return NP_WINDOWS["rect" if name is None else name](n)


def _radar(S, C):
    """RadarConfig with S fast-time samples (10 MHz ADC) and C chirps."""
    return RadarConfig(num_chirps=C, chirp_duration=S * 1e-7)


def _np_rds(sig, cfg, window="hann", dc=True, doppler_window=None,
            raw=False):
    """Explicit float64 DFTs: dechirp x window, per-chirp DC removal,
    e^{+j} range kernel (no shift), windowed e^{-j} Doppler + fftshift."""
    A, C, S = sig.shape
    mix = _np_window(window, S).astype(np.complex128)
    if raw:
        t = np.arange(S) / cfg.sampling_rate
        fc_alias = cfg.fc - np.floor(cfg.fc / cfg.sampling_rate) \
            * cfg.sampling_rate
        cyc = fc_alias * t + 0.5 * cfg.chirp_rate * t * t
        mix = mix * np.exp(-2j * np.pi * (cyc - np.round(cyc)))
    x = sig.astype(np.complex128) * mix
    if dc:
        x = x - x.mean(axis=-1, keepdims=True)
    x = x * _np_window(doppler_window, C)[:, None]
    s, c = np.arange(S), np.arange(C)
    rng = x @ np.exp(2j * np.pi * np.outer(s, s) / S)          # [A, C, R]
    dop = np.einsum("acr,ck->ark", rng,
                    np.exp(-2j * np.pi * np.outer(c, c) / C))   # [A, R, D]
    return np.fft.fftshift(dop, axes=-1)


def _random_cube(A, C, S, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((A, C, S))
            + 1j * rng.standard_normal((A, C, S))).astype(np.complex64)


@pytest.mark.parametrize("n", [16, 17])
@pytest.mark.parametrize("name", ["hann", "hamming", "blackman", "rect"])
def test_window_matches_numpy(name, n):
    np.testing.assert_allclose(np.asarray(get_window(name, n)),
                               _np_window(name, n), atol=1e-6)


@pytest.mark.parametrize("C", [8, 9])
@pytest.mark.parametrize("S", [64, 63])
@pytest.mark.parametrize("dc", [True, False])
def test_dechirp_window_dc_matches_numpy(dc, S, C):
    """Raw-domain input: the XLA dechirp (conj reference chirp) x window,
    DC removal and both transforms, for even and odd fast-time lengths
    (and odd chirp counts, where the Doppler fftshift is not folded into
    the window)."""
    cfg = _radar(S, C)
    sig = _random_cube(3, C, S, seed=S + C)
    got = np.asarray(range_doppler_spectrum(
        sig, cfg, window="hann", dc_removal=dc, input_domain="raw",
        doppler_window="hamming"))
    want = _np_rds(sig, cfg, "hann", dc, "hamming", raw=True)
    assert got.shape == want.shape == (3, S, C)
    # The reference chirp's phase is evaluated in f32: ~3,200 cycles at
    # S=64 round to ~2e-4 cycles, so the dechirped cube carries ~1e-3
    # relative error against this float64 reference.
    assert np.abs(got - want).max() / np.abs(want).max() < 3e-3


@pytest.mark.parametrize("C", [8, 15, 32])
@pytest.mark.parametrize("doppler_window", [None, "hann"])
def test_rds_power_matches_numpy_dft(doppler_window, C):
    """rds_power = mean over antennas of |explicit 2-D DFT|^2."""
    S = 16
    cfg = _radar(S, C)
    sig = _random_cube(4, C, S, seed=C)
    got = np.asarray(rds_power(sig, cfg, window="hann",
                               doppler_window=doppler_window))
    want = np.mean(np.abs(_np_rds(sig, cfg, "hann", True,
                                  doppler_window)) ** 2, axis=0)
    assert got.shape == (S, C)
    assert np.abs(got - want).max() / want.max() < 1e-5


def _np_ca_cfar(p_lin, det):
    """NumPy CA-CFAR mask: zero-padded box sums normalized by the in-map
    cell counts (the training box minus the guard box), 3x3 local maxima,
    threshold max(noise + offset, floor)."""
    p_lin = p_lin.astype(np.float64)
    power_db = 10 * np.log10(p_lin)

    def box_mean(x, size):
        pad = size // 2
        sums = sliding_window_view(np.pad(x, pad), (size, size)).sum(
            axis=(-1, -2))
        counts = sliding_window_view(np.pad(np.ones_like(x), pad),
                                     (size, size)).sum(axis=(-1, -2))
        return sums / counts

    n = det.neighborhood
    local_max = sliding_window_view(
        np.pad(power_db, n // 2, constant_values=-np.inf), (n, n)).max(
            axis=(-1, -2))
    if det.cfar_train_cells > 0:
        train = 2 * det.cfar_train_cells + 2 * det.guard_cells + 1
        guard = 2 * det.guard_cells + 1
        noise = box_mean(p_lin, train)
        if det.guard_cells > 0:
            noise = ((noise * train ** 2 - box_mean(p_lin, guard) * guard ** 2)
                     / (train ** 2 - guard ** 2))
        thresh = np.maximum(10 * np.log10(np.maximum(noise, 1e-12))
                            + det.cfar_offset_db, det.threshold_db)
    else:
        thresh = np.full_like(power_db, det.threshold_db)
    return power_db, thresh, (local_max == power_db) & (power_db > thresh)


@pytest.mark.parametrize("train,guard", [(0, 0), (2, 0), (4, 0), (2, 1),
                                         (4, 2), (8, 2)])
def test_ca_cfar_matches_numpy_box_sum(train, guard):
    rng = np.random.default_rng(train * 10 + guard)
    R, D = 64, 32
    p = rng.exponential(1e-4, (R, D))
    for r, d, a in [(10, 5, 1e-1), (11, 20, 3e-3), (40, 0, 1e-2),
                    (63, 31, 5e-2), (30, 16, 2e-4)]:
        p[r, d] += a
    p = p.astype(np.float32)
    det = DetectionConfig(threshold_db=-60.0, cfar_train_cells=train,
                          guard_cells=guard, cfar_offset_db=10.0)
    power_db, thresh, want = _np_ca_cfar(p, det)
    got_db, got = map(np.asarray, detect._threshold_power(
        jax.numpy.asarray(p), det))
    np.testing.assert_allclose(got_db, power_db, atol=1e-4)
    # Cells within 1e-3 dB of the threshold are f32-vs-f64 coin flips.
    decided = np.abs(power_db - thresh) > 1e-3
    assert np.array_equal(got[decided], want[decided])
    assert want.sum() >= 3


@pytest.mark.parametrize("cell", ["origin", "first_range_last_doppler",
                                  "last_range_first_doppler", "far_corner",
                                  "centre"])
def test_detection_signatures_at_edge_cells(cell):
    """Signatures evaluated per cell (range bin 0, the last range bin,
    both Doppler edges) equal the normalized explicit-DFT cube column.
    DC removal makes range bin 0 identically zero, and its signature is
    the zero vector rather than normalized rounding noise."""
    A, C, S = 4, 8, 16
    cfg = _radar(S, C)
    sig = _random_cube(A, C, S, seed=len(cell))
    r, d = {"origin": (0, 0), "first_range_last_doppler": (0, C - 1),
            "last_range_first_doppler": (S - 1, 0),
            "far_corner": (S - 1, C - 1), "centre": (S // 2, C // 2)}[cell]
    got = np.asarray(detection_signatures(
        sig, jax.numpy.array([r, 1], jax.numpy.int32),
        jax.numpy.array([d, 1], jax.numpy.int32), cfg, window="hann",
        doppler_window="hann"))[0]
    col = _np_rds(sig, cfg, "hann", True, "hann")[:, r, d]
    want = col / np.linalg.norm(col) if r > 0 else np.zeros_like(col)
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("driver", ["batched", "chunked_jacobi",
                                    "chunked_exact"])
def test_drivers_agree_at_main_config(driver):
    """At complete_analysis_config() on a 16-frame corridor the batched and
    chunked drivers agree with the sequential scan driver to 5 mm over the
    12.8 m path: the same detections and solve outcomes, with poses apart
    only by the windowed smoother (exact only while live tracks fit the
    main config's 64 slots), the 0.001x-weight temporal prior (dropped by
    the batched driver, relaxed by the Jacobi sweeps) and float
    reassociation (~1 mm measured for the exact chunked chain)."""
    from radar_slam_tpu.core.config import complete_analysis_config
    from radar_slam_tpu.io.synthetic import (SceneConfig,
                                             constant_motion_scene)
    from radar_slam_tpu.pipeline import frame as pipe

    cfg = complete_analysis_config()
    batches, _ = constant_motion_scene(
        7, num_frames=16, dt=cfg.frame_dt, v_body=(8.0, 0.5),
        yaw_rate=0.05,
        scene=SceneConfig(num_points=96, max_scatterers=cfg.max_scatterers))
    key = jax.random.key(0)
    scan = pipe.process_sequence(batches, key, cfg)
    if driver == "batched":
        out = pipe.process_sequence_batched(batches, key, cfg)
    else:
        out = pipe.process_sequence_chunked(batches, key, cfg, window=8,
                                            prior=driver.split("_")[1])
    np.testing.assert_array_equal(np.asarray(out.motion.success),
                                  np.asarray(scan.motion.success))
    np.testing.assert_array_equal(np.asarray(out.num_detections),
                                  np.asarray(scan.num_detections))
    np.testing.assert_allclose(np.asarray(out.pose), np.asarray(scan.pose),
                               atol=5e-3)
