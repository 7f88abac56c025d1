"""Range-Doppler Spectrum generation: fused dechirp + window + DC + 2-D FFT.

Re-design of ``SignalPreprocessor.generate_range_doppler_spectrum``
(``src/radar_signal/dechirp.py:168-213``).  The reference loops antenna x
chirp in Python, applying dechirp, window and DC removal per chirp, then runs
``np.fft.fft2`` + double fftshift.  Here the whole chain is one traced XLA
program over the [A, C, S] cube:

- dechirp (multiply by conj reference chirp, dechirp.py:139) and the window
  are folded into a single precomputed complex vector;
- DC removal is a mean-subtract along fast time (dechirp.py:120);
- the range transform uses the e^{+j} DFT kernel (``S * ifft``) so that a beat
  tone at -k tau (the rx * conj(tx) convention) lands at bin k tau / delta_f,
  i.e. range = bin * c/(2B) directly -- no fftshift of the range axis.  The
  reference fftshifts BOTH axes (dechirp.py:211) and then labels range bins
  with linspace(0, ...) (dechirp.py:241), which mislocates ranges; see
  SURVEY.md section 2 row 3.
- the Doppler transform is a standard FFT over chirps + fftshift, with the
  axis labelled by the PRF (the reference labels it with the ADC rate,
  dechirp.py:242).

Output layout matches the reference: [num_antennas, range_bins, doppler_bins].
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from radar_slam_tpu.core.config import RadarConfig
from radar_slam_tpu.ops.windows import get_window
from radar_slam_tpu.signal.synth import reference_chirp


def range_axis_m(cfg: RadarConfig, range_bins: Optional[int] = None) -> jax.Array:
    """Range value of each bin [m]: bin * c/(2B) * (fs T / S)."""
    n = range_bins or cfg.samples_per_chirp
    bin_hz = cfg.sampling_rate / n
    metres_per_hz = cfg.c / (2.0 * cfg.chirp_rate)
    return jnp.arange(n, dtype=jnp.float32) * (bin_hz * metres_per_hz)


def doppler_axis_hz(cfg: RadarConfig, doppler_bins: Optional[int] = None) -> jax.Array:
    """Doppler frequency of each (fftshifted) bin [Hz], spanning +/- PRF/2."""
    n = doppler_bins or cfg.num_chirps
    return jnp.fft.fftshift(jnp.fft.fftfreq(n, d=cfg.pri)).astype(jnp.float32)


def doppler_to_radial_velocity(doppler_hz: jax.Array, cfg: RadarConfig) -> jax.Array:
    """Radial velocity (range rate) implied by a Doppler frequency.

    With the synthesis convention phase = -4 pi R(t) / lambda, a range rate vr
    produces f_d = -2 vr / lambda, so vr = -f_d lambda / 2."""
    return -doppler_hz * jnp.float32(cfg.lambda_c) / 2.0


def _complex_matmul(x: jax.Array, w: jax.Array, precision) -> jax.Array:
    """x [..., N] @ w [N, M] as four real f32 matmuls.

    Splitting re/im explicitly (instead of relying on XLA's complex-dot
    decomposition) guarantees f32 accumulation via
    ``preferred_element_type``."""
    xr, xi = jnp.real(x), jnp.imag(x)
    wr, wi = jnp.real(w), jnp.imag(w)
    dot = functools.partial(jax.lax.dot_general,
                            dimension_numbers=(((x.ndim - 1,), (0,)), ((), ())),
                            precision=precision,
                            preferred_element_type=jnp.float32)
    return jax.lax.complex(dot(xr, wr) - dot(xi, wi),
                           dot(xr, wi) + dot(xi, wr))


def range_dft_matrix(S: int, mix: jax.Array, dc_removal: bool) -> jax.Array:
    """[S, S] complex matrix folding the whole range chain into one matmul:
    diag(mix) @ (I - J/S) @ W, with W[s, r] = e^{+2j pi s r / S} (the e^{+j}
    kernel = S * ifft, see range_doppler_spectrum)."""
    s = jnp.arange(S, dtype=jnp.float32)
    w_rng = jnp.exp(1j * (2.0 * jnp.pi / S) * jnp.outer(s, s)
                    ).astype(jnp.complex64)
    if dc_removal:
        # (I - J/S) @ W: subtract the column means (each column of W summed
        # over rows is S*delta(r==0), so only the r=0 column changes -- but
        # keep the general projector so any mix/window composes correctly).
        w_rng = w_rng - jnp.mean(w_rng, axis=0, keepdims=True)
    return mix[:, None] * w_rng


def doppler_dft_matrix(C: int, doppler_window: Optional[str]) -> jax.Array:
    """[C, C] complex matrix folding the Doppler chain: optional slow-time
    window on the rows, e^{-j} DFT, fftshift baked into the column order."""
    c = jnp.arange(C, dtype=jnp.float32)
    k_shifted = jnp.roll(jnp.arange(C, dtype=jnp.float32), C // 2)
    w_dop = jnp.exp(-1j * (2.0 * jnp.pi / C) * jnp.outer(c, k_shifted)
                    ).astype(jnp.complex64)
    if doppler_window is not None:
        wd = get_window(doppler_window, C).astype(jnp.float32)
        w_dop = wd[:, None] * w_dop
    return w_dop


def _rds_matmul(signals: jax.Array, mix: jax.Array, dc_removal: bool,
                doppler_window: Optional[str], precision) -> jax.Array:
    """RDS via two DFT matmuls (see range_doppler_spectrum).

    The range chain (dechirp * window, DC projector, e^{+j} DFT) collapses
    into ONE [S, S] complex matrix applied to fast time, and the Doppler
    chain (slow-time window, e^{-j} DFT, fftshift) into one [C, C] matrix
    applied to slow time."""
    S = signals.shape[-1]
    C = signals.shape[-2]
    w_rng = range_dft_matrix(S, mix, dc_removal)
    w_dop = doppler_dft_matrix(C, doppler_window)
    rng = _complex_matmul(signals, w_rng, precision)       # [..., A, C, S_r]
    rds = _complex_matmul(jnp.swapaxes(rng, -1, -2), w_dop, precision)
    return rds.astype(jnp.complex64)


def _mix_vector(cfg: RadarConfig, window: str, input_domain: str,
                S: int) -> jax.Array:
    """Dechirp x fast-time-window vector [S] (complex64)."""
    w = get_window(window, S).astype(jnp.float32)
    if input_domain == "raw":
        return (jnp.conj(reference_chirp(cfg)) * w).astype(jnp.complex64)
    if input_domain == "baseband":
        return w.astype(jnp.complex64)
    raise ValueError(f"Unknown input domain: {input_domain}")


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "window", "dc_removal", "input_domain",
                     "chirp_subset", "doppler_window"))
def rds_power(signals: jax.Array,
              cfg: RadarConfig,
              window: str = "hann",
              dc_removal: bool = True,
              input_domain: str = "baseband",
              chirp_subset: Optional[Tuple[int, int]] = None,
              doppler_window: Optional[str] = None) -> jax.Array:
    """Non-coherent power map ``mean_a |rds|^2`` (the fused detection path;
    VERDICT round-2 item 1): only the [R, D] map leaves the call, and
    detection signatures are recomputed for the detected cells alone
    (:func:`detection_signatures`) instead of gathered from a kept cube.

    Args/conventions match :func:`range_doppler_spectrum`; returns float32
    [..., range_bins, doppler_bins].
    """
    rds = range_doppler_spectrum(signals, cfg, window=window,
                                 dc_removal=dc_removal,
                                 input_domain=input_domain,
                                 chirp_subset=chirp_subset,
                                 doppler_window=doppler_window)
    return jnp.mean(jnp.abs(rds) ** 2, axis=-3)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "window", "dc_removal", "input_domain",
                     "chirp_subset", "doppler_window"))
def detection_signatures(signals: jax.Array,
                         range_bin: jax.Array,
                         doppler_bin: jax.Array,
                         cfg: RadarConfig,
                         window: str = "hann",
                         dc_removal: bool = True,
                         input_domain: str = "baseband",
                         chirp_subset: Optional[Tuple[int, int]] = None,
                         doppler_window: Optional[str] = None) -> jax.Array:
    """Unit-power spatial signatures [K, A] for K detected RDS cells,
    recomputed directly from the ADC cube at f32 (HIGHEST) precision.

    ``signature_k = rds[:, r_k, d_k] / ||.||`` (angle_estimation.py:83-90)
    exactly as :func:`~radar_slam_tpu.signal.detect.
    extract_spatial_signatures` gathers it from a full cube -- but here only
    the K needed DFT coefficients are evaluated (O(A C S K) vs O(A C S S)),
    so the fused detection path never builds the cube.

    Args:
        signals: complex64 [A, C, S] one frame's cube.
        range_bin / doppler_bin: int32 [K] detected cells.
    """
    if chirp_subset is not None:
        signals = signals[..., chirp_subset[0]:chirp_subset[1], :]
    A, C, S = signals.shape
    mix = _mix_vector(cfg, window, input_domain, S)

    # Column r of range_dft_matrix: mix * (e^{+2j pi s r / S} - [r == 0])
    # (the DC projector only perturbs the r = 0 column; see
    # range_dft_matrix).
    s = jnp.arange(S, dtype=jnp.float32)
    rb = range_bin.astype(jnp.float32)
    w_rng = jnp.exp(1j * (2.0 * jnp.pi / S) * jnp.outer(s, rb)
                    ).astype(jnp.complex64)                        # [S, K]
    if dc_removal:
        w_rng = w_rng - (range_bin[None, :] == 0).astype(jnp.complex64)
    w_rng = mix[:, None] * w_rng

    # Column d of doppler_dft_matrix: window * e^{-2j pi c f(d) / C} with
    # the fftshift column order f(d) = (d - C//2) mod C.
    c = jnp.arange(C, dtype=jnp.float32)
    f = jnp.mod(doppler_bin - C // 2, C).astype(jnp.float32)
    w_dop = jnp.exp(-1j * (2.0 * jnp.pi / C) * jnp.outer(c, f)
                    ).astype(jnp.complex64)                        # [C, K]
    if doppler_window is not None:
        wd = get_window(doppler_window, C).astype(jnp.float32)
        w_dop = wd[:, None] * w_dop

    g = jnp.einsum("acs,sk->ack", signals, w_rng,
                   precision=jax.lax.Precision.HIGHEST)            # [A, C, K]
    sig = jnp.einsum("ack,ck->ka", g, w_dop,
                     precision=jax.lax.Precision.HIGHEST)          # [K, A]
    power = jnp.sum(jnp.abs(sig) ** 2, axis=-1, keepdims=True)
    sig = jnp.where(power > 0, sig / jnp.sqrt(jnp.maximum(power, 1e-30)),
                    sig)
    return sig.astype(jnp.complex64)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "window", "dc_removal", "input_domain",
                     "chirp_subset", "doppler_window", "fft_mode",
                     "dft_precision"))
def range_doppler_spectrum(signals: jax.Array,
                           cfg: RadarConfig,
                           window: str = "hann",
                           dc_removal: bool = True,
                           input_domain: str = "baseband",
                           chirp_subset: Optional[Tuple[int, int]] = None,
                           doppler_window: Optional[str] = None,
                           fft_mode: str = "fft",
                           dft_precision: str = "highest") -> jax.Array:
    """Compute the RDS cube.

    Args:
        signals: complex64 [A, C, S] (or [..., A, C, S]) frame signals.
        cfg: radar config (static).
        window: fast-time window ('hann'|'hamming'|'blackman'|'rect'),
            dechirp.py:99-106.
        dc_removal: subtract per-chirp fast-time mean (dechirp.py:120).
        input_domain: "baseband" if signals are already dechirped (the
            synthesizer default), "raw" to apply conj(reference chirp) first.
            NOTE: the reference simulator emits dechirped signals yet its
            preprocessor dechirps again (dechirp.py:202 applied to
            simulate_raw.py output) -- a double-mix quirk we do not reproduce.
        chirp_subset: optional (start, end) static slow-time slice
            (dechirp.py:183-187).
        doppler_window: optional slow-time window (reference has none).
        fft_mode: "fft" (XLA FFT) or "matmul" (both DFTs as matmuls with
            dechirp/window/DC folded into the DFT matrices).
        dft_precision: matmul precision for fft_mode="matmul"
            ("default"|"high"|"highest").

    Returns:
        complex64 [..., A, range_bins, doppler_bins]; Doppler axis fftshifted,
        range axis NOT shifted (bin r -> range r * c/(2B)).
    """
    if chirp_subset is not None:
        start, end = chirp_subset
        signals = signals[..., start:end, :]

    S = signals.shape[-1]
    mix = _mix_vector(cfg, window, input_domain, S)

    if fft_mode == "matmul":
        prec = {"default": jax.lax.Precision.DEFAULT,
                "high": jax.lax.Precision.HIGH,
                "highest": jax.lax.Precision.HIGHEST}[dft_precision]
        return _rds_matmul(signals, mix, dc_removal, doppler_window, prec)
    if fft_mode != "fft":
        raise ValueError(f"Unknown fft_mode: {fft_mode}")

    x = signals * mix                                   # fused dechirp+window
    if dc_removal:
        x = x - jnp.mean(x, axis=-1, keepdims=True)

    C = x.shape[-2]
    wd = (get_window(doppler_window, C).astype(jnp.float32)
          if doppler_window is not None else jnp.ones(C, jnp.float32))
    if C % 2 == 0:
        # Fold the Doppler fftshift into the slow-time window: multiplying
        # chirp c by (-1)^c shifts the spectrum by C/2 bins (exactly
        # fftshift for even C), saving one whole-cube roll pass.
        wd = wd * jnp.where(jnp.arange(C) % 2 == 0, 1.0, -1.0)
    x = x * wd[..., :, None].astype(jnp.complex64)

    # Range transform: e^{+j} kernel => S * ifft along fast time (last axis).
    rng = jnp.fft.ifft(x, axis=-1) * jnp.complex64(S)   # [..., A, C, S_r]
    # Doppler transform over chirps: transpose first so the FFT also runs on
    # the last axis (XLA's FFT on a minor axis pays an internal transpose),
    # which directly yields the output layout [..., A, range, doppler]
    # (dechirp.py:193 layout).
    rds = jnp.fft.fft(jnp.swapaxes(rng, -1, -2), axis=-1)
    if C % 2 != 0:
        rds = jnp.fft.fftshift(rds, axes=-1)
    return rds.astype(jnp.complex64)
