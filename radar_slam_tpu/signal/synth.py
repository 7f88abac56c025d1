"""Vectorized FMCW raw-signal synthesis from point-cloud scatterers.

Re-design of the reference simulator
(``scripts/simulate_raw.py:27-221``), whose hot triple Python loop
(scatterer x chirp x antenna, ``:171-209``) becomes one complex matmul: the
per-scatterer fast-time, slow-time and antenna phase
factors are rank-1 separable, so

    signals[a, c, s] = sum_sc amp_sc * E_ant[sc, a] * E_dopp[sc, c] * E_fast[sc, s]

is computed as ``(E_antdopp^T @ E_fast)`` with ``E_antdopp [Sc, A*C]``.

Signal model (same physics as the reference, with two deliberate fixes noted
in SURVEY.md section 7 decision 3):

- per-scatterer delay tau = 2R/c and amplitude sqrt(10^(rcs/10)) / (4 pi R^2)
  (simulate_raw.py:122-126);
- dechirped fast-time beat  exp(j 2 pi (-fc tau - k tau t + 0.5 k tau^2))
  (the reference's delayed-chirp x conj(ref) product, :196-209, evaluated in
  closed form);
- ULA phase  exp(j 2 pi d_a sin(az) / lambda)  (:142);
- **fix 1**: a real slow-time Doppler ramp exp(-j 4 pi vr c_idx PRI / lambda);
  the reference computes ``chirp_start_time`` (:192) but never applies it, so
  its moving targets have no Doppler ramp;
- **fix 2**: the time base is t_s = s / fs (exact ADC sampling); the reference
  uses ``linspace(0, T, S)`` (:165) whose step is T/(S-1).

The carrier term -2 pi fc tau = -4 pi R / lambda is retained: its
frame-to-frame change is exactly the temporal phase observable used by the
velocity solver (velocity_solver_improved.py:150).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from radar_slam_tpu.core.config import RadarConfig
from radar_slam_tpu.core.types import ScattererBatch


def expj_cycles(cycles: jax.Array) -> jax.Array:
    """exp(j 2 pi x) with range reduction to |phase| <= pi.

    float32 sin/cos lose accuracy for large arguments (the carrier term
    -4 pi R / lambda alone reaches ~1.6e5 rad, where one f32 ulp is ~0.016
    rad); reducing the *cycle count* mod 1 before the transcendental keeps
    the argument tiny.
    """
    x = cycles - jnp.round(cycles)
    return jnp.exp(1j * (2.0 * jnp.pi) * x.astype(jnp.float32))


def reference_chirp(cfg: RadarConfig) -> jax.Array:
    """Transmit chirp at ADC sample times: exp(j 2 pi (fc t + 0.5 k t^2)).

    (dechirp.py:74-83 / simulate_raw.py:88-100, with the exact t_s = s/fs
    time base.)"""
    t = jnp.arange(cfg.samples_per_chirp, dtype=jnp.float32) / cfg.sampling_rate
    # Drop the integer part of fc/fs cycles per sample: aliasing makes whole
    # cycles invisible at sample times, and float32 cannot carry them.
    fc_alias = cfg.fc - math.floor(cfg.fc / cfg.sampling_rate) * cfg.sampling_rate
    cycles = fc_alias * t + 0.5 * cfg.chirp_rate * t * t
    return expj_cycles(cycles).astype(jnp.complex64)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "output", "add_noise", "fidelity"))
def synthesize_frame(scatterers: ScattererBatch,
                     cfg: RadarConfig,
                     key: jax.Array,
                     output: str = "baseband",
                     add_noise: bool = True,
                     fidelity: str = "tpu") -> jax.Array:
    """Synthesize one frame of multi-channel FMCW signals.

    Args:
        scatterers: padded scatterer batch [S_max] with validity mask.
        cfg: radar configuration (static).
        key: PRNG key for the AWGN term.
        output: "baseband" returns the dechirped mixed signal (the pipeline
            default); "raw" re-modulates by the reference chirp so that
            ``dechirp(raw) == baseband`` exactly, exercising the dechirp op.
        add_noise: add complex AWGN of power ``cfg.noise_power``
            (simulate_raw.py:216-219).
        fidelity: "tpu" (default) applies the two physics fixes in the module
            docstring.  "reference" reproduces the reference simulator's
            quirks *as data* so the solver can be validated against a world
            generated by a DIFFERENT model than the one it inverts
            (anti-inverse-crime; SURVEY section 7 decision 3):

            - NO slow-time Doppler ramp: each scatterer instead carries the
              constant phase offset 4 pi vr fc / c radians across all chirps
              (``simulate_raw.py:127-129`` computes ``doppler_phase`` once;
              the per-chirp ``chirp_start_time`` at ``:190-192`` is never
              applied) -- moving targets land in the zero-Doppler bin;
            - ``linspace(0, T, S)`` time base whose sample step is T/(S-1),
              not 1/fs (``:165``), which skews every beat frequency by
              S/(S-1);
            - the echo window keeps samples with 0 <= t - tau <= T
              (``:194-200``; the upper gate never fires for tau >= 0 and is
              noted here for completeness).

            The reference's *processing* bug of dechirping the
            already-baseband simulator output a second time
            (``dechirp.py:139`` applied to ``simulate_raw.py:201-204``'s
            output) is internal to its own pipeline, not a property of the
            data, and is not reproduced.

    Returns:
        complex64 [num_antennas, num_chirps, samples_per_chirp].
    """
    A, C, S = cfg.total_antennas, cfg.num_chirps, cfg.samples_per_chirp
    e_ac, e_fast = synthesis_factors(scatterers, cfg, fidelity)

    # Contract scatterers: [Sc, A*C]^T @ [Sc, S] -> [A*C, S].
    signals = jnp.einsum("xp,xs->ps", e_ac, e_fast,
                         precision=jax.lax.Precision.HIGHEST).reshape(A, C, S)

    if output == "raw":
        signals = signals * reference_chirp(cfg)[None, None, :]
    elif output != "baseband":
        raise ValueError(f"Unknown output domain: {output}")

    if add_noise:
        kr, ki = jax.random.split(key)
        noise = jnp.sqrt(jnp.float32(cfg.noise_power)) * (
            jax.random.normal(kr, signals.shape, jnp.float32)
            + 1j * jax.random.normal(ki, signals.shape, jnp.float32))
        signals = signals + noise.astype(jnp.complex64)

    return signals


def fast_time_base(cfg: RadarConfig, fidelity: str = "tpu") -> jax.Array:
    """ADC fast-time sample instants [S] for the given synthesis fidelity:
    ``linspace(0, T, S)`` ("reference", simulate_raw.py:165) or the exact
    ``s / fs`` base ("tpu"; module docstring fix 2)."""
    S = cfg.samples_per_chirp
    if fidelity == "reference":
        return (jnp.arange(S, dtype=jnp.float32)
                * (cfg.chirp_duration / max(S - 1, 1)))
    if fidelity == "tpu":
        return jnp.arange(S, dtype=jnp.float32) / cfg.sampling_rate
    raise ValueError(f"Unknown synthesis fidelity: {fidelity}")


def synthesis_factors(scatterers: ScattererBatch, cfg: RadarConfig,
                      fidelity: str = "tpu"):
    """The rank-1 synthesis factors (module docstring):

        signals[a*C + c, s] = (e_ac^T @ e_fast)[a*C + c, s]

    Returns (e_ac [Sc, A*C], e_fast [Sc, S]) complex64 -- amplitude x
    antenna x Doppler factors and echo-gated fast-time beat factors."""
    A, C, S = cfg.total_antennas, cfg.num_chirps, cfg.samples_per_chirp
    lam = cfg.lambda_c
    k_rate = cfg.chirp_rate

    r = scatterers.range_m.astype(jnp.float32)
    az = scatterers.azimuth_rad.astype(jnp.float32)
    rcs = scatterers.rcs_db.astype(jnp.float32)
    vr = scatterers.vr.astype(jnp.float32)
    el = (scatterers.elevation_rad.astype(jnp.float32)
          if scatterers.elevation_rad is not None else jnp.zeros_like(az))

    ok = (scatterers.valid
          & (r > 0.0)
          & jnp.isfinite(r) & jnp.isfinite(az)
          & jnp.isfinite(rcs) & jnp.isfinite(vr))          # simulate_raw.py:181
    r_safe = jnp.where(ok, r, 1.0)

    amp = jnp.sqrt(10.0 ** (rcs / 10.0)) / (4.0 * jnp.pi * r_safe ** 2)
    amp = jnp.where(ok, amp, 0.0)                          # [Sc]

    tau = 2.0 * r_safe / cfg.c                             # [Sc]

    # All phases are accumulated in CYCLES and reduced mod 1 before exp
    # (see expj_cycles): float32 trig is inaccurate for large arguments.
    # Fast-time factor: cycles = -fc tau + 0.5 k tau^2 - k tau t, with
    # samples before the echo arrival (t < tau) zeroed (simulate_raw.py:197).
    t = fast_time_base(cfg, fidelity)                                   # [S]
    # carrier cycles fc*tau = 2R/lambda, computed as 2R/lambda directly to
    # avoid the 7-digit fc*tau product losing the fractional part.
    carrier_cycles = 2.0 * r_safe / lam                                  # [Sc]
    const_cycles = -(carrier_cycles - jnp.round(carrier_cycles)) \
        + 0.5 * k_rate * tau * tau
    beat_cycles = (k_rate * tau)[:, None] * t[None, :]                   # [Sc,S]
    cycles_fast = const_cycles[:, None] - beat_cycles
    arrived = (t[None, :] >= tau[:, None]).astype(jnp.float32)
    if fidelity == "reference":
        # Upper echo gate t - tau <= T (simulate_raw.py:196); a no-op for
        # tau >= 0 under the linspace base but kept for strict faithfulness.
        arrived = arrived * (t[None, :] - tau[:, None]
                             <= cfg.chirp_duration).astype(jnp.float32)
    e_fast = expj_cycles(cycles_fast) * arrived                          # [Sc,S]

    c_idx = jnp.arange(C, dtype=jnp.float32)
    if fidelity == "reference":
        # Constant Doppler phase offset 4 pi vr fc / c rad = 2 vr / lambda
        # cycles on every chirp (simulate_raw.py:127-129 via :142); no ramp.
        cycles_dopp = jnp.broadcast_to((2.0 * vr / lam)[:, None], vr.shape + (C,))
    else:
        # Slow-time Doppler ramp: range rate vr -> cycles
        # -2 vr (c_idx PRI)/lambda.
        cycles_dopp = (-2.0 / lam) * vr[:, None] * (c_idx[None, :] * cfg.pri)
    e_dopp = expj_cycles(cycles_dopp)                                    # [Sc,C]

    # Antenna factor (simulate_raw.py:142), generalized to a URA flattened
    # row-major [el, az] (geometry.ura_steering_vector layout): element
    # (m, n) sees cycles (n d_az u_y + m d_el u_z) / lambda with
    # u = [cos el cos az, cos el sin az, sin el].  ULA (num_antennas_el = 1)
    # reduces to d_a sin(az) / lambda exactly at el = 0.
    u_y = jnp.cos(el) * jnp.sin(az)                                      # [Sc]
    u_z = jnp.sin(el)
    pos_az = jnp.arange(cfg.num_antennas, dtype=jnp.float32) * cfg.spacing
    pos_el = jnp.arange(cfg.num_antennas_el, dtype=jnp.float32) * cfg.spacing_el
    cycles_ant = (1.0 / lam) * (
        u_y[:, None, None] * pos_az[None, None, :]
        + u_z[:, None, None] * pos_el[None, :, None])        # [Sc, Ael, Aaz]
    cycles_ant = cycles_ant.reshape(-1, A)
    e_ant = expj_cycles(cycles_ant) * amp[:, None]                       # [Sc,A]

    e_ac = (e_ant[:, :, None] * e_dopp[:, None, :]).reshape(-1, A * C)
    return e_ac.astype(jnp.complex64), e_fast.astype(jnp.complex64)


def synthesize_frames_batch(scatterers: ScattererBatch, cfg: RadarConfig,
                            key: jax.Array, output: str = "baseband",
                            add_noise: bool = True,
                            fidelity: str = "tpu") -> jax.Array:
    """vmap over a leading frame axis: scatterer arrays [F, S_max] ->
    signals [F, A, C, S]."""
    nframes = scatterers.range_m.shape[0]
    keys = jax.random.split(key, nframes)
    return jax.vmap(
        lambda sc, k: synthesize_frame(sc, cfg, k, output, add_noise, fidelity)
    )(scatterers, keys)
