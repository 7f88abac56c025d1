"""Closed-form 6-DoF radar ego-motion velocity solver.

The reference spends its compute budget on two nested
``scipy.differential_evolution`` searches plus multi-restart thread pools
(``src/velocity_solver/velocity_solver.py:178-269``,
``src/algorithms/advanced_velocity_optimization.py:260-490``).  The model it
optimizes is *linear* in the 6-vector x = (v, w)
(``velocity_solver.py:102-111``):

    phi_i   = (4 pi dt / lambda) * d_i . (v + w x r_i)
            = (4 pi dt / lambda) * [d_i, r_i x d_i] . x

so the whole apparatus collapses into batched regularized least squares
(SURVEY.md section 7, decision 1).  Two observables are supported:

- **doppler**: per-target radial velocities from the Doppler bin,
  vr_i = -[d_i, r_i x d_i] . x  -- coarse (one velocity-resolution quantum)
  but unambiguous.  The reference never uses this observable.
- **phase**: the temporal phase differences the reference optimizes
  (``velocity_solver_improved.py:150``).  With dt = 0.1 s and lambda = 3.9 mm
  the phase wraps every ~2 cm/s of radial velocity, so the problem is a
  lattice of local minima: we run Gauss-Newton on the *wrapped* residual
  (the ``arctan2(sin, cos)`` trick, ``velocity_solver_improved.py:255``)
  from an informed initial guess, which is exactly the local refinement the
  reference's regularized DE performs around its smart init (``:268-323``).
- **fused** (default): doppler solve seeds the phase refinement.

The reference's two-step structure (v-only then full 6-DoF,
``velocity_solver.py:206-263``) and its regularizers (ridge 0.01,
``velocity_solver_improved.py:261-263``; 10x z-velocity penalty and temporal
smoothness, ``advanced_velocity_optimization.py:195-219``) are kept as prior
terms in the normal equations.  Robustness to association outliers comes from
Huber IRLS weights instead of restart voting.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from radar_slam_tpu.core.config import VelocityConfig
from radar_slam_tpu.core.geometry import wrap_angle
from radar_slam_tpu.core.types import Associations, MotionEstimate

# Every matmul of the solve runs in full f32.  The phase rows carry
# 4 pi dt / lambda ~ 320 rad per m/s, so a TF32 product (~1e-3 relative,
# what DEFAULT gives an f32 dot on an NVIDIA GPU) moves the wrapped phase
# residual by radians; on the H100 that put the solve 8.5 mm/s off the
# CPU's where full f32 holds it to the 1 mm/s tolerance.
_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def design_matrix(assoc: Associations) -> jax.Array:
    """Rows [K, 6] = [d_i, r_i x d_i] (the radial-rate Jacobian).

    The range rate of a static target at vehicle-frame position r seen from a
    sensor at s with LOS d = (r - s)/|r - s| is -d.(v + w x r); note
    r x d == s x d (they differ by |r-s| d x d = 0), so using the target
    position as the lever arm is exact for any mounting.  For a colocated
    sensor (d parallel to r) the omega columns vanish -- yaw rate is only
    Doppler-observable with off-origin sensors (ROADMAP item 2)."""
    r = assoc.position
    d = assoc.direction
    return jnp.concatenate([d, jnp.cross(r, d)], axis=-1)


def _masked_median(x: jax.Array, valid: jax.Array) -> jax.Array:
    return jnp.nanmedian(jnp.where(valid, x, jnp.nan))


def smart_initial_guess(assoc: Associations, cfg: VelocityConfig) -> jax.Array:
    """x0 = -(median apparent target velocity), z and omega zero
    (velocity_solver_improved.py:268-323)."""
    vx = _masked_median(assoc.apparent_velocity[:, 0], assoc.valid)
    vy = _masked_median(assoc.apparent_velocity[:, 1], assoc.valid)
    v = jnp.stack([-vx, -vy, 0.0])
    v = jnp.where(jnp.isnan(v), 0.0, v)
    v = jnp.clip(v, -cfg.max_velocity, cfg.max_velocity)
    return jnp.concatenate([v, jnp.zeros(3)])


def _prior_matrix(cfg: VelocityConfig, full: bool) -> jax.Array:
    """Diagonal Tikhonov prior (reference regularizers as ridge terms)."""
    lam = cfg.regularization_weight
    diag = jnp.array([lam, lam, lam * cfg.z_velocity_weight,
                      lam, lam, lam], jnp.float32)
    if not full:
        # v-only step: pin omega hard.
        diag = diag.at[3:].set(1e6)
    return jnp.diag(diag)


def _chol_solve_unrolled(H: jax.Array, g: jax.Array) -> jax.Array:
    """Solve the SPD system H x = g by a fully unrolled Cholesky.

    H [..., n, n], g [..., n] for small static n (3 or 6 here).  Every
    operation is a batched SCALAR op, so the solve vectorizes perfectly over
    leading batch axes -- ``jnp.linalg.solve``'s batched LU was the
    dominant cost of the whole velocity stage (the pipeline's small-solve
    chain runs ~14 of these per frame)."""
    n = H.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = g[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def _ridge_solve(A: jax.Array, b: jax.Array, w: jax.Array, prior: jax.Array,
                 x_prior: jax.Array, t_weight: jax.Array) -> jax.Array:
    """Solve (A^T W A + prior + t I) x = A^T W b + t x_prior."""
    Aw = A * w[:, None]
    H = _mm(A.T, Aw) + prior + t_weight * jnp.eye(6, dtype=A.dtype)
    g = _mm(Aw.T, b) + t_weight * x_prior
    return _chol_solve_unrolled(H + 1e-9 * jnp.eye(6, dtype=A.dtype), g)


def _huber_weights(res: jax.Array, delta: float) -> jax.Array:
    a = jnp.abs(res)
    return jnp.where(a <= delta, 1.0, delta / jnp.maximum(a, 1e-12))


def _apparent_velocity_rows(assoc: Associations):
    """Linear rows for the transverse apparent-velocity observable.

    Model: apparent_v = -(v + w x r), i.e. per target two rows
        [1, 0, 0,    0,  r_z, -r_y] . x = -a_x
        [0, 1, 0, -r_z,    0,  r_x] . x = -a_y
    This is the observable that makes yaw rate identifiable from a single
    colocated sensor (see VelocityConfig docstring); the reference only uses
    it for its smart initial guess (velocity_solver_improved.py:268-323)."""
    r = assoc.position
    zero = jnp.zeros_like(r[:, 0])
    one = jnp.ones_like(zero)
    row_x = jnp.stack([one, zero, zero, zero, r[:, 2], -r[:, 1]], axis=-1)
    row_y = jnp.stack([zero, one, zero, -r[:, 2], zero, r[:, 0]], axis=-1)
    A = jnp.concatenate([row_x, row_y], axis=0)                  # [2K, 6]
    b = jnp.concatenate([-assoc.apparent_velocity[:, 0],
                         -assoc.apparent_velocity[:, 1]])        # [2K]
    return A, b


def solve_doppler(assoc: Associations, cfg: VelocityConfig,
                  prev_motion: Optional[jax.Array] = None) -> jax.Array:
    """Ridge IRLS on the Doppler radial-velocity observable (optionally
    augmented with apparent-velocity rows).

    Model: vr_i = -[d_i, r_i x d_i] . x.  Returns x [6]."""
    A = -design_matrix(assoc)
    b = assoc.vr_mps
    w_base = jnp.where(assoc.valid, jnp.maximum(assoc.weight, 1e-3), 0.0)
    # Doppler-bin vr rows can be disabled (use_doppler_vr=False) for data
    # whose Doppler axis carries no ego-motion information.
    w0 = w_base if cfg.use_doppler_vr else jnp.zeros_like(w_base)
    if cfg.use_apparent_velocity:
        A2, b2 = _apparent_velocity_rows(assoc)
        A = jnp.concatenate([A, A2], axis=0)
        b = jnp.concatenate([b, b2])
        w_app = cfg.apparent_velocity_weight * jnp.concatenate(
            [w_base, w_base])
        w0 = jnp.concatenate([w0, w_app])
    t_w = jnp.float32(cfg.temporal_weight * cfg.regularization_weight
                      if prev_motion is not None else 0.0)
    x_prior = prev_motion if prev_motion is not None else jnp.zeros(6)

    def irls(x, full):
        prior = _prior_matrix(cfg, full)
        # Unrolled (3 static iterations): a fori_loop of tiny ops serializes
        # the solve into latency-bound device steps; unrolled, XLA fuses the
        # whole chain.
        for _ in range(3):
            res = b - _mm(A, x)
            w = w0 * _huber_weights(res, cfg.doppler_huber_mps)
            x = _ridge_solve(A, b, w, prior, x_prior, t_w)
        return x

    x = jnp.zeros(6)
    if cfg.two_step:
        x = irls(x, full=False)
    x = irls(x, full=True)
    return x


def refine_phase(assoc: Associations, x0: jax.Array, dt: jax.Array,
                 lambda_c: float, cfg: VelocityConfig,
                 prev_motion: Optional[jax.Array] = None) -> jax.Array:
    """Gauss-Newton on the wrapped phase residual, starting from x0.

    Each iteration: r = wrap(phi - A x);  x += solve(A^T W A + P, A^T W r).
    d wrap / dx = -A almost everywhere, so this is exact GN on the wrapped
    objective the reference's DE minimizes (velocity_solver_improved.py:
    223-266).

    Only the translational block is refined: the phase observable is purely
    radial, and for a colocated sensor the omega columns of the Jacobian are
    identically zero (r x d = 0) -- refining all 6 parameters would couple a
    ~1e8-magnitude v block with the 1e-2 omega prior in one float32 solve
    (condition ~1e10) and fill omega with numerical noise; omega keeps the
    value observed by the doppler/apparent-velocity stage.  For mounted
    (off-origin) sensors the omega columns r x d are nonzero; their phase
    contribution at x0's omega is subtracted from the residual as a fixed
    offset so the v refinement stays unbiased."""
    scale = 4.0 * jnp.pi * jnp.float32(dt) / jnp.float32(lambda_c)
    A = scale * assoc.direction                                   # [K, 3]
    lever = jnp.cross(assoc.position, assoc.direction)            # [K, 3]
    phi = assoc.temporal_phase_diff - scale * _mm(lever, x0[3:])
    w0 = jnp.where(assoc.valid, jnp.maximum(assoc.weight, 1e-3), 0.0)
    t_w = jnp.float32(cfg.temporal_weight * cfg.regularization_weight
                      if prev_motion is not None else 0.0)
    v_prior = (prev_motion[:3] if prev_motion is not None else jnp.zeros(3))
    lam = cfg.regularization_weight
    prior3 = jnp.diag(jnp.array([lam, lam, lam * cfg.z_velocity_weight],
                                jnp.float32))
    eye3 = jnp.eye(3, dtype=A.dtype)

    # Unrolled static GN iterations (see solve_doppler.irls for why).
    v = x0[:3]
    for _ in range(cfg.gn_iterations):
        res = wrap_angle(phi - _mm(A, v))
        w = w0 * _huber_weights(res, cfg.huber_delta)
        Aw = A * w[:, None]
        H = _mm(A.T, Aw) + (scale * scale) * (prior3 + t_w * eye3)
        g = _mm(Aw.T, res) + (scale * scale) * t_w * (v_prior - v)
        dv = _chol_solve_unrolled(H + 1e-6 * (scale * scale) * eye3, g)
        v = v + dv
    return jnp.concatenate([v, x0[3:]])


def dealias_doppler(assoc: Associations, x_ref: jax.Array,
                    v_unambiguous: float) -> Associations:
    """Unwrap Doppler radial velocities to the alias nearest a prediction.

    The range-Doppler map folds radial velocity into
    [-v_unambiguous, +v_unambiguous) (span lambda/(2 PRI)); each target's vr
    is shifted by the integer number of spans that brings it closest to the
    prediction -[d, r x d].x_ref.  Any x_ref accurate to within one
    half-span (~9.7 m/s at the reference PRI) recovers the true vr exactly."""
    span = jnp.float32(2.0 * v_unambiguous)
    vr_pred = -_mm(design_matrix(assoc), x_ref)
    k = jnp.round((vr_pred - assoc.vr_mps) / span)
    return assoc._replace(vr_mps=assoc.vr_mps + k * span)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "lambda_c", "mode",
                                    "v_unambiguous"))
def solve_velocity(assoc: Associations, dt: jax.Array, lambda_c: float,
                   cfg: VelocityConfig,
                   prev_motion: Optional[jax.Array] = None,
                   mode: Optional[str] = None,
                   v_unambiguous: Optional[float] = None) -> MotionEstimate:
    """Full two-step 6-DoF solve; returns a :class:`MotionEstimate`.

    Replaces ``two_step_optimization`` + ``run_robust_optimization``
    (velocity_solver.py:178-305, advanced_velocity_optimization.py:410-490).
    Deterministic -- no seeds, no restarts, no thread pools.

    Args:
        v_unambiguous: the radar's unambiguous radial velocity
            lambda/(4 PRI); enables Doppler de-aliasing when
            ``cfg.dealias_doppler`` (see :func:`dealias_doppler`).
    """
    mode = mode or cfg.mode
    n = assoc.num_valid

    if cfg.dealias_doppler and v_unambiguous is not None:
        # Reference motion for alias selection, chosen by CONSENSUS: among
        # {previous motion, apparent-velocity initial guess, zero}, pick the
        # candidate whose folded vr residuals agree with the most targets.
        # This bootstraps fast starts from the (unambiguous) apparent
        # velocities while degrading to the identity unwrap when
        # associations are spurious (small tie-break bonuses prefer
        # prev > zero > guess on equal support).
        span = jnp.float32(2.0 * v_unambiguous)
        prev = (prev_motion if prev_motion is not None
                else jnp.zeros(6, jnp.float32))
        cands = jnp.stack([prev, jnp.zeros(6, jnp.float32),
                           smart_initial_guess(assoc, cfg)])        # [3, 6]
        pred = -_mm(cands, design_matrix(assoc).T)                  # [3, K]
        res = assoc.vr_mps[None, :] - pred
        folded = res - span * jnp.round(res / span)
        w = jnp.where(assoc.valid, 1.0, 0.0)
        support = (jnp.sum((jnp.abs(folded) < 1.5) * w, axis=-1)
                   / jnp.maximum(jnp.sum(w), 1.0))
        best = jnp.argmax(support + jnp.array([2e-3, 1e-3, 0.0]))
        assoc = dealias_doppler(assoc, cands[best], v_unambiguous)

    if mode == "doppler":
        x = solve_doppler(assoc, cfg, prev_motion)
    elif mode == "phase":
        x0 = smart_initial_guess(assoc, cfg)
        x = refine_phase(assoc, x0, dt, lambda_c, cfg, prev_motion)
    elif mode == "fused":
        x0 = solve_doppler(assoc, cfg, prev_motion)
        x = refine_phase(assoc, x0, dt, lambda_c, cfg, prev_motion)
    else:
        raise ValueError(f"Unknown solver mode: {mode}")

    # Speed caps (advanced_velocity_optimization.py:195-204 soft constraints,
    # applied here as hard clips on the final estimate).
    v = jnp.clip(x[:3], -cfg.max_velocity, cfg.max_velocity)
    w = jnp.clip(x[3:], -cfg.max_angular_velocity, cfg.max_angular_velocity)
    x = jnp.concatenate([v, w])

    # Residual statistics on the phase observable (velocity_solver.py:277-284).
    scale = 4.0 * jnp.pi * jnp.float32(dt) / jnp.float32(lambda_c)
    res = wrap_angle(assoc.temporal_phase_diff
                     - scale * _mm(design_matrix(assoc), x))
    res = jnp.where(assoc.valid, res, 0.0)
    denom = jnp.maximum(n, 1)
    rmse = jnp.sqrt(jnp.sum(res * res) / denom)
    max_res = jnp.max(jnp.abs(res))
    cost = jnp.sum(res * res)

    success = n >= cfg.min_targets
    zero = jnp.zeros(3)
    fallback = prev_motion if prev_motion is not None else jnp.zeros(6)
    x = jnp.where(success, x, fallback)
    return MotionEstimate(
        velocity=jnp.where(success, x[:3], fallback[:3]),
        angular_velocity=jnp.where(success, x[3:], fallback[3:]),
        rmse=jnp.where(success, rmse, jnp.inf),
        max_residual=jnp.where(success, max_res, jnp.inf),
        num_targets=n.astype(jnp.int32),
        success=success,
        cost=jnp.where(success, cost, jnp.inf),
    )
