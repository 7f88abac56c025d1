"""Synthetic known-truth scene generation for tests and benchmarks.

The reference's universal test fixture is "place 2-3 scatterers at known
(range, azimuth, rcs, vr) and run the real pipeline" (SURVEY.md section 4,
``tests/test_improved_velocity.py:29-77``).  This module generalizes that:
a static world point cloud is observed by an ego vehicle moving with a known
6-DoF motion profile, producing per-frame :class:`ScattererBatch` inputs with
physically consistent ranges, azimuths and radial velocities -- so velocity /
trajectory recovery can be hard-asserted against truth.

All generation runs in host numpy (this is loader-side code; the device
first sees data as one uploaded batch).  ``jax.random`` keys are accepted
for API convenience and reduced to host seeds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from radar_slam_tpu.core.config import PipelineConfig
from radar_slam_tpu.core.types import ScattererBatch

SeedLike = Union[int, np.integer, jax.Array]


def _rng(seed: SeedLike) -> np.random.Generator:
    if isinstance(seed, (int, np.integer)):
        return np.random.default_rng(int(seed))
    # jax PRNG key (on any device): its key data reduced to a host seed.
    if isinstance(seed, jax.Array):
        data = jax.device_get(jax.random.key_data(seed))
        return np.random.default_rng(int(np.asarray(data).sum()) & 0x7FFFFFFF)
    return np.random.default_rng(abs(hash(seed)) & 0x7FFFFFFF)


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    num_points: int = 64
    min_range: float = 5.0
    max_range: float = 55.0
    rcs_min_db: float = 5.0
    rcs_max_db: float = 20.0
    azimuth_span_rad: float = 1.4      # initial point placement (+/- span/2)
    # Sensor field of view: points outside are not observed.  A ULA cannot
    # distinguish az from pi - az (cone ambiguity), so points drifting behind
    # the array would otherwise alias to mirrored azimuths and corrupt the
    # rotation observable.
    fov_rad: float = 2.4
    max_scatterers: int = 512


def make_world_points(seed: SeedLike, scene: SceneConfig
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Random static world points [N, 2] (x, y) and RCS [N] around origin."""
    rng = _rng(seed)
    r = rng.uniform(scene.min_range, scene.max_range, scene.num_points)
    az = rng.uniform(-scene.azimuth_span_rad / 2, scene.azimuth_span_rad / 2,
                     scene.num_points)
    rcs = rng.uniform(scene.rcs_min_db, scene.rcs_max_db, scene.num_points)
    pts = np.stack([r * np.cos(az), r * np.sin(az)], axis=-1)
    return pts.astype(np.float32), rcs.astype(np.float32)


def corridor_points(seed: SeedLike, scene: SceneConfig, path_xy: np.ndarray,
                    lateral: float = 30.0) -> Tuple[np.ndarray, np.ndarray]:
    """Scatter points around an ego path so targets stay in view for the
    whole sequence: each point is offset laterally + longitudinally from a
    random path sample."""
    rng = _rng(seed)
    n = scene.num_points
    idx = rng.integers(0, len(path_xy), n)
    base = np.asarray(path_xy)[idx]
    offs = rng.uniform(-1.0, 1.0, (n, 2)) * np.array(
        [scene.max_range * 0.8, lateral])
    rcs = rng.uniform(scene.rcs_min_db, scene.rcs_max_db, n)
    return (base + offs).astype(np.float32), rcs.astype(np.float32)


def observe_points(world_xy: np.ndarray, rcs_db: np.ndarray,
                   ego_xy: np.ndarray, ego_yaw: float,
                   v_body: np.ndarray, yaw_rate: float,
                   max_scatterers: int,
                   max_range: float = 1e9,
                   min_range: float = 1.5,
                   fov_rad: float = 2.4) -> Dict[str, np.ndarray]:
    """Project static world points into the ego body frame at one instant.

    Radial velocity is the physical range rate of a static point seen from a
    moving ego:  vr = -d_b . v_body  (rotation contributes nothing radially
    for a colocated sensor -- r x d = 0 when r is parallel to d; this is why
    single-sensor Doppler cannot observe yaw rate, see motion/velocity.py).

    Returns plain numpy columns (range_m, azimuth_rad, rcs_db, vr, valid)
    padded to ``max_scatterers``.
    """
    world_xy = np.asarray(world_xy, np.float64)
    c, s = np.cos(ego_yaw), np.sin(ego_yaw)
    rel = world_xy - np.asarray(ego_xy)[None, :]
    xb = c * rel[:, 0] + s * rel[:, 1]
    yb = -s * rel[:, 0] + c * rel[:, 1]
    rng_m = np.hypot(xb, yb)
    az = np.arctan2(yb, xb)
    d = np.stack([xb, yb], axis=-1) / np.maximum(rng_m[:, None], 1e-6)
    vr = -(d[:, 0] * v_body[0] + d[:, 1] * v_body[1])

    n = len(world_xy)
    assert max_scatterers >= n, "max_scatterers smaller than point count"
    pad = max_scatterers - n

    def z(x):
        return np.pad(np.asarray(x, np.float32), (0, pad))

    observable = ((rng_m <= max_range) & (rng_m >= min_range)
                  & (np.abs(az) <= fov_rad / 2))
    return {
        "range_m": z(rng_m), "azimuth_rad": z(az), "rcs_db": z(rcs_db),
        "vr": z(vr),
        "valid": np.pad(observable, (0, pad)),
    }


def _to_device_batch(frames) -> ScattererBatch:
    stack = {k: np.stack([f[k] for f in frames]) for k in frames[0]}
    return ScattererBatch(
        range_m=jnp.asarray(stack["range_m"]),
        azimuth_rad=jnp.asarray(stack["azimuth_rad"]),
        rcs_db=jnp.asarray(stack["rcs_db"]),
        vr=jnp.asarray(stack["vr"]),
        valid=jnp.asarray(stack["valid"]),
        elevation_rad=(jnp.asarray(stack["elevation_rad"])
                       if "elevation_rad" in stack else None),
    )


def constant_motion_scene(seed: SeedLike, num_frames: int, dt: float,
                          v_body: Tuple[float, float],
                          yaw_rate: float,
                          scene: SceneConfig = SceneConfig()):
    """Generate a frame sequence under constant body velocity + yaw rate.

    Points are distributed along the ego's path (corridor) so the scene
    stays observable over arbitrarily long sequences.

    Returns (ScattererBatch stacked [F, S] on device, gt dict of HOST numpy
    arrays: poses [F, 3] (x, y, yaw), velocity_body [3], yaw_rate,
    timestamps [F])."""
    vb = np.array([v_body[0], v_body[1]], np.float64)
    w = float(yaw_rate)

    # Exact constant-twist path.
    yaws = w * dt * np.arange(num_frames + 1)
    c, s = np.cos(yaws[:-1]), np.sin(yaws[:-1])
    steps = np.stack([c * vb[0] - s * vb[1], s * vb[0] + c * vb[1]],
                     axis=-1) * dt
    path = np.concatenate([np.zeros((1, 2)), np.cumsum(steps, axis=0)])

    world, rcs = corridor_points(seed, scene, path)

    frames = []
    for i in range(num_frames):
        frames.append(observe_points(
            world, rcs, path[i], yaws[i], vb, w, scene.max_scatterers,
            max_range=scene.max_range, fov_rad=scene.fov_rad))

    gt = {
        "poses": np.concatenate([path[:num_frames],
                                 yaws[:num_frames, None]], axis=-1),
        "velocity_body": np.array([v_body[0], v_body[1], 0.0]),
        "yaw_rate": w,
        "timestamps": np.arange(num_frames) * dt,
    }
    return _to_device_batch(frames), gt


def constant_motion_scene_3d(seed: SeedLike, num_frames: int, dt: float,
                             v_body: Tuple[float, float, float],
                             yaw_rate: float,
                             scene: SceneConfig = SceneConfig(),
                             z_span: float = 10.0):
    """3-D variant of :func:`constant_motion_scene`: world points carry
    heights, observations carry elevations, and the ego moves with a full
    3-D body velocity (vz makes the ego climb/descend) -- the workload that
    requires a URA (RadarConfig.num_antennas_el > 1) to recover v_z.

    Returns (ScattererBatch [F, S] with ``elevation_rad``, gt dict)."""
    vb = np.array(v_body, np.float64)
    w = float(yaw_rate)

    yaws = w * dt * np.arange(num_frames + 1)
    c, s = np.cos(yaws[:-1]), np.sin(yaws[:-1])
    steps = np.stack([c * vb[0] - s * vb[1], s * vb[0] + c * vb[1],
                      np.full(num_frames, vb[2])], axis=-1) * dt
    path = np.concatenate([np.zeros((1, 3)), np.cumsum(steps, axis=0)])

    world_xy, rcs = corridor_points(seed, scene, path[:, :2])
    rng = _rng(seed)
    world_z = rng.uniform(-z_span, z_span, len(world_xy))
    world = np.concatenate([world_xy, world_z[:, None]], axis=-1)

    frames = []
    for i in range(num_frames):
        cy, sy = np.cos(yaws[i]), np.sin(yaws[i])
        rel = world - path[i][None, :]
        xb = cy * rel[:, 0] + sy * rel[:, 1]
        yb = -sy * rel[:, 0] + cy * rel[:, 1]
        zb = rel[:, 2]
        rng_m = np.sqrt(xb * xb + yb * yb + zb * zb)
        rh = np.hypot(xb, yb)
        az = np.arctan2(yb, xb)
        el = np.arctan2(zb, np.maximum(rh, 1e-6))
        d = np.stack([xb, yb, zb], -1) / np.maximum(rng_m[:, None], 1e-6)
        # vr = -d . (v + w x p), planar yaw: w x p = (-w yb, w xb, 0).
        vr = -(d[:, 0] * (vb[0] - w * yb) + d[:, 1] * (vb[1] + w * xb)
               + d[:, 2] * vb[2])

        n = len(world)
        pad = scene.max_scatterers - n
        assert pad >= 0

        def z_(x):
            return np.pad(np.asarray(x, np.float32), (0, pad))

        observable = ((rng_m <= scene.max_range) & (rng_m >= 1.5)
                      & (np.abs(az) <= scene.fov_rad / 2))
        frames.append({
            "range_m": z_(rng_m), "azimuth_rad": z_(az), "rcs_db": z_(rcs),
            "vr": z_(vr), "elevation_rad": z_(el),
            "valid": np.pad(observable, (0, pad)),
        })

    gt = {
        "poses": np.concatenate([path[:num_frames, :2],
                                 yaws[:num_frames, None]], axis=-1),
        "velocity_body": vb,
        "yaw_rate": w,
        "timestamps": np.arange(num_frames) * dt,
    }
    return _to_device_batch(frames), gt


@dataclasses.dataclass(frozen=True)
class MismatchConfig:
    """Adversarial / model-mismatch scene options (VERDICT round-1 items 1-2).

    Each knob makes the generated world disagree with an assumption the
    solver's model bakes in; :func:`mismatch_scene` composes them on top of
    the constant-twist ego profile.  All default to "off" (= the clean
    :func:`constant_motion_scene` world).
    """

    # Moving rigid actors (other vehicles): points with their OWN world
    # velocity.  Their vr / phase / apparent-velocity observables encode the
    # actor's motion, not the ego's -- the dominant real-data outlier class
    # (RadarScenes scenes are full of movers; the reference's robust tier
    # exists for this, robust_angle_estimation.py:140-272).
    num_movers: int = 0
    mover_points: int = 3          # scatterers per actor (extended body)
    mover_speed_min: float = 3.0   # world speed range [m/s]
    mover_speed_max: float = 10.0
    mover_rcs_db: float = 22.0     # vehicles are strong reflectors
    # Coherent traffic: all actors drive ANTI-parallel to the ego's initial
    # heading (oncoming lane) instead of in random directions.  Their biases
    # add up instead of cancelling -- the hardest case for an unrobust
    # estimator (random directions partially average out).
    mover_oncoming: bool = False
    # Transient clutter: per-frame spurious returns at random (range, az, vr)
    # uncorrelated across frames (rain / multipath ghosts).  Violates the
    # static-world association assumption.
    clutter_per_frame: int = 0
    clutter_rcs_db: float = 14.0
    clutter_vr_span: float = 15.0
    # Extended targets: every world point becomes a Gaussian cluster of
    # sub-scatterers (multi-cell returns; violates the point-target model
    # behind peak detection / signature extraction).
    extent_points: int = 1
    extent_size_m: float = 0.8
    # Sensor timing jitter: frames observed at t_i = i dt + U(-j, j) dt while
    # the solver integrates with the nominal dt.
    dt_jitter_frac: float = 0.0
    # Dropped frames: all returns lost with this probability (frames 0-1 are
    # never dropped so association can bootstrap).
    drop_frame_prob: float = 0.0


def twist_poses(t: np.ndarray, v_body: np.ndarray, yaw_rate: float
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact constant-twist planar poses at times ``t``.

    Returns (xy [T, 2], yaw [T]).  Closed form of the continuous motion
    x'(t) = R(w t) v_body:  for |w| > 0,
    x(t) = (vx sin(wt) + vy (cos(wt) - 1)) / w,
    y(t) = (vx (1 - cos(wt)) + vy sin(wt)) / w."""
    t = np.asarray(t, np.float64)
    vx, vy = float(v_body[0]), float(v_body[1])
    w = float(yaw_rate)
    yaw = w * t
    if abs(w) < 1e-9:
        xy = np.stack([vx * t, vy * t], axis=-1)
    else:
        sw, cw = np.sin(yaw), np.cos(yaw)
        xy = np.stack([(vx * sw + vy * (cw - 1.0)) / w,
                       (vx * (1.0 - cw) + vy * sw) / w], axis=-1)
    return xy, yaw


def _observe_relative(world_xy: np.ndarray, world_vel: np.ndarray,
                      rcs_db: np.ndarray, ego_xy: np.ndarray, ego_yaw: float,
                      v_body: np.ndarray, max_range: float, min_range: float,
                      fov_rad: float) -> Dict[str, np.ndarray]:
    """Unpadded body-frame observation of (possibly moving) world points.

    vr is the exact range rate  d_w . (u - v_ego_w)  expressed in the body
    frame:  vr = d_b . (R^T u) - d_b . v_body  (static u = 0 reduces to
    :func:`observe_points`'s -d_b . v_body; colocated-sensor rotation adds
    nothing radially)."""
    world_xy = np.asarray(world_xy, np.float64)
    c, s = np.cos(ego_yaw), np.sin(ego_yaw)
    rel = world_xy - np.asarray(ego_xy)[None, :]
    xb = c * rel[:, 0] + s * rel[:, 1]
    yb = -s * rel[:, 0] + c * rel[:, 1]
    rng_m = np.hypot(xb, yb)
    az = np.arctan2(yb, xb)
    d = np.stack([xb, yb], axis=-1) / np.maximum(rng_m[:, None], 1e-6)
    u = np.asarray(world_vel, np.float64)
    ub = np.stack([c * u[:, 0] + s * u[:, 1],
                   -s * u[:, 0] + c * u[:, 1]], axis=-1)
    vr = (d[:, 0] * (ub[:, 0] - v_body[0])
          + d[:, 1] * (ub[:, 1] - v_body[1]))
    observable = ((rng_m <= max_range) & (rng_m >= min_range)
                  & (np.abs(az) <= fov_rad / 2))
    return {"range_m": rng_m.astype(np.float32),
            "azimuth_rad": az.astype(np.float32),
            "rcs_db": np.asarray(rcs_db, np.float32),
            "vr": vr.astype(np.float32),
            "valid": observable}


def mismatch_scene(seed: SeedLike, num_frames: int, dt: float,
                   v_body: Tuple[float, float], yaw_rate: float,
                   scene: SceneConfig = SceneConfig(),
                   mm: MismatchConfig = MismatchConfig()):
    """Adversarial scene generator: constant-twist ego through a static
    corridor world plus the :class:`MismatchConfig` perturbations.

    Returns (ScattererBatch [F, S] on device, gt dict as in
    :func:`constant_motion_scene` plus ``mover_fraction`` -- the mean share
    of observable returns that belong to moving actors)."""
    rng = _rng(seed)
    vb = np.array([v_body[0], v_body[1]], np.float64)
    w = float(yaw_rate)

    t_nom = np.arange(num_frames) * dt
    jitter = rng.uniform(-1.0, 1.0, num_frames) * mm.dt_jitter_frac * dt
    jitter[0] = 0.0
    t_act = t_nom + jitter
    path, yaws = twist_poses(t_act, vb, w)

    # Static world along the nominal path.
    path_dense, _ = twist_poses(np.linspace(0.0, num_frames * dt, 64), vb, w)
    world, rcs = corridor_points(seed, scene, path_dense)
    if mm.extent_points > 1:
        reps = int(mm.extent_points)
        offs = rng.normal(0.0, mm.extent_size_m, (len(world) * reps, 2))
        world = np.repeat(world, reps, axis=0) + offs
        # Split the return power across the cluster.
        rcs = np.repeat(rcs, reps) - 10.0 * np.log10(reps)
    static_vel = np.zeros_like(world)

    # Moving actors: spawned ahead of the ego, each a small rigid cluster
    # with a constant world velocity.
    mover_xy = np.zeros((0, 2))
    mover_vel = np.zeros((0, 2))
    mover_rcs = np.zeros(0)
    if mm.num_movers > 0:
        idx = rng.integers(0, len(path), mm.num_movers)
        head = yaws[idx] + rng.uniform(-0.5, 0.5, mm.num_movers)
        dist = rng.uniform(scene.min_range + 5.0, scene.max_range * 0.7,
                           mm.num_movers)
        centers = path[idx] + np.stack([np.cos(head) * dist,
                                        np.sin(head) * dist], axis=-1)
        speed = rng.uniform(mm.mover_speed_min, mm.mover_speed_max,
                            mm.num_movers)
        if mm.mover_oncoming:
            heading0 = float(np.arctan2(vb[1], vb[0]))
            vdir = np.full(mm.num_movers, heading0 + np.pi) \
                + rng.uniform(-0.15, 0.15, mm.num_movers)
        else:
            vdir = rng.uniform(-np.pi, np.pi, mm.num_movers)
        vel = np.stack([np.cos(vdir), np.sin(vdir)], axis=-1) * speed[:, None]
        body = rng.normal(0.0, 1.2, (mm.num_movers, mm.mover_points, 2))
        mover_xy = (centers[:, None, :] + body).reshape(-1, 2)
        mover_vel = np.repeat(vel, mm.mover_points, axis=0)
        mover_rcs = np.full(len(mover_xy), mm.mover_rcs_db) \
            + rng.uniform(-3.0, 3.0, len(mover_xy))

    dropped = rng.uniform(0.0, 1.0, num_frames) < mm.drop_frame_prob
    dropped[:2] = False

    frames = []
    mover_frac = []
    for i in range(num_frames):
        obs_s = _observe_relative(world, static_vel, rcs, path[i], yaws[i],
                                  vb, scene.max_range, 1.5, scene.fov_rad)
        parts = [obs_s]
        if len(mover_xy):
            mxy = mover_xy + mover_vel * t_act[i]
            obs_m = _observe_relative(mxy, mover_vel, mover_rcs, path[i],
                                      yaws[i], vb, scene.max_range, 1.5,
                                      scene.fov_rad)
            parts.append(obs_m)
        if mm.clutter_per_frame > 0:
            n = mm.clutter_per_frame
            parts.append({
                "range_m": rng.uniform(2.0, scene.max_range, n
                                       ).astype(np.float32),
                "azimuth_rad": rng.uniform(-scene.fov_rad / 2,
                                           scene.fov_rad / 2, n
                                           ).astype(np.float32),
                "rcs_db": (mm.clutter_rcs_db
                           + rng.uniform(-4.0, 4.0, n)).astype(np.float32),
                "vr": rng.uniform(-mm.clutter_vr_span, mm.clutter_vr_span, n
                                  ).astype(np.float32),
                "valid": np.ones(n, bool),
            })
        cat = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        if dropped[i]:
            cat["valid"] = np.zeros_like(cat["valid"])
        n_total = len(cat["range_m"])
        assert n_total <= scene.max_scatterers, \
            f"{n_total} scatterers exceed capacity {scene.max_scatterers}"
        pad = scene.max_scatterers - n_total
        n_static = len(world)
        vis = cat["valid"]
        n_mover_vis = int(vis[n_static:n_static + len(mover_xy)].sum())
        mover_frac.append(n_mover_vis / max(int(vis.sum()), 1))
        frames.append({
            k: (np.pad(v, (0, pad)) if k != "valid"
                else np.pad(v, (0, pad))) for k, v in cat.items()})

    gt = {
        "poses": np.concatenate([path, yaws[:, None]], axis=-1),
        "velocity_body": np.array([v_body[0], v_body[1], 0.0]),
        "yaw_rate": w,
        "timestamps": t_act,
        "mover_fraction": float(np.mean(mover_frac)),
        "dropped": dropped,
    }
    return _to_device_batch(frames), gt


def observe_points_from_sensor(world_xy: np.ndarray, rcs_db: np.ndarray,
                               ego_xy: np.ndarray, ego_yaw: float,
                               v_body: np.ndarray, yaw_rate: float,
                               mount: Tuple[float, float, float],
                               max_scatterers: int,
                               max_range: float = 1e9,
                               min_range: float = 1.5,
                               fov_rad: float = 2.4) -> Dict[str, np.ndarray]:
    """Project static world points into ONE mounted sensor's frame.

    ``mount`` = (x, y, yaw) of the sensor in the vehicle frame.  Outputs are
    SENSOR-frame polar coordinates (what a real mounted radar measures; cf.
    RadarScenes per-sensor ``range_sc``/``azimuth_sc``), and the radial
    velocity is the exact range rate of a static point seen from the mounted
    sensor on a translating+rotating ego:

        vr = -d . (v + w x p)      (d = sensor->target LOS, p = target
                                    position, both in the vehicle frame;
                                    see motion/velocity.py design_matrix)

    The w x p lever-arm term is what makes yaw rate observable from Doppler
    alone with a multi-sensor rig -- the colocated :func:`observe_points`
    cannot express it (there d is parallel to p)."""
    world_xy = np.asarray(world_xy, np.float64)
    mx, my, myaw = float(mount[0]), float(mount[1]), float(mount[2])
    c, s = np.cos(ego_yaw), np.sin(ego_yaw)
    rel = world_xy - np.asarray(ego_xy)[None, :]
    # Target position p in the vehicle (body) frame.
    px = c * rel[:, 0] + s * rel[:, 1]
    py = -s * rel[:, 0] + c * rel[:, 1]
    # Sensor->target vector in the vehicle frame.
    ex, ey = px - mx, py - my
    rng_m = np.hypot(ex, ey)
    dx, dy = ex / np.maximum(rng_m, 1e-6), ey / np.maximum(rng_m, 1e-6)
    # Azimuth in the SENSOR frame (boresight rotated by mount yaw).
    az = np.arctan2(ey, ex) - myaw
    az = np.arctan2(np.sin(az), np.cos(az))
    w = float(yaw_rate)
    # v + w x p (planar): (vx - w py, vy + w px).
    vr = -(dx * (v_body[0] - w * py) + dy * (v_body[1] + w * px))

    n = len(world_xy)
    assert max_scatterers >= n, "max_scatterers smaller than point count"
    pad = max_scatterers - n

    def z(x):
        return np.pad(np.asarray(x, np.float32), (0, pad))

    observable = ((rng_m <= max_range) & (rng_m >= min_range)
                  & (np.abs(az) <= fov_rad / 2))
    return {
        "range_m": z(rng_m), "azimuth_rad": z(az), "rcs_db": z(rcs_db),
        "vr": z(vr),
        "valid": np.pad(observable, (0, pad)),
    }


def constant_motion_scene_rig(seed: SeedLike, num_frames: int, dt: float,
                              v_body: Tuple[float, float],
                              yaw_rate: float,
                              rig: Tuple[Tuple[float, float, float], ...],
                              scene: SceneConfig = SceneConfig()):
    """Multi-sensor variant of :func:`constant_motion_scene`.

    Each sensor of ``rig`` ((x, y, yaw) mounts in the vehicle frame) observes
    the same static world in its own frame.  Points are placed around the
    path per sensor so every sensor keeps returns in view.

    Returns (ScattererBatch stacked [F, N_sens, S] on device, gt dict)."""
    vb = np.array([v_body[0], v_body[1]], np.float64)
    w = float(yaw_rate)

    yaws = w * dt * np.arange(num_frames + 1)
    c, s = np.cos(yaws[:-1]), np.sin(yaws[:-1])
    steps = np.stack([c * vb[0] - s * vb[1], s * vb[0] + c * vb[1]],
                     axis=-1) * dt
    path = np.concatenate([np.zeros((1, 2)), np.cumsum(steps, axis=0)])

    rng = _rng(seed)
    worlds = []
    for b, mount in enumerate(rig):
        # Seed world points along boresight of this sensor around the path.
        n = scene.num_points
        idx = rng.integers(0, len(path), n)
        base = path[idx]
        head = yaws[idx] + mount[2]
        along = rng.uniform(scene.min_range, scene.max_range * 0.8, n)
        across = rng.uniform(-0.4, 0.4, n) * scene.max_range
        pts = base + np.stack([
            np.cos(head) * along - np.sin(head) * across,
            np.sin(head) * along + np.cos(head) * across], axis=-1)
        rcs = rng.uniform(scene.rcs_min_db, scene.rcs_max_db, n)
        worlds.append((pts, rcs))

    frames = []
    for i in range(num_frames):
        per_sensor = [
            observe_points_from_sensor(
                worlds[b][0], worlds[b][1], path[i], yaws[i], vb, w, mount,
                scene.max_scatterers, max_range=scene.max_range,
                fov_rad=scene.fov_rad)
            for b, mount in enumerate(rig)]
        frames.append({k: np.stack([ps[k] for ps in per_sensor])
                       for k in per_sensor[0]})

    gt = {
        "poses": np.concatenate([path[:num_frames],
                                 yaws[:num_frames, None]], axis=-1),
        "velocity_body": np.array([v_body[0], v_body[1], 0.0]),
        "yaw_rate": w,
        "timestamps": np.arange(num_frames) * dt,
    }
    return _to_device_batch(frames), gt


def pipeline_scatterer_pad(batch: ScattererBatch, cfg: PipelineConfig
                           ) -> ScattererBatch:
    """Pad/trim a batch to the pipeline's static scatterer capacity."""
    from radar_slam_tpu.core.types import pad_to
    S = cfg.max_scatterers
    return ScattererBatch(*[pad_to(x, S, axis=-1) if x is not None else None
                            for x in batch])


# ---------------------------------------------------------------------------
# Loop-closure characterization scenes (detection-level point clouds)
# ---------------------------------------------------------------------------

def to_body(world_pts: np.ndarray, pose) -> np.ndarray:
    """World-frame 2-D points [N, 2] into the body frame of SE(2) ``pose``
    (x, y, yaw)."""
    c, s = np.cos(pose[2]), np.sin(pose[2])
    rel = world_pts - pose[:2]
    return np.stack([c * rel[:, 0] + s * rel[:, 1],
                     -s * rel[:, 0] + c * rel[:, 1]], axis=-1)


def circle_scene(n_frames: int = 90, v: float = 6.0, w: float = 0.7,
                 dt: float = 0.1, n_world: int = 120, seed: SeedLike = 2):
    """Ego drives a full circle (a revisit at the end); world points are
    scattered in a band along the circle.

    Returns (gt_poses [F, 3], points [F, N, 2] jnp, valid [F, N] jnp) in
    the detection-cloud convention of ``parallel/loopclosure.py``.
    """
    rng = _rng(seed)
    poses = []
    x = np.zeros(2)
    yaw = 0.0
    for _ in range(n_frames):
        poses.append([x[0], x[1], yaw])
        x = x + dt * np.array([v * np.cos(yaw), v * np.sin(yaw)])
        yaw += w * dt
    poses = np.array(poses)
    radius = v / w
    center = np.array([0.0, radius])
    ang = rng.uniform(0, 2 * np.pi, n_world)
    rad = radius + rng.uniform(-12, 12, n_world)
    world = center + np.stack([rad * np.sin(ang), -rad * np.cos(ang)], -1)

    pts, msk = [], []
    for p in poses:
        body = to_body(world, p)
        rngs = np.hypot(body[:, 0], body[:, 1])
        az = np.arctan2(body[:, 1], body[:, 0])
        ok = (rngs > 1.5) & (rngs < 40.0) & (np.abs(az) < 1.2)
        pts.append(body.astype(np.float32))
        msk.append(ok)
    return poses, jnp.asarray(np.stack(pts)), jnp.asarray(np.stack(msk))


def periodic_corridor_scene(seed: SeedLike, n_frames: int = 80,
                            v: float = 6.0, dt: float = 0.1,
                            period: float = 18.0, n_per_period: int = 28,
                            jitter: float = 0.0,
                            corridor_halfwidth: float = 6.0,
                            max_range: float = 40.0, capacity: int = 160):
    """Perceptually-aliased corridor for loop-closure false-positive tests.

    Ego drives straight through a corridor whose wall-point pattern repeats
    every ``period`` metres, so frames ``period / (v dt)`` apart see
    near-identical local geometry WITHOUT being revisits -- the worst case
    for descriptor-based retrieval (the aliasing the reference never faces
    because it has no loop closure at all).  Each repetition independently
    re-draws the base pattern with per-point ``jitter`` [m]: at descriptor
    resolution (2.8 m rings x 7.5 deg sectors) jittered repeats still look
    alike, but point-level verification (ICP) sees the difference.

    Returns (gt_poses [F, 3], points [F, K, 2] jnp, valid [F, K] jnp) in
    the detection-cloud convention of ``parallel/loopclosure.py``.
    """
    rng = _rng(seed)
    poses = np.zeros((n_frames, 3))
    poses[:, 0] = v * dt * np.arange(n_frames)

    u = rng.uniform(0.0, period, n_per_period)
    side = rng.choice([-1.0, 1.0], n_per_period)
    y = side * (corridor_halfwidth + rng.uniform(-1.0, 1.0, n_per_period))
    base = np.stack([u, y], axis=-1)                       # [P, 2]

    span = v * dt * n_frames + 2 * max_range
    k0 = int(np.floor(-max_range / period)) - 1
    k1 = int(np.ceil(span / period)) + 1
    reps = []
    for k in range(k0, k1):
        rep = base + rng.normal(0.0, jitter, base.shape)
        rep[:, 0] += k * period
        reps.append(rep)
    world = np.concatenate(reps)                           # [M, 2]

    pts = np.zeros((n_frames, capacity, 2), np.float32)
    msk = np.zeros((n_frames, capacity), bool)
    for f in range(n_frames):
        body = world - poses[f, :2]                        # yaw = 0
        r = np.hypot(body[:, 0], body[:, 1])
        ok = (r > 1.5) & (r < max_range)
        sel = np.argsort(np.where(ok, r, np.inf))[:capacity]
        good = ok[sel]
        n = int(good.sum())
        pts[f, :n] = body[sel[:n]]
        msk[f, :n] = True
    return poses, jnp.asarray(pts), jnp.asarray(msk)


def augment_clutter_movers(poses: np.ndarray, pts, msk,
                           seed: SeedLike, clutter_per_frame: int = 12,
                           n_movers: int = 3, mover_speed: float = 8.0,
                           max_range: float = 40.0, dt: float = 0.1):
    """Append per-frame uniform clutter + coherently moving objects to a
    detection-cloud scene (loop-closure stress variant).

    Clutter points are re-drawn independently every frame (decorrelated
    across revisits); movers travel in straight world-frame lines and are
    observed in each frame's body frame.  Returns (points, valid) with
    ``clutter_per_frame + n_movers`` extra columns.
    """
    rng = _rng(seed)
    F = pts.shape[0]
    pts_np = np.asarray(pts)
    msk_np = np.asarray(msk)
    extra = clutter_per_frame + n_movers

    m0 = rng.uniform(-max_range, max_range, (n_movers, 2)) \
        + poses[0, :2][None, :]
    ang = rng.uniform(0, 2 * np.pi, n_movers)
    mv = mover_speed * np.stack([np.cos(ang), np.sin(ang)], axis=-1)

    add_p = np.zeros((F, extra, 2), np.float32)
    add_m = np.zeros((F, extra), bool)
    t = 0.0
    for f in range(F):
        c, s = np.cos(poses[f, 2]), np.sin(poses[f, 2])
        Rw2b = np.array([[c, s], [-s, c]])
        r_cl = np.sqrt(rng.uniform(0.04, 1.0, clutter_per_frame)) * max_range
        a_cl = rng.uniform(-np.pi, np.pi, clutter_per_frame)
        add_p[f, :clutter_per_frame, 0] = r_cl * np.cos(a_cl)
        add_p[f, :clutter_per_frame, 1] = r_cl * np.sin(a_cl)
        add_m[f, :clutter_per_frame] = True
        world_m = m0 + mv * t
        body_m = (world_m - poses[f, :2]) @ Rw2b.T
        rr = np.hypot(body_m[:, 0], body_m[:, 1])
        add_p[f, clutter_per_frame:] = body_m
        add_m[f, clutter_per_frame:] = (rr > 1.5) & (rr < max_range)
        t += dt
    return (jnp.asarray(np.concatenate([pts_np, add_p], axis=1)),
            jnp.asarray(np.concatenate([msk_np, add_m], axis=1)))
