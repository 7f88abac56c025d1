"""Artifact schema-compatible persistence (checkpoint/interop layer).

The reference's inter-stage contract is the filesystem
(SURVEY.md section 1): ``raw_sim/frame_XXXX.npy``, ``rds/frame_XXXX_rds.npy``
+ ``frame_XXXX_peaks.npz``, ``angles/frame_XXXX_angles.npz``,
``velocities/frame_XXXX_velocity.npz``, ``poses/trajectory.npz`` + text
export, ``synthesis_metadata.json`` (run_ego_motion_pipeline.py:96-105,
163-169, 218-219, 274-275, 341-342; simulate_raw.py:313-327;
pose_integration.py:351-376).  This module writes/reads the same filenames
and keys so artifacts interoperate with reference tooling, and doubles as
the stage-level checkpoint/resume mechanism.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional

import jax
import numpy as np

from radar_slam_tpu.core.config import PipelineConfig, RadarConfig
from radar_slam_tpu.core.types import Detections, Targets, Trajectory

STAGE_DIRS = ("raw_sim", "rds", "angles", "velocities", "poses", "evaluation")


def ensure_stage_dirs(root: str | Path) -> Dict[str, Path]:
    root = Path(root)
    out = {}
    for d in STAGE_DIRS:
        p = root / d
        p.mkdir(parents=True, exist_ok=True)
        out[d] = p
    return out


def frame_name(i: int) -> str:
    return f"frame_{i:04d}"


# -- raw signals (simulate_raw.py:302-304) ----------------------------------

def save_raw_frame(path: Path, i: int, signals) -> Path:
    f = path / f"{frame_name(i)}.npy"
    np.save(f, jax.device_get(signals))
    return f


def load_raw_frame(path: Path, i: int) -> np.ndarray:
    return np.load(path / f"{frame_name(i)}.npy")


def save_synthesis_metadata(path: Path, radar: RadarConfig,
                            stats: Dict) -> Path:
    f = path / "synthesis_metadata.json"
    with open(f, "w") as fh:
        json.dump({
            "radar_params": {
                "fc": radar.fc, "bandwidth": radar.bandwidth,
                "chirp_duration": radar.chirp_duration, "pri": radar.pri,
                "num_chirps": radar.num_chirps,
                "num_antennas": radar.num_antennas,
                "antenna_spacing": radar.spacing,
                "sampling_rate": radar.sampling_rate,
            },
            "processing_stats": stats,
        }, fh, indent=2)
    return f


# -- RDS + peaks (run_ego_motion_pipeline.py:163-169) -----------------------

def save_rds_frame(path: Path, i: int, rds, detections: Detections,
                   power_db: Optional[np.ndarray] = None) -> Path:
    np.save(path / f"{frame_name(i)}_rds.npy", jax.device_get(rds))
    d = {k: jax.device_get(v) for k, v in detections._asdict().items()}
    if power_db is not None:
        d["power_spectrum_db"] = np.asarray(power_db)
    np.savez(path / f"{frame_name(i)}_peaks.npz", **d)
    return path / f"{frame_name(i)}_rds.npy"


def load_rds_frame(path: Path, i: int):
    rds = np.load(path / f"{frame_name(i)}_rds.npy")
    with np.load(path / f"{frame_name(i)}_peaks.npz") as z:
        peaks = {k: z[k] for k in z.files}
    return rds, peaks


# -- angles (run_ego_motion_pipeline.py:218-219) ----------------------------

def save_angles_frame(path: Path, i: int, targets: Targets) -> Path:
    f = path / f"{frame_name(i)}_angles.npz"
    np.savez(f, **{k: jax.device_get(v) for k, v in targets._asdict().items()})
    return f


def load_angles_frame(path: Path, i: int) -> Dict[str, np.ndarray]:
    with np.load(path / f"{frame_name(i)}_angles.npz") as z:
        return {k: z[k] for k in z.files}


# -- velocities (run_ego_motion_pipeline.py:274-275) ------------------------

def save_velocity_frame(path: Path, i: int, motion) -> Path:
    f = path / f"{frame_name(i)}_velocity.npz"
    np.savez(f,
             velocity=np.asarray(motion.velocity),
             angular_velocity=np.asarray(motion.angular_velocity),
             rmse=np.asarray(motion.rmse),
             max_residual=np.asarray(motion.max_residual),
             num_targets=np.asarray(motion.num_targets),
             success=np.asarray(motion.success),
             cost=np.asarray(motion.cost))
    return f


def load_velocity_frame(path: Path, i: int) -> Dict[str, np.ndarray]:
    with np.load(path / f"{frame_name(i)}_velocity.npz") as z:
        return {k: z[k] for k in z.files}


# -- trajectory (pose_integration.py:351-376) -------------------------------

def save_trajectory(path: Path, traj: Trajectory,
                    name: str = "trajectory") -> Path:
    f = Path(path) / f"{name}.npz"
    np.savez(
        f,
        timestamps=np.asarray(traj.timestamps),
        positions=np.asarray(traj.positions),
        orientations=np.asarray(traj.orientations),
        rotations=np.asarray(traj.rotations),
        quaternions=np.asarray(traj.quaternions),
        velocities=np.asarray(traj.velocities),
        angular_velocities=np.asarray(traj.angular_velocities))
    # Text export: timestamp,x,y,z,roll,pitch,yaw (pose_integration.py:364-376)
    txt = Path(path) / f"{name}.txt"
    ts = np.asarray(traj.timestamps)
    pos = np.asarray(traj.positions)
    eul = np.asarray(traj.orientations)
    with open(txt, "w") as fh:
        fh.write("# timestamp x y z roll pitch yaw\n")
        for k in range(len(ts)):
            fh.write(f"{ts[k]:.6f} {pos[k,0]:.6f} {pos[k,1]:.6f} "
                     f"{pos[k,2]:.6f} {eul[k,0]:.6f} {eul[k,1]:.6f} "
                     f"{eul[k,2]:.6f}\n")
    return f


def load_trajectory(path: Path, name: str = "trajectory") -> Dict[str, np.ndarray]:
    with np.load(Path(path) / f"{name}.npz") as z:
        return {k: z[k] for k in z.files}


# -- pipeline config snapshot ----------------------------------------------

def save_config(path: Path, cfg: PipelineConfig) -> Path:
    f = Path(path) / "pipeline_config.json"
    with open(f, "w") as fh:
        json.dump(dataclasses.asdict(cfg), fh, indent=2, default=str)
    return f
