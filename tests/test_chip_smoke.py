"""chip_smoke.py and the device / compile-cache helpers it stands on, run at
tiny sizes on the CPU: the refusal to run without a GPU, the peak table,
the cache location, and every phase function of the smoke test."""

import dataclasses
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radar_slam_tpu.core.config import RadarConfig, complete_analysis_config
from radar_slam_tpu.utils import compile_cache, device

ROOT = Path(__file__).resolve().parents[1]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load_chip_smoke()


def _tiny_cfg():
    """The main config's structure at a size the CPU runs in seconds: 128
    samples at 0.6 m range bins (so the corridor's 5-55 m stays in view),
    8 chirps, 16 detections, a 5 deg grid."""
    cfg = complete_analysis_config()
    return dataclasses.replace(
        cfg,
        radar=RadarConfig(num_chirps=8, chirp_duration=12.8e-6,
                          bandwidth=250e6, noise_power=1e-6),
        detection=dataclasses.replace(cfg.detection, max_detections=16,
                                      cfar_train_cells=2, guard_cells=1),
        aoa=dataclasses.replace(cfg.aoa, search_resolution_deg=5.0,
                                max_targets=16, track_capacity=32),
        velocity=dataclasses.replace(cfg.velocity, gn_iterations=2),
        max_scatterers=128)


# ----------------------------------------------------------- device helpers

def test_peak_rates_of_h100():
    peaks = device.peak_rates("NVIDIA H100 80GB HBM3")
    assert peaks == {"bf16_tflops": 989.0, "tf32_tflops": 495.0,
                     "f32_tflops": 67.0, "hbm_gbps": 3350.0}


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe",
                                  "NVIDIA A100-SXM4-80GB"])
def test_peak_rates_unknown_device_kind_is_error(kind):
    with pytest.raises(ValueError, match="no published peak rates"):
        device.peak_rates(kind)


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="JAX found no GPU"):
        device.require_gpu()


@pytest.mark.parametrize("configured", [None, "/var/cache/xla"])
def test_compile_cache_dir(configured):
    env = {} if configured is None else {"JAX_COMPILATION_CACHE_DIR":
                                         configured}
    want = (ROOT / ".jax_cache" if configured is None else Path(configured))
    assert compile_cache.cache_dir(env) == want


def test_enable_compile_cache_points_jax_at_cache_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == ROOT / ".jax_cache"
        assert jax.config.jax_compilation_cache_dir == str(path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


# ---------------------------------------------------------- chip_smoke.py

@pytest.mark.parametrize("argv", [[], ["--four-gpus"]])
def test_chip_smoke_refuses_cpu(argv):
    with pytest.raises(SystemExit, match="JAX found no GPU"):
        cs.main(argv)


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """Copied into a directory with nothing else of the repository it
    exits non-zero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "radar_slam_tpu" in r.stderr


def test_dot_precisions_reads_the_jaxpr():
    def f(x):
        a = jnp.einsum("ij,jk->ik", x, x,
                       precision=jax.lax.Precision.HIGHEST)
        return jnp.fft.fft(a @ x).real
    got = cs.dot_precisions(f, jnp.ones((4, 4), jnp.complex64))
    assert got == {"dot_general": ["DEFAULT", "HIGHEST"], "fft": 1}


def test_compare_stages_at_tiny_size():
    """Two CPU devices run the same programs: every stage agrees exactly
    and reports its tolerance and precisions."""
    cpu0, cpu1 = jax.devices("cpu")[:2]
    res = cs.compare_stages(_tiny_cfg(), 4, cpu0, cpu1)
    assert res["ok"], res
    assert set(res["stages"]) == {
        "synth_cube", "rds_power", "detection", "signatures",
        "angles_beamforming", "angles_music", "angles_esprit", "solve",
        "poses"}
    assert res["stages"]["detection"]["detections"] > 0
    assert res["stages"]["synth_cube"]["precision"]["dot_general"] == [
        "HIGHEST"]
    assert res["stages"]["rds_power"]["precision"]["fft"] > 0


@pytest.mark.parametrize("phase,frames", [("batched_gates", 8),
                                          ("batched_long", 16),
                                          ("sequential_drivers", 16),
                                          ("rig_batched", 8)])
def test_main_path_phase_at_tiny_size(phase, frames):
    """Each main-path phase runs its drivers and reports finite metrics
    with first/steady/compile times (its accuracy gates are calibrated on
    the full-size config, so only their presence is checked here)."""
    res = getattr(cs, phase)(_tiny_cfg(), frames)
    assert isinstance(res["ok"], bool)
    assert res["frames"] == frames
    times = [v for k, v in res.items() if k.startswith("time")]
    assert times and all(t["steady_s"] > 0 and t["compile_s"] >= 0
                         for t in times)
    nums = [v for k, v in res.items()
            if isinstance(v, float) and not k.startswith("time")]
    assert nums and np.isfinite(nums).all()


def test_four_gpu_mesh_on_virtual_devices():
    """The --four-gpus path on a 4-device CPU mesh: the frame-parallel
    driver and the mesh solvers equal their single-device forms."""
    res = cs.four_gpu_mesh(_tiny_cfg(), frames=16, n=4)
    assert res["ok"], res["checks"]
    assert set(res["checks"]) == {"dp_pose_m", "dp_velocity_mps",
                                  "gn_cg_pose_m", "schur_pose_m",
                                  "solve_graphs_mesh_pose_m"}


def test_streaming_step_takes_a_fresh_state():
    """The frame step donates its state: a freshly initialized state must
    hold one buffer per field (the analyze CLI's streaming path)."""
    from radar_slam_tpu.pipeline import frame as pipe

    cfg = _tiny_cfg()
    batches, _ = cs.corridor(cfg, 2)
    state = pipe.init_state(cfg)
    for f in range(2):
        frame = jax.tree.map(lambda x: x[f], batches)
        state, out = pipe.process_scatterers(state, frame,
                                             jax.random.key(f), cfg)
    assert np.isfinite(np.asarray(out.pose)).all()
