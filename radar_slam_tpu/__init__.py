"""radar_slam_tpu: multi-channel FMCW radar ego-motion framework.

A from-scratch JAX / XLA re-design of the capabilities of the
reference implementation ``zaidcontractor/radar-slam`` (see SURVEY.md):

- ``core``      typed config, geometry, static-shape pytree types
- ``signal``    FMCW synthesis, dechirp + range-Doppler FFT, CFAR detection
- ``aoa``       beamforming / MUSIC / ESPRIT + robust confidence + smoothing
- ``motion``    cross-frame association, closed-form 6-DoF velocity, pose scan
- ``evaluate``  velocity metrics, Umeyama alignment, APE / RTE
- ``pipeline``  end-to-end per-frame step, artifact pipeline, streaming runtime
- ``parallel``  device meshes, frame-parallel SPMD, distributed pose-graph GN
- ``io``        RadarScenes ingest, synthetic scenes, artifact schema
- ``ops``       window functions
- ``utils``     profiling, logging, checkpointing
- ``viz``       host-side plotting / analysis
"""

__version__ = "0.1.0"

from radar_slam_tpu.core.config import (AoAConfig, DetectionConfig,
                                        PipelineConfig, PoseConfig,
                                        RadarConfig, VelocityConfig,
                                        complete_analysis_config,
                                        default_config)

__all__ = [
    "AoAConfig", "DetectionConfig", "PipelineConfig", "PoseConfig",
    "RadarConfig", "VelocityConfig", "complete_analysis_config",
    "default_config", "__version__",
]
