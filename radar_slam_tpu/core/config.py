"""Typed configuration for the FMCW radar ego-motion framework.

One source of truth replacing the six duplicated ``radar_params`` dicts in the
reference (``src/radar_signal/dechirp.py:371-378``,
``src/angle_estimation/angle_estimation.py:396-400``,
``src/velocity_solver/velocity_solver.py:446-450``,
``scripts/run_ego_motion_pipeline.py:80-92``,
``results/ground_truth_comparison/radarscenes_complete_analysis.py:47-56``,
``scripts/simulate_raw.py:36-44``).

All configs are frozen dataclasses of Python scalars so they are hashable and
can be passed as static arguments to ``jax.jit``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

C_LIGHT = 299792458.0
# The reference uses c = 3e8 everywhere (e.g. simulate_raw.py:70); we keep
# that value by default so derived quantities (range resolution 0.15 m,
# wavelength 3.896 mm) match the reference's documented numbers exactly.
C_REF = 3.0e8


@dataclasses.dataclass(frozen=True)
class RadarConfig:
    """FMCW radar waveform + array parameters.

    Canonical defaults follow the reference operating point
    (``simulate_raw.py:36-44``): 77 GHz carrier, 1 GHz bandwidth, 40 us chirp,
    100 us PRI, 64 chirps, 8-element half-wavelength ULA, 10 MHz ADC.
    """

    fc: float = 77.0e9                 # carrier frequency [Hz]
    bandwidth: float = 1.0e9           # chirp bandwidth [Hz]
    chirp_duration: float = 40.0e-6    # chirp duration [s]
    pri: float = 100.0e-6              # pulse repetition interval [s]
    num_chirps: int = 64               # chirps per frame (slow time)
    num_antennas: int = 8              # azimuth (ULA) elements
    sampling_rate: float = 10.0e6      # ADC rate [Hz]
    noise_power: float = 0.01          # AWGN power added during synthesis
    antenna_spacing: Optional[float] = None  # None -> lambda/2
    c: float = C_REF                   # propagation speed [m/s]
    # Planar (URA) array: >1 adds an elevation axis of num_antennas_el rows
    # (total elements num_antennas * num_antennas_el, flattened row-major
    # [el, az] along the antenna axis everywhere).  The reference is ULA /
    # azimuth-only -- its "3-D" pipeline can never observe elevation or v_z
    # (ROADMAP item 4); a URA makes both observable.
    num_antennas_el: int = 1
    antenna_spacing_el: Optional[float] = None  # None -> lambda/2

    # ---- derived quantities (all Python floats; safe under jit tracing) ----
    @property
    def lambda_c(self) -> float:
        """Carrier wavelength [m] (simulate_raw.py:71)."""
        return self.c / self.fc

    @property
    def spacing(self) -> float:
        """Element spacing [m]; default half wavelength (simulate_raw.py:72)."""
        return self.antenna_spacing if self.antenna_spacing is not None else self.lambda_c / 2.0

    @property
    def spacing_el(self) -> float:
        """Elevation-row spacing [m]; default half wavelength."""
        return (self.antenna_spacing_el if self.antenna_spacing_el is not None
                else self.lambda_c / 2.0)

    @property
    def total_antennas(self) -> int:
        """Total array elements (num_antennas_el rows x num_antennas cols)."""
        return self.num_antennas * self.num_antennas_el

    @property
    def samples_per_chirp(self) -> int:
        """Fast-time samples per chirp (simulate_raw.py:75)."""
        return int(self.chirp_duration * self.sampling_rate)

    @property
    def chirp_rate(self) -> float:
        """Chirp slope k = B / T [Hz/s] (simulate_raw.py:76)."""
        return self.bandwidth / self.chirp_duration

    @property
    def range_resolution(self) -> float:
        """c / (2B) [m] (dechirp.py:67)."""
        return self.c / (2.0 * self.bandwidth)

    @property
    def velocity_resolution(self) -> float:
        """lambda / (2 N_c PRI) [m/s] (dechirp.py:68)."""
        return self.lambda_c / (2.0 * self.num_chirps * self.pri)

    @property
    def prf(self) -> float:
        """Pulse repetition frequency = 1/PRI [Hz].

        Note: the reference labels its Doppler axis with the ADC rate instead
        (dechirp.py:242, a unit bug); we use the physically correct PRF.
        """
        return 1.0 / self.pri

    @property
    def max_unambiguous_range(self) -> float:
        """Range spanned by the fast-time FFT [m]."""
        return self.range_resolution * self.samples_per_chirp

    @property
    def max_unambiguous_velocity(self) -> float:
        """+/- lambda / (4 PRI) [m/s]."""
        return self.lambda_c / (4.0 * self.pri)

    def validate(self) -> "RadarConfig":
        assert self.fc > 0 and self.bandwidth > 0
        assert self.samples_per_chirp > 0, "chirp_duration * sampling_rate must be >= 1"
        assert self.num_chirps >= 1 and self.num_antennas >= 2
        assert self.pri >= self.chirp_duration, "PRI must cover the chirp"
        return self


@dataclasses.dataclass(frozen=True)
class DetectionConfig:
    """Range-Doppler peak detection (static-shape CFAR / local-max top-K).

    Replaces the reference's dynamic peak lists
    (``dechirp.py:244-271``: 3x3 maximum_filter local maxima above a dB
    threshold, range-gated) with a fixed top-K detection set + validity mask.
    """

    threshold_db: float = -25.0        # complete-analysis operating point (:171)
    min_range: float = 1.0             # dechirp.py:218
    max_range: float = 200.0           # dechirp.py:219
    max_detections: int = 64           # static K (>= reference max_targets=50)
    neighborhood: int = 3              # local-max window (3x3, dechirp.py:251)
    # Cross-detection non-max suppression: drop any detection within this
    # many bins (Chebyshev) of a stronger one.  Kills range/Doppler sidelobe
    # duplicates of strong targets that survive the local-max filter; the
    # reference has no equivalent (its duplicate peaks flow downstream).
    nms_radius: int = 2
    guard_cells: int = 0               # CFAR guard band (0 = plain threshold)
    cfar_train_cells: int = 0          # >0 enables the CFAR offset threshold
    cfar_offset_db: float = 12.0       # CFAR threshold over local noise estimate
    # "ca" = cell-averaging over a 2-D training box; "os" = order-statistic
    # over a cross of 4*train cells (rank os_rank), robust to heterogeneous
    # clutter / dense multi-target scenes where CA's mean is dragged up by
    # neighbouring returns and masks weak targets (ROADMAP item 5; the
    # reference has only the fixed global threshold, dechirp.py:244-271).
    cfar_mode: str = "ca"
    os_rank: float = 0.75              # OS-CFAR order statistic quantile
    # >0 enables an EMA clutter map carried across frames by the scan/
    # streaming drivers: cells must exceed the background power map by
    # clutter_offset_db.  Suppresses persistent returns (direct coupling,
    # stationary clutter for a parked ego).  Warmup ~1/alpha frames.
    clutter_map_alpha: float = 0.0
    clutter_offset_db: float = 6.0


@dataclasses.dataclass(frozen=True)
class AoAConfig:
    """Angle-of-arrival estimation parameters.

    Mirrors ``AngleEstimator`` / ``RobustAngleEstimator`` settings
    (angle_estimation.py:30-60, robust_angle_estimation.py:30-86).
    """

    search_min_deg: float = -90.0
    search_max_deg: float = 90.0
    search_resolution_deg: float = 2.0   # complete-analysis point (:72); 0.5 in basic
    method: str = "beamforming"          # beamforming | music | esprit
    # Elevation search grid, used when RadarConfig.num_antennas_el > 1
    # (joint az-el spectrum over the URA).
    el_min_deg: float = -20.0
    el_max_deg: float = 20.0
    el_resolution_deg: float = 2.0
    num_sources: int = 1
    # Forward-backward averaging of the per-detection covariance before
    # MUSIC's eigendecomposition (R_fb = (R + J conj(R) J)/2).  For the
    # centro-symmetric ULA a pure steering vector satisfies
    # J conj(s) = e^{j phi} s, so the signal subspace is unchanged while
    # the noise contribution gets an extra effective snapshot -- the
    # textbook fix for the reference's rank-1 single-snapshot covariance
    # (angle_estimation.py:127; VERDICT r03 item 3).  NOTE: True is a
    # deliberate parity DEPARTURE -- the reference never FB-averages; set
    # False for bit-level reference behavior (docs/PARITY.md).
    music_fb: bool = True
    # Weighted multi-lag ESPRIT (estimators._multilag_slope): the lag-1
    # subarray correlation the reference's SVD+pinv reduces to (for a
    # rank-1 snapshot) discards most of the aperture; the |r_m|-weighted
    # multi-lag phase slope recovers it (e2e pos RMSE 0.331 -> 0.182, the
    # beamforming level; VERDICT r04 item 5).  Parity departure like
    # music_fb; False restores the reference-equivalent lag-1 estimate.
    esprit_weighted: bool = True
    # robust estimator:
    temporal_window: int = 3             # robust_angle_estimation.py:73 (ref default 5)
    confidence_threshold: float = 0.6    # complete-analysis :74
    smoothing_factor: float = 0.7        # robust_angle_estimation.py:46
    max_targets: int = 50                # top-K kept after power filter (:75)
    power_filter_db: float = -25.0       # robust_angle_estimation.py:363
    track_capacity: int = 256            # static slots for temporal smoother state
    # Tracks not updated for more than this many frames cannot match new
    # detections: range/Doppler bins are re-used by *different* physical
    # targets as the scene migrates, and blending their angles corrupts the
    # estimates.  (The reference never expires its per-bin deques,
    # robust_angle_estimation.py:289-296 -- a latent bug.)
    track_max_age: int = 2

    @property
    def num_grid_points(self) -> int:
        return int(round((self.search_max_deg - self.search_min_deg)
                         / self.search_resolution_deg)) + 1

    @property
    def num_el_grid_points(self) -> int:
        return int(round((self.el_max_deg - self.el_min_deg)
                         / self.el_resolution_deg)) + 1


@dataclasses.dataclass(frozen=True)
class VelocityConfig:
    """6-DoF velocity solve parameters.

    The reference's two-step differential-evolution search
    (velocity_solver.py:178-269, advanced_velocity_optimization.py:260-490)
    collapses into a closed-form regularized least-squares because the Doppler
    phase model phi_i = (4 pi dt / lambda) d_i . (v + w x r_i) is linear in
    (v, w) (velocity_solver.py:102-111).  ``mode`` selects the observable:

    - "doppler": per-target Doppler-bin radial velocities (coarse, unambiguous)
    - "phase":   temporal phase differences, unwrapped around the initial
                 guess, Gauss-Newton iterated (reference-equivalent observable,
                 velocity_solver_improved.py:150)
    - "fused":   doppler solve seeds the phase refinement (default)
    """

    mode: str = "fused"
    max_velocity: float = 30.0           # complete-analysis :82
    max_angular_velocity: float = 5.0    # complete-analysis :83
    regularization_weight: float = 0.01  # velocity_solver_improved.py:261-263
    z_velocity_weight: float = 10.0      # advanced_velocity_optimization.py:219
    temporal_weight: float = 0.1         # advanced_velocity_optimization.py:209
    huber_delta: float = 1.0             # IRLS robust loss scale [rad]
    gn_iterations: int = 8               # Gauss-Newton / IRLS iterations
    two_step: bool = True                # v-only solve then full 6-DoF (:178)
    association_gate: float = 5.0        # cartesian gate [m] (improved :45)
    min_targets: int = 3                 # velocity_solver.py:202
    # Huber scale [m/s] for the Doppler radial-velocity IRLS.  This is the
    # robustness knob that rejects detections on MOVING objects (their vr
    # contains the object's own motion -- the dominant real-data outlier
    # class the reference's confidence machinery contends with,
    # robust_angle_estimation.py:140-272).  Set very large to disable
    # (ablation: tests/test_adversarial.py shows recovery then fails).
    doppler_huber_mps: float = 0.5
    # Use the Doppler-bin radial velocities as solve rows.  Disable for data
    # whose Doppler axis is known-uninformative (the reference simulator's
    # no-ramp quirk folds every target into the zero-Doppler bin); the solve
    # then runs on apparent-velocity rows (which observe v AND omega) seeded
    # into the phase refinement.
    use_doppler_vr: bool = True
    # For a colocated sensor the radial observables satisfy d.(w x r) == 0
    # (r parallel to d), so the reference's 6-DoF model cannot observe w at
    # all -- its omega estimates are regularization artifacts.  The
    # transverse apparent velocity of associated targets DOES see rotation:
    # (pos_t - pos_{t-1})/dt ~= -(v + w x r).  These rows make yaw rate
    # observable; weight reflects the coarse position quantization.
    use_apparent_velocity: bool = True
    apparent_velocity_weight: float = 0.1
    # "mutual" = one-shot mutual-nearest-neighbour matching (parallel; the
    # default); "greedy" = the reference's power-ordered sequential claim
    # (velocity_solver_improved.py:100-126).
    association_method: str = "mutual"
    # Doppler-bin radial velocities are ambiguous modulo lambda/(2 PRI)
    # (~19.5 m/s at the reference PRI): ego speeds beyond ~9.7 m/s radial
    # alias.  When enabled the solver unwraps each target's vr to the alias
    # nearest a prediction from the previous motion (or, bootstrapping, the
    # unambiguous apparent-velocity initial guess).  The reference has no
    # equivalent -- its Doppler axis is mislabeled anyway (dechirp.py:242).
    dealias_doppler: bool = True


@dataclasses.dataclass(frozen=True)
class PoseConfig:
    """Pose integration parameters (pose_integration.py:23-66)."""

    integration_method: str = "trapezoidal"  # trapezoidal | euler
    smoothing: bool = False
    smoothing_window: int = 5
    planar: bool = False                     # True -> x,y,yaw Euler update
                                             # (complete-analysis :208-210)
    # When a frame's velocity solve fails (too few associations, dropped
    # frame), dead-reckon the pose with the previous motion estimate instead
    # of freezing it.  The reference freezes (worse: the complete-analysis
    # path copies the GT pose into the estimate, radarscenes_complete_
    # analysis.py:229-231); coasting keeps drift ~0 through short gaps under
    # smooth motion.  Frame 0 coasts with zero motion either way.
    coast_on_failure: bool = True


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end pipeline composition."""

    radar: RadarConfig = dataclasses.field(default_factory=RadarConfig)
    detection: DetectionConfig = dataclasses.field(default_factory=DetectionConfig)
    aoa: AoAConfig = dataclasses.field(default_factory=AoAConfig)
    velocity: VelocityConfig = dataclasses.field(default_factory=VelocityConfig)
    pose: PoseConfig = dataclasses.field(default_factory=PoseConfig)
    frame_duration_ms: float = 100.0         # loader frame window (loader :141)
    max_scatterers: int = 512                # static pad for scatterer batches
    chirp_subset: Optional[Tuple[int, int]] = None  # dechirp.py:183-187
    window: str = "hann"                     # fast-time window (dechirp.py:99)
    # Slow-time window: the reference windows fast time only, leaving -13 dB
    # Doppler sidelobes that duplicate strong targets; we window both axes.
    doppler_window: Optional[str] = "hann"
    # RDS transform: "fft" (XLA FFT), "matmul" (both DFTs as XLA matmuls
    # with dechirp/window/DC folded into the DFT matrices), or "fused"
    # (detection runs on the power map ``mean_a |rds|^2`` alone and spatial
    # signatures are recomputed at f32 for only the detected cells, so no
    # complex RDS cube is returned).  See signal/rds.py.
    fft_mode: str = "fft"
    dft_precision: str = "highest"       # matmul-mode DFT precision
    # Synthesis model used when the pipeline starts from scatterers:
    # "tpu" (physics-fixed, signal/synth.py module docstring; the name is
    # historical and does not refer to a device) or "reference"
    # (reproduces the reference simulator's quirks -- no slow-time Doppler
    # ramp, linspace time base; see synthesize_frame).  "reference" exists so
    # the solver can be validated against data generated by a model it does
    # NOT invert (anti-inverse-crime validation tier).
    synth_fidelity: str = "tpu"

    @property
    def frame_dt(self) -> float:
        return self.frame_duration_ms * 1e-3


def complete_analysis_config() -> PipelineConfig:
    """The reference's real end-to-end operating point
    (radarscenes_complete_analysis.py:47-87): 32 chirps, 2 deg grid,
    confidence 0.6, top-50 targets.

    Deviation (deliberate): the reference synthesizes with noise_power=0.01,
    which puts a typical mid-range scatterer (amplitude sqrt(rcs)/(4 pi R^2),
    simulate_raw.py:125-126) ~15 dB BELOW the post-2-D-FFT noise floor --
    its detections are noise bins and its velocity estimates ride on
    regularization (consistent with SURVEY.md section 6 provenance notes).
    Synthesis noise is a simulation choice, not a measurement; we default to
    1e-6 (~30 dB post-integration SNR, a realistic automotive radar regime).
    Pass RadarConfig(noise_power=0.01) explicitly for strict parity runs.

    Detection uses CA-CFAR (the reference's fixed -25 dB threshold admits
    the sidelobe skirts of strong close targets; measured on the synthetic
    corridor workload CFAR cuts velocity error from -1.6+-2.2 m/s to
    -0.015+-0.018 m/s).

    fft_mode="fused": detection runs on the power map and signatures are
    recomputed for only the detected cells (signal/rds.py:rds_power,
    detection_signatures)."""
    return PipelineConfig(
        radar=RadarConfig(num_chirps=32, noise_power=1e-6),
        detection=DetectionConfig(cfar_train_cells=8, guard_cells=2,
                                  cfar_offset_db=12.0),
        aoa=AoAConfig(search_resolution_deg=2.0, confidence_threshold=0.6,
                      max_targets=50, temporal_window=3,
                      track_capacity=64),
        velocity=VelocityConfig(max_velocity=30.0, max_angular_velocity=5.0,
                                regularization_weight=0.01),
        pose=PoseConfig(planar=True),
        fft_mode="fused",
    )


def reference_fidelity_config(noise_power: float = 1e-6) -> PipelineConfig:
    """Operating point for data synthesized with ``fidelity="reference"``
    (the adversarial anti-inverse-crime tier; VERDICT round-1 item 1).

    Reference-mode data has NO slow-time Doppler ramp (simulate_raw.py
    computes but never applies ``chirp_start_time``), so every target lands
    in the zero-Doppler bin and the Doppler-bin radial velocity reads ~0 --
    an observable the solver's model disagrees with.  The solve therefore
    runs on the observables that survive the mismatch:

    - ``use_doppler_vr=False``: the dead vr rows are dropped; the coarse
      solve runs on apparent-velocity rows at full weight (they observe v
      AND omega through the lever arm);
    - the temporal carrier-phase differences then refine v (exact in both
      models -- the range change between frames drives -4 pi dR / lambda
      regardless of the intra-frame Doppler quirk), exactly the reference's
      own structure of smart init + local refinement
      (velocity_solver_improved.py:268-323);
    - ``dealias_doppler=False``: unwrapping all-zero vr toward a prediction
      would fabricate +/-19.5 m/s quanta.

    OS-CFAR handles the crowded zero-Doppler column (every target shares it,
    so CA's training mean is dragged up by neighbours).

    Args:
        noise_power: synthesis AWGN power.  The reference's own 0.01 puts
            mid-range scatterers below the post-FFT noise floor (see
            complete_analysis_config); pass 0.01 for the strict
            graceful-degradation test, keep 1e-6 to test the structural
            model mismatch at realistic SNR.
    """
    return PipelineConfig(
        radar=RadarConfig(num_chirps=32, noise_power=noise_power),
        detection=DetectionConfig(cfar_train_cells=8, guard_cells=2,
                                  cfar_offset_db=12.0, cfar_mode="os"),
        aoa=AoAConfig(search_resolution_deg=2.0, confidence_threshold=0.6,
                      max_targets=50, temporal_window=3, track_capacity=64),
        velocity=VelocityConfig(use_doppler_vr=False, dealias_doppler=False,
                                apparent_velocity_weight=1.0),
        pose=PoseConfig(planar=True),
        synth_fidelity="reference",
    )


def default_config() -> PipelineConfig:
    """Paper-faithful default (64 chirps, 0.5 deg grid) as in
    run_ego_motion_pipeline.py:80-92 (noise: see complete_analysis_config)."""
    return PipelineConfig(
        radar=RadarConfig(num_chirps=64, noise_power=1e-6),
        detection=DetectionConfig(cfar_train_cells=8, guard_cells=2,
                                  cfar_offset_db=12.0),
        aoa=AoAConfig(search_resolution_deg=0.5),
    )
