"""Multi-sequence sharded batch: pipeline + pose-graph GN per sequence,
sequences partitioned over the 8-device mesh."""

import jax
import numpy as np
import pytest

from radar_slam_tpu.core.config import (AoAConfig, DetectionConfig,
                                        PipelineConfig, RadarConfig,
                                        VelocityConfig)
from radar_slam_tpu.io.synthetic import SceneConfig, constant_motion_scene
from radar_slam_tpu.parallel import multiseq
from radar_slam_tpu.parallel.mesh import make_mesh

CFG = PipelineConfig(
    radar=RadarConfig(noise_power=1e-6, num_chirps=16,
                      chirp_duration=12.8e-6),   # 128 samples: fast test
    detection=DetectionConfig(cfar_train_cells=6, guard_cells=2,
                              cfar_offset_db=12.0, max_detections=24,
                              max_range=60.0),
    aoa=AoAConfig(search_resolution_deg=3.0, confidence_threshold=0.5,
                  max_targets=24, track_capacity=64),
    velocity=VelocityConfig(),
    max_scatterers=128,
)


@pytest.mark.slow
def test_multiseq_sharded(eight_devices):
    M, F = 8, 8
    # Stay under the unambiguous radial velocity lambda/(4 PRI) = 9.74 m/s.
    vels = [(3.0 + 0.5 * m, 0.0) for m in range(M)]
    seqs, gts = [], []
    for m in range(M):
        b, gt = constant_motion_scene(
            100 + m, num_frames=F, dt=CFG.frame_dt, v_body=vels[m],
            yaw_rate=0.0,
            scene=SceneConfig(num_points=48, max_range=18.0, min_range=3.0,
                              max_scatterers=CFG.max_scatterers))
        seqs.append(b)
        gts.append(gt)
    batch = jax.tree.map(lambda *xs: jax.numpy.stack(xs), *seqs)
    keys = jax.random.split(jax.random.key(0), M)

    mesh = make_mesh(8, axis_name="s")
    out, poses, costs = multiseq.process_sequences_sharded(
        batch, keys, CFG, mesh)

    assert poses.shape == (M, F + 1, 3)
    v = np.asarray(out.motion.velocity)          # [M, F, 3]
    ok = np.asarray(out.motion.success)
    # Each sequence recovers its own commanded speed.
    recovered = 0
    for m in range(M):
        if ok[m, 1:].mean() > 0.5:
            vm = v[m, 1:][ok[m, 1:]][:, 0].mean()
            if abs(vm - vels[m][0]) < 0.5:
                recovered += 1
    assert recovered >= 6, (recovered,
                            [v[m, 1:, 0].mean() for m in range(M)])
    # Refined pose endpoints track the open-loop distance per sequence.
    for m in range(M):
        if ok[m, 1:].mean() > 0.5:
            d = np.linalg.norm(np.asarray(poses)[m, -1, :2])
            expect = vels[m][0] * CFG.frame_dt * F
            assert abs(d - expect) < 1.0, (m, d, expect)


def _loopy_graphs(M=4, n=16, drift=0.06):
    """Stacked noisy chains [M] with one ACTIVE loop closure each."""
    from radar_slam_tpu.parallel import posegraph
    import jax.numpy as jnp

    graphs = []
    for m in range(M):
        rng = np.random.default_rng(20 + m)
        v = np.tile(np.array([5.0, 0.0, 0.0]), (n - 1, 1)).astype(np.float32)
        wz = np.full(n - 1, 0.1, np.float32)
        g = posegraph.from_velocities(
            jnp.asarray(v), jnp.asarray(wz), jnp.ones(n - 1, bool), dt=0.1,
            loop_capacity=1)
        noisy = np.asarray(g.poses) + rng.normal(0, drift, (n, 3))
        g = g._replace(poses=jnp.asarray(noisy.astype(np.float32)))
        g = posegraph.add_loop_closure(
            g, slot=0, i=1 + m, j=12 + (m % 3),
            delta=jnp.asarray(rng.normal(0, 0.2, 3).astype(np.float32)),
            info=jnp.array([5e3, 5e3, 5e3]))
        graphs.append(g)
    return jax.tree.map(lambda *xs: jax.numpy.stack(xs), *graphs), graphs


def test_multiseq_mesh_schur_matches_single_device_gn(eight_devices):
    """Config-5 composition (VERDICT round-2 item 7): 4 sequences with
    ACTIVE loop closures scanned through the full-mesh distributed Schur
    solver must match each sequence's single-device GN solution."""
    from radar_slam_tpu.parallel import ba

    batch, graphs = _loopy_graphs(M=4, n=16)
    mesh = make_mesh(8, axis_name="f")
    poses, costs = multiseq.solve_graphs_mesh(batch, mesh, steps=10)

    for m, g in enumerate(graphs):
        ref, c_ref = ba.gauss_newton_cg(g, mesh=None, gn_iters=10,
                                        cg_iters=60)
        np.testing.assert_allclose(np.asarray(poses)[m], np.asarray(ref),
                                   atol=5e-3)
        assert float(costs[m]) <= 1.05 * float(c_ref) + 1e-6


@pytest.mark.slow
def test_multiseq_schur_end_to_end(eight_devices):
    """Pipeline phase sequence-sharded, solve phase through the full-mesh
    Schur solver, in one jitted program; endpoints track commanded motion."""
    M, F = 8, 7                     # F + 1 = 8 poses = mesh size
    vels = [(3.0 + 0.4 * m, 0.0) for m in range(M)]
    seqs = []
    for m in range(M):
        b, _ = constant_motion_scene(
            100 + m, num_frames=F, dt=CFG.frame_dt, v_body=vels[m],
            yaw_rate=0.0,
            scene=SceneConfig(num_points=48, max_range=18.0, min_range=3.0,
                              max_scatterers=CFG.max_scatterers))
        seqs.append(b)
    batch = jax.tree.map(lambda *xs: jax.numpy.stack(xs), *seqs)
    keys = jax.random.split(jax.random.key(0), M)

    mesh = make_mesh(8, axis_name="s")
    out, poses, costs = multiseq.process_sequences_schur(
        batch, keys, CFG, mesh)
    assert poses.shape == (M, F + 1, 3)
    ok = np.asarray(out.motion.success)
    good = 0
    for m in range(M):
        if ok[m, 1:].mean() > 0.5:
            d = np.linalg.norm(np.asarray(poses)[m, -1, :2])
            expect = vels[m][0] * CFG.frame_dt * F
            if abs(d - expect) < 1.0:
                good += 1
    assert good >= 6, good


@pytest.mark.slow
def test_refine_sequences_mesh_round_trip(eight_devices):
    """Config-5 loop-closure ROUND TRIP (VERDICT r03 item 5): a batch of
    drifted circle sequences through retrieval -> slot fill -> full-mesh
    Schur re-solve must accept loops and beat the open-loop endpoint
    error per sequence.

    The scenes are the calibrated loop-closure scenario
    (io/synthetic.py:circle_scene + odometric bias -- the same drift
    model the scan-context characterization tier pins down); they enter
    through refine_sequences_mesh's ``out=`` injection so the test
    isolates the retrieve -> fill -> mesh-solve composition the r03
    docstring left as prose.  The pipeline phase of the same function is
    covered by test_multiseq_schur_end_to_end."""
    import jax.numpy as jnp

    from radar_slam_tpu.core.types import MotionEstimate
    from radar_slam_tpu.parallel import posegraph
    from radar_slam_tpu.parallel.loopclosure import LoopClosureConfig
    from radar_slam_tpu.io.synthetic import circle_scene
    from radar_slam_tpu.pipeline.frame import FrameOutput

    M, F = 2, 95                    # F + 1 = 96 poses over the 8-mesh
    v_true, w_true, dt = 6.0, 0.7, CFG.frame_dt
    outs, gts = [], []
    for m in range(M):
        gt_poses, pts, msk = circle_scene(n_frames=F, v=v_true, w=w_true,
                                          dt=dt, seed=5 + m)
        gts.append(gt_poses)
        # Odometry with a velocity-scale + yaw-rate bias: the classic
        # drift loop closure exists to fix (~matching the scan-context
        # characterization drift scenes).
        vel = np.tile([v_true * 1.03, 0.0, 0.0], (F, 1)).astype(np.float32)
        wz = np.full(F, w_true + 0.03, np.float32)
        zf = jnp.zeros(F, jnp.float32)
        motion = MotionEstimate(
            velocity=jnp.asarray(vel),
            angular_velocity=jnp.stack([zf, zf, jnp.asarray(wz)], axis=-1),
            rmse=zf, max_residual=zf,
            num_targets=jnp.zeros(F, jnp.int32),
            success=jnp.ones(F, bool), cost=zf)
        outs.append(FrameOutput(
            motion=motion, pose=jnp.zeros((F, 3), jnp.float32),
            num_detections=jnp.zeros(F, jnp.int32),
            num_reliable=jnp.zeros(F, jnp.int32),
            num_associations=jnp.zeros(F, jnp.int32),
            target_xy=pts, target_valid=msk))
    out = jax.tree.map(lambda *xs: jax.numpy.stack(xs), *outs)

    mesh = make_mesh(8, axis_name="s")
    _, poses, costs, loops = multiseq.refine_sequences_mesh(
        None, None, CFG, mesh, steps=10, loop_capacity=4,
        lc_cfg=LoopClosureConfig(revisit_radius=5.0, min_separation=40),
        proposer="scancontext", out=out)

    for m in range(M):
        open_g = posegraph.from_velocities(
            out.motion.velocity[m], out.motion.angular_velocity[m, :, 2],
            out.motion.success[m], dt)
        gt_end = gts[m][-1, :2]
        open_err = np.linalg.norm(np.asarray(open_g.poses)[-2, :2] - gt_end)
        ref_err = np.linalg.norm(np.asarray(poses)[m, -2, :2] - gt_end)
        assert len(loops[m]) >= 1, f"sequence {m}: no loop accepted"
        assert open_err > 1.5, (m, open_err)     # the bias really drifts
        assert ref_err < 0.6 * open_err, (m, ref_err, open_err)
