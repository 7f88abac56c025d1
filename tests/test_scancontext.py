"""Scan-context loop-closure retrieval tests.

The descriptor proposer's selling point vs the pose-gated one
(``loopclosure.find_loop_closures``): retrieval must survive odometric
drift larger than the revisit gate.  Also pins the FFT shift-search against
a brute-force reference and the shift->yaw sign convention against
explicitly rotated clouds.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from radar_slam_tpu.io.synthetic import circle_scene
from radar_slam_tpu.parallel import slam
from radar_slam_tpu.parallel.loopclosure import (LoopClosureConfig,
                                                 find_loop_closures)
from radar_slam_tpu.parallel.scancontext import (ScanContextConfig,
                                                 build_descriptors,
                                                 find_loop_closures_sc,
                                                 propose_candidates,
                                                 ring_keys, sc_correlate,
                                                 shift_to_yaw)


def test_fft_correlation_matches_bruteforce():
    rng = np.random.default_rng(3)
    a = jnp.asarray(rng.uniform(0, 2, (16, 48)).astype(np.float32))
    b = jnp.asarray(rng.uniform(0, 2, (16, 48)).astype(np.float32))

    def unit_cols(d):
        return d / np.maximum(np.linalg.norm(d, axis=0, keepdims=True), 1e-9)

    an, bn = unit_cols(np.asarray(a)), unit_cols(np.asarray(b))
    brute = np.array([np.sum(an * np.roll(bn, -n, axis=1)) / 48
                      for n in range(48)])
    sim, shift = sc_correlate(a, b)
    assert abs(float(sim) - brute.max()) < 1e-5
    assert int(shift) == int(brute.argmax())


def test_rotation_invariance_and_yaw_sign():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-30, 30, (80, 2)).astype(np.float32)
    cfg = ScanContextConfig()
    for dpsi in [0.7, -1.1, 2.4]:
        # Frame i at yaw 0, frame j at yaw dpsi, same position:
        # body azimuths in j are those in i minus dpsi.
        c, s = np.cos(dpsi), np.sin(dpsi)
        pts_j = (pts @ np.array([[c, s], [-s, c]]).T).astype(np.float32)
        d = build_descriptors(jnp.asarray(np.stack([pts, pts_j])),
                              jnp.ones((2, 80), bool), cfg)
        sim, shift = sc_correlate(d[0], d[1])
        assert float(sim) > 0.4, dpsi
        yaw = float(shift_to_yaw(shift, cfg.n_sectors))
        err = np.arctan2(np.sin(yaw - dpsi), np.cos(yaw - dpsi))
        # Within one sector of the truth.
        assert abs(err) < 2 * np.pi / cfg.n_sectors + 1e-6, (dpsi, yaw)
        # Ring keys are rotation invariant.
        k = np.asarray(ring_keys(d))
        np.testing.assert_allclose(k[0] @ k[1], 1.0, atol=0.02)


def test_retrieval_is_temporally_gated():
    """Consecutive (near-identical) frames must not propose each other."""
    _, pts, msk = circle_scene(n_frames=30)
    desc = build_descriptors(pts, msk, ScanContextConfig())
    cands = propose_candidates(desc, ScanContextConfig(min_separation=40))
    assert cands == []


@pytest.mark.slow
def test_scancontext_survives_drift_where_pose_gate_fails():
    """Odometry drift larger than the revisit gate: the pose-gated proposer
    finds nothing, scan-context retrieval still closes the loop and the
    refined endpoint error drops."""
    poses, pts, msk = circle_scene()
    n = len(poses)
    dt = 0.1
    rng = np.random.default_rng(7)
    vel = np.tile([6.0, 0.0, 0.0], (n, 1)) + rng.normal(0, 0.1, (n, 3))
    vel[:, 2] = 0.0
    # Yaw-rate bias: the estimated heading sweeps < 2pi where the true
    # trajectory closes the circle, so the estimated endpoint lands ~7 m
    # from the start -- outside the revisit gate.  (A speed bias would not
    # do it: it rescales the estimated circle but still closes it.)
    wz = np.full(n, 0.7 - 0.1) + rng.normal(0, 0.01, n)
    lc = LoopClosureConfig(revisit_radius=5.0, min_separation=40,
                           max_rmse=0.5)

    res_pose = slam.refine_trajectory(vel, wz, np.ones(n, bool), dt,
                                      frame_points=pts, frame_valid=msk,
                                      lc_cfg=lc, proposer="pose")
    assert not res_pose["loop_closures"], \
        "drift should defeat the pose-gated proposer in this scene"

    res_sc = slam.refine_trajectory(vel, wz, np.ones(n, bool), dt,
                                    frame_points=pts, frame_valid=msk,
                                    lc_cfg=lc, proposer="scancontext")
    assert res_sc["loop_closures"], "scan context should still retrieve"
    lc0 = res_sc["loop_closures"][0]
    assert lc0["j"] - lc0["i"] > 40
    open_err = np.linalg.norm(res_sc["open_loop_poses"][:n, :2]
                              - poses[:, :2], axis=1)
    ref_err = np.linalg.norm(res_sc["poses"][:n, :2] - poses[:, :2], axis=1)
    assert ref_err[-1] < 0.6 * open_err[-1], (open_err[-1], ref_err[-1])


def test_sc_matches_pose_gate_on_mild_drift():
    """On the easy scene both proposers accept a loop and refine similarly."""
    poses, pts, msk = circle_scene()
    n = len(poses)
    rng = np.random.default_rng(5)
    vel = np.tile([6.0, 0.0, 0.0], (n, 1)) + rng.normal(0, 0.15, (n, 3))
    vel[:, 0] += 0.25
    vel[:, 2] = 0.0
    wz = np.full(n, 0.7) + rng.normal(0, 0.01, n)
    lc = LoopClosureConfig(revisit_radius=6.0, min_separation=40,
                           max_rmse=0.5)
    res = {p: slam.refine_trajectory(vel, wz, np.ones(n, bool), 0.1,
                                     frame_points=pts, frame_valid=msk,
                                     lc_cfg=lc, proposer=p)
           for p in ("pose", "scancontext")}
    for p, r in res.items():
        assert r["loop_closures"], p
    e = {p: np.linalg.norm(r["poses"][:n, :2] - poses[:, :2], axis=1).max()
         for p, r in res.items()}
    assert abs(e["pose"] - e["scancontext"]) < 0.5, e


def test_stage1_tiled_matches_dense_exactly():
    """The streaming tiled top-M (city-scale stage 1) is EXACT: identical
    values and indices to the dense [F, F] path, including the temporal
    mask, short tails (F not a tile multiple) and queries with fewer than
    top_m admissible candidates."""
    from radar_slam_tpu.parallel.scancontext import (_stage1_candidates,
                                                     _stage1_candidates_tiled)
    rng = np.random.default_rng(0)
    for F, tile, min_sep, top_m in [(97, 16, 20, 4), (256, 64, 5, 8),
                                    (33, 64, 10, 3), (130, 128, 128, 4)]:
        raw = rng.uniform(0.0, 1.0, (F, 16)).astype(np.float32)
        keys = jnp.asarray(raw / np.linalg.norm(raw, axis=1, keepdims=True))
        dv, di = _stage1_candidates(keys, top_m, min_sep)
        tv, ti = _stage1_candidates_tiled(keys, top_m, min_sep, tile)
        # Padded tile shapes give XLA different matmul tilings -> <=1 ulp
        # value wobble; the SELECTION (indices) must be identical.
        fin = np.isfinite(np.asarray(dv))
        np.testing.assert_array_equal(fin, np.isfinite(np.asarray(tv)))
        np.testing.assert_allclose(np.asarray(dv)[fin], np.asarray(tv)[fin],
                                   rtol=0, atol=5e-7, err_msg=f"F={F}")
        np.testing.assert_array_equal(np.asarray(di)[fin],
                                      np.asarray(ti)[fin],
                                      err_msg=f"F={F}")


def test_propose_candidates_tiled_path_matches_dense():
    """End-to-end propose_candidates agrees whichever stage-1 path runs."""
    import dataclasses as dc
    from radar_slam_tpu.parallel.scancontext import (ScanContextConfig,
                                                     build_descriptors,
                                                     propose_candidates)
    poses, pts, msk = circle_scene()
    sc_dense = ScanContextConfig(min_separation=40)
    sc_tiled = dc.replace(sc_dense, stage1_dense_limit=8, stage1_tile=16)
    desc = build_descriptors(jnp.asarray(pts), jnp.asarray(msk), sc_dense)
    a = propose_candidates(np.asarray(desc), sc_dense)
    b = propose_candidates(np.asarray(desc), sc_tiled)
    assert a == b and a, (a, b)
