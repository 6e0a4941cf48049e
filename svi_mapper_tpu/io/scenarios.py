"""The generated scenarios that ``bench.py`` and ``chip_smoke.py`` run.

* the KITTI-width loop: a 26 m-radius circle at KITTI-like per-frame motion
  (0.79 m + 1.7 deg of yaw per frame; KITTI 00 averages ~0.8 m/frame) whose
  revisit fires closure, pose graph and BA;
* its stereo-inertial stream: 10 IMU samples per frame (200 Hz : 20 fps);
* the production BA window: 32 keyframes x 4096 landmarks.

Everything is made from fixed seeds, so every run sees the same data.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from svi_mapper_tpu.config import DEFAULT_PARAMS, TrackingParams
from svi_mapper_tpu.io.synthetic import (SyntheticSequence, default_camera,
                                         loop_trajectory)

KITTI_WIDTH, KITTI_HEIGHT = 1241, 376
LOOP_RADIUS_M = 26.0
# frames per lap of the full 208-frame loop (its default 1.15-lap fit)
FRAMES_PER_LOOP = 181
IMU_SUBSAMPLES, FRAME_DT_S = 10, 0.05


def loop_sequence(n_frames: int = 208, width: int = KITTI_WIDTH,
                  height: int = KITTI_HEIGHT,
                  radius: float = LOOP_RADIUS_M) -> SyntheticSequence:
    """The loop. Tighter loops yaw too fast for any tracker at KITTI
    resolution (50+ px/frame feature shifts), so runs shorter than a lap
    keep the full loop's per-frame motion instead of fitting 1.15 laps."""
    seq = SyntheticSequence(n_frames=n_frames, width=width, height=height,
                            trajectory="loop", loop_radius=radius)
    if n_frames < FRAMES_PER_LOOP:
        seq.poses_wc = loop_trajectory(n_frames, radius,
                                       frames_per_loop=FRAMES_PER_LOOP)
    return seq


def loop_params(n_landmarks: int = 1024) -> TrackingParams:
    return dataclasses.replace(
        DEFAULT_PARAMS, max_landmarks=n_landmarks,
        max_detections=n_landmarks,
        keyframe_translation_m2=4.0, keyframe_rotation_rad2=0.02,
        # the circular world turns continuously (0.035 rad + 0.9 m per
        # frame -> motion scaling ~1.8 every frame); the reference's
        # KITTI-calibrated optimization veto of 1.5 (CTrackerSV.h:72)
        # assumes straight stretches (~1.4) between turns and would block
        # the entire back-end here, so the scenario raises the bound — the
        # veto itself stays unit-tested in tests/test_closure_queue.py
        max_motion_scaling_for_optimization=2.5,
    )


def loop_imu(seq: SyntheticSequence, n_frames: int):
    """(calibration, dts, omega, accel): per-frame IMU sample blocks for
    ``StereoInertialTracker.process_many_imu``, synthesized from the
    ground truth with small gyro/accelerometer noise."""
    from svi_mapper_tpu.imu import interpolator as imu

    sub, dt = IMU_SUBSAMPLES, FRAME_DT_S
    calib = imu.ImuCalibration(
        R_imu_to_world=np.eye(3), bias_gyro=np.zeros(3),
        bias_accel=np.zeros(3), noise_gyro=np.zeros(3),
        noise_accel=np.zeros(3), n_samples=200)
    omega, accel = imu.synthesize_measurements(
        seq.poses_wc, dt, calib=calib, noise_gyro=0.001, noise_accel=0.02)
    up = np.array([0.0, -1.0, 0.0])
    dts = [np.full(1 if i == 0 else sub, dt if i == 0 else dt / sub,
                   np.float32) for i in range(n_frames)]
    oms = [np.zeros((1, 3), np.float32) if i == 0
           else np.tile(omega[i - 1], (sub, 1)).astype(np.float32)
           for i in range(n_frames)]
    acs = [(up * imu.GRAVITY)[None].astype(np.float32) if i == 0
           else np.tile(accel[i - 1], (sub, 1)).astype(np.float32)
           for i in range(n_frames)]
    return calib, dts, oms, acs


def ba_window(K: int = 32, n_points: int = 4096, width: int = KITTI_WIDTH,
              height: int = KITTI_HEIGHT, seed: int = 3):
    """(cam, (T_wc, X0, obs, mask, fix)): forward motion over ``K``
    keyframes, noisy stereo observations (0.5 px), points perturbed by
    0.2 m so LM has real work every iteration, first pose fixed."""
    cam = default_camera(width, height)
    rng = np.random.default_rng(seed)
    X = rng.uniform([-20, -2, 5], [20, 2, 60], (n_points, 3)).astype(
        np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    T[:, 2, 3] = -np.arange(K, dtype=np.float32) * 1.0   # forward motion
    fx, cx, cy = float(cam.left.fx), float(cam.left.cx), float(cam.left.cy)
    bq = float(cam.right.P[0, 3])
    p_c = np.einsum("kij,lj->kli", T[:, :3, :3], X) + T[:, None, :3, 3]
    z = p_c[..., 2]
    u_l = fx * p_c[..., 0] / z + cx
    v_l = fx * p_c[..., 1] / z + cy
    u_r = (fx * p_c[..., 0] + bq) / z + cx
    obs = (np.stack([u_l, v_l, u_r, v_l], -1)
           + rng.normal(0, 0.5, (K, n_points, 4))).astype(np.float32)
    mask = (z > 1.0) & (u_l > 0) & (u_l < width) & (v_l > 0) & (v_l < height)
    X0 = X + rng.normal(0, 0.2, X.shape).astype(np.float32)
    fix = np.zeros(K, bool)
    fix[0] = True
    return cam, (T, X0, obs, mask, fix)
