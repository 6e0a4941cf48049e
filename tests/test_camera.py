"""Tests for camera models, triangulation, and the calibration parser."""

import numpy as np
import jax.numpy as jnp

from svi_mapper_tpu import config
from svi_mapper_tpu.geometry import se3, triangulation
from svi_mapper_tpu.geometry.camera import StereoCamera, pinhole_from_projection

# the reference's calibration files, shipped in hardware_parameters/
REF_HW = config.HARDWARE_PARAMETERS_DIR

# KITTI 00 rectified projection (public dataset calibration constants)
P_KITTI_L = np.array([[718.856, 0.0, 607.1928, 0.0],
                      [0.0, 718.856, 185.2157, 0.0],
                      [0.0, 0.0, 1.0, 0.0]])
P_KITTI_R = np.array([[718.856, 0.0, 607.1928, -386.1448],
                      [0.0, 718.856, 185.2157, 0.0],
                      [0.0, 0.0, 1.0, 0.0]])


def make_kitti_stereo():
    left = pinhole_from_projection(P_KITTI_L, 1241, 376)
    right = pinhole_from_projection(P_KITTI_R, 1241, 376)
    return StereoCamera(left=left, right=right)


def test_baseline():
    cam = make_kitti_stereo()
    assert np.isclose(float(cam.baseline), 386.1448 / 718.856, atol=1e-6)


def test_project_backproject_roundtrip(rng):
    cam = make_kitti_stereo().left
    p = np.stack(
        [rng.uniform(-10, 10, 256), rng.uniform(-5, 5, 256), rng.uniform(1, 80, 256)],
        axis=-1,
    ).astype(np.float32)
    uv = cam.project(jnp.asarray(p))
    p_rt = cam.back_project(uv, jnp.asarray(p[:, 2]))
    assert np.allclose(np.asarray(p_rt), p, atol=1e-3)


def test_stereo_invariants(rng):
    """Rectified-projection invariants the reference asserts
    (CTriangulator.cpp:24-31, triangulation_sampling.cpp:49-80):
    v_L == v_R, u_L > u_R, disparity = fx*b/z."""
    cam = make_kitti_stereo()
    p = np.stack(
        [rng.uniform(-10, 10, 256), rng.uniform(-5, 5, 256), rng.uniform(1, 80, 256)],
        axis=-1,
    ).astype(np.float32)
    uv_l, uv_r = cam.project_stereo(jnp.asarray(p))
    uv_l, uv_r = np.asarray(uv_l), np.asarray(uv_r)
    assert np.allclose(uv_l[:, 1], uv_r[:, 1], atol=1e-4)
    assert np.all(uv_l[:, 0] > uv_r[:, 0])
    d_expected = 386.1448 / p[:, 2]
    assert np.allclose(uv_l[:, 0] - uv_r[:, 0], d_expected, rtol=1e-4)


def test_triangulate_roundtrip(rng):
    cam = make_kitti_stereo()
    p = np.stack(
        [rng.uniform(-10, 10, 256), rng.uniform(-5, 5, 256), rng.uniform(1, 60, 256)],
        axis=-1,
    ).astype(np.float32)
    uv_l, uv_r = cam.project_stereo(jnp.asarray(p))
    p_rt = np.asarray(cam.triangulate(uv_l, uv_r))
    assert np.allclose(p_rt, p, rtol=2e-3, atol=2e-3)


def test_triangulate_dlt_roundtrip(rng):
    cam = make_kitti_stereo()
    p = np.stack(
        [rng.uniform(-10, 10, 128), rng.uniform(-5, 5, 128), rng.uniform(2, 50, 128)],
        axis=-1,
    ).astype(np.float32)
    uv_l, uv_r = cam.project_stereo(jnp.asarray(p))
    P_l = jnp.broadcast_to(cam.left.P, (128, 3, 4))
    P_r = jnp.broadcast_to(cam.right.P, (128, 3, 4))
    p_rt = np.asarray(triangulation.triangulate_dlt(P_l, P_r, uv_l, uv_r))
    assert np.allclose(p_rt, p, rtol=5e-3, atol=5e-3)


def test_epipolar_distance_zero_for_true_matches(rng):
    cam = make_kitti_stereo()
    # relative pose left->right for a rectified pair: pure x-translation
    T_lr = np.eye(4, dtype=np.float32)
    T_lr[0, 3] = -float(cam.baseline)
    F = triangulation.fundamental_from_relative(
        jnp.asarray(T_lr), cam.left.P[:, :3], cam.right.P[:, :3]
    )
    p = np.stack(
        [rng.uniform(-10, 10, 64), rng.uniform(-5, 5, 64), rng.uniform(2, 50, 64)],
        axis=-1,
    ).astype(np.float32)
    uv_l, uv_r = cam.project_stereo(jnp.asarray(p))
    d = np.asarray(triangulation.epipolar_distance(jnp.broadcast_to(F, (64, 3, 3)), uv_l, uv_r))
    assert np.all(d < 1e-2)


def test_fov_and_principal_weight():
    cam = make_kitti_stereo().left
    uv = jnp.asarray([[30.0, 30.0], [10.0, 100.0], [620.0, 180.0]])
    inside = np.asarray(cam.in_fov(uv))
    assert list(inside) == [True, False, True]
    w = np.asarray(cam.principal_weight(jnp.asarray([[607.1928 + 100.0, 185.2157]])))
    assert np.isclose(w[0, 0], np.sqrt(100.0) / 10.0)
    assert np.isclose(w[0, 1], 0.0)


def test_parse_reference_calibrations():
    """The reference hardware_parameters files must load unchanged
    (ref CParameterBase.h:169-392)."""
    cam = config.load_stereo_camera(
        REF_HW / "kitti_00_camera_left.txt", REF_HW / "kitti_00_camera_right.txt"
    )
    assert cam.width == 1241 and cam.height == 376
    assert np.isclose(float(cam.left.fx), 718.856)
    assert np.isclose(float(cam.baseline), 386.1448 / 718.856, atol=1e-6)

    vi = config.load_camera_calibration(REF_HW / "vi_sensor_camera_left.txt")
    assert vi.has_imu
    assert vi.width == 752 and vi.height == 480
    assert np.isclose(vi.K[0, 0], 468.2793078854663)
    assert np.isclose(np.linalg.norm(vi.q_cam_to_imu), 1.0, atol=1e-6)
    R = np.asarray(se3.quat_to_R(jnp.asarray(vi.q_cam_to_imu, jnp.float32)))
    assert np.allclose(R @ R.T, np.eye(3), atol=1e-6)


def test_shipped_calibrations_load_by_bare_name():
    """README quick-start regression: the three shipped rigs load by bare
    filename (resolved against hardware_parameters/) with the correct
    baselines (KITTI 00: P_right[0,3] = -386.1448 -> b = 0.537 m)."""
    from svi_mapper_tpu.config import load_stereo_camera

    cam = load_stereo_camera("kitti_00_camera_left.txt",
                             "kitti_00_camera_right.txt")
    assert abs(float(cam.baseline) - 0.5371657) < 1e-4
    assert abs(float(cam.left.fx) - 718.856) < 1e-2
    assert cam.left.width == 1241 and cam.left.height == 376

    cam2 = load_stereo_camera("kitti_11_12_camera_left.txt",
                              "kitti_11_12_camera_right.txt")
    assert abs(float(cam2.baseline) - 0.5371507) < 1e-4

    vi = load_stereo_camera("vi_sensor_camera_left.txt",
                            "vi_sensor_camera_right.txt")
    assert abs(float(vi.baseline) - 0.110170) < 1e-4
    # the VI rig carries IMU extrinsics (ref vi_sensor_camera_left.txt:17-23)
    from svi_mapper_tpu.config import load_camera_calibration
    calib = load_camera_calibration("vi_sensor_camera_left.txt")
    assert calib.has_imu
    assert abs(float(np.linalg.norm(calib.q_cam_to_imu)) - 1.0) < 1e-6
