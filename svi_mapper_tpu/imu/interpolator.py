"""IMU calibration, filtering, and pose-prior integration.

JAX replacement for ``CIMUInterpolator`` (CIMUInterpolator.h:7,
.cpp:29-105): startup calibration alternates gravity-direction alignment
(``calibrateRotation``) and bias estimation (``calibrateOffsets``) over a
static measurement buffer until convergence 1e-3; runtime statics provide
threshold filters that zero sub-noise components (angular-velocity
imprecision 0.01 rad/s, acceleration imprecision 0.5 m/s^2,
CIMUInterpolator.h:36-41) and the IMU pose prior used by the SVI tracker
(rotation overwritten by integrated gyro, translation by 1/2 a dt^2,
CTrackerSVI.cpp:356-364, damped when dt > 0.11 s :377-398).

The calibration math runs as batched jnp reductions over the whole buffer
(the reference loops measurement-by-measurement).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from svi_mapper_tpu.geometry import se3

# reference constants (CIMUInterpolator.h:36-41)
GRAVITY = 9.80665
IMPRECISION_OMEGA = 0.01      # rad/s — zero smaller angular rates
IMPRECISION_ACCEL = 0.5       # m/s^2 — zero smaller linear accelerations
MAX_DT_SECONDS = 0.11         # damped fallback beyond this gap (CTrackerSVI.cpp:377)
CALIBRATION_CONVERGENCE = 1e-3  # (CIMUInterpolator.cpp:29-45)


@dataclasses.dataclass(frozen=True)
class ImuCalibration:
    """Result of the static startup calibration."""

    R_imu_to_world: np.ndarray   # [3,3] gravity-aligned orientation
    bias_gyro: np.ndarray        # [3] rad/s
    bias_accel: np.ndarray       # [3] m/s^2 (gravity removed)
    noise_gyro: np.ndarray       # [3] std dev
    noise_accel: np.ndarray      # [3] std dev
    n_samples: int


def calibrate(
    omega: np.ndarray,           # [N,3] angular velocities (static period)
    accel: np.ndarray,           # [N,3] specific-force measurements
    max_iterations: int = 20,
    convergence: float = CALIBRATION_CONVERGENCE,
) -> ImuCalibration:
    """Alternate gravity alignment and bias estimation until convergence
    (the calibrateRotation/calibrateOffsets loop, CIMUInterpolator.cpp:29-105).

    During the static period the mean specific force equals -g in IMU
    coordinates; R_imu_to_world rotates it onto the world 'up' axis
    (0, -1, 0) — the y-down camera/world convention of the pipeline.
    """
    omega = jnp.asarray(omega, jnp.float32)
    accel = jnp.asarray(accel, jnp.float32)
    up = jnp.asarray([0.0, -1.0, 0.0], jnp.float32)   # world up (y down)

    R = jnp.eye(3, dtype=jnp.float32)
    bias_a = jnp.zeros(3, jnp.float32)
    for _ in range(max_iterations):
        # gravity direction estimate from bias-corrected mean
        mean_a = jnp.mean(accel, axis=0) - bias_a
        g_dir = mean_a / jnp.maximum(jnp.linalg.norm(mean_a), 1e-9)
        # rotation bringing measured gravity onto world up (axis-angle)
        target = up
        axis = jnp.cross(g_dir, target)
        s = jnp.linalg.norm(axis)
        c = jnp.dot(g_dir, target)
        angle = jnp.arctan2(s, c)
        axis = jnp.where(s > 1e-9, axis / jnp.maximum(s, 1e-9), jnp.asarray([1.0, 0.0, 0.0]))
        R_new = se3.exp_so3(axis * angle)
        # bias = residual after removing rotated gravity
        g_world = up * GRAVITY
        bias_new = jnp.mean(accel, axis=0) - R_new.T @ g_world
        delta = jnp.maximum(
            jnp.max(jnp.abs(R_new - R)), jnp.max(jnp.abs(bias_new - bias_a))
        )
        R, bias_a = R_new, bias_new
        if float(delta) < convergence:
            break

    bias_g = jnp.mean(omega, axis=0)
    return ImuCalibration(
        R_imu_to_world=np.asarray(R),
        bias_gyro=np.asarray(bias_g),
        bias_accel=np.asarray(bias_a),
        noise_gyro=np.asarray(jnp.std(omega, axis=0)),
        noise_accel=np.asarray(jnp.std(accel, axis=0)),
        n_samples=int(omega.shape[0]),
    )


def threshold_filter(v: jax.Array, imprecision: float) -> jax.Array:
    """Zero components below the sensor imprecision
    (ref CIMUInterpolator.h:36-41 static filters)."""
    return jnp.where(jnp.abs(v) > imprecision, v, 0.0)


def gravity_filtered_accel(
    accel_imu: jax.Array,        # [3] raw specific force in IMU frame
    R_wc: jax.Array,             # [3,3] world->camera rotation (camera==IMU here)
    bias_accel: jax.Array,
) -> jax.Array:
    """Linear acceleration in the camera frame with gravity removed
    (ref CTrackerSVI.cpp:586-596)."""
    up = jnp.asarray([0.0, -1.0, 0.0], accel_imu.dtype)
    g_cam = R_wc @ (up * GRAVITY)
    a = accel_imu - bias_accel - g_cam
    return threshold_filter(a, IMPRECISION_ACCEL)


def integrate_prior(
    T_wc: jax.Array,             # [4,4] current world->camera
    omega: jax.Array,            # [3] bias-corrected angular velocity (camera frame)
    accel: jax.Array,            # [3] gravity-filtered linear acceleration
    velocity: jax.Array,         # [3] current linear velocity (camera frame)
    dt: jax.Array,               # scalar seconds
) -> jax.Array:
    """IMU-primed pose prior: rotation from integrated gyro, translation
    from v dt + 1/2 a dt^2 (ref CTrackerSVI.cpp:356-364), with the damped
    fallback when the measurement gap exceeds MAX_DT_SECONDS (:377-398)."""
    dt_ok = dt <= MAX_DT_SECONDS
    scale = jnp.where(dt_ok, 1.0, 0.5)           # damp stale integration
    w = threshold_filter(omega, IMPRECISION_OMEGA) * scale
    t_delta = (velocity * dt + 0.5 * accel * dt * dt) * scale
    # camera-frame motion increment: new_T = delta @ T
    delta = se3.exp_se3(jnp.concatenate([t_delta, w * dt]))
    return jnp.matmul(delta, T_wc, precision=jax.lax.Precision.HIGHEST)


def integrate_prior_samples(
    T_wc: jax.Array,             # [4,4] current world->camera
    dts: jax.Array,              # [K] per-sample time steps (s), 0-padded
    omega: jax.Array,            # [K,3] raw IMU-frame angular velocities
    accel: jax.Array,            # [K,3] raw IMU-frame specific forces
    valid: jax.Array,            # [K] bool — real samples (padding False)
    velocity: jax.Array,         # [3] camera-frame linear velocity at frame start
    R_cam_imu: jax.Array,        # [3,3] IMU->camera rotation (rig extrinsics)
    bias_gyro: jax.Array,        # [3] IMU-frame gyro bias
    bias_accel: jax.Array,       # [3] IMU-frame accelerometer bias
) -> tuple[jax.Array, jax.Array]:
    """Per-sample IMU integration of one frame interval (``lax.scan``).

    The reference extrapolates a SINGLE filtered sample over the whole
    interval (CTrackerSVI.cpp:356-364); here every 200 Hz row integrates
    individually — rotation composes ``prod exp(w_i dt_i)``, gravity is
    removed per sample with the *evolving* orientation, and translation
    accumulates ``v dt + 1/2 a dt^2`` with the velocity carried through the
    interval. Under rotation change within the interval this is strictly
    tighter than the reference's one-sample extrapolation.

    The damped fallback applies when the total interval exceeds
    ``MAX_DT_SECONDS`` (ref :377-398): rotation capped to the first
    sample's rate over MAX_DT, translation zeroed.

    Returns ``(T_prior, rot_total)`` — the primed pose and the integrated
    camera-frame rotation vector (consumed by the dead-reckoning final
    fallback that zeroes its x component, ref :548-551).
    """
    prec = jax.lax.Precision.HIGHEST
    dt_f = T_wc.dtype
    up = jnp.asarray([0.0, -1.0, 0.0], dt_f)
    R_wc0 = T_wc[:3, :3]

    w_cam = jnp.einsum("ij,kj->ki", R_cam_imu, omega - bias_gyro[None, :],
                       precision=prec)
    w_cam = threshold_filter(w_cam, IMPRECISION_OMEGA)
    a_cam_raw = jnp.einsum("ij,kj->ki", R_cam_imu, accel - bias_accel[None, :],
                           precision=prec)
    dts = jnp.where(valid, dts, 0.0)

    def step(carry, inp):
        R_d, t_d, v = carry
        w, a_raw, h = inp
        # gravity removal with the orientation AT this sample
        R_wc_i = jnp.matmul(R_d, R_wc0, precision=prec)
        g_cam = R_wc_i @ (up * GRAVITY)
        a_lin = threshold_filter(a_raw - g_cam, IMPRECISION_ACCEL)
        t_d = t_d + v * h + 0.5 * a_lin * h * h
        v = v + a_lin * h
        R_d = jnp.matmul(se3.exp_so3(w * h), R_d, precision=prec)
        return (R_d, t_d, v), None

    init = (jnp.eye(3, dtype=dt_f), jnp.zeros(3, dt_f), velocity)
    (R_delta, t_delta, _), _ = jax.lax.scan(step, init, (w_cam, a_cam_raw, dts))

    dt_total = jnp.sum(dts)
    rot_total = se3.log_so3(R_delta)

    # damped fallback (ref CTrackerSVI.cpp:377-398)
    damped = dt_total > MAX_DT_SECONDS
    rot_damped = w_cam[0] * MAX_DT_SECONDS
    rot_used = jnp.where(damped, rot_damped, rot_total)
    t_used = jnp.where(damped, jnp.zeros_like(t_delta), t_delta)

    delta = jnp.eye(4, dtype=dt_f)
    delta = delta.at[:3, :3].set(
        jnp.where(damped, se3.exp_so3(rot_damped), R_delta))
    delta = delta.at[:3, 3].set(t_used)
    T_prior = jnp.matmul(delta, T_wc, precision=prec)
    return T_prior, rot_used


def synthesize_measurements(
    poses_wc: np.ndarray,        # [N,4,4] ground-truth world->camera poses
    dt: float,
    calib: ImuCalibration | None = None,
    noise_gyro: float = 0.0,
    noise_accel: float = 0.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Generate (omega [N-1,3], accel [N-1,3]) IMU streams consistent with a
    pose sequence — the test-fixture generator (no analog in the reference,
    which replays recorded sensor dumps)."""
    rng = np.random.default_rng(seed)
    N = len(poses_wc)
    omegas, accels = [], []
    up = np.array([0.0, -1.0, 0.0])
    vel_prev = None
    for k in range(N - 1):
        delta = poses_wc[k + 1] @ np.linalg.inv(poses_wc[k])
        xi = np.asarray(se3.log_se3(jnp.asarray(delta, jnp.float32)))
        omega = xi[3:] / dt
        v = xi[:3] / dt
        if vel_prev is None:
            a = np.zeros(3)
        else:
            a = (v - vel_prev) / dt
        vel_prev = v
        # specific force = linear acceleration + gravity reaction in camera frame
        R_wc = poses_wc[k][:3, :3]
        g_cam = R_wc @ (up * GRAVITY)
        accel = a + g_cam
        if calib is not None:
            omega = omega + calib.bias_gyro
            accel = accel + calib.bias_accel
        omegas.append(omega + rng.normal(0, noise_gyro, 3))
        accels.append(accel + rng.normal(0, noise_accel, 3))
    return np.stack(omegas).astype(np.float32), np.stack(accels).astype(np.float32)
