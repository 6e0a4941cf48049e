"""SE(3) / SO(3) Lie-group operations, batched and jit-safe.

JAX replacement for the reference's hand-rolled pose algebra
(``CMiniVisionToolbox``: Rodrigues conversions ``CMiniVisionToolbox.h:36-37``,
skew matrix ``:48``, se(3)-vector-to-isometry ``getTransformationFromVector``
``:49`` used by every Gauss-Newton solver, and the ad-hoc rotation
re-orthogonalization ``R -= 0.5 R (R^T R - I)`` in
``CSolverStereoPosit.cpp:108-114``).

Design notes
------------
* Poses are 4x4 homogeneous matrices (row-major, ``T @ [x,1]``); twists are
  6-vectors ``[rho, phi]`` (translation part first, rotation part last) to
  match the reference's ``(tx,ty,tz,rx,ry,rz)`` ordering
  (``CMiniVisionToolbox.cpp`` getTransformationFromVector).
* Every function is elementwise-batchable with ``jax.vmap`` and contains no
  data-dependent Python control flow; small-angle branches use ``jnp.where``
  with Taylor fallbacks that are safe in float32.
* No dtype is forced: float32 on the device, float64 under x64 CPU tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8

# Accelerator matmuls may default to reduced precision (TF32 on GPUs); pose
# algebra needs true float32.
_PREC = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_PREC)


def hat(w: jax.Array) -> jax.Array:
    """Skew-symmetric matrix of a 3-vector (ref CMiniVisionToolbox.h:48)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jax.Array) -> jax.Array:
    """Inverse of :func:`hat`."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _so3_coeffs(theta_sq: jax.Array):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3), Taylor-safe."""
    theta = jnp.sqrt(jnp.maximum(theta_sq, 0.0))
    small = theta_sq < _EPS
    # guard against 0/0 — the branch value is discarded by jnp.where.
    safe_t2 = jnp.where(small, 1.0, theta_sq)
    safe_t = jnp.sqrt(safe_t2)
    A = jnp.where(small, 1.0 - theta_sq / 6.0, jnp.sin(safe_t) / safe_t)
    B = jnp.where(small, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(safe_t)) / safe_t2)
    C = jnp.where(small, 1.0 / 6.0 - theta_sq / 120.0, (safe_t - jnp.sin(safe_t)) / (safe_t2 * safe_t))
    return A, B, C


def exp_so3(phi: jax.Array) -> jax.Array:
    """Rodrigues formula: axis-angle 3-vector -> rotation matrix.

    Replaces ``CMiniVisionToolbox::fromOrientationRodrigues``
    (CMiniVisionToolbox.h:36).
    """
    theta_sq = jnp.sum(phi * phi, axis=-1)
    A, B, _ = _so3_coeffs(theta_sq)
    Phi = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), Phi.shape)
    return eye + A[..., None, None] * Phi + B[..., None, None] * _mm(Phi, Phi)


def log_so3(R: jax.Array) -> jax.Array:
    """Rotation matrix -> axis-angle vector (inverse Rodrigues).

    Numerically careful around theta = 0 and theta = pi (float32-safe).
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    # vee of the antisymmetric part = sin(theta) * axis
    w = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5
    sin_theta = jnp.sin(theta)

    small = theta < 1e-4
    near_pi = theta > jnp.pi - 1e-3

    # generic: phi = theta / sin(theta) * w
    safe_sin = jnp.where(small | near_pi, 1.0, sin_theta)
    phi_generic = (theta / safe_sin)[..., None] * w
    # small angle: phi ~= (1 + theta^2/6) * w
    phi_small = (1.0 + theta[..., None] ** 2 / 6.0) * w
    # near pi: extract axis from the symmetric part. R ~ I + (1-cos)K^2+sin K;
    # diag(R) = 1 - (1-cos)(axis_perp^2) -> axis_i^2 = (R_ii - cos)/(1 - cos)
    one_minus_cos = jnp.where(near_pi, 1.0 - cos_theta, 1.0)
    axis_sq = jnp.clip(
        (jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1) - cos_theta[..., None])
        / one_minus_cos[..., None],
        0.0,
        1.0,
    )
    axis_abs = jnp.sqrt(axis_sq)
    # signs from the off-diagonal sums (robust when sin ~ 0)
    s = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    # fall back to products with the dominant axis for sign disambiguation
    sym = jnp.stack(
        [
            R[..., 1, 0] + R[..., 0, 1],
            R[..., 2, 1] + R[..., 1, 2],
            R[..., 0, 2] + R[..., 2, 0],
        ],
        axis=-1,
    )  # [xy, yz, zx] pair products * 2(1-cos)
    dominant = jnp.argmax(axis_abs, axis=-1)

    def _signed_axis(axis_abs, sym, dominant, s):
        # give the dominant axis the sign of s (or + if s ~ 0), then propagate
        # via pair products: sign(x*y) = sign(sym_xy) etc.
        d_sign = jnp.where(jnp.take_along_axis(s, dominant[..., None], axis=-1)[..., 0] >= 0, 1.0, -1.0)
        signs = []
        for i in range(3):
            same = dominant == i
            # pair product linking axis i with dominant axis
            pair_idx = jnp.where(
                (dominant == 0) & (i == 1) | (dominant == 1) & (i == 0), 0,
                jnp.where((dominant == 1) & (i == 2) | (dominant == 2) & (i == 1), 1, 2),
            )
            pair = jnp.take_along_axis(sym, pair_idx[..., None], axis=-1)[..., 0]
            sign_i = jnp.where(same, d_sign, d_sign * jnp.where(pair >= 0, 1.0, -1.0))
            signs.append(sign_i)
        return axis_abs * jnp.stack(signs, axis=-1)

    axis_pi = _signed_axis(axis_abs, sym, dominant, s)
    phi_pi = theta[..., None] * axis_pi

    return jnp.where(
        small[..., None], phi_small, jnp.where(near_pi[..., None], phi_pi, phi_generic)
    )


def exp_se3(xi: jax.Array) -> jax.Array:
    """se(3) twist ``[rho, phi]`` -> 4x4 isometry.

    The exact-exponential replacement for the reference's small-angle
    ``getTransformationFromVector`` (CMiniVisionToolbox.h:49) used to apply
    GN pose updates; identical to first order, stabler for large steps.
    """
    rho, phi = xi[..., :3], xi[..., 3:]
    theta_sq = jnp.sum(phi * phi, axis=-1)
    A, B, C = _so3_coeffs(theta_sq)
    Phi = hat(phi)
    Phi2 = _mm(Phi, Phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), Phi.shape)
    R = eye + A[..., None, None] * Phi + B[..., None, None] * Phi2
    V = eye + B[..., None, None] * Phi + C[..., None, None] * Phi2
    t = jnp.einsum("...ij,...j->...i", V, rho, precision=_PREC)
    return make_T(R, t)


def log_se3(T: jax.Array) -> jax.Array:
    """4x4 isometry -> twist ``[rho, phi]`` (inverse of :func:`exp_se3`)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = log_so3(R)
    theta_sq = jnp.sum(phi * phi, axis=-1)
    A, B, _ = _so3_coeffs(theta_sq)
    Phi = hat(phi)
    Phi2 = _mm(Phi, Phi)
    # V^{-1} = I - Phi/2 + (1/theta^2)(1 - A/(2B)) Phi^2, Taylor at 0: 1/12
    small = theta_sq < _EPS
    safe_t2 = jnp.where(small, 1.0, theta_sq)
    coef = jnp.where(small, 1.0 / 12.0, (1.0 - A / (2.0 * B)) / safe_t2)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), Phi.shape)
    V_inv = eye - 0.5 * Phi + coef[..., None, None] * Phi2
    rho = jnp.einsum("...ij,...j->...i", V_inv, t, precision=_PREC)
    return jnp.concatenate([rho, phi], axis=-1)


def make_T(R: jax.Array, t: jax.Array) -> jax.Array:
    """Assemble 4x4 isometries from rotations and translations."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (4,)
    )[..., None, :]
    return jnp.concatenate([top, bottom], axis=-2)


def inv_T(T: jax.Array) -> jax.Array:
    """Fast inverse of an isometry (R^T, -R^T t)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return make_T(Rt, -jnp.einsum("...ij,...j->...i", Rt, t, precision=_PREC))


def transform(T: jax.Array, p: jax.Array) -> jax.Array:
    """Apply isometries to 3D points: ``T[..., :3, :3] @ p + t``."""
    return jnp.einsum("...ij,...j->...i", T[..., :3, :3], p, precision=_PREC) + T[..., :3, 3]


def reorthogonalize(R: jax.Array) -> jax.Array:
    """Project a near-rotation back onto SO(3).

    The reference damps drift with one Newton step ``R -= 0.5 R (R^T R - I)``
    (CSolverStereoPosit.cpp:108-114); we use the same cheap step — it is
    fully batched and needs no SVD.
    """
    eye = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)
    return R - 0.5 * _mm(R, _mm(jnp.swapaxes(R, -1, -2), R) - eye)


def apply_left_update(xi: jax.Array, T: jax.Array) -> jax.Array:
    """GN left-multiplicative update ``exp(xi) @ T`` with re-orthogonalization."""
    T_new = _mm(exp_se3(xi), T)
    R = reorthogonalize(T_new[..., :3, :3])
    return make_T(R, T_new[..., :3, 3])


def quat_to_R(q_xyzw: jax.Array) -> jax.Array:
    """Quaternion (x, y, z, w — the reference's file order,
    vi_sensor_camera_left.txt:17) -> rotation matrix."""
    q = q_xyzw / jnp.linalg.norm(q_xyzw, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], axis=-1),
            jnp.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], axis=-1),
            jnp.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], axis=-1),
        ],
        axis=-2,
    )


def rotation_geodesic_angle(Ra: jax.Array, Rb: jax.Array) -> jax.Array:
    """Angle of Ra^T Rb — the KITTI rotation-error formula
    (evaluate_trajectory.cpp:287-303): acos((trace - 1) / 2)."""
    Rrel = _mm(jnp.swapaxes(Ra, -1, -2), Rb)
    trace = Rrel[..., 0, 0] + Rrel[..., 1, 1] + Rrel[..., 2, 2]
    return jnp.arccos(jnp.clip(0.5 * (trace - 1.0), -1.0, 1.0))
