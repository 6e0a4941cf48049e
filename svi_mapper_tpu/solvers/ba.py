"""Bundle adjustment: batched Schur-complement Levenberg-Marquardt.

JAX replacement for the full-graph stage of ``Cg2oOptimizer``
(Cg2oOptimizer.cpp:232-522: BlockSolverX + CHOLMOD + Levenberg over pose and
landmark vertices with Cauchy-robust stereo measurement edges, iterated in
chunks until <1 % chi^2 improvement, :954-980). g2o's sparse-direct solve is
pointer-heavy and serial; the classic Schur trick keeps everything
block-dense and batched:

  * residuals/Jacobians for ALL (keyframe, landmark) observations at once
    from a dense ``[K, L, 4]`` observation tensor + mask (window BA sizes:
    K <= ~32 poses, L <= ~4096 landmarks — the dense tensor is ~2 MB);
  * Hessian blocks H_pp [K,6,6], H_ll [L,3,3], H_pl [K,L,6,3] by batched
    matmuls, landmark blocks inverted in parallel (batched 3x3);
  * the reduced camera system S = H_pp - W H_ll^-1 W^T is a small dense
    [6K, 6K] matrix solved by Cholesky;
  * Levenberg damping with accept/reject on chi^2, fixed iteration cap,
    and the reference's <1 % relative-improvement stop.

Gauge freedom is fixed by masking updates of designated poses
(``fix_mask``), the batched analog of g2o's setFixed on reference vertices
(Cg2oOptimizer.cpp:342-360).

Residuals are the same 4D stereo reprojection error as the front-end
solvers with the 10 px^2 robust kernel; this replaces the reference's
depth-tiered edge selection (XYZ / depth / disparity edges,
Cg2oOptimizer.cpp:1383-1466) — pixel-space residuals carry the same
depth-dependent information content natively.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from svi_mapper_tpu.geometry import se3
from svi_mapper_tpu.geometry.camera import StereoCamera

from svi_mapper_tpu.geometry.linalg import inv3x3 as _inv3x3
from svi_mapper_tpu.utils import struct

_PREC = jax.lax.Precision.HIGHEST

@struct.dataclass
class BAResult:
    T_wc: jax.Array        # [K,4,4] optimized poses
    points_w: jax.Array    # [L,3] optimized landmarks
    chi2_initial: jax.Array
    chi2_final: jax.Array
    iterations: jax.Array


def _residuals(T_wc, X, obs_uv, fx, fy, cx, cy, bq):
    """r [K,L,4], p_cam [K,L,3] for all observation pairs."""
    p_c = jnp.einsum("kij,lj->kli", T_wc[:, :3, :3], X, precision=_PREC) + T_wc[:, None, :3, 3]
    x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
    safe_z = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    iz = 1.0 / safe_z
    u_l = fx * x * iz + cx
    v_l = fy * y * iz + cy
    u_r = (fx * x + bq) * iz + cx
    pred = jnp.stack([u_l, v_l, u_r, v_l], axis=-1)
    return pred - obs_uv, p_c


def _jacobians(p_c, T_wc, fx, fy, bq):
    """J_pose [K,L,4,6] (left-mult se3 of T_k), J_point [K,L,4,3] (world X)."""
    x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
    safe_z = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    iz = 1.0 / safe_z
    iz2 = iz * iz
    zr = jnp.zeros_like(x)
    J_ul = jnp.stack([fx * iz, zr, -fx * x * iz2], axis=-1)
    J_vl = jnp.stack([zr, fy * iz, -fy * y * iz2], axis=-1)
    J_ur = jnp.stack([fx * iz, zr, -(fx * x + bq) * iz2], axis=-1)
    J_uv = jnp.stack([J_ul, J_vl, J_ur, J_vl], axis=-2)          # [K,L,4,3]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=p_c.dtype), p_c.shape[:-1] + (3, 3))
    J_pc = jnp.concatenate([eye, -se3.hat(p_c)], axis=-1)        # [K,L,3,6]
    J_pose = jnp.einsum("klri,klij->klrj", J_uv, J_pc, precision=_PREC)
    # d p_c / d X_world = R_k
    J_point = jnp.einsum("klri,kij->klrj", J_uv, T_wc[:, :3, :3], precision=_PREC)
    return J_pose, J_point


def _chi2(r, w_mask):
    return jnp.sum(w_mask * jnp.sum(r * r, axis=-1))


def _adjoint(T: jax.Array) -> jax.Array:
    """SE(3) adjoint [[R, hat(t) R], [0, R]] for batched [.,4,4]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tR = jnp.matmul(se3.hat(t), R, precision=_PREC)
    top = jnp.concatenate([R, tR], axis=-1)
    bot = jnp.concatenate([jnp.zeros_like(R), R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


@functools.partial(jax.jit, static_argnames=("max_iterations",))
def bundle_adjust(
    T_wc: jax.Array,          # [K,4,4]
    points_w: jax.Array,      # [L,3]
    obs_uv: jax.Array,        # [K,L,4]
    obs_mask: jax.Array,      # [K,L] bool
    cam: StereoCamera,
    fix_mask: jax.Array,      # [K] bool — poses held fixed (gauge)
    *,
    kernel_px2: float = 10.0,
    max_iterations: int = 10,
    lm_lambda0: float = 1e-4,
    point_damping: float = 1e-6,
    min_rel_improvement: float = 0.01,   # ref <1% chi2 stop (Cg2o:966-977)
    odo_M: jax.Array | None = None,      # [K,4,4] pose-pose chain measurements
                                         # (entry k: T_{k+1} <- k; the
                                         # reference's EdgeSE3 chain in the
                                         # full graph, Cg2o:1258-1266)
    odo_w: jax.Array | None = None,      # [K] edge weights (0 disables; last
                                         # entry unused)
    grav_d: jax.Array | None = None,     # [K,3] measured camera-frame down
                                         # directions — per-keyframe gravity
                                         # unary in the FULL graph (ref
                                         # EdgeSE3LinearAcceleration,
                                         # Cg2oOptimizer.cpp:982-997)
    grav_w: jax.Array | None = None,     # [K] gravity weights (0 disables)
    obs_w: jax.Array | None = None,      # [K,L] per-observation information
                                         # scale (depth-tiered weighting, ref
                                         # dInformationFactor = 1/z,
                                         # Cg2oOptimizer.cpp:1403-1466);
                                         # multiplies into the mask/robust
                                         # weight
) -> BAResult:
    fx, fy = cam.left.fx, cam.left.fy
    cx, cy = cam.left.cx, cam.left.cy
    bq = cam.right.P[0, 3]
    K = T_wc.shape[0]
    L = points_w.shape[0]
    dtype = points_w.dtype
    maskf = obs_mask.astype(dtype)
    if obs_w is not None:
        maskf = maskf * obs_w.astype(dtype)

    def robust_w(r):
        err2 = jnp.sum(r * r, axis=-1)
        w = jnp.where(err2 > kernel_px2, kernel_px2 / jnp.maximum(err2, 1e-12), 1.0)
        return w * maskf

    # pose-pose odometry chain (ref EdgeSE3 full-graph edges,
    # Cg2oOptimizer.cpp:1258-1266): keeps weakly-observed keyframes anchored
    # to the (post-pose-graph) trajectory while reprojection terms refine
    use_odo = odo_M is not None

    def _se3_inv_batch(T):
        R = T[..., :3, :3]
        t = T[..., :3, 3]
        Rt = jnp.swapaxes(R, -1, -2)
        ti = -jnp.einsum("...ij,...j->...i", Rt, t, precision=_PREC)
        out = jnp.broadcast_to(jnp.eye(4, dtype=T.dtype), T.shape)
        return out.at[..., :3, :3].set(Rt).at[..., :3, 3].set(ti)

    if use_odo:
        odo_Minv = _se3_inv_batch(odo_M[: K - 1])
        wo = odo_w[: K - 1]

    def odo_residuals(T):
        Dk = jnp.matmul(T[1:], _se3_inv_batch(T[:-1]), precision=_PREC)
        r_o = jax.vmap(se3.log_se3)(
            jnp.matmul(Dk, odo_Minv, precision=_PREC))           # [K-1,6]
        return Dk, r_o

    def odo_chi2(T):
        if not use_odo:
            return jnp.asarray(0.0, dtype)
        _, r_o = odo_residuals(T)
        return jnp.sum(wo * jnp.sum(r_o * r_o, axis=-1))

    # gravity-direction unary (ref error = R_n2w a_hat - (0,0,-1),
    # edge_se3_linear_acceleration.cpp:106-116; our world down is (0,-1,0)):
    # residual r_g = R_wc g_down - d_measured, J = [0 | -hat(R g_down)]
    # under the left-multiplicative update
    use_grav = grav_d is not None

    def grav_residuals(T):
        Rg = -T[:, :3, 1]                     # R_wc @ (0,-1,0)
        return Rg, Rg - grav_d                # [K,3], [K,3]

    def grav_chi2(T):
        if not use_grav:
            return jnp.asarray(0.0, dtype)
        _, r_g = grav_residuals(T)
        return jnp.sum(grav_w * jnp.sum(r_g * r_g, axis=-1))

    r0, _ = _residuals(T_wc, points_w, obs_uv, fx, fy, cx, cy, bq)
    chi2_init = _chi2(r0, robust_w(r0)) + odo_chi2(T_wc) + grav_chi2(T_wc)

    def lm_step(carry):
        T, X, lam, chi2_prev, it, done = carry
        r, p_c = _residuals(T, X, obs_uv, fx, fy, cx, cy, bq)
        w = robust_w(r)                                          # [K,L]
        # in-front mask (behind-camera obs excluded)
        w = w * (p_c[..., 2] > 0.05)
        J_pose, J_point = _jacobians(p_c, T, fx, fy, bq)

        # Hessian blocks as explicit batched matmuls over the flattened
        # observation axis
        Jp = J_pose.reshape(K, L * 4, 6)
        Jpw = (J_pose * w[..., None, None]).reshape(K, L * 4, 6)
        Jl = J_point.transpose(1, 0, 2, 3).reshape(L, K * 4, 3)
        Jlw = (J_point * w[..., None, None]).transpose(1, 0, 2, 3).reshape(L, K * 4, 3)
        rk = r.reshape(K, L * 4, 1)
        rl = r.transpose(1, 0, 2).reshape(L, K * 4, 1)

        H_pp = jnp.matmul(Jpw.transpose(0, 2, 1), Jp, precision=_PREC)   # [K,6,6]
        H_ll = jnp.matmul(Jlw.transpose(0, 2, 1), Jl, precision=_PREC)   # [L,3,3]
        # tiny-matrix batched contractions (r-dim 4, m-dim 3) are unrolled
        # into broadcast-sums, which fuse into one elementwise pass
        Jpw4 = J_pose * w[..., None, None]                        # [K,L,4,6]
        H_pl = sum(
            Jpw4[..., rr, :, None] * J_point[..., rr, None, :] for rr in range(4)
        )                                                         # [K,L,6,3]
        b_p = jnp.matmul(Jpw.transpose(0, 2, 1), rk, precision=_PREC)[..., 0]  # [K,6]
        b_l = jnp.matmul(Jlw.transpose(0, 2, 1), rl, precision=_PREC)[..., 0]  # [L,3]

        # Levenberg damping
        H_pp = H_pp + lam * jnp.eye(6, dtype=dtype)[None]
        H_ll = H_ll + (lam + point_damping) * jnp.eye(3, dtype=dtype)[None]

        H_ll_inv = _inv3x3(H_ll)                                  # [L,3,3] batched

        # Schur complement S = H_pp_diag - W Hll^-1 W^T as ONE [K6, L3] x
        # [L3, K6] matmul
        W_Hinv = sum(
            H_pl[..., :, jj, None] * H_ll_inv[None, :, None, jj, :]
            for jj in range(3)
        )                                                         # [K,L,6,3]
        A = W_Hinv.transpose(0, 2, 1, 3).reshape(K * 6, L * 3)
        B = H_pl.transpose(0, 2, 1, 3).reshape(K * 6, L * 3)
        S_off = jnp.matmul(A, B.T, precision=_PREC).reshape(K, 6, K, 6)
        S = -S_off
        S = S.at[jnp.arange(K), :, jnp.arange(K), :].add(H_pp)
        rhs = b_p - jnp.matmul(A, b_l.reshape(L * 3), precision=_PREC).reshape(K, 6)

        if use_odo:
            # J_{k+1} = I, J_k = -Adj(D_k) (left-multiplicative updates)
            Dk, r_o = odo_residuals(T)
            Adj = _adjoint(Dk)                                    # [K-1,6,6]
            AdjT = Adj.transpose(0, 2, 1)
            ks = jnp.arange(K - 1)
            wk = wo[:, None, None]
            eye6 = jnp.broadcast_to(jnp.eye(6, dtype=dtype), (K - 1, 6, 6))
            S = S.at[ks + 1, :, ks + 1, :].add(wk * eye6)
            S = S.at[ks, :, ks, :].add(
                wk * jnp.matmul(AdjT, Adj, precision=_PREC))
            S = S.at[ks, :, ks + 1, :].add(-wk * AdjT)
            S = S.at[ks + 1, :, ks, :].add(-wk * Adj)
            rhs = rhs.at[ks + 1].add(wo[:, None] * r_o)
            rhs = rhs.at[ks].add(
                -wo[:, None] * jnp.einsum("kji,kj->ki", Adj, r_o,
                                          precision=_PREC))

        if use_grav:
            Rg, r_g = grav_residuals(T)
            A = -se3.hat(Rg)                                  # [K,3,3] = J_phi
            kk = jnp.arange(K)
            wg = grav_w[:, None, None]
            S = S.at[kk, 3:, kk, 3:].add(
                wg * jnp.matmul(A.transpose(0, 2, 1), A, precision=_PREC))
            rhs = rhs.at[:, 3:].add(
                grav_w[:, None] * jnp.einsum("kji,kj->ki", A, r_g,
                                             precision=_PREC))

        # gauge fixing: zero out rows/cols of fixed poses, identity diagonal
        free = (~fix_mask).astype(dtype)                          # [K]
        Sm = S * free[:, None, None, None] * free[None, None, :, None]
        Sm = Sm.at[jnp.arange(K), :, jnp.arange(K), :].add(
            (1.0 - free)[:, None, None] * jnp.eye(6, dtype=dtype)
        )
        rhs = rhs * free[:, None]

        # S is SPD after damping + gauge fixing: Cholesky beats the LU
        # custom call this solve lowered to before
        S_flat = Sm.reshape(K * 6, K * 6)
        c_lo = jax.scipy.linalg.cho_factor(S_flat, lower=True)
        dp = -jax.scipy.linalg.cho_solve(c_lo, rhs.reshape(K * 6)).reshape(K, 6)
        dp = dp * free[:, None]
        # back-substitute landmark updates
        dx = -jnp.matmul(
            H_ll_inv,
            (b_l + jnp.matmul(B.T, dp.reshape(K * 6),
                              precision=_PREC).reshape(L, 3))[..., None],
            precision=_PREC,
        )[..., 0]

        T_new = jax.vmap(se3.apply_left_update)(dp, T)
        X_new = X + dx

        r_new, _ = _residuals(T_new, X_new, obs_uv, fx, fy, cx, cy, bq)
        chi2_new = (_chi2(r_new, robust_w(r_new)) + odo_chi2(T_new)
                    + grav_chi2(T_new))
        accept = chi2_new < chi2_prev
        T = jnp.where(accept, T_new, T)
        X = jnp.where(accept, X_new, X)
        lam = jnp.where(accept, lam * 0.3, lam * 8.0)
        rel_gain = (chi2_prev - chi2_new) / jnp.maximum(chi2_prev, 1e-12)
        done = accept & (rel_gain < min_rel_improvement)
        chi2 = jnp.where(accept, chi2_new, chi2_prev)
        return T, X, lam, chi2, it + 1, done

    def cond(carry):
        *_, it, done = carry
        return (it < max_iterations) & ~done

    T_f, X_f, _, chi2_f, iters, _ = jax.lax.while_loop(
        cond, lm_step,
        (T_wc, points_w, jnp.asarray(lm_lambda0, dtype), chi2_init, jnp.int32(0),
         jnp.asarray(False)),
    )
    return BAResult(
        T_wc=T_f, points_w=X_f,
        chi2_initial=chi2_init, chi2_final=chi2_f, iterations=iters,
    )


@jax.jit
def reprojection_stats(
    T_wc: jax.Array,          # [K,4,4]
    points_w: jax.Array,      # [L,3]
    obs_uv: jax.Array,        # [K,L,4]
    obs_mask: jax.Array,      # [K,L] bool
    cam: StereoCamera,
) -> tuple[jax.Array, jax.Array]:
    """Per-landmark post-BA health: (mean squared reprojection error [L],
    minimum observing-camera depth [L]) — the excision criteria of the
    reference's _applyOptimizationToLandmarks (Cg2oOptimizer.cpp:1486-1504)."""
    fx, fy = cam.left.fx, cam.left.fy
    cx, cy = cam.left.cx, cam.left.cy
    bq = cam.right.P[0, 3]
    r, p_c = _residuals(T_wc, points_w, obs_uv, fx, fy, cx, cy, bq)
    m = obs_mask.astype(r.dtype)
    n = jnp.maximum(jnp.sum(m, axis=0), 1.0)                    # [L]
    err2 = jnp.sum(m * jnp.sum(r * r, axis=-1), axis=0) / n
    depth = jnp.min(jnp.where(obs_mask, p_c[..., 2], jnp.inf), axis=0)
    return err2, depth
