"""Pose-graph optimization: batched robust Gauss-Newton over SE(3) chains.

JAX replacement for the reference's trajectory-only g2o graph
(Cg2oOptimizer.cpp:92-96: BlockSolver_6_3 + CHOLMOD + Gauss-Newton, run for
up to 1000 iterations after loop-closure consensus, :342-360) with its
pose-pose ``EdgeSE3`` measurements (information 1e5*I scaled down by
1/(1+||dt||^2), :1258-1266) and z-damped loop-closure edges (:1075-1133).

Design: poses and edges are fixed-capacity masked arrays; each GN iteration
evaluates every edge residual r = log(T_j inv(T_i) inv(M_ij)) in batch,
scatter-adds the standard (J_j = I, J_i = -Ad(M_ij)) block Jacobian
contributions into a dense [6N, 6N] system and solves by Cholesky — N is
the keyframe count (hundreds), so the dense solve is one small matrix
factorization compared to g2o's sparse factorization machinery.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from svi_mapper_tpu.geometry import se3
from svi_mapper_tpu.utils import struct

_PREC = jax.lax.Precision.HIGHEST


def adjoint(T: jax.Array) -> jax.Array:
    """SE(3) adjoint for twist order [rho, phi]: [[R, hat(t)R], [0, R]]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tR = jnp.matmul(se3.hat(t), R, precision=_PREC)
    top = jnp.concatenate([R, tR], axis=-1)
    bottom = jnp.concatenate([jnp.zeros_like(R), R], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


@struct.dataclass
class PoseGraphEdges:
    """Fixed-capacity edge set (sequential odometry + loop closures)."""

    i: jax.Array          # [E] int32 source pose index
    j: jax.Array          # [E] int32 target pose index
    T_ij: jax.Array       # [E,4,4] measured relative transform T_j @ inv(T_i)
    weight: jax.Array     # [E] information scale
    valid: jax.Array      # [E] bool
    # optional per-component diagonal information (twist order [rho, phi]),
    # multiplied into ``weight``: the anisotropic analog of the reference's
    # 6x6 edge information matrices — loop-closure edges damp the
    # translation-z component by 100 (_getInformationNoZ,
    # Cg2oOptimizer.cpp:1542-1550, applied :1075-1133) because ICP depth
    # along the optical axis is the noisy direction. None = isotropic.
    info6: jax.Array | None = None   # [E,6]


@struct.dataclass
class GravityPriors:
    """Per-pose gravity-direction measurements — the unary edge
    ``EdgeSE3LinearAcceleration`` (edge_se3_linear_acceleration.cpp:106-116:
    error = R â_measured - (0, 0, -1); here the world 'up' is (0, -1, 0) in
    the y-down camera convention)."""

    down_cam: jax.Array    # [N,3] unit gravity direction measured in camera frame
    weight: jax.Array      # [N]
    valid: jax.Array       # [N] bool


@struct.dataclass
class PoseGraphResult:
    T_wc: jax.Array       # [N,4,4]
    chi2_initial: jax.Array
    chi2_final: jax.Array
    iterations: jax.Array


def make_edges(capacity: int, dtype=jnp.float32) -> PoseGraphEdges:
    return PoseGraphEdges(
        i=jnp.zeros((capacity,), jnp.int32),
        j=jnp.zeros((capacity,), jnp.int32),
        T_ij=jnp.broadcast_to(jnp.eye(4, dtype=dtype), (capacity, 4, 4)),
        weight=jnp.zeros((capacity,), dtype),
        valid=jnp.zeros((capacity,), jnp.bool_),
    )


def sequential_edge_weight(T_ij: jax.Array) -> jax.Array:
    """Reference's odometry information scaling 1/(1 + ||dt||^2)
    (Cg2oOptimizer.cpp:1258-1266)."""
    dt2 = jnp.sum(T_ij[..., :3, 3] ** 2, axis=-1)
    return 1.0 / (1.0 + dt2)


def _edge_residuals(T_wc, edges):
    """r [E,6] for all edges."""
    Ti = T_wc[edges.i]
    Tj = T_wc[edges.j]
    E = jnp.matmul(
        jnp.matmul(Tj, se3.inv_T(Ti), precision=_PREC),
        se3.inv_T(edges.T_ij), precision=_PREC,
    )
    return se3.log_se3(E)


@functools.partial(jax.jit, static_argnames=("max_iterations",))
def optimize_pose_graph(
    T_wc: jax.Array,            # [N,4,4] initial poses (world->camera)
    edges: PoseGraphEdges,
    fix_mask: jax.Array,        # [N] bool — gauge-fixed poses
    *,
    gravity: GravityPriors | None = None,
    robust_delta: float = 0.5,  # Cauchy-style kernel on ||r||^2
    max_iterations: int = 20,
    damping: float = 1e-4,
    convergence: float = 1e-6,
    trust_radius: float = 1.0,  # per-iteration update clamp (GN trust region)
) -> PoseGraphResult:
    N = T_wc.shape[0]
    dtype = T_wc.dtype
    ew = edges.weight * edges.valid.astype(dtype)
    # per-component diagonal information (isotropic when info6 is None)
    i6 = (jnp.ones(edges.T_ij.shape[:1] + (6,), dtype)
          if edges.info6 is None else edges.info6.astype(dtype))
    w6_base = ew[:, None] * i6                                   # [E,6]
    down_w = jnp.asarray([0.0, -1.0, 0.0], dtype)  # world gravity direction

    def gravity_residual(T):
        # r = R_wc down_world - down_measured (unary, rotation-only)
        return jnp.einsum("nij,j->ni", T[:, :3, :3], down_w,
                          precision=_PREC) - gravity.down_cam

    def chi2_of(T):
        r = _edge_residuals(T, edges)
        c = jnp.sum(w6_base * r * r)
        if gravity is not None:
            gw = gravity.weight * gravity.valid.astype(dtype)
            rg = gravity_residual(T)
            c = c + jnp.sum(gw * jnp.sum(rg * rg, axis=-1))
        return c

    chi2_init = chi2_of(T_wc)

    def gn_step(carry):
        T, it, delta = carry
        r = _edge_residuals(T, edges)                            # [E,6]
        # robust kernel on the info-weighted residual r^T Omega r (g2o
        # semantics; Omega here = diag(i6) without the edge weight so the
        # kernel cutoff stays comparable across edges): a z-damped closure
        # edge with large optical-axis error keeps its well-conditioned
        # x/y information instead of tripping the cutoff.
        err2 = jnp.sum(i6 * r * r, axis=-1)
        rob = jnp.where(err2 > robust_delta,
                        robust_delta / jnp.maximum(err2, 1e-12), 1.0)
        w6 = w6_base * rob[:, None]                              # [E,6]
        J_i = -adjoint(edges.T_ij)                               # [E,6,6]
        # per-edge blocks under the diagonal information W = diag(w6)
        H_ii = jnp.einsum("eki,ek,ekj->eij", J_i, w6, J_i, precision=_PREC)
        H_jj = w6[:, :, None] * jnp.broadcast_to(jnp.eye(6, dtype=dtype), H_ii.shape)
        # off-diagonal block H_ij = J_i^T W J_j with J_j = I -> J_i^T diag(w6)
        H_ij_blk = jnp.swapaxes(J_i, -1, -2) * w6[:, None, :]
        b_i = jnp.einsum("eki,ek,ek->ei", J_i, w6, r, precision=_PREC)
        b_j = w6 * r

        H = jnp.zeros((N, 6, N, 6), dtype)
        H = H.at[edges.i, :, edges.i, :].add(H_ii)
        H = H.at[edges.j, :, edges.j, :].add(H_jj)
        H = H.at[edges.i, :, edges.j, :].add(H_ij_blk)
        H = H.at[edges.j, :, edges.i, :].add(jnp.swapaxes(H_ij_blk, -1, -2))
        b = jnp.zeros((N, 6), dtype)
        b = b.at[edges.i].add(b_i)
        b = b.at[edges.j].add(b_j)

        if gravity is not None:
            gw = gravity.weight * gravity.valid.astype(dtype)
            rg = gravity_residual(T)                         # [N,3]
            Rg = jnp.einsum("nij,j->ni", T[:, :3, :3], down_w, precision=_PREC)
            # J = [0 | -hat(R down_w)] (3x6) — translation-independent
            Jg = jnp.concatenate(
                [jnp.zeros((N, 3, 3), dtype), -se3.hat(Rg)], axis=-1
            )
            H = H.at[jnp.arange(N), :, jnp.arange(N), :].add(
                jnp.einsum("nki,n,nkj->nij", Jg, gw, Jg, precision=_PREC)
            )
            b = b + jnp.einsum("nki,n,nk->ni", Jg, gw, rg, precision=_PREC)

        free = (~fix_mask).astype(dtype)
        H = H * free[:, None, None, None] * free[None, None, :, None]
        H = H.at[jnp.arange(N), :, jnp.arange(N), :].add(
            jnp.eye(6, dtype=dtype)[None] * ((1.0 - free) + damping)[:, None, None]
        )
        b = b * free[:, None]

        # damped SPD system: Cholesky beats the LU custom call
        c_lo = jax.scipy.linalg.cho_factor(H.reshape(N * 6, N * 6), lower=True)
        xi = -jax.scipy.linalg.cho_solve(c_lo, b.reshape(N * 6)).reshape(N, 6)
        xi = xi * free[:, None]
        # trust region: scale the whole update down if any pose step is huge
        step = jnp.max(jnp.abs(xi))
        scale = jnp.minimum(1.0, trust_radius / jnp.maximum(step, 1e-12))
        xi = xi * scale
        xi = jnp.where(jnp.isfinite(xi), xi, 0.0)
        T_new = jax.vmap(se3.apply_left_update)(xi, T)
        return T_new, it + 1, jnp.max(jnp.abs(xi))

    def cond(carry):
        _, it, delta = carry
        return (it < max_iterations) & (delta > convergence)

    T_f, iters, _ = jax.lax.while_loop(
        cond, gn_step, (T_wc, jnp.int32(0), jnp.asarray(jnp.inf, dtype))
    )
    return PoseGraphResult(
        T_wc=T_f, chi2_initial=chi2_init, chi2_final=chi2_of(T_f), iterations=iters
    )
