"""3D-3D point-cloud alignment (ICP with known correspondences), batched.

JAX replacement for the reference's loop-closure ICP
(CTrackerGT.cpp:506-631): Gauss-Newton on a 6-DoF transform aligning the
matched landmark clouds of a (query, reference) keyframe pair, with
inverse-depth weighting, a 1.0 m^2 inlier kernel, and the acceptance gates
>= 25 inliers and average inlier error < 0.9 (gates :524-631).

The per-closure C++ GN loop becomes one ``vmap``-able solver so ALL closure
candidates of a query keyframe validate simultaneously.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from svi_mapper_tpu.geometry import linalg, se3
from svi_mapper_tpu.utils import struct

_PREC = jax.lax.Precision.HIGHEST


@struct.dataclass
class ICPResult:
    T_qr: jax.Array        # [4,4] transform mapping reference-cloud points
                           #       onto query-cloud points
    ok: jax.Array          # bool
    inliers: jax.Array     # int32
    avg_error: jax.Array   # average inlier squared error (m^2)
    iterations: jax.Array


@functools.partial(jax.jit, static_argnames=("max_iterations",))
def align_clouds(
    p_query: jax.Array,     # [N,3] points in the query frame
    p_ref: jax.Array,       # [N,3] corresponding points in the reference frame
    valid: jax.Array,       # [N] bool correspondence mask
    *,
    T_init: jax.Array | None = None,
    inlier_m2: float = 1.0,          # ref inlier kernel 1.0 (CTrackerGT.cpp:524)
    min_inliers: int = 25,           # ref :527
    max_avg_error: float = 0.9,      # ref :528
    max_iterations: int = 20,
    convergence: float = 1e-5,
    damping: float = 1e-6,
) -> ICPResult:
    """Solve min_T sum w ||T p_ref - p_query||^2 with robust weights.

    Weights include the reference's inverse-depth factor (far points carry
    less information, CTrackerGT.cpp:535-560) and the 1 m^2 robust kernel.
    """
    dtype = p_query.dtype
    if T_init is None:
        T_init = jnp.eye(4, dtype=dtype)
    vm = valid.astype(dtype)
    # inverse-depth information: 1/(1+z) on the query side
    w_depth = vm / (1.0 + jnp.maximum(p_query[:, 2], 0.0))

    def step(carry):
        T, it, delta = carry
        q = se3.transform(T, p_ref)                       # [N,3]
        r = q - p_query
        err2 = jnp.sum(r * r, axis=-1)
        w = w_depth * jnp.where(err2 > inlier_m2,
                                inlier_m2 / jnp.maximum(err2, 1e-12), 1.0)
        # J = d(T p)/d xi = [I | -hat(q)]
        eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), q.shape[:-1] + (3, 3))
        J = jnp.concatenate([eye, -se3.hat(q)], axis=-1)  # [N,3,6]
        H = jnp.einsum("nri,n,nrj->ij", J, w, J, precision=_PREC)
        b = jnp.einsum("nri,n,nr->i", J, w, r, precision=_PREC)
        H = H + damping * jnp.eye(6, dtype=dtype)
        xi = -linalg.solve6x6_spd(H, b)
        return se3.apply_left_update(xi, T), it + 1, jnp.max(jnp.abs(xi))

    def cond(carry):
        _, it, delta = carry
        return (it < max_iterations) & (delta > convergence)

    T_f, iters, _ = jax.lax.while_loop(
        cond, step, (T_init, jnp.int32(0), jnp.asarray(jnp.inf, dtype))
    )

    q = se3.transform(T_f, p_ref)
    err2 = jnp.sum((q - p_query) ** 2, axis=-1)
    inlier = valid & (err2 < inlier_m2)
    n_in = jnp.sum(inlier.astype(jnp.int32))
    avg = jnp.sum(jnp.where(inlier, err2, 0.0)) / jnp.maximum(n_in, 1)
    ok = (n_in >= min_inliers) & (avg < max_avg_error) & jnp.all(jnp.isfinite(T_f))
    return ICPResult(T_qr=T_f, ok=ok, inliers=n_in, avg_error=avg, iterations=iters)


align_clouds_batch = jax.vmap(
    lambda pq, pr, v: align_clouds(pq, pr, v),
    in_axes=(0, 0, 0),
)
