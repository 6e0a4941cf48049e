"""Multi-view triangulation + epipolar geometry, batched.

JAX replacement for the linear-triangulation and epipolar utilities of
``CMiniVisionToolbox`` (essential/fundamental from relative pose
CMiniVisionToolbox.h:50-52, linear stereo triangulation SVD/QR/LU/DLT variants
:54-56/:88-94, epipolar distance :57). The reference solves one 4x4 SVD per
point; here every variant is a closed-form batched solve so thousands of
points triangulate in one fused XLA computation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_PREC = jax.lax.Precision.HIGHEST

from svi_mapper_tpu.geometry import se3


def triangulate_dlt(
    P_left: jax.Array, P_right: jax.Array, uv_left: jax.Array, uv_right: jax.Array
) -> jax.Array:
    """General DLT triangulation for (possibly unrectified) stereo.

    Builds the standard 4x4 homogeneous system (rows u*P3-P1, v*P3-P2 per
    view; ref CMiniVisionToolbox.cpp triangulation family) and solves the
    inhomogeneous 4x3 least-squares via normal equations — a batched 3x3
    solve instead of the reference's per-point Jacobi SVD
    (CMiniVisionToolbox.h:54).

    Args:
      P_left, P_right: (..., 3, 4) projection matrices (world or cam frame).
      uv_left, uv_right: (..., 2) pixel measurements.

    Returns:
      (..., 3) points in the frame the projection matrices map from.
    """
    rows = []
    for P, uv in ((P_left, uv_left), (P_right, uv_right)):
        rows.append(uv[..., 0, None] * P[..., 2, :] - P[..., 0, :])
        rows.append(uv[..., 1, None] * P[..., 2, :] - P[..., 1, :])
    A = jnp.stack(rows, axis=-2)  # (..., 4, 4)
    M = A[..., :3]
    b = -A[..., 3]
    AtA = jnp.einsum("...ki,...kj->...ij", M, M, precision=_PREC)
    Atb = jnp.einsum("...ki,...k->...i", M, b, precision=_PREC)
    # Levenberg damping keeps degenerate rays finite in float32.
    AtA = AtA + 1e-9 * jnp.eye(3, dtype=AtA.dtype)
    return jnp.linalg.solve(AtA, Atb[..., None])[..., 0]


def essential_from_relative(T_ab: jax.Array) -> jax.Array:
    """Essential matrix of the relative pose a->b: E = [t]_x R
    (ref CMiniVisionToolbox.h:50)."""
    R = T_ab[..., :3, :3]
    t = T_ab[..., :3, 3]
    return jnp.matmul(se3.hat(t), R, precision=_PREC)


def fundamental_from_relative(
    T_ab: jax.Array, K_a: jax.Array, K_b: jax.Array
) -> jax.Array:
    """Fundamental matrix F = K_b^-T E K_a^-1 (ref CMiniVisionToolbox.h:51;
    used per detection point in CFundamentalMatcher.cpp:802-806)."""
    E = essential_from_relative(T_ab)
    Kbi = jnp.linalg.inv(K_b).swapaxes(-1, -2)
    Kai = jnp.linalg.inv(K_a)
    return jnp.matmul(jnp.matmul(Kbi, E, precision=_PREC), Kai, precision=_PREC)


def epipolar_line(F: jax.Array, uv: jax.Array) -> jax.Array:
    """Line coefficients (a, b, c) in image b for pixels in image a:
    l = F @ [u, v, 1]."""
    uv1 = jnp.concatenate([uv, jnp.ones_like(uv[..., :1])], axis=-1)
    return jnp.einsum("...ij,...j->...i", F, uv1, precision=_PREC)


def epipolar_distance(F: jax.Array, uv_a: jax.Array, uv_b: jax.Array) -> jax.Array:
    """Point-to-epipolar-line distance in image b
    (ref CMiniVisionToolbox.h:57)."""
    l = epipolar_line(F, uv_a)
    uv1 = jnp.concatenate([uv_b, jnp.ones_like(uv_b[..., :1])], axis=-1)
    num = jnp.abs(jnp.sum(l * uv1, axis=-1))
    den = jnp.sqrt(l[..., 0] ** 2 + l[..., 1] ** 2)
    return num / jnp.maximum(den, 1e-12)
