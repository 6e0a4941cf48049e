"""Closed-form small linear algebra for the GN/LM solvers.

Rationale: ``jnp.linalg.solve``/``inv`` lower to LU library calls that
serialize per batch element — ruinous for the tiny 3x3/6x6 normal-equation
systems every solver in this package builds
(landmark refinement CLandmark.cpp:447-581 has one 3x3 per landmark; stereo
posit CSolverStereoPosit.cpp:108 and closure ICP CTrackerGT.cpp:535-630 one
6x6 per iteration). Closed forms are pure fused elementwise ops: they vmap,
batch, and fuse into the surrounding kernels.

All inputs are assumed damped SPD (every call site adds Levenberg damping),
which keeps the cofactor/Schur forms well-conditioned in float32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def inv3x3(M: jax.Array) -> jax.Array:
    """Batched closed-form 3x3 inverse (adjugate / determinant).

    Accepts any leading batch shape: ``[..., 3, 3] -> [..., 3, 3]``.
    """
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20,
                              jnp.where(det < 0, -1e-20, 1e-20), det)
    adj = jnp.stack([
        jnp.stack([A, B, C], axis=-1),
        jnp.stack([D, E, F], axis=-1),
        jnp.stack([G, H, I], axis=-1),
    ], axis=-2)
    return adj * inv_det[..., None, None]


def solve3x3(M: jax.Array, b: jax.Array) -> jax.Array:
    """``[..., 3, 3] @ x = [..., 3]`` via the closed-form inverse."""
    return jnp.einsum("...ij,...j->...i", inv3x3(M), b)


def solve6x6_spd(M: jax.Array, b: jax.Array) -> jax.Array:
    """Solve a (damped) SPD ``[..., 6, 6]`` system by 3x3-block Schur
    elimination — two closed-form 3x3 inverses, no LU custom call.

    M = [[A, B], [B^T, D]]; S = D - B^T A^-1 B;
    x2 = S^-1 (b2 - B^T A^-1 b1); x1 = A^-1 (b1 - B x2).
    """
    A = M[..., :3, :3]
    B = M[..., :3, 3:]
    D = M[..., 3:, 3:]
    b1 = b[..., :3]
    b2 = b[..., 3:]
    Ainv = inv3x3(A)
    AinvB = jnp.einsum("...ij,...jk->...ik", Ainv, B)
    S = D - jnp.einsum("...ji,...jk->...ik", B, AinvB)
    Ainv_b1 = jnp.einsum("...ij,...j->...i", Ainv, b1)
    rhs2 = b2 - jnp.einsum("...ji,...j->...i", B, Ainv_b1)
    x2 = solve3x3(S, rhs2)
    x1 = Ainv_b1 - jnp.einsum("...ij,...j->...i", AinvB, x2)
    return jnp.concatenate([x1, x2], axis=-1)
