"""Per-landmark epipolar band parameters for stage-3 tracking.

JAX replacement for the epipolar-curve stage of
``CFundamentalMatcher::trackEpipolar`` (CFundamentalMatcher.cpp:802-977):
the reference computes, per detection point, a fundamental matrix from the
relative pose, the epipolar line of each landmark's reference observation,
clips the line to a search window scaled by principal-point weight
(CPinholeCamera.h:220-227) and motion (half length = 15 + weight * 10 *
motion_scaling, CFundamentalMatcher.h:92 / .cpp:858-859; motion scaling
CTrackerGT.cpp:157), and samples candidates along the dominant axis with
perpendicular recursion offsets (:2142-2334).

Here the same geometry becomes five per-landmark integers consumed by the
dense window scorer (frontend.tracking): a fixed-point
line normal + offset and two axis reaches. Candidates are ALL window pixels
within perpendicular distance ``BAND_HALF_WIDTH_PX`` of the line and within
the scaled reach — a strict superset of the reference's recursive +-2
offset sampling, at zero extra cost since the window is scored densely
anyway. The fixed-point quantization (x256) makes the band test exact
integer arithmetic, identical on every backend.

Key property (why stage 3 exists): the epipolar line through the landmark's
LAST observation passes through its true current projection regardless of
the error in the landmark's 3D estimate — depth error slides the prediction
*along* the line. The previous fixed horizontal band captured this only for
near-horizontal lines; the oriented band captures any line orientation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from svi_mapper_tpu.mapping.landmarks import LandmarkTable

# fixed-point scale for the line test (exact integer comparisons)
BAND_SCALE = 256
# half-width of the accepted band around the epipolar line, in pixels
# (the reference samples offsets 0/+2 around the curve with recursion
# limit 2, CFundamentalMatcher.cpp:2156-2196; +-2.5 px is the superset)
BAND_HALF_WIDTH_PX = 2.5
BAND_HALF_WIDTH_Q = int(round(BAND_HALF_WIDTH_PX * BAND_SCALE))  # 640
# epipolar line base half-length in pixels (ref CFundamentalMatcher.h:92)
EPIPOLAR_BASE_LENGTH_PX = 15.0
# per-unit-motion-scaling line length gain (ref dHalfLineLength =
# motionScaling * 10, CFundamentalMatcher.cpp:779)
EPIPOLAR_MOTION_GAIN_PX = 10.0

_C0_CLIP = 1 << 20   # keeps |c0q| + |nxq*dx| + |nyq*dy| well inside int32


def motion_scaling(T_delta: jax.Array, cap: float = 5.0) -> jax.Array:
    """Search-window motion scaling from a frame-to-frame pose delta:
    ``min(1 + 10*|rot| + 0.5*|trans|, cap)`` (ref CTrackerGT.cpp:157)."""
    from svi_mapper_tpu.geometry import se3

    w = se3.log_so3(T_delta[:3, :3])
    t = T_delta[:3, 3]
    raw = 1.0 + 10.0 * jnp.linalg.norm(w) + 0.5 * jnp.linalg.norm(t)
    return jnp.minimum(raw, jnp.asarray(cap, raw.dtype))


def epipolar_band_params(
    table: LandmarkTable,
    T_wc_prior: jax.Array,      # [4,4] predicted world->LEFT-camera
    cam_left,                    # PinholeCamera
    uv_pred: jax.Array,          # [L, 2] predicted reprojections (float)
    ms: jax.Array | float = 1.0,  # motion scaling (ref CTrackerGT.cpp:157)
    *,
    reach_x: int,
    reach_y: int,
    base_length_px: float = EPIPOLAR_BASE_LENGTH_PX,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Fixed-point oriented-band parameters per landmark.

    Returns ``(nxq, nyq, c0q, ru, rv)``, all ``[L] int32``:

    * ``(nxq, nyq)`` — unit line normal x ``BAND_SCALE``;
    * ``c0q`` — signed distance (x ``BAND_SCALE``) of the *rounded*
      prediction pixel from the line, so a window offset ``(dx, dy)`` from
      that pixel lies on the band iff
      ``|c0q + nxq*dx + nyq*dy| <= BAND_HALF_WIDTH_Q``;
    * ``(ru, rv)`` — per-axis search reach in pixels: the principal-weight
      and motion scaled half lengths (ref CFundamentalMatcher.cpp:858-859),
      clipped to the scoring window.

    Landmarks whose relative translation since the last observation is
    (near) zero have an undefined fundamental matrix (ref guard at
    CFundamentalMatcher.cpp:841); they fall back to a horizontal band
    through the prediction — the pre-epipolar fixed-band behavior.
    """
    L = table.capacity
    M = table.max_measurements
    dt = uv_pred.dtype
    prec = jax.lax.Precision.HIGHEST

    # --- relative pose last-observation -> prior, per landmark -----------
    idx = (table.meas_next - 1) % M
    T_last = table.meas_T_wc[jnp.arange(L), idx]         # [L,4,4] world->cam
    R_last = T_last[:, :3, :3]
    t_last = T_last[:, :3, 3]
    Rp = T_wc_prior[:3, :3].astype(dt)
    tp = T_wc_prior[:3, 3].astype(dt)
    # T_rel = T_prior @ inv(T_last): maps last-obs camera coords to current
    R_rel = jnp.einsum("ij,lkj->lik", Rp, R_last, precision=prec)  # Rp R_l^T
    t_rel = tp[None, :] - jnp.einsum("lij,lj->li", R_rel, t_last,
                                     precision=prec)               # [L,3]

    # --- F = K^-T [t]x R K^-1 (triangulation.fundamental_from_relative,
    #     batched with the analytic pinhole K inverse) --------------------
    fx = jnp.asarray(cam_left.fx, dt)
    fy = jnp.asarray(cam_left.fy, dt)
    cx = jnp.asarray(cam_left.cx, dt)
    cy = jnp.asarray(cam_left.cy, dt)
    zero = jnp.zeros((), dt)
    one = jnp.ones((), dt)
    K_inv = jnp.stack([
        jnp.stack([1.0 / fx, zero, -cx / fx]),
        jnp.stack([zero, 1.0 / fy, -cy / fy]),
        jnp.stack([zero, zero, one]),
    ])                                                   # [3,3]
    tx, ty, tz = t_rel[:, 0], t_rel[:, 1], t_rel[:, 2]
    z = jnp.zeros_like(tx)
    hat_t = jnp.stack([
        jnp.stack([z, -tz, ty], -1),
        jnp.stack([tz, z, -tx], -1),
        jnp.stack([-ty, tx, z], -1),
    ], -2)                                               # [L,3,3]
    E = jnp.einsum("lij,ljk->lik", hat_t, R_rel, precision=prec)
    F = jnp.einsum("ji,ljk,km->lim", K_inv, E, K_inv,
                   precision=prec)                       # K^-T E K^-1

    # --- line through the LAST observation pixel -------------------------
    uv_last = table.uv_left_last                         # [L,2]
    uv1 = jnp.concatenate([uv_last, jnp.ones((L, 1), dt)], -1)
    line = jnp.einsum("lij,lj->li", F, uv1, precision=prec)   # [L,3] (a,b,c)
    a, b, c = line[:, 0], line[:, 1], line[:, 2]
    norm = jnp.sqrt(a * a + b * b)

    # an empty measurement ring (e.g. just cleared by the BA write-back,
    # which resets meas_count/meas_next but leaves meas_T_wc stale) has no
    # valid last-observation pose — fall back to the fixed-band geometry
    # rather than orienting the band from a garbage slot
    ring_empty = table.meas_count == 0
    degenerate = (jnp.sum(t_rel * t_rel, -1) < 1e-10) | (norm < 1e-12) | ring_empty
    safe = jnp.maximum(norm, 1e-12)
    nx = jnp.where(degenerate, 0.0, a / safe)
    ny = jnp.where(degenerate, 1.0, b / safe)

    # signed distance of the rounded prediction pixel from the line
    uvs = jnp.nan_to_num(uv_pred, nan=0.0, posinf=0.0, neginf=0.0)
    u_r = jnp.round(uvs[:, 0])
    v_r = jnp.round(uvs[:, 1])
    c0 = jnp.where(degenerate, 0.0, (a * u_r + b * v_r + c) / safe)

    nxq = jnp.round(nx * BAND_SCALE).astype(jnp.int32)
    nyq = jnp.round(ny * BAND_SCALE).astype(jnp.int32)
    c0q = jnp.clip(jnp.round(c0 * BAND_SCALE), -_C0_CLIP, _C0_CLIP).astype(jnp.int32)

    # --- principal-weight + motion scaled reach (ref .cpp:858-859) -------
    pw = cam_left.principal_weight(uvs)                  # [L,2]
    half = base_length_px + pw * (EPIPOLAR_MOTION_GAIN_PX * jnp.asarray(ms, dt))
    ru = jnp.clip(jnp.round(half[:, 0]), 1, reach_x).astype(jnp.int32)
    rv = jnp.clip(jnp.round(half[:, 1]), 1, reach_y).astype(jnp.int32)
    return nxq, nyq, c0q, ru, rv


def fixed_band_params(
    L: int, reach_x: int, reach_y: int
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """The pre-epipolar fixed horizontal band (|dy| <= 2, |dx| <= reach_x)
    expressed as band parameters — used when epipolar steering is disabled
    and as the degenerate-translation fallback geometry."""
    z = jnp.zeros((L,), jnp.int32)
    return (
        z,
        z + BAND_SCALE,
        z,
        z + reach_x,
        z + reach_y,
    )
