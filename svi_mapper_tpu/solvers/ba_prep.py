"""On-device BA window preparation: depth gating, re-init, tier weights.

One jitted program replaces the host-side numpy einsums that used to run on
the back-end worker thread before every BA chunk (VERDICT r3 Weak-6: in
overlapped mode those einsums contended for the GIL with the tracker
thread's dispatch loop). Three stages, all masked lattice ops:

  * **depth-consistency gate** (ref 0.75 < |p_est|^2/|p_meas|^2 < 1.25,
    Cg2oOptimizer.cpp:1403-1410): an observation whose stereo-triangulated
    range disagrees with the current estimate by >25% never enters BA,
    with a 1 px pixel-space tolerance floor for far landmarks whose
    sub-pixel disparity noise breaks the relative band (the reference's
    disparity tier likewise bottoms out at 1 px, :1444-1447).
  * **self-consistency re-init**: when a landmark's measurements agree
    with EACH OTHER but not with its estimate, the estimate is re-seeded
    from the measurement back-projections (the reference gets this free —
    its vertex estimates start FROM the measured points, :1383-1401).
  * **depth-tiered information** (ref dInformationFactor = 1/z common to
    all three edge tiers, :1403; far landmarks need > 1 px of disparity,
    :1444-1447): per-observation weights 1/max(z, 1), mean-normalized over
    the window so the robust kernel's px^2 scale stays calibrated. The
    tier-specific unit constants (1000 m^-2 XYZ / x100 depth / x1000
    disparity) belong to the reference's mixed-unit residuals and don't
    transfer to our uniform pixel-space residual; the 1/z law and the
    far-disparity floor are the transferable content.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from svi_mapper_tpu.geometry.camera import StereoCamera
from svi_mapper_tpu.utils import struct

_PREC = jax.lax.Precision.HIGHEST


@struct.dataclass
class BAWindowPrep:
    mask: jax.Array       # [K,L] bool — post-gate observation mask
    X0: jax.Array         # [L,3] — (possibly re-seeded) landmark initializer
    obs_w: jax.Array      # [K,L] — per-observation information scale
    n_gated: jax.Array    # int32 — observations removed by the depth gate
    n_reinit: jax.Array   # int32 — landmarks re-seeded from measurements
    n_obs: jax.Array      # int32 — surviving observation count


@functools.partial(
    jax.jit, static_argnames=("depth_weighting",))
def prepare_ba_window(
    T0: jax.Array,        # [K,4,4] keyframe poses (world->camera)
    obs: jax.Array,       # [K,L,4] stereo observations [uL,vL,uR,vR]
    mask: jax.Array,      # [K,L] bool
    X0: jax.Array,        # [L,3] current landmark estimates (world)
    cam: StereoCamera,
    *,
    far_d2: float = 50.0,          # squared range of the far tier
    min_far_disparity: float = 1.0,
    depth_weighting: bool = True,
) -> BAWindowPrep:
    fxl, fyl = cam.left.fx, cam.left.fy
    cxl, cyl = cam.left.cx, cam.left.cy
    bq = cam.right.P[0, 3]
    dtype = X0.dtype

    disp = obs[..., 0] - obs[..., 2]                          # [K,L]
    inf = jnp.asarray(jnp.inf, dtype)
    z_meas = jnp.where(disp > 0.01, -bq / jnp.maximum(disp, 0.01), inf)
    x_meas = (obs[..., 0] - cxl) * z_meas / fxl
    y_meas = (obs[..., 1] - cyl) * z_meas / fyl
    d2_meas = x_meas ** 2 + y_meas ** 2 + z_meas ** 2
    m0 = mask & jnp.isfinite(d2_meas)

    def gate(X):
        p_est = (jnp.einsum("kij,lj->kli", T0[:, :3, :3], X, precision=_PREC)
                 + T0[:, None, :3, 3])
        rel = jnp.sum(p_est ** 2, -1) / d2_meas
        band = jnp.isfinite(rel) & (rel > 0.75) & (rel < 1.25)
        # pixel-space tolerance floor (see module docstring)
        d_pred = -bq / jnp.maximum(p_est[..., 2], 1e-3)
        return band | (jnp.abs(disp - d_pred) <= 1.0)

    n_obs_l = jnp.maximum(jnp.sum(m0, 0), 1)                  # [L]
    consistent = gate(X0)
    bad_frac = jnp.sum(m0 & ~consistent, 0) / n_obs_l

    # measurement self-consistency: back-projected world points of one
    # landmark must cluster relative to the measured range
    p_meas = jnp.stack([x_meas, y_meas, z_meas], -1)          # [K,L,3]
    p_w = jnp.einsum(
        "kji,klj->kli", T0[:, :3, :3],
        jnp.where(m0[..., None], p_meas, 0.0) - T0[:, None, :3, 3],
        precision=_PREC)
    mean_w = jnp.sum(p_w * m0[..., None], 0) / n_obs_l[:, None]
    spread2 = jnp.sum(jnp.sum((p_w - mean_w) ** 2, -1) * m0, 0) / n_obs_l
    rbar = jnp.sum(jnp.sqrt(jnp.where(m0, d2_meas, 0.0)), 0) / n_obs_l
    self_ok = (jnp.sum(m0, 0) >= 2) & (jnp.sqrt(spread2) < 0.25 * rbar)
    reinit = self_ok & (bad_frac > 0.5)
    X0_new = jnp.where(reinit[:, None], mean_w, X0)
    consistent = gate(X0_new)

    # far landmarks with sub-threshold disparity never constrain (ref
    # 1.0 < dDisparity requirement of the disparity tier, :1444-1447)
    far_drop = (d2_meas >= far_d2) & (disp <= min_far_disparity)

    n_gated = jnp.sum(mask & ~consistent).astype(jnp.int32)
    mask_new = mask & consistent & ~far_drop
    # a landmark reduced below two observations no longer constrains
    mask_new = mask_new & (jnp.sum(mask_new, 0) >= 2)[None, :]

    if depth_weighting:
        w = jnp.where(m0, 1.0 / jnp.clip(z_meas, 1.0, 1e4), 0.0)
        mean_w_obs = (jnp.sum(jnp.where(mask_new, w, 0.0))
                      / jnp.maximum(jnp.sum(mask_new), 1))
        obs_w = jnp.where(mask_new, w / jnp.maximum(mean_w_obs, 1e-9), 0.0)
    else:
        obs_w = mask_new.astype(dtype)

    return BAWindowPrep(
        mask=mask_new, X0=X0_new, obs_w=obs_w,
        n_gated=n_gated,
        n_reinit=jnp.sum(reinit).astype(jnp.int32),
        n_obs=jnp.sum(mask_new).astype(jnp.int32),
    )
