"""Temporal landmark tracking: the 3-stage matcher as one masked window op.

JAX replacement for the tracking engine of ``CFundamentalMatcher``
(CFundamentalMatcher.cpp:391-2397). The reference runs, per landmark, a
try/catch cascade of three stages:
  stage 1 — direct reprojection descriptor check (cutoff 25, :391-487);
  stage 2 — regional GFTT + brute-force recovery   (cutoff 50, :495-727);
  stage 3 — recursive epipolar-curve sampling      (cutoff 50, :2142-2397),
with search windows scaled by principal-point weight and motion
(:856-977) and a dual-descriptor acceptance (distance to the *last* AND to
the *original* descriptor, :2336-2397).

Here the cascade becomes ONE dense scoring of the ``WIN_H x WIN_W`` window
around each landmark's predicted reprojection: every window pixel is
XOR-popcount scored against the landmark's last and reference descriptors,
then masked into three tiers —

  tier 0: the 3x3 cell at the prediction            (stage 1, cutoff 25)
  tier 1: |dx|, |dy| <= 8                            (stage 2, cutoff 50)
  tier 2: the per-landmark **oriented epipolar band**
          (frontend.epipolar): pixels within 2.5 px of the landmark's
          epipolar line, within the principal-weight/motion scaled reach
          (stage 3, cutoff 50)

— and reduced by a masked argmin whose score bias enforces the cascade
priority (a stage-1 acceptance always beats stage-2 beats stage-3). The
dual-descriptor rule applies to every candidate. Scoring every window
pixel is free relative to the lattice-gather it replaces: the window is
sliced once per landmark from the dense field, the band test is
fixed-point integer arithmetic, and ties break by row-major window
position, so the result is deterministic on every backend.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from svi_mapper_tpu.frontend.epipolar import (
    BAND_HALF_WIDTH_Q,
    epipolar_band_params,
    fixed_band_params,
)
from svi_mapper_tpu.geometry import se3
from svi_mapper_tpu.geometry.camera import StereoCamera
from svi_mapper_tpu.mapping.landmarks import LandmarkTable
from svi_mapper_tpu.ops.descriptors import brief_at
from svi_mapper_tpu.utils import struct

# window geometry: the acceptance-mask reach around each prediction
REACH_X = 28                 # ref: epipolar reach, <= the 28 px FoV inset
REACH_Y = 20                 # vertical reach for steep epipolar lines
WIN_W = 2 * REACH_X + 1      # 57 px of candidate reach
WIN_H = 2 * REACH_Y + 1      # 41

# score bias per tier: stage-1 hits dominate stage-2 dominate stage-3,
# mirroring the reference's cascade short-circuit order
TIER_BIAS = (0, 1000, 2000)

_BIG = jnp.int32(1 << 20)
# rejected-candidate sentinel before the BIG rewrite: small enough that the
# fused (score, position) min key score * 4096 + pos stays exact in int32
# (pos < WIN_H * WIN_W = 2337 < 4096)
_BIG_K = 4096


@struct.dataclass
class TrackResult:
    tracked: jax.Array      # [L] bool — matched this frame (left + right)
    uv4: jax.Array          # [L, 4] (uL, vL, uR, vR)
    desc_left: jax.Array    # [L, 8] descriptor at the matched left location
    p_cam: jax.Array        # [L, 3] instantaneous stereo triangulation
    depth: jax.Array        # [L]
    tier: jax.Array         # [L] int32 — which stage matched (0/1/2)
    distance: jax.Array     # [L] Hamming distance (to last descriptor)
    uv_pred: jax.Array      # [L, 2] predicted left reprojection


def tier_scores(dx, dy, d_last, ref_ok, nxq, nyq, c0q, ru, rv,
                cutoff_s1, cutoff_s2):
    """The shared per-pixel tier scoring over integer window offsets.

    ``dx, dy`` are int32 offsets from the rounded prediction pixel (any
    broadcastable shape); ``d_last`` the Hamming distance to the last
    descriptor; ``ref_ok`` the dual-descriptor gate;
    ``nxq/nyq/c0q/ru/rv`` the per-landmark band parameters broadcast
    alongside. Tiers are CUMULATIVE fallbacks, as in the reference's
    cascade: a pixel inside the stage-1 cell that fails the strict cutoff
    25 can still be accepted by stage 2 at cutoff 50 (the reference's
    regional recovery searches the whole region including the prediction,
    CFundamentalMatcher.cpp:495-727). Per-pixel score = min over tiers of
    ``d_last + tier_bias`` where the tier's region and cutoff accept.

    This is THE tracking acceptance spec. Returns the int32 score
    (``_BIG_K`` where nothing accepts).
    """
    adx, ady = jnp.abs(dx), jnp.abs(dy)
    t0 = (adx <= 1) & (ady <= 1)
    t1 = (adx <= 8) & (ady <= 8)
    band = jnp.abs(c0q + nxq * dx + nyq * dy) <= BAND_HALF_WIDTH_Q
    t2 = band & (adx <= ru) & (ady <= rv)
    s0 = jnp.where(t0 & (d_last <= cutoff_s1) & ref_ok,
                   d_last + TIER_BIAS[0], _BIG_K)
    ok2 = (d_last <= cutoff_s2) & ref_ok
    s1 = jnp.where(t1 & ok2, d_last + TIER_BIAS[1], _BIG_K)
    s2 = jnp.where(t2 & ok2, d_last + TIER_BIAS[2], _BIG_K)
    return jnp.minimum(s0, jnp.minimum(s1, s2))


def window_scores(
    dense: jax.Array,          # [H, W, 8] uint32 dense BRIEF field
    uv_pred: jax.Array,        # [L, 2] float predictions
    desc_last: jax.Array,      # [L, 8] uint32
    desc_ref: jax.Array,       # [L, 8] uint32
    band: tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array],
    *,
    cutoff_s1: int,
    cutoff_s2: int,
    cutoff_ref: int,
):
    """Dense window scorer: every window pixel of every landmark at once.

    Returns ``(score [L], x [L], y [L], dist [L])`` int32 — the biased best
    score (>= 1<<20 if no acceptance), the winning pixel, and its Hamming
    distance to the last descriptor.
    """
    h, w, _ = dense.shape
    nxq, nyq, c0q, ru, rv = band

    uvs = jnp.nan_to_num(uv_pred, nan=0.0, posinf=0.0, neginf=0.0)
    u_r = jnp.clip(jnp.round(uvs[:, 0]).astype(jnp.int32), 0, w - 1)
    v_r = jnp.clip(jnp.round(uvs[:, 1]).astype(jnp.int32), 0, h - 1)
    x0 = jnp.clip(u_r - REACH_X, 0, w - WIN_W)
    y0 = jnp.clip(v_r - REACH_Y, 0, h - WIN_H)

    win = jax.vmap(
        lambda y, x: jax.lax.dynamic_slice(dense, (y, x, 0), (WIN_H, WIN_W, 8))
    )(y0, x0)                                              # [L, WH, WW, 8]

    d_last = jnp.sum(
        jax.lax.population_count(win ^ desc_last[:, None, None, :]), -1
    ).astype(jnp.int32)                                    # [L, WH, WW]
    d_ref = jnp.sum(
        jax.lax.population_count(win ^ desc_ref[:, None, None, :]), -1
    ).astype(jnp.int32)

    col = jnp.arange(WIN_W, dtype=jnp.int32)
    row = jnp.arange(WIN_H, dtype=jnp.int32)
    dx = (x0[:, None, None] + col[None, None, :]) - u_r[:, None, None]
    dy = (y0[:, None, None] + row[None, :, None]) - v_r[:, None, None]

    score = tier_scores(
        dx, dy, d_last, d_ref <= cutoff_ref,
        nxq[:, None, None], nyq[:, None, None], c0q[:, None, None],
        ru[:, None, None], rv[:, None, None],
        jnp.int32(cutoff_s1), jnp.int32(cutoff_s2),
    )

    # fused (score, position) min key: window-local row-major position, so
    # equal-score ties resolve to the first pixel in (y, x) order
    pos = (row[None, :, None] * jnp.int32(WIN_W) + col[None, None, :]
           + jnp.zeros_like(score))
    key = jnp.min((score * _BIG_K + pos).reshape(score.shape[0], -1), axis=1)
    best_score = key // _BIG_K
    rel = key % _BIG_K
    x = x0 + rel % WIN_W
    y = y0 + rel // WIN_W
    best_score = jnp.where(best_score >= _BIG_K, _BIG, best_score)
    dist = best_score % 1000
    return best_score, x, y, dist


@functools.partial(
    jax.jit,
    static_argnames=(
        "cutoff_s1", "cutoff_s2", "cutoff_ref", "cutoff_stereo",
        "max_disparity", "use_epipolar", "use_desc_history",
    ),
)
def track_landmarks(
    dense_left: jax.Array,      # [H, W, 8] dense BRIEF of current LEFT
    dense_right: jax.Array,     # [H, W, 8] dense BRIEF of current RIGHT
    table: LandmarkTable,
    T_wc_prior: jax.Array,      # [4,4] predicted world->LEFT-camera
    cam: StereoCamera,
    motion_scaling: jax.Array | float = 1.0,
    *,
    cutoff_s1: int = 25,        # ref CFundamentalMatcher.cpp:23
    cutoff_s2: int = 50,        # ref :24-26 (stage2 + epipolar)
    cutoff_ref: int = 50,       # vs the original descriptor (ref _getMatch)
    cutoff_stereo: int = 100,   # right-image re-match: the stereo
                                # correspondence runs through CTriangulator,
                                # cutoff 100 (ref CTriangulator.cpp:13)
    max_disparity: int = 128,
    use_epipolar: bool = True,  # False = legacy fixed horizontal band
    use_desc_history: bool = True,  # anchor the ref gate on the history ring
) -> TrackResult:
    """Track every active landmark into the current stereo frame."""
    from svi_mapper_tpu.frontend.stereo import match_stereo
    from svi_mapper_tpu.mapping.landmarks import anchor_descriptors

    # The "original"-descriptor side of the dual gate: either the creation
    # descriptor (plain reference rule) or the nearest history-ring
    # snapshot (drift-tolerant anchor, see mapping.landmarks). Resolved
    # per landmark BEFORE scoring, so the window pass consumes one [L, 8]
    # anchor.
    desc_anchor = (anchor_descriptors(table) if use_desc_history
                   else table.desc_left_ref)

    L = table.capacity
    pos_w = table.pos_w
    p_c = se3.transform(T_wc_prior, pos_w)                 # [L, 3]
    uv_pred = cam.left.project(p_c)                        # [L, 2]
    in_front = p_c[:, 2] > 0.05
    in_view = cam.left.in_fov(uv_pred) & in_front

    if use_epipolar:
        band = epipolar_band_params(
            table, T_wc_prior, cam.left, uv_pred, motion_scaling,
            reach_x=REACH_X, reach_y=REACH_Y,
        )
    else:
        band = fixed_band_params(L, REACH_X, REACH_Y)

    uvs = jnp.nan_to_num(uv_pred, nan=0.0, posinf=0.0, neginf=0.0)
    frac = uvs - jnp.round(uvs)

    best_score, x, y, best_dist = window_scores(
        dense_left, uv_pred, table.desc_left_last, desc_anchor,
        band,
        cutoff_s1=cutoff_s1, cutoff_s2=cutoff_s2, cutoff_ref=cutoff_ref,
    )

    uv_l = jnp.stack(
        [x.astype(uv_pred.dtype), y.astype(uv_pred.dtype)], axis=-1
    ) + frac
    best_tier = jnp.clip(best_score // 1000, 0, 2)

    left_ok = (best_score < _BIG) & in_view & table.active
    # descriptor at the matched pixel (round(uv_l) is exactly that pixel:
    # the carried fractional part is < 0.5 by construction)
    desc_new = brief_at(dense_left, uv_l)

    # right-image correspondence around the last disparity
    # (ref CTriangulator bounded search, CTriangulator.h:20-21)
    sm = match_stereo(
        dense_right, uv_l, desc_new, left_ok, cam,
        max_disparity=max_disparity,
        cutoff=cutoff_stereo,
        disparity_center=table.disparity_last,
        search_range=jnp.maximum(
            jnp.asarray(20.0, pos_w.dtype),
            0.5 * table.disparity_last,
        ),
    )
    tracked = left_ok & sm.ok
    uv4 = jnp.concatenate([uv_l, sm.uv_right], axis=-1)
    return TrackResult(
        tracked=tracked,
        uv4=uv4,
        desc_left=desc_new,
        p_cam=sm.p_cam,
        depth=sm.depth,
        tier=best_tier,
        distance=best_dist,
        uv_pred=uv_pred,
    )
