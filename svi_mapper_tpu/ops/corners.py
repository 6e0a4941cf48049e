"""Shi-Tomasi corner detection with masked grid NMS and fixed-K output.

JAX replacement for the reference's ``cv::GoodFeaturesToTrackDetector``
(1000 features, quality 0.01, min distance 7 — CFundamentalMatcher.cpp:18)
including the active-landmark exclusion mask (CFundamentalMatcher.cpp:2043)
and the regional detection used by tracking stage 2
(CFundamentalMatcher.cpp:495-727).

Design: the variable-length OpenCV keypoint list becomes a fixed-capacity
``[K]`` table with a validity mask. Spatial spreading (GFTT's min-distance)
is achieved with a two-level scheme that is XLA-friendly:
  1. 3x3 local-maximum suppression on the min-eigenvalue response surface;
  2. one winner per ``cell x cell`` grid cell (cheap reshape/argmax);
  3. global top-K over cell winners.
This bounds inter-feature spacing from below by ~cell/2 without any
sequential suppression loop, and every step is a dense masked op.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from svi_mapper_tpu.ops.image import _maxpool_separable, box_blur, sobel_gradients


@functools.partial(jax.jit, static_argnames=("window",))
def min_eig_response(img: jax.Array, window: int = 5) -> jax.Array:
    """Shi-Tomasi corner response: min eigenvalue of the structure tensor.

    lambda_min = (sxx + syy)/2 - sqrt(((sxx - syy)/2)^2 + sxy^2), computed
    from box-filtered Sobel gradient products — the same response GFTT
    ranks by (useMinEigen=true default in the reference's detector).
    """
    ix, iy = sobel_gradients(img)
    sxx = box_blur(ix * ix, window)
    syy = box_blur(iy * iy, window)
    sxy = box_blur(ix * iy, window)
    half_tr = 0.5 * (sxx + syy)
    disc = jnp.sqrt(jnp.maximum(0.25 * (sxx - syy) ** 2 + sxy * sxy, 0.0))
    return half_tr - disc


@functools.partial(jax.jit, static_argnames=("k", "cell", "border"))
def detect_corners(
    img: jax.Array,
    k: int = 1024,
    cell: int = 16,
    quality: float = 0.01,
    border: int = 28,
    mask: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Detect up to ``k`` corners with grid-spread NMS.

    Args:
      img: [H, W] float32 image.
      k: output capacity (ref GFTT cap 1000, CFundamentalMatcher.cpp:18).
      cell: grid cell size in px — lower bound on feature spacing
        (replaces GFTT min-distance 7).
      quality: relative quality level vs the best response (ref 0.01).
      border: exclusion border in px (ref FoV inset 28, CPinholeCamera.h:61).
      mask: optional [H, W] bool — True where detection is ALLOWED
        (the inverse of the reference's occupancy mask around active
        landmarks, CFundamentalMatcher.cpp:2043).

    Returns:
      (uv [k, 2] float32 (u=x, v=y), score [k], valid [k] bool),
      sorted by descending score.
    """
    h, w = img.shape
    resp = min_eig_response(img)

    # 3x3 local maximum test via separable shifted max
    neigh = _maxpool_separable(resp, 1)
    is_peak = resp >= neigh

    # border + user mask
    row = jnp.arange(h)[:, None]
    col = jnp.arange(w)[None, :]
    ok = (row >= border) & (row < h - border) & (col >= border) & (col < w - border)
    if mask is not None:
        ok = ok & mask
    resp_masked = jnp.where(is_peak & ok, resp, -jnp.inf)

    # quality gate relative to the global best (ref GFTT qualityLevel), with
    # a strict positive floor so textureless images yield zero detections
    best = jnp.max(resp_masked)
    floor = jnp.maximum(quality * jnp.maximum(best, 0.0), 1e-6)
    resp_masked = jnp.where(resp_masked > floor, resp_masked, -jnp.inf)

    # one winner per grid cell
    ch = -(-h // cell)
    cw = -(-w // cell)
    padded = jnp.full((ch * cell, cw * cell), -jnp.inf, resp.dtype).at[:h, :w].set(resp_masked)
    cells = padded.reshape(ch, cell, cw, cell).transpose(0, 2, 1, 3).reshape(ch, cw, cell * cell)
    cell_best = jnp.max(cells, axis=-1)
    cell_arg = jnp.argmax(cells, axis=-1)
    cell_v = cell_arg // cell
    cell_u = cell_arg % cell
    vv = (jnp.arange(ch)[:, None] * cell + cell_v).reshape(-1)
    uu = (jnp.arange(cw)[None, :] * cell + cell_u).reshape(-1)
    scores = cell_best.reshape(-1)

    # global top-k over cell winners
    k_eff = min(k, scores.shape[0])
    top_scores, top_idx = jax.lax.top_k(scores, k_eff)
    sel_u = uu[top_idx].astype(jnp.float32)
    sel_v = vv[top_idx].astype(jnp.float32)
    valid = jnp.isfinite(top_scores)
    uv = jnp.stack([sel_u, sel_v], axis=-1)
    if k_eff < k:
        uv = jnp.pad(uv, ((0, k - k_eff), (0, 0)))
        top_scores = jnp.pad(top_scores, (0, k - k_eff), constant_values=-jnp.inf)
        valid = jnp.pad(valid, (0, k - k_eff))
    uv = jnp.where(valid[:, None], uv, 0.0)
    return uv, jnp.where(valid, top_scores, 0.0), valid


def occupancy_mask(
    shape: tuple[int, int], uv: jax.Array, valid: jax.Array, radius: int = 7
) -> jax.Array:
    """Detection-allowed mask that excludes disks around existing features.

    Replaces the reference's per-landmark ``cv::circle`` mask painting
    (CFundamentalMatcher.cpp:2043) with a scatter + box dilation: True
    where detection is allowed.
    """
    h, w = shape
    occ = jnp.zeros((h, w), jnp.float32)
    ui = jnp.clip(uv[:, 0].astype(jnp.int32), 0, w - 1)
    vi = jnp.clip(uv[:, 1].astype(jnp.int32), 0, h - 1)
    occ = occ.at[vi, ui].add(jnp.where(valid, 1.0, 0.0))
    # dilate by a (2r+1)^2 box via separable shifted max
    occ = _maxpool_separable(occ, radius)
    return occ <= 0.0
