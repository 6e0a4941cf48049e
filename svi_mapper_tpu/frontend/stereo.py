"""Epipolar-row stereo correspondence on the dense descriptor field.

JAX replacement for ``CTriangulator`` (CTriangulator.cpp:13-356):
the reference generates a dense row of candidate keypoints along the
rectified scanline in RIGHT, extracts BRIEF for each, and brute-force
Hamming-matches (cutoff 100, search range bounded by the last disparity or
60 px, depth from disparity with a min-disparity floor). Here the right
image's descriptors are precomputed densely once (ops.descriptors.brief_dense)
so the scanline search is one contiguous ``[D, 8]`` row slice per keypoint
(vmapped ``dynamic_slice``: contiguous reads instead of a point gather) +
XOR-popcount + masked argmin, fused for all keypoints at once.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from svi_mapper_tpu.geometry.camera import StereoCamera
from svi_mapper_tpu.utils import struct

_BIG = jnp.int32(1 << 20)


@struct.dataclass
class StereoMatches:
    uv_right: jax.Array    # [K, 2]
    disparity: jax.Array   # [K]
    depth: jax.Array       # [K]
    p_cam: jax.Array       # [K, 3] triangulated camera-frame points
    distance: jax.Array    # [K] Hamming distance of the accepted match
    ok: jax.Array          # [K] bool


@functools.partial(
    jax.jit, static_argnames=("max_disparity", "cutoff")
)
def match_stereo(
    dense_right: jax.Array,     # [H, W, 8] uint32 dense BRIEF of RIGHT
    uv_left: jax.Array,         # [K, 2] left keypoints
    desc_left: jax.Array,       # [K, 8] their descriptors
    valid: jax.Array,           # [K] bool
    cam: StereoCamera,
    *,
    max_disparity: int = 128,
    cutoff: int = 100,          # ref CTriangulator.cpp:13
    min_disparity: float = 0.5,
    min_depth: float = 0.05,
    max_depth: float = 1000.0,
    disparity_center: jax.Array | None = None,  # [K] previous disparity
    search_range: jax.Array | None = None,      # [K] +- px around center
) -> StereoMatches:
    """Match left keypoints into the right image along rectified scanlines.

    When ``disparity_center``/``search_range`` are given the candidate set is
    masked to ``|d - center| <= range`` — the reference's bounded re-search
    around the last disparity (CTriangulator.h:20-21, fMinimumSearchRange 60).

    Returns a StereoMatches batch; ``ok`` encodes what the reference
    signalled with CExceptionNoMatchFound / CExceptionZeroDisparity.
    """
    K = uv_left.shape[0]
    D = max_disparity
    h, w = dense_right.shape[:2]

    De = min(D, w)   # images narrower than the search range: clamp the span
    u_r = jnp.clip(jnp.round(uv_left[:, 0]).astype(jnp.int32), 0, w - 1)
    v_r = jnp.clip(jnp.round(uv_left[:, 1]).astype(jnp.int32), 0, h - 1)

    # contiguous row-span fetch: the De scanline candidates left of the
    # keypoint are one [De, 8] slice of the dense field; reversing the
    # span makes index i correspond to disparity base + i
    x0 = jnp.clip(u_r - (De - 1), 0, w - De)

    def cut(y, x):
        return jax.lax.dynamic_slice(dense_right, (y, x, 0), (1, De, 8))

    cand_desc = jax.vmap(cut)(v_r, x0)[:, 0, ::-1, :]             # [K, De, 8]
    # disparity of reversed-span index i: u = x0 + (De-1) - i, d = u_r - u
    base = (u_r - x0 - (De - 1)).astype(uv_left.dtype)            # [K] (<= 0)
    disps = base[:, None] + jnp.arange(De, dtype=uv_left.dtype)[None, :]

    # Hamming of each candidate against its left descriptor
    x = cand_desc ^ desc_left[:, None, :]
    dist = jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)

    # candidate validity: inside image (in FLOAT coordinates, u - d >= 0 —
    # keeps the left-edge semantics of the pregather formulation), disparity
    # floor + ceiling, optional range bound
    okc = (disps >= min_disparity) & (disps <= uv_left[:, 0:1]) \
        & (disps <= De - 1)
    if disparity_center is not None:
        rng = search_range if search_range is not None else jnp.full((K,), 60.0, uv_left.dtype)
        okc = okc & (jnp.abs(disps - disparity_center[:, None]) <= rng[:, None])
    dist = jnp.where(okc, dist, _BIG)

    best = jnp.argmin(dist, axis=1).astype(jnp.int32)             # [K]
    best_dist = jnp.take_along_axis(dist, best[:, None], axis=1)[:, 0]
    disparity = jnp.take_along_axis(disps, best[:, None], axis=1)[:, 0]

    # refine disparity to sub-pixel with a 3-point parabola on the Hamming
    # profile (cheap accuracy win over the reference's integer candidates)
    S = dist.shape[1]
    dm = jnp.take_along_axis(dist, jnp.clip(best - 1, 0, S - 1)[:, None], axis=1)[:, 0]
    dp = jnp.take_along_axis(dist, jnp.clip(best + 1, 0, S - 1)[:, None], axis=1)[:, 0]
    denom = (dm + dp - 2 * best_dist).astype(uv_left.dtype)
    interior = (best > 0) & (best < S - 1)
    delta = jnp.where(
        interior & (denom > 0) & (dm < _BIG) & (dp < _BIG),
        0.5 * (dm - dp).astype(uv_left.dtype) / jnp.maximum(denom, 1e-6),
        0.0,
    )
    disparity = disparity + jnp.clip(delta, -0.5, 0.5)

    depth = cam.depth_from_disparity(disparity)
    uv_right = jnp.stack([uv_left[:, 0] - disparity, uv_left[:, 1]], axis=-1)
    p_cam = cam.triangulate(uv_left, uv_right)

    ok = (
        valid
        & (best_dist <= cutoff)
        & (disparity >= min_disparity)
        & (depth > min_depth)
        & (depth < max_depth)
    )
    return StereoMatches(
        uv_right=uv_right,
        disparity=disparity,
        depth=depth,
        p_cam=p_cam,
        distance=best_dist,
        ok=ok,
    )
