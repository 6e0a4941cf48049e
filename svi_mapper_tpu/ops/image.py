"""Image-plane device ops: blur, gradients, histogram equalization, remap.

JAX replacement for the reference's OpenCV image calls:
``cv::GaussianBlur``-style smoothing before BRIEF extraction (the reference
relies on OpenCV's BriefDescriptorExtractor which smooths internally),
``cv::equalizeHist`` (CTrackerSVI.cpp:339-341), and
``cv::remap``/``initUndistortRectifyMap`` rectification
(CStereoCamera.h:89-107, CStereoCameraIMU.h:20-52).

All ops take float32 single-channel images shaped ``[H, W]`` and are pure jnp
so XLA fuses them into the frame step.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _conv1d(img: jax.Array, kernel: jax.Array, axis: int) -> jax.Array:
    """Separable 1D convolution along an axis with SAME edge padding.

    Implemented as shift-multiply-accumulate over the (small, static) tap
    count rather than ``conv_general_dilated``: k shifted adds of a
    1-channel image fuse into a couple of elementwise passes.
    """
    k = kernel.shape[0]
    pad = k // 2
    if axis == 0:
        padded = jnp.pad(img, ((pad, pad), (0, 0)), mode="edge")
    else:
        padded = jnp.pad(img, ((0, 0), (pad, pad)), mode="edge")
    h, w = img.shape
    out = jnp.zeros_like(img)
    for i in range(k):
        tap = jax.lax.dynamic_slice(
            padded, (i, 0) if axis == 0 else (0, i), (h, w)
        )
        out = out + tap * kernel[i]
    return out


def _maxpool_separable(img: jax.Array, radius: int) -> jax.Array:
    """(2r+1)^2 max filter as two separable shifted-max passes."""
    h, w = img.shape

    def pass_axis(x, axis):
        padded = jnp.pad(
            x,
            ((radius, radius), (0, 0)) if axis == 0 else ((0, 0), (radius, radius)),
            constant_values=-jnp.inf,
        )
        out = x
        for i in range(2 * radius + 1):
            if i == radius:
                continue
            tap = jax.lax.dynamic_slice(
                padded, (i, 0) if axis == 0 else (0, i), (h, w)
            )
            out = jnp.maximum(out, tap)
        return out

    return pass_axis(pass_axis(img, 0), 1)


@functools.partial(jax.jit, static_argnames=("size",))
def box_blur(img: jax.Array, size: int = 9) -> jax.Array:
    """Separable box blur (the BRIEF smoothing window)."""
    k = jnp.full((size,), 1.0 / size, dtype=img.dtype)
    return _conv1d(_conv1d(img, k, 0), k, 1)


def _gaussian_kernel(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("sigma", "radius"))
def gaussian_blur(img: jax.Array, sigma: float = 2.0, radius: int = 4) -> jax.Array:
    k = jnp.asarray(_gaussian_kernel(sigma, radius), dtype=img.dtype)
    return _conv1d(_conv1d(img, k, 0), k, 1)


@jax.jit
def sobel_gradients(img: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Sobel x/y gradients (separable [1 2 1] x [-1 0 1])."""
    smooth = jnp.asarray([1.0, 2.0, 1.0], dtype=img.dtype)
    diff = jnp.asarray([-1.0, 0.0, 1.0], dtype=img.dtype)
    ix = _conv1d(_conv1d(img, smooth, 0), diff, 1)
    iy = _conv1d(_conv1d(img, diff, 0), smooth, 1)
    return ix, iy


@jax.jit
def equalize_hist(img_u8: jax.Array) -> jax.Array:
    """Histogram equalization of a uint8 image -> float32 in [0, 255].

    Replaces ``cv::equalizeHist`` (used on every SVI frame,
    CTrackerSVI.cpp:339-341). Built from a 256-bin one-hot histogram +
    cumulative sum + LUT gather — fully on-device, no host round trip.
    """
    flat = img_u8.astype(jnp.int32).reshape(-1)
    hist = jnp.zeros((256,), jnp.int32).at[flat].add(1)
    cdf = jnp.cumsum(hist)
    total = cdf[-1]
    # OpenCV convention: scale by (cdf - cdf_min) / (total - cdf_min) * 255
    cdf_min = jnp.min(jnp.where(hist > 0, cdf, total))
    denom = jnp.maximum(total - cdf_min, 1)
    lut = ((cdf - cdf_min).astype(jnp.float32) / denom.astype(jnp.float32)) * 255.0
    lut = jnp.clip(lut, 0.0, 255.0)
    return lut[flat].reshape(img_u8.shape)


@jax.jit
def remap_bilinear(img: jax.Array, map_x: jax.Array, map_y: jax.Array) -> jax.Array:
    """Bilinear remap: ``out[i, j] = img(map_y[i, j], map_x[i, j])``.

    Replaces ``cv::remap`` for undistortion/rectification
    (CStereoCamera.h:89-107). Out-of-bounds samples clamp to the border.
    """
    h, w = img.shape
    x0 = jnp.floor(map_x)
    y0 = jnp.floor(map_y)
    fx = map_x - x0
    fy = map_y - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    x1i = jnp.clip(x0i + 1, 0, w - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1i = jnp.clip(y0i + 1, 0, h - 1)
    v00 = img[y0i, x0i]
    v01 = img[y0i, x1i]
    v10 = img[y1i, x0i]
    v11 = img[y1i, x1i]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def undistort_rectify_maps(
    K: np.ndarray,
    dist: np.ndarray,
    R_rect: np.ndarray,
    P_new: np.ndarray,
    width: int,
    height: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Precompute undistort+rectify sampling maps (host-side, float64).

    Equivalent of ``cv::initUndistortRectifyMap`` (CStereoCameraIMU.h:20-52):
    for each rectified output pixel, find the raw-image source coordinate by
    back-rotating through ``R_rect`` and applying the radial-tangential
    distortion model (k1, k2, p1, p2 — the reference's 4-coefficient model,
    vecDistortionCoefficients in hardware_parameters files).

    Returns (map_x, map_y) float32 arrays shaped [height, width] to feed
    :func:`remap_bilinear` on device.
    """
    k1, k2, p1, p2 = [float(c) for c in np.asarray(dist).reshape(-1)[:4]]
    fx_n, fy_n = P_new[0, 0], P_new[1, 1]
    cx_n, cy_n = P_new[0, 2], P_new[1, 2]
    u, v = np.meshgrid(np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64))
    # rectified pixel -> normalized rectified ray
    x = (u - cx_n) / fx_n
    y = (v - cy_n) / fy_n
    rays = np.stack([x, y, np.ones_like(x)], axis=-1)
    # rotate back into the raw camera frame
    rays_raw = rays @ R_rect  # == R_rect.T applied to each ray (row-vector form)
    xr = rays_raw[..., 0] / rays_raw[..., 2]
    yr = rays_raw[..., 1] / rays_raw[..., 2]
    # distort
    r2 = xr * xr + yr * yr
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = xr * radial + 2.0 * p1 * xr * yr + p2 * (r2 + 2.0 * xr * xr)
    yd = yr * radial + p1 * (r2 + 2.0 * yr * yr) + 2.0 * p2 * xr * yr
    # raw intrinsics
    map_x = K[0, 0] * xd + K[0, 2]
    map_y = K[1, 1] * yd + K[1, 2]
    return map_x.astype(np.float32), map_y.astype(np.float32)


def stereo_rectify(
    K0: np.ndarray, dist0: np.ndarray,
    K1: np.ndarray, dist1: np.ndarray,
    T_10: np.ndarray,
    width: int, height: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Compute rectifying rotations + new projections for a stereo pair
    (Bouguet's algorithm — the ``cv::stereoRectify`` used by the reference's
    IMU camera construction, CStereoCameraIMU.h:20-52 and
    CParameterBase.h:169-392).

    ``T_10`` maps cam0-frame points into cam1: ``x1 = R x0 + t``. Returns
    ``(R_rect0, R_rect1, P0, P1)`` with a shared rectified K (averaged
    focal/principal point) and ``P1[0,3] = fx * t_rect_x`` — negative when
    cam0 is the left camera, matching the framework's ``P_R[0,3] = -fx b``
    disparity convention (Types.h:48-51).
    """
    R = np.asarray(T_10[:3, :3], np.float64)
    t = np.asarray(T_10[:3, 3], np.float64)
    # split the relative rotation evenly between the two cameras:
    # R_rect0 = B exp(+om/2), R_rect1 = B exp(-om/2)  =>  R_rect1 R = R_rect0
    # rotation vector via log map
    cos_th = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(cos_th)
    if th < 1e-12:
        om = np.zeros(3)
    else:
        om = th / (2.0 * np.sin(th)) * np.array(
            [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])

    def _exp(v):
        a = np.linalg.norm(v)
        if a < 1e-12:
            return np.eye(3)
        k = v / a
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(a) * Kx + (1 - np.cos(a)) * (Kx @ Kx)

    half_p = _exp(0.5 * om)
    half_m = _exp(-0.5 * om)
    t_half = half_m @ t                     # translation seen from the midframe
    # baseline-aligned common orientation: rows e1 (baseline), e2, e3.
    # e1 follows the sign of the dominant horizontal component so the
    # rectified x-axis keeps pointing right and a left-camera cam0 yields
    # t_rect_x = -baseline (cv::stereoRectify's uu-sign choice)
    sign = -1.0 if t_half[0] < 0 else 1.0
    e1 = sign * t_half / max(np.linalg.norm(t_half), 1e-12)
    nxy = np.hypot(e1[0], e1[1])
    if nxy < 1e-9:
        e2 = np.array([1.0, 0.0, 0.0])      # degenerate: baseline along z
    else:
        e2 = np.array([-e1[1], e1[0], 0.0]) / nxy
    e3 = np.cross(e1, e2)
    B = np.stack([e1, e2, e3])
    R_rect0 = B @ half_p
    R_rect1 = B @ half_m

    fx = 0.5 * (K0[0, 0] + K1[0, 0])
    fy = 0.5 * (K0[1, 1] + K1[1, 1])
    cx = 0.5 * (K0[0, 2] + K1[0, 2])
    cy = 0.5 * (K0[1, 2] + K1[1, 2])
    K_new = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    t_rect = R_rect1 @ t                    # == B @ t_half = [±|t|, 0, 0]
    P0 = np.hstack([K_new, np.zeros((3, 1))])
    P1 = np.hstack([K_new, np.zeros((3, 1))])
    P1[0, 3] = fx * t_rect[0]
    return R_rect0, R_rect1, P0, P1


