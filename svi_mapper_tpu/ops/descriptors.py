"""BRIEF-style binary descriptor extraction as a batched device op.

JAX replacement for OpenCV's ``BriefDescriptorExtractor`` (used at
CTriangulator.cpp:11 and throughout CFundamentalMatcher) and the reference's
``CDescriptorBRIEF`` 256-bit type (CDescriptorBRIEF.h:16-37,
DESCRIPTOR_SIZE_BITS=256 Types.h:6).

Design: descriptors are 256 Boolean intensity comparisons on a smoothed
image patch. The OpenCV implementation walks keypoints on the host; here the
whole keypoint batch is processed at once:

  1. the caller smooths the image once per frame (ops.image.box_blur);
  2. a 32x32 patch is cut per keypoint (vmapped dynamic_slice);
  3. the 256 compare pairs are *static* indices into the flattened patch, so
     sampling is a constant-index gather XLA lowers to cheap selects;
  4. bits pack into 8 uint32 words — the storage format all Hamming kernels
     (ops.hamming) operate on.

The sample pattern is a fixed Gaussian pattern (BRIEF paper's G II sampling)
generated from a constant seed — any fixed pattern works as long as detection
and matching share it, exactly like the reference shares one OpenCV pattern.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

DESCRIPTOR_BITS = 256          # ref Types.h:6
DESCRIPTOR_WORDS = 8           # 256 bits packed into 8 x uint32
PATCH_SIZE = 32                # ref: OpenCV BRIEF 48x48 window, KERNEL 9;
PATCH_HALF = PATCH_SIZE // 2   # 32 keeps the pattern reach small


def _make_pattern(seed: int = 17) -> tuple[np.ndarray, np.ndarray]:
    """Gaussian sample-pair pattern, clipped to the patch interior."""
    rng = np.random.default_rng(seed)
    sigma = PATCH_SIZE / 5.0
    a = rng.normal(0.0, sigma, size=(DESCRIPTOR_BITS, 2))
    b = rng.normal(0.0, sigma, size=(DESCRIPTOR_BITS, 2))
    lim = PATCH_HALF - 1
    a = np.clip(np.round(a), -lim, lim).astype(np.int32) + PATCH_HALF
    b = np.clip(np.round(b), -lim, lim).astype(np.int32) + PATCH_HALF
    # avoid degenerate identical pairs
    same = np.all(a == b, axis=-1)
    b[same, 0] = (b[same, 0] + 3) % PATCH_SIZE
    return a, b


_PATTERN_A, _PATTERN_B = _make_pattern()
# flattened static indices into a 32*32 patch (row-major [v, u])
_IDX_A = jnp.asarray(_PATTERN_A[:, 1] * PATCH_SIZE + _PATTERN_A[:, 0])
_IDX_B = jnp.asarray(_PATTERN_B[:, 1] * PATCH_SIZE + _PATTERN_B[:, 0])

_BIT_WEIGHTS = jnp.asarray(
    (1 << np.arange(32, dtype=np.uint64)).astype(np.uint32)
)


def pack_bits(bits: jax.Array) -> jax.Array:
    """[..., 256] bool -> [..., 8] uint32 (little-endian bit order)."""
    words = bits.reshape(bits.shape[:-1] + (DESCRIPTOR_WORDS, 32))
    return jnp.sum(
        words.astype(jnp.uint32) * _BIT_WEIGHTS, axis=-1, dtype=jnp.uint32
    )


def unpack_bits(packed: jax.Array) -> jax.Array:
    """[..., 8] uint32 -> [..., 256] bool."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (packed[..., :, None] >> shifts) & jnp.uint32(1)
    return bits.reshape(packed.shape[:-1] + (DESCRIPTOR_BITS,)).astype(jnp.bool_)


def extract_patches(img: jax.Array, uv: jax.Array) -> jax.Array:
    """Cut a 32x32 patch around each keypoint (clamped inside the image).

    Args:
      img: [H, W] float32 (already smoothed).
      uv: [K, 2] float32 keypoint centers (u=x, v=y).

    Returns: [K, 32, 32] float32 patches.
    """
    h, w = img.shape
    top = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32) - PATCH_HALF, 0, h - PATCH_SIZE)
    left = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32) - PATCH_HALF, 0, w - PATCH_SIZE)

    def cut(t, l):
        return jax.lax.dynamic_slice(img, (t, l), (PATCH_SIZE, PATCH_SIZE))

    return jax.vmap(cut)(top, left)


@jax.jit
def brief_descriptors(img_smooth: jax.Array, uv: jax.Array) -> jax.Array:
    """Extract packed BRIEF descriptors for a keypoint batch.

    Args:
      img_smooth: [H, W] float32 smoothed image.
      uv: [K, 2] float32 keypoints.

    Returns: [K, 8] uint32 packed 256-bit descriptors.
    """
    patches = extract_patches(img_smooth, uv)            # [K, 32, 32]
    flat = patches.reshape(patches.shape[0], -1)         # [K, 1024]
    pa = flat[:, _IDX_A]                                  # [K, 256] static gather
    pb = flat[:, _IDX_B]
    bits = pa < pb                                        # BRIEF test
    return pack_bits(bits)


@jax.jit
def brief_dense(img_smooth: jax.Array) -> jax.Array:
    """Dense BRIEF: the packed descriptor of EVERY pixel, as one fused op.

    The JAX replacement for the reference's per-candidate descriptor
    extraction along epipolar scanlines (CTriangulator.cpp:65-117 extracts
    BRIEF for a dense row of candidate keypoints every frame; the epipolar
    tracker re-extracts along sampled curves, CFundamentalMatcher.cpp:
    2142-2397). Computing bit i for all pixels is one shifted-image
    comparison ``img[y+ay, x+ax] < img[y+by, x+bx]`` (256 fused elementwise
    ops), after which *all* matching anywhere in the frame is a cheap gather
    into the [H, W, 8] uint32 field. Descriptors agree bit-for-bit with
    :func:`brief_descriptors` away from the image border.

    Cost for KITTI (376x1241): ~120M comparisons + packing; the field is
    15 MB of device memory.
    """
    h, w = img_smooth.shape
    pad = PATCH_HALF
    padded = jnp.pad(img_smooth, pad, mode="edge")

    def shifted(dy, dx):
        return jax.lax.dynamic_slice(padded, (pad + dy, pad + dx), (h, w))

    words = []
    for wi in range(DESCRIPTOR_WORDS):
        acc = jnp.zeros((h, w), jnp.uint32)
        for bi in range(32):
            i = wi * 32 + bi
            ay, ax = int(_PATTERN_A[i, 1]) - PATCH_HALF, int(_PATTERN_A[i, 0]) - PATCH_HALF
            by, bx = int(_PATTERN_B[i, 1]) - PATCH_HALF, int(_PATTERN_B[i, 0]) - PATCH_HALF
            bit = shifted(ay, ax) < shifted(by, bx)
            acc = acc | (bit.astype(jnp.uint32) << jnp.uint32(bi))
        words.append(acc)
    return jnp.stack(words, axis=-1)


def smooth_brief_dense(img: jax.Array) -> jax.Array:
    """Canonical smooth+describe: box blur, then the shifted comparisons.

    XLA fuses the blur and the comparison chain; a hand-written fused
    kernel was tried earlier, lost to this path, and broke bit-exactness
    through float reassociation, so it was removed.
    """
    from svi_mapper_tpu.ops.image import box_blur

    return brief_dense(box_blur(img, 5))


@jax.jit
def brief_at(dense: jax.Array, uv: jax.Array) -> jax.Array:
    """Gather packed descriptors from a dense field at (possibly fractional)
    pixel locations (nearest-pixel, clamped to the image)."""
    h, w = dense.shape[:2]
    x = jnp.clip(jnp.round(uv[..., 0]).astype(jnp.int32), 0, w - 1)
    y = jnp.clip(jnp.round(uv[..., 1]).astype(jnp.int32), 0, h - 1)
    return dense[y, x]


@jax.jit
def brief_descriptors_at_offsets(
    img_smooth: jax.Array, uv: jax.Array, offsets: jax.Array
) -> jax.Array:
    """Descriptors at ``uv[k] + offsets[c]`` for every (keypoint, candidate).

    Used by epipolar search: the reference extracts BRIEF along sampled
    curve points (CFundamentalMatcher.cpp:2142-2397); here all K x C
    candidate locations are described in one batch.

    Args:
      img_smooth: [H, W]; uv: [K, 2]; offsets: [C, 2].

    Returns: [K, C, 8] uint32.
    """
    k, c = uv.shape[0], offsets.shape[0]
    all_uv = (uv[:, None, :] + offsets[None, :, :]).reshape(k * c, 2)
    d = brief_descriptors(img_smooth, all_uv)
    return d.reshape(k, c, DESCRIPTOR_WORDS)
