"""Tests for the device ops: image, corners, descriptors, Hamming kernels."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from svi_mapper_tpu.ops import corners, descriptors, hamming, image


# ---------------------------------------------------------------------------
# image ops
# ---------------------------------------------------------------------------

def test_box_blur_constant_preserved():
    img = jnp.full((64, 80), 3.5)
    out = image.box_blur(img, 9)
    assert np.allclose(np.asarray(out), 3.5, atol=1e-5)


def test_box_blur_matches_numpy_interior(rng):
    img = rng.random((40, 50)).astype(np.float32)
    out = np.asarray(image.box_blur(jnp.asarray(img), 3))
    # interior check vs direct average
    for i, j in [(10, 10), (20, 30), (5, 45)]:
        ref = img[i - 1 : i + 2, j - 1 : j + 2].mean()
        assert np.isclose(out[i, j], ref, atol=1e-5)


def test_sobel_gradient_direction():
    # ramp in x -> ix == const > 0, iy == 0
    img = jnp.broadcast_to(jnp.arange(32, dtype=jnp.float32)[None, :], (32, 32))
    ix, iy = image.sobel_gradients(img)
    assert np.allclose(np.asarray(ix)[2:-2, 2:-2], 8.0)  # [1 2 1]*[-1 0 1] ramp -> 8
    assert np.allclose(np.asarray(iy)[2:-2, 2:-2], 0.0, atol=1e-5)


def test_equalize_hist_uniform_output(rng):
    img = (rng.random((64, 64)) ** 3 * 255).astype(np.uint8)  # skewed histogram
    out = np.asarray(image.equalize_hist(jnp.asarray(img)))
    assert out.min() >= 0 and out.max() <= 255
    # equalization spreads the CDF: quartiles should be near-uniform
    qs = np.percentile(out, [25, 50, 75])
    assert np.all(np.diff(qs) > 30)


def test_remap_identity(rng):
    img = rng.random((32, 48)).astype(np.float32)
    yy, xx = np.mgrid[0:32, 0:48].astype(np.float32)
    out = np.asarray(image.remap_bilinear(jnp.asarray(img), jnp.asarray(xx), jnp.asarray(yy)))
    assert np.allclose(out, img, atol=1e-6)


def test_remap_half_pixel_shift(rng):
    img = rng.random((32, 48)).astype(np.float32)
    yy, xx = np.mgrid[0:32, 0:48].astype(np.float32)
    out = np.asarray(image.remap_bilinear(jnp.asarray(img), jnp.asarray(xx + 0.5), jnp.asarray(yy)))
    ref = 0.5 * (img[:, :-1] + img[:, 1:])
    assert np.allclose(out[:, :-1], ref, atol=1e-6)


def test_undistort_rectify_maps_zero_distortion_identity():
    K = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]])
    P = np.hstack([K, np.zeros((3, 1))])
    mx, my = image.undistort_rectify_maps(K, np.zeros(4), np.eye(3), P, 64, 48)
    yy, xx = np.mgrid[0:48, 0:64]
    assert np.allclose(mx, xx, atol=1e-5)
    assert np.allclose(my, yy, atol=1e-5)


# ---------------------------------------------------------------------------
# corners
# ---------------------------------------------------------------------------

def _checkerboard(h, w, sq=8):
    yy, xx = np.mgrid[0:h, 0:w]
    return (((yy // sq) + (xx // sq)) % 2).astype(np.float32) * 255.0


def test_detect_corners_finds_checkerboard_crossings():
    img = _checkerboard(160, 200, 16)
    uv, score, valid = corners.detect_corners(jnp.asarray(img), k=64, cell=8, border=20)
    uv = np.asarray(uv)[np.asarray(valid)]
    assert len(uv) >= 20
    # every detection should be near a 16px grid crossing
    du = np.abs((uv[:, 0] + 8) % 16 - 8)
    dv = np.abs((uv[:, 1] + 8) % 16 - 8)
    assert np.percentile(du, 90) <= 2.5
    assert np.percentile(dv, 90) <= 2.5


def test_detect_corners_respects_mask():
    img = _checkerboard(160, 200, 16)
    mask = np.ones((160, 200), bool)
    mask[:, :100] = False  # forbid the left half
    uv, _, valid = corners.detect_corners(
        jnp.asarray(img), k=64, cell=8, border=20, mask=jnp.asarray(mask)
    )
    uv = np.asarray(uv)[np.asarray(valid)]
    assert len(uv) > 0
    assert np.all(uv[:, 0] >= 100)


def test_detect_corners_flat_image_all_invalid():
    img = jnp.zeros((128, 128))
    _, _, valid = corners.detect_corners(img, k=32, border=16)
    assert not np.any(np.asarray(valid))


def test_occupancy_mask():
    uv = jnp.asarray([[50.0, 40.0]])
    valid = jnp.asarray([True])
    m = np.asarray(corners.occupancy_mask((80, 100), uv, valid, radius=5))
    assert not m[40, 50]
    assert not m[44, 54]
    assert m[40, 60]


# ---------------------------------------------------------------------------
# descriptors
# ---------------------------------------------------------------------------

def test_pack_unpack_roundtrip(rng):
    bits = rng.random((10, 256)) > 0.5
    packed = descriptors.pack_bits(jnp.asarray(bits))
    assert packed.dtype == jnp.uint32 and packed.shape == (10, 8)
    rt = np.asarray(descriptors.unpack_bits(packed))
    assert np.array_equal(rt, bits)


def test_brief_same_point_same_descriptor(rng):
    img = jnp.asarray(rng.random((100, 120)).astype(np.float32))
    smooth = image.box_blur(img, 5)
    uv = jnp.asarray([[60.0, 50.0], [60.0, 50.0], [30.0, 40.0]])
    d = descriptors.brief_descriptors(smooth, uv)
    d = np.asarray(d)
    assert np.array_equal(d[0], d[1])
    assert not np.array_equal(d[0], d[2])


def test_brief_translation_invariance(rng):
    """Descriptor of the same texture at a shifted location matches."""
    patch = rng.random((60, 60)).astype(np.float32)
    img1 = np.zeros((128, 128), np.float32)
    img2 = np.zeros((128, 128), np.float32)
    img1[30:90, 30:90] = patch
    img2[40:100, 50:110] = patch
    s1 = image.box_blur(jnp.asarray(img1), 5)
    s2 = image.box_blur(jnp.asarray(img2), 5)
    d1 = descriptors.brief_descriptors(s1, jnp.asarray([[60.0, 60.0]]))
    d2 = descriptors.brief_descriptors(s2, jnp.asarray([[80.0, 70.0]]))
    dist = int(np.asarray(hamming.hamming_packed(d1, d2))[0, 0])
    assert dist == 0


def test_brief_offsets_grid(rng):
    img = jnp.asarray(rng.random((100, 120)).astype(np.float32))
    smooth = image.box_blur(img, 5)
    uv = jnp.asarray([[60.0, 50.0], [40.0, 40.0]])
    offs = jnp.asarray([[0.0, 0.0], [5.0, 0.0]])
    d = descriptors.brief_descriptors_at_offsets(smooth, uv, offs)
    assert d.shape == (2, 2, 8)
    d0 = descriptors.brief_descriptors(smooth, uv)
    assert np.array_equal(np.asarray(d[:, 0]), np.asarray(d0))


# ---------------------------------------------------------------------------
# hamming
# ---------------------------------------------------------------------------

def _np_hamming(a_bits, b_bits):
    return (a_bits[:, None, :] != b_bits[None, :, :]).sum(-1)


def test_hamming_packed_vs_numpy(rng):
    a_bits = rng.random((37, 256)) > 0.5
    b_bits = rng.random((53, 256)) > 0.5
    a = descriptors.pack_bits(jnp.asarray(a_bits))
    b = descriptors.pack_bits(jnp.asarray(b_bits))
    d = np.asarray(hamming.hamming_packed(a, b))
    assert np.array_equal(d, _np_hamming(a_bits, b_bits))


def test_hamming_mxu_agrees(rng):
    a_bits = rng.random((37, 256)) > 0.5
    b_bits = rng.random((53, 256)) > 0.5
    a = descriptors.pack_bits(jnp.asarray(a_bits))
    b = descriptors.pack_bits(jnp.asarray(b_bits))
    d1 = np.asarray(hamming.hamming_packed(a, b))
    d2 = np.asarray(hamming.hamming_mxu(a, b))
    assert np.array_equal(d1, d2)


def test_match_nearest_with_cutoff(rng):
    bits = rng.random((20, 256)) > 0.5
    ref = descriptors.pack_bits(jnp.asarray(bits))
    # queries = refs with a few flipped bits
    q_bits = bits.copy()
    q_bits[:, :10] = ~q_bits[:, :10]
    query = descriptors.pack_bits(jnp.asarray(q_bits))
    idx, dist, ok = hamming.match_nearest(query, ref, cutoff=25)
    assert np.array_equal(np.asarray(idx), np.arange(20))
    assert np.all(np.asarray(dist) == 10)
    assert np.all(np.asarray(ok))
    _, _, ok2 = hamming.match_nearest(query, ref, cutoff=5)
    assert not np.any(np.asarray(ok2))


def test_match_nearest_respects_ref_valid(rng):
    bits = rng.random((8, 256)) > 0.5
    ref = descriptors.pack_bits(jnp.asarray(bits))
    query = ref
    ref_valid = jnp.asarray([True, False] * 4)
    idx, _, ok = hamming.match_nearest(query, ref, cutoff=0, ref_valid=ref_valid)
    ok = np.asarray(ok)
    assert list(ok) == [True, False] * 4


def test_match_mutual_one_to_one(rng):
    bits = rng.random((10, 256)) > 0.5
    ref = descriptors.pack_bits(jnp.asarray(bits))
    # two queries close to the same ref: only one (the closer) survives
    q_bits = np.concatenate([bits, bits[:1]], axis=0)
    q_bits[10, :3] = ~q_bits[10, :3]  # dup of ref 0, distance 3
    query = descriptors.pack_bits(jnp.asarray(q_bits))
    idx, dist, ok = hamming.match_mutual(query, ref, cutoff=25)
    ok = np.asarray(ok)
    assert ok[0] and not ok[10]  # exact copy wins, perturbed dup loses
    assert np.asarray(idx)[0] == 0


def test_count_matches(rng):
    bits = rng.random((30, 256)) > 0.5
    ref = descriptors.pack_bits(jnp.asarray(bits))
    query = descriptors.pack_bits(jnp.asarray(np.concatenate([bits[:12], ~bits[12:]], 0)))
    n = int(np.asarray(hamming.count_matches(query, ref, cutoff=10)))
    assert n == 12


def test_brief_dense_matches_patch_extraction(rng):
    img = jnp.asarray(rng.random((100, 140)).astype(np.float32))
    smooth = image.box_blur(img, 5)
    dense = descriptors.brief_dense(smooth)
    assert dense.shape == (100, 140, 8) and dense.dtype == jnp.uint32
    uv = jnp.asarray(
        np.stack([rng.uniform(20, 120, 32), rng.uniform(20, 80, 32)], -1).astype(np.float32)
    )
    d_patch = np.asarray(descriptors.brief_descriptors(smooth, uv))
    d_dense = np.asarray(descriptors.brief_at(dense, uv))
    assert np.array_equal(d_patch, d_dense)


def test_brief_at_clamps_out_of_bounds(rng):
    img = jnp.asarray(rng.random((64, 64)).astype(np.float32))
    dense = descriptors.brief_dense(img)
    d = descriptors.brief_at(dense, jnp.asarray([[-5.0, -5.0], [200.0, 200.0]]))
    assert d.shape == (2, 8)  # no crash, clamped
