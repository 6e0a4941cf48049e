"""Stereo scanline matcher vs a plain-loop NumPy oracle.

frontend.stereo.match_stereo (the CTriangulator-analog matcher,
CTriangulator.cpp:13-356) must reproduce the oracle below exactly on the
integer part of the search — same accepted keypoints, same Hamming
distances, same integer disparities — and its sub-pixel parabola within
float32 rounding.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from svi_mapper_tpu.frontend.stereo import match_stereo
from svi_mapper_tpu.io.synthetic import SyntheticSequence
from svi_mapper_tpu.ops.descriptors import brief_at, smooth_brief_dense

_BIG = 1 << 20


@pytest.fixture(scope="module")
def scene():
    seq = SyntheticSequence(n_frames=2, width=512, height=256, step=0.8)
    l, r, _ = seq.frame(0)
    dense_l = smooth_brief_dense(jnp.asarray(l))
    dense_r = smooth_brief_dense(jnp.asarray(r))
    return seq.cam, dense_l, dense_r


def numpy_oracle(dense_r, uv, desc, valid, cam, *, max_disparity=128,
                 cutoff=100, min_disparity=0.5, min_depth=0.05,
                 max_depth=1000.0, center=None, search=None):
    """Per-keypoint scanline search: integer disparities in ascending
    order (first minimum wins), parabola refinement on the Hamming
    profile, depth gates. Returns (ok, distance, disparity)."""
    dense_r = np.asarray(dense_r)
    uv = np.asarray(uv, np.float64)
    desc = np.asarray(desc)
    h, w = dense_r.shape[:2]
    De = min(max_disparity, w)
    bq = float(np.asarray(cam.right.P)[0, 3])
    K = uv.shape[0]
    ok = np.zeros(K, bool)
    dist_out = np.zeros(K, np.int64)
    disp_out = np.zeros(K, np.float64)
    for k in range(K):
        u = float(np.nan_to_num(uv[k, 0], nan=0.0))
        v = float(np.nan_to_num(uv[k, 1], nan=0.0))
        u_r = int(np.clip(np.round(u), 0, w - 1))
        v_r = int(np.clip(np.round(v), 0, h - 1))
        # profile over every integer disparity the row span covers
        x0 = int(np.clip(u_r - (De - 1), 0, w - De))
        ds = np.arange(u_r - x0 - (De - 1), u_r - x0 + 1)
        prof = np.full(ds.shape, _BIG, np.int64)
        for i, d in enumerate(ds):
            if not (d >= min_disparity and d <= u and d <= De - 1):
                continue
            if center is not None and abs(d - center[k]) > search[k]:
                continue
            x = np.bitwise_xor(dense_r[v_r, u_r - d], desc[k])
            prof[i] = int(np.unpackbits(x.view(np.uint8)).sum())
        best = int(np.argmin(prof))
        bd = int(prof[best])
        disp = float(ds[best])
        if 0 < best < len(ds) - 1:
            dm, dp = prof[best - 1], prof[best + 1]
            denom = dm + dp - 2 * bd
            if denom > 0 and dm < _BIG and dp < _BIG:
                disp += float(np.clip(0.5 * (dm - dp) / denom, -0.5, 0.5))
        depth = -bq / max(disp, 1e-6)
        ok[k] = (bool(valid[k]) and bd <= cutoff and disp >= min_disparity
                 and min_depth < depth < max_depth)
        dist_out[k], disp_out[k] = bd, disp
    return ok, dist_out, disp_out


def _compare(sm, oracle):
    ok, dist, disp = oracle
    np.testing.assert_array_equal(np.asarray(sm.ok), ok)
    # rejected rows carry argmin-of-all-masked values; only accepted
    # matches carry meaning
    np.testing.assert_array_equal(np.asarray(sm.distance)[ok], dist[ok])
    np.testing.assert_allclose(np.asarray(sm.disparity)[ok], disp[ok],
                               atol=1e-4)


def _keypoints(rng, K, u_range, v_range):
    return jnp.asarray(np.stack([
        rng.uniform(*u_range, K), rng.uniform(*v_range, K)], 1)
        .astype(np.float32))


def test_kernel_matches_xla_path(scene, rng):
    cam, dense_l, dense_r = scene
    K = 256
    uv = _keypoints(rng, K, (0, 511), (0, 255))
    desc = brief_at(dense_l, uv)
    valid = jnp.ones(K, bool)
    sm = match_stereo(dense_r, uv, desc, valid, cam)
    assert int(np.asarray(sm.ok).sum()) > 50
    _compare(sm, numpy_oracle(dense_r, uv, desc, np.ones(K, bool), cam))


def test_kernel_matches_with_disparity_bounds(scene, rng):
    cam, dense_l, dense_r = scene
    K = 128
    uv = _keypoints(rng, K, (30, 480), (10, 250))
    desc = brief_at(dense_l, uv)
    valid = jnp.ones(K, bool)
    center = rng.uniform(2, 50, K).astype(np.float32)
    search = np.maximum(20.0, 0.5 * center).astype(np.float32)
    sm = match_stereo(dense_r, uv, desc, valid, cam,
                      disparity_center=jnp.asarray(center),
                      search_range=jnp.asarray(search), cutoff=50)
    _compare(sm, numpy_oracle(dense_r, uv, desc, np.ones(K, bool), cam,
                              cutoff=50, center=center, search=search))


def test_kernel_small_image(rng):
    """Width below the search range (EuRoC-test-sized frames)."""
    seq = SyntheticSequence(n_frames=1, width=64, height=48, step=0.4)
    l, r, _ = seq.frame(0)
    dense_l = smooth_brief_dense(jnp.asarray(l))
    dense_r = smooth_brief_dense(jnp.asarray(r))
    K = 32
    uv = _keypoints(rng, K, (0, 63), (0, 47))
    desc = brief_at(dense_l, uv)
    valid = jnp.ones(K, bool)
    sm = match_stereo(dense_r, uv, desc, valid, seq.cam)
    _compare(sm, numpy_oracle(dense_r, uv, desc, np.ones(K, bool), seq.cam))


def test_kernel_nan_uv_safe(scene, rng):
    cam, dense_l, dense_r = scene
    uv = _keypoints(rng, 16, (0, 511), (0, 255))
    uv = uv.at[2].set(jnp.nan)
    desc = brief_at(dense_l, jnp.nan_to_num(uv))
    sm = match_stereo(dense_r, uv, desc, jnp.ones(16, bool), cam)
    assert not bool(np.asarray(sm.ok)[2])
    _compare(sm, numpy_oracle(dense_r, uv, desc, np.ones(16, bool), cam))
