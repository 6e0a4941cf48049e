"""Dense tracking window scorer vs a plain-loop NumPy oracle (bit parity).

frontend.tracking.window_scores and the NumPy oracle below must agree
EXACTLY for in-FoV landmarks — same accepted candidate, same biased score,
same Hamming distance — since both implement the 3-stage cascade of
CFundamentalMatcher.cpp:391-2397 (stage-3 = the oriented epipolar band of
frontend.epipolar).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from svi_mapper_tpu.frontend.epipolar import BAND_HALF_WIDTH_Q, fixed_band_params
from svi_mapper_tpu.frontend import tracking as tk
from svi_mapper_tpu.frontend.tracking import _BIG, window_scores


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def numpy_oracle(dense, uv, dlast, dref, band, cutoff_s1=25, cutoff_s2=50,
                 cutoff_ref=50):
    """Plain-loop NumPy statement of the tracking acceptance spec."""
    h, w, _ = dense.shape
    L = uv.shape[0]
    nxq, nyq, c0q, ru, rv = [np.asarray(b) for b in band]
    score = np.full(L, 1 << 20, np.int64)
    bx = np.zeros(L, np.int64)
    by = np.zeros(L, np.int64)
    dist = np.full(L, (1 << 20) % 1000, np.int64)
    bits = np.unpackbits(
        np.ascontiguousarray(dense).view(np.uint8), axis=-1
    ).reshape(h, w, 256)
    blast = np.unpackbits(
        np.ascontiguousarray(dlast).view(np.uint8), axis=-1
    ).reshape(L, 256)
    bref = np.unpackbits(
        np.ascontiguousarray(dref).view(np.uint8), axis=-1
    ).reshape(L, 256)
    for i in range(L):
        u = int(np.clip(np.round(np.nan_to_num(uv[i, 0], posinf=0, neginf=0)), 0, w - 1))
        v = int(np.clip(np.round(np.nan_to_num(uv[i, 1], posinf=0, neginf=0)), 0, h - 1))
        x0 = int(np.clip(u - tk.REACH_X, 0, w - tk.WIN_W))
        y0 = int(np.clip(v - tk.REACH_Y, 0, h - tk.WIN_H))
        for y in range(y0, y0 + tk.WIN_H):          # row-major scan = the
            for x in range(x0, x0 + tk.WIN_W):      # tie-break order
                dx, dy = x - u, y - v
                # cumulative tier fallbacks (frontend.tracking.tier_scores)
                t0 = abs(dx) <= 1 and abs(dy) <= 1
                t1 = abs(dx) <= 8 and abs(dy) <= 8
                on_band = abs(int(c0q[i]) + int(nxq[i]) * dx
                              + int(nyq[i]) * dy) <= BAND_HALF_WIDTH_Q
                t2 = on_band and abs(dx) <= ru[i] and abs(dy) <= rv[i]
                if not (t0 or t1 or t2):
                    continue
                d1 = int(np.sum(bits[y, x] ^ blast[i]))
                d2 = int(np.sum(bits[y, x] ^ bref[i]))
                if d2 > cutoff_ref:
                    continue
                s = 1 << 20
                if t0 and d1 <= cutoff_s1:
                    s = min(s, d1)
                if t1 and d1 <= cutoff_s2:
                    s = min(s, d1 + 1000)
                if t2 and d1 <= cutoff_s2:
                    s = min(s, d1 + 2000)
                if s < score[i]:
                    score[i], bx[i], by[i], dist[i] = s, x, y, d1
    return score, bx, by, dist


def _random_band(rng, L):
    """Random oriented bands: unit normals x256, small offsets, reaches."""
    theta = rng.uniform(0, 2 * np.pi, L)
    nxq = np.round(np.cos(theta) * 256).astype(np.int32)
    nyq = np.round(np.sin(theta) * 256).astype(np.int32)
    c0q = rng.integers(-800, 800, L).astype(np.int32)
    ru = rng.integers(5, tk.REACH_X + 1, L).astype(np.int32)
    rv = rng.integers(5, tk.REACH_Y + 1, L).astype(np.int32)
    return tuple(jnp.asarray(a) for a in (nxq, nyq, c0q, ru, rv))


def _random_case(rng, h=128, w=256, L=48, planted=24, band=None):
    """Random field + landmarks; plants near-exact matches for the first
    ``planted`` landmarks. With ``band`` given, plants lie ON each
    landmark's oriented epipolar band (so tier-2 acceptance is exercised);
    otherwise at random in-window offsets."""
    dense = rng.integers(0, 2 ** 32, (h, w, 8), dtype=np.uint64).astype(np.uint32)
    uv = np.stack([
        rng.uniform(29, w - 30, L), rng.uniform(29, h - 30, L)
    ], 1).astype(np.float32)
    dlast = rng.integers(0, 2 ** 32, (L, 8), dtype=np.uint64).astype(np.uint32)
    dref = dlast.copy()
    for i in range(planted):
        if band is not None:
            nxq, nyq, c0q, ru, rv = [np.asarray(a) for a in band]
            nx, ny, c0 = nxq[i] / 256.0, nyq[i] / 256.0, c0q[i] / 256.0
            s = float(rng.uniform(-12, 12))
            # offset = on-line point: s along the tangent, -c0 along the
            # normal (cancels the line offset)
            dx = int(round(-s * ny - c0 * nx))
            dy = int(round(s * nx - c0 * ny))
            dx = int(np.clip(dx, -min(ru[i], tk.REACH_X), min(ru[i], tk.REACH_X)))
            dy = int(np.clip(dy, -min(rv[i], tk.REACH_Y), min(rv[i], tk.REACH_Y)))
        else:
            # on the fixed horizontal band (always accepted by tier 2)
            dx = int(rng.integers(-tk.REACH_X, tk.REACH_X + 1))
            dy = int(rng.integers(-2, 3))
        x = int(round(uv[i, 0])) + dx
        y = int(round(uv[i, 1])) + dy
        d = dlast[i].copy()
        d[0] ^= np.uint32(0b111)  # 3 flipped bits
        dense[y, x] = d
    return (jnp.asarray(dense), jnp.asarray(uv), jnp.asarray(dlast),
            jnp.asarray(dref))


def _assert_all_equal(a, b, accepted=None):
    a = [np.asarray(v) for v in a]
    b = [np.asarray(v) for v in b]
    np.testing.assert_array_equal(a[0], b[0])
    m = a[0] < (1 << 20) if accepted is None else accepted
    for va, vb in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(va[m], vb[m])


def _scores(dense, uv, dlast, dref, band):
    return window_scores(dense, uv, dlast, dref, band,
                         cutoff_s1=25, cutoff_s2=50, cutoff_ref=50)


def _oracle(dense, uv, dlast, dref, band):
    return numpy_oracle(np.asarray(dense), np.asarray(uv),
                        np.asarray(dlast), np.asarray(dref), band)


@pytest.mark.parametrize("use_oriented", [False, True])
def test_kernel_and_xla_match_numpy_oracle(rng, use_oriented):
    L = 48
    band = (_random_band(rng, L) if use_oriented
            else fixed_band_params(L, tk.REACH_X, tk.REACH_Y))
    dense, uv, dlast, dref = _random_case(
        rng, L=L, band=band if use_oriented else None)
    out_x = _scores(dense, uv, dlast, dref, band)
    out_np = _oracle(dense, uv, dlast, dref, band)
    assert (np.asarray(out_np[0]) < (1 << 20)).sum() >= 8, \
        "planted matches should be found"
    _assert_all_equal(out_x, out_np)


def test_kernel_rejects_when_nothing_matches(rng):
    dense, uv, dlast, dref = _random_case(rng, planted=0)
    band = fixed_band_params(uv.shape[0], tk.REACH_X, tk.REACH_Y)
    # random 256-bit descriptors are ~128 bits apart — nothing under cutoff
    score, *_ = _scores(dense, uv, dlast, dref, band)
    assert (np.asarray(score) >= int(_BIG)).all()


def test_kernel_handles_band_edges(rng):
    """Landmarks concentrated at band boundaries and image borders."""
    h, w, L = 144, 256, 48
    dense = rng.integers(0, 2 ** 32, (h, w, 8), dtype=np.uint64).astype(np.uint32)
    ys = np.concatenate([
        np.full(L // 4, 29.0), np.full(L // 4, float(h - 30)),
        np.full(L // 4, 48.0 - 0.4), np.full(L // 4, 72.0 + 0.4),
    ])
    uv = np.stack([rng.uniform(29, w - 30, L), ys[:L]], 1).astype(np.float32)
    dlast = rng.integers(0, 2 ** 32, (L, 8), dtype=np.uint64).astype(np.uint32)
    # every landmark sees its exact field descriptor at offset 0
    for i in range(L):
        dlast[i] = dense[int(round(uv[i, 1])), int(round(uv[i, 0]))]
    dref = dlast.copy()
    dj = jnp.asarray(dense)
    band = _random_band(np.random.default_rng(3), L)
    args = (dj, jnp.asarray(uv), jnp.asarray(dlast), jnp.asarray(dref), band)
    out_x = _scores(*args)
    _assert_all_equal(out_x, _oracle(*args))
    assert (np.asarray(out_x[0]) == 0).all()   # exact self-matches, tier 0


def test_kernel_nan_positions_are_safe(rng):
    dense, uv, dlast, dref = _random_case(rng, L=16, planted=0)
    band = fixed_band_params(16, tk.REACH_X, tk.REACH_Y)
    uv = uv.at[3].set(jnp.nan).at[7].set(jnp.inf)
    out_x = _scores(dense, uv, dlast, dref, band)
    assert np.isfinite(np.asarray(out_x[0])).all()
    # non-finite predictions are scored at the clamped pixel, as the
    # oracle does
    _assert_all_equal(out_x, _oracle(dense, uv, dlast, dref, band))
