"""Tests for the landmark table, stereo posit, and landmark refinement."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from svi_mapper_tpu.geometry import se3
from svi_mapper_tpu.geometry.camera import StereoCamera, pinhole_from_projection
from svi_mapper_tpu.mapping import landmarks as lm
from svi_mapper_tpu.solvers import landmark_opt, posit
from svi_mapper_tpu.config import DEFAULT_PARAMS


def make_cam():
    P_l = np.array([[718.856, 0, 607.1928, 0], [0, 718.856, 185.2157, 0], [0, 0, 1, 0]])
    P_r = P_l.copy()
    P_r[0, 3] = -386.1448
    return StereoCamera(
        left=pinhole_from_projection(P_l, 1241, 376),
        right=pinhole_from_projection(P_r, 1241, 376),
    )


def make_world(rng, n=200):
    """Random world points in front of a camera ring."""
    return np.stack(
        [rng.uniform(-15, 15, n), rng.uniform(-3, 3, n), rng.uniform(5, 60, n)],
        axis=-1,
    ).astype(np.float32)


def observe(cam, T_wc, p_w, noise=0.0, rng=None):
    p_c = np.asarray(se3.transform(jnp.asarray(T_wc), jnp.asarray(p_w)))
    uv_l, uv_r = cam.project_stereo(jnp.asarray(p_c))
    uv4 = np.concatenate([np.asarray(uv_l), np.asarray(uv_r)], axis=-1)
    if noise > 0:
        uv4 = uv4 + rng.normal(0, noise, uv4.shape)
        uv4[:, 3] = uv4[:, 1]  # keep rectified rows consistent
    return uv4.astype(np.float32), p_c[:, 2]


# ---------------------------------------------------------------------------
# posit
# ---------------------------------------------------------------------------

def test_posit_recovers_pose(rng):
    cam = make_cam()
    p_w = make_world(rng)
    T_true = np.asarray(se3.exp_se3(jnp.asarray([0.3, -0.1, 0.5, 0.02, 0.04, -0.01], jnp.float32)))
    uv4, z = observe(cam, T_true, p_w)
    valid = jnp.asarray(z > 0)
    T_init = np.asarray(se3.exp_se3(jnp.asarray([0.1, 0.05, 0.2, 0.0, 0.0, 0.0], jnp.float32)))
    res = posit.solve_stereo_posit(jnp.asarray(T_init), jnp.asarray(p_w), jnp.asarray(uv4), valid, cam)
    assert bool(res.ok)
    err = np.abs(np.asarray(res.T_wc) - T_true).max()
    assert err < 1e-3
    assert float(res.avg_error_px2) < 0.1


def test_posit_robust_to_outliers(rng):
    cam = make_cam()
    p_w = make_world(rng, 200)
    T_true = np.asarray(se3.exp_se3(jnp.asarray([0.2, 0.0, 0.4, 0.0, 0.03, 0.0], jnp.float32)))
    uv4, z = observe(cam, T_true, p_w, noise=0.3, rng=rng)
    # corrupt 20% of the matches badly
    n_out = 40
    uv4[:n_out, 0] += rng.uniform(30, 80, n_out)
    res = posit.solve_stereo_posit(
        jnp.asarray(np.eye(4, dtype=np.float32)), jnp.asarray(p_w),
        jnp.asarray(uv4), jnp.asarray(z > 0), cam,
    )
    assert bool(res.ok)
    t_err = np.linalg.norm(np.asarray(res.T_wc)[:3, 3] - T_true[:3, 3])
    assert t_err < 0.05
    assert int(res.inliers) > 100


def test_posit_fails_with_too_few_points(rng):
    cam = make_cam()
    p_w = make_world(rng, 10)  # < min_points 25
    T_true = np.eye(4, dtype=np.float32)
    uv4, z = observe(cam, T_true, p_w)
    res = posit.solve_stereo_posit(
        jnp.asarray(T_true), jnp.asarray(p_w), jnp.asarray(uv4), jnp.asarray(z > 0), cam
    )
    assert not bool(res.ok)
    # failure returns the prior unchanged (the reference keeps the prior too)
    assert np.allclose(np.asarray(res.T_wc), T_true)


def test_posit_risk_gate(rng):
    """A pose far from prior+IMU must be rejected (RISK check,
    CSolverStereoPosit.cpp:144-150)."""
    cam = make_cam()
    p_w = make_world(rng)
    T_true = np.asarray(se3.exp_se3(jnp.asarray([3.0, 0.0, 0.0, 0.0, 0.0, 0.0], jnp.float32)))
    uv4, z = observe(cam, T_true, p_w)
    T_prior = np.eye(4, dtype=np.float32)
    res = posit.solve_stereo_posit(
        jnp.asarray(T_prior), jnp.asarray(p_w), jnp.asarray(uv4), jnp.asarray(z > 0),
        cam, T_prior=jnp.asarray(T_prior), max_risk_m2=2.0,
    )
    assert not bool(res.ok)


# ---------------------------------------------------------------------------
# landmark table
# ---------------------------------------------------------------------------

def test_insert_and_add_measurements(rng):
    table = lm.make_table(16, 4)
    pos = rng.normal(size=(8, 3)).astype(np.float32)
    desc = (rng.integers(0, 2**32, (8, 8), dtype=np.uint64)).astype(np.uint32)
    uv4 = rng.normal(size=(8, 4)).astype(np.float32)
    new_valid = jnp.asarray([True] * 5 + [False] * 3)
    table, next_uid = lm.insert_landmarks(
        table, new_valid, jnp.asarray(pos), jnp.asarray(uv4[:, :2]),
        jnp.asarray(uv4[:, 0] - uv4[:, 2]), jnp.asarray(desc), jnp.asarray(desc),
        jnp.asarray(uv4), jnp.eye(4), jnp.int32(0),
    )
    assert int(table.num_active) == 5
    assert int(next_uid) == 5
    active_uids = np.sort(np.asarray(table.uid)[np.asarray(table.active)])
    assert list(active_uids) == [0, 1, 2, 3, 4]
    # positions landed in table
    got = np.asarray(table.pos_w)[np.asarray(table.active)]
    assert np.allclose(np.sort(got.ravel()), np.sort(pos[:5].ravel()))

    # second insert fills more slots without clobbering
    table2, next_uid2 = lm.insert_landmarks(
        table, jnp.asarray([True] * 8), jnp.asarray(pos), jnp.asarray(uv4[:, :2]),
        jnp.asarray(uv4[:, 0] - uv4[:, 2]), jnp.asarray(desc), jnp.asarray(desc),
        jnp.asarray(uv4), jnp.eye(4), next_uid,
    )
    assert int(table2.num_active) == 13
    assert int(next_uid2) == 13


def test_insert_overflow_drops_excess(rng):
    table = lm.make_table(4, 2)
    pos = rng.normal(size=(8, 3)).astype(np.float32)
    desc = np.zeros((8, 8), np.uint32)
    uv4 = np.zeros((8, 4), np.float32)
    table, next_uid = lm.insert_landmarks(
        table, jnp.ones(8, bool), jnp.asarray(pos), jnp.asarray(uv4[:, :2]),
        jnp.asarray(uv4[:, 0]), jnp.asarray(desc), jnp.asarray(desc),
        jnp.asarray(uv4), jnp.eye(4), jnp.int32(0),
    )
    assert int(table.num_active) == 4
    assert int(next_uid) == 4


def test_measurement_ring_and_failure_counters(rng):
    table = lm.make_table(8, 3)
    desc = np.zeros((8, 8), np.uint32)
    uv4 = np.ones((8, 4), np.float32)
    table, _ = lm.insert_landmarks(
        table, jnp.asarray([True, True] + [False] * 6), jnp.zeros((8, 3)),
        jnp.zeros((8, 2)), jnp.zeros(8), jnp.asarray(desc), jnp.asarray(desc),
        jnp.asarray(uv4), jnp.eye(4), jnp.int32(0),
    )
    tracked = jnp.asarray([True, False] + [False] * 6)
    for i in range(4):
        table = lm.add_measurements(
            table, tracked, jnp.full((8, 4), float(i + 2)), jnp.asarray(desc), jnp.eye(4)
        )
    counts = np.asarray(table.meas_count)
    assert counts[0] == 5  # 1 initial + 4 tracked (ring capacity 3, count keeps total)
    assert counts[1] == 1
    failed = np.asarray(table.failed)
    assert failed[0] == 0 and failed[1] == 4
    # retire: landmark 1 exceeded the failure cap? cap is 5 -> not yet
    table_r = lm.retire_landmarks(table, DEFAULT_PARAMS)
    assert int(table_r.num_active) == 2
    for i in range(3):
        table = lm.add_measurements(
            table, jnp.zeros(8, bool), jnp.zeros((8, 4)), jnp.asarray(desc), jnp.eye(4)
        )
    table_r = lm.retire_landmarks(table, DEFAULT_PARAMS)
    active = np.asarray(table_r.active)
    assert active[0] and not active[1]  # 7 consecutive failures > 5 -> dropped


# ---------------------------------------------------------------------------
# landmark refinement
# ---------------------------------------------------------------------------

def test_optimize_landmarks_recovers_points(rng):
    cam = make_cam()
    L, M = 32, 8
    table = lm.make_table(L, M)
    p_true = make_world(rng, L)
    # camera moves forward along z
    poses = [np.asarray(se3.exp_se3(jnp.asarray([0, 0, -0.5 * i, 0, 0.002 * i, 0], jnp.float32))) for i in range(M)]
    meas_uv = np.zeros((L, M, 4), np.float32)
    meas_T = np.zeros((L, M, 4, 4), np.float32)
    for i, T in enumerate(poses):
        uv4, z = observe(cam, T, p_true, noise=0.2, rng=rng)
        meas_uv[:, i] = uv4
        meas_T[:, i] = T
    table = table.replace(
        active=jnp.ones(L, bool),
        pos_w=jnp.asarray(p_true + rng.normal(0, 0.5, (L, 3)).astype(np.float32)),
        meas_uv=jnp.asarray(meas_uv),
        meas_T_wc=jnp.asarray(meas_T),
        meas_count=jnp.full(L, M, jnp.int32),
    )
    table = landmark_opt.optimize_landmarks(table, cam)
    opt = np.asarray(table.is_optimal)
    assert opt.mean() > 0.9
    err = np.linalg.norm(np.asarray(table.pos_w) - p_true, axis=-1)
    # depth accuracy is geometry-limited: dz/d(disp) = z^2/(fx b) ~ 9 m/px at
    # z=60 m, so judge metric accuracy only on well-conditioned depths
    near = opt & (p_true[:, 2] < 25.0)
    assert near.sum() >= 5
    assert np.median(err[near]) < 0.05
    # everything flagged optimal must at least reproject well (already gated)
    assert np.all(err[opt] < 1.5)


def _numpy_landmark_gn(p0, uv, T, mask, cam, kernel_px2=10.0,
                       max_iterations=100, convergence=1e-5, damping=1e-6):
    """float64 per-landmark robust GN (CLandmark.cpp:447-581 semantics):
    the plain reference for the structure-of-arrays core."""
    fx, fy = float(cam.left.fx), float(cam.left.fy)
    cx, cy = float(cam.left.cx), float(cam.left.cy)
    bq = float(np.asarray(cam.right.P)[0, 3])
    R, t = T[:, :3, :3].astype(np.float64), T[:, :3, 3].astype(np.float64)

    def project(p):
        pc = R @ p + t
        z = np.where(np.abs(pc[:, 2]) < 1e-6, 1e-6, pc[:, 2])
        pred = np.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy,
                         (fx * pc[:, 0] + bq) / z + cx,
                         fy * pc[:, 1] / z + cy], -1)
        return pc, z, pred - uv

    p = p0.astype(np.float64)
    for _ in range(max_iterations):
        pc, z, r = project(p)
        err2 = (r * r).sum(-1)
        w = np.where(err2 > kernel_px2, kernel_px2 / np.maximum(err2, 1e-12),
                     1.0) * mask * (pc[:, 2] > 0.05)
        iz, iz2 = 1.0 / z, 1.0 / z ** 2
        J_cam = np.zeros((len(z), 4, 3))
        J_cam[:, 0] = np.stack([fx * iz, 0 * iz, -fx * pc[:, 0] * iz2], -1)
        J_cam[:, 1] = np.stack([0 * iz, fy * iz, -fy * pc[:, 1] * iz2], -1)
        J_cam[:, 2] = np.stack([fx * iz, 0 * iz,
                                -(fx * pc[:, 0] + bq) * iz2], -1)
        J_cam[:, 3] = J_cam[:, 1]
        J = J_cam @ R
        H = np.einsum("mri,m,mrj->ij", J, w, J) + damping * np.eye(3)
        dp = -np.linalg.solve(H, np.einsum("mri,m,mr->i", J, w, r))
        p = p + dp
        if np.abs(dp).max() <= convergence:
            break
    pc, z, r = project(p)
    usable = mask * (pc[:, 2] > 0.05)
    n = max(usable.sum(), 1.0)
    err2 = (r * r).sum(-1)
    return p, (usable * (err2 < kernel_px2)).sum() / n, (usable * err2).sum() / n


def test_refinement_core_matches_float64_gauss_newton(rng):
    """The kept structure-of-arrays core against the plain float64 GN."""
    cam = make_cam()
    L, M = 16, 6
    table = lm.make_table(L, M)
    p_true = make_world(rng, L)
    p_true[:, 2] = rng.uniform(5, 20, L)        # well-conditioned depths
    poses = [np.asarray(se3.exp_se3(jnp.asarray(
        [0.1 * i, 0, -0.6 * i, 0, 0.003 * i, 0], jnp.float32)))
        for i in range(M)]
    meas_uv = np.zeros((L, M, 4), np.float32)
    meas_T = np.zeros((L, M, 4, 4), np.float32)
    for i, T in enumerate(poses):
        meas_uv[:, i], _ = observe(cam, T, p_true, noise=0.3, rng=rng)
        meas_T[:, i] = T
    p0 = (p_true + rng.normal(0, 0.3, (L, 3))).astype(np.float32)
    counts = rng.integers(3, M + 1, L)             # partly filled rings
    table = table.replace(
        active=jnp.ones(L, bool), pos_w=jnp.asarray(p0),
        meas_uv=jnp.asarray(meas_uv), meas_T_wc=jnp.asarray(meas_T),
        meas_count=jnp.asarray(counts, jnp.int32))
    fx, fy = cam.left.fx, cam.left.fy
    cx, cy, bq = cam.left.cx, cam.left.cy, cam.right.P[0, 3]
    p_opt, inl, avg, ok = jax.jit(
        lambda t: landmark_opt._refine_soa(t, fx, fy, cx, cy, bq,
                                           10.0, 100, 1e-5, 1e-6))(table)
    mask = np.asarray(lm.measurement_mask(table), np.float64)
    assert np.asarray(ok).all()
    for i in range(L):
        p_ref, inl_ref, avg_ref = _numpy_landmark_gn(
            p0[i], meas_uv[i].astype(np.float64), meas_T[i], mask[i], cam)
        np.testing.assert_allclose(np.asarray(p_opt[i]), p_ref, atol=2e-3)
        np.testing.assert_allclose(float(inl[i]), inl_ref, atol=1e-6)
        np.testing.assert_allclose(float(avg[i]), avg_ref, rtol=1e-2,
                                   atol=1e-3)


def test_optimize_landmarks_needs_min_measurements(rng):
    cam = make_cam()
    table = lm.make_table(8, 8)
    table = table.replace(
        active=jnp.ones(8, bool),
        pos_w=jnp.asarray(make_world(rng, 8)),
        meas_count=jnp.full(8, 2, jnp.int32),  # < 5
    )
    out = landmark_opt.optimize_landmarks(table, cam)
    assert not np.any(np.asarray(out.is_optimal))
    assert np.allclose(np.asarray(out.pos_w), np.asarray(table.pos_w))


def test_optimize_landmarks_rejects_garbage(rng):
    """Inconsistent measurements must fail the inlier-ratio gate."""
    cam = make_cam()
    L, M = 4, 8
    table = lm.make_table(L, M)
    meas_uv = rng.uniform(0, 300, (L, M, 4)).astype(np.float32)
    meas_T = np.broadcast_to(np.eye(4, dtype=np.float32), (L, M, 4, 4)).copy()
    table = table.replace(
        active=jnp.ones(L, bool),
        pos_w=jnp.asarray(make_world(rng, L)),
        meas_uv=jnp.asarray(meas_uv),
        meas_T_wc=jnp.asarray(meas_T),
        meas_count=jnp.full(L, M, jnp.int32),
    )
    out = landmark_opt.optimize_landmarks(table, cam)
    assert np.asarray(out.opt_failed).sum() >= 3


def test_optimize_landmarks_idwa_fallback_recovers_bad_estimate(rng):
    """The inverse-depth-weighted-average fallback (ref dormant alternates
    _getOptimizedLandmarkLEFT3D/_getOptimizedLandmarkIDWA,
    CLandmark.cpp:347-445,583-646): a landmark whose stored estimate is
    BEHIND the cameras gives the pixel-space GN zero usable weights (it
    cannot move), but the measurements themselves agree — IDWA must
    recover the true position."""
    cam = make_cam()
    L, M = 8, 8
    table = lm.make_table(L, M)
    p_true = make_world(rng, L)
    poses = [np.asarray(se3.exp_se3(jnp.asarray(
        [0, 0, -0.5 * i, 0, 0.002 * i, 0], jnp.float32))) for i in range(M)]
    meas_uv = np.zeros((L, M, 4), np.float32)
    meas_T = np.zeros((L, M, 4, 4), np.float32)
    for i, T in enumerate(poses):
        uv4, _ = observe(cam, T, p_true, noise=0.1, rng=rng)
        meas_uv[:, i] = uv4
        meas_T[:, i] = T
    bad = np.tile(np.array([0.0, 0.0, -50.0], np.float32), (L, 1))
    table = table.replace(
        active=jnp.ones(L, bool),
        pos_w=jnp.asarray(bad),                   # behind every camera
        meas_uv=jnp.asarray(meas_uv),
        meas_T_wc=jnp.asarray(meas_T),
        meas_count=jnp.full(L, M, jnp.int32),
    )
    out = landmark_opt.optimize_landmarks(table, cam, idwa_fallback=True)
    opt = np.asarray(out.is_optimal)
    assert opt.mean() > 0.8, f"IDWA fallback failed: {opt}"
    err = np.linalg.norm(np.asarray(out.pos_w) - p_true, axis=-1)
    near = opt & (p_true[:, 2] < 25.0)
    if near.any():
        assert np.median(err[near]) < 0.5
    # without the (opt-in) fallback the same table must fail — the default
    # mirrors the reference, where both alternates are disabled in
    # optimize() (CLandmark.cpp:289-291)
    out2 = landmark_opt.optimize_landmarks(table, cam)
    assert not np.any(np.asarray(out2.is_optimal))
