"""True epipolar stage-3: geometry, differential oracle, and the
yaw+roll recovery bar.

The oriented epipolar band (frontend.epipolar) replaces the fixed
horizontal stage-3 band. Its defining property — from the epipolar
constraint — is that the landmark's true current projection lies ON the
band regardless of the error in the landmark's 3D estimate (depth error
slides the prediction *along* the epipolar line). Ref:
CFundamentalMatcher::trackEpipolar, CFundamentalMatcher.cpp:802-977.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from svi_mapper_tpu.config import DEFAULT_PARAMS
from svi_mapper_tpu.frontend import epipolar as epi
from svi_mapper_tpu.frontend.tracking import track_landmarks
from svi_mapper_tpu.geometry import se3
from svi_mapper_tpu.io.synthetic import SyntheticSequence, default_camera
from svi_mapper_tpu.mapping import landmarks as lm
from svi_mapper_tpu.models.tracker import StereoTracker
from svi_mapper_tpu.ops.descriptors import smooth_brief_dense
from svi_mapper_tpu.frontend.tracking import REACH_X, REACH_Y


def _pose(yaw=0.0, pitch=0.0, roll=0.0, t=(0.0, 0.0, 0.0)):
    """world->camera pose from camera yaw/pitch/roll + camera center."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    R_cw = Rz @ Rx @ Ry        # camera-from-world rotation
    T = np.eye(4)
    T[:3, :3] = R_cw
    T[:3, 3] = -R_cw @ np.asarray(t, np.float64)
    return T


def test_motion_scaling_formula():
    T = np.eye(4)
    assert float(epi.motion_scaling(jnp.asarray(T))) == pytest.approx(1.0)
    T = _pose(yaw=0.1, t=(0.5, 0, 1.0))
    w = se3.log_so3(jnp.asarray(T[:3, :3]))
    expect = 1.0 + 10.0 * float(jnp.linalg.norm(w)) + 0.5 * float(
        np.linalg.norm(T[:3, 3]))
    assert float(epi.motion_scaling(jnp.asarray(T))) == pytest.approx(
        min(expect, 5.0), rel=1e-5)
    assert float(epi.motion_scaling(jnp.asarray(_pose(yaw=1.0)))) == 5.0


def _table_with_points(cam, points_w, T_A):
    """A landmark table seeded with exact observations from pose A."""
    n = points_w.shape[0]
    table = lm.make_table(capacity=n, max_measurements=4)
    p_a = se3.transform(jnp.asarray(T_A, jnp.float32), jnp.asarray(points_w, jnp.float32))
    uv_l = cam.left.project(p_a)
    uv_r = cam.right.project(p_a)
    uv4 = jnp.concatenate([uv_l, uv_r], -1)
    desc = jnp.zeros((n, 8), jnp.uint32)
    table, _ = lm.insert_landmarks(
        table, jnp.ones((n,), bool), jnp.asarray(points_w, jnp.float32),
        uv_l, uv_l[:, 0] - uv_r[:, 0], desc, desc, uv4,
        jnp.asarray(T_A, jnp.float32), jnp.int32(0),
    )
    return table, np.asarray(uv_l)


def test_band_contains_true_projection_despite_depth_error():
    """Corrupt every landmark's depth along its frame-A viewing ray: the
    band computed from the (wrong) prediction must still contain the TRUE
    frame-B projection — the epipolar guarantee the fixed band lacked."""
    rng = np.random.default_rng(0)
    cam = default_camera(512, 256)
    T_A = _pose()
    T_B = _pose(yaw=0.04, roll=0.06, t=(0.5, 0.45, 1.2))

    n = 64
    pts = np.stack([
        rng.uniform(-6, 6, n), rng.uniform(-3, 3, n), rng.uniform(6, 16, n)
    ], -1)
    table, _ = _table_with_points(cam, pts, T_A)

    # corrupt depth along the frame-A ray (projection in A unchanged)
    center_A = -T_A[:3, :3].T @ T_A[:3, 3]
    scale = rng.uniform(0.7, 1.4, (n, 1))
    pts_bad = center_A + (pts - center_A) * scale
    table = table.replace(pos_w=jnp.asarray(pts_bad, jnp.float32))

    uv_pred = cam.left.project(
        se3.transform(jnp.asarray(T_B, jnp.float32), table.pos_w))
    nxq, nyq, c0q, ru, rv = [np.asarray(a) for a in epi.epipolar_band_params(
        table, jnp.asarray(T_B, jnp.float32), cam.left, uv_pred, 3.0,
        reach_x=REACH_X, reach_y=REACH_Y,
    )]

    uv_true = np.asarray(cam.left.project(
        se3.transform(jnp.asarray(T_B, jnp.float32),
                      jnp.asarray(pts, jnp.float32))))
    uv_pred = np.asarray(uv_pred)
    d = np.round(uv_true) - np.round(uv_pred)
    perp = np.abs(c0q + nxq * d[:, 0] + nyq * d[:, 1]) / epi.BAND_SCALE
    # only meaningful where the displacement is inside the window reach
    in_reach = (np.abs(d[:, 0]) <= REACH_X) & (np.abs(d[:, 1]) <= REACH_Y)
    assert in_reach.sum() >= n // 2
    assert (perp[in_reach] <= epi.BAND_HALF_WIDTH_PX).all(), \
        f"max perpendicular distance {perp[in_reach].max():.2f}px"
    # and a healthy fraction genuinely needed stage 3 (off the fixed band)
    off_fixed = in_reach & (np.abs(d[:, 1]) > 2)
    assert off_fixed.sum() >= 10


def test_degenerate_translation_falls_back_to_horizontal_band():
    cam = default_camera(256, 128)
    T_A = _pose()
    T_B = _pose(yaw=0.2)     # pure rotation: essential matrix undefined
    pts = np.array([[1.0, 0.5, 10.0], [-2.0, 1.0, 15.0]])
    table, _ = _table_with_points(cam, pts, T_A)
    uv_pred = cam.left.project(
        se3.transform(jnp.asarray(T_B, jnp.float32), table.pos_w))
    nxq, nyq, c0q, *_ = epi.epipolar_band_params(
        table, jnp.asarray(T_B, jnp.float32), cam.left, uv_pred, 1.0,
        reach_x=REACH_X, reach_y=REACH_Y,
    )
    np.testing.assert_array_equal(np.asarray(nxq), 0)
    np.testing.assert_array_equal(np.asarray(nyq), epi.BAND_SCALE)
    np.testing.assert_array_equal(np.asarray(c0q), 0)


def test_yaw_roll_recovery_vs_fixed_band():
    """A yaw+roll step with depth-corrupted landmarks: the oriented band
    must keep >= 90% of the *recoverable* tracks the fixed horizontal band
    loses (the VERDICT round-2 acceptance bar for true epipolar stage-3).

    "Recoverable" excludes losses no stage-3 spec could track, all
    reference-faithful exclusions:
      * true displacement beyond the window reach (+-28, +-20) — the
        reference clips its sampling segment to the window too
        (CFundamentalMatcher.cpp:862-905);
      * corrupted prediction outside the 28 px FoV inset — the reference
        throws "projection out of sight" (CFundamentalMatcher.cpp:849);
      * appearance-dead tracks whose descriptor at the TRUE pixel already
        exceeds the stage cutoff (no candidate set can accept them).
    """
    from svi_mapper_tpu.io.synthetic import render_stereo
    from svi_mapper_tpu.ops.descriptors import brief_at

    params = dataclasses.replace(DEFAULT_PARAMS, max_landmarks=384,
                                 max_detections=384)
    seq = SyntheticSequence(n_frames=4, width=512, height=256, step=0.4)
    tracker = StereoTracker(seq.cam, params, use_gt_pose=True)
    frames = list(seq)
    for (L, R, T) in frames[:3]:
        tracker.process(L, R, T)
    st = tracker.state

    # frame B: continue with translation + a strong yaw+roll twist
    T_last = frames[2][2]
    twist = _pose(yaw=0.03, roll=0.07, t=(0.5, 0.6, 0.9))
    T_B = jnp.asarray(twist @ T_last, jnp.float32)
    Lb, Rb = render_stereo(seq.cam, T_B)

    dense_l = smooth_brief_dense(Lb)
    dense_r = smooth_brief_dense(Rb)
    ms = epi.motion_scaling(jnp.asarray(twist, jnp.float32))

    def run(table, use_epipolar):
        return track_landmarks(dense_l, dense_r, table, T_B, seq.cam, ms,
                               use_epipolar=use_epipolar)

    # corrupt depths along each landmark's last viewing ray (projection at
    # the last observation unchanged -> the displacement in frame B slides
    # along the epipolar line)
    rng = np.random.default_rng(1)
    idx = (np.asarray(st.table.meas_next) - 1) % st.table.max_measurements
    T_obs = np.asarray(st.table.meas_T_wc)[np.arange(st.table.capacity), idx]
    centers = -np.einsum("lji,lj->li", T_obs[:, :3, :3], T_obs[:, :3, 3])
    pos = np.asarray(st.table.pos_w)
    scale = np.where(rng.random(pos.shape[0]) < 0.5, 0.80, 1.30)[:, None]
    pos_bad = centers + (pos - centers) * scale
    bad_table = st.table.replace(pos_w=jnp.asarray(pos_bad, jnp.float32))

    tr_epi = run(bad_table, True)                         # oriented band
    ideal = np.asarray(run(st.table, True).tracked)       # clean 3D estimates
    fixed = np.asarray(run(bad_table, False).tracked)     # fixed band
    epib = np.asarray(tr_epi.tracked)

    # recoverability filter (see docstring)
    uv_true = np.asarray(seq.cam.left.project(
        se3.transform(T_B, st.table.pos_w)))
    uv_pred = np.asarray(tr_epi.uv_pred)
    d = np.round(uv_true) - np.round(uv_pred)
    in_reach = (np.abs(d[:, 0]) <= REACH_X) & (np.abs(d[:, 1]) <= REACH_Y)
    in_view = np.asarray(seq.cam.left.in_fov(tr_epi.uv_pred))
    ham_true = np.bitwise_count(
        np.asarray(brief_at(dense_l, jnp.asarray(uv_true)))
        ^ np.asarray(st.table.desc_left_last)
    ).sum(-1)
    recoverable = in_reach & in_view & (ham_true <= 50)

    lost = ideal & ~fixed & recoverable
    assert lost.sum() >= 6, f"scenario too easy: only {lost.sum()} lost"
    recovered = lost & epib
    rate = recovered.sum() / lost.sum()
    assert rate >= 0.9, f"recovered only {rate:.1%} of fixed-band losses"
