"""Regional detection recovery (stage-2 second chance).

The dropout scenario of VERDICT item 8: landmark predictions displaced
beyond the dense tracking window's reach must be recovered by the
corner-detection + region-masked Hamming stage
(ref CFundamentalMatcher.cpp:495-727).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from svi_mapper_tpu.config import DEFAULT_PARAMS
from svi_mapper_tpu.frontend import epipolar as epi
from svi_mapper_tpu.frontend.recovery import regional_recovery
from svi_mapper_tpu.frontend.tracking import track_landmarks
from svi_mapper_tpu.geometry import se3
from svi_mapper_tpu.io.synthetic import SyntheticSequence, render_stereo
from svi_mapper_tpu.models.tracker import StereoTracker
from svi_mapper_tpu.ops.descriptors import smooth_brief_dense
from svi_mapper_tpu.frontend.tracking import REACH_X, REACH_Y


@pytest.fixture(scope="module")
def dropout_case():
    """Tracker state + a next frame where every prediction is shifted far
    beyond the dense window (simulated via a translated pose prior)."""
    params = dataclasses.replace(DEFAULT_PARAMS, max_landmarks=256,
                                 max_detections=256)
    seq = SyntheticSequence(n_frames=4, width=512, height=256, step=0.4)
    tracker = StereoTracker(seq.cam, params, use_gt_pose=True)
    frames = list(seq)
    for (L, R, T) in frames[:3]:
        tracker.process(L, R, T)
    # frame B is a modest true step (appearance preserved), but the POSE fed
    # to tracking is rotation-perturbed so predictions land 30-50 px off —
    # the bad-prior dropout stage 2 exists to absorb
    # (ref getPoseStereoPosit runs stage 1+2 under the raw prior)
    from tests.test_epipolar_tracking import _pose
    T_true = jnp.asarray(frames[3][2], jnp.float32)
    T_wrong = jnp.asarray(_pose(yaw=0.12, pitch=0.045) @ frames[3][2],
                          jnp.float32)
    Lb, Rb = render_stereo(seq.cam, T_true)
    return tracker.state, seq.cam, T_true, T_wrong, Lb, Rb


def test_recovery_beyond_window(dropout_case):
    st, cam, T_true, T_wrong, Lb, Rb = dropout_case
    dense_l = smooth_brief_dense(Lb)
    dense_r = smooth_brief_dense(Rb)

    tr = track_landmarks(dense_l, dense_r, st.table, T_wrong, cam, 3.0)
    tracked = np.asarray(tr.tracked)

    rec = regional_recovery(dense_l, dense_r, Lb, st.table, tr.tracked,
                            T_wrong, cam, 3.0)
    recovered = np.asarray(rec.recovered)

    # which landmarks are genuinely recoverable: active, visible under both
    # poses, displaced beyond the dense window by the prior error
    uv_true = np.asarray(cam.left.project(
        se3.transform(T_true, st.table.pos_w)))
    uv_pred = np.asarray(tr.uv_pred)
    d = np.abs(np.round(uv_true) - np.round(uv_pred))
    beyond = (d[:, 0] > REACH_X) | (d[:, 1] > REACH_Y)
    in_view = np.asarray(cam.left.in_fov(tr.uv_pred)) \
        & np.asarray(cam.left.in_fov(jnp.asarray(uv_true, jnp.float32)))
    needy = np.asarray(st.table.active) & ~tracked & beyond & in_view
    assert needy.sum() >= 20, f"scenario too easy: {needy.sum()} dropouts"

    rate = (needy & recovered).sum() / needy.sum()
    assert rate >= 0.6, f"recovered only {rate:.1%} of window dropouts"

    # recovered measurements land near the true projections
    uv4 = np.asarray(rec.uv4)
    hit = needy & recovered
    err = np.linalg.norm(uv4[hit, :2] - uv_true[hit], axis=-1)
    assert np.median(err) < 2.0


def test_recovery_is_one_to_one(dropout_case):
    st, cam, T_true, T_wrong, Lb, Rb = dropout_case
    dense_l = smooth_brief_dense(Lb)
    dense_r = smooth_brief_dense(Rb)
    none_tracked = jnp.zeros((st.table.capacity,), bool)
    rec = regional_recovery(dense_l, dense_r, Lb, st.table, none_tracked,
                            T_true, cam, 1.5)
    recovered = np.asarray(rec.recovered)
    uv = np.asarray(rec.uv4)[recovered, :2]
    assert recovered.sum() > 10
    # no detection assigned to two landmarks
    assert len(np.unique(uv, axis=0)) == len(uv)


def test_frame_step_recovers_under_bad_gt_pose(dropout_case):
    """End-to-end: the frame step's recovery path re-acquires landmarks the
    window pass lost under a perturbed pose, keeping the measurement
    stream alive."""
    st, cam, T_true, T_wrong, Lb, Rb = dropout_case
    from svi_mapper_tpu.models import frame as frame_mod

    params = dataclasses.replace(DEFAULT_PARAMS, max_landmarks=256,
                                 max_detections=256)
    _, out = frame_mod.process_frame(
        st, Lb, Rb, cam, params, T_wrong, use_gt_pose=True)
    _, out_ref = frame_mod.process_frame(
        st, Lb, Rb, cam, params, T_true, use_gt_pose=True)
    # with recovery, the bad-pose frame keeps a solid fraction of the
    # good-pose frame's measurement count
    assert int(out.n_tracked) >= 0.45 * int(out_ref.n_tracked)
