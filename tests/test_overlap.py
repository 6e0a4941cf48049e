"""Overlapped back-end: the keyframe tail (DB add, closure search, pose
graph, BA) on a worker thread with fold-based state reconciliation.

The reference runs its back-end inline in the frame loop
(CTrackerSV.cpp:440); ``SLAMSystem(overlap_backend=True)`` overlaps it with
the next chunk's front-end while preserving the closure/BA semantics.
These tests pin the overlap mode to the synchronous mode's behavior on a
revisiting loop.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from svi_mapper_tpu.config import DEFAULT_PARAMS
from svi_mapper_tpu.eval import trajectory as ev
from svi_mapper_tpu.io.synthetic import SyntheticSequence
from svi_mapper_tpu.models.slam import SLAMSystem

pytestmark = pytest.mark.slow  # whole-module e2e (fast-subset excluded)

# circular-loop world overrides (see tests/test_slam.py PARAMS rationale)
PARAMS = dataclasses.replace(DEFAULT_PARAMS, max_landmarks=512,
                             max_detections=512,
                             closure_exclude_recent=10,
                             max_motion_scaling_for_optimization=2.5)


@pytest.fixture(scope="module")
def loop_imgs():
    seq = SyntheticSequence(n_frames=96, width=512, height=256,
                            trajectory="loop", loop_radius=12.0)
    L = jnp.stack([jnp.asarray(f[0]) for f in seq])
    R = jnp.stack([jnp.asarray(f[1]) for f in seq])
    return seq, L, R


def _run(seq, L, R, overlap: bool) -> SLAMSystem:
    s = SLAMSystem(seq.cam, PARAMS, enable_local_ba=True,
                   enable_loop_closure=True, overlap_backend=overlap)
    s.process_many(L, R, chunk=16)
    s.finalize_backend()   # drain worker + the closure waiting queue
    return s


@pytest.fixture(scope="module")
def overlap_run(loop_imgs):
    seq, L, R = loop_imgs
    return seq, _run(seq, L, R, overlap=True)


def test_overlap_closes_the_loop(overlap_run):
    _, s = overlap_run
    assert s.stats["closures_accepted"] >= 1
    assert s.stats["pose_graph_runs"] >= 1
    assert s.stats["ba_runs"] >= 1
    # the worker queue drained and every future completed without error
    assert not s._bk_futures
    assert s._bk_folds.empty()


def test_overlap_accuracy_matches_sync(overlap_run, loop_imgs):
    """Overlapping must not cost accuracy: the optimized ATE stays in the
    synchronous mode's band on the same loop."""
    seq, L, R = loop_imgs
    _, s_ov = overlap_run
    s_sy = _run(seq, L, R, overlap=False)
    ate_ov = ev.evaluate(s_ov.optimized_trajectory(), seq.poses_wc).ate_rmse_m
    ate_sy = ev.evaluate(s_sy.optimized_trajectory(), seq.poses_wc).ate_rmse_m
    assert np.isfinite(ate_ov) and np.isfinite(ate_sy)
    assert ate_ov < max(1.25 * ate_sy, 0.25)
    assert ate_ov < 0.5


def test_overlap_keyframes_sane(overlap_run):
    _, s = overlap_run
    for kf in s.slam_keyframes:
        assert np.isfinite(kf.T_wc).all()
        R = kf.T_wc[:3, :3]
        assert np.allclose(R @ R.T, np.eye(3), atol=1e-4)
        # overlap mode records snapshot positions for worker-side BA inits
        assert kf.obs_pos.shape == (len(kf.obs_uids), 3)


def test_overlap_single_device_falls_back_to_sync(loop_imgs, monkeypatch):
    """On a single visible device overlap only adds overhead — requesting
    it must warn and fall back to the synchronous back-end; 'force' keeps
    the worker."""
    import jax

    import svi_mapper_tpu.models.slam as slam_mod

    seq, _, _ = loop_imgs
    one = jax.devices()[:1]
    monkeypatch.setattr(slam_mod.jax, "devices", lambda *a, **k: one)
    with pytest.warns(UserWarning, match="single visible device"):
        s = SLAMSystem(seq.cam, PARAMS, overlap_backend=True)
    assert s._bk_pool is None            # synchronous
    s.close()
    s2 = SLAMSystem(seq.cam, PARAMS, overlap_backend="force")
    assert s2._bk_pool is not None       # worker kept on request
    s2.close()


def test_overlap_rejects_async_closure_combo(loop_imgs):
    seq, _, _ = loop_imgs
    with pytest.raises(ValueError):
        SLAMSystem(seq.cam, PARAMS, overlap_backend=True, async_closure=True)


def test_overlap_per_frame_mode(loop_imgs):
    """The per-frame process() path also routes keyframes through the
    worker and folds at keyframe boundaries."""
    seq, L, R = loop_imgs
    s = SLAMSystem(seq.cam, PARAMS, enable_local_ba=True,
                   enable_loop_closure=True, overlap_backend=True)
    for i in range(40):
        s.process(np.asarray(L[i]), np.asarray(R[i]))
    s.flush_backend()
    assert len(s.slam_keyframes) >= 2
    assert np.isfinite(s.trajectory_array).all()
