"""Long-sequence accuracy regression (VERDICT round-2 item 9).

A 520-frame synthetic corridor (~200 m of travel) through the FULL SLAM
system in throughput mode, with bounds calibrated against the 2026-08-19
build (raw ATE 0.94 m, rel translation 4.8%, rel rotation 2.1e-3
rad/frame). Catches f32 drift,
world-shift regressions, and back-end gating regressions that short tests
cannot see.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from svi_mapper_tpu.config import DEFAULT_PARAMS
from svi_mapper_tpu.eval import trajectory as ev
from svi_mapper_tpu.io.synthetic import SyntheticSequence
from svi_mapper_tpu.models.slam import SLAMSystem


@pytest.mark.slow
def test_520_frame_corridor_accuracy():
    params = dataclasses.replace(DEFAULT_PARAMS, max_landmarks=512,
                                 max_detections=512)
    seq = SyntheticSequence(n_frames=520, width=384, height=192, step=0.4)
    frames = [(np.asarray(f[0]), np.asarray(f[1]), f[2]) for f in seq]
    Ls = np.stack([f[0] for f in frames])
    Rs = np.stack([f[1] for f in frames])
    Ts = np.stack([f[2] for f in frames])

    s = SLAMSystem(seq.cam, params)
    s.process_many(Ls, Rs, chunk=16)

    assert s.frame_count == 520
    assert len(s.slam_keyframes) >= 25
    # no tracking collapse anywhere along the 200 m
    tracked = np.asarray([int(o.n_tracked) for o in s.outputs])
    assert (tracked[5:] >= 40).all(), \
        f"tracking collapsed: min {tracked[5:].min()} at {tracked[5:].argmin() + 5}"

    m = ev.evaluate(s.optimized_trajectory(), Ts)
    mr = ev.evaluate(s.trajectory_array, Ts)
    # calibrated regression bounds (1.5x the 2026-08-19 measurements)
    assert mr.ate_rmse_m < 1.45, f"raw ATE {mr.ate_rmse_m:.3f}"
    assert m.ate_rmse_m < 1.45, f"optimized ATE {m.ate_rmse_m:.3f}"
    assert m.rel_trans_ratio < 0.075, f"rel trans {m.rel_trans_ratio:.3%}"
    assert m.rel_rot_err_rad < 0.0033, f"rel rot {m.rel_rot_err_rad:.5f}"
    # trajectory length sanity: the estimate covers the traveled distance
    Traw = s.trajectory_array
    centers = -np.einsum("nji,nj->ni", Traw[:, :3, :3], Traw[:, :3, 3])
    est_len = np.sum(np.linalg.norm(np.diff(centers, axis=0), axis=-1))
    true_len = 0.4 * 519
    assert abs(est_len - true_len) / true_len < 0.06
