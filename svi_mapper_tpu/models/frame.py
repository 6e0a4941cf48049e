"""The per-frame SLAM step: one jitted, fully on-device computation.

This is the JAX equivalent of the reference's per-frame call tree
(SURVEY.md §3.1/§3.2: ``CTracker*::process`` -> ``_trackLandmarks`` ->
track / posit / measurement insertion / landmark optimization / keyframe
check / re-detection). The reference interleaves host loops and exceptions;
here the whole frame is ONE compiled XLA program over fixed-shape state:

  images -> smooth -> dense BRIEF fields -> lattice tracking -> stereo posit
  -> measurement append -> (cond) landmark GN refinement -> retirement ->
  masked detection + stereo triangulation -> landmark insertion ->
  keyframe decision.

Host code only feeds images and reads the per-frame outputs (pose, flags).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from svi_mapper_tpu.config import TrackingParams
from svi_mapper_tpu.frontend import epipolar as epi
from svi_mapper_tpu.frontend.recovery import regional_recovery
from svi_mapper_tpu.frontend.stereo import match_stereo
from svi_mapper_tpu.frontend.tracking import track_landmarks
from svi_mapper_tpu.geometry import se3
from svi_mapper_tpu.geometry.camera import StereoCamera
from svi_mapper_tpu.mapping import landmarks as lm
from svi_mapper_tpu.ops.corners import detect_corners, occupancy_mask
from svi_mapper_tpu.ops.descriptors import brief_at, smooth_brief_dense
from svi_mapper_tpu.ops.image import box_blur
from svi_mapper_tpu.solvers.landmark_opt import optimize_landmarks
from svi_mapper_tpu.solvers.posit import solve_stereo_posit
from svi_mapper_tpu.utils import struct


@struct.dataclass
class FrameState:
    """Pure-functional tracking state threaded through the frame scan
    (replaces the mutable members of CTrackerSV/CFundamentalMatcher)."""

    T_wc: jax.Array           # [4,4] current world->LEFT-camera estimate
    T_wc_prev: jax.Array      # [4,4] previous frame (constant-velocity prior)
    T_last_keyframe: jax.Array  # [4,4] pose at the last keyframe spawn
    table: lm.LandmarkTable
    next_uid: jax.Array       # int32
    frame_idx: jax.Array      # int32
    instability: jax.Array    # int32 (ref CTrackerSV.cpp:286-317: +5 on pose
                              # failure, capped 20, -1 per good frame)


@struct.dataclass
class FrameOutput:
    T_wc: jax.Array
    posit_ok: jax.Array       # bool — pose solve accepted (False in GT mode)
    n_tracked: jax.Array      # int32
    n_active: jax.Array       # int32
    n_optimal: jax.Array      # int32 visible optimal landmarks
    n_new: jax.Array          # int32 landmarks inserted
    is_keyframe: jax.Array    # bool
    avg_error_px2: jax.Array  # posit average inlier error
    inliers: jax.Array        # posit inlier count
    instability: jax.Array    # int32 — post-frame instability counter
                              # (ref CTrackerSV.cpp:286-317; gates BA at :430)


@struct.dataclass
class KeyframeSnapshot:
    """Per-frame landmark-table snapshot emitted by the chunked scan so
    host keyframe handling (DB add, closure search, BA observations) sees
    the table AS OF the keyframe's own frame, not the end of the chunk
    (the reference builds the keyframe cloud inline, CTrackerGT.cpp:222-250)."""

    uid: jax.Array        # [L] int32
    active: jax.Array     # [L] bool
    optimal: jax.Array    # [L] bool
    tracked: jax.Array    # [L] bool — measurement landed this frame (failed==0)
    uv_left: jax.Array    # [L, 2] last left pixel
    disparity: jax.Array  # [L]
    pos_w: jax.Array      # [L, 3]
    desc: jax.Array       # [L, 8] uint32 left reference descriptors
    bit_prob: jax.Array   # [L, 256] uint8 quantized bit probabilities
                          # (closure-pool probabilistic descriptors)


def snapshot_of(table: lm.LandmarkTable) -> KeyframeSnapshot:
    return KeyframeSnapshot(
        uid=table.uid,
        active=table.active,
        optimal=table.is_optimal,
        tracked=table.failed == 0,
        uv_left=table.uv_left_last,
        disparity=table.disparity_last,
        pos_w=table.pos_w,
        desc=table.desc_left_ref,
        bit_prob=lm.bit_prob_u8(table),
    )


def init_state(params: TrackingParams, T0: jax.Array | None = None) -> FrameState:
    eye = jnp.eye(4, dtype=jnp.float32) if T0 is None else jnp.asarray(T0, jnp.float32)
    return FrameState(
        T_wc=eye,
        T_wc_prev=eye,
        T_last_keyframe=eye,
        table=lm.make_table(params.max_landmarks, params.max_measurements,
                            history_slots=params.desc_history_slots),
        next_uid=jnp.int32(0),
        frame_idx=jnp.int32(0),
        instability=jnp.int32(0),
    )


def _constant_velocity_prior(state: FrameState) -> jax.Array:
    """T_pred = (T_cur inv(T_prev)) T_cur (ref CTrackerSV constant-velocity
    prior, CTrackerSV.cpp:134-239)."""
    prec = jax.lax.Precision.HIGHEST
    delta = jnp.matmul(state.T_wc, se3.inv_T(state.T_wc_prev), precision=prec)
    return jnp.matmul(delta, state.T_wc, precision=prec)


@functools.partial(
    jax.jit, static_argnames=("params", "use_gt_pose", "use_external_prior")
)
def process_frame(
    state: FrameState,
    img_left: jax.Array,        # [H, W] float32
    img_right: jax.Array,
    cam: StereoCamera,
    params: TrackingParams,
    T_gt: jax.Array | None = None,   # [4,4] GT pose, or external prior
    *,
    use_gt_pose: bool = False,
    use_external_prior: bool = False,   # T_gt is a PRIOR (IMU), posit still runs
    do_landmark_opt: jax.Array | bool = True,
    T_fallback: jax.Array | None = None,   # pose when the whole cascade fails
                                     # (SVI: damped IMU dead reckoning with the
                                     # x rotation zeroed, ref CTrackerSVI.cpp:548-551;
                                     # default: keep the raw prior)
) -> tuple[FrameState, FrameOutput]:
    """Process one stereo frame. Compiled once per image shape."""
    # --- image preprocessing + dense descriptor fields -------------------
    dense_l = smooth_brief_dense(img_left)
    dense_r = smooth_brief_dense(img_right)

    # --- pose prior ------------------------------------------------------
    if use_gt_pose or use_external_prior:
        assert T_gt is not None
        T_prior = T_gt
    else:
        T_prior = _constant_velocity_prior(state)

    # search-window motion scaling from the frame-to-frame prior delta
    # (ref CTrackerGT.cpp:157: min(1 + 10|w| + 0.5|t|, 5))
    ms = epi.motion_scaling(
        jnp.matmul(T_prior, se3.inv_T(state.T_wc),
                   precision=jax.lax.Precision.HIGHEST),
        params.motion_scaling_cap,
    )

    # --- temporal tracking (3-stage lattice) + frame pose ----------------
    def _attempt(T_p):
        """One track-then-solve attempt under a given pose prior (the body
        of the reference's getPoseStereoPosit, CFundamentalMatcher.cpp:338:
        match collection reprojets with the prior, so a retry re-collects)."""
        tr = track_landmarks(
            dense_l, dense_r, state.table, T_p, cam, ms,
            cutoff_s1=params.matching_distance_tracking,
            cutoff_s2=params.matching_distance_tracking_stage2,
            cutoff_ref=params.matching_distance_epipolar,
            cutoff_stereo=params.matching_distance_triangulation,
            use_desc_history=params.use_desc_history,
        )
        rs = solve_stereo_posit(
            T_p, state.table.pos_w, tr.uv4, tr.tracked, cam,
            T_prior=T_p,
            kernel_px2=params.posit_kernel_px2,
            min_points=params.posit_min_points,
            min_inliers=params.posit_min_inliers,
            max_error_px2=params.posit_max_error_px2,
            max_risk_m2=params.posit_max_risk_m2,
            max_iterations=params.posit_max_iterations,
            convergence=params.posit_convergence,
        )
        return tr, rs

    if use_gt_pose:
        track = track_landmarks(
            dense_l, dense_r, state.table, T_prior, cam, ms,
            cutoff_s1=params.matching_distance_tracking,
            cutoff_s2=params.matching_distance_tracking_stage2,
            cutoff_ref=params.matching_distance_epipolar,
            cutoff_stereo=params.matching_distance_triangulation,
            use_desc_history=params.use_desc_history,
        )
        T_new = T_gt
        posit_ok = jnp.asarray(False)
        avg_err = jnp.asarray(0.0, jnp.float32)
        inliers = jnp.int32(0)
        instability = state.instability
    else:
        # fallback cascade (ref CTrackerSV.cpp:271-318): raw prior ->
        # rotation-only prior (predicted rotation, LAST frame's camera
        # center) -> keep the raw prior with instability += 5
        track1, res1 = _attempt(T_prior)

        R_prior = T_prior[:3, :3]
        c_last = -state.T_wc[:3, :3].T @ state.T_wc[:3, 3]   # last camera center
        T_rot = jnp.eye(4, dtype=T_prior.dtype)
        T_rot = T_rot.at[:3, :3].set(R_prior)
        T_rot = T_rot.at[:3, 3].set(-R_prior @ c_last)

        track, res = jax.lax.cond(
            res1.ok,
            lambda _: (track1, res1),
            lambda _: _attempt(T_rot),
            None,
        )
        posit_ok = res.ok
        avg_err = res.avg_error_px2
        inliers = res.inliers
        # final failure -> fallback pose (raw prior, or the caller's dead
        # reckoning) and raise the instability counter
        # (ref CTrackerSV.cpp:286-317: +5 capped at 20, -1 decay)
        T_fb = T_prior if T_fallback is None else T_fallback
        T_new = jnp.where(posit_ok, res.T_wc, T_fb)
        instability = jnp.clip(
            jnp.where(posit_ok, state.instability - 1, state.instability + 5),
            0, 20,
        )
    # --- regional detection recovery (stage-2 second chance under the
    #     refined pose, ref CFundamentalMatcher.cpp:495-727) ---------------
    if params.enable_recovery:
        rec = regional_recovery(
            dense_l, dense_r, img_left, state.table, track.tracked, T_new,
            cam, ms,
            cutoff=params.matching_distance_tracking_stage2,
            cutoff_stereo=params.matching_distance_triangulation,
            max_detections=params.recovery_max_detections,
            detect_cell=params.recovery_cell,
            use_desc_history=params.use_desc_history,
        )
        tracked_all = track.tracked | rec.recovered
        uv4_all = jnp.where(track.tracked[:, None], track.uv4, rec.uv4)
        desc_all = jnp.where(track.tracked[:, None], track.desc_left,
                             rec.desc_left)
    else:
        tracked_all = track.tracked
        uv4_all = track.uv4
        desc_all = track.desc_left
    n_tracked = jnp.sum(tracked_all.astype(jnp.int32))

    # --- measurements ----------------------------------------------------
    table = lm.add_measurements(
        state.table, tracked_all, uv4_all, desc_all, T_new,
        hist_every=params.desc_history_every,
    )

    # --- landmark refinement (cond: GT every frame, SV every 10 frames —
    #     ref CTrackerGT.cpp:196-198 / CTrackerSV.h:79) ------------------
    do_opt = jnp.asarray(do_landmark_opt)

    def _opt(t):
        return optimize_landmarks(
            t, cam,
            min_measurements=params.landmark_min_measurements,
            kernel_px2=params.landmark_kernel_px2,
            max_error_px2=params.landmark_max_error_px2,
            min_inlier_ratio=params.landmark_min_inlier_ratio,
            max_iterations=params.landmark_max_iterations,
            convergence=params.landmark_convergence,
            idwa_fallback=params.landmark_idwa_fallback,
        )

    table = jax.lax.cond(do_opt, _opt, lambda t: t, table)

    # --- retirement ------------------------------------------------------
    table = lm.retire_landmarks(table, params)

    # --- detection of new landmarks --------------------------------------
    allowed = occupancy_mask(
        img_left.shape, table.uv_left_last, table.active & tracked_all,
        radius=params.detect_min_distance,
    )
    uv_new, score_new, valid_new = detect_corners(
        img_left,
        k=params.max_detections,
        cell=params.detect_cell,
        quality=params.detect_quality,
        border=28,
        mask=allowed,
    )
    desc_new = brief_at(dense_l, uv_new)
    sm = match_stereo(
        dense_r, uv_new, desc_new, valid_new, cam,
        cutoff=params.matching_distance_triangulation,
        min_depth=params.min_depth_m,
        max_depth=params.max_depth_m,
    )
    desc_new_r = brief_at(dense_r, sm.uv_right)
    T_cw = se3.inv_T(T_new)
    pos_w_new = se3.transform(T_cw, sm.p_cam)
    uv4_new = jnp.concatenate([uv_new, sm.uv_right], axis=-1)
    table, next_uid = lm.insert_landmarks(
        table, sm.ok, pos_w_new, uv_new, sm.disparity,
        desc_new, desc_new_r, uv4_new, T_new, state.next_uid,
    )
    n_new = next_uid - state.next_uid

    # --- keyframe decision (ref CTrackerGT.h:47-49,68) -------------------
    delta_kf = jnp.matmul(T_new, se3.inv_T(state.T_last_keyframe),
                          precision=jax.lax.Precision.HIGHEST)
    dt2 = jnp.sum(delta_kf[:3, 3] ** 2)
    dr2 = jnp.sum(se3.log_so3(delta_kf[:3, :3]) ** 2)
    n_optimal = jnp.sum((table.active & table.is_optimal & tracked_all).astype(jnp.int32))
    is_keyframe = (
        (dt2 > params.keyframe_translation_m2) | (dr2 > params.keyframe_rotation_rad2)
    ) & (n_optimal >= params.keyframe_min_landmarks)

    # bump keyframe presences of the landmarks visible in a new keyframe
    # (promotion rule, ref CFundamentalMatcher.cpp:203-242)
    table = table.replace(
        keyframe_presences=jnp.where(
            is_keyframe & table.active & tracked_all,
            table.keyframe_presences + 1,
            table.keyframe_presences,
        )
    )

    new_state = FrameState(
        T_wc=T_new,
        T_wc_prev=state.T_wc,
        T_last_keyframe=jnp.where(is_keyframe, T_new, state.T_last_keyframe),
        table=table,
        next_uid=next_uid,
        frame_idx=state.frame_idx + 1,
        instability=state.instability if use_gt_pose else instability,
    )
    out = FrameOutput(
        T_wc=T_new,
        posit_ok=posit_ok,
        n_tracked=n_tracked,
        n_active=jnp.sum(table.active.astype(jnp.int32)),
        n_optimal=n_optimal,
        n_new=n_new,
        is_keyframe=is_keyframe,
        avg_error_px2=avg_err,
        inliers=inliers,
        instability=new_state.instability,
    )
    return new_state, out


@functools.partial(
    jax.jit,
    static_argnames=("params", "use_gt_pose", "landmark_opt_every",
                     "emit_snapshots"),
)
def process_chunk(
    state: FrameState,
    imgs_left: jax.Array,       # [N, H, W] float32 — staged frame chunk
    imgs_right: jax.Array,
    cam: StereoCamera,
    params: TrackingParams,
    T_gt: jax.Array | None = None,   # [N,4,4] GT poses (GT mode only)
    *,
    use_gt_pose: bool = False,
    landmark_opt_every: int = 1,
    emit_snapshots: bool = False,
) -> tuple[FrameState, FrameOutput]:
    """Throughput mode: ``lax.scan`` the frame step over a staged chunk.

    One dispatch + one compiled program processes N frames back-to-back on
    device — dispatch latency and host sync amortize over the chunk, and
    XLA overlaps the per-frame programs' memory traffic. Numerically
    IDENTICAL to N sequential :func:`process_frame` calls (the scan body is
    the same traced computation); the landmark-opt cadence is computed from
    the carried ``frame_idx`` so cadence survives chunk boundaries.

    Keyframe/loop-closure events surface in the stacked FrameOutput; host
    code handles them after each chunk (the offline/throughput analog of the
    reference's per-frame dataset playback, tracker_gt.cpp:182-268). With
    ``emit_snapshots=True`` the scan additionally stacks a per-frame
    :class:`KeyframeSnapshot` (~60 KB/frame) so the SLAM back-end can build
    each keyframe's observation set from its OWN frame's table.
    """
    every = max(1, landmark_opt_every)

    def step(carry, inp):
        l, r, T = inp
        do_opt = (carry.frame_idx % every) == 0
        carry, out = process_frame(
            carry, l, r, cam, params, T,
            use_gt_pose=use_gt_pose,
            do_landmark_opt=do_opt,
        )
        if emit_snapshots:
            return carry, (out, snapshot_of(carry.table))
        return carry, out

    n = imgs_left.shape[0]
    if T_gt is None:
        T_feed = jnp.zeros((n, 4, 4), jnp.float32)   # unused (not GT mode)
    else:
        T_feed = T_gt
    state, ys = jax.lax.scan(step, state, (imgs_left, imgs_right, T_feed))
    if emit_snapshots:
        out, snaps = ys
        return state, out, snaps
    return state, ys


@functools.partial(
    jax.jit,
    static_argnames=("params", "landmark_opt_every", "equalize"),
)
def process_chunk_svi(
    state: FrameState,
    imgs_left: jax.Array,       # [N, H, W] float32 — RAW frames (pre-
    imgs_right: jax.Array,      #   processing runs inside the scan)
    cam: StereoCamera,
    params: TrackingParams,
    dts: jax.Array,             # [N, cap] per-sample time steps (0-padded)
    omega: jax.Array,           # [N, cap, 3] raw IMU angular velocities
    accel: jax.Array,           # [N, cap, 3] raw IMU specific forces
    valid: jax.Array,           # [N, cap] bool sample mask
    velocity0: jax.Array,       # [3] camera-frame linear velocity carry-in
    R_ci: jax.Array,            # [3,3] IMU->camera rotation
    bias_gyro: jax.Array,       # [3]
    bias_accel: jax.Array,      # [3]
    *,
    landmark_opt_every: int = 1,
    equalize: bool = False,
    rect_maps: tuple | None = None,   # (mlx, mly, mrx, mry) or None
) -> tuple:
    """SVI throughput mode: the stereo-inertial frame step under one
    ``lax.scan`` (VERDICT r2 Weak-5: the per-frame SVI path paid a host
    dispatch per frame). Each scan step integrates the frame interval's
    IMU sample block into a pose prior from the CARRIED velocity + pose
    (imu.interpolator.integrate_prior_samples — the 200 Hz per-sample
    path), equalizes/rectifies the raw frames on device
    (ref CTrackerSVI.cpp:339-341), runs the visual solve with the IMU
    dead-reckoning fallback (x-zeroed rotation, ref :548-551), and updates
    the velocity from the accepted pose delta — numerically identical
    stepping to N sequential ``process_imu_samples`` calls.

    Returns ``(state, velocity, outputs, snapshots)``.
    """
    from svi_mapper_tpu.imu import interpolator as imu_mod
    from svi_mapper_tpu.ops.image import equalize_hist, remap_bilinear

    every = max(1, landmark_opt_every)
    prec = jax.lax.Precision.HIGHEST

    def prep(x, mx, my):
        if equalize:
            x = equalize_hist(
                jnp.clip(x, 0, 255).astype(jnp.uint8)).astype(jnp.float32)
        if rect_maps is not None:
            x = remap_bilinear(x, mx, my)
        return x

    def step(carry, inp):
        st, vel = carry
        l, r, dt_s, om, ac, va = inp
        if rect_maps is not None:
            mlx, mly, mrx, mry = rect_maps
        else:
            mlx = mly = mrx = mry = None
        l = prep(l, mlx, mly)
        r = prep(r, mrx, mry)
        T = st.T_wc
        T_prior, rot_total = imu_mod.integrate_prior_samples(
            T, dt_s, om, ac, va, vel, R_ci, bias_gyro, bias_accel)
        # dead-reckoning fallback: damped rotation-only with the x
        # component zeroed (ref CTrackerSVI.cpp:548-551)
        rot_yz = rot_total.at[0].set(0.0)
        T_fb = jnp.matmul(
            jnp.eye(4, dtype=jnp.float32).at[:3, :3].set(
                se3.exp_so3(rot_yz)), T, precision=prec)
        do_opt = (st.frame_idx % every) == 0
        st2, out = process_frame(
            st, l, r, cam, params, T_prior,
            use_external_prior=True, do_landmark_opt=do_opt,
            T_fallback=T_fb,
        )
        # velocity from the accepted visual delta, in the pre-correction
        # gauge (models.svi._update_velocity semantics)
        delta = jnp.matmul(st2.T_wc, se3.inv_T(T), precision=prec)
        xi = se3.log_se3(delta)
        dt_total = jnp.sum(dt_s * va)
        vel2 = jnp.where(dt_total > 1e-6,
                         xi[:3] / jnp.maximum(dt_total, 1e-6), vel)
        return (st2, vel2), (out, snapshot_of(st2.table))

    (state, vel), (outs, snaps) = jax.lax.scan(
        step, (state, jnp.asarray(velocity0, jnp.float32)),
        (imgs_left, imgs_right, dts, omega, accel, valid))
    return state, vel, outs, snaps
