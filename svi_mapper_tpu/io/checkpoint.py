"""Checkpoint / resume of the full SLAM map state.

The reference is not resumable — its only persistence is g2o graph snapshots
(Cg2oOptimizer.cpp:493-514), keyframe cloud files (CKeyFrame.cpp:138-185)
and the final KITTI trajectory log. SURVEY.md §5 requires the new framework
to checkpoint the *whole* map state (landmark arrays, keyframe poses, pose
graph, closure edges) so long runs can stop and resume exactly.

Everything device-resident here is a fixed-capacity array (static shapes
compile once), so a checkpoint is one compressed ``.npz``: the FrameState pytree
leaves, the keyframe database pools, and the ragged host-side records
(keyframes, closures) stored as concatenated arrays + offsets. A JSON
manifest carries the scalars, the tracking parameters, and the camera
calibration, so ``load_checkpoint`` can rebuild a tracker without any other
inputs. Arrays are pulled to host with ``np.asarray`` — under a sharded
mesh this is a gather; re-sharding on load is the caller's mesh placement.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np

# v2: closure waiting-queue state + per-edge uid_pairs/suppressed (r5)
CHECKPOINT_VERSION = 2

_STATE_FIELDS = (
    "T_wc", "T_wc_prev", "T_last_keyframe", "next_uid", "frame_idx",
    "instability",
)
_CAM_FIELDS = ("P", "K", "dist", "R_rect")


def _cat(arrays, dtype):
    """Concatenate a ragged list of [n, ...] arrays -> (flat, offsets)."""
    if not arrays:
        return np.zeros((0,), dtype), np.zeros(1, np.int64)
    flat = np.concatenate([np.asarray(a, dtype) for a in arrays], axis=0)
    offs = np.zeros(len(arrays) + 1, np.int64)
    np.cumsum([len(a) for a in arrays], out=offs[1:])
    return flat, offs


def _split(flat, offs):
    return [flat[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]


def save_checkpoint(path: str | Path, tracker) -> None:
    """Serialize a :class:`StereoTracker` / :class:`SLAMSystem` to ``path``.

    The checkpoint is self-contained: camera calibration and tracking
    parameters ride along, so resuming needs only the file.
    """
    from svi_mapper_tpu.models.slam import SLAMSystem

    if hasattr(tracker, "flush_closures"):
        tracker.flush_closures(block=True)   # async searches must land first

    arrays: dict[str, np.ndarray] = {}
    state = tracker.state
    for f in _STATE_FIELDS:
        arrays[f"state__{f}"] = np.asarray(getattr(state, f))
    for f in dataclasses.fields(state.table):
        arrays[f"table__{f.name}"] = np.asarray(getattr(state.table, f.name))

    if tracker.trajectory:
        arrays["trajectory"] = np.stack(
            [np.asarray(T, np.float64) for T in tracker.trajectory])
    # robocentric world-shift state (ref m_vecTranslationToG2o)
    arrays["world_offset"] = np.asarray(tracker.world_offset, np.float64)
    arrays["world_shifts"] = np.asarray(tracker.world_shifts, np.int64)

    # camera (both eyes)
    for eye in ("left", "right"):
        c = getattr(tracker.cam, eye)
        for f in _CAM_FIELDS:
            arrays[f"cam__{eye}__{f}"] = np.asarray(getattr(c, f))

    from svi_mapper_tpu.models.svi import StereoInertialTracker

    kind = ("svi" if isinstance(tracker, StereoInertialTracker)
            else "slam" if isinstance(tracker, SLAMSystem) else "tracker")
    meta = {
        "version": CHECKPOINT_VERSION,
        "kind": kind,
        "params": dataclasses.asdict(tracker.params),
        "use_gt_pose": tracker.use_gt_pose,
        "landmark_opt_every": tracker.landmark_opt_every,
        "frame_count": tracker.frame_count,
        "cam": {eye: {"width": getattr(tracker.cam, eye).width,
                      "height": getattr(tracker.cam, eye).height}
                for eye in ("left", "right")},
    }

    is_slam = isinstance(tracker, SLAMSystem)
    if is_slam:
        kfs = tracker.slam_keyframes
        meta["slam"] = {
            "enable_loop_closure": tracker.enable_loop_closure,
            "enable_local_ba": tracker.enable_local_ba,
            "ba_window": tracker.ba_window,
            "ba_max_points": tracker.ba_max_points,
            "consensus_window": tracker.consensus_window,
            "stats": tracker.stats,
            "kf_index": [k.index for k in kfs],
            "kf_frame_idx": [k.frame_idx for k in kfs],
            "db_n": tracker.db.n,
            "db_capacity": tracker.db.capacity,
            "db_pool_size": tracker.db.pool_size,
            "db_native_index": tracker.db.index is not None,
            "async_closure": tracker._closure_pool is not None,
            # incremental-BA / landmark-identity state
            "last_opt_kf": tracker._last_opt_kf,
            "uid_parent": {str(k): v for k, v in tracker._uid_parent.items()},
            "excised_uids": sorted(tracker._excised_uids),
            # closure waiting-queue state (the r4 back-end cadence,
            # models/slam.py _maybe_trigger_backend): a checkpoint taken
            # with closures queued must resume with the pending
            # reconciliation trigger intact
            "last_closure_opt_kf": int(tracker._last_closure_opt_kf),
            "closure_kfs_in_queue": int(tracker._closure_kfs_in_queue),
            "closure_opt_lo": (None if tracker._closure_opt_lo is None
                               else int(tracker._closure_opt_lo)),
            "kf_since_local_ba": int(tracker._kf_since_local_ba),
        }
        if kfs:
            arrays["kf__T_wc"] = np.stack([k.T_wc for k in kfs])
            arrays["kf__obs_uids"], arrays["kf__obs_offs"] = _cat(
                [k.obs_uids for k in kfs], np.int64)
            flat_uv = [k.obs_uv4 for k in kfs]
            arrays["kf__obs_uv4"] = (np.concatenate(flat_uv, axis=0)
                                     if flat_uv else np.zeros((0, 4), np.float32))
            # spawn-time world positions (the overlapped back-end's BA
            # initializer); only when every keyframe carries them
            if all(len(k.obs_pos) == len(k.obs_uids) for k in kfs):
                arrays["kf__obs_pos"] = np.concatenate(
                    [k.obs_pos for k in kfs], axis=0)
            arrays["kf__pool_uids"], arrays["kf__pool_offs"] = _cat(
                [k.pool_uids for k in kfs], np.int64)
        for name, edges in (("cand", tracker.closure_candidates),
                            ("acc", tracker.accepted_closures)):
            if edges:
                arrays[f"cl__{name}__ij"] = np.asarray(
                    [(e.ref_kf, e.query_kf, int(e.accepted),
                      int(e.suppressed)) for e in edges],
                    np.int64)
                arrays[f"cl__{name}__T"] = np.stack([e.T_qr for e in edges])
                # matched landmark identities of the ICP inliers — restored
                # closures must keep their identity-merge raw material
                (arrays[f"cl__{name}__pairs"],
                 arrays[f"cl__{name}__pairs_offs"]) = _cat(
                    [np.asarray(e.uid_pairs, np.int64).reshape(-1, 2)
                     for e in edges], np.int64)
        # keyframe database pools (device arrays -> host)
        for f in ("desc", "p_cam", "valid", "count", "T_wc"):
            arrays[f"db__{f}"] = np.asarray(getattr(tracker.db, f))
        if tracker.db.prob is not None:
            arrays["db__prob"] = np.asarray(tracker.db.prob)
        if kind == "svi":
            meta["svi"] = {
                "equalize": tracker.equalize,
                "gravity_weight": tracker.gravity_weight,
                "calib_n_samples": tracker.calib.n_samples,
                "has_rectify_maps": tracker.rectify_maps is not None,
            }
            arrays["svi__velocity"] = np.asarray(tracker.velocity)
            arrays["svi__T_cam_imu"] = np.asarray(tracker.T_cam_imu)
            if tracker.gravity_obs:
                arrays["svi__gravity_obs"] = np.stack(tracker.gravity_obs)
            for f in ("R_imu_to_world", "bias_gyro", "bias_accel",
                      "noise_gyro", "noise_accel"):
                arrays[f"svi__calib__{f}"] = np.asarray(
                    getattr(tracker.calib, f))
            if tracker.rectify_maps is not None:
                for k, m in enumerate(tracker.rectify_maps):
                    arrays[f"svi__rmap__{k}"] = np.asarray(m)
    else:
        kfs = tracker.keyframes
        meta["kf_index"] = [k.index for k in kfs]
        meta["kf_frame_idx"] = [k.frame_idx for k in kfs]
        if kfs:
            arrays["kf__T_wc"] = np.stack([k.T_wc for k in kfs])
            arrays["kf__uids"], arrays["kf__offs"] = _cat(
                [k.landmark_uids for k in kfs], np.int64)
            arrays["kf__points_w"] = np.concatenate(
                [k.points_w for k in kfs], axis=0)
            arrays["kf__desc"] = np.concatenate(
                [k.descriptors for k in kfs], axis=0)

    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_checkpoint(path: str | Path):
    """Rebuild the tracker from a checkpoint file and return it, positioned
    exactly where :func:`save_checkpoint` left it (same FrameState, keyframe
    records, closure edges, database pools)."""
    from svi_mapper_tpu.config import TrackingParams
    from svi_mapper_tpu.geometry.camera import PinholeCamera, StereoCamera
    from svi_mapper_tpu.models.slam import ClosureEdge, SLAMKeyframe, SLAMSystem
    from svi_mapper_tpu.models.tracker import KeyframeRecord, StereoTracker

    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays.pop("__meta__")).decode())
    if meta["version"] > CHECKPOINT_VERSION:
        raise ValueError(
            f"checkpoint {path} has unsupported version {meta['version']}")

    params = TrackingParams(**meta["params"])
    eyes = {}
    for eye in ("left", "right"):
        eyes[eye] = PinholeCamera(
            **{f: jnp.asarray(arrays[f"cam__{eye}__{f}"]) for f in _CAM_FIELDS},
            width=meta["cam"][eye]["width"],
            height=meta["cam"][eye]["height"],
        )
    cam = StereoCamera(left=eyes["left"], right=eyes["right"])

    is_slam = meta["kind"] in ("slam", "svi")
    if is_slam:
        s = meta["slam"]
        slam_kwargs = dict(
            enable_loop_closure=s["enable_loop_closure"],
            enable_local_ba=s["enable_local_ba"],
            ba_window=s["ba_window"], ba_max_points=s["ba_max_points"],
            consensus_window=s["consensus_window"],
            max_keyframes=s["db_capacity"], pool_size=s["db_pool_size"],
            native_index=s["db_native_index"],
            async_closure=s.get("async_closure", False),
        )
        if meta["kind"] == "svi":
            from svi_mapper_tpu.imu.interpolator import ImuCalibration
            from svi_mapper_tpu.models.svi import StereoInertialTracker

            sv = meta["svi"]
            calib = ImuCalibration(
                **{f: arrays[f"svi__calib__{f}"]
                   for f in ("R_imu_to_world", "bias_gyro", "bias_accel",
                             "noise_gyro", "noise_accel")},
                n_samples=sv["calib_n_samples"],
            )
            rmaps = None
            if sv["has_rectify_maps"]:
                rmaps = tuple(arrays[f"svi__rmap__{k}"] for k in range(4))
            tracker = StereoInertialTracker(
                cam, calib, params, rectify_maps=rmaps,
                equalize=sv["equalize"],
                gravity_weight=sv["gravity_weight"],
                T_cam_imu=arrays.get("svi__T_cam_imu"), **slam_kwargs)
            tracker.velocity = arrays["svi__velocity"].astype(np.float32)
            if "svi__gravity_obs" in arrays:
                tracker.gravity_obs = list(arrays["svi__gravity_obs"])
        else:
            tracker = SLAMSystem(cam, params, use_gt_pose=meta["use_gt_pose"],
                                 **slam_kwargs)
        tracker.stats = s["stats"]
    else:
        tracker = StereoTracker(cam, params, use_gt_pose=meta["use_gt_pose"],
                                landmark_opt_every=meta["landmark_opt_every"])
    tracker.frame_count = meta["frame_count"]

    # device state
    table = tracker.state.table
    # fields absent from an older checkpoint keep their freshly-allocated
    # value (e.g. the descriptor-history ring added after round 2)
    table = table.replace(**{
        f.name: jnp.asarray(arrays[f"table__{f.name}"])
        for f in dataclasses.fields(table)
        if f"table__{f.name}" in arrays
    })
    if "table__desc_hist" not in arrays and "table__desc_left_ref" in arrays:
        # pre-ring checkpoint: the ring invariant is "slots hold genuine
        # past appearances, starting as copies of the creation descriptor"
        # (mapping.landmarks). A zero-filled allocation would make the
        # all-zero vector compete in the anchor argmin (dark uniform
        # patches would pass the gate) — broadcast the creation
        # descriptor into every slot instead.
        ring = jnp.broadcast_to(
            table.desc_left_ref[:, None, :], table.desc_hist.shape)
        table = table.replace(
            desc_hist=jnp.asarray(ring),
            hist_next=jnp.zeros_like(table.hist_next))
    tracker.state = tracker.state.replace(
        table=table,
        **{f: jnp.asarray(arrays[f"state__{f}"]) for f in _STATE_FIELDS},
    )
    if "trajectory" in arrays:
        tracker.trajectory = list(arrays["trajectory"])
    if "world_offset" in arrays:
        tracker.world_offset = np.asarray(arrays["world_offset"], np.float64)
        tracker.world_shifts = int(arrays.get("world_shifts", 0))

    if is_slam:
        s = meta["slam"]
        tracker._last_opt_kf = int(s.get("last_opt_kf", 0))
        tracker._uid_parent = {int(k): int(v)
                               for k, v in s.get("uid_parent", {}).items()}
        tracker._excised_uids = set(s.get("excised_uids", []))
        if s["kf_index"]:
            uids = _split(arrays["kf__obs_uids"], arrays["kf__obs_offs"])
            uv4 = _split(arrays["kf__obs_uv4"], arrays["kf__obs_offs"])
            pools = _split(arrays["kf__pool_uids"], arrays["kf__pool_offs"])
            pos = (_split(arrays["kf__obs_pos"], arrays["kf__obs_offs"])
                   if "kf__obs_pos" in arrays else None)
            tracker.slam_keyframes = [
                SLAMKeyframe(index=i, frame_idx=fi,
                             T_wc=arrays["kf__T_wc"][k],
                             obs_uids=uids[k], obs_uv4=uv4[k],
                             pool_uids=pools[k],
                             **({"obs_pos": pos[k]} if pos is not None else {}))
                for k, (i, fi) in enumerate(zip(s["kf_index"], s["kf_frame_idx"]))
            ]
        tracker._last_closure_opt_kf = int(s.get("last_closure_opt_kf", 0))
        tracker._closure_kfs_in_queue = int(s.get("closure_kfs_in_queue", 0))
        lo = s.get("closure_opt_lo")
        tracker._closure_opt_lo = None if lo is None else int(lo)
        tracker._kf_since_local_ba = int(s.get("kf_since_local_ba", 0))
        for name, dest in (("cand", "closure_candidates"),
                           ("acc", "accepted_closures")):
            key = f"cl__{name}__ij"
            if key in arrays:
                pairs = None
                if f"cl__{name}__pairs" in arrays:
                    pairs = _split(arrays[f"cl__{name}__pairs"],
                                   arrays[f"cl__{name}__pairs_offs"])
                edges = [
                    ClosureEdge(
                        ref_kf=int(row[0]), query_kf=int(row[1]),
                        T_qr=arrays[f"cl__{name}__T"][k],
                        accepted=bool(row[2]),
                        # v1 checkpoints carry 3 columns and no pairs
                        suppressed=bool(row[3]) if len(row) > 3 else False,
                        uid_pairs=(
                            np.asarray(pairs[k], np.int64).reshape(-1, 2)
                            if pairs is not None
                            else np.zeros((0, 2), np.int64)))
                    for k, row in enumerate(arrays[key])
                ]
                setattr(tracker, dest, edges)
        db = tracker.db
        db.n = s["db_n"]
        for f in ("desc", "p_cam", "valid", "count", "T_wc"):
            setattr(db, f, jnp.asarray(arrays[f"db__{f}"]))
        # checkpoints from before probabilistic pools lack db__prob:
        # drop the live prob store so matching degrades to exact-Hamming
        db.prob = (jnp.asarray(arrays["db__prob"])
                   if "db__prob" in arrays else None)
        db.count_host = [int(c) for c in arrays["db__count"][: db.n]]
        db.T_wc_host = np.asarray(arrays["db__T_wc"], np.float32).copy()
        db.capacity = int(arrays["db__desc"].shape[0])
        if db.index is not None:
            # rebuild the native shortlist index from the stored pools
            desc = arrays["db__desc"]
            valid = arrays["db__valid"]
            for k in range(db.n):
                db.index.add(desc[k][valid[k]], k)
    else:
        if meta["kf_index"]:
            uids = _split(arrays["kf__uids"], arrays["kf__offs"])
            pts = _split(arrays["kf__points_w"], arrays["kf__offs"])
            desc = _split(arrays["kf__desc"], arrays["kf__offs"])
            tracker.keyframes = [
                KeyframeRecord(index=i, frame_idx=fi,
                               T_wc=arrays["kf__T_wc"][k],
                               landmark_uids=uids[k], points_w=pts[k],
                               descriptors=desc[k])
                for k, (i, fi) in enumerate(zip(meta["kf_index"],
                                                meta["kf_frame_idx"]))
            ]
    return tracker
