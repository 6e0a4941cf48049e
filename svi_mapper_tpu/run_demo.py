"""Demo entry point: run the stereo SLAM slice on a synthetic sequence.

Usage:
  python -m svi_mapper_tpu.run_demo [--frames N] [--gt] [--cpu]
                                    [--width W] [--height H]

Prints per-frame tracking stats and the final trajectory metric block —
the equivalent of the reference's on-exit report (tracker_gt.cpp:285-308)
plus the evaluate_trajectory summary (evaluate_trajectory.cpp:270-284).
"""

from __future__ import annotations

import argparse
import dataclasses
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--step", type=float, default=0.5)
    ap.add_argument("--gt", action="store_true", help="ground-truth pose playback (tracker_gt mode)")
    ap.add_argument("--slam", action="store_true",
                    help="full SLAM (loop closure + windowed BA) instead of pure VO")
    ap.add_argument("--trajectory", choices=["corridor", "loop"], default="corridor")
    ap.add_argument("--loop-radius", type=float, default=12.0)
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument("--landmarks", type=int, default=1024)
    ap.add_argument("--save", type=str, default="", help="write KITTI trajectory here")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from svi_mapper_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from svi_mapper_tpu.config import DEFAULT_PARAMS
    from svi_mapper_tpu.eval import trajectory as ev
    from svi_mapper_tpu.io.synthetic import SyntheticSequence
    from svi_mapper_tpu.models.slam import SLAMSystem
    from svi_mapper_tpu.models.tracker import StereoTracker

    print(f"backend: {jax.default_backend()}  devices: {jax.devices()}")
    seq = SyntheticSequence(
        args.frames, args.width, args.height, step=args.step,
        trajectory=args.trajectory, loop_radius=args.loop_radius,
    )
    params = dataclasses.replace(
        DEFAULT_PARAMS, max_landmarks=args.landmarks, max_detections=args.landmarks
    )
    if args.slam:
        tracker = SLAMSystem(seq.cam, params, use_gt_pose=args.gt)
    else:
        tracker = StereoTracker(seq.cam, params, use_gt_pose=args.gt)

    t_start = time.perf_counter()
    for i, (L, R, T_gt) in enumerate(seq):
        out = tracker.process(L, R, T_gt=T_gt if args.gt else None)
        print(
            f"[{i:04d}] ok={int(bool(out.posit_ok))} tracked={int(out.n_tracked):4d} "
            f"active={int(out.n_active):4d} optimal={int(out.n_optimal):4d} "
            f"new={int(out.n_new):3d} inliers={int(out.inliers):4d} "
            f"err={float(out.avg_error_px2):6.3f}px^2 kf={int(bool(out.is_keyframe))}"
        )
    wall = time.perf_counter() - t_start

    m = ev.evaluate(tracker.trajectory_array, seq.poses_wc)
    if args.slam:
        m_opt = ev.evaluate(tracker.optimized_trajectory(), seq.poses_wc)
    fps = args.frames / wall
    print("-" * 70)
    print(f"frames: {args.frames}  wall: {wall:.2f}s  fps(incl. compile+render): {fps:.2f}")
    print(f"pure tracking fps: {tracker.fps():.2f}")
    print(f"keyframes: {len(tracker.keyframes)}")
    print(f"ATE RMSE:            {m.ate_rmse_m * 100:.2f} cm")
    print(f"rel translation err: {m.rel_trans_err_m * 100:.3f} cm/frame ({m.rel_trans_ratio * 100:.2f} %)")
    print(f"rel rotation err:    {m.rel_rot_err_rad:.5f} rad/frame")
    print(f"relative translation precision: {m.precision:.4f}")
    if args.slam:
        print(f"SLAM stats: {tracker.stats}")
        print(f"OPTIMIZED ATE RMSE:  {m_opt.ate_rmse_m * 100:.2f} cm "
              f"(raw VO {m.ate_rmse_m * 100:.2f} cm)")
    if args.save:
        ev.save_kitti_trajectory(args.save, tracker.trajectory_array)
        print(f"trajectory written to {args.save}")


if __name__ == "__main__":
    main()
