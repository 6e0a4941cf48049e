"""Benchmark: full stereo-SLAM throughput per chip on KITTI-sized frames.

Three measurements (BASELINE.md measurement row):

  * **full-SLAM frames/s** (headline): ``SLAMSystem.process_many`` on a
    synthetic loop sequence at KITTI 00 resolution (1241x376) — per-frame
    front-end (dense BRIEF x2, 3-stage tracking, stereo posit GN with the
    fallback cascade, landmark GN refinement, detection + triangulation +
    insertion) in ``lax.scan`` chunks PLUS the back-end folded at chunk
    boundaries: keyframe DB adds, loop-closure search + consensus,
    trajectory pose graph, windowed Schur BA — the complete pipeline of the
    reference's ``tracker_sv`` (CTrackerSV.cpp:239-456) including the
    inline back-end at :440.
  * **front-end frames/s**: the tracking-only chunked scan (the round-1
    number, kept for continuity).
  * **BA iterations/s**: Levenberg-Marquardt iterations of the batched
    Schur-complement bundle adjuster at the 8-keyframe x 1024-landmark
    window shape (solvers.ba.bundle_adjust).

Baselines: the reference publishes no numbers (BASELINE.md); the CPU
anchors below are this same code on the jax CPU backend of a development
machine (measured 2026-08 with ``python bench.py --cpu``). BASELINE.json's
throughput target is >= 3x the CPU baseline per chip.

Frames are pre-staged on device before the clock starts: only processing
is measured, not host->device staging of the input frames.

Without ``--cpu`` the run requires a GPU and fails when JAX finds none.

Prints exactly one JSON line: {"metric", "value", "unit", "vs_baseline",
...extra fields}.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

# CPU-backend anchors (jax CPU on a development machine, measured
# 2026-08-19 with `python bench.py --cpu` — same code, same scenario).
# Re-measured 2026-08-21 with the round-5 code: frontend 6.69, BA 19.8,
# full SLAM 5.31 — the r5 back-end (probabilistic matching, fused closure
# queries, depth tiers, dedup) costs MORE on CPU, so the anchors below
# keep the historical maxima: every vs_baseline ratio reported against
# them is conservative.
CPU_FULL_SLAM_FPS = 6.921
CPU_FRONTEND_FPS = 6.557
CPU_BA_ITERS_PER_SEC = 21.6     # 32-keyframe x 4096-landmark window


def bench_frontend(quick: bool) -> float:
    import jax
    import jax.numpy as jnp

    from svi_mapper_tpu.config import DEFAULT_PARAMS
    from svi_mapper_tpu.io.synthetic import SyntheticSequence
    from svi_mapper_tpu.models import frame as frame_mod

    n_frames = 4 if quick else 10
    reps = 1 if quick else 4
    seq = SyntheticSequence(n_frames=n_frames, width=1241, height=376, step=0.8)
    L = jnp.stack([jnp.asarray(f[0]) for f in seq])
    R = jnp.stack([jnp.asarray(f[1]) for f in seq])
    jax.block_until_ready((L, R))

    params = dataclasses.replace(DEFAULT_PARAMS, max_landmarks=1024,
                                 max_detections=1024)
    cam = seq.cam

    def run_chunk(state, l, r):
        return frame_mod.process_chunk(
            state, l, r, cam, params, use_gt_pose=False, landmark_opt_every=1
        )

    # compile + map warmup (fills the landmark table to steady state)
    state = frame_mod.init_state(params)
    state, out = run_chunk(state, L, R)
    jax.block_until_ready(out.T_wc)

    t0 = time.perf_counter()
    n = 0
    for _ in range(reps):
        state, out = run_chunk(state, L, R)
        n += n_frames
    out.T_wc.block_until_ready()
    dt = time.perf_counter() - t0
    return n / dt


def bench_full_slam(quick: bool) -> tuple[float, dict]:
    import jax
    import jax.numpy as jnp

    from svi_mapper_tpu.io import scenarios
    from svi_mapper_tpu.models.slam import SLAMSystem

    # the loop's revisit fires the closure + pose-graph + BA path during
    # the measurement; quick mode keeps the per-frame motion on a run too
    # short to revisit (fps only)
    n_frames = 48 if quick else 208
    seq = scenarios.loop_sequence(n_frames)
    L = jnp.stack([jnp.asarray(f[0]) for f in seq])
    R = jnp.stack([jnp.asarray(f[1]) for f in seq])
    jax.block_until_ready((L, R))
    params = scenarios.loop_params()

    def run(overlap: bool) -> SLAMSystem:
        # overlap=True: closure search, pose graph and BA run on a worker
        # thread over queued keyframe snapshots; overlap=False: the
        # reference's inline back-end (CTrackerSV.cpp:440) folded at chunk
        # boundaries. Both are measured: on a single chip the device work
        # of both threads serializes, so overlap only hides HOST time and
        # the winner is an empirical question. 'force' bypasses the
        # single-device auto-fallback: the A/B here deliberately measures
        # true overlap cost on one chip
        slam = SLAMSystem(seq.cam, params,
                          overlap_backend="force" if overlap else False)
        # chunk=32: the chunk-batched DB add lands all adds before any
        # query, so larger chunks are safe at any keyframe density and
        # halve the boundary sync count
        slam.process_many(L, R, chunk=32)
        slam.finalize_backend()
        return slam

    # HYGIENE: worker threads of a finished overlap run degrade every later
    # run in the same process, so every system is close()d right after
    # timing — and the sync measurement runs FIRST, from a sync warmup,
    # because overlap runs are additionally erratic on a single chip (two
    # threads contend for one dispatch path).
    run(False).close()           # compile warmup (all shape buckets)
    t0 = time.perf_counter()
    slam_s = run(False)
    fps_sync = n_frames / (time.perf_counter() - t0)
    slam_s.close()
    t0 = time.perf_counter()
    slam_o = run(True)
    fps_overlap = n_frames / (time.perf_counter() - t0)
    slam_o.close()
    slam = slam_o if fps_overlap >= fps_sync else slam_s
    return fps_sync, fps_overlap, dict(
        slam.stats, keyframes=len(slam.slam_keyframes))


def bench_svi(quick: bool) -> float:
    """Stereo-inertial throughput: process_many_imu (the SVI chunked scan)
    on the same loop at 10 IMU samples/frame (200 Hz : 20 fps)."""
    import jax
    import jax.numpy as jnp

    from svi_mapper_tpu.io import scenarios
    from svi_mapper_tpu.models.svi import StereoInertialTracker

    n_frames = 48 if quick else 208
    seq = scenarios.loop_sequence(n_frames)
    # pre-stage frames on device (same as bench_full_slam): re-shipping the
    # ~780 MB stack every run would measure host->device staging, not the
    # tracker (module docstring)
    L = jnp.stack([jnp.asarray(f[0]) for f in seq])
    R = jnp.stack([jnp.asarray(f[1]) for f in seq])
    jax.block_until_ready((L, R))
    calib0, dts, oms, acs = scenarios.loop_imu(seq, n_frames)
    params = scenarios.loop_params()

    def run() -> StereoInertialTracker:
        # synchronous back-end: the overlap worker measurably degrades the
        # tracker thread's dispatch on a single chip (see bench_full_slam)
        tr = StereoInertialTracker(seq.cam, calib0, params, equalize=False)
        tr.process_many_imu(L, R, dts, oms, acs, chunk=32)
        tr.finalize_backend()
        return tr

    run().close()
    t0 = time.perf_counter()
    tr = run()
    fps = n_frames / (time.perf_counter() - t0)
    tr.close()
    return fps


def bench_endurance(quick: bool) -> dict:
    """Reference-scale endurance: a 2,048-frame multi-revisit loop through
    the FULL SLAM system (the reference's operating point is a 4,541-frame
    KITTI 00 replay, tracker_gt.cpp:182-268, with a 4-32 GB map-scale RAM
    budget, readme.txt).

    Geometry: ~2.4 laps of a 108 m-radius circle at KITTI-like per-frame
    motion (0.8 m + 0.42 deg/frame) -> ~1,600 m of travel, ~320 keyframes,
    laps 2-3 revisiting lap 1 (a long multi-revisit closure regime), and
    repeated robocentric world shifts (threshold lowered to 150 m so the
    2R=216 m excursion crosses it; the default 512 m targets real KITTI
    scale). Frames render on-device per chunk — only PROCESSING time is
    measured (same pre-staging stance as bench_full_slam).

    Reports: fps over the first vs last quartile (stability), keyframe/
    closure/world-shift counts, the keyframe-tail time split, pose-graph
    wall at final graph size, peak host RSS + device memory, and DB size.
    """
    import resource

    import jax
    import jax.numpy as jnp
    import numpy as np

    from svi_mapper_tpu.config import DEFAULT_PARAMS
    from svi_mapper_tpu.eval import trajectory as ev
    from svi_mapper_tpu.io.synthetic import SyntheticSequence, loop_trajectory
    from svi_mapper_tpu.models.slam import SLAMSystem

    if quick:
        n_frames, frames_per_loop, radius = 256, 181, 26.0
    else:
        n_frames, frames_per_loop, radius = 2048, 849, 108.0
    # ring_world: the default corridor world ends at |x| = 60 m, so the
    # 216 m-diameter endurance circle would leave it and starve the
    # tracker (measured r5: collapse at the first-quartile boundary with
    # black frames) — the annular circuit world contains the loop
    from svi_mapper_tpu.io.synthetic import ring_world

    seq = SyntheticSequence(n_frames=n_frames, width=1241, height=376,
                            trajectory="loop", loop_radius=radius,
                            world=ring_world(radius))
    seq.poses_wc = loop_trajectory(n_frames, radius,
                                   frames_per_loop=frames_per_loop)

    params = dataclasses.replace(
        DEFAULT_PARAMS, max_landmarks=1024, max_detections=1024,
        # bench keyframe gates (2 m / 0.14 rad): ~650 keyframes over 2,048
        # frames — the reference-scale graph the short bench never reaches
        # (denser than the reference's 5 m gate, which also runs clean, to
        # maximize the graph-size stress this scenario exists to measure)
        keyframe_translation_m2=4.0, keyframe_rotation_rad2=0.02,
        max_motion_scaling_for_optimization=2.5,   # all-turn world (above)
        # multi-lap drift accumulates over an 849-frame / ~680 m lap with
        # NO closure opportunity until the second lap: measured raw-VO
        # drift on this geometry is ~3.8% of distance (15.5 m at frame
        # 512), so first-revisit drift is ~25 m. The reference's 5 m
        # radius gate (CTrackerSV.h:89) is calibrated to its closure-
        # corrected steady state; here the gate widens to 50 m so the
        # FIRST closure of a lap is reachable (after it, the pose graph
        # pulls drift back down). Precision still holds: the ring world
        # has no repeated texture, and BoW + match-floor + ICP gates
        # remain in force.
        closure_search_radius_m2=2500.0,
    )

    # presize the closure DB to the expected ~680 keyframes: the 512->1024
    # capacity growth otherwise recompiles every fused-query program
    # mid-measurement (the biggest closure-path executables)
    slam = SLAMSystem(seq.cam, params, max_keyframes=256 if quick else 1024)
    slam.world_shift_threshold_m = 150.0
    chunk = 64
    chunk_times: list[tuple[int, float]] = []
    warm = True
    for s0 in range(0, n_frames, chunk):
        e0 = min(s0 + chunk, n_frames)
        L = jnp.stack([jnp.asarray(seq.frame(i)[0]) for i in range(s0, e0)])
        R = jnp.stack([jnp.asarray(seq.frame(i)[1]) for i in range(s0, e0)])
        jax.block_until_ready((L, R))
        if warm:
            # compile warmup outside the measurement: a throwaway system
            # runs the first THREE chunks so the steady-state programs —
            # frame step, chunk-batched DB add + closure query at their
            # bucket widths, windowed BA, early pose graph — compile (and
            # land in the persistent cache) before the clock starts. The
            # few late growth buckets (K=64 BA, N>=512 pose graph) still
            # compile once each mid-run.
            w = SLAMSystem(seq.cam, params,
                           max_keyframes=256 if quick else 1024)
            w.world_shift_threshold_m = 150.0
            for w0 in range(0, min(3 * chunk, n_frames), chunk):
                w1 = min(w0 + chunk, n_frames)
                Lw = jnp.stack([jnp.asarray(seq.frame(i)[0])
                                for i in range(w0, w1)])
                Rw = jnp.stack([jnp.asarray(seq.frame(i)[1])
                                for i in range(w0, w1)])
                w.process_many(Lw, Rw, chunk=32)
            w.close()
            # pose-graph bucket pre-warm: the graph walks shape buckets
            # (N, E) as it grows and compiles a fresh [6N, 6N] program at
            # each, which would otherwise land inside the measurement.
            # Compile them here, at the exact production call signature,
            # outside the clock.
            from svi_mapper_tpu.solvers import pose_graph as pg_mod

            for N, E in ((64, 128), (128, 128), (128, 256), (256, 256),
                         (256, 512), (512, 512), (512, 1024), (1024, 1024),
                         (1024, 2048)):
                if quick and N > 256:
                    continue
                Tw = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (N, 4, 4))
                ew = pg_mod.PoseGraphEdges(
                    i=jnp.zeros(E, jnp.int32),
                    j=jnp.ones(E, jnp.int32),
                    T_ij=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32),
                                          (E, 4, 4)),
                    weight=jnp.ones(E, jnp.float32),
                    valid=jnp.zeros(E, bool),
                    info6=jnp.ones((E, 6), jnp.float32))
                fixw = jnp.zeros(N, bool).at[0].set(True)
                jax.block_until_ready(
                    pg_mod.optimize_pose_graph(Tw, ew, fixw, gravity=None))
            warm = False
        t0 = time.perf_counter()
        slam.process_many(L, R, chunk=32)
        chunk_times.append((e0 - s0, time.perf_counter() - t0))
    t0 = time.perf_counter()
    slam.finalize_backend()
    finalize_s = time.perf_counter() - t0

    frames_done = np.array([c[0] for c in chunk_times])
    times = np.array([c[1] for c in chunk_times])
    cum = np.cumsum(frames_done)
    q1_mask = cum <= n_frames // 4
    q4_mask = cum > 3 * n_frames // 4
    fps_q1 = frames_done[q1_mask].sum() / times[q1_mask].sum()
    fps_q4 = frames_done[q4_mask].sum() / times[q4_mask].sum()
    fps_all = n_frames / times.sum()

    try:
        traj = slam.optimized_trajectory()
        ate = (ev.evaluate(traj, seq.poses_wc).ate_rmse_m
               if np.isfinite(traj).all() else float("nan"))
    except Exception:
        ate = float("nan")
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    try:
        mem = jax.devices()[0].memory_stats() or {}
        dev_gb = mem.get("peak_bytes_in_use", mem.get("bytes_in_use", 0)) / 1e9
    except Exception:
        dev_gb = float("nan")
    tm = slam.timings
    n_kf = len(slam.slam_keyframes)
    out = {
        "endurance_frames": n_frames,
        "endurance_fps": round(fps_all, 2),
        "endurance_fps_q1": round(fps_q1, 2),
        "endurance_fps_q4": round(fps_q4, 2),
        "endurance_fps_sag_pct": round(100 * (1 - fps_q4 / fps_q1), 1),
        "endurance_keyframes": n_kf,
        "endurance_closures_accepted": slam.stats.get("closures_accepted", 0),
        "endurance_closures_deduped": slam.stats.get("closures_deduped", 0),
        "endurance_world_shifts": slam.world_shifts,
        "endurance_ba_runs": slam.stats.get("ba_runs", 0),
        "endurance_pose_graph_runs": slam.stats.get("pose_graph_runs", 0),
        "endurance_pose_graph_last_ms": round(
            1e3 * tm.get("pose_graph_last_s", 0.0), 1),
        "endurance_pose_graph_last_n": int(tm.get("pose_graph_last_n", 0)),
        "endurance_kf_tail_ms_per_kf": {
            k[3:]: round(1e3 * tm.get(k, 0.0) / max(n_kf, 1), 2)
            for k in ("kf_db_add", "kf_closure", "kf_backend", "kf_ba",
                      "kf_pose_graph", "kf_total")},
        "endurance_finalize_s": round(finalize_s, 2),
        "endurance_ate_m": (round(float(ate), 3)
                            if np.isfinite(ate) else None),
        "endurance_db_keyframes": slam.db.n,
        "endurance_db_capacity": slam.db.capacity,
        "endurance_peak_rss_gb": round(rss_gb, 2),
        "endurance_device_peak_gb": round(dev_gb, 2),
    }
    slam.close()
    return out


def bench_ba(quick: bool) -> float:
    import jax
    import jax.numpy as jnp

    from svi_mapper_tpu.io import scenarios
    from svi_mapper_tpu.solvers import ba as ba_mod

    # the production mapping window (solvers.ba docstring): 32 keyframes x
    # 4096 landmarks — Schur reduction [192, 12288] x [12288, 192]
    iters = 30
    reps = 1 if quick else 4
    cam, (T, X0, obs, mask, fix) = scenarios.ba_window(32, 4096)

    args = (jnp.asarray(T), jnp.asarray(X0), jnp.asarray(obs, jnp.float32),
            jnp.asarray(mask), cam, jnp.asarray(fix))
    # min_rel_improvement=0 disables the <1% early stop: every call runs
    # the full `iters` LM iterations
    res = ba_mod.bundle_adjust(*args, max_iterations=iters,
                               min_rel_improvement=0.0)
    jax.block_until_ready(res.T_wc)
    t0 = time.perf_counter()
    its = []
    for _ in range(reps):
        res = ba_mod.bundle_adjust(*args, max_iterations=iters,
                                   min_rel_improvement=0.0)
        its.append(res.iterations)     # defer sync: int() here would add a
    jax.block_until_ready(res.T_wc)    # host round trip per rep
    done = sum(int(x) for x in its)
    return done / (time.perf_counter() - t0)


def main() -> None:
    quick = "--quick" in sys.argv
    import jax

    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
    elif jax.default_backend() != "gpu":
        sys.exit(f"bench.py: no GPU found (backend {jax.default_backend()!r});"
                 " pass --cpu to measure the CPU backend")
    from svi_mapper_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if "--stages" in sys.argv:
        # per-stage device budget (the tracker_gt exit report analog,
        # tracker_gt.cpp:285-308) + hardware-utilization roofline —
        # human-readable mode
        from svi_mapper_tpu.eval.stage_bench import format_budget, stage_budget
        from svi_mapper_tpu.eval.utilization import (format_report,
                                                     utilization_report)

        print(format_budget(stage_budget()))
        print()
        print(format_report(utilization_report()))
        return

    if "--endurance" in sys.argv:
        # standalone endurance mode (also runs inside the default bench)
        print(json.dumps(bench_endurance(quick)))
        return

    # order: the overlap A/B inside bench_full_slam is the only stage that
    # spawns worker threads — run it LAST so its (erratic, two-thread)
    # dispatch state cannot contaminate the other measurements
    frontend_fps = bench_frontend(quick)
    ba_ips = bench_ba(quick)
    svi_fps = bench_svi(quick)
    # CPU backend: the 2,048-frame endurance renders the 33-plane ring
    # world on the host at KITTI resolution — an hour-scale run that
    # measures the renderer, not the tracker; the quick variant keeps
    # the endurance fields meaningful at CPU-feasible cost
    endurance = bench_endurance(quick or "--cpu" in sys.argv)
    slam_fps_sync, slam_fps_overlap, slam_stats = bench_full_slam(quick)
    slam_fps = max(slam_fps_sync, slam_fps_overlap)

    # hardware-utilization evidence: MFU / HBM fraction
    # / bound classification per hot stage from XLA's cost model + stream
    # timing — the absolute claim behind the CPU-relative ratios
    util = {}
    try:
        from svi_mapper_tpu.eval.utilization import utilization_report

        rep = utilization_report()
        util = {
            "device": rep["device_kind"],
            "stages": {
                name: {
                    "stream_ms": round(r["wall_stream_ms"], 2),
                    "sync_ms": round(r["wall_sync_ms"], 2),
                    "mfu_pct": round(100 * r.get("mfu", 0.0), 2),
                    "hbm_pct": round(100 * r.get("hbm_frac", 0.0), 2),
                    "bound": r["bound"],
                }
                for name, r in rep["stages"].items()
            },
        }
    except Exception as e:                       # pragma: no cover
        util = {"error": str(e)}

    print(
        json.dumps(
            {
                "metric": "synthetic_kitti_full_slam_frames_per_sec_per_chip",
                "value": round(slam_fps, 3),
                "unit": "frames/s",
                "vs_baseline": round(slam_fps / CPU_FULL_SLAM_FPS, 3),
                "full_slam_fps_sync": round(slam_fps_sync, 3),
                "full_slam_fps_overlap": round(slam_fps_overlap, 3),
                "frontend_frames_per_sec": round(frontend_fps, 3),
                "frontend_vs_baseline": round(frontend_fps / CPU_FRONTEND_FPS, 3),
                "ba_iterations_per_sec": round(ba_ips, 3),
                "ba_vs_baseline": round(ba_ips / CPU_BA_ITERS_PER_SEC, 3),
                "svi_frames_per_sec": round(svi_fps, 3),
                "closures_accepted": slam_stats.get("closures_accepted", 0),
                "closures_deduped": slam_stats.get("closures_deduped", 0),
                "ba_runs": slam_stats.get("ba_runs", 0),
                "keyframes": slam_stats.get("keyframes", 0),
                "utilization": util,
                **endurance,
            }
        )
    )


if __name__ == "__main__":
    main()
