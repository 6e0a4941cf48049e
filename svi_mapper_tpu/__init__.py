"""svi_mapper_tpu — a JAX stereo visual(-inertial) SLAM engine.

A from-scratch JAX/XLA re-design of the capabilities of the C++
reference ``schdomin/svi_mapper`` (see SURVEY.md): BRIEF-style stereo keypoint
detection, epipolar-constrained left/right matching, landmark triangulation
and refinement, robust stereo-reprojection pose solving ("stereo posit"),
keyframing, loop closure (global binary-descriptor matching + 3D-3D ICP +
consensus), and pose-graph / bundle-adjustment back-end — all as batched,
fixed-capacity, masked array programs that compile once under ``jit`` and
shard over a ``jax.sharding.Mesh``.

Layer map (mirrors SURVEY.md §7 build order):
  geometry/  SE(3), pinhole/stereo cameras, triangulation     (ref: src/vision)
  ops/       device kernels: Hamming, BRIEF, corners, image   (ref: cv calls)
  frontend/  detection + stereo matching + temporal tracking  (ref: src/core)
  solvers/   posit GN, landmark GN, BA, pose graph, ICP       (ref: src/optimization)
  mapping/   landmark table, keyframes, loop closure          (ref: src/types)
  imu/       IMU calibration/integration                      (ref: CIMUInterpolator)
  models/    the tracker families GT / SV / SVI               (ref: CTracker*)
  parallel/  mesh + sharded tracking/BA                       (new; no ref analog)
  io/        datasets (KITTI, synthetic), cloud serialization (ref: src/runnable)
  eval/      trajectory metrics, timing reports               (ref: evaluate_trajectory)
"""

__version__ = "0.1.0"
