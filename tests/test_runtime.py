"""Host runtime pieces: pod-mesh helpers, typed errors, run loggers,
track-lost detection (SURVEY.md §2.6/§5 parity)."""

import dataclasses
import os
from pathlib import Path

import jax
import numpy as np
import pytest

from svi_mapper_tpu.utils import errors


def test_pod_mesh_and_local_slice():
    from svi_mapper_tpu.parallel.distributed import (
        host_local_slice,
        initialize,
        make_pod_mesh,
    )

    assert initialize() is False          # single process
    mesh = make_pod_mesh()                # 1 host x 8 virtual devices
    assert mesh.devices.shape == (1, len(jax.devices()))
    assert mesh.axis_names == ("host", "map")
    sl = host_local_slice(100, mesh)
    assert sl == slice(0, 100)
    with pytest.raises(ValueError, match="split"):
        make_pod_mesh(hosts=7)


def test_sharded_ba_matches_single_device():
    import jax.numpy as jnp

    from svi_mapper_tpu.io.synthetic import default_camera
    from svi_mapper_tpu.parallel.mesh import make_map_mesh
    from svi_mapper_tpu.parallel.sharded_ba import bundle_adjust_sharded

    cam = default_camera(width=320, height=240)
    rng = np.random.default_rng(0)
    K, L = 4, 64
    X = np.stack([rng.uniform(-5, 5, L), rng.uniform(-2, 2, L),
                  rng.uniform(4, 20, L)], -1).astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    T[:, 2, 3] = -0.3 * np.arange(K)
    obs = np.zeros((K, L, 4), np.float32)
    mask = np.zeros((K, L), bool)
    for k in range(K):
        p = X @ T[k, :3, :3].T + T[k, :3, 3]
        uvl, uvr = (np.asarray(u) for u in cam.project_stereo(jnp.asarray(p)))
        obs[k] = np.concatenate([uvl, uvr], -1)
        mask[k] = p[:, 2] > 1
    X0 = (X + rng.normal(0, 0.05, X.shape)).astype(np.float32)
    fix = np.zeros(K, bool); fix[0] = True

    res1 = bundle_adjust_sharded(make_map_mesh(1), jnp.asarray(T),
                                 jnp.asarray(X0), jnp.asarray(obs),
                                 jnp.asarray(mask), cam, jnp.asarray(fix))
    res8 = bundle_adjust_sharded(make_map_mesh(len(jax.devices())),
                                 jnp.asarray(T), jnp.asarray(X0),
                                 jnp.asarray(obs), jnp.asarray(mask), cam,
                                 jnp.asarray(fix))
    assert np.allclose(np.asarray(res1.points_w), np.asarray(res8.points_w),
                       atol=1e-4)
    assert abs(float(res1.chi2_final) - float(res8.chi2_final)) < 1e-2


def test_parameter_error_on_malformed_calibration(tmp_path):
    from svi_mapper_tpu.config import load_camera_calibration

    bad = tmp_path / "bad.txt"
    bad.write_text("uWidthPixels 640\n")     # missing everything else
    with pytest.raises(errors.ParameterError, match="missing"):
        load_camera_calibration(bad)
    with pytest.raises(errors.ParameterError):
        load_camera_calibration(tmp_path / "nonexistent.txt")
    # errors stay catchable as ValueError (stdlib-compatible hierarchy)
    with pytest.raises(ValueError):
        load_camera_calibration(bad)


def test_reference_calibrations_still_load():
    from svi_mapper_tpu.config import load_stereo_camera

    cam = load_stereo_camera(
        "kitti_00_camera_left.txt",
        "kitti_00_camera_right.txt",
    )
    assert abs(float(cam.baseline) - 0.537) < 0.01


def test_track_lost_detection():
    from svi_mapper_tpu.config import DEFAULT_PARAMS
    from svi_mapper_tpu.io.synthetic import SyntheticSequence
    from svi_mapper_tpu.models.tracker import StereoTracker

    params = dataclasses.replace(DEFAULT_PARAMS, max_landmarks=128,
                                 max_detections=128)
    seq = SyntheticSequence(n_frames=6, width=256, height=192, step=0.3)
    tr = StereoTracker(seq.cam, params, raise_on_track_lost=True)
    frames = list(seq)
    for (L, R, _) in frames[:3]:
        tr.process(np.asarray(L), np.asarray(R))
    assert int(tr.outputs[-1].n_active) >= 20
    # feed garbage: tracking collapses -> TrackLostError
    noise = np.random.default_rng(0).uniform(0, 255, frames[0][0].shape)
    with pytest.raises(errors.TrackLostError):
        for _ in range(3):
            tr.process(noise.astype(np.float32), noise.astype(np.float32))
    assert tr.track_lost_events


def test_run_logger_files(tmp_path):
    from svi_mapper_tpu.config import DEFAULT_PARAMS
    from svi_mapper_tpu.io.synthetic import SyntheticSequence
    from svi_mapper_tpu.models.tracker import StereoTracker
    from svi_mapper_tpu.utils import loggers

    params = dataclasses.replace(DEFAULT_PARAMS, max_landmarks=64,
                                 max_detections=64)
    seq = SyntheticSequence(n_frames=3, width=160, height=120)
    tr = StereoTracker(seq.cam, params)
    lg = loggers.attach(tr, tmp_path / "logs")
    for (L, R, _) in seq:
        tr.process(np.asarray(L), np.asarray(R))
    loggers.finalize(tr, lg)

    logs = {p.name for p in (tmp_path / "logs").iterdir()}
    assert {"odometry_optimization.txt", "trajectory.txt",
            "landmark_creation.txt", "epipolar_detection.txt",
            "landmarks_final.txt", "landmarks_final_optimized.txt",
            "trajectory_kitti.txt"} <= logs
    odo = (tmp_path / "logs" / "odometry_optimization.txt").read_text()
    assert len(odo.splitlines()) == 3
    # KITTI trajectory re-loads as 3 poses
    from svi_mapper_tpu.eval.trajectory import load_kitti_trajectory

    T = load_kitti_trajectory(tmp_path / "logs" / "trajectory_kitti.txt")
    assert T.shape == (3, 4, 4)


_CACHE_PROBE = """
import jax, jax.numpy as jnp
from svi_mapper_tpu.utils.compile_cache import enable_compile_cache
print(enable_compile_cache())
print(jax.config.jax_compilation_cache_dir)
jax.block_until_ready(jax.jit(lambda x: x * 2 + 1)(jnp.ones(3)))
"""


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins when set (and the cache lands there);
    otherwise the cache goes to the fixed in-checkout directory."""
    import subprocess
    import sys

    from svi_mapper_tpu.utils import compile_cache

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(Path(__file__).parents[1]))
    if env_set:
        env.update(JAX_COMPILATION_CACHE_DIR=str(tmp_path),
                   JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
                   JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0")
        probe = _CACHE_PROBE
    else:
        # placement only: do not write into the checkout from a test
        probe = _CACHE_PROBE.rsplit("jax.block_until_ready", 1)[0]
    r = subprocess.run([sys.executable, "-c", probe], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    returned, configured = r.stdout.split()[:2]
    if env_set:
        assert returned == configured == str(tmp_path)
        assert any(p.name.endswith("-cache") for p in tmp_path.iterdir())
    else:
        want = str(compile_cache.CHECKOUT_CACHE_DIR)
        assert returned == configured == want
        assert want.startswith(str(Path(__file__).parents[1]))
