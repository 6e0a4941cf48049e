"""Trajectory resampling/alignment math + fault injection + tool CLIs
(ref runnables interpolate_trajectory.cpp, compute_rotation_icp.cpp,
triangulation_sampling.cpp, create_cloud; fault hook CLandmark.cpp:648-710)."""

import pytest
import subprocess
import sys
from pathlib import Path

import numpy as np

from svi_mapper_tpu.eval import trajectory as ev
from svi_mapper_tpu.utils import faults

REPO_ROOT = Path(__file__).resolve().parents[1]

RNG = np.random.default_rng(3)


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def _traj(n, step=1.0, turn=0.05):
    """World->camera transforms along an arc."""
    T = []
    P = np.eye(4)
    for i in range(n):
        P = P @ np.block([[_rot_z(turn), np.array([[step], [0], [0]])],
                          [np.zeros((1, 3)), np.ones((1, 1))]])
        T.append(np.linalg.inv(P))
    return np.stack(T).astype(np.float64)


def test_interpolate_recovers_known_poses():
    T = _traj(10)
    t_src = np.arange(10, dtype=float)
    # resampling AT the source times must reproduce the poses
    out = ev.interpolate_trajectory(t_src, T, t_src)
    assert np.allclose(out, T, atol=1e-5)
    # midpoint translation is the chord midpoint
    out2 = ev.interpolate_trajectory(t_src, T, np.array([3.5]))
    P = np.linalg.inv(T)
    p_mid = 0.5 * (P[3, :3, 3] + P[4, :3, 3])
    assert np.allclose(np.linalg.inv(out2[0])[:3, 3], p_mid, atol=1e-5)


def test_interpolate_slerp_rotation_halfway():
    # two poses differing by a 90 deg z-rotation -> midpoint is 45 deg
    P0 = np.eye(4)
    P1 = np.eye(4); P1[:3, :3] = _rot_z(np.pi / 2)
    T = np.stack([np.linalg.inv(P0), np.linalg.inv(P1)])
    out = ev.interpolate_trajectory(np.array([0.0, 1.0]), T, np.array([0.5]))
    R_mid = np.linalg.inv(out[0])[:3, :3]
    assert np.allclose(R_mid, _rot_z(np.pi / 4), atol=1e-6)


def test_align_trajectory_removes_rigid_offset():
    T = _traj(20)
    # corrupt with a known rigid transform of the world
    G = np.eye(4); G[:3, :3] = _rot_z(0.7); G[:3, 3] = [5, -3, 2]
    T_est = np.einsum("nij,jk->nik", T, np.linalg.inv(G))
    assert ev.ate_rmse(T_est, T, align=False) > 1.0
    aligned, R, t = ev.align_trajectory(T_est, T)
    assert ev.ate_rmse(aligned, T, align=False) < 1e-6


def test_flip_descriptor_bits_exact_count():
    d = RNG.integers(0, 2 ** 32, size=(10, 8), dtype=np.uint64).astype(np.uint32)
    out = faults.flip_descriptor_bits(d, 6, RNG)
    x = d ^ out
    pop = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)
    assert (pop == 6).all()
    assert np.array_equal(faults.flip_descriptor_bits(d, 0, RNG), d)


def test_drop_measurements_fraction():
    mask = np.ones(100, bool)
    out = faults.drop_measurements(mask, 0.3, RNG)
    assert out.sum() == 70
    assert mask.all()  # input untouched


def test_perturb_pose_is_rigid():
    T = np.eye(4)
    out = faults.perturb_pose(T, 0.1, 0.05, RNG)
    R = out[:3, :3]
    assert np.allclose(R @ R.T, np.eye(3), atol=1e-5)
    assert abs(np.linalg.det(R) - 1) < 1e-5
    assert not np.allclose(out, T)


@pytest.mark.slow
def test_acceptance_cli_end_to_end(tmp_path):
    """The real-data acceptance harness (VERDICT r4 Next-8) runs a KITTI
    tree end-to-end and exits 0 when its gates pass / 1 when they fail."""
    import cv2

    rng = np.random.default_rng(3)
    seq_dir = tmp_path / "sequences" / "00"
    (seq_dir / "image_0").mkdir(parents=True)
    (seq_dir / "image_1").mkdir(parents=True)
    n = 6
    base = (rng.random((64, 160)) * 255).astype(np.uint8)
    for i in range(n):
        # shift the texture so there is real apparent motion to track
        img = np.roll(base, -3 * i, axis=1)
        cv2.imwrite(str(seq_dir / "image_0" / f"{i:06d}.png"), img)
        cv2.imwrite(str(seq_dir / "image_1" / f"{i:06d}.png"),
                    np.roll(img, 5, axis=1))
    (seq_dir / "times.txt").write_text(
        "\n".join(str(0.1 * i) for i in range(n)) + "\n")
    (seq_dir / "calib.txt").write_text(
        "P0: 100 0 80 0 0 100 32 0 0 0 1 0\n"
        "P1: 100 0 80 -54 0 100 32 0 0 0 1 0\n")
    poses = tmp_path / "poses"; poses.mkdir()
    lines = []
    for i in range(n):
        T = np.eye(4); T[2, 3] = 0.3 * i
        lines.append(" ".join(str(x) for x in T[:3].reshape(-1)))
    (poses / "00.txt").write_text("\n".join(lines) + "\n")

    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin:/usr/local/bin"}
    # permissive gates -> PASS (exit 0)
    r = subprocess.run(
        [sys.executable, "-m", "svi_mapper_tpu.tools.acceptance",
         str(tmp_path), "--cpu", "--min-closures", "0", "--min-fps", "0",
         "--max-ate", "1e9", "--max-rel", "1e9", "--chunk", "3",
         "--landmarks", "128"],
        capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ACCEPTANCE PASSED" in r.stdout
    # an unreachable gate -> FAIL (exit 1)
    r = subprocess.run(
        [sys.executable, "-m", "svi_mapper_tpu.tools.acceptance",
         str(tmp_path), "--cpu", "--min-closures", "99", "--min-fps", "0",
         "--max-ate", "1e9", "--max-rel", "1e9", "--chunk", "3",
         "--landmarks", "128"],
        capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "ACCEPTANCE FAILED" in r.stdout


def test_triangulation_sampling_cli_passes():
    r = subprocess.run(
        [sys.executable, "-m", "svi_mapper_tpu.tools.triangulation_sampling",
         "--cpu", "--samples", "200"],
        capture_output=True, text=True, timeout=300,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin:/usr/local/bin"},
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "invariants hold" in r.stdout


def test_vocabulary_cli_pipeline(tmp_path):
    """compute_descriptors -> create_vocabulary CLI chain
    (ref compute_descriptors_holidays.cpp, create_vocabulary_dbow2.cpp)."""
    from PIL import Image

    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(0)
    base = rng.random((96, 128)).astype(np.float32)
    # smooth so corners are sparse but present
    k = np.ones((5, 5)) / 25.0
    for _ in range(2):
        base = np.pad(base, 2, mode="edge")
        base = sum(
            base[i:i + 96 + 0, j:j + 128] * k[i, j]
            for i in range(5) for j in range(5)
        )
    base = (255 * (base - base.min()) / (base.max() - base.min())).astype(np.uint8)
    for i in range(2):
        Image.fromarray(np.roll(base, 5 * i, axis=1)).save(imgs / f"im{i}.png")

    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin:/usr/local/bin",
           "PYTHONPATH": "."}
    desc = tmp_path / "desc.npz"
    r = subprocess.run(
        [sys.executable, "-m", "svi_mapper_tpu.tools.compute_descriptors",
         str(imgs), "-o", str(desc), "--cpu", "--max-per-image", "64"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO_ROOT,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    z = np.load(desc)
    assert z["desc"].dtype == np.uint32 and len(z["desc"]) > 16

    vocab = tmp_path / "vocab.npz"
    r = subprocess.run(
        [sys.executable, "-m", "svi_mapper_tpu.tools.create_vocabulary",
         str(desc), "-o", str(vocab), "--cpu", "--k", "3", "--levels", "2",
         "--iters", "3"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO_ROOT,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    from svi_mapper_tpu.mapping.vocabulary import load_vocabulary, word_ids
    import jax.numpy as jnp

    v = load_vocabulary(vocab)
    w = np.asarray(word_ids(v, jnp.asarray(z["desc"][:32])))
    assert w.min() >= 0 and w.max() < v.num_words


def test_republish_stream_pairs_incoming_frames(tmp_path):
    """republish_stream pairs files as they arrive and writes a readable
    dump (ref republisher_node.cpp role)."""
    import threading
    import time as _time

    from PIL import Image

    from svi_mapper_tpu import native
    from svi_mapper_tpu.tools.republish_stream import republish

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")

    watch = tmp_path / "stream"
    (watch / "left").mkdir(parents=True)
    (watch / "right").mkdir(parents=True)
    rng = np.random.default_rng(0)
    frames = [
        (rng.integers(0, 255, (48, 64), dtype=np.uint8),
         rng.integers(0, 255, (48, 64), dtype=np.uint8))
        for _ in range(5)
    ]

    def feeder():
        import os

        for i, (L, R) in enumerate(frames):
            # atomic: write to a temp name, then rename (right first — the
            # pairing keys on both sides being present)
            for sub, img in (("right", R), ("left", L)):
                tmp = watch / sub / f".tmp_{i:04d}.png"
                Image.fromarray(img).save(tmp)
                os.replace(tmp, watch / sub / f"{i:04d}.500000.png")
            _time.sleep(0.05)

    t = threading.Thread(target=feeder)
    t.start()
    out = tmp_path / "stream.svid"
    # generous idle timeout: CI machines stall the feeder under load
    n = republish(watch, out, poll_s=0.02, idle_timeout_s=8.0,
                  log=lambda *a: None)
    t.join()
    assert n == 5

    r = native.DumpReader(out)
    assert r.n_frames == 5 and (r.height, r.width) == (48, 64)
    got = list(r)
    assert len(got) == 5
    fid, ts, L, R = got[2]
    assert fid == 2
    np.testing.assert_array_equal(L, frames[2][0])
    np.testing.assert_array_equal(R, frames[2][1])
