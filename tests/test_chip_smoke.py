"""chip_smoke.py's phase functions at small sizes, on the CPU.

The script itself runs only on a GPU (phase a refuses anything else); these
tests call its phases directly with small shapes so that their plumbing,
comparisons and checks run in the CPU suite. Phase (b)'s "GPU vs CPU"
comparison becomes CPU vs CPU here, which must agree exactly.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_device_check_refuses_cpu(smoke):
    with pytest.raises(SystemExit, match="no GPU"):
        smoke.phase_device_check()


def test_script_without_gpu_exits_nonzero_and_prints_no_result():
    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"}
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_parity_phase_small(smoke):
    cpu = jax.devices("cpu")[0]
    out = smoke.phase_parity(cpu, cpu, width=256, height=192,
                             n_landmarks=128, ba_k=4, ba_l=256,
                             ba_iterations=3, pool=64)
    # the same device on both sides: every comparison is exact
    assert out["brief_bit_flip_share"] == 0.0
    assert out["frame_tracked"] == out["frame_tracked_ref"] > 0
    assert out["frame_translation_diff_m"] == 0.0
    assert out["ba_chi2"] == out["ba_chi2_ref"] < out["ba_chi2_initial"]
    assert out["window_accepted"] > 0 and out["stereo_matched"] > 0
    assert out["expected_hamming_max_err"] < 1e-4


def test_full_slam_phase_small(smoke):
    out = smoke.phase_full_slam(width=256, height=192, n_frames=8,
                                n_landmarks=128, chunk=4,
                                expect_backend=False, timed_rerun=False)
    assert out["frames"] == 8
    assert np.isfinite(out["ate_m"])


def test_svi_phase_small(smoke):
    out = smoke.phase_svi(width=512, height=256, n_frames=8,
                          n_landmarks=256, chunk=4)
    assert out["frames"] == 8 and out["longest_bridge"] == 0


def test_multi_phase_small(smoke):
    # the conftest platform has 8 virtual CPU devices; use four, as the
    # script does on four GPUs
    out = smoke.phase_multi(4, width=256, height=192, n_landmarks=128,
                            ba_k=4, ba_l=256, ba_iterations=3)
    assert out["table_shard_rows"] == 32 and out["ba_point_shards"] == 4
    assert out["frame_tracked"] > 0
