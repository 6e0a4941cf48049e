"""True multi-process jax.distributed exercise (VERDICT r2 Next-3).

Spawns two OS processes with a local coordinator, a 4-virtual-CPU-device
backend each, and runs the landmark-sharded Schur BA over a mesh spanning
both — the reduction's psum crosses the process boundary, catching
init-order and cross-host (``host``-axis) bugs the single-process 8-device
virtual mesh cannot. The reference has nothing to mirror here (it is
single-process by construction, SURVEY.md §2.9); BASELINE.json config 5
requires the multi-host path.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

WORKER = Path(__file__).with_name("distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_sharded_ba_parity():
    coordinator = f"127.0.0.1:{_free_port()}"
    # the workers pick their own device count and platform
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), coordinator, "2", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(WORKER.parent.parent))
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
    # both processes converged to the SAME replicated chi2
    chi2 = [line.split()[1] for out in outs
            for line in out.splitlines() if line.startswith("OK ")]
    assert len(chi2) == 2, outs
    assert chi2[0] == chi2[1], chi2
