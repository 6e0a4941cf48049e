"""Multi-host runtime: jax.distributed bring-up + (host, map) meshes.

The reference has no distributed backend at all (single process, SURVEY.md
§2.9); BASELINE.json config 5 requires a multi-host path with >= 70 %
frames/s scaling efficiency at N >= 2 hosts. This module is the thin,
testable bring-up layer:

* :func:`initialize` — `jax.distributed.initialize` wrapper that no-ops in
  single-process runs (so the same entry point works on a laptop, one GPU
  host, or a cluster launched with the standard coordinator env vars).
* :func:`make_pod_mesh` — a ``(host, map)`` mesh: the landmark/map-block
  axis shards within a host over the intra-host links (NVLink), keyframe
  blocks shard across hosts over the network. For single-host runs the
  ``host`` axis has size 1 and every collective stays inside the host.
* :func:`host_local_slice` — which rows of a globally-sharded landmark axis
  live on this process (for host-side IO like checkpoint writes).

The heavy lifting (sharded Schur BA) is in :mod:`parallel.sharded_ba`; it
works unchanged on a multi-host mesh because only the sharding annotations
change.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh

_initialized = False


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Bring up jax.distributed across hosts; returns True if multi-process.

    With no arguments, reads the standard environment
    (COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID)
    and silently stays single-process when nothing is configured.
    """
    global _initialized
    if _initialized:
        return jax.process_count() > 1
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        # single-process run
        _initialized = True
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True
    return jax.process_count() > 1


def make_pod_mesh(
    hosts: int | None = None,
    axis_names: tuple[str, str] = ("host", "map"),
) -> Mesh:
    """2-D ``(host, map)`` mesh over all addressable devices.

    ``hosts`` defaults to ``jax.process_count()``; devices are arranged so
    each row of the mesh is one host's local chips — collectives over
    ``map`` stay inside a host (NVLink), collectives over ``host`` cross the
    network (the scaling-book layout rule: put the fast-changing axis on
    the fast interconnect).
    """
    devs = jax.devices()
    n_hosts = hosts or max(jax.process_count(), 1)
    if len(devs) % n_hosts:
        raise ValueError(
            f"{len(devs)} devices do not split over {n_hosts} hosts")
    grid = np.asarray(devs).reshape(n_hosts, len(devs) // n_hosts)
    return Mesh(grid, axis_names)


def host_local_slice(global_rows: int, mesh: Mesh) -> slice:
    """Rows of a ``map``-sharded axis owned by this process (host-side IO)."""
    n_hosts = mesh.devices.shape[0]
    per = -(-global_rows // n_hosts)
    pid = jax.process_index()
    return slice(pid * per, min((pid + 1) * per, global_rows))
