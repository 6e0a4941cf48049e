"""Device-mesh helpers: SPMD sharding of the SLAM state.

The reference is strictly single-process (SURVEY.md §2.9) — this layer is
new capability. The natural data parallelism of the pipeline is over
*landmark table rows* (tracking lattice matching, measurement updates,
per-landmark GN) and *map blocks* (BA, later rounds): the landmark axis
shards over a 1-D ``map`` mesh axis, images and poses replicate, and XLA
inserts the ``psum`` collectives for the pose solver's Hessian reduction
automatically from the sharding annotations (the scaling-book recipe: pick
a mesh, annotate shardings, let XLA place the collectives).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from svi_mapper_tpu.mapping.landmarks import LandmarkTable
from svi_mapper_tpu.models.frame import FrameState


def make_map_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the ``map`` axis (landmark/map-block sharding)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), ("map",))


def table_shardings(mesh: Mesh) -> LandmarkTable:
    """A LandmarkTable-shaped pytree of NamedShardings: every per-landmark
    array splits its leading (landmark) axis across ``map``."""
    row = NamedSharding(mesh, P("map"))
    return jax.tree_util.tree_map(lambda _: row, _table_structure())


def _table_structure():
    from svi_mapper_tpu.mapping.landmarks import make_table

    return make_table(1, 1)


def state_shardings(mesh: Mesh, state: FrameState) -> FrameState:
    """Shardings for a full FrameState: landmark arrays split over ``map``,
    scalars/poses replicated."""
    row = NamedSharding(mesh, P("map"))
    rep = NamedSharding(mesh, P())

    def pick(path, leaf):
        names = [getattr(p, "name", "") for p in path]
        if "table" in names:
            return row
        return rep

    return jax.tree_util.tree_map_with_path(pick, state)


def shard_state(state: FrameState, mesh: Mesh) -> FrameState:
    """Place a FrameState onto the mesh with map-axis landmark sharding."""
    shardings = state_shardings(mesh, state)
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, s), state, shardings
    )


def replicate(x, mesh: Mesh):
    """Fully replicate an array (images, poses, camera) over the mesh."""
    rep = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, rep), x)
