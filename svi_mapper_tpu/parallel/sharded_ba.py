"""Distributed bundle adjustment: landmark-sharded Schur reduction.

BASELINE.json configs 4-5: "large-map distributed BA: keyframe/map-block
partitioned Schur reduction on a multi-chip mesh". The reference has no
distributed anything (SURVEY.md §2.9); this layer is new capability.

Design (the scaling-book recipe — annotate shardings, let XLA place the
collectives): the observation tensor ``[K, L, 4]``, landmark states
``[L, 3]`` and all per-landmark Hessian blocks shard their landmark axis
over the 1-D ``map`` mesh axis. Poses and the reduced [6K, 6K] camera
system replicate. The Schur reduction ``S = H_pp - sum_l W_l H_ll^-1 W_l^T``
contracts over the sharded axis, so XLA partitions it into per-device
partial sums + one ``psum`` (NCCL on GPUs) — exactly the hand-written MPI
reduction of distributed BA systems, derived automatically from sharding
annotations. The dense [6K, 6K] solve then runs replicated (it is tiny).

The solver body is the SAME ``solvers.ba.bundle_adjust`` — this module only
places the data and constrains the outputs, which is the whole point: one
code path, any mesh size.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from svi_mapper_tpu.geometry.camera import StereoCamera
from svi_mapper_tpu.solvers import ba as ba_mod


def shard_ba_inputs(
    mesh: Mesh,
    T_wc: jax.Array,
    points_w: jax.Array,
    obs_uv: jax.Array,
    obs_mask: jax.Array,
    fix_mask: jax.Array,
):
    """Place BA inputs on the mesh: landmark axis over ``map``, rest replicated."""
    rep = NamedSharding(mesh, P())
    lnd = NamedSharding(mesh, P("map"))
    k_lnd = NamedSharding(mesh, P(None, "map"))
    return (
        jax.device_put(T_wc, rep),
        jax.device_put(points_w, lnd),
        jax.device_put(obs_uv, k_lnd),
        jax.device_put(obs_mask, k_lnd),
        jax.device_put(fix_mask, rep),
    )


def bundle_adjust_sharded(
    mesh: Mesh,
    T_wc: jax.Array,
    points_w: jax.Array,
    obs_uv: jax.Array,
    obs_mask: jax.Array,
    cam: StereoCamera,
    fix_mask: jax.Array,
    **kwargs,
) -> ba_mod.BAResult:
    """Run Schur-complement BA with the landmark axis sharded over ``mesh``.

    Pads the landmark axis up to a multiple of the mesh size, places the
    data, and jits the stock solver with sharded in/out specs. Results are
    numerically equivalent to the single-device solve (same reduction, one
    extra psum).
    """
    n_dev = mesh.devices.size
    L = points_w.shape[0]
    pad = (-L) % n_dev
    if pad:
        points_w = jnp.pad(points_w, ((0, pad), (0, 0)))
        obs_uv = jnp.pad(obs_uv, ((0, 0), (0, pad), (0, 0)))
        obs_mask = jnp.pad(obs_mask, ((0, 0), (0, pad)))

    args = shard_ba_inputs(mesh, T_wc, points_w, obs_uv, obs_mask, fix_mask)
    rep = NamedSharding(mesh, P())
    lnd = NamedSharding(mesh, P("map"))
    out_shardings = ba_mod.BAResult(
        T_wc=rep, points_w=lnd,
        chi2_initial=rep, chi2_final=rep, iterations=rep,
    )

    fn = jax.jit(
        lambda T, X, o, m, f: ba_mod.bundle_adjust(T, X, o, m, cam, f, **kwargs),
        out_shardings=out_shardings,
    )
    with mesh:
        res = fn(*args)
    if pad:
        res = res.replace(points_w=res.points_w[:L])
    return res
