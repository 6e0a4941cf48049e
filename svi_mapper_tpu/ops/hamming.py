"""Hamming-distance kernels for 256-bit binary descriptors.

The reference spends its matching time in pointer-chasing descriptor search
trees (``CBTree``/``CBNode``: bit-split descent + leaf linear scan with
``std::bitset<256>`` XOR-popcount, CBNode.h:622-627, CBTree.h:198-236) and
OpenCV brute-force Hamming matchers (CTriangulator.cpp:12). On an
accelerator the tree's irregular traversal is unnecessary: all-pairs
Hamming distance is a dense op, is *exact* (the tree is approximate), and
for the reference's pool sizes (<= a few thousand descriptors per keyframe)
is faster than any traversal.

Two implementations, one contract:
  * :func:`hamming_packed`   — XOR + popcount on packed uint32 words;
                               the portable reference path.
  * :func:`hamming_mxu`      — bit-matmul identity
                               ``d(i,j) = |a_i| + |b_j| - 2 a_i . b_j``
                               on unpacked {0,1} matrices; one [N,256]x[256,M]
                               matmul.

Plus the batched matcher ops built on them (nearest/mutual-nearest with
Hamming cutoffs) replacing CBTree::match and the one-to-one enforcement of
CBPTree.h:41-50 / the per-landmark vote dedup _getMatchNN
(CTrackerGT.cpp:648-678).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from svi_mapper_tpu.ops.descriptors import unpack_bits


# ---------------------------------------------------------------------------
# distance matrices
# ---------------------------------------------------------------------------

@jax.jit
def hamming_packed(a: jax.Array, b: jax.Array) -> jax.Array:
    """All-pairs Hamming distance on packed descriptors.

    Args: a [N, 8] uint32, b [M, 8] uint32. Returns [N, M] int32.
    """
    x = a[:, None, :] ^ b[None, :, :]
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


@jax.jit
def hamming_mxu(a: jax.Array, b: jax.Array) -> jax.Array:
    """All-pairs Hamming via the bit-matmul identity (one matmul).

    ``d = |a| + |b| - 2 a.b`` with a, b unpacked to {0,1} float32: products
    and 256-length accumulations are integers <= 256, exact in float32 and
    under any reduced-precision input mode (bf16, TF32) with float32
    accumulation, so no precision argument is needed.
    """
    a_bits = unpack_bits(a).astype(jnp.float32)           # [N, 256]
    b_bits = unpack_bits(b).astype(jnp.float32)           # [M, 256]
    na = jnp.sum(a_bits, axis=-1)
    nb = jnp.sum(b_bits, axis=-1)
    dot = jax.lax.dot_general(
        a_bits, b_bits,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return (na[:, None] + nb[None, :] - 2.0 * dot).astype(jnp.int32)


# ---------------------------------------------------------------------------
# matchers
# ---------------------------------------------------------------------------

_BIG = jnp.int32(1 << 20)


@functools.partial(jax.jit, static_argnames=("cutoff",))
def match_nearest(
    query: jax.Array,
    ref: jax.Array,
    cutoff: int,
    query_valid: jax.Array | None = None,
    ref_valid: jax.Array | None = None,
):
    """Nearest-neighbour Hamming matching with a distance cutoff.

    The batched equivalent of ``CBTree::match`` (CBTree.h:198-236): for each
    query descriptor return the best reference index, its distance, and an
    acceptance mask (distance <= cutoff, both sides valid).

    Returns: (idx [N] int32, dist [N] int32, ok [N] bool).
    """
    d = hamming_packed(query, ref)
    if ref_valid is not None:
        d = jnp.where(ref_valid[None, :], d, _BIG)
    idx = jnp.argmin(d, axis=1).astype(jnp.int32)
    dist = jnp.take_along_axis(d, idx[:, None], axis=1)[:, 0]
    ok = dist <= cutoff
    if query_valid is not None:
        ok = ok & query_valid
    return idx, dist, ok


@functools.partial(jax.jit, static_argnames=("cutoff",))
def match_mutual(
    query: jax.Array,
    ref: jax.Array,
    cutoff: int,
    query_valid: jax.Array | None = None,
    ref_valid: jax.Array | None = None,
):
    """Mutual-nearest (one-to-one) Hamming matching.

    Batched replacement for the reference's one-to-one enforcement: the
    matched-train-ID set of CBPTree.h:41-50 and the per-landmark vote dedup
    ``_getMatchNN`` (CTrackerGT.cpp:648-678). A pair (i, j) survives iff j is
    i's nearest reference AND i is j's nearest query AND d <= cutoff.

    Returns: (idx [N] int32, dist [N] int32, ok [N] bool).
    """
    d = hamming_packed(query, ref)
    if ref_valid is not None:
        d = jnp.where(ref_valid[None, :], d, _BIG)
    if query_valid is not None:
        d = jnp.where(query_valid[:, None], d, _BIG)
    fwd = jnp.argmin(d, axis=1).astype(jnp.int32)          # best ref per query
    bwd = jnp.argmin(d, axis=0).astype(jnp.int32)          # best query per ref
    dist = jnp.take_along_axis(d, fwd[:, None], axis=1)[:, 0]
    mutual = bwd[fwd] == jnp.arange(d.shape[0], dtype=jnp.int32)
    ok = mutual & (dist <= cutoff)
    if query_valid is not None:
        ok = ok & query_valid
    return fwd, dist, ok


@functools.partial(jax.jit, static_argnames=("cutoff",))
def count_matches(
    query: jax.Array,
    ref: jax.Array,
    cutoff: int,
    query_valid: jax.Array | None = None,
    ref_valid: jax.Array | None = None,
) -> jax.Array:
    """Number of queries whose nearest reference is within the cutoff —
    the place-recognition score (``getNumberOfMatches``, CBTree.h)."""
    _, _, ok = match_nearest(query, ref, cutoff, query_valid, ref_valid)
    return jnp.sum(ok)
