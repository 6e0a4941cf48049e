"""Per-bit descriptor statistics and probabilistic descriptor matching.

JAX replacement for the reference's probabilistic-descriptor family:
``CLandmark`` accumulates per-bit probability and permanence vectors over a
landmark's descriptor history (CLandmark.cpp:96-124,260-261 into
``CBitStatistics``, Types.h:83), and the CBPTree/CBPNode/CBPITree trees
match binary queries against those mean-bit vectors (``CPDescriptorBRIEF``
Eigen ``Matrix<double,256,1>``, CPDescriptorBRIEF.h:10-33) with the
probability-Hamming cutoff ``MAXIMUM_DISTANCE_HAMMING_PROBABILITY = 50``
(CKeyFrame.h:13).

The tree becomes a matmul: the expected Hamming distance between a binary
query ``q`` and a mean-bit vector ``p`` is

    E[d(q, x)] = sum_b  q_b (1 - p_b) + (1 - q_b) p_b
               = sum_b p_b  +  q . (1 - 2 p)

so a whole query set against a whole landmark pool is one ``[Q,256] x
[256,N]`` contraction plus a rank-1 bias — exact, batched, and faster than
any bit-guided tree descent on an accelerator (SURVEY.md §7 design
stance).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from svi_mapper_tpu.ops.descriptors import DESCRIPTOR_BITS, unpack_bits
from svi_mapper_tpu.utils import struct

# Probability-Hamming matching cutoff (ref CKeyFrame.h:13).
MAX_DISTANCE_HAMMING_PROBABILITY = 50.0


@struct.dataclass
class BitStats:
    """Per-item descriptor bit statistics (ref CBitStatistics, Types.h:83).

    ``prob`` is the running mean of each bit over the observation history;
    ``permanence`` is the fraction of observations in which each bit kept
    the value it had at the previous observation (the reference's
    bit-stability measure, CLandmark.cpp:260-261).
    """

    bit_sum: jax.Array     # [..., 256] f32 — sum of observed bits
    stable_sum: jax.Array  # [..., 256] f32 — count of bit == previous bit
    count: jax.Array       # [...] f32 — observations folded in

    @property
    def prob(self) -> jax.Array:
        return self.bit_sum / jnp.maximum(self.count[..., None], 1.0)

    @property
    def permanence(self) -> jax.Array:
        # first observation has no predecessor -> count-1 transitions
        return self.stable_sum / jnp.maximum(self.count[..., None] - 1.0, 1.0)


def init_bit_stats(desc: jax.Array) -> BitStats:
    """Start statistics from the creation descriptor ``[..., 8] uint32``."""
    bits = unpack_bits(desc).astype(jnp.float32)
    return BitStats(
        bit_sum=bits,
        stable_sum=jnp.zeros_like(bits),
        count=jnp.ones(desc.shape[:-1], jnp.float32),
    )


def update_bit_stats(
    stats: BitStats,
    desc_new: jax.Array,   # [..., 8] uint32 — newly observed descriptor
    desc_prev: jax.Array,  # [..., 8] uint32 — previous observation
    mask: jax.Array,       # [...] bool — which rows observed this frame
) -> BitStats:
    """Fold one observation per masked row into the statistics (the batched
    per-measurement update of CLandmark::addMeasurement, CLandmark.cpp:96-124)."""
    bits_new = unpack_bits(desc_new).astype(jnp.float32)
    bits_prev = unpack_bits(desc_prev).astype(jnp.float32)
    agree = 1.0 - jnp.abs(bits_new - bits_prev)
    m = mask[..., None]
    return BitStats(
        bit_sum=jnp.where(m, stats.bit_sum + bits_new, stats.bit_sum),
        stable_sum=jnp.where(m, stats.stable_sum + agree, stats.stable_sum),
        count=jnp.where(mask, stats.count + 1.0, stats.count),
    )


def reset_rows(stats: BitStats, desc: jax.Array, rows_mask: jax.Array) -> BitStats:
    """Re-initialize masked rows from a fresh creation descriptor (used when
    a landmark slot is recycled by insert_landmarks)."""
    fresh = init_bit_stats(desc)
    m = rows_mask[..., None]
    return BitStats(
        bit_sum=jnp.where(m, fresh.bit_sum, stats.bit_sum),
        stable_sum=jnp.where(m, fresh.stable_sum, stats.stable_sum),
        count=jnp.where(rows_mask, fresh.count, stats.count),
    )


def expected_hamming(query: jax.Array, mean_bits: jax.Array) -> jax.Array:
    """Expected Hamming distance of binary queries against mean-bit vectors.

    ``query``: [Q, 8] uint32 packed descriptors; ``mean_bits``: [N, 256]
    float bit probabilities. Returns [Q, N] float32. One contraction — the
    batched replacement for the CBPTree leaf scan (CBPNode.h:64-201). It
    runs at HIGHEST precision: a reduced-precision (TF32) product of
    fractional probabilities would move a 256-bit sum by up to a tenth of a
    unit, enough to flip a comparison against the cutoff."""
    q = unpack_bits(query).astype(jnp.float32)           # [Q, 256]
    bias = jnp.sum(mean_bits, axis=-1)                   # [N]
    corr = jax.lax.dot_general(
        q, 1.0 - 2.0 * mean_bits,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )                                                    # [Q, N]
    return bias[None, :] + corr


def match_probabilistic(
    query: jax.Array,        # [Q, 8] uint32
    mean_bits: jax.Array,    # [N, 256] f32
    valid: jax.Array,        # [N] bool
    cutoff: float = MAX_DISTANCE_HAMMING_PROBABILITY,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """One-to-one nearest match under the probability-Hamming cutoff.

    Returns ``(idx, dist, ok)`` per query. One-to-one enforcement mirrors
    the matched-train-ID set of CBPTree::match (CBPTree.h:41-50): a train
    item is awarded to its best-scoring query only.
    """
    d = expected_hamming(query, mean_bits)               # [Q, N]
    big = jnp.float32(1e9)
    d = jnp.where(valid[None, :], d, big)
    idx = jnp.argmin(d, axis=1)                          # [Q]
    dist = jnp.take_along_axis(d, idx[:, None], axis=1)[:, 0]
    ok = dist <= cutoff
    # one-to-one: for each train index keep only the best query
    Q = query.shape[0]
    order = jnp.argsort(dist)                            # best queries first
    idx_sorted = idx[order]
    first = jnp.zeros((mean_bits.shape[0] + 1,), jnp.int32).at[
        jnp.where(ok[order], idx_sorted, mean_bits.shape[0])
    ].max(Q - jnp.arange(Q, dtype=jnp.int32), mode="drop")
    # first[t] holds (Q - rank) of the best query claiming train t
    rank_of_query = jnp.zeros((Q,), jnp.int32).at[order].set(
        Q - jnp.arange(Q, dtype=jnp.int32))
    keep = first[idx] == rank_of_query
    return idx, dist, ok & keep
