"""Per-bit descriptor statistics + probabilistic matching
(ref CBitStatistics Types.h:83, CLandmark.cpp:96-124, CBPTree family,
probability cutoff MAXIMUM_DISTANCE_HAMMING_PROBABILITY CKeyFrame.h:13)."""

import jax.numpy as jnp
import numpy as np

from svi_mapper_tpu.mapping import bitstats as bs
from svi_mapper_tpu.mapping import landmarks as lm
from svi_mapper_tpu.ops.descriptors import pack_bits

RNG = np.random.default_rng(7)


def _rand_desc(n):
    bits = RNG.integers(0, 2, size=(n, 256)).astype(bool)
    return np.asarray(pack_bits(jnp.asarray(bits))), bits


def test_bit_stats_accumulation_matches_numpy():
    n = 5
    d0, b0 = _rand_desc(n)
    stats = bs.init_bit_stats(jnp.asarray(d0))
    assert np.allclose(np.asarray(stats.prob), b0)

    history = [b0]
    prev = d0
    for _ in range(4):
        d, b = _rand_desc(n)
        mask = RNG.integers(0, 2, size=n).astype(bool)
        stats = bs.update_bit_stats(stats, jnp.asarray(d), jnp.asarray(prev),
                                    jnp.asarray(mask))
        # numpy oracle per masked row
        hb = []
        for i in range(n):
            hb.append(b[i] if mask[i] else None)
        history.append(hb)
        prev = np.where(mask[:, None], d, prev)

    # recompute probability from the observation history
    for i in range(n):
        obs = [history[0][i]]
        for step in history[1:]:
            if step[i] is not None:
                obs.append(step[i])
        p = np.mean(obs, axis=0)
        assert np.allclose(np.asarray(stats.prob)[i], p, atol=1e-6)
        assert float(np.asarray(stats.count)[i]) == len(obs)


def test_permanence_counts_bit_stability():
    d0, b0 = _rand_desc(1)
    stats = bs.init_bit_stats(jnp.asarray(d0))
    # observe the SAME descriptor twice -> permanence 1 everywhere
    stats = bs.update_bit_stats(stats, jnp.asarray(d0), jnp.asarray(d0),
                                jnp.ones(1, bool))
    assert np.allclose(np.asarray(stats.permanence), 1.0)
    # observe the complement -> half the transitions stable
    dinv = np.asarray(pack_bits(jnp.asarray(~b0)))
    stats = bs.update_bit_stats(stats, jnp.asarray(dinv), jnp.asarray(d0),
                                jnp.ones(1, bool))
    assert np.allclose(np.asarray(stats.permanence), 0.5)


def test_expected_hamming_matches_exact_on_binary_pools():
    # when the mean-bit vectors are exactly 0/1, expected Hamming == Hamming
    q_packed, q_bits = _rand_desc(6)
    t_packed, t_bits = _rand_desc(9)
    d = np.asarray(bs.expected_hamming(jnp.asarray(q_packed),
                                       jnp.asarray(t_bits.astype(np.float32))))
    exact = (q_bits[:, None, :] != t_bits[None, :, :]).sum(-1)
    assert np.allclose(d, exact, atol=1e-3)


def test_expected_hamming_numpy_oracle_fractional():
    q_packed, q_bits = _rand_desc(4)
    p = RNG.uniform(0, 1, size=(7, 256)).astype(np.float32)
    d = np.asarray(bs.expected_hamming(jnp.asarray(q_packed), jnp.asarray(p)))
    oracle = (q_bits[:, None, :] * (1 - p[None]) +
              (1 - q_bits[:, None, :]) * p[None]).sum(-1)
    assert np.allclose(d, oracle, atol=1e-2)


def test_expected_distances_match_float64_at_full_precision():
    """Bit probabilities k/255 against float64 numpy: both contractions
    (bitstats.expected_hamming, closure._prob_distance) must keep float32
    accuracy — a reduced-precision (TF32) product would be off by ~0.1."""
    from svi_mapper_tpu.mapping.closure import _prob_distance

    q_packed, q_bits = _rand_desc(64)
    r_packed, r_bits = _rand_desc(48)
    pq_u8 = RNG.integers(0, 256, size=(64, 256)).astype(np.uint8)
    pr_u8 = RNG.integers(0, 256, size=(48, 256)).astype(np.uint8)
    pq, pr = pq_u8 / 255.0, pr_u8 / 255.0               # float64

    def oracle(bits, p):
        return p.sum(-1)[None, :] + bits.astype(np.float64) @ (1.0 - 2.0 * p).T

    d = np.asarray(bs.expected_hamming(jnp.asarray(q_packed),
                                       jnp.asarray(pr.astype(np.float32))))
    np.testing.assert_allclose(d, oracle(q_bits, pr), atol=2e-4)
    d2 = np.asarray(_prob_distance(jnp.asarray(q_packed), jnp.asarray(pq_u8),
                                   jnp.asarray(r_packed), jnp.asarray(pr_u8)))
    want = 0.5 * (oracle(q_bits, pr) + oracle(r_bits, pq).T)
    np.testing.assert_allclose(d2, want, atol=2e-4)


def test_match_probabilistic_one_to_one_and_cutoff():
    t_packed, t_bits = _rand_desc(8)
    pools = t_bits.astype(np.float32)
    # queries 0,1 both equal train 3; query 2 = train 5 with 4 bits flipped;
    # query 3 is far from everything (cutoff)
    q_bits = np.stack([t_bits[3], t_bits[3], t_bits[5].copy(),
                       RNG.integers(0, 2, 256).astype(bool)])
    q_bits[2, :4] = ~q_bits[2, :4]
    q_packed = np.asarray(pack_bits(jnp.asarray(q_bits)))
    valid = np.ones(8, bool)
    idx, dist, ok = (np.asarray(a) for a in bs.match_probabilistic(
        jnp.asarray(q_packed), jnp.asarray(pools), jnp.asarray(valid),
        cutoff=25.0))
    # one-to-one: only one of queries {0,1} keeps train 3
    assert (ok[:2] & (idx[:2] == 3)).sum() == 1
    assert ok[2] and idx[2] == 5 and abs(dist[2] - 4) < 0.1
    assert not ok[3]


def test_landmark_table_accumulates_bit_stats():
    table = lm.make_table(8, 4)
    d, b = _rand_desc(3)
    uv = RNG.uniform(10, 50, size=(3, 2)).astype(np.float32)
    table, _ = lm.insert_landmarks(
        table, jnp.ones(3, bool), jnp.asarray(RNG.normal(size=(3, 3)), jnp.float32),
        jnp.asarray(uv), jnp.asarray(np.full(3, 5.0, np.float32)),
        jnp.asarray(d), jnp.asarray(d),
        jnp.asarray(np.concatenate([uv, uv - [5, 0]], 1), jnp.float32),
        jnp.eye(4), jnp.int32(0),
    )
    assert np.allclose(np.asarray(table.bit_sum)[:3], b)

    # re-observe the same descriptors on rows 0..2 -> bit_sum doubles,
    # bit_stable counts full agreement
    tracked = np.zeros(8, bool); tracked[:3] = True
    uv4 = np.zeros((8, 4), np.float32)
    d8 = np.zeros((8, 8), np.uint32); d8[:3] = d
    table = lm.add_measurements(table, jnp.asarray(tracked), jnp.asarray(uv4),
                                jnp.asarray(d8), jnp.eye(4))
    assert np.allclose(np.asarray(table.bit_sum)[:3], 2.0 * b)
    assert np.allclose(np.asarray(table.bit_stable)[:3], 1.0)
    # probability over the 2 measurements is just the bits again
    prob = np.asarray(table.bit_sum)[:3] / np.asarray(table.meas_count)[:3, None]
    assert np.allclose(prob, b)
