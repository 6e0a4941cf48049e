"""Loop-closure subsystem: place recognition, cloud matching, consensus.

JAX replacement for the reference's loop-closing stack:
  * DBoW2 vocabulary query + per-keyframe CBTree descriptor matching
    (CTrackerGT.cpp:383-503, CKeyFrame.cpp:6-35) -> replaced by exact
    all-pairs Hamming scoring of fixed-capacity descriptor pools — dense
    brute force replaces the tree traversal and removes the tree's
    approximation (SURVEY.md §7 design stance);
  * per-candidate 3D-3D ICP with gates (CTrackerGT.cpp:506-631) ->
    batched solvers.icp over all candidates at once;
  * windowed single-robot consensus ``LoopClosureChecker``
    (closure_checker.cpp:20-113: virtually move the local vertex set by
    each candidate's zero-error transform, re-evaluate every candidate's
    chi^2, keep the largest agreeing set) -> a [C, C] batched chi^2 matrix.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from svi_mapper_tpu.geometry import se3
from svi_mapper_tpu.solvers.icp import align_clouds

_PREC = jax.lax.Precision.HIGHEST
_BIG = jnp.int32(1 << 20)


# ---------------------------------------------------------------------------
# keyframe database (host container, device arrays)
# ---------------------------------------------------------------------------

@jax.jit
def _db_set(desc_a, p_a, v_a, c_a, T_a, k, d, p, v, n, T):
    return (desc_a.at[k].set(d), p_a.at[k].set(p), v_a.at[k].set(v),
            c_a.at[k].set(n), T_a.at[k].set(T))


@jax.jit
def _db_set_prob(prob_a, k, pr):
    return prob_a.at[k].set(pr)


@jax.jit
def _db_set_many(desc_a, p_a, v_a, c_a, T_a, k0, d, p, v, n, T):
    """Write B consecutive keyframe pools in ONE dispatch (chunk-batched
    DB add — the per-keyframe version cost ~7 device calls each)."""
    upd = jax.lax.dynamic_update_slice
    z = jnp.zeros((), jnp.int32)
    return (upd(desc_a, d, (k0, z, z)), upd(p_a, p, (k0, z, z)),
            upd(v_a, v, (k0, z)), upd(c_a, n, (k0,)),
            upd(T_a, T, (k0, z, z)))


@jax.jit
def _db_set_prob_many(prob_a, k0, plane, idx):
    """Gather B keyframes' pooled bit-probability rows from the chunk's
    [B, L, 256] device plane stack and store them, in the same dispatch
    family as `_db_set_many` (the plane never crosses to host)."""
    pr = jnp.take_along_axis(plane, idx[:, :, None], axis=1)  # [B,P,256]
    z = jnp.zeros((), jnp.int32)
    return jax.lax.dynamic_update_slice(prob_a, pr, (k0, z, z))


@dataclasses.dataclass
class KeyframeDatabase:
    """Growable stack of keyframe descriptor/point pools
    (the batched replacement for the BoW database + per-keyframe trees).

    Capacity doubles when full (the reference's DB grows unbounded on the
    heap). Closure-query shortlisting is ON by default: a bag-of-words
    vocabulary trains automatically on the first ``vocab_train_at``
    keyframes' descriptor pools (the reference always shortlists with a
    pretrained DBoW2 vocabulary, CTrackerGT.cpp:39,411 — training in-run
    replaces shipping a vocabulary file). With ``native_index=True`` a
    host-side C++ descriptor search tree
    (:class:`svi_mapper_tpu.native.DescriptorIndex`, the CBITree/DBoW2
    analog) shortlists instead.
    """

    capacity: int
    pool_size: int
    desc: jax.Array        # [K, P, 8] uint32 descriptor pools
    p_cam: jax.Array       # [K, P, 3] landmark positions in the keyframe frame
    valid: jax.Array       # [K, P] bool
    count: jax.Array       # [K] int32
    T_wc: jax.Array        # [K, 4, 4] keyframe poses at spawn
    n: int = 0             # number of keyframes stored
    # per-pool-entry descriptor bit probabilities, quantized to uint8
    # (ref CPDescriptorBRIEF mean-bit vectors stored per keyframe,
    # CKeyFrame.h:86-94 / CPDescriptorBRIEF.h:10-33); None = not stored
    prob: jax.Array | None = None   # [K, P, 256] uint8
    index: object | None = None  # optional native DescriptorIndex
    bow: object | None = None    # optional mapping.vocabulary.BowDatabase
    auto_vocab: bool = True      # train the BoW vocabulary in-run
    vocab_train_at: int = 8      # keyframes accumulated before training
    count_host: list = dataclasses.field(default_factory=list)  # host mirror
    # host mirror of T_wc: the per-keyframe closure search reads poses for
    # its metric radius gate / ICP init — a device fetch per query costs a
    # blocking host read
    T_wc_host: np.ndarray | None = None  # [K,4,4]

    def count_of(self, k: int) -> int:
        """Pool size of keyframe k without a device read."""
        if k < len(self.count_host):
            return self.count_host[k]
        return int(self.count[k])    # restored-from-checkpoint fallback

    @classmethod
    def create(cls, capacity: int = 512, pool_size: int = 256,
               native_index: bool = False,
               vocabulary: object | None = None,
               auto_vocab: bool = True,
               store_prob: bool = True) -> "KeyframeDatabase":
        """Default shortlisting = in-run BoW (the reference's DBoW2 role);
        the native tree index is opt-in — its single-leaf NN votes have
        lower recall than BoW scoring under viewpoint drift, matching the
        reference where the tree serves per-candidate matching, not place
        recognition."""
        index = None
        if native_index:
            from svi_mapper_tpu import native

            if native.available():
                index = native.DescriptorIndex()
        bow = None
        if vocabulary is not None:
            from svi_mapper_tpu.mapping.vocabulary import BowDatabase

            bow = BowDatabase(vocabulary, capacity=capacity)
            auto_vocab = False
        return cls(
            capacity=capacity,
            pool_size=pool_size,
            desc=jnp.zeros((capacity, pool_size, 8), jnp.uint32),
            p_cam=jnp.zeros((capacity, pool_size, 3), jnp.float32),
            valid=jnp.zeros((capacity, pool_size), jnp.bool_),
            count=jnp.zeros((capacity,), jnp.int32),
            T_wc=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (capacity, 4, 4)).copy(),
            prob=(jnp.zeros((capacity, pool_size, 256), jnp.uint8)
                  if store_prob else None),
            index=index,
            bow=bow,
            auto_vocab=auto_vocab,
            T_wc_host=np.tile(np.eye(4, dtype=np.float32), (capacity, 1, 1)),
        )

    def _grow(self) -> None:
        """Double the pool capacity (amortized O(1) per keyframe)."""
        pad = self.capacity
        P = self.pool_size
        self.desc = jnp.concatenate(
            [self.desc, jnp.zeros((pad, P, 8), jnp.uint32)])
        self.p_cam = jnp.concatenate(
            [self.p_cam, jnp.zeros((pad, P, 3), jnp.float32)])
        self.valid = jnp.concatenate(
            [self.valid, jnp.zeros((pad, P), jnp.bool_)])
        self.count = jnp.concatenate(
            [self.count, jnp.zeros((pad,), jnp.int32)])
        self.T_wc = jnp.concatenate(
            [self.T_wc,
             jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (pad, 4, 4))])
        if self.prob is not None:
            self.prob = jnp.concatenate(
                [self.prob, jnp.zeros((pad, P, 256), jnp.uint8)])
        if self.T_wc_host is not None:
            self.T_wc_host = np.concatenate(
                [self.T_wc_host,
                 np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))])
        self.capacity *= 2

    def _train_vocab(self) -> None:
        """In-run vocabulary training over the stored pools (the shipped-
        vocabulary replacement; ref brief_k10L6.voc.gz, CTrackerGT.cpp:39)."""
        from svi_mapper_tpu.mapping.vocabulary import BowDatabase, build_vocabulary

        desc_all = np.asarray(self.desc[: self.n])
        descs = [desc_all[k][: self.count_of(k)] for k in range(self.n)]
        alld = np.concatenate(descs)
        if len(alld) < 64:
            return
        doc_ids = np.concatenate(
            [np.full(len(d), k, np.int32) for k, d in enumerate(descs)])
        vocab = build_vocabulary(alld, k=8, levels=3, iters=4,
                                 doc_ids=doc_ids)
        self.bow = BowDatabase(vocab, capacity=max(self.capacity, 1024))
        for d in descs:
            self.bow.add(d)

    def add(self, desc: np.ndarray, p_cam: np.ndarray, T_wc: np.ndarray,
            prob: np.ndarray | None = None,
            prob_device: tuple | None = None) -> int:
        """Append one keyframe pool (truncated/padded to pool_size).

        ``prob`` [n, 256] uint8 — optional quantized bit probabilities of
        the pooled landmarks (the probabilistic descriptors the reference
        stores per keyframe, CKeyFrame.h:86-94).

        ``prob_device`` = (plane [L, 256] uint8 DEVICE array, sel_idx [n]
        host int indices): the probability rows stay on device and the
        pool gather + store run as device ops — the [L, 256] plane is the
        fat part of a keyframe snapshot (~256 KB) and need not round-trip
        through the host."""
        if self.n >= self.capacity:
            self._grow()
        P = self.pool_size
        n = min(len(desc), P)
        d = np.zeros((P, 8), np.uint32)
        p = np.zeros((P, 3), np.float32)
        v = np.zeros((P,), bool)
        d[:n] = desc[:n]
        p[:n] = p_cam[:n]
        v[:n] = True
        k = self.n
        # one fused dispatch for all five array writes (dispatch latency
        # dominates these tiny updates)
        self.desc, self.p_cam, self.valid, self.count, self.T_wc = _db_set(
            self.desc, self.p_cam, self.valid, self.count, self.T_wc,
            k, jnp.asarray(d), jnp.asarray(p), jnp.asarray(v),
            jnp.int32(n), jnp.asarray(T_wc, jnp.float32),
        )
        if self.prob is not None:
            if prob_device is not None:
                plane, sel_idx = prob_device
                idx = np.zeros(P, np.int32)      # pad slots re-read row 0;
                idx[:n] = sel_idx[:n]            # valid[n:] is False anyway
                pr = jnp.take(plane, jnp.asarray(idx), axis=0)
            elif prob is not None:
                prh = np.zeros((P, 256), np.uint8)
                prh[:n] = prob[:n]
                pr = jnp.asarray(prh)
            else:
                # fall back to the binary snapshot as a degenerate (0/255)
                # probability so prob-mode matching degrades to exact
                from svi_mapper_tpu.ops.descriptors import unpack_bits
                prh = np.zeros((P, 256), np.uint8)
                prh[:n] = np.asarray(
                    jax.device_get(unpack_bits(jnp.asarray(d[:n])))
                ).astype(np.uint8) * 255
                pr = jnp.asarray(prh)
            self.prob = _db_set_prob(self.prob, k, pr)
        self.count_host.append(n)
        if self.T_wc_host is not None:
            self.T_wc_host[k] = np.asarray(T_wc, np.float32)
        self.n = k + 1
        if self.index is not None:
            self.index.add(d[:n], k)
        if self.bow is not None:
            self.bow.add(d[:n])
        elif self.auto_vocab and self.index is None \
                and self.n >= self.vocab_train_at:
            self._train_vocab()
        return k

    def add_many(self, pools: list, plane: jax.Array | None = None) -> list[int]:
        """Append a CHUNK of keyframe pools in two fused dispatches.

        ``pools`` is a list of ``(desc [n,8], p_cam [n,3], T_wc [4,4],
        sel_idx [n] | None)`` host tuples, in keyframe order; ``plane`` is
        the chunk's stacked ``[B, L, 256]`` uint8 bit-probability device
        array aligned with ``pools`` (``sel_idx`` indexes its L axis).
        Equivalent to ``[self.add(...) for ...]`` but the array writes
        batch into ONE `_db_set_many` + ONE `_db_set_prob_many` dispatch
        and the BoW vectors into one batched descent — at endurance
        keyframe density (1 keyframe / 3 frames) the per-keyframe dispatch
        cost dominated the whole tail.

        The batch width pads to a power-of-two bucket so the jitted
        programs compile once per bucket; pad rows write zeros into slots
        the NEXT add overwrites (count/valid stay zero, and the temporal
        ``idx < lo`` closure gate excludes indices >= n regardless).
        """
        B0 = len(pools)
        if B0 == 0:
            return []
        if self.prob is not None and plane is None:
            # no device probability plane: the single-add path degrades
            # each pool to binary 0/255 probabilities — keep that behavior
            return [self.add(d0, p0, T0) for (d0, p0, T0, _s) in pools]
        if B0 == 1 and plane is not None:
            d0, p0, T0, s0 = pools[0]
            return [self.add(d0, p0, T0,
                             prob_device=(plane[0], s0))]
        while self.n + B0 > self.capacity:
            self._grow()
        P = self.pool_size
        B = 1
        while B < B0:
            B *= 2
        d = np.zeros((B, P, 8), np.uint32)
        p = np.zeros((B, P, 3), np.float32)
        v = np.zeros((B, P), bool)
        nv = np.zeros((B,), np.int32)
        T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
        idx = np.zeros((B, P), np.int32)
        for b, (desc, p_cam, T_wc, sel_idx) in enumerate(pools):
            n = min(len(desc), P)
            d[b, :n] = desc[:n]
            p[b, :n] = p_cam[:n]
            v[b, :n] = True
            nv[b] = n
            T[b] = np.asarray(T_wc, np.float32)
            if sel_idx is not None:
                idx[b, :n] = sel_idx[:n]
        k0 = self.n
        # pad slots beyond capacity can't happen: _grow above guarantees
        # n + B0 fits, and pad rows (B0..B) may spill into free slots only
        while k0 + B > self.capacity:
            self._grow()
        self.desc, self.p_cam, self.valid, self.count, self.T_wc = \
            _db_set_many(self.desc, self.p_cam, self.valid, self.count,
                         self.T_wc, jnp.int32(k0), jnp.asarray(d),
                         jnp.asarray(p), jnp.asarray(v), jnp.asarray(nv),
                         jnp.asarray(T))
        if self.prob is not None and plane is not None:
            Bp = plane.shape[0]
            if Bp < B:      # pad the plane stack to the bucket width
                plane = jnp.concatenate(
                    [plane, jnp.zeros((B - Bp,) + plane.shape[1:],
                                      plane.dtype)])
            self.prob = _db_set_prob_many(self.prob, jnp.int32(k0), plane,
                                          jnp.asarray(idx))
        out = []
        for b in range(B0):
            k = k0 + b
            self.count_host.append(int(nv[b]))
            if self.T_wc_host is not None:
                self.T_wc_host[k] = T[b]
            if self.index is not None:
                self.index.add(d[b, : nv[b]], k)
            out.append(k)
        self.n = k0 + B0
        if self.bow is not None:
            self.bow.add_many(d, v, count=B0)
        elif self.auto_vocab and self.index is None \
                and self.n >= self.vocab_train_at:
            self._train_vocab()
        return out

    def poses_host(self) -> np.ndarray:
        """[capacity,4,4] stored keyframe poses WITHOUT a device read
        (host mirror; falls back to a device fetch for DBs restored from
        archives that predate the mirror)."""
        if self.T_wc_host is None or len(self.T_wc_host) != self.capacity:
            self.T_wc_host = np.asarray(self.T_wc, np.float32).copy()
        return self.T_wc_host

    def update_poses(self, T_new: np.ndarray) -> None:
        """Overwrite the first ``len(T_new)`` stored poses (device array +
        host mirror) — the pose-graph back-propagation into the closure DB
        (ref _backPropagateTrajectoryToFull, Cg2oOptimizer.cpp:1552-1603)."""
        n = len(T_new)
        # rebind a fresh host array instead of mutating in place: snapshot()
        # readers (async closure worker) hold the OLD binding, so their
        # radius-gate / ICP-init pose reads stay internally consistent —
        # mirroring how the jax arrays are rebound, never mutated.
        host = self.poses_host().copy()
        host[:n] = np.asarray(T_new, np.float32)
        self.T_wc_host = host
        self.T_wc = jnp.asarray(host)

    def snapshot(self) -> "KeyframeDatabase":
        """Shallow copy for a reader thread: the device arrays are immutable
        jax values (later ``add`` calls rebind, never mutate), and the shared
        native index is internally locked — so a snapshot reads consistently
        while the tracker keeps appending."""
        return dataclasses.replace(self)


# ---------------------------------------------------------------------------
# place recognition: batched pool scoring
# ---------------------------------------------------------------------------

def _pool_nn_counts(
    desc_q: jax.Array,      # [P, 8] query pool
    valid_q: jax.Array,     # [P]
    desc_r: jax.Array,      # [C, P, 8] reference pools
    valid_r: jax.Array,     # [C, P]
    cutoff: int,
) -> jax.Array:
    """[C] match counts: #query descriptors whose nearest neighbour in pool
    c is within the Hamming cutoff (the reference's getNumberOfMatches
    score, CBTree.h:198-236 — exact brute force replaces tree descent).

    The ONE home of the [P, C, P] XOR-popcount-min-count block: every
    pool-scoring entry point (score_pools, count_pool_matches, the fused
    closure query) routes through here so gate changes cannot diverge
    (VERDICT r4 Weak-7)."""
    x = desc_q[:, None, None, :] ^ desc_r[None, :, :, :]          # [P,C,P,8]
    d = jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)
    d = jnp.where(valid_r[None, :, :], d, _BIG)
    dmin = jnp.min(d, axis=-1)                                    # [P,C]
    hit = (dmin <= cutoff) & valid_q[:, None]
    return jnp.sum(hit.astype(jnp.int32), axis=0)                 # [C]


@functools.partial(jax.jit, static_argnames=("cutoff",))
def score_pools(
    desc_q: jax.Array,      # [P, 8] query pool
    valid_q: jax.Array,     # [P]
    desc_db: jax.Array,     # [K, P, 8] database pools
    valid_db: jax.Array,    # [K, P]
    cutoff: int = 25,       # ref MAXIMUM_DISTANCE_HAMMING (CKeyFrame.h:12)
) -> jax.Array:
    """[K] match counts of the query pool against every database pool."""
    return _pool_nn_counts(desc_q, valid_q, desc_db, valid_db, cutoff)


@functools.partial(jax.jit, static_argnames=("cutoff",))
def count_pool_matches(
    desc_q: jax.Array, valid_q: jax.Array,
    desc_r: jax.Array, valid_r: jax.Array,
    cutoff: int = 25,
) -> jax.Array:
    """Scalar match count of one query pool against one reference pool
    (single-pool slice of :func:`score_pools`)."""
    return _pool_nn_counts(desc_q, valid_q, desc_r[None], valid_r[None],
                           cutoff)[0]


def _prob_distance(desc_q, prob_q, desc_r, prob_r):
    """Symmetric expected-Hamming distance matrix [P, P] between two pools.

    Each side contributes E[d(bits, mean_bits_other)] = sum(p) + b.(1-2p)
    (mapping.bitstats); averaging both directions uses BOTH observation
    histories — the batched analog of the reference matching binary
    queries against stored CPDescriptorBRIEF mean-bit vectors
    (CBPNode.h leaf scan, cutoff CKeyFrame.h:13).

    Both contractions run at HIGHEST precision: the probabilities are k/255,
    and a reduced-precision (TF32) product would move a 256-bit sum by up to
    a tenth of a unit, enough to flip a comparison against the cutoff."""
    from svi_mapper_tpu.ops.descriptors import unpack_bits

    bq = unpack_bits(desc_q).astype(jnp.float32)          # [P, 256]
    br = unpack_bits(desc_r).astype(jnp.float32)
    pq = prob_q.astype(jnp.float32) / 255.0
    pr = prob_r.astype(jnp.float32) / 255.0
    dot = functools.partial(
        jax.lax.dot_general,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    d_qr = jnp.sum(pr, -1)[None, :] + dot(bq, 1.0 - 2.0 * pr)   # [Pq, Pr]
    d_rq = jnp.sum(pq, -1)[None, :] + dot(br, 1.0 - 2.0 * pq)   # [Pr, Pq]
    return 0.5 * (d_qr + d_rq.T)


@functools.partial(
    jax.jit,
    static_argnames=("k", "C", "Cm", "cutoff", "prob_cutoff", "di_levels"))
def closure_query_fused(
    centroids, child_valid, weights,   # the vocabulary (pytrees)
    vectors: jax.Array,                # [N, W] stored BoW vectors
    query_kf: jax.Array,               # scalar int32
    desc_db: jax.Array, p_db: jax.Array, valid_db: jax.Array,
    T_db: jax.Array,                   # [N,4,4] stored keyframe poses
    lo: jax.Array,                     # temporal bound (< lo eligible)
    radius_m2: jax.Array,              # metric candidate gate (inf = off)
    entry_floor: jax.Array,            # int32 shortlist match-count floor
    k: int, C: int, Cm: int, cutoff: int,
    prob_db: jax.Array | None = None,
    prob_cutoff: float = 50.0,
    icp_inlier_m2: float = 1.0,
    icp_min_inliers: int = 25,
    icp_max_avg_error: float = 0.9,
    di_levels: int = 0,
):
    """The WHOLE loop-closure query as ONE dispatch: BoW scoring ->
    temporal + metric-radius gates -> top-C shortlist -> exact match
    counts -> top-Cm candidate selection -> mutual pool matching (exact or
    probabilistic) -> batched ICP validation.

    ``di_levels > 0`` enables the DBoW2 direct-index restriction on the
    match stage (``DBOW2_ID_LEVELS``, CTrackerGT.cpp:38-39,248-250):
    correspondence pairs must share their vocabulary node at tree level
    ``di_levels``. Off by default — the exact all-pairs match is already
    one fused dispatch, so the index is a precision knob (prunes
    cross-node coincidental Hamming hits), not the lookup accelerator it
    is on the CPU reference.

    A split pipeline (shortlist dispatch + host selection + match/ICP
    dispatch) pays two dispatches and two blocking host reads per keyframe.
    Fused: one dispatch, one host read. This is the ONLY production query path for BoW-backed
    databases; find_closures keeps a split fallback only for the native
    tree index and vocabulary-less databases.

    Returns ``(cand [Cm], ok [Cm], n_matches [Cm], T_qr [Cm,4,4],
    icp_ok [Cm], inliers [Cm], inl_mask [Cm,P], fwd [Cm,P])``.
    """
    from svi_mapper_tpu.mapping.vocabulary import _bow_vector_jit, score_l1

    desc_q = desc_db[query_kf]
    p_q = p_db[query_kf]
    valid_q = valid_db[query_kf]
    v = _bow_vector_jit(centroids, child_valid, weights, desc_q,
                        valid_q.astype(jnp.float32), k)
    s = score_l1(v, vectors)                               # [Nv]
    Nv = vectors.shape[0]                 # BoW store capacity
    Nd = T_db.shape[0]                    # pool/pose store capacity
    idx = jnp.arange(Nv, dtype=jnp.int32)
    # temporal exclusion + metric search radius (ref CTrackerSV.h:89);
    # the BoW vector store and the pool store grow independently, so the
    # [Nd] distance vector aligns to the [Nv] score vector by index
    R = T_db[:, :3, :3]
    t = T_db[:, :3, 3]
    centers = -jnp.einsum("kji,kj->ki", R, t, precision=_PREC)
    d2 = jnp.sum((centers - centers[query_kf]) ** 2, axis=-1)
    if Nv <= Nd:
        d2v = d2[:Nv]
    else:
        d2v = jnp.concatenate(
            [d2, jnp.full((Nv - Nd,), jnp.inf, d2.dtype)])
    s = jnp.where((idx < lo) & (d2v <= radius_m2), s, -1.0)
    top_s, short = jax.lax.top_k(s, C)
    short = short.astype(jnp.int32)
    safe = jnp.where(top_s > 0.0, short, 0)
    desc_r = jnp.take(desc_db, safe, axis=0)               # [C,P,8]
    valid_r = jnp.take(valid_db, safe, axis=0)
    counts = _pool_nn_counts(desc_q, valid_q, desc_r, valid_r, cutoff)
    counts = jnp.where(top_s > 0.0, counts, 0)
    # top-Cm candidates by exact match count, gated by the entry floor
    top_c, sel = jax.lax.top_k(counts, Cm)
    cand = safe[sel]                                       # [Cm] DB indices
    ok = top_c >= entry_floor
    cand_safe = jnp.where(ok, cand, 0)
    T_q = T_db[query_kf]
    T_init = jnp.matmul(
        T_q[None], se3.inv_T(jnp.take(T_db, cand_safe, axis=0)),
        precision=_PREC)
    desc_c = jnp.take(desc_db, cand_safe, axis=0)
    p_c = jnp.take(p_db, cand_safe, axis=0)
    valid_c = jnp.take(valid_db, cand_safe, axis=0)
    prob_q = None if prob_db is None else prob_db[query_kf]
    prob_c = None if prob_db is None else jnp.take(prob_db, cand_safe, axis=0)
    if di_levels > 0:
        # direct-index node ids: one extra descent for the query pool and
        # the Cm candidate pools (vmapped) — tiny vs the [P,C,P] popcount
        from svi_mapper_tpu.mapping.vocabulary import _descend

        node_q = _descend(centroids, child_valid, desc_q, k,
                          levels=di_levels)
        node_c = jax.vmap(
            lambda dc: _descend(centroids, child_valid, dc, k,
                                levels=di_levels))(desc_c)
    else:
        node_q = node_c = None

    def one(dr, pr, vr, Ti, prob_ri, node_ri=None):
        pq, prm, okm, fwd = match_pools(desc_q, p_q, valid_q, dr, pr, vr,
                                        cutoff=cutoff, prob_q=prob_q,
                                        prob_r=prob_ri,
                                        prob_cutoff=prob_cutoff,
                                        node_q=node_q, node_r=node_ri)
        res = align_clouds(pq, prm, okm, T_init=Ti,
                           inlier_m2=icp_inlier_m2,
                           min_inliers=icp_min_inliers,
                           max_avg_error=icp_max_avg_error)
        n_matches = jnp.sum(okm.astype(jnp.int32))
        q = se3.transform(res.T_qr, prm)
        err2 = jnp.sum((q - pq) ** 2, -1)
        inl = okm & (err2 < icp_inlier_m2)
        return n_matches, res.T_qr, res.ok, res.inliers, inl, fwd

    # the expensive match + ICP stage only EXECUTES when some candidate
    # passed the entry gate (most keyframes have none — the old split
    # pipeline skipped its second dispatch then, and running the [P,C,P]
    # match unconditionally measurably costs full-SLAM throughput)
    P = desc_q.shape[0]

    def _match(_):
        # vmap over exactly the per-candidate arrays that exist (prob_c /
        # node_c are None-or-[Cm,...] depending on the static config)
        per_cand = [a for a in (prob_c, node_c) if a is not None]

        def run(dr, pr, vr, Ti, *rest):
            it = iter(rest)
            prob_ri = next(it) if prob_c is not None else None
            node_ri = next(it) if node_c is not None else None
            return one(dr, pr, vr, Ti, prob_ri, node_ri)

        return jax.vmap(run)(desc_c, p_c, valid_c, T_init, *per_cand)

    def _skip(_):
        return (jnp.zeros((Cm,), jnp.int32),
                jnp.broadcast_to(jnp.eye(4, dtype=T_db.dtype), (Cm, 4, 4)),
                jnp.zeros((Cm,), jnp.bool_),
                jnp.zeros((Cm,), jnp.int32),
                jnp.zeros((Cm, P), jnp.bool_),
                jnp.zeros((Cm, P), jnp.int32))

    n_m, T_qr, icp_ok, inliers, inl, fwd = jax.lax.cond(
        jnp.any(ok), _match, _skip, None)
    return cand, ok, n_m, T_qr, icp_ok, inliers, inl, fwd


@functools.partial(jax.jit, static_argnames=("cutoff", "prob_cutoff"))
def match_pools_many(
    query_kf: jax.Array,          # scalar int32 — query pool index
    cand_idx: jax.Array,          # [C] database keyframe indices
    desc_db: jax.Array, p_db: jax.Array, valid_db: jax.Array,
    T_init: jax.Array,            # [C,4,4] ICP initializations
    cutoff: int = 25,
    icp_inlier_m2: float = 1.0,
    icp_min_inliers: int = 25,
    icp_max_avg_error: float = 0.9,
    prob_db: jax.Array | None = None,   # [K,P,256] u8 — enables prob matching
    prob_cutoff: float = 50.0,
):
    """Mutual matching + ICP validation of one query pool against C
    candidate pools in ONE dispatch (vmapped match_pools + align_clouds)."""
    desc_q = desc_db[query_kf]
    p_q = p_db[query_kf]
    valid_q = valid_db[query_kf]
    desc_r = jnp.take(desc_db, cand_idx, axis=0)
    p_r = jnp.take(p_db, cand_idx, axis=0)
    valid_r = jnp.take(valid_db, cand_idx, axis=0)
    prob_q = None if prob_db is None else prob_db[query_kf]
    prob_r = None if prob_db is None else jnp.take(prob_db, cand_idx, axis=0)

    def one(dr, pr, vr, Ti, prob_ri):
        pq, prm, ok, fwd = match_pools(desc_q, p_q, valid_q, dr, pr, vr,
                                       cutoff=cutoff, prob_q=prob_q,
                                       prob_r=prob_ri,
                                       prob_cutoff=prob_cutoff)
        res = align_clouds(pq, prm, ok, T_init=Ti,
                           inlier_m2=icp_inlier_m2,
                           min_inliers=icp_min_inliers,
                           max_avg_error=icp_max_avg_error)
        n_matches = jnp.sum(ok.astype(jnp.int32))
        # post-ICP inlier correspondences (the pair export)
        q = se3.transform(res.T_qr, prm)
        err2 = jnp.sum((q - pq) ** 2, -1)
        inl = ok & (err2 < icp_inlier_m2)
        return n_matches, res.T_qr, res.ok, res.inliers, inl, fwd

    if prob_r is None:
        return jax.vmap(lambda dr, pr, vr, Ti: one(dr, pr, vr, Ti, None))(
            desc_r, p_r, valid_r, T_init)
    return jax.vmap(one)(desc_r, p_r, valid_r, T_init, prob_r)


@functools.partial(jax.jit, static_argnames=("cutoff", "prob_cutoff"))
def match_pools(
    desc_q: jax.Array, p_q: jax.Array, valid_q: jax.Array,
    desc_r: jax.Array, p_r: jax.Array, valid_r: jax.Array,
    cutoff: int = 25,
    prob_q: jax.Array | None = None,   # [P,256] u8 bit probabilities
    prob_r: jax.Array | None = None,
    prob_cutoff: float = 50.0,
    node_q: jax.Array | None = None,   # [P] int32 direct-index node ids
    node_r: jax.Array | None = None,
):
    """Mutual-nearest matching of two keyframe pools -> aligned point pairs.

    Returns (pq [P,3], pr [P,3], ok [P], fwd [P]): for each query-pool
    slot, the matched reference point and its pool slot index (one-to-one
    enforced, ref CBPTree.h:41-50 / _getMatchNN CTrackerGT.cpp:648-678).

    With ``prob_q``/``prob_r`` given, the distance is the symmetric expected
    Hamming between each pool's bit-probability history under the
    probabilistic cutoff (ref MAXIMUM_DISTANCE_HAMMING_PROBABILITY = 50,
    CKeyFrame.h:13) — robust to the per-snapshot descriptor noise that
    starves exact matching under photometric stress.

    With ``node_q``/``node_r`` given, pairs are additionally required to
    share their vocabulary node (the DBoW2 direct-index restriction,
    ``DBOW2_ID_LEVELS 2``, CTrackerGT.cpp:38-39,248-250): the reference
    only considers feature pairs listed under the same level-2 node; here
    the same constraint is a [P, P] node-equality mask on the dense
    distance matrix (see :func:`mapping.vocabulary.node_ids`)."""
    if prob_q is not None and prob_r is not None:
        d = _prob_distance(desc_q, prob_q, desc_r, prob_r)
        big = jnp.float32(1e9)
        d = jnp.where(valid_q[:, None] & valid_r[None, :], d, big)
        if node_q is not None and node_r is not None:
            d = jnp.where(node_q[:, None] == node_r[None, :], d, big)
        cut = jnp.float32(prob_cutoff)
    else:
        x = desc_q[:, None, :] ^ desc_r[None, :, :]
        d = jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)
        d = jnp.where(valid_q[:, None] & valid_r[None, :], d, _BIG)
        if node_q is not None and node_r is not None:
            d = jnp.where(node_q[:, None] == node_r[None, :], d, _BIG)
        cut = cutoff
    fwd = jnp.argmin(d, axis=1)
    bwd = jnp.argmin(d, axis=0)
    dist = jnp.take_along_axis(d, fwd[:, None], axis=1)[:, 0]
    mutual = bwd[fwd] == jnp.arange(d.shape[0])
    ok = mutual & (dist <= cut) & valid_q
    return p_q, p_r[fwd], ok, fwd


# ---------------------------------------------------------------------------
# consensus: batched LoopClosureChecker
# ---------------------------------------------------------------------------

@jax.jit
def consensus_matrix(
    M: jax.Array,          # [C,4,4] measured closure transforms T_q<-r
    T_i: jax.Array,        # [C,4,4] reference keyframe pose estimates (world->cam)
    T_j: jax.Array,        # [C,4,4] query keyframe pose estimates
    valid: jax.Array,      # [C]
) -> jax.Array:
    """[C, C] chi^2: error of candidate d under the rigid correction that
    makes candidate c exact (closure_checker.cpp:53-113: push the candidate's
    zero-error transform onto the movable set, re-evaluate all candidates)."""
    # correction that zeroes candidate c: D_c = M_c T_i_c inv(T_j_c)
    D = jnp.matmul(jnp.matmul(M, T_i, precision=_PREC), se3.inv_T(T_j), precision=_PREC)

    def err_under(Dc):
        # candidate d error with all query poses moved rigidly by Dc
        Tj_corr = jnp.matmul(Dc[None], T_j, precision=_PREC)
        E = jnp.matmul(
            jnp.matmul(Tj_corr, se3.inv_T(T_i), precision=_PREC),
            se3.inv_T(M), precision=_PREC,
        )
        r = se3.log_se3(E)
        return jnp.sum(r * r, axis=-1)                    # [C]

    chi2 = jax.vmap(err_under)(D)                         # [C,C]
    big = jnp.asarray(jnp.inf, chi2.dtype)
    chi2 = jnp.where(valid[None, :] & valid[:, None], chi2, big)
    return chi2


def _log_se3_np(T: np.ndarray) -> np.ndarray:
    """Host float64 SE(3) log ``[..., 4, 4] -> [..., 6]`` (numpy mirror of
    geometry.se3.log_se3 — parity-tested in tests/test_backend.py).

    Exists so the per-keyframe closure consensus can run WITHOUT a device
    round trip: the candidate windows are tiny ([C<=16] rigid-transform
    algebra), and on the device every consensus paid a dispatch plus a
    blocking read — at endurance revisit density a first-order throughput
    cost."""
    T = np.asarray(T, np.float64)
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = np.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(cos_t)
    w = 0.5 * np.stack([R[..., 2, 1] - R[..., 1, 2],
                        R[..., 0, 2] - R[..., 2, 0],
                        R[..., 1, 0] - R[..., 0, 1]], -1)  # sin(t) * axis
    sin_t = np.sin(theta)
    small = theta < 1e-6
    near_pi = theta > np.pi - 1e-4
    safe_sin = np.where(small | near_pi, 1.0, sin_t)
    phi = (theta / safe_sin)[..., None] * w
    phi = np.where(small[..., None], w, phi)
    if near_pi.any():
        # axis from the symmetric part; sign from the antisymmetric part
        omc = np.where(near_pi, 1.0 - cos_t, 1.0)
        ax2 = np.clip((np.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]],
                                -1) - cos_t[..., None]) / omc[..., None],
                      0.0, None)
        ax = np.sqrt(ax2)
        ax *= np.where(w >= 0, 1.0, -1.0)
        n = np.linalg.norm(ax, axis=-1, keepdims=True)
        ax = ax / np.where(n > 0, n, 1.0)
        phi = np.where(near_pi[..., None], theta[..., None] * ax, phi)
    th2 = np.sum(phi * phi, -1)
    sm = th2 < 1e-12
    safe_t2 = np.where(sm, 1.0, th2)
    st = np.sqrt(safe_t2)
    A = np.where(sm, 1.0 - th2 / 6.0, np.sin(st) / st)
    B = np.where(sm, 0.5 - th2 / 24.0, (1.0 - np.cos(st)) / safe_t2)
    coef = np.where(sm, 1.0 / 12.0, (1.0 - A / (2.0 * B)) / safe_t2)
    Z = np.zeros_like(phi[..., 0])
    Phi = np.stack([
        np.stack([Z, -phi[..., 2], phi[..., 1]], -1),
        np.stack([phi[..., 2], Z, -phi[..., 0]], -1),
        np.stack([-phi[..., 1], phi[..., 0], Z], -1)], -2)
    Phi2 = Phi @ Phi
    eye = np.broadcast_to(np.eye(3), Phi.shape)
    V_inv = eye - 0.5 * Phi + coef[..., None, None] * Phi2
    rho = np.einsum("...ij,...j->...i", V_inv, t)
    return np.concatenate([rho, phi], -1)


def consensus_matrix_np(M: np.ndarray, T_i: np.ndarray,
                        T_j: np.ndarray) -> np.ndarray:
    """Host mirror of :func:`consensus_matrix` ([C, C] chi^2, float64) —
    zero device round trips (see `_log_se3_np`)."""
    M = np.asarray(M, np.float64)
    T_i = np.asarray(T_i, np.float64)
    T_j = np.asarray(T_j, np.float64)
    inv = np.linalg.inv
    D = M @ T_i @ inv(T_j)                      # [C,4,4]
    Tj_corr = D[:, None] @ T_j[None, :]         # [C,C,4,4]
    E = Tj_corr @ inv(T_i)[None, :] @ inv(M)[None, :]
    r = _log_se3_np(E)
    return np.sum(r * r, axis=-1)               # [C,C]


def consensus_filter(chi2: jax.Array, valid: jax.Array, threshold: float = 0.25):
    """Keep the largest agreeing candidate set (ref LoopClosureChecker
    inlier counting, closure_checker.cpp:34-50; threshold Cg2oOptimizer.h:125).

    Returns (accept [C] bool, best_count int).
    """
    inlier = chi2 < threshold                             # [C,C]
    counts = jnp.sum(inlier.astype(jnp.int32), axis=1)    # consensus per anchor
    counts = jnp.where(valid, counts, 0)
    best = jnp.argmax(counts)
    accept = inlier[best] & valid
    return accept, counts[best]


# ---------------------------------------------------------------------------
# the full query pipeline (host-orchestrated, device-computed)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ClosureCandidate:
    query_kf: int
    ref_kf: int
    T_qr: np.ndarray      # measured relative transform (query <- ref frame)
    inliers: int
    matches: int
    # ICP-inlier correspondence slots (query_pool_slot, ref_pool_slot) —
    # the raw material for landmark-identity closure constraints
    # (ref EdgePointXYZ, Cg2oOptimizer.cpp:444-459)
    pairs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), np.int32))


def _decode_fused(query_kf: int, match_floor: int, max_candidates: int,
                  fused) -> list[ClosureCandidate]:
    """Host-side decode of one (already device_get) closure_query_fused
    result tuple into validated ClosureCandidates (shared by the
    single-query and chunk-batched paths)."""
    cand, okf, n_matches, T_qr, icp_ok, inliers, inl_mask, fwd = fused
    results: list[ClosureCandidate] = []
    seen: set[int] = set()
    for j in range(max_candidates):
        c = int(cand[j])
        if (not bool(okf[j]) or c in seen
                or int(n_matches[j]) < match_floor
                or not bool(icp_ok[j])):
            continue
        seen.add(c)
        slots_q = np.nonzero(inl_mask[j])[0].astype(np.int32)
        pairs = np.stack([slots_q, fwd[j][slots_q].astype(np.int32)], -1)
        results.append(ClosureCandidate(
            query_kf=query_kf, ref_kf=c, T_qr=T_qr[j],
            inliers=int(inliers[j]), matches=int(n_matches[j]),
            pairs=pairs,
        ))
    return results


def find_closures_batch(
    db: KeyframeDatabase,
    query_kfs: list[int],
    *,
    min_matches: int = 25,
    min_relative: float = 0.5,
    hamming_cutoff: int = 25,
    exclude_recent: int = 20,
    max_candidates: int = 4,
    icp_kwargs: dict | None = None,
    probabilistic: bool = True,
    prob_cutoff: float = 50.0,
    search_radius_m2: float = 25.0,
    direct_index_levels: int = 0,
) -> list[list[ClosureCandidate]]:
    """All closure queries of one chunk's keyframes in ONE dispatch + ONE
    host read: the per-keyframe fused query still paid one blocking host
    read per keyframe, so a chunk's queries batch via vmap over the fused
    program.

    Safe to batch because chunk-mates can never be each other's closure
    references: the temporal exclusion (>= ``exclude_recent`` keyframes,
    ref CTrackerSV.h:84) far exceeds any chunk's keyframe count, so each
    query's eligible set is unaffected by the others having already been
    added to the database. Falls back to sequential :func:`find_closures`
    for vocabulary-less / native-index databases.
    """
    use_prob = probabilistic and db.prob is not None
    if db.bow is None or db.bow.n == 0 or len(query_kfs) <= 1:
        kw = dict(min_matches=min_matches, min_relative=min_relative,
                  hamming_cutoff=hamming_cutoff,
                  exclude_recent=exclude_recent,
                  max_candidates=max_candidates, icp_kwargs=icp_kwargs,
                  probabilistic=probabilistic, prob_cutoff=prob_cutoff,
                  search_radius_m2=search_radius_m2,
                  direct_index_levels=direct_index_levels)
        return [find_closures(db, q, **kw) for q in query_kfs]

    kw = icp_kwargs or {}
    C = max(4 * max_candidates, 8)
    n_qs = [db.count_of(q) for q in query_kfs]
    floors = [max(min_matches, int(min_relative * n)) for n in n_qs]
    entries = [min_matches if use_prob else f for f in floors]
    los = [max(0, q - exclude_recent) for q in query_kfs]
    # pad the batch to a power-of-two bucket (repeat the last query) so the
    # vmapped program compiles once per bucket, not once per chunk width
    B0 = len(query_kfs)
    B = 1
    while B < B0:
        B *= 2
    query_kfs = list(query_kfs) + [query_kfs[-1]] * (B - B0)
    entries = entries + [entries[-1]] * (B - B0)
    los = los + [los[-1]] * (B - B0)

    def one(q, lo_b, entry):
        return closure_query_fused(
            db.bow.vocab.centroids, db.bow.vocab.child_valid,
            db.bow.vocab.weights, db.bow.vectors,
            q, db.desc, db.p_cam, db.valid, db.T_wc, lo_b,
            jnp.float32(search_radius_m2), entry,
            db.bow.vocab.k, C, max_candidates, hamming_cutoff,
            prob_db=db.prob if use_prob else None,
            prob_cutoff=prob_cutoff,
            icp_inlier_m2=kw.get("inlier_m2", 1.0),
            icp_min_inliers=kw.get("min_inliers", 25),
            icp_max_avg_error=kw.get("max_avg_error", 0.9),
            di_levels=direct_index_levels,
        )

    batched = jax.device_get(jax.vmap(one)(
        jnp.asarray(query_kfs, jnp.int32),
        jnp.asarray(los, jnp.int32),
        jnp.asarray(entries, jnp.int32),
    ))
    out: list[list[ClosureCandidate]] = []
    for b in range(B0):                       # padded slots drop
        q = query_kfs[b]
        match_floor = floors[b] if use_prob else min_matches
        fused_b = tuple(x[b] for x in batched)
        out.append([] if q < 1 or n_qs[b] < min_matches
                   else _decode_fused(q, match_floor, max_candidates,
                                      fused_b))
    return out


def find_closures(
    db: KeyframeDatabase,
    query_kf: int,
    *,
    min_matches: int = 25,           # ref CTrackerGT.cpp:422 gate family
    min_relative: float = 0.5,       # ref :479
    hamming_cutoff: int = 25,
    exclude_recent: int = 10,
    max_candidates: int = 4,
    icp_kwargs: dict | None = None,
    probabilistic: bool = True,
    prob_cutoff: float = 50.0,       # ref CKeyFrame.h:13
    direct_index_levels: int = 0,    # ref DBOW2_ID_LEVELS (CTrackerGT.cpp:38)
    search_radius_m2: float = 25.0,  # ref m_dLoopClosingRadiusSquaredMetersL2
                                     # (CTrackerSV.h:89): candidates must lie
                                     # within this squared metric distance of
                                     # the query's CURRENT pose estimate —
                                     # the defense against perceptual
                                     # aliasing (distinct places that look
                                     # identical can never become candidates
                                     # while drift stays bounded). inf = off.
) -> list[ClosureCandidate]:
    """Find validated loop closures of keyframe ``query_kf`` against all
    earlier keyframes (the _getLoopClosuresForKeyFrame pipeline,
    CTrackerGT.cpp:383-645).

    With ``probabilistic`` (and a DB that stores bit probabilities), the
    per-candidate matching stage uses expected-Hamming against the pooled
    bit-statistics under the probability cutoff (the CBPTree role,
    CBPTree.h:41-50): the exact-Hamming shortlist still places candidates,
    but only the absolute match floor gates them in — the relative gate
    (ref :479) moves to the noise-robust probabilistic match count. This
    keeps recall under photometric stress, where per-snapshot descriptors
    drift 25+ bits between revisits while the bit means stay aligned.
    """
    if query_kf < 1:
        return []
    use_prob = probabilistic and db.prob is not None
    n_q = db.count_of(query_kf)          # host mirror — no device read
    if n_q < min_matches:
        return []

    floor = max(min_matches, int(min_relative * n_q))
    kw = icp_kwargs or {}
    if db.bow is not None and db.bow.n > 0:
        # the default path: BoW scoring, temporal + metric gates, top-C
        # shortlist, exact counting, candidate selection, pool matching
        # (exact or probabilistic) and ICP validation all run as ONE
        # dispatch + ONE host read (closure_query_fused) — the split
        # pipeline paid two dispatches and two host reads per keyframe.
        C = max(4 * max_candidates, 8)
        lo_b = max(0, query_kf - exclude_recent)
        entry = min_matches if use_prob else floor
        fused = jax.device_get(closure_query_fused(
            db.bow.vocab.centroids, db.bow.vocab.child_valid,
            db.bow.vocab.weights, db.bow.vectors,
            jnp.int32(query_kf), db.desc, db.p_cam, db.valid,
            db.T_wc, jnp.int32(lo_b),
            jnp.float32(search_radius_m2), jnp.int32(entry),
            db.bow.vocab.k, C, max_candidates, hamming_cutoff,
            prob_db=db.prob if use_prob else None,
            prob_cutoff=prob_cutoff,
            icp_inlier_m2=kw.get("inlier_m2", 1.0),
            icp_min_inliers=kw.get("min_inliers", 25),
            icp_max_avg_error=kw.get("max_avg_error", 0.9),
            di_levels=direct_index_levels,
        ))
        match_floor = floor if use_prob else min_matches
        return _decode_fused(query_kf, match_floor, max_candidates, fused)
    if db.index is not None:
        # host-side tree shortlist (native CBITree/DBoW2 analog): per-query-
        # descriptor best-leaf vote counts per keyframe — same score
        # semantics as score_pools but sublinear in stored descriptors.
        # Votes are bounded to pre-exclusion keyframes so the query
        # keyframe's own (already-inserted) descriptors cannot shadow the
        # revisited one (the reference queries before adding, CTrackerGT:411)
        desc_q, valid_q = jax.device_get(
            (db.desc[query_kf], db.valid[query_kf]))
        q = desc_q[valid_q]
        votes = db.index.query(q, cutoff=hamming_cutoff,
                               max_keyframe=max(0, query_kf - exclude_recent))
        scores = np.zeros(db.desc.shape[0], np.int32)
        scores[: len(votes)] = votes
    else:
        scores = np.array(
            score_pools(db.desc[query_kf], db.valid[query_kf],
                        db.desc, db.valid, cutoff=hamming_cutoff)
        )
    # only earlier, temporally non-adjacent keyframes are eligible
    lo = max(0, query_kf - exclude_recent)
    scores[lo:] = 0
    # metric search-radius gate (ref CTrackerSV.h:89, radius check
    # CTrackerSV.cpp:980): camera centers of candidate and query must be
    # within sqrt(search_radius_m2) under the CURRENT (post-correction)
    # pose estimates. Host mirror: no device round trip per query.
    T_wc_np = db.poses_host()
    if np.isfinite(search_radius_m2):
        R_all = T_wc_np[: query_kf + 1, :3, :3]
        t_all = T_wc_np[: query_kf + 1, :3, 3]
        centers = -np.einsum("kji,kj->ki", R_all, t_all)
        d2 = np.sum((centers[:-1] - centers[-1]) ** 2, axis=-1)
        scores[: query_kf][d2 > search_radius_m2] = 0
    # relative-match gate (ref :479) + absolute floor. In probabilistic
    # mode only the absolute floor applies here; the relative gate is
    # enforced on the probabilistic match count after the match stage.
    entry = min_matches if use_prob else floor
    cand_idx = np.argsort(scores)[::-1][:max_candidates]
    cand_idx = [int(c) for c in cand_idx if scores[c] >= entry]
    if not cand_idx:
        return []

    # batched match + ICP validation over a FIXED candidate width (one
    # dispatch; padding repeats candidate 0 and is dropped on host)
    C = max_candidates
    n_cand = len(cand_idx)
    cand_pad = np.asarray(
        (cand_idx + [cand_idx[0]] * C)[:C], np.int32)
    T_init = (T_wc_np[query_kf][None]
              @ np.linalg.inv(T_wc_np[cand_pad].astype(np.float64))
              ).astype(np.float32)
    n_matches, T_qr, icp_ok, inliers, inl_mask, fwd = jax.device_get(
        match_pools_many(
            jnp.int32(query_kf), jnp.asarray(cand_pad),
            db.desc, db.p_cam, db.valid, jnp.asarray(T_init),
            cutoff=hamming_cutoff,
            icp_inlier_m2=kw.get("inlier_m2", 1.0),
            icp_min_inliers=kw.get("min_inliers", 25),
            icp_max_avg_error=kw.get("max_avg_error", 0.9),
            prob_db=db.prob if use_prob else None,
            prob_cutoff=prob_cutoff,
        )
    )

    match_floor = floor if use_prob else min_matches
    results = []
    for k in range(n_cand):
        c = int(cand_pad[k])
        if int(n_matches[k]) < match_floor or not bool(icp_ok[k]):
            continue
        # post-ICP inlier correspondences: the same inlier rule the
        # acceptance gates use (solvers.icp, ref CTrackerGT.cpp:524)
        slots_q = np.nonzero(inl_mask[k])[0].astype(np.int32)
        pairs = np.stack([slots_q, fwd[k][slots_q].astype(np.int32)], -1)
        results.append(
            ClosureCandidate(
                query_kf=query_kf,
                ref_kf=c,
                T_qr=T_qr[k],
                inliers=int(inliers[k]),
                matches=int(n_matches[k]),
                pairs=pairs,
            )
        )
    return results
