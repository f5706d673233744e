"""Loop-closure detection over binary descriptors (MILD-equivalent).

Device redesign of MILD's multi-index-hashed loop-closure database
(ref: 3rdparty/MILD/loop_closure_detector.cpp:94-132 construct,
:149-229 insert_and_query, :232+ query; wrapper
src/LCDetection/MildLCDetector.cpp:7-44). MILD's 16x16-bit hash tables
exist to avoid exhaustive hamming distances on a scalar CPU; on device the
database is one padded uint32 tensor (K, F, 8) and a query is a single
XOR + population_count broadcast — exact (no hash-miss recall loss).

Scoring is the reference's tf-idf-weighted similarity
(ref: loop_closure_detector.cpp:213-227): per query feature, every database
feature within hamming distance 64 contributes
exp(-max(d,10)^2/900) (`lut_feature_similarity`, :71-80 with
HAMMING_COVARIANCE=900, mild.hpp:33); the per-keyframe sums are normalised
by the feature's total energy and weighted by log(K / #keyframes-matched)
— repeated structure that matches everywhere is discounted.

Candidate selection uses the reference's salient score
(ref: 3rdparty/MILD/BayesianFilter.hpp:40-100 `calculateSalientScore`:
(sim - std) / mean over the pre-loop history, with the recent above-average
streak trimmed), threshold 1.5 and top MAX_CANDIDATES=7
(ref: src/LCDetection/MildLCDetector.cpp:7-40). The optional temporal
Bayesian filter (ref: BayesianFilter.hpp:103-172 `filter`) tracks per-
keyframe visit probabilities across queries with the reference's 0.95/0.05
transition model and retro-erases isolated detections.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

SALIENT_THRESHOLD = 1.5  # ref: MildLCDetector.h salient_score_threshold
MAX_CANDIDATES = 7  # ref: MildLCDetector.h max_candidate_num
# Absolute-evidence floor for candidacy. The reference gates at
# min_shared_score_threshold = 4 (ref: BayesianFilter.hpp:28) on its
# BUCKETED scores; the exhaustive device scan finds every sub-64-distance
# match, which inflates each feature's total energy and deflates its idf,
# compressing genuine-revisit scores to O(0.1-1). 0.05 keeps the gate's
# purpose (kill all-zero degenerate queries, where the salient formula
# returns 3.0 for everything) without vetoing real loops.
MIN_SHARED_SCORE = 0.05
HAMMING_THRESHOLD = 64  # ref: mild.hpp DEFAULT_HAMMING_DISTANCE_THRESHOLD
HAMMING_COVARIANCE = 900.0  # ref: mild.hpp:33
# energy floor = lut_feature_similarity[20] (ref: loop_closure_detector.cpp:214)
_ENERGY_FLOOR = math.exp(-20.0 * 20.0 / HAMMING_COVARIANCE)


@functools.partial(jax.jit, static_argnames=())
def _similarity_scores(
    q_desc: jax.Array,  # (N, 8) uint32
    q_valid: jax.Array,  # (N,)
    db_desc: jax.Array,  # (K, F, 8) uint32 (capacity-padded)
    db_valid: jax.Array,  # (K, F)
    num_keyframes: jax.Array | None = None,  # () actual K for the idf
) -> jax.Array:
    """(K,) tf-idf similarity of the query frame to each stored keyframe.

    Exhaustive-equivalent of `query_database` + `search_entry`
    (ref: loop_closure_detector.cpp:232+, :290-308): every db feature
    within distance 64 contributes its LUT similarity (the hash version
    misses pairs that share no bucket; the exhaustive scan is exact).
    """
    from ..ops import hamming as _h

    kdb = db_desc.shape[0] if num_keyframes is None else num_keyframes
    kk, ff = db_desc.shape[0], db_desc.shape[1]
    d = _h.hamming_table(q_desc, db_desc.reshape(kk * ff, 8)).reshape(
        -1, kk, ff
    ).astype(jnp.float32)  # (N, K, F) via one matmul
    sim = jnp.exp(-jnp.square(jnp.maximum(d, 10.0)) / HAMMING_COVARIANCE)
    sim = jnp.where(db_valid[None, :, :] & (d < HAMMING_THRESHOLD), sim, 0.0)
    fs = jnp.sum(sim, axis=-1)  # (N, K) feature_score
    # tf-idf (ref: loop_closure_detector.cpp:213-227)
    energy = _ENERGY_FLOOR + jnp.sum(fs, axis=-1, keepdims=True)  # (N, 1)
    simcount = jnp.maximum(1, jnp.sum((fs > 0).astype(jnp.int32), axis=-1))
    idf = jnp.log(jnp.maximum(1.0, kdb / simcount.astype(jnp.float32)))  # (N,)
    contrib = fs / energy * idf[:, None]
    return jnp.sum(jnp.where(q_valid[:, None], contrib, 0.0), axis=0)  # (K,)


@functools.partial(jax.jit, static_argnames=())
def _similarity_scores_batch(q_descs, q_valids, db_desc, db_valid, num_keyframes):
    """(Q, N, 8) queries -> (Q, K) scores; jitted lax.map (a bare lax.map
    outside jit executes semi-eagerly at ~30-50x the cost)."""
    return jax.lax.map(
        lambda qv: _similarity_scores(qv[0], qv[1], db_desc, db_valid, num_keyframes),
        (q_descs, q_valids),
    )


def salient_scores_device(sims: jax.Array, g: jax.Array) -> jax.Array:
    """Device (traceable) version of `salient_scores` over a CAPACITY-padded
    similarity vector: statistics over rows [0, g), same trailing-streak
    trim and degenerate-case handling as the host version.
    """
    n_cap = sims.shape[0]
    idx = jnp.arange(n_cap)
    m = (idx < g).astype(jnp.float32)
    gf = jnp.maximum(g.astype(jnp.float32), 1.0)
    avg = jnp.sum(sims * m) / gf
    # hist = largest index with sims[i] < avg (the reference slices [0:hist])
    below = (idx < g) & (sims < avg)
    hist = jnp.max(jnp.where(below, idx, -1))
    sm = (idx < hist).astype(jnp.float32)
    histf = jnp.maximum(hist.astype(jnp.float32), 1.0)
    mean = jnp.sum(sims * sm) / histf
    delta = jnp.sqrt(jnp.sum(sm * jnp.square(sims - mean))) / jnp.maximum(
        jnp.sqrt(histf - 1.0), 1.0
    )
    sal = (sims - delta) / jnp.maximum(mean, 1e-12)
    sal = jnp.where((mean < 1e-8) | (hist < 3), jnp.ones_like(sal), sal)
    return jnp.where(hist <= 0, jnp.full_like(sal, 3.0), sal)


def lc_candidates_device(
    q_desc: jax.Array,  # (F, 8) uint32
    q_valid: jax.Array,  # (F,)
    db_desc: jax.Array,  # (N_CAP, F, 8)
    db_valid: jax.Array,  # (N_CAP, F)
    g: jax.Array,  # () int32: DB rows < g participate in the statistics
    limit: jax.Array,  # () int32: candidate ordering restricted to idx < limit
    exclude: jax.Array,  # () int32: candidate index to skip (-1 for none)
    max_candidates: int = MAX_CANDIDATES,
) -> tuple[jax.Array, jax.Array]:
    """Fully on-device candidate selection for one keyframe query.

    Mirrors `select_candidates` (ref: MildLCDetector.cpp:7-40): tf-idf
    similarity over keyframes [0, g), salient filter (threshold 1.5),
    ordering restricted to indices < `limit` (g-1 for loop-closure edges —
    the immediately previous keyframe is the odometry partner — or g for
    relocalisation), top `max_candidates`. Returns (indices (M,),
    valid (M,)).
    """
    n_cap = db_desc.shape[0]
    idx = jnp.arange(n_cap)
    row_mask = idx < g
    sims = _similarity_scores(
        q_desc, q_valid, db_desc, db_valid & row_mask[:, None], num_keyframes=g
    )
    sal = salient_scores_device(sims, g)
    sal = jnp.where(sims < MIN_SHARED_SCORE, jnp.minimum(sal, 1.0), sal)
    order_mask = (idx < limit) & (idx != exclude)
    scores = jnp.where(order_mask, sal, -jnp.inf)
    vals, top = jax.lax.top_k(scores, max_candidates)
    return top, vals > SALIENT_THRESHOLD


def salient_scores(sims: np.ndarray) -> np.ndarray:
    """Reference `calculateSalientScore` (ref: BayesianFilter.hpp:40-100).

    Trims the trailing streak of above-average scores (the adjacent
    keyframes, which are naturally similar) from the statistics, then
    salient[i] = (sim[i] - std) / mean.
    """
    n = len(sims)
    if n == 0:
        return np.zeros(0, np.float32)
    avg = float(sims.mean())
    # history_loop = largest index with sims[i] < avg; the reference slices
    # [0:history_loop], EXCLUDING that element (ref loop + VectorXf sizing)
    hist = n - 1
    while hist >= 0 and sims[hist] >= avg:
        hist -= 1
    if hist <= 0:
        return np.full(n, 3.0, np.float32)  # all frames significant
    s = sims[:hist]
    mean = float(s.mean())
    if mean < 1e-8 or hist < 3:
        return np.ones(n, np.float32)
    delta = float(np.linalg.norm(s - s.mean()) / max(np.sqrt(hist - 1), 1.0))
    return ((sims - delta) / mean).astype(np.float32)


class BayesianTemporalFilter:
    """Sequential visit-probability filter (ref: BayesianFilter.hpp:103-172).

    Call `update(sims)` once per query (in keyframe order); returns the
    per-keyframe visit probabilities for the `len(sims) - min_distance`
    historical keyframes. Flags (prob > probability_threshold) are kept
    per step, and an isolated detection — flagged at step t but supported
    by neither t-1/t-2 nor t+1 in its +/-4 neighbourhood — is retro-erased,
    mirroring the reference's `privious_visit_flag` surgery.
    """

    TRANS = ((0.95, 0.05), (0.05, 0.95))

    def __init__(
        self,
        probability_threshold: float = 0.6,
        non_loop_closure_threshold: float = 4.0,
        min_shared_score_threshold: float = 4.0,
        min_distance: int = 1,
    ):
        # defaults: ref BayesianFilter.hpp:26-29
        self.probability_threshold = probability_threshold
        self.nlc = non_loop_closure_threshold
        self.min_shared = min_shared_score_threshold
        self.min_distance = min_distance
        self.prev_prob = np.zeros(0, np.float32)
        self.flags: list[np.ndarray] = []

    def update(self, sims: np.ndarray) -> np.ndarray:
        n = len(sims) - self.min_distance
        if n <= 0:
            return np.zeros(0, np.float32)
        s = np.asarray(sims[:n], np.float32)
        mean = float(s.mean())
        delta = float(np.linalg.norm(s - s.mean()) / max(np.sqrt(max(n - 1, 1)), 1.0))
        prob = np.zeros(n, np.float32)
        prev = self.prev_prob
        for i in range(n):
            sal = (s[i] - delta) / mean if mean >= 1e-8 else 1.0
            if s[i] < self.min_shared:
                sal = 1.0
            like = max(1.0, sal)
            lo = max(i - 2, 0)
            hi = min(len(prev) - 1, i + 3)
            alpha = float(prev[lo : hi + 1].max()) if hi >= lo and len(prev) else 0.0
            p1 = like * self.TRANS[1][0] * (1 - alpha) + like * self.TRANS[1][1] * alpha
            p2 = self.nlc * self.TRANS[0][0] * (1 - alpha) + self.nlc * self.TRANS[0][1] * alpha
            prob[i] = p1 / (p1 + p2)
        flags = (prob > self.probability_threshold).astype(np.int32)
        # retro-erasure of isolated detections (ref: BayesianFilter.hpp:139-166)
        if len(self.flags) >= 4:
            prev_f = self.flags[-1]
            rng = len(prev_f)
            i = 0
            while i < rng:
                if prev_f[i] > 0:
                    start = max(i - 4, 0)
                    while i < rng and prev_f[i] > 0:
                        i += 1
                    end = min(i + 4, max(rng - 3, start + 1))
                    if flags[start:end].max(initial=0) == 0:
                        p2f = self.flags[-3][start:end].max(initial=0)
                        p1f = self.flags[-2][start:end].max(initial=0)
                        if p2f + p1f < 2:
                            self.flags[-3][start:end] = 0
                            self.flags[-2][start:end] = 0
                            self.flags[-1][start:end] = 0
                i += 1
        self.prev_prob = prob
        self.flags.append(flags)
        return prob


class LoopClosureDetector:
    """Keyframe descriptor DB with salient-score candidate selection."""

    def __init__(
        self,
        feature_capacity: int = 512,
        initial_keyframes: int = 64,
        temporal: bool = False,
    ):
        self.fcap = feature_capacity
        self.kcap = initial_keyframes
        self.db = jnp.zeros((self.kcap, feature_capacity, 8), jnp.uint32)
        self.db_valid = jnp.zeros((self.kcap, feature_capacity), bool)
        self.num_keyframes = 0
        self.temporal = BayesianTemporalFilter() if temporal else None

    def insert(self, desc: jax.Array, valid: jax.Array) -> int:
        """Add a keyframe's descriptors; returns its index.

        (ref: loop_closure_detector.cpp construct_database / Insert wrapper.)
        """
        if self.num_keyframes == self.kcap:
            self.kcap *= 2
            self.db = jnp.zeros((self.kcap,) + self.db.shape[1:], jnp.uint32).at[
                : self.num_keyframes
            ].set(self.db)
            self.db_valid = jnp.zeros((self.kcap, self.fcap), bool).at[
                : self.num_keyframes
            ].set(self.db_valid)
        n = min(desc.shape[0], self.fcap)
        row = jnp.zeros((self.fcap, 8), jnp.uint32).at[:n].set(desc[:n])
        rowv = jnp.zeros((self.fcap,), bool).at[:n].set(valid[:n])
        k = self.num_keyframes
        self.db = self.db.at[k].set(row)
        self.db_valid = self.db_valid.at[k].set(rowv)
        self.num_keyframes += 1
        return k

    def similarity(self, desc: jax.Array, valid: jax.Array) -> np.ndarray:
        """(num_keyframes,) tf-idf similarity scores of a query frame.

        The query runs over the CAPACITY-padded DB (invalid rows masked) so
        the jitted kernel recompiles only when the capacity doubles, not on
        every insert — per-keyframe recompiles dominated the sparse
        systems' frame time.
        """
        k = self.num_keyframes
        if k == 0:
            return np.zeros(0, np.float32)
        sims = np.asarray(
            _similarity_scores(
                desc, valid, self.db, self.db_valid, jnp.int32(k)
            )
        )
        return sims[:k]

    def similarity_batch(self, descs: jax.Array, valids: jax.Array) -> np.ndarray:
        """(Q, num_keyframes) tf-idf scores for Q query frames in ONE
        dispatch + fetch (chunked systems batch their LC queries)."""
        k = self.num_keyframes
        if k == 0:
            return np.zeros((descs.shape[0], 0), np.float32)
        sims = np.asarray(
            _similarity_scores_batch(
                descs, valids, self.db, self.db_valid, jnp.int32(k)
            )
        )
        return sims[:, :k]

    def candidates_from_sims(self, sims: np.ndarray, limit: int) -> list[int]:
        """Candidate selection from precomputed similarity scores,
        considering only keyframes with index < limit."""
        if limit <= 0:
            return []
        # statistics over the FULL similarity vector (matching
        # select_candidates); only the candidate ordering is restricted to
        # indices < limit, so chunked and per-frame paths agree
        salient = salient_scores(sims)
        salient = np.where(sims < MIN_SHARED_SCORE, np.minimum(salient, 1.0), salient)
        order = np.argsort(-salient[:limit], kind="stable")
        return [int(i) for i in order[:MAX_CANDIDATES] if salient[i] > SALIENT_THRESHOLD]

    def select_candidates(
        self,
        desc: jax.Array,
        valid: jax.Array,
        exclude_recent: int = 1,
    ) -> list[int]:
        """Keyframe indices that are likely loop closures for this frame.

        (ref: MildLCDetector.cpp:7-40 `SelectCandidates` — salient score
        over the full database with recent-streak trimming, threshold 1.5,
        top 7.) `exclude_recent` drops the most recent keyframes from the
        returned list (callers track the previous keyframe separately).
        If the detector was built with `temporal=True`, the Bayesian filter
        state advances on every call.
        """
        k = self.num_keyframes
        if k <= exclude_recent:
            return []
        sims = self.similarity(desc, valid)
        salient = salient_scores(sims)
        # low absolute evidence cannot be a loop no matter how it compares
        # to the (possibly all-zero) history — the reference applies the
        # same clamp in its filter (ref: BayesianFilter.hpp:126-129)
        salient = np.where(sims < MIN_SHARED_SCORE, np.minimum(salient, 1.0), salient)
        if self.temporal is not None:
            self.temporal.update(sims)
        limit = k - exclude_recent
        order = np.argsort(-salient[:limit], kind="stable")
        return [
            int(i)
            for i in order[:MAX_CANDIDATES]
            if salient[i] > SALIENT_THRESHOLD
        ]
