"""Fully device-resident sparse SLAM: the whole FBAFusion chunk in ONE
dispatch + ONE small fetch.

Device redesign of the reference's FBAFusion system (ref:
example/FBAFusion/FBASlam.{h,cpp}, driver FBAFusion.cpp:10-105). The
host-loop rebuild (`systems/fbaslam.py`) already batches tracking into an
on-device scan, but still crosses the host<->device boundary ~6 times per
chunk (summary fetch, LC similarity, LC pair prep/track, pose-graph) and
issues dozens of small per-keyframe dispatches; that overhead capped the
sparse pipeline below the reference CPU. Here EVERYTHING lives on device:

  state (donated across chunks):
    - keyframe DB: batched SparseFrame (N_CAP keyframes x F features)
      doubling as the MILD descriptor database (lcdetection/mild.py)
    - keyframe poses (N_CAP, 4, 4) + pose-graph edge store (E_CAP edges x
      C correspondences)
    - previous-frame cache (retro-promotion), bootstrap/failure scalars

  per chunk (one jitted program):
    1. feature extraction for K frames          (lax.map)
    2. tracking scan with keyframe promotion    (lax.scan), including a
       cond-gated failure ladder that costs nothing when tracking is fine:
         rung A: re-track against the previous frame and retro-promote it
         rung B: LC relocalisation — candidate from the descriptor DB by
                 salient score, re-track against it (ref FBASlam.cpp:103-108)
    3. loop-closure candidate selection for every new keyframe
       (`lc_candidates_device`, while_loop over the actual count)
    4. LC pair tracking + edge append           (while_loop, actual count)
    5. pose-graph Gauss-Newton over ALL keyframes (optimization/posegraph)
    6. re-anchoring of the carried scalars

The host fetches one small pytree per chunk (per-frame anchors/relative
poses + the optimised keyframe poses) and never touches feature arrays.
Capacity growth (keyframes, edges) doubles the device arrays between
chunks; with the persistent compile cache each capacity compiles once
ever.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry.camera import PinholeCamera
from ..lcdetection import mild
from ..odometry import features as feat
from ..odometry import sparse
from ..optimization import posegraph
from .keyframe_slam import KEYFRAME_DISPARITY

MAX_EDGE_CORRS = 256
MAX_REPROJECTION_ERROR_3D = 0.05  # ref: KeyframeBasedSlam.h:58
DEFAULT_HYPOTHESES = 256  # batched RANSAC; ref runs 400 iters WITH early
# exit (SparseOdometryFunction.cpp:37-39) — 256 simultaneous hypotheses
# match its effective sampling power at half the batched cost
REBASE_AFTER = 3  # consecutive failures before re-bootstrapping a keyframe
REMATCH_BELOW = 80  # odometry tracks skip the pose-guided re-match round
# when round 1 already has this many inliers (the reference re-matches
# unconditionally, SparseMatcher.cpp:25-50; at 80+ inliers the pose is
# already over-determined 26x and the second match+RANSAC chain buys
# nothing — LC pair tracking still always re-matches)


class EdgeStore(NamedTuple):
    """Device-resident pose-graph edge arrays (capacity E_CAP).

    `src_i`/`dst_j` carry the KEYPOINT indices behind each compacted
    correspondence (source keypoint row, matched target keypoint row) so
    downstream consumers — the full-BA track linker in systems/fused_ba.py
    (ref: example/BAFusion/BASlam.cpp:89-150 local->global index maps) —
    can join edges back to the keyframe DB without refetching matches."""

    src: jax.Array  # (E,) int32
    dst: jax.Array  # (E,) int32
    p_src: jax.Array  # (E, C, 3)
    p_dst: jax.Array  # (E, C, 3)
    valid: jax.Array  # (E, C) bool
    src_i: jax.Array  # (E, C) int32 source keypoint index per corr
    dst_j: jax.Array  # (E, C) int32 matched target keypoint index
    num: jax.Array  # () int32
    overflow: jax.Array  # () int32


class SparseDevState(NamedTuple):
    """Whole sparse-SLAM state on device; donated every chunk."""

    kf: sparse.SparseFrame  # batched leaves (N_CAP, ...)
    kf_pose: jax.Array  # (N_CAP, 4, 4) world-from-keyframe
    num_kf: jax.Array  # () int32
    cur_kf: jax.Array  # () int32 index tracked against
    edges: EdgeStore
    last_T: jax.Array  # (4, 4) last frame's world pose
    last_anchor: jax.Array  # () int32
    last_Trel: jax.Array  # (4, 4)
    prev: sparse.SparseFrame  # previous frame (single)
    prev_ok: jax.Array  # () bool: prev tracked fine AND is not a keyframe
    prev_anchor: jax.Array  # () int32 keyframe prev tracked against
    prev_Trel: jax.Array  # (4, 4) anchor-relative pose of prev
    prev_psrc: jax.Array  # (C, 3) compacted correspondences of prev
    prev_pdst: jax.Array  # (C, 3)
    prev_pval: jax.Array  # (C,)
    prev_si: jax.Array  # (C,) int32 source keypoint index per corr
    prev_dj: jax.Array  # (C,) int32 matched target keypoint index
    fail_streak: jax.Array  # () int32 consecutive tracking failures


class SparseChunkOut(NamedTuple):
    """Per-chunk fetch: everything the host trajectory needs, nothing else."""

    T_rel: jax.Array  # (K, 4, 4) anchor-relative pose per frame
    anchor: jax.Array  # (K,) int32 keyframe index per frame
    ok: jax.Array  # (K,) bool
    is_kf: jax.Array  # (K,) bool
    retro: jax.Array  # (K,) bool: prev frame retro-promoted here
    reloc: jax.Array  # (K,) bool: frame recovered via LC relocalisation
    rmse: jax.Array  # (K,)
    disparity: jax.Array  # (K,)
    kf_pose: jax.Array  # (N_CAP, 4, 4) post-optimisation
    num_kf: jax.Array  # ()
    num_edges: jax.Array  # ()
    edge_overflow: jax.Array  # ()
    lc_pairs: jax.Array  # () candidates tracked this chunk
    lc_edges: jax.Array  # () loop edges appended this chunk


def _zero_frame(f: int) -> sparse.SparseFrame:
    kp = feat.Keypoints(
        uv=jnp.zeros((f, 2), jnp.float32),
        score=jnp.zeros((f,), jnp.float32),
        angle=jnp.zeros((f,), jnp.float32),
        desc=jnp.zeros((f, 8), jnp.uint32),
        valid=jnp.zeros((f,), bool),
    )
    return sparse.SparseFrame(kp, jnp.zeros((f, 3), jnp.float32), jnp.zeros((f,), bool))


def make_state(n_cap: int, e_cap: int, corr_cap: int, f: int) -> SparseDevState:
    zf = _zero_frame(f)

    def eye():  # fresh buffer each use: the state is donated as a whole,
        # and donating one buffer through two leaves is an error
        return jnp.eye(4, dtype=jnp.float32) + jnp.zeros((4, 4), jnp.float32)

    return SparseDevState(
        kf=jax.tree.map(lambda a: jnp.broadcast_to(a[None], (n_cap,) + a.shape).copy(), zf),
        kf_pose=jnp.broadcast_to(eye()[None], (n_cap, 4, 4)).copy(),
        num_kf=jnp.int32(0),
        cur_kf=jnp.int32(0),
        edges=EdgeStore(
            src=jnp.zeros((e_cap,), jnp.int32),
            dst=jnp.zeros((e_cap,), jnp.int32),
            p_src=jnp.zeros((e_cap, corr_cap, 3), jnp.float32),
            p_dst=jnp.zeros((e_cap, corr_cap, 3), jnp.float32),
            valid=jnp.zeros((e_cap, corr_cap), bool),
            src_i=jnp.zeros((e_cap, corr_cap), jnp.int32),
            dst_j=jnp.zeros((e_cap, corr_cap), jnp.int32),
            num=jnp.int32(0),
            overflow=jnp.int32(0),
        ),
        last_T=eye(),
        last_anchor=jnp.int32(0),
        last_Trel=eye(),
        prev=jax.tree.map(lambda a: a.copy(), zf),
        prev_ok=jnp.bool_(False),
        prev_anchor=jnp.int32(0),
        prev_Trel=eye(),
        prev_psrc=jnp.zeros((corr_cap, 3), jnp.float32),
        prev_pdst=jnp.zeros((corr_cap, 3), jnp.float32),
        prev_pval=jnp.zeros((corr_cap,), bool),
        prev_si=jnp.zeros((corr_cap,), jnp.int32),
        prev_dj=jnp.zeros((corr_cap,), jnp.int32),
        fail_streak=jnp.int32(0),
    )


def _inv(T):
    R = T[:3, :3]
    t = T[:3, 3]
    out = jnp.eye(4, dtype=T.dtype)
    out = out.at[:3, :3].set(R.T)
    return out.at[:3, 3].set(-R.T @ t)


def _compact_corr(corr_src, corr_dst, corr_valid, corr_idx, c):
    """First `c` valid correspondences (order-preserving), fixed shape.

    Returns (src_pts, dst_pts, valid, src_kp_idx, dst_kp_idx): the corr
    arrays are indexed by SOURCE keypoint row, so the compaction index is
    itself the source keypoint index and `corr_idx` gathers the matched
    target keypoint."""
    (ci,) = jnp.nonzero(corr_valid, size=c, fill_value=0)
    cnt = jnp.sum(corr_valid.astype(jnp.int32))
    cv = jnp.arange(c) < cnt
    return (
        corr_src[ci], corr_dst[ci], cv,
        ci.astype(jnp.int32), corr_idx[ci].astype(jnp.int32),
    )


def _append_edge(edges: EdgeStore, cond, src, dst, ps, pd, pv, si, dj) -> EdgeStore:
    e_cap = edges.src.shape[0]
    fits = cond & (edges.num < e_cap)
    w = jnp.where(fits, edges.num, e_cap)  # e_cap = drop
    return EdgeStore(
        src=edges.src.at[w].set(src, mode="drop"),
        dst=edges.dst.at[w].set(dst, mode="drop"),
        p_src=edges.p_src.at[w].set(ps, mode="drop"),
        p_dst=edges.p_dst.at[w].set(pd, mode="drop"),
        valid=edges.valid.at[w].set(pv, mode="drop"),
        src_i=edges.src_i.at[w].set(si, mode="drop"),
        dst_j=edges.dst_j.at[w].set(dj, mode="drop"),
        num=edges.num + fits.astype(jnp.int32),
        overflow=edges.overflow + (cond & ~fits).astype(jnp.int32),
    )


def _write_kf(kf_db, kf_pose, cond, idx, frame, pose):
    n_cap = kf_pose.shape[0]
    w = jnp.where(cond, idx, n_cap)
    kf_db = jax.tree.map(
        lambda db, row: db.at[w].set(row, mode="drop"), kf_db, frame
    )
    return kf_db, kf_pose.at[w].set(pose, mode="drop")


def _zero_track(f: int, c_corr: int):
    """Zero-filled (SparseTrackingResult, TrackingSummary) for cond elses."""
    eye = jnp.eye(4, dtype=jnp.float32)
    res = sparse.SparseTrackingResult(
        T_ts=eye,
        num_inliers=jnp.int32(0),
        rmse=jnp.float32(jnp.inf),
        success=jnp.bool_(False),
        corr_src=jnp.zeros((f, 3), jnp.float32),
        corr_dst=jnp.zeros((f, 3), jnp.float32),
        corr_valid=jnp.zeros((f,), bool),
        corr_idx=jnp.zeros((f,), jnp.int32),
    )
    summ = sparse.TrackingSummary(
        T_ts=eye,
        success=jnp.bool_(False),
        rmse=jnp.float32(jnp.inf),
        num_inliers=jnp.int32(0),
        disparity=jnp.float32(0.0),
    )
    return res, summ


def _sparse_chunk_body(
    state: SparseDevState,
    grays: jax.Array,  # (K, H, W)
    depths: jax.Array,  # (K, H, W)
    frame_valid: jax.Array,  # (K,) bool — padding mask
    key: jax.Array,
    camera: PinholeCamera,
    max_keypoints: int = 1000,
    threshold: float = 0.01,
    keyframe_disparity: float = KEYFRAME_DISPARITY,
    num_hypotheses: int = DEFAULT_HYPOTHESES,
    gn_iters: int = posegraph.DEFAULT_ITERS,
) -> tuple[SparseDevState, SparseChunkOut]:
    """Traceable chunk body — jitted standalone below, and inlined into
    larger per-chunk programs (systems/fused_ba.py fuses the track linker
    + full BA into the SAME dispatch to halve per-chunk blocking round
    trips)."""
    k = grays.shape[0]
    f = state.kf.points.shape[1]
    c_corr = state.edges.p_src.shape[1]
    n_cap = state.kf_pose.shape[0]
    thr = jnp.float32(keyframe_disparity)
    eye = jnp.eye(4, dtype=jnp.float32)

    # ---- 1. feature extraction: whole chunk in ONE batched program --------
    # (chunk-wide ops + flat global-index gathers; padding frames compute
    # garbage alongside the real ones and are masked out below — cheaper
    # than the per-frame cond'd lax.map it replaces, whose ~60 small-kernel
    # launches per frame dominated the sparse budget)
    frames = sparse.extract_sparse_frames_batch(
        grays, depths, camera, max_keypoints=max_keypoints, threshold=threshold
    )
    fvcol = frame_valid[:, None]
    frames = sparse.SparseFrame(
        kp=frames.kp._replace(valid=frames.kp.valid & fvcol),
        points=frames.points,
        valid=frames.valid & fvcol,
    )

    # ---- 2. tracking scan with promotion + failure ladder -----------------
    def body(carry, xs):
        st, key = carry
        frame_i, fv = xs
        key, k1, k2, k3 = jax.random.split(key, 4)

        # bootstrap: very first valid frame becomes keyframe 0 at identity
        boot = fv & (st.num_kf == 0)

        kf_frame = jax.tree.map(lambda a: a[st.cur_kf], st.kf)
        res0, summ0 = jax.lax.cond(
            fv & ~boot,
            lambda _: sparse._track_summary_inner(
                k1, kf_frame, frame_i, camera, num_hypotheses,
                rematch_below=REMATCH_BELOW,
            ),
            lambda _: _zero_track(f, c_corr),
            None,
        )
        ok0 = fv & ~boot & summ0.success

        # rung A: re-track against the previous (non-keyframe) frame
        need_a = fv & ~boot & ~ok0 & st.prev_ok
        res_a, summ_a = jax.lax.cond(
            need_a,
            lambda _: sparse._track_summary_inner(
                k2, st.prev, frame_i, camera, num_hypotheses,
                rematch_below=REMATCH_BELOW,
            ),
            lambda _: _zero_track(f, c_corr),
            None,
        )
        # guard: no promotion past the DB capacity (host grows proactively;
        # this only protects against a pathological all-keyframe chunk)
        use_a = need_a & summ_a.success & (st.num_kf < n_cap)

        # rung B: LC relocalisation against the best salient candidate
        need_b = fv & ~boot & ~ok0 & ~use_a & (st.num_kf >= 3)

        def rung_b(_):
            cand, _cok = mild.lc_candidates_device(
                frame_i.kp.desc, frame_i.valid, st.kf.kp.desc,
                st.kf.valid, g=st.num_kf, limit=st.num_kf,
                exclude=jnp.int32(-1),
            )
            # for RELOCALISATION the salient gate (tuned to limit false LC
            # edges) is dropped: when lost, try the best-scoring keyframe
            # unconditionally — tracking success is the safety check
            c0 = cand[0]
            kf_c = jax.tree.map(lambda a: a[c0], st.kf)
            res_b, summ_b = sparse._track_summary_inner(
                k3, kf_c, frame_i, camera, num_hypotheses
            )
            return c0, summ_b.success, res_b, summ_b

        c0, okb, res_b, summ_b = jax.lax.cond(
            need_b,
            rung_b,
            lambda _: (jnp.int32(0), jnp.bool_(False)) + _zero_track(f, c_corr),
            None,
        )
        use_b = need_b & okb

        # retro-promotion of prev (rung A success): prev becomes a keyframe
        new_idx_a = st.num_kf
        prev_T = st.kf_pose[st.prev_anchor] @ st.prev_Trel
        kf_db, kf_pose = _write_kf(
            st.kf, st.kf_pose, use_a, new_idx_a, st.prev, prev_T
        )
        edges = _append_edge(
            st.edges, use_a, st.prev_anchor, new_idx_a,
            st.prev_psrc, st.prev_pdst, st.prev_pval,
            st.prev_si, st.prev_dj,
        )
        num_kf = st.num_kf + use_a.astype(jnp.int32)
        promo_a = jnp.where(use_a, new_idx_a, -1)
        promo_a_src = st.prev_anchor

        # effective tracking result (main | rung A | rung B)
        ok = ok0 | use_a | use_b
        anchor = jnp.where(
            use_a, new_idx_a, jnp.where(use_b, c0, st.cur_kf)
        )

        def pick(m_a, a, m_b, b, base):
            return jnp.where(m_a, a, jnp.where(m_b, b, base))

        T_ts = pick(use_a, summ_a.T_ts, use_b, summ_b.T_ts, summ0.T_ts)
        rmse = pick(use_a, summ_a.rmse, use_b, summ_b.rmse, summ0.rmse)
        disp = pick(use_a, summ_a.disparity, use_b, summ_b.disparity, summ0.disparity)
        csrc = pick(use_a[..., None, None], res_a.corr_src, use_b[..., None, None], res_b.corr_src, res0.corr_src)
        cdst = pick(use_a[..., None, None], res_a.corr_dst, use_b[..., None, None], res_b.corr_dst, res0.corr_dst)
        cval = pick(use_a[..., None], res_a.corr_valid, use_b[..., None], res_b.corr_valid, res0.corr_valid)
        cidx = pick(use_a[..., None], res_a.corr_idx, use_b[..., None], res_b.corr_idx, res0.corr_idx)
        psrc_c, pdst_c, pval_c, si_c, dj_c = _compact_corr(csrc, cdst, cval, cidx, c_corr)

        anchor_pose = kf_pose[anchor]
        T_world = jnp.where(ok, anchor_pose @ _inv(T_ts), st.last_T)
        T_world = jnp.where(boot, eye, T_world)

        # rung C: re-bootstrap after persistent failure — when every
        # recovery path has failed REBASE_AFTER consecutive frames and the
        # current frame has enough features, promote it as a fresh keyframe
        # at the carried pose so tracking resumes against a NEARBY frame.
        # No pose-graph edge is added (there is no correspondence); the LC
        # stage queries the new keyframe, so a later revisit of mapped
        # territory re-links it to the graph. (The reference hard-exits
        # here, ref FBASlam.cpp:124-128 — a production system must not.)
        rebase = (
            fv & ~boot & ~ok & (st.fail_streak >= REBASE_AFTER)
            & (jnp.sum(frame_i.valid.astype(jnp.int32)) >= sparse.MIN_INLIERS)
            & (num_kf < n_cap)
        )

        # keyframe promotion (disparity trigger, ref FBASlam.cpp:32-41)
        is_kf = boot | rebase | (ok & (disp >= thr) & (num_kf < n_cap))
        new_idx = num_kf
        kf_db, kf_pose = _write_kf(kf_db, kf_pose, is_kf, new_idx, frame_i, T_world)
        edges = _append_edge(
            edges, is_kf & ~boot & ~rebase, anchor, new_idx,
            psrc_c, pdst_c, pval_c, si_c, dj_c,
        )
        num_kf = num_kf + is_kf.astype(jnp.int32)
        promo_b = jnp.where(is_kf & ~boot, new_idx, -1)
        promo_b_src = anchor
        cur_kf = jnp.where(is_kf, new_idx, anchor)

        anchor_out = jnp.where(is_kf, new_idx, anchor)
        T_rel = jnp.where(is_kf, eye, _inv(anchor_pose) @ T_world)
        ok_out = ok | boot

        st = st._replace(
            kf=kf_db, kf_pose=kf_pose, num_kf=num_kf, cur_kf=cur_kf,
            edges=edges,
            last_T=jnp.where(fv, T_world, st.last_T),
            last_anchor=jnp.where(fv, anchor_out, st.last_anchor),
            last_Trel=jnp.where(fv, T_rel, st.last_Trel),
            prev=jax.tree.map(
                lambda new, old: jnp.where(
                    jnp.reshape(fv, (1,) * old.ndim), new, old
                ), frame_i, st.prev,
            ),
            prev_ok=jnp.where(fv, ok_out & ~is_kf, st.prev_ok),
            prev_anchor=jnp.where(fv, anchor, st.prev_anchor),
            prev_Trel=jnp.where(fv, T_rel, st.prev_Trel),
            prev_psrc=jnp.where(fv, psrc_c, st.prev_psrc),
            prev_pdst=jnp.where(fv, pdst_c, st.prev_pdst),
            prev_pval=jnp.where(fv, pval_c, st.prev_pval),
            prev_si=jnp.where(fv, si_c, st.prev_si),
            prev_dj=jnp.where(fv, dj_c, st.prev_dj),
            fail_streak=jnp.where(
                fv,
                jnp.where(ok_out | rebase, 0, st.fail_streak + 1),
                st.fail_streak,
            ),
        )
        out = (
            T_rel, anchor_out, ok_out, is_kf, use_a, use_b, rmse, disp,
            promo_a, promo_a_src, promo_b, promo_b_src,
        )
        return (st, key), out

    (st, key), outs = jax.lax.scan(body, (state, key), (frames, frame_valid))
    (T_rel_o, anchor_o, ok_o, iskf_o, retro_o, reloc_o, rmse_o, disp_o,
     pa, pa_src, pb, pb_src) = outs

    # ---- 3. LC candidate selection for every new keyframe -----------------
    promo = jnp.concatenate([pa, pb])  # (2K,)
    promo_src = jnp.concatenate([pa_src, pb_src])
    (pidx,) = jnp.nonzero(promo >= 0, size=2 * k, fill_value=0)
    n_promo = jnp.sum((promo >= 0).astype(jnp.int32))

    m = mild.MAX_CANDIDATES
    pair_cand = jnp.zeros((2 * k * m,), jnp.int32)
    pair_g = jnp.zeros((2 * k * m,), jnp.int32)
    pair_ok = jnp.zeros((2 * k * m,), bool)

    def lc_q_body(carry):
        q, pc, pg, po = carry
        g = promo[pidx[q]]
        src_ex = promo_src[pidx[q]]
        qd = st.kf.kp.desc[g]
        qv = st.kf.valid[g]
        cand, cok = mild.lc_candidates_device(
            qd, qv, st.kf.kp.desc, st.kf.valid,
            g=g, limit=g - 1, exclude=src_ex,
        )
        sl = q * m
        pc = jax.lax.dynamic_update_slice(pc, cand, (sl,))
        pg = jax.lax.dynamic_update_slice(pg, jnp.full((m,), g, jnp.int32), (sl,))
        po = jax.lax.dynamic_update_slice(po, cok, (sl,))
        return q + 1, pc, pg, po

    _, pair_cand, pair_g, pair_ok = jax.lax.while_loop(
        lambda c: c[0] < n_promo, lc_q_body,
        (jnp.int32(0), pair_cand, pair_g, pair_ok),
    )

    # ---- 4. LC pair tracking + edge append (actual count only) ------------
    (qi,) = jnp.nonzero(pair_ok, size=2 * k * m, fill_value=0)
    n_pairs = jnp.sum(pair_ok.astype(jnp.int32))

    def lc_p_body(carry):
        p, edges, key, n_added = carry
        key, kk = jax.random.split(key)
        c = pair_cand[qi[p]]
        g = pair_g[qi[p]]
        kf_c = jax.tree.map(lambda a: a[c], st.kf)
        kf_g = jax.tree.map(lambda a: a[g], st.kf)
        res_p, summ_p = sparse._track_summary_inner(
            kk, kf_c, kf_g, camera, num_hypotheses
        )
        succ = summ_p.success & (summ_p.rmse < MAX_REPROJECTION_ERROR_3D)
        ps, pd, pv, si, dj = _compact_corr(
            res_p.corr_src, res_p.corr_dst, res_p.corr_valid, res_p.corr_idx, c_corr
        )
        edges = _append_edge(edges, succ, c, g, ps, pd, pv, si, dj)
        return p + 1, edges, key, n_added + succ.astype(jnp.int32)

    _, edges, key, lc_added = jax.lax.while_loop(
        lambda c: c[0] < n_pairs, lc_p_body,
        (jnp.int32(0), st.edges, key, jnp.int32(0)),
    )
    st = st._replace(edges=edges)

    # ---- 5. pose-graph Gauss-Newton (ref FBASlam.cpp:140-147 Optimize) ----
    def run_gn(kf_pose):
        e = st.edges
        ev = jnp.arange(e.src.shape[0]) < e.num
        pg_edges = posegraph.PoseGraphEdges(
            e.src, e.dst, e.p_src, e.p_dst, e.valid, ev
        )
        opt, _ = posegraph.optimize_pose_graph(kf_pose, pg_edges, iters=gn_iters)
        return opt

    kf_pose = jax.lax.cond(
        (n_promo > 0) & (st.num_kf >= 2) & (st.edges.num > 0),
        run_gn, lambda p: p, st.kf_pose,
    )

    # ---- 6. re-anchor carried scalars to the optimised poses --------------
    st = st._replace(
        kf_pose=kf_pose,
        last_T=kf_pose[st.last_anchor] @ st.last_Trel,
    )

    out = SparseChunkOut(
        T_rel=T_rel_o, anchor=anchor_o, ok=ok_o, is_kf=iskf_o,
        retro=retro_o, reloc=reloc_o, rmse=rmse_o, disparity=disp_o,
        kf_pose=kf_pose, num_kf=st.num_kf, num_edges=st.edges.num,
        edge_overflow=st.edges.overflow, lc_pairs=n_pairs, lc_edges=lc_added,
    )
    return st, out


fused_sparse_chunk = functools.partial(
    jax.jit,
    static_argnames=(
        "camera", "max_keypoints", "threshold", "keyframe_disparity",
        "num_hypotheses", "gn_iters",
    ),
    donate_argnums=(0,),
)(_sparse_chunk_body)


def _grow_axis0(tree, pad_rows: int):
    """Pad every leaf with `pad_rows` zero rows along axis 0."""
    def pad(a):
        padding = [(0, pad_rows)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, padding)
    return jax.tree.map(pad, tree)


@dataclasses.dataclass
class FusedFBASlam:
    """Host driver: sparse keyframe SLAM with one fetch per chunk.

    API mirrors `systems.fbaslam.FBASlam` (`process_chunk`, `trajectory`)
    but keeps keyframes, edges, and the descriptor DB on device. The host
    stores only per-frame (anchor, relative-pose) records and the latest
    fetched keyframe poses for trajectory assembly (the reference's
    `UpdateAllPoses` re-anchoring, ref: KeyframeBasedSlam.h:36-45).
    """

    camera: PinholeCamera
    max_keypoints: int = 1000
    fast_threshold: float = 0.01
    keyframe_disparity: float = KEYFRAME_DISPARITY
    num_hypotheses: int = DEFAULT_HYPOTHESES
    kf_capacity: int = 64
    edge_capacity: int = 512
    corr_capacity: int = MAX_EDGE_CORRS

    def __post_init__(self):
        self._state = make_state(
            self.kf_capacity, self.edge_capacity, self.corr_capacity,
            self.max_keypoints,
        )
        self.frame_count = 0
        self.num_kf = 0
        self.num_edges = 0
        self.edge_overflow = 0
        self.lc_edges_total = 0
        self._anchors: list[int] = []
        self._Trels: list[np.ndarray] = []
        self._ok: list[bool] = []
        self._iskf: list[bool] = []
        self._kf_pose = np.tile(np.eye(4, dtype=np.float32), (self.kf_capacity, 1, 1))
        self._rng = np.random.default_rng(0)

    # -- capacity management -------------------------------------------------

    def _maybe_grow(self, next_k: int) -> None:
        """Double device capacities when the next chunk could overflow them.

        One recompile per doubling (cached persistently)."""
        st = self._state
        # `while`, not `if`: a chunk larger than half the current capacity
        # needs more than one doubling, and an under-provisioned DB silently
        # stops promoting keyframes mid-chunk (the in-scan guard)
        while self.num_kf + 2 * next_k + 2 > self.kf_capacity:
            st = st._replace(
                kf=_grow_axis0(st.kf, self.kf_capacity),
                kf_pose=jnp.concatenate(
                    [st.kf_pose,
                     jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32)[None],
                                      (self.kf_capacity, 4, 4))]
                ),
            )
            self.kf_capacity *= 2
        # worst case per chunk: 2K promotions x (1 odometry + 7 LC) edges
        while self.num_edges + 2 * next_k * (mild.MAX_CANDIDATES + 1) > self.edge_capacity:
            e = st.edges
            st = st._replace(
                edges=EdgeStore(
                    src=jnp.pad(e.src, (0, self.edge_capacity)),
                    dst=jnp.pad(e.dst, (0, self.edge_capacity)),
                    p_src=jnp.pad(e.p_src, ((0, self.edge_capacity), (0, 0), (0, 0))),
                    p_dst=jnp.pad(e.p_dst, ((0, self.edge_capacity), (0, 0), (0, 0))),
                    valid=jnp.pad(e.valid, ((0, self.edge_capacity), (0, 0))),
                    src_i=jnp.pad(e.src_i, ((0, self.edge_capacity), (0, 0))),
                    dst_j=jnp.pad(e.dst_j, ((0, self.edge_capacity), (0, 0))),
                    num=e.num, overflow=e.overflow,
                )
            )
            self.edge_capacity *= 2
        self._state = st

    # -- main entry ----------------------------------------------------------

    def process_chunk(self, grays, depths) -> dict:
        """Process K frames; pads to a power-of-two scan length so each
        distinct chunk size compiles (and caches) one executable."""
        grays = jnp.asarray(grays, jnp.float32)
        depths = jnp.asarray(depths, jnp.float32)
        k = int(grays.shape[0])
        if k == 0:
            return {"frames": self.frame_count, "keyframes": self.num_kf}
        k_pad = max(8, 1 << (k - 1).bit_length())
        if k_pad != k:
            pad = ((0, k_pad - k), (0, 0), (0, 0))
            grays = jnp.pad(grays, pad)
            depths = jnp.pad(depths, pad)
        fvalid = jnp.arange(k_pad) < k
        self._maybe_grow(k_pad)
        key = jax.random.PRNGKey(int(self._rng.integers(0, 2**31)))
        self._state, out = fused_sparse_chunk(
            self._state, grays, depths, fvalid, key, self.camera,
            max_keypoints=self.max_keypoints, threshold=self.fast_threshold,
            keyframe_disparity=self.keyframe_disparity,
            num_hypotheses=self.num_hypotheses,
        )
        h = jax.device_get(out)  # the ONE per-chunk fetch
        self.frame_count += k
        self.num_kf = int(h.num_kf)
        self.num_edges = int(h.num_edges)
        self.edge_overflow = int(h.edge_overflow)
        self.lc_edges_total += int(h.lc_edges)
        self._kf_pose = np.asarray(h.kf_pose)
        for i in range(k):
            self._anchors.append(int(h.anchor[i]))
            self._Trels.append(np.asarray(h.T_rel[i]))
            self._ok.append(bool(h.ok[i]))
            self._iskf.append(bool(h.is_kf[i]))
        return {
            "frames": self.frame_count, "keyframes": self.num_kf,
            "edges": self.num_edges, "lc_pairs": int(h.lc_pairs),
            "relocs": int(np.sum(h.reloc)), "retro": int(np.sum(h.retro)),
        }

    def trajectory(self) -> np.ndarray:
        """Per-frame world poses, re-anchored to the latest keyframe poses."""
        n = len(self._anchors)
        if n == 0:
            return np.zeros((0, 4, 4), np.float32)
        anchors = np.asarray(self._anchors)
        trels = np.stack(self._Trels)
        return np.einsum("nij,njk->nik", self._kf_pose[anchors], trels)
