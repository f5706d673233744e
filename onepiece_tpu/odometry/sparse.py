"""Sparse feature-based RGB-D odometry.

Device redesign of `Odometry::SparseTracking(MILD)` (ref:
src/Odometry/Odometry.cpp:91-168 (BF), :170-252 / :351-435 (MILD variant)):
detect ORB-style features, match descriptors (exhaustive hamming replaces
MILD's multi-index hash), filter outliers (validity / pairwise-consistency
RanSaPC), estimate the rigid transform with batched RANSAC over 3D-3D
correspondences, then pose-guided re-match and re-estimate.

Pipeline stages are individually jitted; the orchestration (two match
rounds) is host-side like the reference but with no per-feature loops.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3
from ..geometry.camera import PinholeCamera
from ..ops import hamming, image as image_ops, ransac
from . import features as feat

# reference thresholds (ref: src/Odometry/Odometry.cpp SparseTrackingMILD and
# SparseOdometryFunction.cpp RANSAC3d)
RANSAC_THRESHOLD = 0.01  # depth-normalised (ref: OdometryPredefined.h
# REPROJECTION_ERROR_3D_THRESHOLD = 0.01; gate is ||Tp - q|| / z)
RANSAC_HYPOTHESES = 400
RANSAC_SAMPLES = 8
RANSAPC_ROUNDS = 5  # ref: Odometry.cpp:400-404 applies RanSaPC 5x
MIN_INLIERS = 20


class SparseFrame(NamedTuple):
    """Per-frame sparse data: keypoints + backprojected 3D points."""

    kp: feat.Keypoints
    points: jax.Array  # (K, 3) camera-frame 3D points at keypoints
    valid: jax.Array  # (K,) keypoint has valid depth


class SparseTrackingResult(NamedTuple):
    T_ts: jax.Array  # (4, 4) source -> target
    num_inliers: jax.Array
    rmse: jax.Array
    success: jax.Array  # bool
    corr_src: jax.Array  # (K, 3) matched source points (masked)
    corr_dst: jax.Array  # (K, 3) matched target points
    corr_valid: jax.Array  # (K,)
    corr_idx: jax.Array  # (K,) matched TARGET keypoint index per source kp


@functools.partial(jax.jit, static_argnames=("camera", "max_keypoints", "threshold"))
def extract_sparse_frame(
    gray: jax.Array,
    depth: jax.Array,
    camera: PinholeCamera,
    max_keypoints: int = 1000,
    threshold: float = 0.05,
) -> SparseFrame:
    """Detect features and backproject them with the depth image.

    (ref: Odometry.cpp:66-85 `GetLocalPointsFromKeyPoints`.)
    """
    kp = feat.detect_and_describe(gray, max_keypoints=max_keypoints, threshold=threshold)
    ui = jnp.clip(jnp.round(kp.uv[:, 0]), 0, camera.width - 1).astype(jnp.int32)
    vi = jnp.clip(jnp.round(kp.uv[:, 1]), 0, camera.height - 1).astype(jnp.int32)
    z = depth[vi, ui]
    pts = camera.backproject(kp.uv, z)
    valid = kp.valid & (z > 0)
    return SparseFrame(kp, pts, valid)


@functools.partial(
    jax.jit, static_argnames=("camera", "num_hypotheses", "rematch_below")
)
def _match_and_estimate(
    key: jax.Array,
    source: SparseFrame,
    target: SparseFrame,
    camera: PinholeCamera,
    num_hypotheses: int = RANSAC_HYPOTHESES,
    rematch_below: int | None = None,
) -> SparseTrackingResult:
    # round 1: descriptor match + ratio test
    idx, ok = hamming.match_descriptors(
        source.kp.desc, source.valid, target.kp.desc, target.valid
    )
    src_pts = source.points
    dst_pts = target.points[idx]
    ok = ok & target.valid[idx]

    # RanSaPC pairwise-consistency rounds (ref: Odometry.cpp:400-404)
    keys = jax.random.split(key, RANSAPC_ROUNDS + 2)
    for r in range(RANSAPC_ROUNDS):
        ok = ransac.ransapc_filter(keys[r], src_pts, dst_pts, ok)

    res1 = ransac.ransac_rigid(
        keys[-2], src_pts, dst_pts, ok,
        threshold=RANSAC_THRESHOLD,
        num_hypotheses=num_hypotheses,
        sample_size=RANSAC_SAMPLES,
        norm_z=src_pts[:, 2],
    )

    # round 2: pose-guided re-match (ref: SparseMatcher.cpp:25-50). The
    # reference re-matches unconditionally; `rematch_below` gates it behind
    # a lax.cond so a confidently-tracked frame (adjacent frames in the
    # odometry scan routinely clear 100+ inliers) skips the second
    # match+RANSAC chain entirely — the cond's untaken branch costs nothing
    # at runtime. LC pair tracking passes None (always re-match: wide
    # baselines are exactly where pose-guided matching earns its keep).
    def round2(key2):
        pred = src_pts @ res1.T[:3, :3].T + res1.T[:3, 3]
        uv_pred, _ = camera.project(pred)
        idx2, ok2 = hamming.match_descriptors_windowed(
            source.kp.desc, source.valid, target.kp.desc, target.valid,
            uv_pred, target.kp.uv,
        )
        dst2 = target.points[idx2]
        ok2 = ok2 & target.valid[idx2]
        res2 = ransac.ransac_rigid(
            key2, src_pts, dst2, ok2,
            threshold=RANSAC_THRESHOLD,
            num_hypotheses=num_hypotheses,
            sample_size=RANSAC_SAMPLES,
            norm_z=src_pts[:, 2],
        )
        return res2, dst2, idx2

    def skip2(key2):
        return res1, dst_pts, idx

    if rematch_below is None:
        res2, dst2, idx2 = round2(keys[-1])
    else:
        res2, dst2, idx2 = jax.lax.cond(
            res1.num_inliers < rematch_below, round2, skip2, keys[-1]
        )

    use2 = res2.num_inliers >= res1.num_inliers
    T = jnp.where(use2, res2.T, res1.T)
    nin = jnp.where(use2, res2.num_inliers, res1.num_inliers)
    rmse = jnp.where(use2, res2.rmse, res1.rmse)
    corr_dst = jnp.where(use2, dst2, dst_pts)
    corr_ok = jnp.where(use2, res2.inliers, res1.inliers)
    corr_idx = jnp.where(use2, idx2, idx)
    return SparseTrackingResult(
        T, nin, rmse, nin >= MIN_INLIERS, src_pts, corr_dst, corr_ok, corr_idx
    )


def sparse_tracking(
    source: SparseFrame,
    target: SparseFrame,
    camera: PinholeCamera,
    key: jax.Array | None = None,
) -> SparseTrackingResult:
    """Estimate T_ts mapping source-frame points into the target frame.

    NOTE the reference's convention: its RANSAC estimates the transform of
    source points onto target points from matched 3D pairs — same here.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    return _match_and_estimate(key, source, target, camera)


class TrackingSummary(NamedTuple):
    """Scalar-only tracking summary: ONE small host fetch per frame.

    The per-frame host loop (systems/fbaslam.py) previously fetched
    T_ts/success/corr arrays in 4-5 separate blocking transfers, each a
    host round trip that caps the sparse pipeline regardless of kernel
    speed. Everything the
    keyframe decision needs (including the reference's average-disparity
    trigger, ref: Correspondence.h:22-40) is computed on device and fetched
    as one tiny pytree; the full correspondence arrays are fetched only
    when a keyframe is promoted.
    """

    T_ts: jax.Array  # (4, 4)
    success: jax.Array  # () bool
    rmse: jax.Array
    num_inliers: jax.Array
    disparity: jax.Array  # () average pixel disparity over inlier matches


@functools.partial(jax.jit, static_argnames=("camera",))
def _track_summary(key, source, target, camera):
    return _track_summary_inner(key, source, target, camera)


def sparse_tracking_with_summary(
    source: SparseFrame,
    target: SparseFrame,
    camera: PinholeCamera,
    key: jax.Array | None = None,
) -> tuple[SparseTrackingResult, TrackingSummary]:
    """`sparse_tracking` plus a device-computed scalar summary (see
    TrackingSummary). The result's arrays stay on device."""
    if key is None:
        key = jax.random.PRNGKey(0)
    return _track_summary(key, source, target, camera)


class ChunkScanOut(NamedTuple):
    """Per-frame outputs of the on-device keyframe-selection scan."""

    T_world: jax.Array  # (K, 4, 4)
    is_kf: jax.Array  # (K,) bool
    success: jax.Array  # (K,) bool
    rmse: jax.Array  # (K,)
    disparity: jax.Array  # (K,)
    corr_src: jax.Array  # (K, N, 3) vs the frame's tracking keyframe
    corr_dst: jax.Array  # (K, N, 3)
    corr_valid: jax.Array  # (K, N)
    corr_idx: jax.Array  # (K, N) matched keypoint index in the frame
    promote_prev: jax.Array  # (K,) bool: frame i-1 was retroactively
    #                          promoted to keyframe when frame i lost
    #                          tracking (failure recovery)


@functools.partial(jax.jit, static_argnames=("camera", "keyframe_disparity"))
def sparse_chunk_scan(
    kf_frame: SparseFrame,  # current keyframe at chunk entry
    kf_pose: jax.Array,  # (4, 4) world-from-keyframe
    frames: SparseFrame,  # batched: leaves have leading K axis
    camera: PinholeCamera,
    key: jax.Array,
    keyframe_disparity: float,
) -> tuple[tuple[SparseFrame, jax.Array], ChunkScanOut]:
    """Track a CHUNK of frames and select keyframes in ONE dispatch.

    The reference's FBAFusion frame loop (ref: FBASlam.cpp:5-139) is
    sequential host control flow: track vs the last keyframe, promote on
    disparity >= threshold, repeat — every step needs the previous step's
    decision. A per-frame host round trip caps the loop regardless of
    kernel speed. Here the
    WHOLE loop runs on device as a `lax.scan` whose carry is the current
    keyframe (frame pytree + pose): promotion is a `where`-select of the
    carry, so the chunk needs ONE dispatch and one summary fetch. Failed
    frames keep the previous pose (constant-position fallback, ref
    :103-108's relocalisation can be replayed host-side for them).

    Loop-closure detection and pose-graph optimisation happen at chunk
    boundaries (systems/fbaslam.py `process_chunk`) — deferred by at most
    one chunk relative to the reference's per-keyframe schedule.
    """
    thr = jnp.float32(keyframe_disparity)

    def sel(cond, new, old):
        return jax.tree.map(
            lambda a, b: jnp.where(jnp.reshape(cond, (1,) * b.ndim), a, b),
            new, old,
        )

    def body(carry, xs):
        kf, kfp, prev_frame, prev_T, prev_ok, last_T, key = carry
        frame_i, _ = xs
        key, sub = jax.random.split(key)
        res, summ = _track_summary_inner(sub, kf, frame_i, camera)
        ok = summ.success
        # FAILURE RECOVERY: tracking lost against the keyframe, but the
        # previous frame tracked fine -> retroactively promote it as the
        # new keyframe so the NEXT frame has a nearby reference. (The
        # reference hard-exits here, ref FBASlam.cpp:124-128; a production
        # system must not.) The current frame keeps the previous pose.
        promote_prev = (~ok) & prev_ok
        kf = sel(promote_prev, prev_frame, kf)
        kfp = jnp.where(promote_prev, prev_T, kfp)
        T_rel = se3_inverse(summ.T_ts)
        T_world = jnp.where(ok, kfp @ T_rel, last_T)
        is_kf = ok & (summ.disparity >= thr)
        kf = sel(is_kf, frame_i, kf)
        kfp = jnp.where(is_kf, T_world, kfp)
        out = (
            T_world, is_kf, ok, summ.rmse, summ.disparity,
            res.corr_src, res.corr_dst, res.corr_valid, res.corr_idx,
            promote_prev,
        )
        return (kf, kfp, frame_i, T_world, ok, T_world, key), out

    k = frames.points.shape[0]
    f0 = jax.tree.map(lambda a: a[0], frames)  # placeholder prev (unused: prev_ok=False)
    init = (kf_frame, kf_pose, f0, kf_pose, jnp.bool_(False), kf_pose, key)
    (kf_out, kfp_out, _, _, _, _, _), outs = jax.lax.scan(
        body, init, (frames, jnp.arange(k))
    )
    (T_world, is_kf, ok, rmse, disp, csrc, cdst, cval, cidx, pp) = outs
    return (kf_out, kfp_out), ChunkScanOut(
        T_world, is_kf, ok, rmse, disp, csrc, cdst, cval, cidx, pp
    )


def se3_inverse(T: jax.Array) -> jax.Array:
    R = T[:3, :3]
    t = T[:3, 3]
    out = jnp.eye(4, dtype=T.dtype)
    out = out.at[:3, :3].set(R.T)
    return out.at[:3, 3].set(-R.T @ t)


def _track_summary_inner(key, source, target, camera,
                         num_hypotheses=RANSAC_HYPOTHESES,
                         rematch_below=None):
    """Unjitted body shared by `_track_summary` and the chunk scan."""
    res = _match_and_estimate(key, source, target, camera, num_hypotheses,
                              rematch_below)
    uv_src = source.kp.uv
    uv_dst, _ = camera.project(res.corr_dst)
    d = jnp.linalg.norm(uv_dst - uv_src, axis=-1)
    vf = res.corr_valid.astype(jnp.float32)
    disp = jnp.sum(d * vf) / jnp.clip(jnp.sum(vf), 1.0, None)
    return res, TrackingSummary(res.T_ts, res.success, res.rmse, res.num_inliers, disp)


@functools.partial(jax.jit, static_argnames=("camera", "max_keypoints", "threshold"))
def extract_sparse_frames_batch(
    grays: jax.Array,  # (K, H, W)
    depths: jax.Array,  # (K, H, W)
    camera: PinholeCamera,
    max_keypoints: int = 1000,
    threshold: float = 0.05,
) -> SparseFrame:
    """Batched `extract_sparse_frame` over a chunk: one dispatch of
    chunk-wide ops.

    Built on `features.detect_and_describe_batch`: every detector stage is
    one B-fold-larger op (the sequential lax.map path paid ~60 small-kernel
    launches per frame), and all keypoint lookups are single flat gathers
    with global frame*H*W indices — NOT vmapped (batched) gathers.
    """
    b, h, w = grays.shape
    kp = feat.detect_and_describe_batch(
        grays, max_keypoints=max_keypoints, threshold=threshold
    )
    ui = jnp.clip(jnp.round(kp.uv[..., 0]), 0, w - 1).astype(jnp.int32)
    vi = jnp.clip(jnp.round(kp.uv[..., 1]), 0, h - 1).astype(jnp.int32)
    base = (jnp.arange(b, dtype=jnp.int32) * (h * w))[:, None]
    z = depths.reshape(-1)[(base + vi * w + ui).reshape(-1)].reshape(b, -1)
    pts = camera.backproject(kp.uv, z)
    valid = kp.valid & (z > 0)
    return SparseFrame(kp, pts, valid)


@functools.partial(jax.jit, static_argnames=("camera",))
def track_pairs_batch(
    keys: jax.Array,  # (P, 2) PRNG keys
    sources: SparseFrame,  # batched (leading P)
    targets: SparseFrame,  # batched (leading P)
    camera: PinholeCamera,
) -> tuple[SparseTrackingResult, TrackingSummary]:
    """Batched pair tracking in ONE jitted dispatch.

    `lax.map` (sequential; vmapped RANSAC/top-k lowers poorly) — and the
    jit wrapper matters: a bare lax.map outside jit executes its body
    semi-eagerly at ~50x the cost.
    """
    return jax.lax.map(
        lambda x: _track_summary_inner(x[0], x[1], x[2], camera),
        (keys, sources, targets),
    )
