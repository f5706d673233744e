"""Batched-hypothesis RANSAC for rigid 3D-3D alignment and plane fitting.

Device redesign of the reference's sequential RANSAC engines — the GRANSAC
template (ref: 3rdparty/GRANSAC/GRANSAC.hpp), `RANSAC3d`
(ref: src/Odometry/SparseOdometryFunction.cpp:10-55, 8 samples x 400 iters
with an inlier-ratio early exit) and `EstimateRigidTransformationRANSAC`
(ref: src/Geometry/Ransac.cpp:7-40). Sequential hypothesize-and-test with
early exit is hostile to XLA; the statistically equivalent batched form
draws ALL hypotheses at once, scores them with one einsum, and argmaxes —
no data-dependent control flow anywhere.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3, transforms


class RansacResult(NamedTuple):
    T: jax.Array  # (4, 4) best rigid transform
    inliers: jax.Array  # (N,) bool
    num_inliers: jax.Array  # scalar int
    rmse: jax.Array  # inlier rmse


def _sample_indices(key: jax.Array, valid: jax.Array, num_hyp: int, sample_size: int) -> jax.Array:
    """(H, S) indices drawn from valid entries via Gumbel top-k (no replacement
    within a hypothesis)."""
    n = valid.shape[0]
    logits = jnp.where(valid, 0.0, -jnp.inf)
    g = jax.random.gumbel(key, (num_hyp, n))
    _, idx = jax.lax.top_k(logits[None, :] + g, sample_size)
    return idx


@functools.partial(jax.jit, static_argnames=("num_hypotheses", "sample_size"))
def ransac_rigid(
    key: jax.Array,
    src: jax.Array,  # (N, 3)
    dst: jax.Array,  # (N, 3)
    valid: jax.Array,  # (N,) bool
    threshold: float | jax.Array = 0.05,
    num_hypotheses: int = 400,
    sample_size: int = 8,
    norm_z: jax.Array | None = None,
) -> RansacResult:
    """All-hypotheses-at-once rigid RANSAC with weighted-Kabsch refit.

    Defaults match RANSAC3d (ref: SparseOdometryFunction.cpp:10-55).
    With `norm_z` (per-correspondence depths), the inlier gate becomes the
    reference's DEPTH-NORMALISED reprojection error
    ||T p - q|| / z <= threshold (ref: SparseOdometryFunction.cpp:56-61
    `ReprojectionError3D`, threshold REPROJECTION_ERROR_3D_THRESHOLD=0.01)
    — an absolute gate over-trusts far points, whose keypoint localisation
    error grows linearly with depth.
    """
    thr2 = jnp.square(threshold * norm_z) if norm_z is not None else threshold * threshold
    idx = _sample_indices(key, valid, num_hypotheses, sample_size)
    # hypothesis batch: quaternion power-iteration Kabsch (transforms.
    # kabsch_fast) — the batched 3x3 SVD dominated the track budget on
    # chip; an occasional slow-converging hypothesis only wastes one of
    # `num_hypotheses`, and the winning inlier set is refit with the SVD
    # path below
    Ts = jax.vmap(transforms.kabsch_fast)(src[idx], dst[idx])  # (H, 4, 4)
    pred = jnp.einsum("hij,nj->hni", Ts[:, :3, :3], src) + Ts[:, None, :3, 3]
    d2 = jnp.sum((pred - dst[None]) ** 2, axis=-1)  # (H, N)
    inl = (d2 < thr2) & valid[None, :]
    counts = jnp.sum(inl, axis=-1)
    best = jnp.argmax(counts)
    best_inl = inl[best]
    # refit on the best inlier set
    w = best_inl.astype(jnp.float32)
    T_refit = transforms.kabsch(src, dst, w)
    pred_r = src @ T_refit[:3, :3].T + T_refit[:3, 3]
    d2_r = jnp.sum((pred_r - dst) ** 2, axis=-1)
    inl_r = (d2_r < thr2) & valid
    # guard: refit must not be worse than the raw best hypothesis
    better = jnp.sum(inl_r) >= counts[best]
    T_out = jnp.where(better, T_refit, Ts[best])
    inl_out = jnp.where(better, inl_r, best_inl)
    nin = jnp.sum(inl_out)
    d2_out = jnp.where(better, d2_r, d2[best])
    if norm_z is not None:
        # report rmse in the same normalised units as the gate, matching the
        # reference's ComputeReprojectionError3D (err / z) so its
        # max_reprojection_error_3d thresholds apply unchanged
        d2_out = d2_out / jnp.clip(jnp.square(norm_z), 1e-6, None)
    rmse = jnp.sqrt(
        jnp.sum(jnp.where(inl_out, d2_out, 0.0))
        / jnp.clip(nin.astype(jnp.float32), 1.0, None)
    )
    return RansacResult(T_out, inl_out, nin, rmse)


@functools.partial(jax.jit, static_argnames=("num_hypotheses",))
def ransac_plane(
    key: jax.Array,
    points: jax.Array,  # (N, 3)
    valid: jax.Array,
    threshold: float = 0.02,
    num_hypotheses: int = 256,
) -> tuple[jax.Array, jax.Array]:
    """Plane RANSAC (ref: src/Geometry/Ransac.cpp:42-77 `FitPlaneRANSAC`).

    Returns (plane (4,), inlier mask (N,))."""
    idx = _sample_indices(key, valid, num_hypotheses, 3)
    planes = jax.vmap(transforms.fit_plane)(points[idx])  # (H, 4)
    d = jnp.abs(
        jnp.einsum("hi,ni->hn", planes[:, :3], points) + planes[:, 3:4]
    )
    inl = (d < threshold) & valid[None, :]
    best = jnp.argmax(jnp.sum(inl, axis=-1))
    w = inl[best].astype(jnp.float32)
    plane = transforms.fit_plane(points, w)
    d_r = jnp.abs(points @ plane[:3] + plane[3])
    return plane, (d_r < threshold) & valid


def ransapc_filter(
    key: jax.Array,
    src: jax.Array,
    dst: jax.Array,
    valid: jax.Array,
    num_anchors: int = 8,
    tolerance: float = 0.1,
    min_votes: int = 5,
) -> jax.Array:
    """Pairwise-consistency outlier filter (RanSaPC).

    (ref: src/Odometry/SparseOdometryFunction.h:50-84 `OutlierFilter::RanSaPC`,
    applied 5x in SparseTrackingMILD, ref: Odometry.cpp:400-404.)
    Rigid motion preserves pairwise distances: a correspondence votes for an
    anchor if | |src_i - src_a| - |dst_i - dst_a| | < tol. The reference
    loops anchors sequentially; here all anchors are checked in one batch.
    Returns the filtered validity mask.
    """
    idx = _sample_indices(key, valid, 1, num_anchors)[0]  # (A,)
    ds = jnp.linalg.norm(src[:, None, :] - src[idx][None], axis=-1)  # (N, A)
    dd = jnp.linalg.norm(dst[:, None, :] - dst[idx][None], axis=-1)
    consistent = jnp.abs(ds - dd) < tolerance
    votes = jnp.sum(consistent & valid[idx][None, :], axis=-1)
    return valid & (votes >= min_votes)


@functools.partial(jax.jit, static_argnames=("num_hypotheses",))
def homography_filter(
    key: jax.Array,
    uv_src: jax.Array,  # (N, 2) source pixel coords
    uv_dst: jax.Array,  # (N, 2) matched target pixel coords
    valid: jax.Array,  # (N,) bool
    threshold: float = 6.0,
    num_hypotheses: int = 256,
) -> jax.Array:
    """Homography-RANSAC 2D outlier filter on pixel matches.

    (ref: src/Odometry/SparseOdometryFunction.h:102-127 `OutlierFilter::
    Ransac` — cv::findHomography(CV_FM_RANSAC) with the 6 px
    REPROJECTION_ERROR_2D_THRESHOLD, keeping inlier matches.) Batched:
    all 4-point DLT hypotheses are solved at once (eigen-vector of the
    9x9 normal matrix), scored by symmetric-free transfer error.
    Returns the filtered validity mask.
    """
    # normalise for DLT conditioning: Hartley-style similarity derived from
    # the (valid) points themselves — centroid + mean distance — so the
    # 6 px threshold stays well-conditioned at any image resolution
    vw = valid.astype(jnp.float32)
    n_valid = jnp.maximum(jnp.sum(vw), 1.0)
    center = jnp.sum(jnp.concatenate([uv_src, uv_dst], 0)
                     * jnp.concatenate([vw, vw])[:, None], axis=0) / (2.0 * n_valid)
    mean_dist = jnp.sum(
        (jnp.linalg.norm(uv_src - center, axis=-1)
         + jnp.linalg.norm(uv_dst - center, axis=-1)) * vw
    ) / (2.0 * n_valid)
    scale = 1.0 / jnp.maximum(mean_dist, 1e-6)
    s_n = (uv_src - center) * scale
    d_n = (uv_dst - center) * scale

    idx = _sample_indices(key, valid, num_hypotheses, 4)  # (H, 4)

    def dlt(si):
        p = s_n[si]  # (4, 2)
        q = d_n[si]
        x, y = p[:, 0], p[:, 1]
        u, v = q[:, 0], q[:, 1]
        z = jnp.zeros_like(x)
        o = jnp.ones_like(x)
        r1 = jnp.stack([-x, -y, -o, z, z, z, u * x, u * y, u], -1)
        r2 = jnp.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)
        A = jnp.concatenate([r1, r2], axis=0)  # (8, 9)
        # null vector of A: eigenvector of A^T A with smallest eigenvalue
        w, V = jnp.linalg.eigh(A.T @ A)
        return V[:, 0].reshape(3, 3)

    Hs = jax.vmap(dlt)(idx)  # (H, 3, 3)
    ones = jnp.ones((s_n.shape[0], 1), jnp.float32)
    src_h = jnp.concatenate([s_n, ones], axis=-1)  # (N, 3)
    proj = jnp.einsum("hij,nj->hni", Hs, src_h)
    wz = proj[..., 2]
    wz = jnp.where(jnp.abs(wz) > 1e-8, wz, 1e-8)
    pred = proj[..., :2] / wz[..., None]
    err = jnp.linalg.norm(pred - d_n[None], axis=-1) / scale  # back to pixels
    inl = (err < threshold) & valid[None]
    counts = jnp.sum(inl, axis=-1)
    best = jnp.argmax(counts)
    # degenerate-sample guard: if no hypothesis beats half the matches,
    # keep the input mask (cv::findHomography would fail and the reference
    # proceeds with unfiltered matches)
    ok = counts[best] >= jnp.maximum(4, jnp.sum(valid) // 4)
    return jnp.where(ok, inl[best], valid)
