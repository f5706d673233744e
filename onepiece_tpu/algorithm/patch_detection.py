"""Region-growing line (2D) and plane (3D) detection.

Rebuild of `algorithm::PatchDetection` (ref: src/Algorithm/PatchDetection.
{h,cpp}): per-point local models from neighbourhood fits (:39-126, two
inlier-refit rounds), seeds chosen by lowest local residual (`ChooseSeed`
:29-38), BFS region growing where a candidate joins if it passes the
reference's two-part inlier test (`IsInlier` :13-28 — distance to the
patch model <= radius/2 AND |local normal . patch normal| >= 0.8), with
the patch model refit once per FRONTIER NODE (:146-173), not per
candidate. Visited-but-rejected candidates are CONSUMED (the reference
erases them from `un_visited` before the inlier test, :155-158).

Device/host split: the per-point local fits are one batched
eigendecomposition over the kNN tensor (device-friendly numpy here — the
kNN itself comes from the device); the BFS is host control flow, but each
model refit is O(D^3) from incremental running sums (count, sum p,
sum p p^T) instead of the r3 implementation's O(|members|) SVD per
CANDIDATE — on a 100k-point room scan that is the difference between
seconds and hours.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np


@dataclasses.dataclass
class Patch:
    indices: np.ndarray  # member point indices
    model: np.ndarray  # line: (origin, dir) flat 6[4]; plane: (n, d) 4


def _models_from_cov(mu: np.ndarray, cov: np.ndarray):
    """(n, d) hyperplane + principal direction + rms residual from moments.

    mu (..., D); cov (..., D, D) central covariance. Returns
    (normal (..., D), d (...,), direction (..., D), rms (...,)).
    """
    w, v = np.linalg.eigh(cov)
    normal = v[..., 0]  # smallest-variance direction
    direction = v[..., -1]  # largest (line tangent / plane major axis)
    d = -np.einsum("...i,...i->...", normal, mu)
    rms = np.sqrt(np.maximum(w[..., 0], 0.0))
    return normal, d, direction, rms


def local_models(
    points: np.ndarray, neighbors: np.ndarray, dist_threshold: float,
    refit_rounds: int = 2,
):
    """Per-point local hyperplane fits over the kNN lists, fully batched.

    Follows the reference's estimation loop (PatchDetection.cpp:85-126):
    fit, keep neighbours within the distance threshold, refit
    (`remain_iter_times = 2`). Returns (normals (N, D), residuals (N,)).
    """
    nb = points[neighbors]  # (N, K, D)
    w_mask = np.ones(nb.shape[:2], np.float64)
    for _ in range(refit_rounds + 1):
        cnt = np.maximum(w_mask.sum(1), 1.0)
        mu = (nb * w_mask[..., None]).sum(1) / cnt[:, None]
        X = (nb - mu[:, None]) * w_mask[..., None]
        cov = np.einsum("nki,nkj->nij", X, X) / cnt[:, None, None]
        normal, d, _, rms = _models_from_cov(mu, cov)
        dist = np.abs(np.einsum("nkd,nd->nk", nb, normal) + d[:, None])
        w_mask = (dist <= dist_threshold).astype(np.float64)
    return normal, rms


def detect_patches(
    points: np.ndarray,  # (N, D) D=2 lines / D=3 planes
    neighbors: np.ndarray,  # (N, K) kNN indices (device-computed)
    residual_threshold: float = 0.02,
    min_points: int = 20,
    max_patches: int = 64,
    normal_min_dot: float = 0.8,  # ref IsInlier normal_prod >= 0.8
) -> list[Patch]:
    """Seeded region growing with incremental patch statistics."""
    pts = np.asarray(points, np.float64)
    n, d_dim = pts.shape
    normals, local_res = local_models(pts, neighbors, residual_threshold)

    order = np.argsort(local_res, kind="stable")
    unvisited = np.ones(n, bool)
    patches: list[Patch] = []
    for seed in order:
        if not unvisited[seed] or len(patches) >= max_patches:
            continue
        # incremental stats of the growing patch
        s1 = pts[seed].copy()
        s2 = np.outer(pts[seed], pts[seed])
        cnt = 1
        p_n = normals[seed]
        p_d = -p_n @ pts[seed]
        members = [int(seed)]
        frontier = deque([int(seed)])
        unvisited[seed] = False
        rms = np.inf
        while frontier:
            cur = frontier.popleft()
            for nb in neighbors[cur]:
                nb = int(nb)
                if not unvisited[nb]:
                    continue
                unvisited[nb] = False  # consumed even if rejected (ref :155)
                p = pts[nb]
                dist = abs(p_n @ p + p_d)
                tangent_ok = abs(normals[nb] @ p_n) >= normal_min_dot
                if dist > residual_threshold or not tangent_ok:
                    continue
                members.append(nb)
                frontier.append(nb)
                s1 += p
                s2 += np.outer(p, p)
                cnt += 1
            if cnt >= 3:
                mu = s1 / cnt
                cov = s2 / cnt - np.outer(mu, mu)
                p_n, p_d, _, rms = _models_from_cov(mu, cov)
        if cnt >= min_points and rms <= residual_threshold:
            idx = np.array(sorted(members))
            mu = s1 / cnt
            cov = s2 / cnt - np.outer(mu, mu)
            p_n, p_d, direction, _ = _models_from_cov(mu, cov)
            if d_dim == 3:
                model = np.concatenate([p_n, [p_d]])
            else:
                model = np.concatenate([mu, direction])
            patches.append(Patch(idx, model))
        else:
            # failed patch: members stay consumed for THIS seed pass, but
            # a too-small cluster should not poison other seeds' territory
            # (the reference keeps them consumed; we match it)
            pass
    return patches
