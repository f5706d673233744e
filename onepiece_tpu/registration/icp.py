"""Iterative closest point: point-to-point and point-to-plane.

Device redesign of `registration::ICP` (ref: src/Registration/ICP.{h,cpp}).
The reference parallelises its KD-tree NN queries with OpenMP
(ref: ICP.cpp:64,184) and runs 30 sequential iterations of
correspond -> estimate. Here the NN search is exact brute force
(ops/knn.py), correspondence + estimation are fused into one jitted
iteration, and the outer loop is a `lax.fori_loop` — the entire ICP runs as
a single device program.

Variants (matching ref):
  - point_to_point: weighted Kabsch on inlier correspondences
    (ref: ICP.cpp:31-107 `PointToPoint`)
  - point_to_plane: 6x6 GN on  n_q . (T p - q)  residuals
    (ref: ICP.cpp:108-224 `EstimateRigidTransformationPointToPlane` /
    `PointToPlane`)
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3, transforms
from ..ops import knn as knn_ops

DEFAULT_ITERS = 30  # ref: ICPParameter max_iteration (ICP.h:13-19)
DEFAULT_THRESHOLD = 0.1  # inlier distance threshold (meters)


class ICPResult(NamedTuple):
    T: jax.Array  # (4, 4) aligning source onto target
    num_inliers: jax.Array
    rmse: jax.Array


def _correspond(src_t: jax.Array, src_valid, tgt: jax.Array, tgt_valid, threshold):
    idx, d2 = knn_ops.knn(src_t, tgt, tgt_valid, k=1)
    idx, d2 = idx[:, 0], d2[:, 0]
    ok = src_valid & (d2 < threshold * threshold)
    return idx, d2, ok


@functools.partial(jax.jit, static_argnames=("iters",))
def point_to_point(
    src: jax.Array,  # (N, 3)
    src_valid: jax.Array,
    tgt: jax.Array,  # (M, 3)
    tgt_valid: jax.Array,
    init_T: jax.Array | None = None,
    threshold: float = DEFAULT_THRESHOLD,
    iters: int = DEFAULT_ITERS,
) -> ICPResult:
    T0 = jnp.eye(4, dtype=jnp.float32) if init_T is None else init_T

    def body(_, T):
        src_t = src @ T[:3, :3].T + T[:3, 3]
        idx, d2, ok = _correspond(src_t, src_valid, tgt, tgt_valid, threshold)
        w = ok.astype(jnp.float32)
        T_new = transforms.kabsch(src, tgt[idx], w)
        good = jnp.all(jnp.isfinite(T_new)) & (jnp.sum(w) > 3)
        return jnp.where(good, T_new, T)

    T = jax.lax.fori_loop(0, iters, body, T0)
    src_t = src @ T[:3, :3].T + T[:3, 3]
    idx, d2, ok = _correspond(src_t, src_valid, tgt, tgt_valid, threshold)
    n = jnp.sum(ok)
    rmse = jnp.sqrt(jnp.sum(jnp.where(ok, d2, 0.0)) / jnp.clip(n, 1, None))
    return ICPResult(T, n, rmse)


@functools.partial(jax.jit, static_argnames=("iters",))
def point_to_plane(
    src: jax.Array,
    src_valid: jax.Array,
    tgt: jax.Array,
    tgt_normals: jax.Array,
    tgt_valid: jax.Array,
    init_T: jax.Array | None = None,
    threshold: float = DEFAULT_THRESHOLD,
    iters: int = DEFAULT_ITERS,
) -> ICPResult:
    T0 = jnp.eye(4, dtype=jnp.float32) if init_T is None else init_T

    def body(_, T):
        src_t = src @ T[:3, :3].T + T[:3, 3]
        idx, d2, ok = _correspond(src_t, src_valid, tgt, tgt_valid, threshold)
        q = tgt[idx]
        n = tgt_normals[idx]
        w = ok.astype(jnp.float32)
        r = jnp.sum(n * (src_t - q), axis=-1)  # (N,)
        # J = [n | (src_t x n)] for left-mult twist on T  (n.(exp(xi)p - q))
        J = jnp.concatenate([n, jnp.cross(src_t, n)], axis=-1)  # (N, 6)
        JTJ = jnp.einsum("ni,n,nj->ij", J, w, J)
        JTr = jnp.einsum("ni,n,n->i", J, w, r)
        xi = jnp.linalg.solve(JTJ + 1e-8 * jnp.eye(6), -JTr)
        good = jnp.all(jnp.isfinite(xi)) & (jnp.sum(w) > 6)
        xi = jnp.where(good, xi, 0.0)
        return se3.se3_exp(xi) @ T

    T = jax.lax.fori_loop(0, iters, body, T0)
    src_t = src @ T[:3, :3].T + T[:3, 3]
    idx, d2, ok = _correspond(src_t, src_valid, tgt, tgt_valid, threshold)
    q = tgt[idx]
    n = tgt_normals[idx]
    r = jnp.sum(n * (src_t - q), axis=-1)
    ni = jnp.sum(ok)
    rmse = jnp.sqrt(jnp.sum(jnp.where(ok, r * r, 0.0)) / jnp.clip(ni, 1, None))
    return ICPResult(T, ni, rmse)
