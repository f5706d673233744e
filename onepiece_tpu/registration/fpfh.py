"""FPFH 33-bin 3D features, fully batched.

Device redesign of `registration::FPFH` (ref: src/Registration/3DFeature.cpp:
`ComputePairDescriptor` :8-24, `ComputeSPFH` :27-81, `ComputeFPFHFeature`
:83-131). The reference loops points and KD-tree neighbours; here neighbour
sets come from the brute-force k-NN (radius-masked) and the Darboux-angle
pair features + 11-bin histograms are one vmapped computation with one-hot
reductions — no scatter conflicts, matmul-friendly shapes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops import knn as knn_ops

NUM_BINS = 11  # per angle feature -> 33-dim descriptor


def _pair_features(p1, n1, p2, n2):
    """Darboux frame angles for point pairs.

    p1, n1: (..., 3) source point/normal; p2, n2: (..., 3) neighbour.
    Returns (alpha, phi, theta) each (...,) — the three PFH angles
    (ref: 3DFeature.cpp:8-24).
    """
    d = p2 - p1
    dist = jnp.linalg.norm(d, axis=-1)
    dsafe = jnp.where(dist > 1e-9, dist, 1.0)
    du = d / dsafe[..., None]
    # order the pair so the source normal has the smaller angle to d
    a1 = jnp.abs(jnp.sum(n1 * du, axis=-1))
    a2 = jnp.abs(jnp.sum(n2 * du, axis=-1))
    swap = a2 > a1
    ns = jnp.where(swap[..., None], n2, n1)
    nt = jnp.where(swap[..., None], n1, n2)
    du = jnp.where(swap[..., None], -du, du)

    u = ns
    v = jnp.cross(du, u)
    vn = jnp.linalg.norm(v, axis=-1, keepdims=True)
    v = v / jnp.where(vn > 1e-9, vn, 1.0)
    w = jnp.cross(u, v)
    alpha = jnp.sum(v * nt, axis=-1)  # in [-1, 1]
    phi = jnp.sum(u * du, axis=-1)  # in [-1, 1]
    theta = jnp.arctan2(jnp.sum(w * nt, axis=-1), jnp.sum(u * nt, axis=-1))
    return alpha, phi, theta


def _histogram(vals: jax.Array, lo: float, hi: float, w: jax.Array) -> jax.Array:
    """(N, K) values + (N, K) weights -> (N, NUM_BINS) soft counts."""
    b = jnp.clip(((vals - lo) / (hi - lo) * NUM_BINS).astype(jnp.int32), 0, NUM_BINS - 1)
    onehot = jax.nn.one_hot(b, NUM_BINS, dtype=jnp.float32)
    return jnp.einsum("nkb,nk->nb", onehot, w)


@functools.partial(jax.jit, static_argnames=("k",))
def compute_fpfh(
    points: jax.Array,  # (N, 3)
    normals: jax.Array,  # (N, 3)
    valid: jax.Array,  # (N,)
    radius: float = 0.25,
    k: int = 32,
) -> jax.Array:
    """(N, 33) FPFH descriptors (invalid points -> zeros)."""
    idx, d2, in_r = knn_ops.radius_knn(points, points, valid, k=k, radius=radius)
    # exclude self (distance 0)
    nb_ok = in_r & (d2 > 1e-12) & valid[:, None] & valid[idx]
    w = nb_ok.astype(jnp.float32)

    p2 = points[idx]
    n2 = normals[idx]
    alpha, phi, theta = _pair_features(
        points[:, None, :], normals[:, None, :], p2, n2
    )
    import numpy as _np

    spfh = jnp.concatenate(
        [
            _histogram(alpha, -1.0, 1.0, w),
            _histogram(phi, -1.0, 1.0, w),
            _histogram(theta, -_np.pi, _np.pi, w),
        ],
        axis=-1,
    )  # (N, 33)
    cnt = jnp.clip(jnp.sum(w, axis=-1, keepdims=True), 1.0, None)
    spfh = spfh / cnt

    # FPFH = SPFH + mean_k (1/dist_k) SPFH(neighbor_k)
    # (ref: 3DFeature.cpp:83-131 weight = 1/distance)
    inv_d = jnp.where(nb_ok, 1.0 / jnp.sqrt(jnp.clip(d2, 1e-12, None)), 0.0)
    nb_spfh = spfh[idx]  # (N, K, 33)
    agg = jnp.einsum("nkf,nk->nf", nb_spfh, inv_d)
    ksum = jnp.clip(jnp.sum(nb_ok, axis=-1, keepdims=True).astype(jnp.float32), 1.0, None)
    fpfh = spfh + agg / ksum
    # normalise each 11-bin block to sum 100 (PCL-style)
    blocks = fpfh.reshape(-1, 3, NUM_BINS)
    s = jnp.clip(jnp.sum(blocks, axis=-1, keepdims=True), 1e-9, None)
    fpfh = (blocks / s * 100.0).reshape(-1, 3 * NUM_BINS)
    return jnp.where(valid[:, None], fpfh, 0.0)
