"""Exact nearest-neighbor search by brute force.

Replacement for the reference's nanoflann KD-tree
(ref: src/Geometry/KDTree.h:62-365). A KD-tree is pointer-chasing; at the
reference's problem sizes (640x480 frames, submap clouds of 1e4-1e5 points,
feature dim 3 or 33) an exhaustive tiled distance computation is exact and
maps onto wide elementwise device code.

Distances are summed coordinate by coordinate, never expanded as
|a|^2 + |b|^2 - 2 a.b: for points ~4 m from the origin that form cancels
~16 m^2 terms down to ~1e-4 m^2 distances, so f32 rounding (~4e-6 m^2)
reorders neighbors 1 cm apart. The direct form is pure elementwise work, so
XLA fuses it into the argmin and never writes the (tile, M) block for k=1.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

LARGE = 1e30


def pairwise_sqdist(query: jax.Array, ref: jax.Array) -> jax.Array:
    """Squared L2 distances (N, D) x (M, D) -> (N, M), exact to f32 rounding
    of each distance (see the module docstring for why not a matmul)."""
    d = jnp.zeros((query.shape[0], ref.shape[0]), jnp.float32)
    for j in range(query.shape[-1]):
        diff = query[:, None, j] - ref[None, :, j]
        d = d + diff * diff
    return d


@functools.partial(jax.jit, static_argnames=("k", "tile"))
def knn(
    query: jax.Array,
    ref: jax.Array,
    ref_valid: jax.Array,
    k: int = 1,
    tile: int = 2048,
) -> tuple[jax.Array, jax.Array]:
    """Exact k-NN: returns (indices (N, k), sqdists (N, k)).

    Invalid reference points (mask False) never match; a query with no
    valid reference gets distance LARGE. Query rows are tiled with lax.map
    so the (tile, M) distance block stays bounded while M can be large.
    """
    n = query.shape[0]
    pad = (-n) % tile
    qp = jnp.pad(query, ((0, pad), (0, 0)))

    def one_tile(qt):
        d = jnp.where(ref_valid[None, :], pairwise_sqdist(qt, ref), LARGE)
        if k == 1:
            idx = jnp.argmin(d, axis=-1)
            # recompute the winner's distance: keeps d a fusion-only value
            diff = qt - ref[idx]
            d1 = jnp.where(ref_valid[idx], jnp.sum(diff * diff, -1), LARGE)
            return idx[:, None], d1[:, None]
        neg_d, idx = jax.lax.top_k(-d, k)
        return idx, -neg_d

    qtiles = qp.reshape(-1, tile, query.shape[-1])
    idx, dist = jax.lax.map(one_tile, qtiles)
    idx = idx.reshape(-1, k)[:n]
    dist = dist.reshape(-1, k)[:n]
    return idx, dist


@functools.partial(jax.jit, static_argnames=("k", "radius", "tile"))
def radius_knn(
    query: jax.Array,
    ref: jax.Array,
    ref_valid: jax.Array,
    k: int,
    radius: float,
    tile: int = 2048,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """k nearest neighbors within `radius` (ref: KDTree.h `KnnRadiusSearch`).

    Returns (indices (N, k), sqdists (N, k), in_radius_mask (N, k)).
    """
    idx, dist = knn(query, ref, ref_valid, k=k, tile=tile)
    mask = dist <= radius * radius
    return idx, dist, mask
