"""Clustering: k-means, mean-shift, k-medoids.

Device redesign of `algorithm::Clustering` (ref: src/Algorithm/Clustering.{h,cpp}
— cv::kmeans-backed K-means :38-73, mean-shift :76+, medoids). All three are
classic fixed-iteration array algorithms; the device versions use one
distance matmul per iteration and run under jit with static iteration
counts.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops.knn import pairwise_sqdist


@functools.partial(jax.jit, static_argnames=("k", "iters"))
def kmeans(
    key: jax.Array,
    points: jax.Array,  # (N, D)
    valid: jax.Array,  # (N,)
    k: int,
    iters: int = 25,
) -> tuple[jax.Array, jax.Array]:
    """Lloyd's k-means. Returns (centers (k, D), labels (N,))."""
    n = points.shape[0]
    # k-means++ style init: random distinct valid points via gumbel top-k
    logits = jnp.where(valid, 0.0, -jnp.inf)
    g = jax.random.gumbel(key, (n,))
    _, idx = jax.lax.top_k(logits + g, k)
    centers = points[idx]

    def body(_, centers):
        d = pairwise_sqdist(points, centers)  # (N, k)
        labels = jnp.argmin(d, axis=-1)
        onehot = jax.nn.one_hot(labels, k, dtype=points.dtype) * valid[:, None]
        counts = jnp.sum(onehot, axis=0)  # (k,)
        sums = onehot.T @ points  # (k, D)
        new = sums / jnp.clip(counts[:, None], 1.0, None)
        # keep old center when a cluster empties
        return jnp.where(counts[:, None] > 0, new, centers)

    centers = jax.lax.fori_loop(0, iters, body, centers)
    labels = jnp.argmin(pairwise_sqdist(points, centers), axis=-1)
    labels = jnp.where(valid, labels, -1)
    return centers, labels


@functools.partial(jax.jit, static_argnames=("iters",))
def mean_shift(
    points: jax.Array,  # (N, D)
    valid: jax.Array,
    bandwidth: float,
    iters: int = 30,
) -> jax.Array:
    """Gaussian-kernel mean shift; returns per-point modes (N, D).

    (ref: Clustering.h MeansShiftClustering.) Cluster extraction = host-side
    mode dedup (modes within bandwidth/2 collapse).
    """
    inv_bw2 = 1.0 / (bandwidth * bandwidth)

    def body(_, modes):
        d2 = pairwise_sqdist(modes, points)
        w = jnp.exp(-0.5 * d2 * inv_bw2) * valid[None, :]
        wsum = jnp.clip(jnp.sum(w, axis=-1, keepdims=True), 1e-12, None)
        return (w @ points) / wsum

    return jax.lax.fori_loop(0, iters, body, points)


def mean_shift_clusters(points, valid, bandwidth: float, iters: int = 30):
    """Host wrapper: run mean_shift and collapse modes into cluster labels."""
    import numpy as np

    modes = np.asarray(mean_shift(points, valid, bandwidth, iters))
    v = np.asarray(valid)
    labels = np.full(len(modes), -1, np.int64)
    centers: list[np.ndarray] = []
    for i in np.nonzero(v)[0]:
        for ci, c in enumerate(centers):
            if np.linalg.norm(modes[i] - c) < bandwidth * 0.5:
                labels[i] = ci
                break
        else:
            labels[i] = len(centers)
            centers.append(modes[i])
    return (np.stack(centers) if centers else np.zeros((0, points.shape[-1]))), labels


@functools.partial(jax.jit, static_argnames=("k", "iters"))
def kmedoids(
    key: jax.Array,
    points: jax.Array,
    valid: jax.Array,
    k: int,
    iters: int = 15,
) -> tuple[jax.Array, jax.Array]:
    """PAM-lite k-medoids: alternate assignment and per-cluster medoid update.

    Returns (medoid indices (k,), labels (N,)).
    """
    n = points.shape[0]
    logits = jnp.where(valid, 0.0, -jnp.inf)
    g = jax.random.gumbel(key, (n,))
    _, medoids = jax.lax.top_k(logits + g, k)
    d_all = pairwise_sqdist(points, points)
    d_all = jnp.where(valid[None, :], d_all, jnp.inf)

    def body(_, medoids):
        d = d_all[:, medoids]  # (N, k)
        labels = jnp.argmin(d, axis=-1)
        onehot = (jax.nn.one_hot(labels, k) * valid[:, None]).astype(bool)  # (N, k)
        # new medoid per cluster: point minimising intra-cluster distance sum
        costs = jnp.where(onehot.T[:, None, :], d_all[None], 0.0).sum(-1)  # (k, N)
        costs = jnp.where(onehot.T, costs, jnp.inf)
        return jnp.argmin(costs, axis=-1)

    medoids = jax.lax.fori_loop(0, iters, body, medoids)
    labels = jnp.argmin(d_all[:, medoids], axis=-1)
    return medoids, jnp.where(valid, labels, -1)
