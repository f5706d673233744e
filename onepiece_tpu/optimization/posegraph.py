"""Pose-graph Gauss-Newton over 3D-3D correspondence edges ("FastBA").

Device redesign of `SimpleBA` (ref: src/Optimization/SimpleBA.{h,cpp}): the
reference loops edges and correspondences, assembling a sparse 6Nx6N system
with Eigen triplets and SimplicialLDLT (ref: SimpleBA.cpp:18-156). Here all
edge contributions are computed with one vmap and scatter-added into a dense
(N, N, 6, 6) block matrix — at keyframe counts (N ~ 1e2..1e3) the dense
Cholesky is small and runs entirely on device.

Residual model (matching ref ComputeJTJAndJTr, SimpleBA.cpp:18-78): for edge
(s, t) with local correspondence pairs (p in frame s, q in frame t):
    r = T_s p - T_t q                       (world-frame 3-vector)
    J wrt left-mult twist of T_s: [ I | -[T_s p]_x ]
    J wrt T_t:                   -[ I | -[T_t q]_x ]
Pose 0 is gauge-fixed (ref: SimpleBA.cpp first-pose handling).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3

DEFAULT_ITERS = 5  # ref: SimpleBA.cpp runs 5 GN iterations


class PoseGraphEdges(NamedTuple):
    """Padded edge tensors (ref Correspondence, src/Optimization/Correspondence.h)."""

    src: jax.Array  # (E,) int32 source keyframe index
    dst: jax.Array  # (E,) int32 target keyframe index
    p_src: jax.Array  # (E, C, 3) points in source-frame coords
    p_dst: jax.Array  # (E, C, 3) matched points in target-frame coords
    valid: jax.Array  # (E, C) bool
    edge_valid: jax.Array  # (E,) bool


def _edge_blocks(T_src, T_dst, p_src, p_dst, valid):
    """Per-edge 6x6 blocks and rhs. All args for ONE edge (C, 3)/(C,)."""
    pw = p_src @ T_src[:3, :3].T + T_src[:3, 3]
    qw = p_dst @ T_dst[:3, :3].T + T_dst[:3, 3]
    r = pw - qw  # (C, 3)
    w = valid.astype(jnp.float32)
    # J_s = [I | -skew(pw)], J_t = -[I | -skew(qw)]   (C, 3, 6)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=pw.dtype), pw.shape[:-1] + (3, 3))
    Js = jnp.concatenate([eye, -se3.skew(pw)], axis=-1)
    Jt = -jnp.concatenate([eye, -se3.skew(qw)], axis=-1)
    Hss = jnp.einsum("cki,c,ckj->ij", Js, w, Js)
    Htt = jnp.einsum("cki,c,ckj->ij", Jt, w, Jt)
    Hst = jnp.einsum("cki,c,ckj->ij", Js, w, Jt)
    bs = jnp.einsum("cki,c,ck->i", Js, w, r)
    bt = jnp.einsum("cki,c,ck->i", Jt, w, r)
    cost = jnp.einsum("c,ck->", w, r * r)
    return Hss, Htt, Hst, bs, bt, cost


@functools.partial(jax.jit, static_argnames=("num_poses",))
def _gn_step(poses: jax.Array, edges: PoseGraphEdges, num_poses: int, damping: float = 1e-6):
    T_src = poses[edges.src]
    T_dst = poses[edges.dst]
    ev = edges.edge_valid[:, None] & edges.valid
    Hss, Htt, Hst, bs, bt, cost = jax.vmap(_edge_blocks)(
        T_src, T_dst, edges.p_src, edges.p_dst, ev
    )
    n = num_poses
    H = jnp.zeros((n, n, 6, 6), jnp.float32)
    H = H.at[edges.src, edges.src].add(Hss)
    H = H.at[edges.dst, edges.dst].add(Htt)
    H = H.at[edges.src, edges.dst].add(Hst)
    H = H.at[edges.dst, edges.src].add(jnp.swapaxes(Hst, -1, -2))
    b = jnp.zeros((n, 6), jnp.float32)
    b = b.at[edges.src].add(bs)
    b = b.at[edges.dst].add(bt)

    Hd = H.transpose(0, 2, 1, 3).reshape(n * 6, n * 6)
    bd = b.reshape(n * 6)
    # gauge fix: drop pose 0
    A = Hd[6:, 6:] + damping * jnp.eye(6 * (n - 1), dtype=jnp.float32)
    rhs = -bd[6:]
    L = jnp.linalg.cholesky(A)
    delta = jax.scipy.linalg.cho_solve((L, True), rhs)
    ok = jnp.all(jnp.isfinite(delta))
    delta = jnp.where(ok, delta, 0.0)
    xi = jnp.concatenate([jnp.zeros((1, 6)), delta.reshape(n - 1, 6)], axis=0)
    new_poses = jnp.einsum("nij,njk->nik", se3.se3_exp(xi), poses)
    return new_poses, jnp.sum(cost)


def optimize_pose_graph(
    poses: jax.Array,  # (N, 4, 4) world-from-frame
    edges: PoseGraphEdges,
    iters: int = DEFAULT_ITERS,
    damping: float = 1e-6,
) -> tuple[jax.Array, jax.Array]:
    """Run GN iterations; returns (optimized poses, final cost)."""
    n = poses.shape[0]
    cost = jnp.float32(0.0)
    for _ in range(iters):
        poses, cost = _gn_step(poses, edges, n, damping)
    return poses, cost


def build_edges(edge_list: list[dict], corr_capacity: int, num_edges_cap: int | None = None) -> PoseGraphEdges:
    """Host helper: pack a python list of edges into padded tensors.

    edge_list entries: {"src": int, "dst": int, "p_src": (C_i, 3) array,
    "p_dst": (C_i, 3) array}. Correspondences are truncated/padded to
    corr_capacity; edges padded to num_edges_cap.
    """
    import numpy as np

    e = len(edge_list)
    cap_e = num_edges_cap or max(e, 1)
    src = np.zeros(cap_e, np.int32)
    dst = np.zeros(cap_e, np.int32)
    ps = np.zeros((cap_e, corr_capacity, 3), np.float32)
    pd = np.zeros((cap_e, corr_capacity, 3), np.float32)
    val = np.zeros((cap_e, corr_capacity), bool)
    eval_ = np.zeros(cap_e, bool)
    for i, ed in enumerate(edge_list[:cap_e]):
        c = min(len(ed["p_src"]), corr_capacity)
        src[i] = ed["src"]
        dst[i] = ed["dst"]
        ps[i, :c] = ed["p_src"][:c]
        pd[i, :c] = ed["p_dst"][:c]
        val[i, :c] = True
        eval_[i] = True
    return PoseGraphEdges(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(ps), jnp.asarray(pd),
        jnp.asarray(val), jnp.asarray(eval_),
    )
