"""Distributed pose-graph Gauss-Newton: edge-sharded JTJ/JTr over a mesh.

SURVEY §2.10 axis 2's second half: the full-BA Schur reduction is already
sharded (parallel/ba.py); this shards the pose-graph ("FastBA") solve the
same way. Edges are partitioned across devices, each device vmaps its edge
shard into local (N, N, 6, 6) / (N, 6) normal-equation contributions, ONE
`psum` reduces them over ICI, and the small 6Nx6N Cholesky runs replicated
on every device (single-controller pattern: identical inputs -> bitwise
identical poses on every device, no cross-host divergence to reconcile).

Replaces the reference's serial sparse assembly + SimplicialLDLT
(ref: src/Optimization/SimpleBA.cpp:80-156, the :137-141 solve) at
keyframe counts (10^3) where a single host's assembly dominates.
The math is optimization/posegraph.py's `_gn_step` verbatim — the test
asserts mm-level agreement with the replicated solver and bitwise
equality across devices.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..geometry import se3
from ..optimization.posegraph import DEFAULT_ITERS, PoseGraphEdges, _edge_blocks


def shard_edges(edges: PoseGraphEdges, mesh: Mesh, axis: str = "d") -> PoseGraphEdges:
    """Pad the edge axis to a multiple of the mesh and device_put sharded."""
    n_dev = mesh.shape[axis]
    e = edges.src.shape[0]
    pad = (-e) % n_dev

    def prep(a):
        if pad:
            a = jnp.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))
        return jax.device_put(a, NamedSharding(mesh, P(axis)))

    return PoseGraphEdges(*(prep(a) for a in edges))


@functools.partial(
    jax.jit, static_argnames=("mesh", "num_poses", "damping", "axis")
)
def _gn_step_sharded(
    poses: jax.Array,
    edges: PoseGraphEdges,
    mesh: Mesh,
    num_poses: int,
    damping: float = 1e-6,
    axis: str = "d",
):
    n = num_poses

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(),) + (P(axis),) * 6,
        out_specs=(P(), P()),
        check_vma=False,
    )
    def step(poses_r, src, dst, p_src, p_dst, valid, edge_valid):
        ev = edge_valid[:, None] & valid
        Hss, Htt, Hst, bs, bt, cost = jax.vmap(_edge_blocks)(
            poses_r[src], poses_r[dst], p_src, p_dst, ev
        )
        H = jnp.zeros((n, n, 6, 6), jnp.float32)
        H = H.at[src, src].add(Hss)
        H = H.at[dst, dst].add(Htt)
        H = H.at[src, dst].add(Hst)
        H = H.at[dst, src].add(jnp.swapaxes(Hst, -1, -2))
        b = jnp.zeros((n, 6), jnp.float32)
        b = b.at[src].add(bs)
        b = b.at[dst].add(bt)

        # THE collective: one psum of the assembled normal equations
        H = jax.lax.psum(H, axis)
        b = jax.lax.psum(b, axis)
        cost = jax.lax.psum(jnp.sum(cost), axis)

        # replicated solve, identical on every device (same as
        # optimization/posegraph._gn_step from here on)
        Hd = H.transpose(0, 2, 1, 3).reshape(n * 6, n * 6)
        bd = b.reshape(n * 6)
        A = Hd[6:, 6:] + damping * jnp.eye(6 * (n - 1), dtype=jnp.float32)
        rhs = -bd[6:]
        L = jnp.linalg.cholesky(A)
        delta = jax.scipy.linalg.cho_solve((L, True), rhs)
        ok = jnp.all(jnp.isfinite(delta))
        delta = jnp.where(ok, delta, 0.0)
        xi = jnp.concatenate([jnp.zeros((1, 6)), delta.reshape(n - 1, 6)], 0)
        new_poses = jnp.einsum("nij,njk->nik", se3.se3_exp(xi), poses_r)
        return new_poses, cost

    return step(
        poses, edges.src, edges.dst, edges.p_src, edges.p_dst,
        edges.valid, edges.edge_valid,
    )


def optimize_pose_graph_sharded(
    poses: jax.Array,  # (N, 4, 4) world-from-frame, replicated
    edges: PoseGraphEdges,  # edge axis sharded over the mesh
    mesh: Mesh,
    iters: int = DEFAULT_ITERS,
    damping: float = 1e-6,
    axis: str = "d",
) -> tuple[jax.Array, jax.Array]:
    """Edge-sharded pose-graph GN; returns (optimized poses, final cost)."""
    n = poses.shape[0]
    cost = jnp.float32(0.0)
    for _ in range(iters):
        poses, cost = _gn_step_sharded(poses, edges, mesh, n, damping, axis)
    return poses, cost


def dryrun(mesh: Mesh, axis: str = "d") -> None:
    """Ring pose graph, one sharded GN iteration; finiteness-checked."""
    from ..optimization.posegraph import build_edges

    rng = np.random.default_rng(0)
    n = 8
    pts = rng.uniform(-1, 1, (24, 3)).astype(np.float32)
    edge_list = [
        {"src": i, "dst": (i + 1) % n, "p_src": pts, "p_dst": pts}
        for i in range(n)
    ]
    edges = shard_edges(build_edges(edge_list, corr_capacity=24), mesh, axis)
    poses = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (n, 4, 4))
    new_poses, cost = optimize_pose_graph_sharded(poses, edges, mesh, iters=2, axis=axis)
    assert np.isfinite(np.asarray(new_poses)).all()
    print("parallel.posegraph dryrun ok: cost", float(cost))
