"""Distributed bundle adjustment: point-sharded Schur reduction over a mesh.

This is the BASELINE.json collective: observations are sharded across
devices BY POINT (every observation of a point lives with its point), each
device builds its local U/S/rhs contributions, and one `psum` reduces the
6Fx6F camera system — the device replacement for the reference's
single-threaded sparse assembly (ref: src/Optimization/BundleAdjustment.cpp:
130-234). The reduced solve is tiny and runs replicated on every device
(single-controller pattern: identical systems, identical solutions, no
divergence across hosts). Point back-substitution is local to each shard.

Data layout: per-point padded tensors (P, Omax) — frame index, uv, mask —
the same grouping bundle.BAObservations uses for its Schur stage, so the
math matches optimization/bundle.py exactly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..geometry import se3


def per_point_layout(obs, num_points: int):
    """Convert flat BAObservations into per-point (P, Omax) tensors."""
    lists = np.asarray(obs.obs_of_point)
    mask = lists >= 0
    safe = np.clip(lists, 0, max(len(np.asarray(obs.frame)) - 1, 0))
    frame_pp = np.where(mask, np.asarray(obs.frame)[safe], 0)
    uv_pp = np.where(mask[..., None], np.asarray(obs.uv)[safe], 0.0)
    return (
        jnp.asarray(frame_pp, jnp.int32),
        jnp.asarray(uv_pp, jnp.float32),
        jnp.asarray(mask),
    )


def _local_schur(poses, points_sh, frame_pp, uv_pp, mask_pp, lam, fx, fy, cx, cy, F):
    """One shard's U/S/rhs contributions + local V/W/b_p.

    points_sh: (Ps, 3); frame_pp: (Ps, Omax); returns psum-ready arrays.
    """
    T = poses[frame_pp]  # (Ps, Omax, 4, 4)
    pw = points_sh[:, None, :]
    pc = jnp.einsum("poij,poj->poi", T[..., :3, :3], jnp.broadcast_to(pw, frame_pp.shape + (3,))) + T[..., :3, 3]
    z = pc[..., 2]
    zs = jnp.where(z > 1e-6, z, 1.0)
    u = pc[..., 0] / zs * fx + cx
    v = pc[..., 1] / zs * fy + cy
    r = jnp.stack([u, v], -1) - uv_pp  # (Ps, Omax, 2)
    w = (mask_pp & (z > 1e-6)).astype(jnp.float32)

    iz = 1.0 / zs
    zero = jnp.zeros_like(z)
    J_pc = jnp.stack(
        [
            jnp.stack([fx * iz, zero, -fx * pc[..., 0] * iz * iz], -1),
            jnp.stack([zero, fy * iz, -fy * pc[..., 1] * iz * iz], -1),
        ],
        axis=-2,
    )  # (Ps, Omax, 2, 3)
    J_pose = jnp.concatenate(
        [J_pc, jnp.einsum("pokj,poji->poki", J_pc, -se3.skew(pc))], axis=-1
    )  # (Ps, Omax, 2, 6)
    J_point = jnp.einsum("pokj,poji->poki", J_pc, T[..., :3, :3])  # (Ps, Omax, 2, 3)

    U = jnp.zeros((F, 6, 6)).at[frame_pp].add(
        jnp.einsum("poki,po,pokj->poij", J_pose, w, J_pose)
    )
    V = jnp.einsum("poki,po,pokj->pij", J_point, w, J_point)
    # Marquardt (diagonal-relative) damping — see optimization/bundle.py:
    # an absolute lambda underflows f32 addition at real problem scales
    dV = jnp.einsum("pii->p", V) / 3.0
    V = V + (lam * jnp.abs(V) + (1e-6 * dV[:, None, None] + 1e-9)) * jnp.eye(3)
    W = jnp.einsum("poki,po,pokj->poij", J_pose, w, J_point)  # (Ps, Omax, 6, 3)
    b_c = jnp.zeros((F, 6)).at[frame_pp].add(jnp.einsum("poki,po,pok->poi", J_pose, w, r))
    b_p = jnp.einsum("poki,po,pok->pi", J_point, w, r)  # (Ps, 3)

    Vinv = jnp.linalg.inv(V)
    # Schur cross term as one dense matmul per shard (same formulation as
    # optimization/bundle.py ba_step): assemble the shard's block-sparse W
    # as (6F, 3Ps) dense and let one matmul do the pair reduction — the old
    # (Ps, Omax, Omax, 6, 6) pair tensor was the scaling bomb.
    ps = W.shape[0]
    Wd = jnp.zeros((F, 6, ps, 3)).at[
        frame_pp, :, jnp.arange(ps)[:, None], :
    ].add(W)
    Ym = jnp.einsum("fipk,pkl->fipl", Wd, Vinv).reshape(F * 6, ps * 3)
    Wm = Wd.reshape(F * 6, ps * 3)
    S_sub = Ym @ Wm.T  # (6F, 6F)
    rhs_sub = (Ym @ b_p.reshape(ps * 3)).reshape(F, 6)
    cost = jnp.einsum("po,pok->", w, r * r)
    return U, S_sub, b_c, rhs_sub, Vinv, Wm, b_p, cost


def distributed_ba_step(
    poses: jax.Array,  # (F, 4, 4) replicated
    points: jax.Array,  # (P, 3) sharded on axis 0
    frame_pp: jax.Array,  # (P, Omax)
    uv_pp: jax.Array,  # (P, Omax, 2)
    mask_pp: jax.Array,  # (P, Omax)
    mesh: Mesh,
    lam: float = 1e-4,
    fx: float = 300.0, fy: float = 300.0, cx: float = 160.0, cy: float = 120.0,
    axis: str = "d",
):
    """One damped BA step with the Schur system psum-reduced over the mesh.

    Returns (new_poses (F,4,4) replicated, new_points (P,3) sharded, cost).
    """
    F = poses.shape[0]
    lamf = jnp.float32(lam)

    @jax.jit
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P(axis), P()),
        check_vma=False,
    )
    def step(poses_r, pts_sh, f_sh, uv_sh, m_sh):
        U, S_sub, b_c, rhs_sub, Vinv, Wm, b_p, cost = _local_schur(
            poses_r, pts_sh, f_sh, uv_sh, m_sh, lamf, fx, fy, cx, cy, F
        )
        # the collective: reduce camera-system contributions over ICI
        U = jax.lax.psum(U, axis)
        S_sub = jax.lax.psum(S_sub, axis)
        b_c = jax.lax.psum(b_c, axis)
        rhs_sub = jax.lax.psum(rhs_sub, axis)
        cost = jax.lax.psum(cost, axis)

        dU = jnp.einsum("fii->f", U) / 6.0
        U = U + (lamf * jnp.abs(U) + (1e-6 * dU[:, None, None] + 1e-9)) * jnp.eye(6)
        fi = jnp.arange(F * 6).reshape(F, 6)
        S = (-S_sub).at[fi[:, :, None], fi[:, None, :]].add(U)
        bd = (b_c - rhs_sub).reshape(F * 6)
        L = jnp.linalg.cholesky(S[6:, 6:] + 1e-9 * jnp.eye(6 * (F - 1)))
        dc = jax.scipy.linalg.cho_solve((L, True), -bd[6:])
        ok = jnp.all(jnp.isfinite(dc))
        dc = jnp.where(ok, dc, 0.0)
        delta_c = jnp.concatenate([jnp.zeros((1, 6)), dc.reshape(F - 1, 6)], 0)
        new_poses = jnp.einsum("fij,fjk->fik", se3.se3_exp(delta_c), poses_r)

        # local point back-substitution (Wm^T maps camera deltas to points)
        ps = pts_sh.shape[0]
        wtdc = (Wm.T @ delta_c.reshape(F * 6)).reshape(ps, 3)
        dp = -jnp.einsum("pij,pj->pi", Vinv, b_p + wtdc)
        dp = jnp.where(ok, dp, 0.0)
        return new_poses, pts_sh + dp, cost

    return step(poses, points, frame_pp, uv_pp, mask_pp)


def dryrun(mesh: Mesh, axis: str = "d") -> None:
    """Tiny synthetic BA problem, one distributed step; checks vs single-dev."""
    rng = np.random.default_rng(0)
    F, Pn, Omax = 4, 8 * mesh.shape[axis], 3
    poses = jnp.broadcast_to(jnp.eye(4), (F, 4, 4)).astype(jnp.float32)
    pts = jnp.asarray(rng.uniform(-0.5, 0.5, (Pn, 3)) + np.array([0, 0, 2.0]), jnp.float32)
    frame_pp = jnp.asarray(rng.integers(0, F, (Pn, Omax)), jnp.int32)
    z = np.asarray(pts)[:, 2:3]
    uv_pp = jnp.asarray(
        np.stack(
            [
                np.asarray(pts)[:, 0:1] / z * 300.0 + 160.0 + rng.normal(0, 1, (Pn, 1)),
                np.asarray(pts)[:, 1:2] / z * 300.0 + 120.0 + rng.normal(0, 1, (Pn, 1)),
            ],
            -1,
        ).repeat(Omax, axis=1),
        jnp.float32,
    )
    mask_pp = jnp.ones((Pn, Omax), bool)
    new_poses, new_points, cost = distributed_ba_step(
        poses, pts, frame_pp, uv_pp, mask_pp, mesh, axis=axis
    )
    assert np.isfinite(np.asarray(new_poses)).all()
    assert np.isfinite(np.asarray(new_points)).all()
    print("parallel.ba dryrun ok: cost", float(cost))
