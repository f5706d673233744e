"""Sharded TSDF voxel-block pool: integration over a device mesh.

The block pool (SURVEY §2.10 axis 3) shards on the block axis — each device
owns capacity/n_dev blocks; the depth/color frame and pose are replicated
(a frame is ~1.2 MB — broadcast is free relative to HBM-resident pools).
Integration is embarrassingly parallel per block, so the sharded step needs
NO collectives; cross-device work appears only at meshing halos (host-side
neighbour gather in round 1) and block migration (all_to_all, future).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops import tsdf as tsdf_ops


def integrate_blocks_sharded(
    sdf: jax.Array,  # (B, 512)
    weight: jax.Array,
    color: jax.Array,  # (B, 512, 3)
    block_coords: jax.Array,  # (B, 3)
    block_active: jax.Array,  # (B,)
    depth: jax.Array,
    rgb: jax.Array,
    T_cw: jax.Array,
    mesh: Mesh,
    fx: float, fy: float, cx: float, cy: float,
    voxel_size: float,
    truncation: float,
    axis: str = "d",
):
    """Same math as ops.tsdf.integrate_blocks with the block axis sharded."""

    @jax.jit
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(), P(), P()),
        out_specs=(P(axis), P(axis), P(axis)),
        check_vma=False,
    )
    def step(sdf_s, w_s, c_s, bc_s, act_s, depth_r, rgb_r, T_r):
        return tsdf_ops.integrate_blocks(
            sdf_s, w_s, c_s, bc_s, act_s, depth_r, rgb_r, T_r,
            fx, fy, cx, cy, voxel_size, truncation,
        )

    return step(sdf, weight, color, block_coords, block_active, depth, rgb, T_cw)


def dryrun(mesh: Mesh, camera, axis: str = "d") -> None:
    """Integrate one synthetic frame into a sharded pool; compare vs local."""
    n_dev = mesh.shape[axis]
    B = 16 * n_dev
    rng = np.random.default_rng(0)
    sdf = jnp.full((B, 512), tsdf_ops.EMPTY_SDF)
    w = jnp.zeros((B, 512))
    c = jnp.zeros((B, 512, 3))
    coords = jnp.asarray(rng.integers(-4, 4, (B, 3)), jnp.int32)
    active = jnp.ones((B,), bool)
    h, wd = camera.height, camera.width
    depth = jnp.full((h, wd), 1.5)
    rgb = jnp.full((h, wd, 3), 0.5)
    T = jnp.eye(4)
    args = (sdf, w, c, coords, active, depth, rgb, T)
    kw = dict(
        fx=camera.fx, fy=camera.fy, cx=camera.cx, cy=camera.cy,
        voxel_size=0.05, truncation=0.25,
    )
    s1, w1, c1 = integrate_blocks_sharded(*args, mesh=mesh, axis=axis, **kw)
    s2, w2, c2 = tsdf_ops.integrate_blocks(*args, **kw)
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), atol=1e-6)
    np.testing.assert_allclose(np.asarray(w1), np.asarray(w2), atol=1e-6)
    print("parallel.tsdf dryrun ok: updated voxels", int((np.asarray(w1) > 0).sum()))
