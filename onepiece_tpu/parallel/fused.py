"""Multi-chip sharding of the device-resident fused TSDF path.

Scales SURVEY §2.10 axis 3 (voxel-block sharding) for the production
pipeline (systems/fused_slam.py): the voxel pool shards across the mesh on
the slot axis while the block hash table stays REPLICATED — allocation
(`device_hash.insert`) is deterministic, so every device derives the same
{key -> slot} assignment from the same frame without any collective. Each
device then integrates only the touched slots that fall in its own pool
shard (everything else is routed to the shard's trash row), which makes the
per-frame integration collective-free: the only cross-device traffic is the
(replicated) frame broadcast and, later, meshing halos.

Layout: `vox_sh` is (n_dev, cap_local + 1, 5, 512) sharded on axis 0; each
device's shard carries its own trash row, so `tsdf_triton.integrate_slots` runs
unmodified on the local shard.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..geometry import se3
from ..integration import device_hash as dh
from ..integration.blocks import N_VOX, make_pool
from ..ops import tsdf as tsdf_ops
from ..ops import tsdf_triton


def make_sharded_pool(mesh: Mesh, cap_local: int, axis: str = "d") -> jax.Array:
    """(n_dev, cap_local+1, 5, 512) pool, sharded on the device axis."""
    n_dev = mesh.shape[axis]
    vox = jnp.zeros((n_dev, cap_local + 1, 5, N_VOX), jnp.float32)
    vox = vox.at[:, :, 0, :].set(tsdf_ops.EMPTY_SDF)
    return jax.device_put(vox, NamedSharding(mesh, P(axis)))


def fused_tsdf_step_sharded(
    vox_sh: jax.Array,  # (n_dev, cap_local+1, 5, 512) sharded on axis 0
    table: dh.BlockHashTable,  # replicated
    depth_f: jax.Array,  # (H, W) filtered metric depth
    gray: jax.Array,  # (H, W)
    T_w: jax.Array,  # (4, 4)
    mesh: Mesh,
    fx: float, fy: float, cx: float, cy: float,
    voxel_size: float,
    truncation: float,
    kmax: int = 4096,
    stride: int = 6,
    axis: str = "d",
    interpret: bool = False,
):
    """One frame's allocation + integration on the sharded pool.

    Returns (vox_sh', table'). No collectives: allocation is replicated
    deterministic compute; integration touches only local slots.
    """
    cap_local = vox_sh.shape[1] - 1
    cap_total = cap_local * mesh.shape[axis]
    assert table.block_coords.shape[0] >= cap_total

    @jax.jit
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(), P(), P(), P()),
        out_specs=(P(axis), P()),
        check_vma=False,
    )
    def step(vox_l, table_r, depth_r, gray_r, T_r):
        vox_l = vox_l[0]  # (cap_local+1, 5, 512)
        keys = tsdf_ops.touched_block_keys(
            depth_r, T_r, fx, fy, cx, cy, voxel_size, truncation,
            max_blocks=kmax, stride=stride,
        )
        table2, slots = dh.insert(table_r, keys)
        r = jax.lax.axis_index(axis)
        local = slots - r * cap_local
        local = jnp.where(
            (slots >= 0) & (local >= 0) & (local < cap_local), local, cap_local
        ).astype(jnp.int32)
        vox_l = tsdf_triton.integrate_slots(
            vox_l, keys, local, depth_r, gray_r[..., None], se3.inverse_T(T_r),
            fx, fy, cx, cy, voxel_size, truncation, interpret=interpret,
        )
        return vox_l[None], table2

    return step(vox_sh, table, depth_f, gray, T_w)


def gather_pool(vox_sh: jax.Array) -> jax.Array:
    """Collect the sharded pool into one (cap_total+1, 5, 512) host-side
    pool in global-slot order (for meshing / checkpoint)."""
    n_dev, cap_l1, c, v = vox_sh.shape
    arr = np.asarray(vox_sh)  # (n_dev, cap_local+1, 5, 512)
    body = arr[:, :-1].reshape(n_dev * (cap_l1 - 1), c, v)
    out = np.concatenate([body, arr[:1, -1]], axis=0)
    return jnp.asarray(out)


def dryrun(mesh: Mesh, camera, axis: str = "d", interpret: bool = False) -> None:
    """One synthetic frame through the sharded fused path; verify the
    gathered pool matches the single-device fused integration bit-exactly."""
    from ..utils import synthetic

    scene = synthetic.default_scene()
    T_w = jnp.eye(4)
    depth, gray = synthetic.render(
        scene, T_w, camera.fx, camera.fy, camera.cx, camera.cy,
        camera.height, camera.width, num_steps=32,
    )
    n_dev = mesh.shape[axis]
    cap_local = 512
    cap_total = cap_local * n_dev
    vox_sh = make_sharded_pool(mesh, cap_local, axis)
    table = dh.make_table(1 << 13, cap_total)
    vox_sh, table2 = fused_tsdf_step_sharded(
        vox_sh, table, depth, gray, T_w, mesh,
        camera.fx, camera.fy, camera.cx, camera.cy,
        0.05, 0.2, kmax=1024, stride=4, axis=axis, interpret=interpret,
    )
    got = gather_pool(vox_sh)

    # single-device oracle
    vox1 = make_pool(cap_total)
    keys = tsdf_ops.touched_block_keys(
        depth, T_w, camera.fx, camera.fy, camera.cx, camera.cy,
        0.05, 0.2, max_blocks=1024, stride=4,
    )
    _, slots = dh.insert(dh.make_table(1 << 13, cap_total), keys)
    slots_safe = jnp.where(slots < 0, cap_total, slots).astype(jnp.int32)
    vox1 = tsdf_triton.integrate_slots(
        vox1, keys, slots_safe, depth, gray[..., None], se3.inverse_T(T_w),
        camera.fx, camera.fy, camera.cx, camera.cy, 0.05, 0.2, interpret=interpret,
    )
    a = np.asarray(got[:-1])
    b = np.asarray(vox1[:-1])
    if not np.array_equal(a, b):
        raise AssertionError(
            f"sharded fused TSDF mismatch: {np.abs(a - b).max()}"
        )
    updated = int((np.asarray(got[:-1, 1]) > 0).sum())
    print(f"parallel.fused dryrun ok: {n_dev} shards, {updated} voxels updated")
