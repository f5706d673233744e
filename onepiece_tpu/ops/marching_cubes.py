"""Marching cubes over TSDF voxel blocks.

Device redesign of the reference's per-cube meshing
(ref: src/Integration/MarchingCube.cpp:31-74 `MarchingCube`,
src/Integration/CubeHandler.cpp:70-114 `GenerateMeshByCube`): instead of a
std::thread fan-out over cubes (ref: CubeHandler.cpp:25-42), every voxel of
every block in a chunk is processed in one vectorised launch. Cross-block
corner values (the +1 halo the reference fetches from neighbour cubes) are
gathered from a host-provided neighbour-slot table, so the kernel is pure
gather + table lookup + interpolation with no data-dependent control flow.

Output is a padded triangle buffer with a validity mask. For production
extraction use `compact_triangles`, which compacts the padded buffer ON
DEVICE (bounded `jnp.nonzero` + gather) so only real triangles cross the
host link — the padded buffer is ~24 MB per 128-block chunk, which would
otherwise dominate extraction wall-clock.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .mc_tables import EDGE_CORNERS, MAX_TRIS_PER_VOXEL, TRI_TABLE
from .tsdf import CUBE_SIZE

# The 7 neighbour offsets needed for the +1 halo, in a fixed order.
NEIGHBOR_OFFSETS = np.array(
    [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 0, 1], [0, 1, 1], [1, 1, 1]],
    np.int32,
)

# Dense one-hot forms of the 256-case triangle table, so the per-voxel
# emission is pure matmul (a dynamic TRI_TABLE gather + take_along_axis of
# the 12 edge vertices compiled for minutes and ran slowly; the one-hot
# contraction compiles in seconds and is a plain matmul). K = MAX_T*3 vertex
# slots per voxel.
#   _SEL[config, k, e] = 1 iff vertex slot k of `config` reads edge e
#   _VALID[config, t] = 1 iff triangle t exists for `config`
_K = MAX_TRIS_PER_VOXEL * 3
_SEL = np.zeros((256, _K, 12), np.float32)
_VALID = np.zeros((256, MAX_TRIS_PER_VOXEL), np.float32)
for _cfg in range(256):
    for _t in range(MAX_TRIS_PER_VOXEL):
        _e0 = TRI_TABLE[_cfg, _t, 0]
        if _e0 >= 0:
            _VALID[_cfg, _t] = 1.0
            for _v in range(3):
                _SEL[_cfg, _t * 3 + _v, TRI_TABLE[_cfg, _t, _v]] = 1.0


def _halo_grid(values: jax.Array, neighbor_values: jax.Array) -> jax.Array:
    """Assemble (B, 9, 9, 9) corner grid from own block (B, 8, 8, 8) and its
    7 neighbours (B, 7, 8, 8, 8) (order = NEIGHBOR_OFFSETS)."""
    b = values.shape[0]
    n = CUBE_SIZE
    g = jnp.zeros((b, n + 1, n + 1, n + 1), values.dtype)
    g = g.at[:, :n, :n, :n].set(values)
    nx, ny, nz, nxy, nxz, nyz, nxyz = [neighbor_values[:, i] for i in range(7)]
    g = g.at[:, n, :n, :n].set(nx[:, 0, :, :])
    g = g.at[:, :n, n, :n].set(ny[:, :, 0, :])
    g = g.at[:, :n, :n, n].set(nz[:, :, :, 0])
    g = g.at[:, n, n, :n].set(nxy[:, 0, 0, :])
    g = g.at[:, n, :n, n].set(nxz[:, 0, :, 0])
    g = g.at[:, :n, n, n].set(nyz[:, :, 0, 0])
    g = g.at[:, n, n, n].set(nxyz[:, 0, 0, 0])
    return g


def gather_neighbors(pool_field: jax.Array, neighbor_slots: jax.Array, fill: float) -> jax.Array:
    """pool_field (P, 8, 8, 8), neighbor_slots (B, 7) int (-1 = absent)
    -> (B, 7, 8, 8, 8) with `fill` where absent."""
    safe = jnp.clip(neighbor_slots, 0, pool_field.shape[0] - 1)
    vals = pool_field[safe]
    return jnp.where((neighbor_slots >= 0)[..., None, None, None], vals, fill)


@functools.partial(jax.jit, static_argnames=("voxel_size", "iso"))
def extract_block_triangles(
    sdf: jax.Array,  # (B, 8, 8, 8) normalised tsdf of the chunk's blocks
    weight: jax.Array,  # (B, 8, 8, 8)
    color: jax.Array,  # (B, 8, 8, 8, 3)
    nbr_sdf: jax.Array,  # (B, 7, 8, 8, 8)
    nbr_weight: jax.Array,  # (B, 7, 8, 8, 8)
    nbr_color: jax.Array,  # (B, 7, 8, 8, 8, 3)
    block_coords: jax.Array,  # (B, 3) int32
    voxel_size: float,
    iso: float = 0.0,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Triangles for one chunk of blocks.

    Returns (tri_verts (B, 512, MAX_T, 3, 3) world coords,
             tri_colors (B, 512, MAX_T, 3, 3),
             tri_valid (B, 512, MAX_T) bool).
    """
    b = sdf.shape[0]
    n = CUBE_SIZE
    g = _halo_grid(sdf, nbr_sdf)  # (B, 9, 9, 9)
    gw = _halo_grid(weight, nbr_weight)
    gc = jnp.stack(
        [_halo_grid(color[..., i], nbr_color[..., i]) for i in range(3)], axis=-1
    )

    # corner gathers for each voxel: (B, n, n, n, 8)
    corner_pos = np.array([[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)])
    corners = jnp.stack(
        [
            g[:, dx : dx + n, dy : dy + n, dz : dz + n]
            for dx, dy, dz in corner_pos
        ],
        axis=-1,
    )
    cweights = jnp.stack(
        [gw[:, dx : dx + n, dy : dy + n, dz : dz + n] for dx, dy, dz in corner_pos],
        axis=-1,
    )
    ccolors = jnp.stack(
        [gc[:, dx : dx + n, dy : dy + n, dz : dz + n, :] for dx, dy, dz in corner_pos],
        axis=-2,
    )  # (B, n, n, n, 8, 3)

    voxel_ok = jnp.all(cweights > 0, axis=-1) & jnp.all(jnp.abs(corners) < 1.5, axis=-1)
    inside = corners < iso
    config = jnp.sum(
        inside.astype(jnp.int32) * (1 << np.arange(8, dtype=np.int32)), axis=-1
    )  # (B, n, n, n)

    # 12 edge-interpolated vertices per voxel
    ca = EDGE_CORNERS[:, 0]
    cb = EDGE_CORNERS[:, 1]
    va = corners[..., ca]  # (B, n, n, n, 12)
    vb = corners[..., cb]
    denom = va - vb
    denom_safe = jnp.where(jnp.abs(denom) > 1e-9, denom, 1.0)
    tpar = jnp.clip(jnp.where(jnp.abs(denom) > 1e-9, (va - iso) / denom_safe, 0.5), 0.0, 1.0)

    pa = jnp.asarray(corner_pos, jnp.float32)[ca]  # (12, 3) local corner offsets
    pb = jnp.asarray(corner_pos, jnp.float32)[cb]
    edge_local = pa[None, None, None, None] + tpar[..., None] * (pb - pa)[None, None, None, None]
    # world position: (block*8 + voxel_idx + local + 0.5) * voxel_size
    ii = jax.lax.broadcasted_iota(jnp.float32, (b, n, n, n), 1)
    jj = jax.lax.broadcasted_iota(jnp.float32, (b, n, n, n), 2)
    kk = jax.lax.broadcasted_iota(jnp.float32, (b, n, n, n), 3)
    base = (
        block_coords[:, None, None, None, :].astype(jnp.float32) * n
        + jnp.stack([ii, jj, kk], axis=-1)
    )
    edge_world = (base[..., None, :] + edge_local + 0.5) * voxel_size  # (B,n,n,n,12,3)

    cola = ccolors[..., ca, :]
    colb = ccolors[..., cb, :]
    edge_color = cola + tpar[..., None] * (colb - cola)

    # triangle emission as one-hot contractions (see _SEL/_VALID above):
    # config -> one-hot (V, 256), then one bf16 matmul picks each vertex
    # slot's edge selector, and an fp32 contraction over the 12 edges reads
    # the interpolated positions/colors. Zero dynamic gathers.
    nv = b * n * n * n
    cfg_flat = config.reshape(nv, 1)
    cfg_ids = jax.lax.broadcasted_iota(jnp.int32, (1, 256), 1)
    onehot = (cfg_flat == cfg_ids).astype(jnp.bfloat16)  # (V, 256)
    sel = jax.lax.dot_general(
        onehot, jnp.asarray(_SEL.reshape(256, _K * 12), jnp.bfloat16),
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT,
    ).reshape(nv, _K, 12)  # exact 0/1
    tri_ok_f = jax.lax.dot_general(
        onehot, jnp.asarray(_VALID, jnp.bfloat16),
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT,
    )  # (V, MAX_T)
    # fp32 edge reads keep world coordinates at full precision
    ew = edge_world.reshape(nv, 12, 3)
    ec = edge_color.reshape(nv, 12, 3)
    tv = jnp.einsum(
        "vke,ved->vkd", sel, ew, precision=jax.lax.Precision.HIGHEST
    ).reshape(b, n * n * n, MAX_TRIS_PER_VOXEL, 3, 3)
    tc = jnp.einsum(
        "vke,ved->vkd", sel, ec, precision=jax.lax.Precision.HIGHEST
    ).reshape(b, n * n * n, MAX_TRIS_PER_VOXEL, 3, 3)
    valid = (tri_ok_f > 0.5).reshape(b, n, n, n, MAX_TRIS_PER_VOXEL) & voxel_ok[..., None]
    valid = valid.reshape(b, n * n * n, MAX_TRIS_PER_VOXEL)
    return tv, tc, valid


@functools.partial(jax.jit, static_argnames=("cap",))
def compact_triangles(
    tv: jax.Array,  # (B, 512, MAX_T, 3, 3)
    tc: jax.Array,  # (B, 512, MAX_T, 3, 3)
    valid: jax.Array,  # (B, 512, MAX_T)
    cap: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Device-side compaction of the padded triangle buffer.

    Returns (verts (cap, 3, 3), colors (cap, 3, 3), count ()) where rows
    past `count` are zero. Rows beyond `cap` (overfull chunk) are dropped —
    callers size `cap` to the chunk's worst case and check the count.
    """
    v = valid.reshape(-1)
    nv = v.shape[0]
    (idx,) = jnp.nonzero(v, size=cap, fill_value=nv)
    tvf = tv.reshape(nv, 9)
    tcf = tc.reshape(nv, 9)
    ok = idx < nv
    safe = jnp.minimum(idx, nv - 1)
    out_v = jnp.where(ok[:, None], tvf[safe], 0.0).reshape(cap, 3, 3)
    out_c = jnp.where(ok[:, None], tcf[safe], 0.0).reshape(cap, 3, 3)
    return out_v, out_c, jnp.sum(v.astype(jnp.int32))
