"""TSDF voxel-block integration ops.

Array-first redesign of the reference's per-cube projective TSDF update
(ref: src/Integration/Integrator.cpp:36-94 `IntegrateImage`,
src/Integration/TSDFVoxel.h:8-82). The reference loops cubes on the host and
voxels per cube; here ALL active blocks integrate in one device launch over
`[B, CUBE^3]` — a pure gather from the depth/color images with a masked
weighted-average update. No scatter conflicts exist because each voxel is
owned by exactly one block.

Conventions (matching the reference):
  - CUBE_SIZE = 8 voxels per block edge (ref: src/Integration/VoxelCube.h:4)
  - sdf initialised to 999 (= "empty", ref: TSDFVoxel.h), weight 0
  - truncated sdf stored normalised to [-1, 1] (sdf / truncation)
  - running weighted average with per-update weight 1, weight clamped
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

CUBE_SIZE = 8
EMPTY_SDF = 999.0


def voxel_centers_world(block_coords: jax.Array, voxel_size: float) -> jax.Array:
    """World-space voxel centers for blocks (B, 3)int -> (B, CUBE^3, 3)f32.

    Block with integer coords c covers world AABB
    [c * CUBE_SIZE * voxel_size, (c+1) * CUBE_SIZE * voxel_size); voxel (i,j,k)
    center sits at (c*CUBE + (i,j,k) + 0.5) * voxel_size.
    (ref: VoxelCube.h:63-92 GetGlobalPoint cube/voxel id math.)
    """
    n = CUBE_SIZE
    ii = jax.lax.broadcasted_iota(jnp.int32, (n, n, n), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (n, n, n), 1)
    kk = jax.lax.broadcasted_iota(jnp.int32, (n, n, n), 2)
    local = jnp.stack([ii, jj, kk], axis=-1).reshape(-1, 3)  # (512, 3) x-major
    pos = (block_coords[:, None, :] * n + local[None, :, :]).astype(jnp.float32)
    return (pos + 0.5) * voxel_size


@functools.partial(jax.jit, static_argnames=("voxel_size", "truncation", "max_weight", "use_color"))
def integrate_blocks(
    sdf: jax.Array,  # (B, 512) normalised tsdf
    weight: jax.Array,  # (B, 512)
    color: jax.Array,  # (B, 512, 3)
    block_coords: jax.Array,  # (B, 3) int32
    block_active: jax.Array,  # (B,) bool — only active blocks update
    depth: jax.Array,  # (H, W) meters, 0 invalid
    rgb: jax.Array,  # (H, W, 3) float
    T_cw: jax.Array,  # (4, 4) world-to-camera
    fx: float, fy: float, cx: float, cy: float,
    voxel_size: float,
    truncation: float,
    max_weight: float = 100.0,
    use_color: bool = True,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """One frame's TSDF update for all blocks at once. Returns new (sdf, weight, color).

    Matches ref Integrator.cpp:36-94: project voxel center, nearest-pixel
    depth lookup, sdf = depth - z_cam, integrate if sdf > -truncation,
    weight-1 running average of normalised sdf and color.
    """
    h, w = depth.shape
    pts_w = voxel_centers_world(block_coords, voxel_size)  # (B, 512, 3)
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    pc = jnp.einsum("ij,bnj->bni", R, pts_w) + t
    z = pc[..., 2]
    zsafe = jnp.where(z > 1e-6, z, 1.0)
    u = pc[..., 0] / zsafe * fx + cx
    v = pc[..., 1] / zsafe * fy + cy
    ui = jnp.round(u).astype(jnp.int32)
    vi = jnp.round(v).astype(jnp.int32)
    inb = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h) & (z > 1e-6)
    uic = jnp.clip(ui, 0, w - 1)
    vic = jnp.clip(vi, 0, h - 1)
    d_px = depth[vic, uic]
    sdf_m = d_px - z  # metric signed distance along ray
    upd = inb & (d_px > 0) & (sdf_m > -truncation) & block_active[:, None]

    tsdf_new = jnp.clip(sdf_m / truncation, -1.0, 1.0)
    w_old = weight
    w_new = jnp.where(upd, jnp.minimum(w_old + 1.0, max_weight), w_old)
    # treat EMPTY (weight 0) as zero-contribution
    sdf_safe = jnp.where(w_old > 0, sdf, 0.0)
    sdf_out = jnp.where(
        upd, (sdf_safe * w_old + tsdf_new) / jnp.clip(w_old + 1.0, 1.0, None), sdf
    )
    if use_color:
        c_px = rgb[vic, uic]
        c_safe = jnp.where(w_old[..., None] > 0, color, 0.0)
        c_out = jnp.where(
            upd[..., None],
            (c_safe * w_old[..., None] + c_px) / jnp.clip(w_old[..., None] + 1.0, 1.0, None),
            color,
        )
    else:
        c_out = color
    return sdf_out, w_new, c_out


# truncation-band sampling offsets along each ray (fractions of truncation)
OFFSET_FRACTIONS = (-1.0, -0.5, 0.0, 0.5, 1.0)


@functools.partial(jax.jit, static_argnames=("voxel_size", "truncation"))
def touched_block_coords(
    depth: jax.Array,
    T_wc: jax.Array,  # camera-to-world
    fx: float, fy: float, cx: float, cy: float,
    voxel_size: float,
    truncation: float,
) -> tuple[jax.Array, jax.Array]:
    """Block coords touched by the truncation band around observed surfaces.

    Replaces PrepareCubes' AABB + frustum + corner-SDF scan
    (ref: src/Integration/CubeHandler.cpp:116-196) with a direct device
    computation: every valid pixel contributes the blocks containing points
    at offsets {-trunc, 0, +trunc} (and midpoints) along its ray. The host
    uniquifies the returned (N, 3) int coords and allocates pool slots.
    Returns (coords (N*K, 3) int32, valid (N*K,) bool).
    """
    h, w = depth.shape
    v = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    u = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    valid = depth > 0
    dirs = jnp.stack([(u - cx) / fx, (v - cy) / fy, jnp.ones_like(u)], axis=-1)
    R = T_wc[:3, :3]
    t = T_wc[:3, 3]
    block_edge = voxel_size * CUBE_SIZE
    offsets = jnp.array(OFFSET_FRACTIONS) * truncation
    coords = []
    for off in offsets:
        z = depth + off
        pts_c = dirs * z[..., None]
        pts_w = pts_c @ R.T + t
        coords.append(jnp.floor(pts_w / block_edge).astype(jnp.int32).reshape(-1, 3))
    k = len(offsets)
    return jnp.concatenate(coords), jnp.tile(valid.reshape(-1), (k,))


INVALID_KEY = jnp.int32((1 << 30))


@functools.partial(
    jax.jit, static_argnames=("voxel_size", "truncation", "max_blocks", "stride")
)
def touched_block_keys(
    depth: jax.Array,
    T_wc: jax.Array,
    fx: float, fy: float, cx: float, cy: float,
    voxel_size: float,
    truncation: float,
    max_blocks: int = 4096,
    stride: int = 4,
) -> jax.Array:
    """Unique packed block keys touched by the truncation band, ON DEVICE.

    The naive coord list is H*W*5 x 3 ints (~18 MB/frame of host transfer);
    a device-side fixed-size `jnp.unique` over 30-bit packed keys shrinks
    the transfer to `max_blocks` ints. Pixels are subsampled by `stride`
    (blocks project to ~25 px at 2 m — a 4-px stride cannot skip one) to cut the
    sort size. Keys pack (c+512) into 10 bits/axis; INVALID_KEY fills unused
    slots. Host unpacks with `unpack_block_keys`.
    """
    coords, valid = touched_block_coords(
        depth[::stride, ::stride], T_wc,
        fx / stride, fy / stride, cx / stride, cy / stride,
        voxel_size, truncation,
    )
    c = jnp.clip(coords + 512, 0, 1023)
    keys = (c[:, 0] << 20) | (c[:, 1] << 10) | c[:, 2]
    keys = jnp.where(valid, keys, INVALID_KEY)
    # cheap pre-dedupe before the (sort-backed) unique: consecutive ray
    # offsets of the same pixel usually land in the same block (vertical
    # pass), and at a 0.1 m block edge several consecutive stride-8 pixels
    # of a row do too (horizontal pass) — together they shrink the sort ~5x
    hs = -(-depth.shape[0] // stride)
    ws = -(-depth.shape[1] // stride)
    ko = keys.reshape(len(OFFSET_FRACTIONS), hs, ws)
    dup = jnp.concatenate(
        [jnp.zeros((1, hs, ws), bool), ko[1:] == ko[:-1]], axis=0
    )
    dup = dup | jnp.concatenate(
        [jnp.zeros((len(OFFSET_FRACTIONS), hs, 1), bool), ko[:, :, 1:] == ko[:, :, :-1]],
        axis=2,
    )
    keys = jnp.where(dup.reshape(-1), INVALID_KEY, keys)
    return jnp.unique(keys, size=max_blocks, fill_value=INVALID_KEY)


def unpack_block_keys(keys) -> "np.ndarray":
    """Host helper: packed keys -> (N, 3) int coords, dropping fill slots."""
    import numpy as np

    k = np.asarray(keys)
    k = k[k != int(INVALID_KEY)]
    x = (k >> 20) & 1023
    y = (k >> 10) & 1023
    z = k & 1023
    return np.stack([x, y, z], -1).astype(np.int64) - 512


def debug_point_cloud(
    sdf: "jax.Array",  # (B, 8, 8, 8) raw sdf (truncation-scaled meters)
    weight: "jax.Array",  # (B, 8, 8, 8)
    block_coords: "jax.Array",  # (B, 3) int
    voxel_size: float,
    truncation: float,
):
    """Near-surface voxel centers as a debug cloud.

    (ref: src/Integration/CubeHandler.cpp:45-69 `GetPointCloud` — every
    voxel with weight != 0 and |sdf| < truncation contributes its center,
    colored gray by |sdf|/truncation.) Returns (points (B*512, 3),
    colors (B*512, 3), valid (B*512,)).
    """
    b = sdf.shape[0]
    centers = voxel_centers_world(block_coords, voxel_size)  # (B, 512, 3)
    s = sdf.reshape(b, -1)
    w = weight.reshape(b, -1)
    valid = (w != 0) & (jnp.abs(s) < truncation)
    g = jnp.abs(s) / truncation
    colors = jnp.stack([g, g, g], axis=-1)
    return (
        centers.reshape(-1, 3),
        colors.reshape(-1, 3),
        valid.reshape(-1),
    )
