"""Voxel-block TSDF volume: fixed device pool + host hash table.

Device redesign of `integration::CubeHandler` (ref:
src/Integration/CubeHandler.{h,cpp}). The reference stores cubes in an
`unordered_map<CubeID, VoxelCube>`; dynamic hash maps don't exist on device,
so the rebuild splits responsibilities:

  - DEVICE: a fixed-capacity pool of B blocks — SoA arrays
    sdf (B, 8,8,8), weight (B, 8,8,8), color (B, 8,8,8,3) — integrated /
    meshed in bulk launches (ops/tsdf.py, ops/marching_cubes.py).
  - HOST: a {(bx,by,bz) -> slot} dict and a free list; per-frame block
    allocation (ref `PrepareCubes`, CubeHandler.cpp:147-196) reads the
    device-computed touched-coordinate list once per frame.

Capacity is bucketed: when the pool fills, arrays are grown by 2x (one
recompile per doubling, amortised silent).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry.camera import PinholeCamera
from ..ops import marching_cubes as mc_ops
from ..ops import tsdf as tsdf_ops
from ..ops.tsdf import CUBE_SIZE

# defaults matching the reference (voxel resolution 0.0125 m, truncation 0.1 m
# — ref: src/Integration/CubeHandler.h:15 and Integrator truncation default)
DEFAULT_VOXEL_SIZE = 0.0125
DEFAULT_TRUNCATION = 0.1

N_VOX = CUBE_SIZE**3  # 512 voxels per block


# -- device pool layout (systems/fused_slam.py, parallel/) ---------------------
#
# The device-resident systems keep one channels-first pool (B+1, 5, 512)
# float32 with channels [sdf, weight, r, g, b]; row B is a trash row that
# padding slots point at (`ops.tsdf_triton.integrate_slots`).


def make_pool(capacity: int) -> jax.Array:
    """Fresh (capacity+1, 5, 512) pool; sdf=EMPTY, weight=0, last row trash."""
    vox = jnp.zeros((capacity + 1, 5, N_VOX), jnp.float32)
    return vox.at[:, 0, :].set(tsdf_ops.EMPTY_SDF)


def pool_to_blocks(vox: jax.Array):
    """(B+1, 5, 512) -> (sdf, weight, color) in the (B, 8, 8, 8[,3]) layout."""
    n = CUBE_SIZE
    b = vox.shape[0] - 1
    body = vox[:b]
    sdf = body[:, 0].reshape(b, n, n, n)
    weight = body[:, 1].reshape(b, n, n, n)
    color = jnp.moveaxis(body[:, 2:5], 1, -1).reshape(b, n, n, n, 3)
    return sdf, weight, color


@functools.partial(
    jax.jit,
    static_argnames=("fx", "fy", "cx", "cy", "voxel_size", "truncation", "max_weight"),
)
def _integrate_slots(
    sdf, weight, color, block_coords, slots, depth, rgb, T_cw,
    fx, fy, cx, cy, voxel_size, truncation, max_weight,
):
    """Gather touched slots -> integrate -> scatter back (one device program)."""
    n = CUBE_SIZE
    cap = sdf.shape[0]
    # padding entries carry slot == cap (out of bounds): gathers clamp to a
    # real slot but their updates are masked off, and the scatter uses
    # mode='drop' so they write nothing.
    active = slots < cap
    safe = jnp.clip(slots, 0, cap - 1)
    m = slots.shape[0]
    sdf_g = sdf[safe].reshape(m, -1)
    w_g = weight[safe].reshape(m, -1)
    c_g = color[safe].reshape(m, -1, 3)
    bc_g = block_coords[safe]
    sdf_n, w_n, c_n = tsdf_ops.integrate_blocks(
        sdf_g, w_g, c_g, bc_g, active, depth, rgb, T_cw,
        fx, fy, cx, cy, voxel_size, truncation, max_weight,
    )
    sdf = sdf.at[slots].set(sdf_n.reshape(-1, n, n, n), mode="drop")
    weight = weight.at[slots].set(w_n.reshape(-1, n, n, n), mode="drop")
    color = color.at[slots].set(c_n.reshape(-1, n, n, n, 3), mode="drop")
    return sdf, weight, color


@functools.partial(jax.jit, static_argnames=("voxel_size", "cap"))
def _extract_all_chunks(
    sdf_pool, weight_pool, color_pool,  # (P, 8, 8, 8[, 3])
    idx,  # (n_chunks, chunk) int — pool slots per chunk (0-padded)
    nbr,  # (n_chunks, chunk, 7) int — neighbour slots (-1 absent)
    bc,  # (n_chunks, chunk, 3) int32
    pad_mask,  # (n_chunks, chunk) bool — True = padding row
    voxel_size: float,
    cap: int,
):
    """Marching cubes + compaction for ALL chunks in one device program."""

    def do_chunk(args):
        idx_c, nbr_c, bc_c, pad_c = args
        sdf_c = sdf_pool[idx_c]
        w_c = jnp.where(pad_c[:, None, None, None], 0.0, weight_pool[idx_c])
        col_c = color_pool[idx_c]
        nbr_sdf = mc_ops.gather_neighbors(sdf_pool, nbr_c, tsdf_ops.EMPTY_SDF)
        nbr_w = mc_ops.gather_neighbors(weight_pool, nbr_c, 0.0)
        nbr_col = jnp.stack(
            [mc_ops.gather_neighbors(color_pool[..., i], nbr_c, 0.0) for i in range(3)],
            axis=-1,
        )
        tv, tc, valid = mc_ops.extract_block_triangles(
            sdf_c, w_c, col_c, nbr_sdf, nbr_w, nbr_col, bc_c, voxel_size
        )
        return mc_ops.compact_triangles(tv, tc, valid, cap)

    return jax.lax.map(do_chunk, (idx, nbr, bc, pad_mask))


@dataclasses.dataclass
class TSDFVolume:
    voxel_size: float = DEFAULT_VOXEL_SIZE
    truncation: float = DEFAULT_TRUNCATION
    capacity: int = 4096
    max_weight: float = 100.0

    def __post_init__(self):
        c = self.capacity
        n = CUBE_SIZE
        self.sdf = jnp.full((c, n, n, n), tsdf_ops.EMPTY_SDF, jnp.float32)
        self.weight = jnp.zeros((c, n, n, n), jnp.float32)
        self.color = jnp.zeros((c, n, n, n, 3), jnp.float32)
        self.block_coords = np.zeros((c, 3), np.int64)
        self.slot_of: dict[tuple[int, int, int], int] = {}
        self.num_active = 0

    # -- host bookkeeping -------------------------------------------------

    def _grow(self, needed: int) -> None:
        while self.capacity < needed:
            self.capacity *= 2
        n = CUBE_SIZE
        c = self.capacity

        def grow(arr, fill):
            out = jnp.full((c,) + arr.shape[1:], fill, arr.dtype)
            return out.at[: arr.shape[0]].set(arr)

        self.sdf = grow(self.sdf, tsdf_ops.EMPTY_SDF)
        self.weight = grow(self.weight, 0.0)
        self.color = grow(self.color, 0.0)
        bc = np.zeros((c, 3), np.int64)
        bc[: len(self.block_coords)] = self.block_coords
        self.block_coords = bc

    def allocate(self, coords: np.ndarray) -> None:
        """Ensure blocks exist for the given (N, 3) integer block coords."""
        new = [t for t in map(tuple, coords.astype(np.int64)) if t not in self.slot_of]
        # dict preserves insertion order; dedupe
        new = list(dict.fromkeys(new))
        if not new:
            return
        if self.num_active + len(new) > self.capacity:
            self._grow(self.num_active + len(new))
        for t in new:
            slot = self.num_active
            self.slot_of[t] = slot
            self.block_coords[slot] = t
            self.num_active += 1

    def active_coords(self) -> np.ndarray:
        return self.block_coords[: self.num_active]

    # -- per-frame integration -------------------------------------------

    def integrate_prepared(
        self,
        depth: jax.Array,
        rgb: jax.Array | None,
        T_wc: jax.Array,
        camera: PinholeCamera,
        coords: "np.ndarray",
    ) -> int:
        """Integrate with block coords already on host (pipelined path).

        The caller computed `touched_block_keys` on device and fetched them
        asynchronously (hiding the host-sync latency behind other work);
        this method only allocates + launches the update.
        """
        self.allocate(coords)
        if rgb is None:
            rgb = jnp.zeros(depth.shape + (3,), jnp.float32)
        T_cw = jnp.linalg.inv(jnp.asarray(T_wc, jnp.float32))
        slots = np.array([self.slot_of[tuple(c)] for c in coords], np.int64)
        bucket = 4096
        while bucket < len(slots):
            bucket *= 2
        slots_p = np.full(bucket, self.capacity, np.int64)
        slots_p[: len(slots)] = slots
        self.sdf, self.weight, self.color = _integrate_slots(
            self.sdf, self.weight, self.color,
            jnp.asarray(self.block_coords, jnp.int32),
            jnp.asarray(slots_p), depth, rgb, T_cw,
            camera.fx, camera.fy, camera.cx, camera.cy,
            self.voxel_size, self.truncation, self.max_weight,
        )
        return self.num_active

    def integrate(
        self,
        depth: jax.Array,
        rgb: jax.Array | None,
        T_wc: jax.Array,
        camera: PinholeCamera,
    ) -> int:
        """Allocate touched blocks and fuse one posed RGB-D frame.

        (ref: CubeHandler::IntegrateImage, CubeHandler.cpp:197-210.)
        Returns the number of active blocks after allocation.
        """
        T_wc = jnp.asarray(T_wc, jnp.float32)
        keys = tsdf_ops.touched_block_keys(
            depth, T_wc, camera.fx, camera.fy, camera.cx, camera.cy,
            self.voxel_size, self.truncation,
        )
        coords = tsdf_ops.unpack_block_keys(keys)
        self.allocate(coords)

        if rgb is None:
            rgb = jnp.zeros(depth.shape + (3,), jnp.float32)
        T_cw = jnp.linalg.inv(T_wc)

        # integrate ONLY this frame's touched blocks (the reference's
        # candidate-cube list, CubeHandler.cpp:205-208): gather their voxel
        # data by slot, update, scatter back. Slot count is bucketed so the
        # compiled program is reused across frames.
        slots = np.array([self.slot_of[tuple(c)] for c in coords], np.int64)
        # single bucket size -> one compiled program for the whole run
        bucket = 4096
        while bucket < len(slots):
            bucket *= 2
        slots_p = np.full(bucket, self.capacity, np.int64)  # capacity = drop
        slots_p[: len(slots)] = slots
        n = CUBE_SIZE
        self.sdf, self.weight, self.color = _integrate_slots(
            self.sdf, self.weight, self.color,
            jnp.asarray(self.block_coords, jnp.int32),
            jnp.asarray(slots_p), depth, rgb, T_cw,
            camera.fx, camera.fy, camera.cx, camera.cy,
            self.voxel_size, self.truncation, self.max_weight,
        )
        return self.num_active

    # -- meshing ----------------------------------------------------------

    def _neighbor_slots(self) -> np.ndarray:
        """(num_active, 7) pool slots of each active block's +halo neighbours."""
        na = self.num_active
        out = np.full((na, 7), -1, np.int64)
        for i in range(na):
            base = self.block_coords[i]
            for j, off in enumerate(mc_ops.NEIGHBOR_OFFSETS):
                out[i, j] = self.slot_of.get(tuple(base + off), -1)
        return out

    def extract_mesh(self, chunk: int = 128, cap_per_block: int = 96):
        """Marching cubes over all active blocks -> host (verts, colors) arrays.

        Returns (vertices (T, 3, 3) float32, colors (T, 3, 3) float32) of
        valid triangles. (ref: ExtractTriangleMesh, CubeHandler.cpp:9-44.)

        The WHOLE extraction is one jitted program (`lax.map` over block
        chunks) with device-side compaction, then ONE transfer of the
        compacted buffers: the remote-chip link moves ~30 MB/s, so the
        padded per-chunk fetch-and-compact-on-host formulation took minutes
        where this takes seconds. `cap_per_block` bounds triangles per block
        (average real-scene occupancy is ~55/block; overfull chunks drop the
        excess, observable as count == cap).
        """
        na = self.num_active
        if na == 0:
            return np.zeros((0, 3, 3), np.float32), np.zeros((0, 3, 3), np.float32)
        nbr = self._neighbor_slots()
        n_chunks = -(-na // chunk)
        pad_to = n_chunks * chunk
        idx = np.pad(np.arange(na), (0, pad_to - na), constant_values=0)
        nbr_p = np.pad(nbr, ((0, pad_to - na), (0, 0)), constant_values=-1)
        bc_p = np.pad(self.block_coords[:na], ((0, pad_to - na), (0, 0)))
        pad_mask = np.zeros(pad_to, bool)
        pad_mask[na:] = True
        cap = chunk * cap_per_block
        out_v, out_c, counts = _extract_all_chunks(
            self.sdf, self.weight, self.color,
            jnp.asarray(idx.reshape(n_chunks, chunk)),
            jnp.asarray(nbr_p.reshape(n_chunks, chunk, 7)),
            jnp.asarray(bc_p.reshape(n_chunks, chunk, 3), jnp.int32),
            jnp.asarray(pad_mask.reshape(n_chunks, chunk)),
            self.voxel_size, cap,
        )
        for a in (out_v, out_c, counts):
            a.copy_to_host_async()
        counts = np.minimum(np.asarray(counts), cap)
        vs = np.asarray(out_v)
        cs = np.asarray(out_c)
        verts = np.concatenate([vs[i, : counts[i]] for i in range(n_chunks)])
        cols = np.concatenate([cs[i, : counts[i]] for i in range(n_chunks)])
        return verts, cols
