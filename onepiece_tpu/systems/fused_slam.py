"""Fully device-resident dense SLAM: track + allocate + fuse in ONE dispatch.

Round-1's pipelined loop (`systems/pipeline.py`) still crossed the
host<->device boundary once per frame to uniquify touched block keys and
assign pool slots, a blocking round-trip per frame. This module closes the
loop entirely on device:

  frame step (one jitted program, donated state, zero syncs):
    1. preprocess_frame            — pyramids + XYZ backprojection
    2. dense_tracking              — multi-scale GN (odometry/dense.py)
    3. pose chain                  — T_w_cur = T_w_prev @ inv(T_ts)
    4. bilateral depth filter      — (ref: DenseFusion.cpp:64-110 pre-fuse)
    5. touched_block_keys          — unique packed keys in the trunc band
    6. device_hash.insert          — pool slots, allocating new blocks
    7. tsdf_triton.integrate_slots — in-place TSDF update of the pool

The host dispatches one step per frame and keeps only device references
(poses, rmse); everything is fetched once at `finalize`. Replaces the
reference's per-frame `PrepareCubes` host allocation
(ref: src/Integration/CubeHandler.cpp:147-210) with a device-resident
open-addressing hash (integration/device_hash.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import se3
from ..geometry.camera import PinholeCamera
from ..integration import device_hash as dh
from ..integration.blocks import TSDFVolume, make_pool, pool_to_blocks
from ..odometry import dense
from ..ops import tsdf as tsdf_ops
from ..ops import tsdf_triton
from ..ops.image import bilateral_filter


class FusedState(NamedTuple):
    pyr: dense.FramePyramid  # previous frame's pyramid
    T_w: jax.Array  # (4, 4) world-from-previous-camera
    rel: jax.Array  # (4, 4) last relative pose (constant-velocity init)
    table: dh.BlockHashTable
    vox: jax.Array  # (capacity+1, 5, 512) pool; last row trash


class FrameOut(NamedTuple):
    T_w: jax.Array
    rmse: jax.Array
    num_inliers: jax.Array
    keys_saturated: jax.Array  # () bool: touched-key buffer hit kmax this
    # frame — some blocks may integrate a frame late ("no silent caps")


def _integrate(
    vox, table, depth_f, gray, rgb, T_w, camera, voxel_size, truncation,
    kmax, stride, max_weight, interpret, claim_rounds,
):
    keys = tsdf_ops.touched_block_keys(
        depth_f, T_w, camera.fx, camera.fy, camera.cx, camera.cy,
        voxel_size, truncation, max_blocks=kmax, stride=stride,
    )
    # unique() sorts with INVALID (the largest value) as padding at the
    # tail; a real key in the last slot means the buffer filled and keys
    # may have been dropped (they retry on later frames, sorted-tail
    # biased) — surfaced instead of silent
    saturated = keys[-1] != tsdf_ops.INVALID_KEY
    # steady state uses TWO claim rounds: round 1 resolves all same-cell
    # races in practice (losers re-target their next empty cell in round 2),
    # driving per-frame block drops to zero
    table, slots = dh.insert(table, keys, claim_rounds=claim_rounds)
    cap = vox.shape[0] - 1
    slots_safe = jnp.where(slots < 0, cap, slots).astype(jnp.int32)
    color = gray[..., None] if rgb is None else rgb
    vox = tsdf_triton.integrate_slots(
        vox, keys, slots_safe, depth_f, color, se3.inverse_T(T_w),
        camera.fx, camera.fy, camera.cx, camera.cy,
        voxel_size, truncation, max_weight, interpret=interpret,
    )
    return vox, table, saturated


def _frame_body(
    state: FusedState,
    gray: jax.Array,
    depth: jax.Array,
    rgb: jax.Array | None,
    camera: PinholeCamera,
    voxel_size: float,
    truncation: float,
    kmax: int,
    stride: int,
    max_weight: float,
    iters: tuple[int, ...],
    radii: tuple[int, ...],
    interpret: bool,
    direct_fine: bool = False,
) -> tuple[FusedState, FrameOut]:
    """Traceable body shared by the per-frame and scanned-chunk steps."""
    pyr = dense.preprocess_frame(gray, depth, camera)
    res = dense.dense_tracking(
        state.pyr, pyr, camera, init_T=state.rel, iters=iters, radii=radii,
        direct_fine=direct_fine,
    )
    T_w = state.T_w @ se3.inverse_T(res.T_ts)
    d_f = bilateral_filter(depth)
    vox, table, saturated = _integrate(
        state.vox, state.table, d_f, gray, rgb, T_w, camera,
        voxel_size, truncation, kmax, stride, max_weight, interpret,
        claim_rounds=2,
    )
    return (
        FusedState(pyr, T_w, res.T_ts, table, vox),
        FrameOut(T_w, res.rmse, res.num_inliers, saturated),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "camera", "voxel_size", "truncation", "kmax", "stride", "max_weight",
        "iters", "radii", "interpret", "direct_fine",
    ),
    donate_argnums=(0,),
)
def fused_frame_step(
    state: FusedState,
    gray: jax.Array,
    depth: jax.Array,
    rgb: jax.Array | None,
    camera: PinholeCamera,
    voxel_size: float,
    truncation: float,
    kmax: int = 4096,
    stride: int = 6,
    max_weight: float = 100.0,
    iters: tuple[int, ...] = dense.DEFAULT_ITERS,
    radii: tuple[int, ...] = (8, 4, 4),
    interpret: bool = False,
    direct_fine: bool = False,
) -> tuple[FusedState, FrameOut]:
    """One frame of tracking + fusion, entirely on device."""
    return _frame_body(
        state, gray, depth, rgb, camera, voxel_size, truncation,
        kmax, stride, max_weight, iters, radii, interpret, direct_fine,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "camera", "voxel_size", "truncation", "kmax", "stride", "max_weight",
        "iters", "radii", "interpret", "direct_fine",
    ),
    donate_argnums=(0,),
)
def fused_chunk_step(
    state: FusedState,
    grays: jax.Array,  # (K, H, W)
    depths: jax.Array,  # (K, H, W)
    rgbs: jax.Array | None,  # (K, H, W, 3) or None
    camera: PinholeCamera,
    voxel_size: float,
    truncation: float,
    kmax: int = 4096,
    stride: int = 6,
    max_weight: float = 100.0,
    iters: tuple[int, ...] = dense.DEFAULT_ITERS,
    radii: tuple[int, ...] = (8, 4, 4),
    interpret: bool = False,
    direct_fine: bool = False,
) -> tuple[FusedState, FrameOut]:
    """K frames of tracking + fusion in ONE dispatch (`lax.scan` over frames).

    Amortises per-launch host/runtime overhead across the chunk: the
    whole scan is one XLA while-loop on device. Latency per frame becomes
    chunk-sized, so pick K by the latency budget (K=8 at 30 fps input =
    0.27 s) — throughput is what this buys. Stacked FrameOut (leading axis
    K) is returned.
    """

    def body(st, xs):
        if rgbs is None:
            g, d = xs
            rgb = None
        else:
            g, d, rgb = xs
        st, out = _frame_body(
            st, g, d, rgb, camera, voxel_size, truncation,
            kmax, stride, max_weight, iters, radii, interpret, direct_fine,
        )
        return st, out

    xs = (grays, depths) if rgbs is None else (grays, depths, rgbs)
    return jax.lax.scan(body, state, xs)


@functools.partial(
    jax.jit,
    static_argnames=(
        "camera", "voxel_size", "truncation", "capacity", "table_size",
        "kmax", "stride", "max_weight", "interpret",
    ),
)
def fused_init_step(
    gray: jax.Array,
    depth: jax.Array,
    rgb: jax.Array | None,
    camera: PinholeCamera,
    voxel_size: float,
    truncation: float,
    capacity: int,
    table_size: int,
    kmax: int = 4096,
    stride: int = 6,
    max_weight: float = 100.0,
    interpret: bool = False,
) -> FusedState:
    """Frame 0: build pyramids, allocate the pool, fuse at identity.

    The bulk insert of a whole frustum's blocks into an empty table sees
    real allocation contention, so it gets generous claim rounds (one-time
    cost at startup).
    """
    pyr = dense.preprocess_frame(gray, depth, camera)
    table = dh.make_table(table_size, capacity)
    vox = make_pool(capacity)
    eye = jnp.eye(4, dtype=jnp.float32)
    d_f = bilateral_filter(depth)
    vox, table, _sat = _integrate(
        vox, table, d_f, gray, rgb, eye, camera,
        voxel_size, truncation, kmax, stride, max_weight, interpret,
        claim_rounds=12,
    )
    return FusedState(pyr, eye, eye, table, vox)


@dataclasses.dataclass
class FusedDenseFusion:
    """Host driver: dense VO + TSDF fusion with zero per-frame syncs.

    Drop-in upgrade of `systems.pipeline.PipelinedDenseFusion`; same
    trajectory semantics (frame-to-frame tracking, constant-velocity init,
    every-frame integration), but allocation lives on device so the host
    never blocks inside the loop.
    """

    camera: PinholeCamera
    voxel_size: float = 0.0125
    truncation: float = 0.1
    capacity: int = 16384
    table_size: int = 1 << 16
    kmax: int = 8192  # touched-key buffer; room-scale frustums touch ~4k
    # blocks, so 8k leaves 2x headroom — and `maybe_grow` doubles it
    # whenever a frame still saturates (one recompile per bucket, cached)
    stride: int = 8  # touched-key subsample; a 0.1 m block projects to
    # >= 12.9 px at the 4 m max depth, so 8 px cannot skip one
    iters: tuple[int, ...] = dense.DEFAULT_ITERS
    radii: tuple[int, ...] = (8, 4, 4)
    interpret: bool = False  # run the TSDF kernel interpreted (CPU only)
    direct_fine: bool = False  # finest level: direct stencil (no prewarp)

    def __post_init__(self):
        self._state: FusedState | None = None
        self._poses: list[jax.Array] = []
        self._rmses: list[jax.Array] = []
        self._sat: list[jax.Array] = []
        self._sat_checked = 0
        self.kmax_growth: list[tuple[int, int]] = []  # (frame, new kmax)
        self.frame_count = 0

    def process_frame(self, gray, depth, rgb=None) -> None:
        """rgb=None fuses gray as color (r=g=b=gray)."""
        gray = jnp.asarray(gray, jnp.float32)
        depth = jnp.asarray(depth, jnp.float32)
        if rgb is not None:
            rgb = jnp.asarray(rgb, jnp.float32)
        self.frame_count += 1
        if self._state is None:
            st = fused_init_step(
                gray, depth, rgb, self.camera, self.voxel_size,
                self.truncation, self.capacity, self.table_size,
                self.kmax, self.stride, interpret=self.interpret,
            )
            # T_w and rel are both identity: give them distinct buffers, or
            # the next step's donation deletes one while passing the other
            eye = jnp.asarray(np.eye(4, dtype=np.float32))
            self._state = st._replace(
                T_w=eye, rel=jnp.asarray(np.eye(4, dtype=np.float32))
            )
            self._poses.append(jnp.asarray(np.eye(4, dtype=np.float32)))
            self._rmses.append(jnp.float32(0.0))
            return
        self._state, out = fused_frame_step(
            self._state, gray, depth, rgb, self.camera,
            self.voxel_size, self.truncation, self.kmax, self.stride,
            iters=self.iters, radii=self.radii, interpret=self.interpret,
            direct_fine=self.direct_fine,
        )
        # out.T_w shares a buffer with the state leaf that gets DONATED next
        # frame — keep a private copy so finalize() can still read it
        self._poses.append(out.T_w.copy())
        self._rmses.append(out.rmse.copy())
        self._sat.append(out.keys_saturated.copy())

    def process_chunk(self, grays, depths, rgbs=None) -> None:
        """Process a stack of K frames in one device dispatch.

        grays/depths: (K, H, W); rgbs optional (K, H, W, 3). Frame 0 of the
        whole run still goes through `fused_init_step` (pool allocation), so
        the first chunk dispatches init + a (K-1)-frame scan. Each distinct
        chunk length K compiles its own scan executable — feed fixed-size
        chunks (pad the tail) to avoid recompiles.
        """
        grays = jnp.asarray(grays, jnp.float32)
        depths = jnp.asarray(depths, jnp.float32)
        if rgbs is not None:
            rgbs = jnp.asarray(rgbs, jnp.float32)
        if self._state is None:
            self.process_frame(
                grays[0], depths[0], None if rgbs is None else rgbs[0]
            )
            grays, depths = grays[1:], depths[1:]
            if rgbs is not None:
                rgbs = rgbs[1:]
            if grays.shape[0] == 0:
                return
        k = grays.shape[0]
        if k == 0:
            return
        self.frame_count += k
        self._state, outs = fused_chunk_step(
            self._state, grays, depths, rgbs, self.camera,
            self.voxel_size, self.truncation, self.kmax, self.stride,
            iters=self.iters, radii=self.radii, interpret=self.interpret,
            direct_fine=self.direct_fine,
        )
        # outs leaves are stacked (K, ...) and independent of the donated
        # state buffers, but copy T_w defensively (finalize may run after
        # further donating steps)
        for i in range(k):
            self._poses.append(outs.T_w[i].copy())
            self._rmses.append(outs.rmse[i].copy())
            self._sat.append(outs.keys_saturated[i].copy())

    def maybe_grow(self, threshold: float = 0.85) -> bool:
        """Double the pool (and, if needed, the hash table) when occupancy
        crosses `threshold` — call between chunks on long sequences.

        The reference's `unordered_map` grows transparently
        (ref: src/Integration/CubeHandler.h:22); the device pool is a fixed
        tensor, so growth is an explicit re-allocation: pool rows keep
        their slots (device concat), the replicated table either keeps its
        cells (slots unchanged) or is rebuilt at double size with
        `device_hash.insert_at` once its load factor would pass 1/2.
        Costs one host sync (the occupancy read) + one device copy.

        Also doubles the touched-key buffer (`kmax`, a static of the step
        executables — one recompile per bucket, persistently cached) when
        any frame since the last check saturated it, removing the
        drop-and-retry path entirely on the next chunk (the same policy
        the pool uses; growth events land in `self.kmax_growth`).
        """
        if self._state is None:
            return False
        fresh = self._sat[self._sat_checked :]
        if fresh:
            self._sat_checked = len(self._sat)
            if int(np.sum(np.asarray(jnp.stack(fresh)))) > 0:
                self.kmax *= 2
                self.kmax_growth.append((self.frame_count, self.kmax))
        na = int(self._state.table.num_active)
        if na <= threshold * self.capacity:
            return False
        st = self._state
        new_cap = self.capacity * 2
        old = st.vox
        grown = jnp.concatenate(
            [
                old[: self.capacity],
                make_pool(self.capacity)[: self.capacity],
                old[self.capacity :],  # trash row stays last
            ]
        )
        tbl = st.table
        bc = jnp.zeros((new_cap, 3), jnp.int32).at[: self.capacity].set(
            tbl.block_coords
        )
        tbl = tbl._replace(block_coords=bc)
        if new_cap > tbl.table_keys.shape[0] // 2:
            # rebuild the hash table at double size (same slots)
            c = jnp.clip(bc + 512, 0, 1023)
            packed = (c[:, 0] << 20) | (c[:, 1] << 10) | c[:, 2]
            keys = jnp.where(
                jnp.arange(new_cap) < na, packed, jnp.int32(tsdf_ops.INVALID_KEY)
            )
            new_tbl = dh.make_table(tbl.table_keys.shape[0] * 2, new_cap)
            new_tbl = dh.insert_at(
                new_tbl, keys, jnp.arange(new_cap, dtype=jnp.int32)
            )
            # carry forward the historical overflow AND any keys the rebuild
            # itself dropped, so rebuild losses stay visible to the
            # `overflow == 0` long-run assertion
            tbl = new_tbl._replace(overflow=st.table.overflow + new_tbl.overflow)
            self.table_size = new_tbl.table_keys.shape[0]
        self.capacity = new_cap
        self._state = st._replace(vox=grown, table=tbl)
        return True

    def finalize(self):
        """One sync: fetch trajectory + rmse. Returns (poses, rmses)."""
        poses = np.asarray(jnp.stack(self._poses))
        rmses = np.asarray(jnp.stack(self._rmses))
        return poses, rmses

    @property
    def num_active(self) -> int:
        return int(self._state.table.num_active) if self._state else 0

    @property
    def overflow(self) -> int:
        return int(self._state.table.overflow) if self._state else 0

    @property
    def key_saturated_frames(self) -> int:
        """Frames whose touched-key buffer hit kmax (possible late
        integration of the sorted-tail blocks). One fetch."""
        if not self._sat:
            return 0
        return int(np.sum(np.asarray(jnp.stack(self._sat))))

    def to_volume(self) -> TSDFVolume:
        """Export the device pool as a host-indexed TSDFVolume (for meshing,
        checkpointing, submap merge — one transfer, post-loop)."""
        st = self._state
        assert st is not None
        sdf, weight, color = pool_to_blocks(st.vox)
        na = int(st.table.num_active)
        vol = TSDFVolume(
            voxel_size=self.voxel_size, truncation=self.truncation,
            capacity=self.capacity,
        )
        vol.sdf, vol.weight, vol.color = sdf, weight, color
        bc = np.asarray(st.table.block_coords[:na])
        vol.block_coords[:na] = bc
        vol.slot_of = {tuple(c): i for i, c in enumerate(bc.tolist())}
        vol.num_active = na
        return vol
