"""Software-pipelined dense odometry + TSDF fusion.

The round-1 per-frame pipeline, engineered around the host-sync cost of a
blocking device round-trip (syncs are the enemy):

  - ALL per-frame device work — pyramid preprocessing, multi-scale dense
    tracking, bilateral depth filtering, world-pose chaining, touched-block
    key extraction — runs as ONE jitted program (`frontend_step`): one
    dispatch, zero intermediate syncs.
  - Host transfers (relative pose, block keys) are started asynchronously
    and consumed ONE FRAME LATER, so the transfer latency hides behind the
    next frame's device compute. TSDF integration correspondingly lags one
    frame (allocation needs the keys on host).

The result is a steady-state loop whose wall-clock is max(device compute,
one async transfer), not their sum across 5+ stages.
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
from ..integration.blocks import TSDFVolume
from ..odometry import dense
from ..ops import tsdf as tsdf_ops
from ..ops.image import bilateral_filter


class FrontendOut(NamedTuple):
    pyramid: dense.FramePyramid
    T_ts: jax.Array  # prev -> cur relative pose
    T_world: jax.Array  # world-from-cur
    rmse: jax.Array
    num_inliers: jax.Array
    depth_filtered: jax.Array
    keys: jax.Array  # touched block keys (packed)


@functools.partial(
    jax.jit, static_argnames=("camera", "voxel_size", "truncation")
)
def frontend_step(
    prev_pyr: dense.FramePyramid,
    gray: jax.Array,
    depth: jax.Array,
    T_w_prev: jax.Array,
    init_rel: jax.Array,
    camera: PinholeCamera,
    voxel_size: float,
    truncation: float,
) -> FrontendOut:
    """One frame's full device-side work in a single program."""
    pyr = dense.preprocess_frame(gray, depth, camera)
    res = dense.dense_tracking(prev_pyr, pyr, camera, init_T=init_rel)
    T_w_cur = T_w_prev @ se3.inverse_T(res.T_ts)
    d_f = bilateral_filter(depth)
    keys = tsdf_ops.touched_block_keys(
        d_f, T_w_cur, camera.fx, camera.fy, camera.cx, camera.cy,
        voxel_size, truncation,
    )
    return FrontendOut(pyr, res.T_ts, T_w_cur, res.rmse, res.num_inliers, d_f, keys)


@dataclasses.dataclass
class PipelinedDenseFusion:
    """Dense VO + TSDF fusion with one-frame-lagged integration."""

    camera: PinholeCamera
    voxel_size: float = 0.0125
    truncation: float = 0.1
    volume_capacity: int = 8192
    integrate_stride: int = 1

    def __post_init__(self):
        self.volume = TSDFVolume(
            voxel_size=self.voxel_size, truncation=self.truncation,
            capacity=self.volume_capacity,
        )
        self._prev_pyr = None
        self._T_w_dev = jnp.eye(4)
        self._rel_dev = jnp.eye(4)
        self._pending = None  # (d_f, rgb, T_world_dev, keys) awaiting integrate
        self._poses_dev: list[jax.Array] = []
        self._rmse_dev: list[jax.Array] = []
        self.frame_count = 0

    def process_frame(self, gray: jax.Array, depth: jax.Array, rgb: jax.Array | None = None) -> None:
        gray = jnp.asarray(gray)
        depth = jnp.asarray(depth)
        fidx = self.frame_count
        self.frame_count += 1
        if rgb is None:
            rgb = jnp.stack([gray, gray, gray], axis=-1)

        if fidx == 0:
            self._prev_pyr = dense.preprocess_frame(gray, depth, self.camera)
            d_f = bilateral_filter(depth)
            keys = tsdf_ops.touched_block_keys(
                d_f, jnp.eye(4), self.camera.fx, self.camera.fy,
                self.camera.cx, self.camera.cy, self.voxel_size, self.truncation,
            )
            keys.copy_to_host_async()
            self._poses_dev.append(self._T_w_dev)
            self._rmse_dev.append(jnp.float32(0.0))
            self._pending = (d_f, rgb, self._T_w_dev, keys)
            return

        out = frontend_step(
            self._prev_pyr, gray, depth, self._T_w_dev, self._rel_dev,
            self.camera, self.voxel_size, self.truncation,
        )
        # start async host copies; consumed next frame
        out.keys.copy_to_host_async()
        out.T_world.copy_to_host_async()

        # integrate the PREVIOUS frame (its keys have had a frame to arrive)
        self._drain_pending()
        if fidx % self.integrate_stride == 0:
            self._pending = (out.depth_filtered, rgb, out.T_world, out.keys)

        self._prev_pyr = out.pyramid
        self._T_w_dev = out.T_world
        self._rel_dev = out.T_ts
        self._poses_dev.append(out.T_world)
        self._rmse_dev.append(out.rmse)

    def _drain_pending(self) -> None:
        if self._pending is None:
            return
        d_f, rgb, T_w, keys = self._pending
        self._pending = None
        coords = tsdf_ops.unpack_block_keys(keys)
        self.volume.integrate_prepared(d_f, rgb, T_w, self.camera, coords)

    def finalize(self):
        """Flush the lagged integration; returns (poses (N, 4, 4), rmses)."""
        self._drain_pending()
        poses = np.stack([np.asarray(p) for p in self._poses_dev])
        rmses = np.array([float(r) for r in self._rmse_dev])
        return poses, rmses
