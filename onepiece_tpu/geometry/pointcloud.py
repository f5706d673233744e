"""Point clouds as fixed-capacity padded pytrees.

Array-first replacement for `geometry::PointCloud` (ref:
src/Geometry/PointCloud.{h,cpp}). The reference grows std::vectors; on device
dynamic sizes force recompiles, so a cloud is a fixed-capacity array bundle
with a validity mask. Capacities are bucketed (next power of two) so repeated
pipeline stages reuse compiled programs.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import knn as knn_ops
from . import se3, transforms


def _next_capacity(n: int) -> int:
    cap = 1024
    while cap < n:
        cap *= 2
    return cap


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PointCloud:
    """points/normals/colors: (C, 3) arrays; valid: (C,) bool mask."""

    points: jax.Array
    normals: jax.Array
    colors: jax.Array
    valid: jax.Array

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def count(self) -> jax.Array:
        return jnp.sum(self.valid)

    @staticmethod
    def from_numpy(
        points: np.ndarray,
        normals: np.ndarray | None = None,
        colors: np.ndarray | None = None,
        capacity: int | None = None,
    ) -> "PointCloud":
        n = points.shape[0]
        cap = capacity or _next_capacity(n)
        pts = np.zeros((cap, 3), np.float32)
        pts[:n] = points
        nrm = np.zeros((cap, 3), np.float32)
        if normals is not None:
            nrm[:n] = normals
        col = np.zeros((cap, 3), np.float32)
        if colors is not None:
            col[:n] = colors
        valid = np.zeros((cap,), bool)
        valid[:n] = True
        return PointCloud(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(col), jnp.asarray(valid))

    @staticmethod
    def from_rgbd(
        depth: jax.Array,
        rgb: jax.Array | None,
        camera,
        depth_min: float = 0.05,
        depth_max: float = 10.0,
    ) -> "PointCloud":
        """Backproject a depth (+ optional rgb) image into a camera-frame cloud.

        (ref: src/Geometry/PointCloud.cpp:17-48 `LoadFromRGBD`). Capacity is
        H*W; invalid depths become masked-out entries instead of being
        dropped, keeping the shape static.
        """
        xyz = camera.backproject_grid(depth)
        valid = (depth > depth_min) & (depth < depth_max) & jnp.isfinite(depth)
        pts = xyz.reshape(-1, 3)
        v = valid.reshape(-1)
        col = (
            rgb.reshape(-1, 3).astype(jnp.float32)
            if rgb is not None
            else jnp.zeros_like(pts)
        )
        nrm = jnp.zeros_like(pts)
        return PointCloud(pts, nrm, col, v)

    def transform(self, T: jax.Array) -> "PointCloud":
        pts = se3.transform_points(T, self.points)
        nrm = se3.transform_normals(T, self.normals)
        return dataclasses.replace(self, points=pts, normals=nrm)

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Compact to host numpy arrays (points, normals, colors)."""
        v = np.asarray(self.valid)
        return (
            np.asarray(self.points)[v],
            np.asarray(self.normals)[v],
            np.asarray(self.colors)[v],
        )


def compact(cloud: PointCloud, capacity: int | None = None) -> PointCloud:
    """Host-side compaction: move valid points to the front and shrink the
    padded capacity to the next bucket. Used at submap boundaries where the
    accumulated capacity vastly exceeds the live point count — downstream
    kNN/FPFH cost scales with capacity, not validity."""
    v = np.asarray(cloud.valid)
    pts = np.asarray(cloud.points)[v]
    nrm = np.asarray(cloud.normals)[v]
    col = np.asarray(cloud.colors)[v]
    return PointCloud.from_numpy(pts, nrm, col, capacity=capacity)


def merge(a: PointCloud, b: PointCloud) -> PointCloud:
    """Concatenate two clouds (ref: src/Geometry/PointCloud.cpp:49-67 `MergePCD`)."""
    return PointCloud(
        jnp.concatenate([a.points, b.points]),
        jnp.concatenate([a.normals, b.normals]),
        jnp.concatenate([a.colors, b.colors]),
        jnp.concatenate([a.valid, b.valid]),
    )


def voxel_downsample(cloud: PointCloud, voxel_size: float, out_capacity: int | None = None) -> PointCloud:
    """Voxel-grid average downsample (ref: src/Geometry/PointCloud.cpp:145-189).

    Device design: instead of a hash map, voxel keys are sorted and runs are
    averaged with segment_sum — one sort + three segment reductions, no
    host round-trip. Output keeps input capacity (or `out_capacity`) with a
    mask; one representative (averaged) point per occupied voxel.
    """
    cap = out_capacity or cloud.capacity
    pts = cloud.points
    key = _voxel_keys(pts, cloud.valid, voxel_size)
    order = jnp.argsort(key)
    key_s = key[order]
    seg_start = jnp.concatenate([jnp.array([True]), key_s[1:] != key_s[:-1]])
    seg_id = jnp.cumsum(seg_start.astype(jnp.int32)) - 1

    def seg_mean(x):
        s = jax.ops.segment_sum(x[order], seg_id, num_segments=cap)
        c = jax.ops.segment_sum(jnp.ones_like(x[order, :1]), seg_id, num_segments=cap)
        return s / jnp.clip(c, 1.0, None)

    new_pts = seg_mean(pts)
    new_nrm = seg_mean(cloud.normals)
    nnorm = jnp.linalg.norm(new_nrm, axis=-1, keepdims=True)
    new_nrm = jnp.where(nnorm > 1e-9, new_nrm / jnp.clip(nnorm, 1e-9, None), new_nrm)
    new_col = seg_mean(cloud.colors)
    num_segs = jnp.sum(seg_start & (key_s < jnp.iinfo(jnp.int32).max))
    slot = jnp.arange(cap)
    new_valid = slot < num_segs
    return PointCloud(new_pts, new_nrm, new_col, new_valid)


def _voxel_keys(pts: jax.Array, valid: jax.Array, voxel_size: float) -> jax.Array:
    """int32 voxel key per point; invalid points get the max key so they sort last.

    Spatial hash in the spirit of `VoxelGridHasher`
    (ref: src/Geometry/Geometry.h:101-112) but collision-checked only through
    sorting equality, which is exact for the 21-bit-per-axis range used here.
    """
    ijk = jnp.floor(pts / voxel_size).astype(jnp.int32)
    # pack 3 x 10 bits (offset to positive); enough for ±512 voxels per axis
    # at submap scale; callers with larger extents should recentre first.
    off = ijk + 512
    off = jnp.clip(off, 0, 1023)
    key = (off[:, 0] << 20) | (off[:, 1] << 10) | off[:, 2]
    return jnp.where(valid, key, jnp.iinfo(jnp.int32).max)


def estimate_normals(cloud: PointCloud, k: int = 16, radius: float | None = None) -> PointCloud:
    """Normal estimation via k-NN + smallest covariance eigenvector.

    (ref: src/Geometry/PointCloud.cpp:102-144 `EstimateNormals`). The KD-tree
    is replaced by the exact brute-force k-NN (ops/knn.py). Normals are
    oriented toward the origin (viewpoint) like the reference.
    """
    idx, dist = knn_ops.knn(cloud.points, cloud.points, cloud.valid, k=k)
    neigh = cloud.points[idx]  # (N, k, 3)
    nvalid = cloud.valid[idx]
    if radius is not None:
        nvalid = nvalid & (dist <= radius * radius)
    normals = transforms.estimate_normals_from_neighbors(neigh, nvalid)
    # orient toward viewpoint (camera at origin)
    flip = jnp.sum(normals * cloud.points, axis=-1) > 0.0
    normals = jnp.where(flip[:, None], -normals, normals)
    normals = jnp.where(cloud.valid[:, None], normals, 0.0)
    return dataclasses.replace(cloud, normals=normals)
