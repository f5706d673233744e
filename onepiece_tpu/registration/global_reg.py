"""Global (feature-based) registration: FPFH match + batched RANSAC.

Device redesign of `registration::RansacRegistration`
(ref: src/Registration/GlobalRegistration.cpp:121-266): downsample ->
normals -> FPFH -> 1-NN feature match (33-dim KD-tree replaced by one
distance matmul) -> RanSaPC rejection x3 (ref :76-109) -> rigid RANSAC
(the reference runs up to 40000 sequential GRANSAC iterations,
ref: example/DenseFusion/DenseSlam.h:56; here the same hypothesis count is
evaluated in a handful of batched rounds).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry.pointcloud import PointCloud, estimate_normals, voxel_downsample
from ..ops import knn as knn_ops
from ..ops import ransac
from . import fpfh as fpfh_mod


@dataclasses.dataclass(frozen=True)
class RansacParams:
    """(ref: GlobalRegistration.h:12-24 RANSACParameter defaults.)"""

    voxel_size: float = 0.05
    normal_k: int = 16
    fpfh_radius: float = 0.25
    fpfh_k: int = 32
    threshold: float = 0.075
    num_hypotheses: int = 4096
    sample_size: int = 4
    ransapc_rounds: int = 3


class GlobalRegistrationResult(NamedTuple):
    T: jax.Array
    num_inliers: jax.Array
    rmse: jax.Array
    success: jax.Array


class CloudFeatures(NamedTuple):
    points: jax.Array  # (N, 3)
    normals: jax.Array
    valid: jax.Array
    fpfh: jax.Array  # (N, 33)


def downsample_and_extract(
    cloud: PointCloud, params: RansacParams = RansacParams()
) -> CloudFeatures:
    """(ref: GlobalRegistration.cpp:206-217 `DownSampleAndExtractFeature`.)"""
    ds = voxel_downsample(cloud, params.voxel_size)
    return extract_features(ds, params)


def extract_features(
    cloud: PointCloud, params: RansacParams = RansacParams()
) -> CloudFeatures:
    """Normals + FPFH for an already-downsampled cloud."""
    ds = estimate_normals(cloud, k=params.normal_k)
    feats = fpfh_mod.compute_fpfh(
        ds.points, ds.normals, ds.valid, radius=params.fpfh_radius, k=params.fpfh_k
    )
    return CloudFeatures(ds.points, ds.normals, ds.valid, feats)


def register(
    src: CloudFeatures,
    tgt: CloudFeatures,
    params: RansacParams = RansacParams(),
    key: jax.Array | None = None,
    min_inliers: int = 30,
) -> GlobalRegistrationResult:
    """Estimate T mapping src points onto tgt.

    (ref: GlobalRegistration.cpp:219-266 `RansacRegistration(features)`.)
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    # 33-dim feature 1-NN (ref FeatureMatching3D, :29-74)
    idx, _ = knn_ops.knn(src.fpfh, tgt.fpfh, tgt.valid, k=1)
    idx = idx[:, 0]
    ok = src.valid & tgt.valid[idx]
    dst_pts = tgt.points[idx]

    keys = jax.random.split(key, params.ransapc_rounds + 1)
    for r in range(params.ransapc_rounds):
        ok = ransac.ransapc_filter(
            keys[r], src.points, dst_pts, ok, tolerance=params.voxel_size * 3.0
        )
    res = ransac.ransac_rigid(
        keys[-1], src.points, dst_pts, ok,
        threshold=params.threshold,
        num_hypotheses=params.num_hypotheses,
        sample_size=params.sample_size,
    )
    return GlobalRegistrationResult(
        res.T, res.num_inliers, res.rmse, res.num_inliers >= min_inliers
    )
