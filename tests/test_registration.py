"""ICP, FPFH, and global registration tests on synthetic geometry."""

import jax
import jax.numpy as jnp
import numpy as np

from onepiece_tpu.geometry import se3
from onepiece_tpu.geometry.pointcloud import PointCloud
from onepiece_tpu.registration import fpfh as fpfh_mod
from onepiece_tpu.registration import global_reg, icp

RNG = np.random.default_rng(21)


def make_surface(n=2000):
    """A bumpy non-symmetric surface patch (unambiguous registration)."""
    xy = RNG.uniform(-1, 1, size=(n, 2))
    z = (
        0.3 * np.sin(2.5 * xy[:, 0])
        + 0.2 * np.cos(3.1 * xy[:, 1] + 0.7)
        + 0.15 * np.sin(1.7 * (xy[:, 0] + xy[:, 1]))
    )
    return np.c_[xy, z].astype(np.float32)


def test_icp_point_to_point():
    pts = make_surface()
    T_gt = se3.se3_exp(jnp.asarray([0.05, -0.03, 0.04, 0.05, -0.04, 0.06], jnp.float32))
    src = jnp.asarray(pts)
    dst = se3.transform_points(T_gt, src)
    valid = jnp.ones(len(pts), bool)
    res = icp.point_to_point(src, valid, dst, valid, threshold=0.3)
    np.testing.assert_allclose(np.asarray(res.T), np.asarray(T_gt), atol=2e-3)
    assert float(res.rmse) < 0.02


def test_icp_point_to_plane():
    pts = make_surface()
    src = jnp.asarray(pts)
    T_gt = se3.se3_exp(jnp.asarray([0.04, 0.02, -0.03, 0.03, 0.05, -0.02], jnp.float32))
    dst_cloud = PointCloud.from_numpy(np.asarray(se3.transform_points(T_gt, src)))
    from onepiece_tpu.geometry.pointcloud import estimate_normals

    dst_cloud = estimate_normals(dst_cloud, k=12)
    valid = jnp.ones(len(pts), bool)
    res = icp.point_to_plane(
        src, valid,
        dst_cloud.points[: len(pts)], dst_cloud.normals[: len(pts)],
        dst_cloud.valid[: len(pts)],
        threshold=0.3, iters=20,
    )
    np.testing.assert_allclose(np.asarray(res.T), np.asarray(T_gt), atol=3e-3)
    assert float(res.rmse) < 0.01


def test_icp_partial_overlap():
    pts = make_surface(3000)
    T_gt = se3.se3_exp(jnp.asarray([0.03, 0.0, 0.02, 0.0, 0.03, 0.0], jnp.float32))
    src = jnp.asarray(pts[pts[:, 0] < 0.6])
    dst_all = se3.transform_points(T_gt, jnp.asarray(pts))
    dst = dst_all[pts[:, 0] > -0.6]
    # a tight inlier threshold suppresses the non-overlap drag bias
    res = icp.point_to_point(
        src, jnp.ones(src.shape[0], bool), dst, jnp.ones(dst.shape[0], bool),
        threshold=0.05,
    )
    np.testing.assert_allclose(np.asarray(res.T), np.asarray(T_gt), atol=5e-3)


def test_fpfh_rotation_invariance():
    pts = make_surface(800)
    cloud = PointCloud.from_numpy(pts)
    from onepiece_tpu.geometry.pointcloud import estimate_normals

    cloud = estimate_normals(cloud, k=12)
    f1 = fpfh_mod.compute_fpfh(cloud.points, cloud.normals, cloud.valid, radius=0.3)
    T = se3.se3_exp(jnp.asarray([0.3, -0.2, 0.5, 0.4, -0.7, 0.9], jnp.float32))
    rot = cloud.transform(T)
    f2 = fpfh_mod.compute_fpfh(rot.points, rot.normals, rot.valid, radius=0.3)
    v = np.asarray(cloud.valid)
    a, b = np.asarray(f1)[v], np.asarray(f2)[v]
    # descriptors are rotation invariant (same neighbours, same angles)
    rel = np.abs(a - b).sum(-1) / np.clip(np.abs(a).sum(-1), 1e-6, None)
    assert np.median(rel) < 0.05, np.median(rel)


def test_global_registration_recovers_large_motion():
    pts = make_surface(4000)
    cloud = PointCloud.from_numpy(pts)
    T_gt = se3.se3_exp(jnp.asarray([0.4, -0.3, 0.5, 0.3, 0.5, -0.4], jnp.float32))
    tgt_cloud = cloud.transform(T_gt)
    params = global_reg.RansacParams(voxel_size=0.08, fpfh_radius=0.3, threshold=0.1)
    fs = global_reg.downsample_and_extract(cloud, params)
    ft = global_reg.downsample_and_extract(tgt_cloud, params)
    res = global_reg.register(fs, ft, params)
    assert bool(res.success)
    # refine with ICP and check the composed transform
    refined = icp.point_to_point(
        cloud.points, cloud.valid, tgt_cloud.points, tgt_cloud.valid,
        init_T=res.T, threshold=0.2,
    )
    np.testing.assert_allclose(np.asarray(refined.T), np.asarray(T_gt), atol=5e-3)


def test_knn_exact_far_from_origin():
    """Points ~4 m from the origin, ~1 cm apart: the expanded distance form
    |q|^2 + |r|^2 - 2 q.r would cancel ~32 m^2 down to ~1e-4 m^2 and
    reorder neighbours in f32. The direct form must return the float64
    brute-force answer exactly, with distances to 1e-6 m^2."""
    import jax.numpy as jnp

    from onepiece_tpu.ops import knn as knn_ops

    rng = np.random.default_rng(5)
    side = 40
    g = np.arange(side) * 0.01
    x, y = (a.reshape(-1) for a in np.meshgrid(g, g))
    r = np.stack([x, y, 0.05 * np.sin(20 * x)], -1) + rng.uniform(-0.003, 0.003, (side * side, 3))
    r = (r + np.array([2.0, -1.5, 3.0])).astype(np.float32)
    q = (r[::3] + rng.normal(0, 0.004, r[::3].shape)).astype(np.float32)
    v = rng.random(len(r)) > 0.1
    idx, d2 = knn_ops.knn(jnp.asarray(q), jnp.asarray(r), jnp.asarray(v), k=1, tile=256)
    dd = ((q.astype(np.float64)[:, None] - r.astype(np.float64)[None]) ** 2).sum(-1)
    dd[:, ~v] = np.inf
    np.testing.assert_array_equal(np.asarray(idx)[:, 0], dd.argmin(-1))
    np.testing.assert_allclose(np.asarray(d2)[:, 0], dd.min(-1), atol=1e-6)
