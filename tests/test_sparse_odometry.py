"""Sparse feature odometry: detection, matching, RANSAC on synthetic data."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from onepiece_tpu.geometry import se3
from onepiece_tpu.geometry.camera import PinholeCamera
from onepiece_tpu.odometry import dense, features, sparse
from onepiece_tpu.ops import hamming, ransac
from onepiece_tpu.utils import synthetic

RNG = np.random.default_rng(3)
CAM = PinholeCamera(fx=120.0, fy=120.0, cx=99.5, cy=79.5, width=200, height=160, depth_scale=1000.0)


def render(T):
    scene = synthetic.default_scene()
    return synthetic.render(scene, jnp.asarray(T, jnp.float32), CAM.fx, CAM.fy, CAM.cx, CAM.cy, CAM.height, CAM.width)


def test_ransac_rigid_with_outliers():
    key = jax.random.PRNGKey(0)
    T_gt = se3.se3_exp(jnp.asarray([0.1, -0.05, 0.2, 0.1, -0.2, 0.05], jnp.float32))
    src = jnp.asarray(RNG.normal(size=(200, 3)), jnp.float32)
    dst = se3.transform_points(T_gt, src)
    # corrupt 40% with gross outliers
    n_out = 80
    dst = dst.at[:n_out].add(jnp.asarray(RNG.normal(size=(n_out, 3)) * 2.0 + 1.0, jnp.float32))
    valid = jnp.ones(200, bool)
    res = ransac.ransac_rigid(key, src, dst, valid, threshold=0.02)
    assert int(res.num_inliers) >= 115
    np.testing.assert_allclose(np.asarray(res.T), np.asarray(T_gt), atol=1e-3)


def test_ransapc_rejects_inconsistent():
    key = jax.random.PRNGKey(1)
    T_gt = se3.se3_exp(jnp.asarray([0.1, 0.0, 0.0, 0.0, 0.1, 0.0], jnp.float32))
    src = jnp.asarray(RNG.normal(size=(100, 3)), jnp.float32)
    dst = se3.transform_points(T_gt, src)
    dst = dst.at[:20].add(jnp.asarray(RNG.normal(size=(20, 3)) * 1.5 + 0.8, jnp.float32))
    valid = jnp.ones(100, bool)
    mask = ransac.ransapc_filter(key, src, dst, valid)
    kept = np.asarray(mask)
    assert kept[20:].mean() > 0.9  # inliers survive
    assert kept[:20].mean() < 0.3  # outliers rejected


def test_hamming_matcher():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 2**32, size=(50, 8), dtype=np.uint32)
    b = np.roll(a, 7, axis=0)  # permuted copy
    idx, ok = hamming.match_descriptors(jnp.asarray(a), jnp.ones(50, bool), jnp.asarray(b), jnp.ones(50, bool), max_distance=0, ratio=1.0)
    assert bool(ok.all())
    np.testing.assert_array_equal(np.asarray(idx), (np.arange(50) + 7) % 50)
    table = np.asarray(hamming.hamming_table(jnp.asarray(a), jnp.asarray(a)))
    assert (np.diag(table) == 0).all()
    # popcount sanity vs numpy
    xor = a[:, None, :] ^ a[None, :, :]
    expect = np.unpackbits(xor.view(np.uint8), axis=-1).sum(-1)
    np.testing.assert_array_equal(table, expect)


def test_fast_detects_corners():
    # white square on black: corners should fire near the 4 square corners
    img = np.zeros((100, 100), np.float32)
    img[30:70, 30:70] = 1.0
    kp = features.detect_and_describe(jnp.asarray(img), max_keypoints=50)
    uv = np.asarray(kp.uv)[np.asarray(kp.valid)]
    assert len(uv) >= 4
    corners = np.array([[30, 30], [30, 69], [69, 30], [69, 69]], np.float32)
    for c in corners:
        d = np.linalg.norm(uv - c, axis=-1).min()
        assert d < 4.0, (c, d)


def test_descriptor_invariance_to_translation():
    scene_img = RNG.uniform(0, 1, size=(120, 160)).astype(np.float32)
    import scipy.ndimage as ndi

    smooth = ndi.gaussian_filter(scene_img, 1.0)
    shifted = np.roll(smooth, (0, 5), axis=(0, 1))
    k1 = features.detect_and_describe(jnp.asarray(smooth), max_keypoints=100, threshold=0.03)
    k2 = features.detect_and_describe(jnp.asarray(shifted), max_keypoints=100, threshold=0.03)
    idx, ok = hamming.match_descriptors(k1.desc, k1.valid, k2.desc, k2.valid, max_distance=40, ratio=0.9)
    uv1 = np.asarray(k1.uv)
    uv2 = np.asarray(k2.uv)[np.asarray(idx)]
    okn = np.asarray(ok)
    assert okn.sum() >= 20
    disp = uv2[okn] - uv1[okn]
    med = np.median(disp, axis=0)
    np.testing.assert_allclose(med, [5.0, 0.0], atol=1.0)


def test_sparse_tracking_synthetic():
    xi = [0.02, -0.01, 0.015, 0.01, -0.02, 0.01]
    T1 = se3.se3_exp(jnp.asarray(xi, jnp.float32))
    d0, g0 = render(np.eye(4))
    d1, g1 = render(T1)
    f0 = sparse.extract_sparse_frame(g0, d0, CAM, threshold=0.03)
    f1 = sparse.extract_sparse_frame(g1, d1, CAM, threshold=0.03)
    assert int(f0.valid.sum()) > 30
    res = sparse.sparse_tracking(f0, f1, CAM)
    assert bool(res.success)
    # 3D-3D sparse accuracy is bounded by 1-px keypoint quantisation
    # (~1.5 cm at this focal length / depth); the reference refines via
    # dense tracking or BA downstream, as do our systems.
    T_gt = se3.inverse_T(T1)
    delta = np.asarray(se3.se3_log(res.T_ts @ se3.inverse_T(T_gt)))
    assert np.linalg.norm(delta[:3]) < 0.05, delta
    assert np.linalg.norm(delta[3:]) < 0.02, delta


def test_hamming_table_matmul_exact():
    """The matmul sign-vector formulation must equal XOR+popcount exactly."""
    import jax
    import jax.numpy as jnp

    from onepiece_tpu.ops import hamming

    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.integers(0, 2**32, (33, 8), dtype=np.uint64).astype(np.uint32))
    b = jnp.asarray(rng.integers(0, 2**32, (47, 8), dtype=np.uint64).astype(np.uint32))
    got = np.asarray(hamming.hamming_table(a, b))
    x = np.bitwise_xor(np.asarray(a)[:, None, :], np.asarray(b)[None, :, :])
    want = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)
    np.testing.assert_array_equal(got, want)
