"""Image-processing ops for the dense-odometry front end.

Device replacement of the OpenCV calls in ref:
src/Tool/ImageProcessing.{h,cpp} — pyramids (`CreatePyramid`, :6), Sobel
(`SobelFiltering`, :25), Gaussian (`GaussianFiltering`, :43), bilateral
(`BilateralFilter`, :64) — as jitted depthwise convolutions / stencils. All
ops keep static shapes and run on the VPU; XLA fuses them into neighbouring
elementwise work.

Kernel coefficient conventions match OpenCV's (what the reference uses):
pyrDown's 5-tap [1 4 6 4 1]/16 binomial filter, Sobel 3x3 with the
reference's 1/8 normalisation applied by the caller
(ref: src/Odometry/OdometryPredefined.h SOBEL_SCALE).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _conv2d_same(img: jax.Array, kernel) -> jax.Array:
    """Single-channel 2D correlation with edge replication, (H, W) x (kh, kw).
    `kernel` must be a concrete numpy array (taps unroll at trace time).

    Implemented as a static-slice stencil (pad once, FMA over taps) rather
    than conv_general_dilated: single-channel images waste a convolution
    unit's channel width, while the slice stencil fuses into one
    elementwise pass.
    """
    k_np = np.asarray(kernel)
    kh, kw = k_np.shape
    ph, pw = kh // 2, kw // 2
    h, w = img.shape
    padded = jnp.pad(img, ((ph, ph), (pw, pw)), mode="edge")
    if kh * kw > 64:
        # large kernels (e.g. the 31x31 orientation disk): one XLA conv call
        # beats thousands of unrolled taps
        out = jax.lax.conv_general_dilated(
            padded[None, None],
            jnp.asarray(k_np[None, None], img.dtype),
            window_strides=(1, 1),
            padding="VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
        )
        return out[0, 0]
    out = jnp.zeros_like(img)
    for iy in range(kh):
        for ix in range(kw):
            c = float(k_np[iy, ix])
            if c == 0.0:
                continue
            out = out + c * padded[iy : iy + h, ix : ix + w]
    return out


_BINOMIAL5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def gaussian_blur(img: jax.Array) -> jax.Array:
    """5x5 binomial (Gaussian) blur, separable. (ref: ImageProcessing.cpp:43)."""
    k = _BINOMIAL5
    tmp = _conv2d_same(img, k[None, :])
    return _conv2d_same(tmp, k[:, None])


def pyr_down(img: jax.Array) -> jax.Array:
    """OpenCV-style pyrDown: binomial blur then 2x decimation.

    (ref: ImageProcessing.cpp:6 `CreatePyramid` uses cv::pyrDown).
    """
    return gaussian_blur(img)[::2, ::2]


def build_pyramid(img: jax.Array, levels: int) -> tuple[jax.Array, ...]:
    """Level-0 is the input; each next level is pyrDown of the previous."""
    out = [img]
    for _ in range(levels - 1):
        out.append(pyr_down(out[-1]))
    return tuple(out)


_SOBEL_X = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]])


def sobel(img: jax.Array) -> tuple[jax.Array, jax.Array]:
    """3x3 Sobel dx, dy (ref: ImageProcessing.cpp:25 `SobelFiltering`)."""
    dx = _conv2d_same(img, _SOBEL_X)
    dy = _conv2d_same(img, _SOBEL_X.T)
    return dx, dy


def box_sum3(img: jax.Array) -> jax.Array:
    """3x3 box sum with edge replication (validity-window counting)."""
    return _conv2d_same(img, np.ones((3, 3)))


def scharr(img: jax.Array) -> tuple[jax.Array, jax.Array]:
    """3x3 Scharr gradients (better rotational symmetry than Sobel)."""
    k = np.array([[-3.0, 0, 3], [-10, 0, 10], [-3, 0, 3]])
    return _conv2d_same(img, k), _conv2d_same(img, k.T)


def rgb_to_gray(rgb: jax.Array) -> jax.Array:
    """(H, W, 3) uint8/float -> (H, W) float32 in [0, 255] (BT.601 like cv::cvtColor)."""
    rgb = rgb.astype(jnp.float32)
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def depth_to_meters(depth_raw: jax.Array, depth_scale: float) -> jax.Array:
    """uint16 depth -> float32 meters; zeros stay zero.

    (ref: ImageProcessing.cpp:68 `ConvertDepthTo32F`).
    """
    return depth_raw.astype(jnp.float32) / depth_scale


def clip_depth(depth: jax.Array, near: float, far: float) -> jax.Array:
    """Invalidate (set 0) depths outside [near, far] and non-finite values.

    (ref: src/Odometry/Odometry.cpp:609-620 `InitializeRGBDDenseTracking`
    NaN-clips to [MIN_DEPTH, MAX_DEPTH] = [0.5, 4.0] by default,
    ref: src/Odometry/OdometryPredefined.h).
    """
    ok = jnp.isfinite(depth) & (depth >= near) & (depth <= far)
    return jnp.where(ok, depth, 0.0)


@functools.partial(jax.jit, static_argnames=("radius",))
def bilateral_filter(
    depth: jax.Array,
    radius: int = 2,
    sigma_space: float = 2.0,
    sigma_value: float = 0.03,
) -> jax.Array:
    """Edge-preserving depth smoothing (ref: ImageProcessing.cpp:64).

    Fixed-window stencil: each of the (2r+1)^2 taps is a static SLICE of the
    zero-padded image (XLA fuses the whole FMA chain into one pass — a
    jnp.roll formulation materialises a concatenate per tap), weighted by
    spatial Gaussian x value Gaussian,
    skipping invalid (0) depths. This is the pre-integration filter
    (ref: example/DenseFusion/DenseFusion.cpp bilateral before
    IntegrateImage).
    """
    h, w = depth.shape
    r = radius
    padded = jnp.pad(depth, ((r, r), (r, r)))
    acc = jnp.zeros_like(depth)
    wacc = jnp.zeros_like(depth)
    valid_c = depth > 0
    inv2v = 1.0 / (2 * sigma_value**2)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            shifted = padded[r + dy : r + dy + h, r + dx : r + dx + w]
            ok = (shifted > 0) & valid_c
            ws = np.exp(-(dx * dx + dy * dy) / (2 * sigma_space**2))
            wv = jnp.exp(-((shifted - depth) ** 2) * inv2v)
            w_ = jnp.where(ok, ws * wv, 0.0)
            acc = acc + w_ * shifted
            wacc = wacc + w_
    out = jnp.where(wacc > 1e-8, acc / jnp.clip(wacc, 1e-8, None), depth)
    return jnp.where(valid_c, out, 0.0)


def bilinear_sample(img: jax.Array, uv: jax.Array, *, valid_zero: bool = False) -> tuple[jax.Array, jax.Array]:
    """Bilinear interpolation of (H, W) image at continuous (..., 2) [u, v] coords.

    Returns (values (...,), in_bounds mask (...,)). If valid_zero, samples
    whose 4-neighbourhood contains a zero (invalid depth) are masked out —
    matching how the reference skips invalid-depth correspondences
    (ref: src/Odometry/DenseOdometryFunction.cpp:72-128).
    """
    h, w = img.shape
    u = uv[..., 0]
    v = uv[..., 1]
    u0 = jnp.floor(u)
    v0 = jnp.floor(v)
    fu = u - u0
    fv = v - v0
    u0i = u0.astype(jnp.int32)
    v0i = v0.astype(jnp.int32)
    inb = (u0i >= 0) & (u0i < w - 1) & (v0i >= 0) & (v0i < h - 1)
    u0c = jnp.clip(u0i, 0, w - 2)
    v0c = jnp.clip(v0i, 0, h - 2)
    p00 = img[v0c, u0c]
    p01 = img[v0c, u0c + 1]
    p10 = img[v0c + 1, u0c]
    p11 = img[v0c + 1, u0c + 1]
    val = (
        p00 * (1 - fu) * (1 - fv)
        + p01 * fu * (1 - fv)
        + p10 * (1 - fu) * fv
        + p11 * fu * fv
    )
    if valid_zero:
        inb = inb & (p00 > 0) & (p01 > 0) & (p10 > 0) & (p11 > 0)
    return val, inb
