"""Image warping primitives for the dense tracker.

A data-dependent bilinear gather over a 640x480 image is far costlier than
static-slice stencil arithmetic, so it is kept out of the 28-iteration
dense-tracking loop and done once per frame. The dense tracker therefore:

  1. pre-warps the target once per frame by the *initial* pose guess with a
     single stacked gather (`warp_stack`) — odometry motion is smooth, so
     the guess (previous frame's relative pose) is within a few pixels;
  2. inside the GN loop, samples the pre-warped stack with `stencil_sample`
     — a (2D+1)^2 static-shift stencil with per-pixel bilinear weights:
     pure VPU arithmetic, zero gathers, fuses with the residual/Jacobian
     math. Pixels whose residual displacement exceeds D are masked (they
     re-enter at the next coarser level or next frame).

The compositional approximation: sampling the pre-warped image W at
x + (pi(T p(x)) - pi(T_init p(x))) equals sampling the true target at
pi(T p(x)) up to the spatial distortion of the init warp, which is
second-order small for frame-to-frame motion and guarded by the depth
consistency gate downstream.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=())
def warp_stack(images: jax.Array, uv: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Bilinear-sample a channel stack at given coords. ONE gather total.

    images: (H, W, C); uv: (H, W, 2) target pixel coords per output pixel.
    Returns (warped (H, W, C), in_bounds (H, W)). Out-of-bounds -> 0.
    """
    h, w, c = images.shape
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
    flat = images.reshape(-1, c)
    base = v0c * w + u0c
    i00 = flat[base]
    i01 = flat[base + 1]
    i10 = flat[base + w]
    i11 = flat[base + w + 1]
    wf = (
        i00 * ((1 - fu) * (1 - fv))[..., None]
        + i01 * (fu * (1 - fv))[..., None]
        + i10 * ((1 - fu) * fv)[..., None]
        + i11 * (fu * fv)[..., None]
    )
    return jnp.where(inb[..., None], wf, 0.0), inb


@functools.partial(jax.jit, static_argnames=("radius",))
def stencil_sample(
    stack: jax.Array,  # (C, H, W) pre-warped channel planes
    stack_valid: jax.Array,  # (H, W) bool validity of the stack samples
    d: jax.Array,  # (2, H, W) residual displacement (du, dv) in pixels
    radius: int = 4,
) -> tuple[jax.Array, jax.Array]:
    """Gather-free bilinear sampling of `stack` at x + d, |d| <= radius.

    Returns (values (C, H, W), valid (H, W)). A pixel is valid iff all four
    bilinear corners are in-stencil, in-bounds, and stack-valid.

    Layout is channels-FIRST so W sits in the 128-lane dimension (channels-
    last would put C=6 on the lanes and waste 95% of the VPU). The stack is
    zero-padded once; every stencil tap is a static SLICE of the padded
    array, so XLA fuses the whole (2r+1)^2-tap FMA chain into one pass —
    pure VPU work, no materialised shifted copies, no gathers.

    Separable weighting keeps the flop count at ~2 ops/tap: per-row weights
    wy fold into a row-accumulator; per-column weights wx multiply once.
    """
    c, h, w = stack.shape
    r = radius
    du = d[0]
    dv = d[1]
    in_range = (jnp.abs(du) <= r - 1) & (jnp.abs(dv) <= r - 1)
    padded = jnp.pad(stack, ((0, 0), (r, r), (r, r)))
    padded_v = jnp.pad(stack_valid.astype(stack.dtype), ((r, r), (r, r)))
    acc = jnp.zeros_like(stack)
    wacc = jnp.zeros((h, w), stack.dtype)
    for ky in range(-r, r + 1):
        wy = jnp.maximum(0.0, 1.0 - jnp.abs(dv - ky))
        row_acc = jnp.zeros_like(stack)
        row_vacc = jnp.zeros((h, w), stack.dtype)
        for kx in range(-r, r + 1):
            wx = jnp.maximum(0.0, 1.0 - jnp.abs(du - kx))
            sh = padded[:, r + ky : r + ky + h, r + kx : r + kx + w]
            shv = padded_v[r + ky : r + ky + h, r + kx : r + kx + w]
            row_acc = row_acc + sh * wx[None]
            row_vacc = row_vacc + shv * wx
        acc = acc + row_acc * wy[None]
        wacc = wacc + row_vacc * wy
    valid = in_range & (wacc > 0.999)  # all four corners valid
    return jnp.where(valid[None], acc, 0.0), valid
