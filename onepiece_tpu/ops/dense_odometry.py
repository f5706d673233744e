"""Dense direct RGB-D odometry: residual/Jacobian/normal-equation ops.

Device redesign of the reference's Steinbruecker/Park-style dense alignment
(ref: src/Odometry/DenseOdometryFunction.cpp). The reference *forward-warps*
source pixels into the target with a z-buffered scatter
(`ComputeCorrespondencePixelWise`, :72-128) then accumulates per-pixel 6x6
JTJ terms in a scalar loop (`ComputeJTJandJTr*`, :297-381).

Scatter-with-conflicts is hostile to a vector unit, so here the warp is a
*gather*: every source pixel's 3D point is transformed by the current pose,
projected into the target, and the target intensity/gradient/depth are
bilinearly sampled. Occlusion is handled by a depth-consistency gate (the
sampled target depth must agree with the transformed point's depth), which
plays the role of the reference's z-buffer. One jit region computes
residuals, Jacobians, and reduces the full 6x6 normal equations with two
einsums — XLA fuses the whole pipeline into a handful of VPU passes.

Energy (ref: DenseOdometryFunction.cpp:146-296 `ComputeJacobian*Term`):
  E = (1-lambda) * sum r_I^2 + lambda * sum r_Z^2,  lambda = 0.5 default
      (ref: src/Odometry/OdometryPredefined.h LAMBDA_HYBRID / _DEPTH = 0.5)
with  r_I = I_tgt(pi(T p)) - I_src(x),  r_Z = Z_tgt(pi(T p)) - [T p]_z.

The pose update is left-multiplicative:  T <- exp(xi) @ T, so
  d(Tp)/dxi = [ I | -[Tp]_x ].
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import image as image_ops


class TermData(NamedTuple):
    """Per-level target-side data for one alignment problem."""

    gray: jax.Array  # (H, W) normalized intensity
    dx: jax.Array  # (H, W) intensity gradient (already Sobel-scaled)
    dy: jax.Array
    depth: jax.Array  # (H, W) meters, 0 = invalid
    zdx: jax.Array  # (H, W) depth gradients
    zdy: jax.Array


class NormalEquations(NamedTuple):
    JTJ: jax.Array  # (6, 6)
    JTr: jax.Array  # (6,)
    cost: jax.Array  # scalar weighted SSE
    num_inliers: jax.Array  # scalar float


def build_term_data(gray: jax.Array, depth: jax.Array, sobel_scale: float = 0.125) -> TermData:
    """Precompute gradients for one pyramid level of the target frame.

    sobel_scale is the reference's 1/8 Sobel normalisation
    (ref: src/Odometry/OdometryPredefined.h SOBEL_SCALE).

    Depth gradients are masked to 0 wherever the 3x3 Sobel window touches
    an invalid (0) depth: the reference stores invalid depth as NaN, so its
    depth Sobel goes NaN there and is explicitly zeroed
    (ref: DenseOdometryFunction.cpp:207-208, :258-259). With 0-filled
    invalid depth, an unmasked Sobel would instead fabricate multi-meter
    gradients along validity edges and bias the geometric term.
    """
    dx, dy = image_ops.sobel(gray)
    zdx, zdy = image_ops.sobel(depth)
    valid = (depth > 0).astype(gray.dtype)
    wsum = image_ops.box_sum3(valid)
    interior = wsum > 8.5  # all 9 window taps valid
    zdx = jnp.where(interior, zdx, 0.0)
    zdy = jnp.where(interior, zdy, 0.0)
    return TermData(gray, dx * sobel_scale, dy * sobel_scale, depth, zdx * sobel_scale, zdy * sobel_scale)


@functools.partial(jax.jit, static_argnames=("term", "huber_delta"))
def normal_equations(
    T: jax.Array,
    src_xyz: jax.Array,  # (N, 3) source camera-frame points
    src_gray: jax.Array,  # (N,)
    src_valid: jax.Array,  # (N,) bool
    tgt: TermData,
    fx: jax.Array,
    fy: jax.Array,
    cx: jax.Array,
    cy: jax.Array,
    lambda_depth: jax.Array,
    depth_diff_max: jax.Array,
    term: str = "hybrid",
    huber_delta: float = 0.0,
) -> NormalEquations:
    """One linearisation: warp source into target, build 6x6 normal equations.

    term: 'photo' | 'depth' | 'hybrid' (ref: DenseOdometryFunction.cpp
    DoSingleIteration{Photo,Depth,Hybrid} :382-475).
    """
    h, w = tgt.gray.shape
    R = T[:3, :3]
    t = T[:3, 3]
    p = src_xyz @ R.T + t  # (N, 3) transformed points
    z = p[:, 2]
    zsafe = jnp.where(z > 1e-6, z, 1.0)
    u = p[:, 0] / zsafe * fx + cx
    v = p[:, 1] / zsafe * fy + cy
    uv = jnp.stack([u, v], axis=-1)

    g, ok_g = image_ops.bilinear_sample(tgt.gray, uv)
    gx, _ = image_ops.bilinear_sample(tgt.dx, uv)
    gy, _ = image_ops.bilinear_sample(tgt.dy, uv)
    zt, ok_z = image_ops.bilinear_sample(tgt.depth, uv, valid_zero=True)
    ztx, _ = image_ops.bilinear_sample(tgt.zdx, uv)
    zty, _ = image_ops.bilinear_sample(tgt.zdy, uv)

    r_i = g - src_gray
    r_z = zt - z

    valid = src_valid & ok_g & ok_z & (z > 1e-6) & (jnp.abs(r_z) < depth_diff_max)

    # d(u,v)/dp  rows: (N, 2, 3)
    inv_z = 1.0 / zsafe
    du_dp = jnp.stack([fx * inv_z, jnp.zeros_like(z), -fx * p[:, 0] * inv_z * inv_z], axis=-1)
    dv_dp = jnp.stack([jnp.zeros_like(z), fy * inv_z, -fy * p[:, 1] * inv_z * inv_z], axis=-1)

    # dp/dxi = [I | -[p]_x]; fold directly: J_p(3->6) applied to a row g(1,3):
    #   J[:3] = g ; J[3:] = -g x... actually (g @ (-skew(p))) = cross(p, g)
    def row_to_twist(grow):  # (N, 3) -> (N, 6)
        lin = grow
        ang = jnp.cross(p, grow)  # g @ (-[p]_x) == p x g
        return jnp.concatenate([lin, ang], axis=-1)

    g_i = gx[:, None] * du_dp + gy[:, None] * dv_dp  # (N, 3) dI/dp through warp
    J_i = row_to_twist(g_i)

    g_z = ztx[:, None] * du_dp + zty[:, None] * dv_dp  # depth-map sampling term
    ez = jnp.zeros_like(g_z).at[:, 2].set(1.0)
    J_z = row_to_twist(g_z - ez)

    vf = valid.astype(jnp.float32)
    w_i = jnp.sqrt(jnp.maximum(1.0 - lambda_depth, 0.0))
    w_z = jnp.sqrt(jnp.maximum(lambda_depth, 0.0))
    if term == "photo":
        w_z = jnp.zeros_like(w_z)
        w_i = jnp.ones_like(w_i)
    elif term == "depth":
        w_i = jnp.zeros_like(w_i)
        w_z = jnp.ones_like(w_z)

    if huber_delta > 0.0:
        # Huber IRLS weights on each residual stream
        hw_i = jnp.minimum(1.0, huber_delta / jnp.maximum(jnp.abs(r_i), 1e-12))
        hw_z = jnp.minimum(1.0, huber_delta / jnp.maximum(jnp.abs(r_z), 1e-12))
    else:
        hw_i = jnp.ones_like(r_i)
        hw_z = jnp.ones_like(r_z)

    wi = vf * w_i * w_i * hw_i
    wz = vf * w_z * w_z * hw_z

    # stack the two residual streams: (N, 2, 6) and (N, 2)
    J = jnp.stack([J_i, J_z], axis=1)
    r = jnp.stack([r_i, r_z], axis=1)
    wgt = jnp.stack([wi, wz], axis=1)

    JTJ = jnp.einsum("nki,nk,nkj->ij", J, wgt, J)
    JTr = jnp.einsum("nki,nk,nk->i", J, wgt, r)
    cost = jnp.einsum("nk,nk->", wgt, r * r)
    return NormalEquations(JTJ, JTr, cost, jnp.sum(vf))


def solve_and_update(T: jax.Array, ne: NormalEquations, damping: float = 1e-6) -> jax.Array:
    """Gauss-Newton step: solve (JTJ + damp I) xi = -JTr, T <- exp(xi) T.

    (ref: DenseOdometryFunction.cpp:402-411 does an LDLT solve of the 6x6.)
    Falls back to no-op when the system is degenerate (non-finite solve).
    """
    from ..geometry import se3

    A = ne.JTJ + damping * jnp.eye(6, dtype=ne.JTJ.dtype)
    xi = jnp.linalg.solve(A, -ne.JTr)
    ok = jnp.all(jnp.isfinite(xi)) & (ne.num_inliers > 6)
    xi = jnp.where(ok, xi, 0.0)
    return se3.se3_exp(xi) @ T


def normalize_intensity_scale(
    src_gray: jax.Array,
    src_valid: jax.Array,
    tgt_gray_sampled: jax.Array,
    sample_valid: jax.Array,
) -> jax.Array:
    """Mean-intensity ratio for exposure normalisation.

    (ref: DenseOdometryFunction.cpp:129-144 `NormalizeIntensity` scales both
    images to the mean over initial correspondences.) Returns the scale to
    apply to the target image.
    """
    m = (src_valid & sample_valid).astype(jnp.float32)
    ms = jnp.sum(src_gray * m) / jnp.clip(jnp.sum(m), 1.0, None)
    mt = jnp.sum(tgt_gray_sampled * m) / jnp.clip(jnp.sum(m), 1.0, None)
    return jnp.where(mt > 1e-6, ms / jnp.clip(mt, 1e-6, None), 1.0)
