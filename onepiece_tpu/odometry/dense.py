"""Multi-scale dense RGB-D tracking (direct photometric+geometric alignment).

Device redesign of `Odometry::DenseTracking` + `MultiScaleComputing`
(ref: src/Odometry/Odometry.cpp:463-608, :621-685). The whole coarse-to-fine
Gauss-Newton schedule is jitted: each pyramid level runs a fixed-iteration
`lax.fori_loop` whose body is the fused warp/residual/Jacobian/6x6-reduction
op (ops/dense_odometry.py) plus a 6x6 solve — no host round-trips inside a
frame pair.

Conventions:
  `T_ts` maps source-camera points into the target camera frame:
  p_t = T_ts p_s. A world pose chain updates as
  T_w_target = T_w_source @ inv(T_ts)
  (matches ref: example/DenseFusion/DenseSlam.cpp:30).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3
from ..geometry.camera import PinholeCamera
from ..ops import dense_odometry as dops
from ..ops import image as image_ops

# Reference constants (ref: src/Odometry/OdometryPredefined.h:4-19)
MIN_DEPTH = 0.5
MAX_DEPTH = 4.0
SOBEL_SCALE = 1.0 / 8.0
LAMBDA_HYBRID_DEPTH = 0.5
DEPTH_DIFF_MAX = 0.05  # max |warped z - sampled target z| in meters (ref MAX_DIFF_DEPTH)
DEFAULT_LEVELS = 3
DEFAULT_ITERS = (16, 8, 4)  # coarsest -> ... -> finest? stored finest-first below


class FramePyramid(NamedTuple):
    """Per-level preprocessed data for one RGB-D frame (finest level first)."""

    grays: tuple[jax.Array, ...]  # (H, W) in [0, 1]
    depths: tuple[jax.Array, ...]  # (H, W) meters, 0 invalid
    xyzs: tuple[jax.Array, ...]  # (H, W, 3) camera-frame backprojections


class DenseTrackingResult(NamedTuple):
    T_ts: jax.Array  # (4, 4)
    cost: jax.Array
    num_inliers: jax.Array
    rmse: jax.Array


def _depth_pyr_down(depth: jax.Array) -> jax.Array:
    """Validity-aware 2x2 average: mean of nonzero depths, 0 if all invalid.

    (The reference pyrDowns depth like intensity, which smears zeros across
    boundaries; this rebuild avoids poisoning coarse levels.)
    """
    h, w = depth.shape
    d = depth[: h - h % 2, : w - w % 2].reshape(h // 2, 2, w // 2, 2)
    valid = (d > 0).astype(depth.dtype)
    s = jnp.sum(d * valid, axis=(1, 3))
    c = jnp.sum(valid, axis=(1, 3))
    return jnp.where(c > 0, s / jnp.clip(c, 1.0, None), 0.0)


@functools.partial(
    jax.jit,
    static_argnames=(
        "camera", "levels", "min_depth", "max_depth", "depth_blur",
        "intensity_norm",
    ),
)
def preprocess_frame(
    gray: jax.Array,
    depth: jax.Array,
    camera: PinholeCamera,
    levels: int = DEFAULT_LEVELS,
    min_depth: float = MIN_DEPTH,
    max_depth: float = MAX_DEPTH,
    depth_blur: bool = True,
    intensity_norm: bool = False,
) -> FramePyramid:
    """Gray/depth -> pyramids + XYZ backprojections.

    (ref: Odometry.cpp:609-620 `InitializeRGBDDenseTracking` — gray/255,
    NaN-clip depth to [0.5, 4], Gaussian smooth BOTH gray and depth; the
    reference's NaN depth propagates through the blur, invalidating any
    pixel whose window touches an invalid depth — `depth_blur` reproduces
    that with a validity erosion. :436-461 pyramid builds.)

    `intensity_norm` is the per-frame half of the reference's
    `NormalizeIntensity` (ref: DenseOdometryFunction.cpp:129-144): each
    image is rescaled so its mean intensity over valid-depth pixels is 0.5.
    The reference normalises over the pair's initial correspondences; both
    frames end up at mean 0.5, so per-frame normalisation to the same
    target is equivalent up to the (tiny) support difference, and it keeps
    preprocessing per-frame cacheable.
    """
    g = gray.astype(jnp.float32)
    g = image_ops.gaussian_blur(g)
    d = image_ops.clip_depth(depth.astype(jnp.float32), min_depth, max_depth)
    if depth_blur:
        valid = (d > 0).astype(jnp.float32)
        db = image_ops.gaussian_blur(d)
        vb = image_ops.gaussian_blur(valid)
        d = jnp.where(vb > 0.9999, db, 0.0)
    if intensity_norm:
        m = (d > 0).astype(jnp.float32)
        mean = jnp.sum(g * m) / jnp.clip(jnp.sum(m), 1.0, None)
        g = g * (0.5 / jnp.clip(mean, 1e-6, None))
    grays = [g]
    depths = [d]
    for _ in range(levels - 1):
        grays.append(image_ops.pyr_down(grays[-1]))
        depths.append(_depth_pyr_down(depths[-1]))
    cams = camera.pyramid(levels)
    xyzs = tuple(c.backproject_grid(dl) for c, dl in zip(cams, depths))
    return FramePyramid(tuple(grays), tuple(depths), xyzs)


def _track_level(
    T0: jax.Array,
    src_xyz: jax.Array,
    src_gray: jax.Array,
    tgt: dops.TermData,
    cam: PinholeCamera,
    iters: int,
    term: str,
    lambda_depth: float,
    huber_delta: float,
    depth_diff_max: float = DEPTH_DIFF_MAX,
) -> tuple[jax.Array, dops.NormalEquations]:
    src_pts = src_xyz.reshape(-1, 3)
    src_val = src_pts[:, 2] > 0
    src_g = src_gray.reshape(-1)
    fx = jnp.float32(cam.fx)
    fy = jnp.float32(cam.fy)
    cx = jnp.float32(cam.cx)
    cy = jnp.float32(cam.cy)
    lam = jnp.float32(lambda_depth)
    ddm = jnp.float32(depth_diff_max)

    def body(_, carry):
        T, _ = carry
        ne = dops.normal_equations(
            T, src_pts, src_g, src_val, tgt, fx, fy, cx, cy, lam, ddm,
            term=term, huber_delta=huber_delta,
        )
        return dops.solve_and_update(T, ne), ne

    ne0 = dops.NormalEquations(
        jnp.zeros((6, 6), jnp.float32), jnp.zeros((6,), jnp.float32),
        jnp.float32(0.0), jnp.float32(0.0),
    )
    return jax.lax.fori_loop(0, iters, body, (T0, ne0))


@functools.partial(
    jax.jit,
    static_argnames=(
        "camera", "iters", "term", "huber_delta", "lambda_depth",
        "depth_diff_max", "pair_norm",
    ),
)
def dense_tracking_exact(
    source: FramePyramid,
    target: FramePyramid,
    camera: PinholeCamera,
    init_T: jax.Array | None = None,
    iters: tuple[int, ...] = DEFAULT_ITERS,
    term: str = "hybrid",
    lambda_depth: float = LAMBDA_HYBRID_DEPTH,
    huber_delta: float = 0.0,
    depth_diff_max: float = DEPTH_DIFF_MAX,
    pair_norm: bool = False,
) -> DenseTrackingResult:
    """Coarse-to-fine Gauss-Newton alignment of source onto target.

    iters[0] applies to the coarsest level (ref: Odometry.cpp:621-685
    `MultiScaleComputing`, iteration counts {16, 8, 4} coarse->fine).

    This is the reference-exact formulation with per-iteration bilinear
    gathers — numerically the baseline; `dense_tracking` (pre-warp +
    stencil) is the production path validated against this one.
    """
    levels = len(source.grays)
    assert len(iters) == levels
    T = jnp.eye(4, dtype=jnp.float32) if init_T is None else init_T
    cams = camera.pyramid(levels)
    if pair_norm:
        # Reference NormalizeIntensity (ref: DenseOdometryFunction.cpp:129-144):
        # over the identity-pose correspondences (same pixel, both depths
        # valid, |dz| < MAX_DIFF_DEPTH) scale each gray image to mean 0.5.
        ds = source.depths[0]
        dt = target.depths[0]
        m = ((ds > 0) & (dt > 0) & (jnp.abs(dt - ds) < depth_diff_max)).astype(
            jnp.float32
        )
        msum = jnp.clip(jnp.sum(m), 1.0, None)
        s_s = 0.5 / jnp.clip(jnp.sum(source.grays[0] * m) / msum, 1e-6, None)
        s_t = 0.5 / jnp.clip(jnp.sum(target.grays[0] * m) / msum, 1e-6, None)
    else:
        s_s = jnp.float32(1.0)
        s_t = jnp.float32(1.0)
    last_ne = None
    for li in reversed(range(levels)):  # coarsest first
        tgt = dops.build_term_data(target.grays[li], target.depths[li], SOBEL_SCALE)
        tgt = tgt._replace(gray=tgt.gray * s_t, dx=tgt.dx * s_t, dy=tgt.dy * s_t)
        T, last_ne = _track_level(
            T,
            source.xyzs[li],
            source.grays[li] * s_s,
            tgt,
            cams[li],
            iters[levels - 1 - li],
            term,
            lambda_depth,
            huber_delta,
            depth_diff_max,
        )
    rmse = jnp.sqrt(last_ne.cost / jnp.clip(last_ne.num_inliers, 1.0, None))
    return DenseTrackingResult(T, last_ne.cost, last_ne.num_inliers, rmse)


def chain_pose(T_w_source: jax.Array, T_ts: jax.Array) -> jax.Array:
    """T_w_target = T_w_source @ inv(T_ts) (ref: DenseSlam.cpp:30)."""
    return T_w_source @ se3.inverse_T(T_ts)


# ---------------------------------------------------------------------------
# Production path: per-level BILINEAR pre-warp (one quad-packed row gather) +
# gather-free stencil sampling inside the GN loop. See ops/warp.py for the
# design: one gather per level instead of per iteration, and packing
# the 2x2 bilinear neighbourhood of all 7 term planes into one 28-channel
# row costs the same as the old 3-channel nearest gather while producing
# exactly the values the reference-exact path would bilinearly sample —
# including the TARGET-space Sobel gradients, which removes the
# warped-gradient rotation correction (and its rounding-noise bias: the old
# nearest pre-warp carried ~0.5 px resampling jitter into the Sobel planes,
# a rel-rot bias of ~0.2 deg/pair that re-linearisation could not fix).
# ---------------------------------------------------------------------------


def _pack_quad_rows(term: dops.TermData) -> jax.Array:
    """Pack target term planes into bilinear-quad rows (H*W+1, 32) bf16.

    Row layout: 4 taps [(0,0), (0,1), (1,0), (1,1)] x 8 channels
    [gray, dx, dy, d_hi, d_lo, zdx, zdy, depth_valid]. The final row is an
    all-zero (invalid) dummy for out-of-bounds indices.

    bf16 halves the bytes of BOTH the pack's channel relayout and the
    prewarp's 307k-row gather (the gather is byte-bound at these row
    widths). Depth is the one channel whose bf16 quantisation (~8 mm at
    2 m) would wreck the geometric residual, so it travels as an exact
    hi+lo bf16 pair (reconstruction error ~2^-16 relative, 0.03 mm at
    2 m). Gradients and gray tolerate bf16's ~0.4% relative error: they
    only steer GN, and the bench ATE is unchanged at 1.0 mm.
    """
    h, w = term.gray.shape
    d = term.depth
    d_hi = d.astype(jnp.bfloat16)
    d_lo = (d - d_hi.astype(jnp.float32)).astype(jnp.bfloat16)
    planes = jnp.stack(
        [
            term.gray.astype(jnp.bfloat16),
            term.dx.astype(jnp.bfloat16),
            term.dy.astype(jnp.bfloat16),
            d_hi, d_lo,
            term.zdx.astype(jnp.bfloat16),
            term.zdy.astype(jnp.bfloat16),
            (d > 0).astype(jnp.bfloat16),
        ]
    )  # (8, H, W)
    padded = jnp.pad(planes, ((0, 0), (0, 1), (0, 1)))
    taps = [padded[:, dy : dy + h, dx : dx + w] for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1))]
    q = jnp.concatenate(taps, axis=0)  # (32, H, W)
    rows = q.reshape(32, h * w).T  # (H*W, 32)
    return jnp.concatenate([rows, jnp.zeros((1, 32), rows.dtype)], axis=0)


def _bilinear_prewarp(
    quad_rows: jax.Array, uv0f: jax.Array, h: int, w: int
) -> tuple[jax.Array, jax.Array]:
    """Bilinearly warp all term planes to the source grid. ONE gather.

    Returns (stack6 (6, H, W) f32 = gray/dx/dy/depth/zdx/zdy sampled at
    uv0f, valid (H, W): in-bounds with all four depth taps valid — the
    same gate as the exact path's `bilinear_sample(..., valid_zero=True)`).
    The quad rows are bf16 (see `_pack_quad_rows`); the bilinear combine
    runs in f32 and depth is reconstructed from its hi+lo pair.
    """
    u = uv0f[..., 0]
    v = uv0f[..., 1]
    u0 = jnp.floor(u)
    v0 = jnp.floor(v)
    fu = u - u0
    fv = v - v0
    u0i = u0.astype(jnp.int32)
    v0i = v0.astype(jnp.int32)
    inb = (u0i >= 0) & (u0i < w - 1) & (v0i >= 0) & (v0i < h - 1)
    base = jnp.where(inb, v0i * w + u0i, h * w)
    q = quad_rows[base].astype(jnp.float32)  # (H, W, 32) — ONE gather
    w00 = ((1 - fu) * (1 - fv))[..., None]
    w01 = (fu * (1 - fv))[..., None]
    w10 = ((1 - fu) * fv)[..., None]
    w11 = (fu * fv)[..., None]
    t00, t01, t10, t11 = q[..., 0:8], q[..., 8:16], q[..., 16:24], q[..., 24:32]
    s = t00 * w00 + t01 * w01 + t10 * w10 + t11 * w11
    all_taps_valid = (t00[..., 7] > 0) & (t01[..., 7] > 0) & (t10[..., 7] > 0) & (t11[..., 7] > 0)
    valid = inb & all_taps_valid
    # reconstruct depth = d_hi + d_lo; channel order back to the stack6
    # convention [gray, dx, dy, depth, zdx, zdy]
    s6 = jnp.stack(
        [s[..., 0], s[..., 1], s[..., 2], s[..., 3] + s[..., 4], s[..., 5], s[..., 6]],
        axis=-1,
    )
    stack6 = jnp.moveaxis(jnp.where(valid[..., None], s6, 0.0), -1, 0)
    return stack6, valid


def _track_level_direct(
    T0: jax.Array,
    src_xyz: jax.Array,  # (H, W, 3)
    src_gray: jax.Array,  # (H, W)
    term: "dops.TermData",  # target planes, channels-first, NO packing
    cam: PinholeCamera,
    iters: int,
    radius: int,
    lambda_depth: float,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Gather-free GN with DIRECT stencil sampling of the target planes.

    Numerically this is `dense_tracking_exact`'s bilinear sampling (the
    stencil's tent weights ARE bilinear interpolation), valid whenever the
    per-pixel displacement uv(x) - x stays within radius-1 pixels — true at
    the finest level once the coarser levels have converged the pose. It
    skips the quad-row pack (a 28-channel relayout) and the 307k-row
    prewarp gather entirely, and
    needs no warp-Jacobian correction (the sampling map is the identity).
    Pixels whose displacement exceeds the stencil drop out of the normal
    equations (graceful: the coarser levels' pose survives).
    """
    from ..ops import warp as warp_ops

    fx = jnp.float32(cam.fx)
    fy = jnp.float32(cam.fy)
    cx = jnp.float32(cam.cx)
    cy = jnp.float32(cam.cy)
    h, w = src_gray.shape
    z_src = src_xyz[..., 2]
    src_valid = z_src > 0
    stack6 = jnp.stack([term.gray, term.dx, term.dy, term.depth, term.zdx, term.zdy])
    tgt_valid = term.depth > 0
    grid_u = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    grid_v = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)

    lam = jnp.float32(lambda_depth)
    ddm = jnp.float32(DEPTH_DIFF_MAX)

    def project(T):
        R = T[:3, :3]
        t = T[:3, 3]
        p = jnp.einsum("ij,hwj->hwi", R, src_xyz) + t
        z = p[..., 2]
        zs = jnp.where(z > 1e-6, z, 1.0)
        u = p[..., 0] / zs * fx + cx
        v = p[..., 1] / zs * fy + cy
        return p, z, u, v

    def body(_, carry):
        T, _c, _n = carry
        p, z, u, v = project(T)
        d = jnp.stack([u - grid_u, v - grid_v])
        vals, ok = warp_ops.stencil_sample(stack6, tgt_valid, d, radius)
        g, gx, gy, zt, ztx, zty = (vals[i] for i in range(6))
        r_i = g - src_gray
        r_z = zt - z
        valid = ok & src_valid & (z > 1e-6) & (jnp.abs(r_z) < ddm)

        px, py = p[..., 0], p[..., 1]
        inv_z = 1.0 / jnp.where(z > 1e-6, z, 1.0)
        a = fx * inv_z
        b = fy * inv_z

        def twist_rows(cx_, cy_, extra_z=0.0):
            g1 = cx_ * a
            g2 = cy_ * b
            g3 = -(cx_ * a * px + cy_ * b * py) * inv_z + extra_z
            w1 = py * g3 - z * g2
            w2 = z * g1 - px * g3
            w3 = px * g2 - py * g1
            return (g1, g2, g3, w1, w2, w3)

        Ji = twist_rows(gx, gy)
        Jz = twist_rows(ztx, zty, extra_z=-1.0)
        vf = valid.astype(jnp.float32)
        wi = vf * (1.0 - lam)
        wz = vf * lam
        Ji_m = jnp.stack([x.reshape(-1) for x in Ji])
        Jz_m = jnp.stack([x.reshape(-1) for x in Jz])
        wi_f = wi.reshape(-1)
        wz_f = wz.reshape(-1)
        JTJ = jnp.einsum("in,n,jn->ij", Ji_m, wi_f, Ji_m) + jnp.einsum(
            "in,n,jn->ij", Jz_m, wz_f, Jz_m
        )
        JTr = Ji_m @ (wi_f * r_i.reshape(-1)) + Jz_m @ (wz_f * r_z.reshape(-1))
        cost = jnp.sum(wi * r_i * r_i + wz * r_z * r_z)
        nin = jnp.sum(vf)
        A = JTJ + 1e-6 * jnp.eye(6, dtype=JTJ.dtype)
        xi = jnp.linalg.solve(A, -JTr)
        good = jnp.all(jnp.isfinite(xi)) & (nin > 6)
        xi = jnp.where(good, xi, 0.0)
        return se3.se3_exp(xi) @ T, cost, nin

    return jax.lax.fori_loop(
        0, iters, body, (T0, jnp.float32(0.0), jnp.float32(0.0))
    )


def _track_level_prewarp(
    T0: jax.Array,
    src_xyz: jax.Array,  # (H, W, 3)
    src_gray: jax.Array,  # (H, W)
    quad_rows: jax.Array,  # (H*W+1, 28) packed target term planes
    cam: PinholeCamera,
    iters: int,
    radius: int,
    lambda_depth: float,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    from ..ops import warp as warp_ops

    fx = jnp.float32(cam.fx)
    fy = jnp.float32(cam.fy)
    cx = jnp.float32(cam.cx)
    cy = jnp.float32(cam.cy)
    h, w = src_gray.shape
    z_src = src_xyz[..., 2]
    src_valid = z_src > 0

    def project(T):
        R = T[:3, :3]
        t = T[:3, 3]
        p = jnp.einsum("ij,hwj->hwi", R, src_xyz) + t
        z = p[..., 2]
        zs = jnp.where(z > 1e-6, z, 1.0)
        u = p[..., 0] / zs * fx + cx
        v = p[..., 1] / zs * fy + cy
        return p, z, jnp.stack([u, v], axis=-1)

    # pre-warp at level entry with T0 (one quad-row gather): stack6 holds the
    # target's gray/dx/dy/depth/zdx/zdy bilinearly sampled at uv0f — the
    # gradients are the TARGET-space Sobel planes, exactly what the exact
    # path samples, so no gradient rotation correction is needed below.
    _, _, uv0f = project(T0)
    stack6, stack_valid = _bilinear_prewarp(quad_rows, uv0f, h, w)

    # Spatial Jacobian of the pre-warp map, J_w = d(uv0f)/d(x): sampling the
    # pre-warped stack at x + delta reads the target near
    # uv0f(x) + J_w delta, so the GN displacement must be mapped through
    # J_w^{-1} — without it, a non-identity base pose (e.g. previous-frame
    # init) displaces the samples and the tracker drifts.
    def _grad_xy(f):
        gx = jnp.zeros_like(f).at[:, 1:-1].set((f[:, 2:] - f[:, :-2]) * 0.5)
        gy = jnp.zeros_like(f).at[1:-1, :].set((f[2:, :] - f[:-2, :]) * 0.5)
        return gx, gy

    a11, a12 = _grad_xy(uv0f[..., 0])  # du0/dx, du0/dy
    a21, a22 = _grad_xy(uv0f[..., 1])  # dv0/dx, dv0/dy
    detJ = a11 * a22 - a12 * a21
    # fall back to identity where the warp map is degenerate (invalid depth,
    # depth discontinuities)
    ok_j = (jnp.abs(detJ) > 0.25) & (jnp.abs(detJ) < 4.0)
    inv_det = jnp.where(ok_j, 1.0 / jnp.where(ok_j, detJ, 1.0), 1.0)
    j11 = jnp.where(ok_j, a22 * inv_det, 1.0)
    j12 = jnp.where(ok_j, -a12 * inv_det, 0.0)
    j21 = jnp.where(ok_j, -a21 * inv_det, 0.0)
    j22 = jnp.where(ok_j, a11 * inv_det, 1.0)

    lam = jnp.float32(lambda_depth)
    ddm = jnp.float32(DEPTH_DIFF_MAX)

    def body(_, carry):
        T, _c, _n = carry
        p, z, uv = project(T)
        # displacement in the pre-warped frame: J_w^{-1} (uv - uv0f)
        ru = uv[..., 0] - uv0f[..., 0]
        rv = uv[..., 1] - uv0f[..., 1]
        du = j11 * ru + j12 * rv
        dv = j21 * ru + j22 * rv
        d = jnp.stack([du, dv])
        vals, ok = warp_ops.stencil_sample(stack6, stack_valid, d, radius)
        g, gx, gy, zt, ztx, zty = (vals[i] for i in range(6))
        r_i = g - src_gray
        r_z = zt - z
        valid = ok & src_valid & (z > 1e-6) & (jnp.abs(r_z) < ddm)

        # Jacobian rows as 6 image planes each (channels-first: W on lanes)
        px, py = p[..., 0], p[..., 1]
        inv_z = 1.0 / jnp.where(z > 1e-6, z, 1.0)
        a = fx * inv_z
        b = fy * inv_z

        def twist_rows(cx_, cy_, extra_z=0.0):
            # row = cx_ * du/dp + cy_ * dv/dp (+ extra_z * e_z), then [row | p x row]
            g1 = cx_ * a
            g2 = cy_ * b
            g3 = -(cx_ * a * px + cy_ * b * py) * inv_z + extra_z
            w1 = py * g3 - z * g2
            w2 = z * g1 - px * g3
            w3 = px * g2 - py * g1
            return (g1, g2, g3, w1, w2, w3)

        Ji = twist_rows(gx, gy)
        Jz = twist_rows(ztx, zty, extra_z=-1.0)

        vf = valid.astype(jnp.float32)
        wi = vf * (1.0 - lam)
        wz = vf * lam
        Ji_m = jnp.stack([x.reshape(-1) for x in Ji])  # (6, N)
        Jz_m = jnp.stack([x.reshape(-1) for x in Jz])
        wi_f = wi.reshape(-1)
        wz_f = wz.reshape(-1)
        JTJ = jnp.einsum("in,n,jn->ij", Ji_m, wi_f, Ji_m) + jnp.einsum(
            "in,n,jn->ij", Jz_m, wz_f, Jz_m
        )
        JTr = Ji_m @ (wi_f * r_i.reshape(-1)) + Jz_m @ (wz_f * r_z.reshape(-1))
        cost = jnp.sum(wi * r_i * r_i + wz * r_z * r_z)
        nin = jnp.sum(vf)
        A = JTJ + 1e-6 * jnp.eye(6, dtype=JTJ.dtype)
        xi = jnp.linalg.solve(A, -JTr)
        good = jnp.all(jnp.isfinite(xi)) & (nin > 6)
        xi = jnp.where(good, xi, 0.0)
        return se3.se3_exp(xi) @ T, cost, nin

    T, cost, nin = jax.lax.fori_loop(
        0, iters, body, (T0, jnp.float32(0.0), jnp.float32(0.0))
    )
    return T, cost, nin


@functools.partial(
    jax.jit,
    static_argnames=(
        "camera", "iters", "radii", "lambda_depth", "polish", "direct_fine",
    ),
)
def dense_tracking(
    source: FramePyramid,
    target: FramePyramid,
    camera: PinholeCamera,
    init_T: jax.Array | None = None,
    iters: tuple[int, ...] = DEFAULT_ITERS,
    radii: tuple[int, ...] = (8, 4, 4),
    lambda_depth: float = LAMBDA_HYBRID_DEPTH,
    polish: int = 0,
    direct_fine: bool = False,
) -> DenseTrackingResult:
    """Production multi-scale dense tracking (bilinear pre-warp + stencil).

    Per level: ONE quad-packed row gather bilinearly rebases the target's
    term planes (gray/dx/dy/depth/zdx/zdy, target-space Sobel) onto the
    source grid at the level-entry pose, then `iters` gather-free GN
    iterations sample the pre-warped stack with a (2r+1)^2 stencil at the
    J_w^{-1}-mapped residual displacement. radii[0] is the coarsest level's
    stencil radius (largest because the init pose is least converged
    there). Numerics match `dense_tracking_exact` to the smoothness of the
    pre-warp map (second-order in the residual displacement).

    `polish` > 0 adds one RE-LINEARISATION round at the finest level: a
    fresh pre-warp at the converged pose plus `polish` extra stencil
    iterations (radius 2). With the bilinear pre-warp the level-entry
    samples are already exact, so polish is off by default (it buys <0.1 mm
    ATE on the bench sequence for an extra stencil pass); enable it for large-motion
    pairs where the finest-level entry pose is far from the solution.
    """
    levels = len(source.grays)
    assert len(iters) == levels and len(radii) == levels
    T = jnp.eye(4, dtype=jnp.float32) if init_T is None else init_T
    cams = camera.pyramid(levels)
    cost = jnp.float32(0.0)
    nin = jnp.float32(1.0)
    quad0 = None
    for li in reversed(range(levels)):  # coarsest first
        k = levels - 1 - li
        if direct_fine and li == 0:
            # finest level without prewarp — ONLY for small-baseline
            # streams where inter-frame motion <= radius-1 px (see
            # _track_level_direct's docstring for the constraint)
            term = dops.build_term_data(
                target.grays[li], target.depths[li], SOBEL_SCALE
            )
            T, cost, nin = _track_level_direct(
                T, source.xyzs[li], source.grays[li], term, cams[li],
                iters[k], radii[k], lambda_depth,
            )
            continue
        quad = _pack_quad_rows(
            dops.build_term_data(target.grays[li], target.depths[li], SOBEL_SCALE)
        )
        if li == 0:
            quad0 = quad
        T, cost, nin = _track_level_prewarp(
            T,
            source.xyzs[li],
            source.grays[li],
            quad,
            cams[li],
            iters[k],
            radii[k],
            lambda_depth,
        )
    if polish > 0:
        assert quad0 is not None, "polish requires the prewarp fine level"
        T, cost, nin = _track_level_prewarp(
            T,
            source.xyzs[0],
            source.grays[0],
            quad0,
            cams[0],
            polish,
            2,
            lambda_depth,
        )
    rmse = jnp.sqrt(cost / jnp.clip(nin, 1.0, None))
    return DenseTrackingResult(T, cost, nin, rmse)
