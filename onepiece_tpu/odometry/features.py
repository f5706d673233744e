"""ORB-style feature detection & description in pure JAX.

The reference outsources its sparse front end to OpenCV's ORB
(ref: src/Odometry/Odometry.cpp:368-379 detectAndCompute); this framework
implements the FAST + orientation + steered-BRIEF pipeline natively so the
whole front end runs on device. Descriptors are only ever matched against
descriptors produced by this same module, so instead of transcribing
OpenCV's learned bit_pattern_31_, the 256 BRIEF point pairs are drawn once
from a seeded Gaussian (the original BRIEF recipe) — self-consistent and
copyright-clean.

Design notes (device-first):
  - FAST's 16-pixel Bresenham circle test uses 16 static `jnp.roll`s of the
    whole image — no gathers; the >=9-contiguous-arc test is a rolling-window
    sum over a 16-bit ring.
  - Orientation is the intensity-centroid angle; the patch moments m10/m01
    are two depthwise convolutions evaluated densely, then read at keypoints.
  - Keypoint selection is one global top-k over the NMS'd score map —
    fixed K output with a validity mask (static shapes).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import image as image_ops

FAST_RADIUS = 3
# Bresenham circle of radius 3: 16 offsets in clockwise order
FAST_OFFSETS = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-3 + 2, -3 + 0),
    ],
    np.int32,
)
# fix last entry: proper circle is (-1,-3)
FAST_OFFSETS[15] = (-1, -3)

PATCH_RADIUS = 15  # orientation patch (31x31), like ORB
BRIEF_BITS = 256


class Keypoints(NamedTuple):
    uv: jax.Array  # (K, 2) float32 pixel coords [u, v]
    score: jax.Array  # (K,)
    angle: jax.Array  # (K,) radians
    desc: jax.Array  # (K, 8) uint32 packed 256-bit descriptors
    valid: jax.Array  # (K,) bool


def _brief_pattern(seed: int = 7) -> np.ndarray:
    """(256, 2, 2) int32 point-pair offsets (dy, dx), Gaussian sigma = patch/5,
    clipped to the 31x31 patch (original BRIEF G-II sampling)."""
    rng = np.random.default_rng(seed)
    sigma = (2 * PATCH_RADIUS + 1) / 5.0
    pts = rng.normal(scale=sigma, size=(BRIEF_BITS, 2, 2))
    return np.clip(np.round(pts), -(PATCH_RADIUS - 2), PATCH_RADIUS - 2).astype(np.int32)


BRIEF_PATTERN = _brief_pattern()


def _fast_response(gray: jax.Array, threshold: float) -> jax.Array:
    """FAST-9/16 corner response map (0 where not a corner), (..., H, W).

    ONE fused elementwise pass: each of the 16 shifted ring reads is
    consumed immediately into four accumulators — the bright/dark arc
    membership as a 16-bit mask per pixel and the two score sums. The
    >=9-consecutive test then runs on the packed masks with a log-step
    run-length trick (x &= x>>k), so nothing of shape (16, H, W) or the
    (24, H, W) cumsum of the earlier design is ever materialised: the
    whole response is a single image-sized fusion (the stacked-ring
    version moved ~2.5 GB of HBM per 16-frame chunk; this moves ~0.5 GB).
    """
    sb = jnp.zeros(gray.shape, gray.dtype)
    sd = jnp.zeros(gray.shape, gray.dtype)
    xb = jnp.zeros(gray.shape, jnp.uint32)
    xd = jnp.zeros(gray.shape, jnp.uint32)
    for i, (dx, dy) in enumerate(FAST_OFFSETS):
        r = jnp.roll(gray, (-int(dy), -int(dx)), axis=(-2, -1))
        diff = r - gray
        # where(diff > t, diff - t, 0) == max(diff - t, 0) exactly
        sb = sb + jnp.maximum(diff - threshold, 0.0)
        sd = sd + jnp.maximum(-diff - threshold, 0.0)
        xb = xb | ((diff > threshold).astype(jnp.uint32) << i)
        xd = xd | ((diff < -threshold).astype(jnp.uint32) << i)

    def runs9(x):
        x = x | (x << 16)  # duplicate the ring: circular runs visible from bits 0..15
        r2 = x & (x >> 1)   # run of >=2 starting at bit i
        r4 = r2 & (r2 >> 2)  # >=4
        r8 = r4 & (r4 >> 4)  # >=8
        r9 = r8 & (x >> 8)   # >=9
        return (r9 & jnp.uint32(0xFFFF)) != 0

    is_corner = runs9(xb) | runs9(xd)
    score = jnp.maximum(sb, sd)
    return jnp.where(is_corner, score, 0.0)


def _nms(score: jax.Array, radius: int = 1) -> jax.Array:
    """(2r+1)^2 non-max suppression, separable: max-filter rows then
    columns ((2r+1)^2-1 rolls -> 4r rolls; the square window's max
    factorises exactly)."""
    mx = score
    for d in range(1, radius + 1):
        mx = jnp.maximum(mx, jnp.maximum(
            jnp.roll(score, d, axis=-1), jnp.roll(score, -d, axis=-1)))
    m = mx
    for d in range(1, radius + 1):
        m = jnp.maximum(m, jnp.maximum(
            jnp.roll(mx, d, axis=-2), jnp.roll(mx, -d, axis=-2)))
    return jnp.where(score >= m, score, 0.0)


NUM_ANGLE_BINS = 30  # steered-BRIEF orientation discretisation (12 deg)
_P = 2 * PATCH_RADIUS + 1  # 31

# moment masks for the intensity-centroid orientation, applied to the
# gathered patch (not as dense image convs — two 961-tap convolutions per
# frame cost more than the whole detector)
_ys, _xs = np.mgrid[-PATCH_RADIUS : PATCH_RADIUS + 1, -PATCH_RADIUS : PATCH_RADIUS + 1]
_disk = (_xs**2 + _ys**2) <= PATCH_RADIUS * PATCH_RADIUS
_KX = (_xs * _disk).astype(np.float32)
_KY = (_ys * _disk).astype(np.float32)


def _build_brief_selector() -> np.ndarray:
    """(P*P, NUM_ANGLE_BINS * 512) one-hot: column (b*512 + s) reads the
    patch pixel of BRIEF tap s rotated by angle bin b. Lets the steered
    sampling run as ONE patch x selector matmul instead of
    512 data-dependent gathers per keypoint."""
    sel = np.zeros((NUM_ANGLE_BINS, BRIEF_BITS * 2, _P * _P), np.float32)
    for b in range(NUM_ANGLE_BINS):
        ang = 2.0 * np.pi * b / NUM_ANGLE_BINS
        ca, sa = np.cos(ang), np.sin(ang)
        for s in range(BRIEF_BITS):
            for pt in range(2):
                dy, dx = BRIEF_PATTERN[s, pt]
                rx = int(np.clip(np.round(ca * dx - sa * dy), -PATCH_RADIUS + 1, PATCH_RADIUS - 1))
                ry = int(np.clip(np.round(sa * dx + ca * dy), -PATCH_RADIUS + 1, PATCH_RADIUS - 1))
                sel[b, s * 2 + pt, (ry + PATCH_RADIUS) * _P + (rx + PATCH_RADIUS)] = 1.0
    return sel.reshape(NUM_ANGLE_BINS * BRIEF_BITS * 2, _P * _P).T.copy()


_BRIEF_SELECTOR = _build_brief_selector()  # (961, 30*512)

# The orientation moments m10/m01 are two more linear functionals of the
# same patch — append them as two extra columns so ONE matmul produces
# every per-keypoint reduction (taps + moments).
_BRIEF_SELECTOR_M = np.concatenate(
    [_BRIEF_SELECTOR, _KX.reshape(-1, 1), _KY.reshape(-1, 1)], axis=1
)  # (961, 30*512 + 2)

# DIFFERENCE selector: a BRIEF bit only ever consumes tap(2s+1) - tap(2s),
# so fold the subtraction into the selector (columns halve: 512 -> 256 per
# bin) and the bit becomes sign(patch @ D). Entries are {-1, 0, +1} and the
# moment masks are integers in [-15, 15], so with the patch quantised to
# int8 the whole reduction runs EXACTLY as an int8 x int8 -> int32 matmul
# (int32 accumulation makes the bit sign deterministic).
_BRIEF_DIFF_M = np.concatenate(
    [
        (_BRIEF_SELECTOR.reshape(_P * _P, NUM_ANGLE_BINS, BRIEF_BITS, 2)[..., 1]
         - _BRIEF_SELECTOR.reshape(_P * _P, NUM_ANGLE_BINS, BRIEF_BITS, 2)[..., 0]
         ).reshape(_P * _P, NUM_ANGLE_BINS * BRIEF_BITS),
        _KX.reshape(-1, 1),
        _KY.reshape(-1, 1),
    ],
    axis=1,
).astype(np.int8)  # (961, 30*256 + 2)


def _gather_patches(img: jax.Array, sx: jax.Array, sy: jax.Array) -> jax.Array:
    """(K,) int keypoint coords -> (K, 31, 31) patches. 31 row-gathers.

    Packing each pixel's 31-wide x-window into row channels turns the
    patch extraction into 31 gathers of K indices (31K total) instead of
    K*961 scalar gathers.
    """
    h, w = img.shape
    r = PATCH_RADIUS
    padded = jnp.pad(img, ((0, 0), (r, r)))
    rows = jnp.stack(
        [padded[:, i : i + w] for i in range(_P)], axis=-1
    ).reshape(h * w, _P)  # rows[v*w+u] = img[v, u-r : u+r+1]
    out = []
    for dy in range(-r, r + 1):
        idx = (sy + dy) * w + sx
        out.append(rows[idx])  # (K, 31)
    return jnp.stack(out, axis=1)  # (K, 31, 31)


@functools.partial(jax.jit, static_argnames=("max_keypoints", "nms_radius"))
def detect_and_describe(
    gray: jax.Array,  # (H, W) float in [0, 1]
    max_keypoints: int = 1000,
    threshold: float = 0.08,
    nms_radius: int = 2,
) -> Keypoints:
    """FAST-9 + intensity-centroid orientation + steered BRIEF-256."""
    h, w = gray.shape
    resp = _fast_response(gray, threshold)
    # kill the border where ring/patch sampling would wrap
    border = PATCH_RADIUS + 1
    vmask = jnp.zeros((h, w), bool).at[border : h - border, border : w - border].set(True)
    resp = jnp.where(vmask, resp, 0.0)
    resp = _nms(resp, nms_radius)

    flat = resp.reshape(-1)
    score, idx = jax.lax.top_k(flat, max_keypoints)
    vy = (idx // w).astype(jnp.float32)
    vx = (idx % w).astype(jnp.float32)
    uv = jnp.stack([vx, vy], axis=-1)
    valid = score > 0.0

    # ONE patch gather feeds both the orientation moments and the BRIEF
    # taps; the blurred image serves both (BRIEF smoothing as in ORB, and
    # orientation from the same patch — only cross-frame consistency of
    # the angle matters, which blurring preserves).
    blurred = image_ops.gaussian_blur(gray)
    sx = idx % w
    sy = idx // w
    patches = _gather_patches(blurred, sx, sy)  # (K, 31, 31)

    angle, packed = _describe_patches(patches)
    return Keypoints(uv, score, angle, packed, valid)


def _quantize_i8(x: jax.Array) -> jax.Array:
    """[0, 1] intensities -> int8 in 0..127. Clipped before the cast:
    out-of-range float->int8 conversion is platform-defined, and every
    backend must produce the same descriptor bits."""
    return jnp.clip(jnp.round(x * 127.0), -128.0, 127.0).astype(jnp.int8)


def _describe_patches(patches: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(N, 31, 31) patches -> (angle (N,), packed descriptors (N, 8)).

    Steered BRIEF + orientation moments: the patch is quantised to int8
    (7 bits of the 8-bit source image — descriptor bits are sign tests of
    tap differences, robust to 1-LSB quantisation) and ONE int8 matmul
    against the {-1,0,1} difference selector produces every bin's 256 tap
    differences AND m10/m01 (the two trailing columns), all in exact int32
    arithmetic. A one-hot bin select then picks each keypoint's quantised
    orientation — zero data-dependent gathers.
    """
    if patches.dtype == jnp.int8:  # batch path: quantised before the gather
        pq = patches.reshape(-1, _P * _P)
    else:
        pq = _quantize_i8(patches.reshape(-1, _P * _P).astype(jnp.float32))
    allred = jax.lax.dot_general(
        pq,
        jnp.asarray(_BRIEF_DIFF_M),
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )  # (N, 30*256 + 2) int32, exact
    m10 = allred[:, -2].astype(jnp.float32)
    m01 = allred[:, -1].astype(jnp.float32)
    angle = jnp.arctan2(m01, m10)
    abin = jnp.round(angle / (2.0 * np.pi / NUM_ANGLE_BINS)).astype(jnp.int32) % NUM_ANGLE_BINS
    # bf16 is sign-exact for the select: |diff| <= 512*127 has its sign (and
    # zero) preserved under bf16 rounding, and the bit is sign(diff) > 0
    diffs = allred[:, :-2].reshape(-1, NUM_ANGLE_BINS, BRIEF_BITS).astype(jnp.bfloat16)
    onehot = (abin[:, None] == jnp.arange(NUM_ANGLE_BINS)[None]).astype(jnp.bfloat16)
    sel = jnp.einsum("kbs,kb->ks", diffs, onehot,
                     preferred_element_type=jnp.float32)
    bits = sel > 0  # (N, 256)

    weights = jnp.asarray((1 << np.arange(32)).astype(np.int64) % (1 << 32), jnp.uint32)
    packed = jnp.sum(
        bits.reshape(-1, 8, 32).astype(jnp.uint32) * weights[None, None, :], axis=-1,
        dtype=jnp.uint32,
    )
    return angle, packed


def _blur5_batch(imgs: jax.Array) -> jax.Array:
    """Separable 5x5 binomial blur over (..., H, W) — batched twin of
    ops/image.gaussian_blur (same taps, same edge replication)."""
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    h, w = imgs.shape[-2], imgs.shape[-1]
    nb = imgs.ndim - 2
    p = jnp.pad(imgs, [(0, 0)] * nb + [(0, 0), (2, 2)], mode="edge")
    tmp = sum(k[i] * p[..., :, i : i + w] for i in range(5))
    p2 = jnp.pad(tmp, [(0, 0)] * nb + [(2, 2), (0, 0)], mode="edge")
    return sum(k[i] * p2[..., i : i + h, :] for i in range(5))


def _gather_patches_batch(imgs: jax.Array, sx: jax.Array, sy: jax.Array) -> jax.Array:
    """Batched patch gather: (B, H, W) images + (B, K) coords -> int8
    (B*K, 31, 31) patches, already quantised for `_describe_patches`.

    Same rows trick as `_gather_patches`, but the row table is built for the
    whole chunk and indexed with GLOBAL flat indices (frame*H*W + v*W + u):
    one table, 31 gathers of B*K indices — never a vmapped (batched)
    gather. Two further layout tricks:
      - the table is int8 (the descriptor path is an exact int8 matmul,
        so quantising BEFORE the gather moves 4x fewer bytes), and
      - four consecutive pixels' windows share one 124-wide table row
        (ROADMAP S4 asks whether this packing still pays off). The right
        31-lane block is peeled off afterwards with a 4-wide one-hot
        einsum — W is a multiple of 4, so the block id is sx % 4 for
        every row of a keypoint's patch.
    """
    b, h, w = imgs.shape
    r = PATCH_RADIUS
    q = _quantize_i8(imgs)
    padded = jnp.pad(q, ((0, 0), (0, 0), (r, r)))
    rows4 = jnp.stack(
        [padded[:, :, i : i + w] for i in range(_P)], axis=-1
    ).reshape(b * h * w // 4, 4 * _P)
    base = (jnp.arange(b, dtype=jnp.int32) * (h * w))[:, None]
    out = []
    for dy in range(-r, r + 1):
        gidx = base + (sy + dy) * w + sx  # (B, K)
        out.append(rows4[(gidx // 4).reshape(-1)])
    g4 = jnp.stack(out, axis=1).reshape(-1, _P, 4, _P).astype(jnp.bfloat16)
    onehot = ((sx % 4).reshape(-1)[:, None] == jnp.arange(4)[None]).astype(jnp.bfloat16)
    return jnp.einsum("nkfc,nf->nkc", g4, onehot).astype(jnp.int8)


@functools.partial(jax.jit, static_argnames=("max_keypoints", "nms_radius"))
def detect_and_describe_batch(
    grays: jax.Array,  # (B, H, W) float in [0, 1]
    max_keypoints: int = 1000,
    threshold: float = 0.08,
    nms_radius: int = 2,
) -> Keypoints:
    """Batched `detect_and_describe` over a chunk of frames — one program of
    chunk-wide ops instead of a sequential per-frame lax.map.

    At 640x480 every FAST/NMS/blur op touches ~1.2 MB — far below the
    kernel-latency/bandwidth crossover — so the sequential path pays ~60
    small-kernel launches PER FRAME. Batching makes each op B-fold larger
    at the same launch count. All keypoint gathers use global flat indices
    into chunk-wide tables (see `_gather_patches_batch`); nothing here is
    a vmapped gather.
    """
    b, h, w = grays.shape
    resp = _fast_response(grays, threshold)
    border = PATCH_RADIUS + 1
    vmask = jnp.zeros((h, w), bool).at[border : h - border, border : w - border].set(True)
    resp = jnp.where(vmask[None], resp, 0.0)
    # materialise: the 16-roll FAST fusion is otherwise duplicated into
    # every NMS read of `resp`
    resp = jax.lax.optimization_barrier(resp)
    resp = _nms(resp, nms_radius)

    # approx_max_k: on the GPU and the CPU it lowers to the exact top-k;
    # only backends with an approximate top-k use its ~0.95 recall target
    # (FAST corners are heavily redundant, so that would be noise)
    score, idx = jax.lax.approx_max_k(resp.reshape(b, h * w), max_keypoints)  # (B, K)
    vy = (idx // w).astype(jnp.float32)
    vx = (idx % w).astype(jnp.float32)
    uv = jnp.stack([vx, vy], axis=-1)
    valid = score > 0.0

    blurred = _blur5_batch(grays)
    patches = _gather_patches_batch(blurred, idx % w, idx // w)  # (B*K, 31, 31)
    angle, packed = _describe_patches(patches)
    return Keypoints(
        uv, score, angle.reshape(b, max_keypoints),
        packed.reshape(b, max_keypoints, 8), valid,
    )
