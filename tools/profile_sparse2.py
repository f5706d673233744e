"""Finer attribution: extraction sub-stages + chunk-without-promotions.

Isolates (a) FAST+NMS+topk, (b) blur+patch gather, (c) BRIEF selector
matmul + packing, and (d) the fused chunk with keyframe promotion disabled
(keyframe_disparity=1e9 -> no LC stage, no pose-graph) to attribute the
'other' share of profile_sparse.py.
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from onepiece_tpu.utils import compile_cache

compile_cache.enable()

from onepiece_tpu.geometry.camera import TUM_CAMERA
from onepiece_tpu.odometry import features as feat
from onepiece_tpu.ops import image as image_ops
from onepiece_tpu.systems import fused_sparse
from onepiece_tpu.utils import synthetic


def timeit(fn, n=10, warm=2):
    for _ in range(warm):
        jax.block_until_ready(fn())
    best = None
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        d = time.perf_counter() - t0
        best = d if best is None else min(best, d)
    return best * 1e3


def main():
    cam = TUM_CAMERA
    scene = synthetic.default_scene()
    poses = synthetic.orbit_trajectory(16)
    frames = [
        synthetic.render(scene, jnp.asarray(poses[i]), cam.fx, cam.fy,
                         cam.cx, cam.cy, cam.height, cam.width, num_steps=64)
        for i in range(16)
    ]
    grays = jnp.stack([g for _, g in frames])
    depths = jnp.stack([d for d, _ in frames])
    jax.block_until_ready((grays, depths))
    g0 = grays[0]

    out = {}

    @jax.jit
    def stage_detect(g):
        resp = feat._fast_response(g, 0.01)
        h, w = g.shape
        border = feat.PATCH_RADIUS + 1
        vmask = jnp.zeros((h, w), bool).at[border:h - border, border:w - border].set(True)
        resp = jnp.where(vmask, resp, 0.0)
        resp = feat._nms(resp, 2)
        score, idx = jax.lax.top_k(resp.reshape(-1), 1000)
        return score, idx

    out["a_fast_nms_topk_ms"] = timeit(lambda: stage_detect(g0))

    score, idx = jax.device_get(stage_detect(g0))
    idxd = jnp.asarray(idx)

    @jax.jit
    def stage_patches(g, idx):
        w = g.shape[1]
        blurred = image_ops.gaussian_blur(g)
        return feat._gather_patches(blurred, idx % w, idx // w)

    out["b_blur_gather_ms"] = timeit(lambda: stage_patches(g0, idxd))
    patches = stage_patches(g0, idxd)

    @jax.jit
    def stage_brief(patches):
        import numpy as np
        m10 = jnp.einsum("kij,ij->k", patches, jnp.asarray(feat._KX))
        m01 = jnp.einsum("kij,ij->k", patches, jnp.asarray(feat._KY))
        angle = jnp.arctan2(m01, m10)
        abin = jnp.round(angle / (2.0 * np.pi / feat.NUM_ANGLE_BINS)).astype(jnp.int32) % feat.NUM_ANGLE_BINS
        taps_all = jax.lax.dot_general(
            patches.reshape(-1, feat._P * feat._P), jnp.asarray(feat._BRIEF_SELECTOR),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        ).reshape(-1, feat.NUM_ANGLE_BINS, feat.BRIEF_BITS * 2)
        onehot = (abin[:, None] == jnp.arange(feat.NUM_ANGLE_BINS)[None]).astype(jnp.float32)
        samples = jnp.einsum("kbs,kb->ks", taps_all, onehot).reshape(-1, feat.BRIEF_BITS, 2)
        bits = samples[..., 0] < samples[..., 1]
        weights = jnp.asarray(((1 << np.arange(32)) % (1 << 32)).astype(np.int64), jnp.uint32)
        return jnp.sum(bits.reshape(-1, 8, 32).astype(jnp.uint32) * weights[None, None, :],
                       axis=-1, dtype=jnp.uint32)

    out["c_brief_ms"] = timeit(lambda: stage_brief(patches))

    # (d) chunk with promotions disabled: no LC loops, GN cond False
    def chunk_noprom():
        s = fused_sparse.FusedFBASlam(cam, keyframe_disparity=1e9)
        s.process_chunk(grays, depths)
        return s

    chunk_noprom()
    best = None
    for _ in range(5):
        t0 = time.perf_counter()
        chunk_noprom()
        d = time.perf_counter() - t0
        best = d if best is None else min(best, d)
    out["d_chunk_noprom_ms"] = best * 1e3

    def chunk_full():
        s = fused_sparse.FusedFBASlam(cam)
        s.process_chunk(grays, depths)
        return s

    chunk_full()
    best = None
    for _ in range(5):
        t0 = time.perf_counter()
        s = chunk_full()
        d = time.perf_counter() - t0
        best = d if best is None else min(best, d)
    out["e_chunk_full_ms"] = best * 1e3
    out["num_kf"] = s.num_kf
    out["lc_plus_gn_ms"] = round(out["e_chunk_full_ms"] - out["d_chunk_noprom_ms"], 2)
    print(json.dumps({k: (round(v, 3) if isinstance(v, float) else v)
                      for k, v in out.items()}))


if __name__ == "__main__":
    main()
