"""Per-stage wall-clock profile of the fused SLAM frame step on the device.

Times each sub-stage of `systems.fused_slam.fused_frame_step` as its own
jitted program (so per-stage dispatch overhead is included once each), then
the fully fused step, to locate where the per-frame milliseconds go.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from onepiece_tpu.geometry import se3
from onepiece_tpu.geometry.camera import TUM_CAMERA
from onepiece_tpu.integration import device_hash as dh
from onepiece_tpu.integration.blocks import make_pool
from onepiece_tpu.odometry import dense
from onepiece_tpu.ops import tsdf as tsdf_ops
from onepiece_tpu.ops import tsdf_triton
from onepiece_tpu.ops.image import bilateral_filter
from onepiece_tpu.systems.fused_slam import FusedDenseFusion, fused_frame_step
from onepiece_tpu.utils import synthetic


def timeit(name, fn, *args, n=10, **kw):
    fn(*args, **kw)  # compile
    jax.block_until_ready(fn(*args, **kw))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args, **kw)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n * 1e3
    print(f"{name:40s} {dt:8.2f} ms")
    return dt


def main():
    cam = TUM_CAMERA
    scene = synthetic.default_scene()
    poses = synthetic.orbit_trajectory(4)
    d0, g0 = synthetic.render(scene, jnp.asarray(poses[0]), cam.fx, cam.fy,
                              cam.cx, cam.cy, cam.height, cam.width, num_steps=64)
    d1, g1 = synthetic.render(scene, jnp.asarray(poses[1]), cam.fx, cam.fy,
                              cam.cx, cam.cy, cam.height, cam.width, num_steps=64)
    jax.block_until_ready((d0, g0, d1, g1))
    print(f"devices: {jax.devices()}")

    RADII = (4, 3, 2)
    ITERS = dense.DEFAULT_ITERS
    print(f"iters={ITERS} radii={RADII}")

    # stage 1: preprocess
    pre = jax.jit(lambda g, d: dense.preprocess_frame(g, d, cam))
    timeit("preprocess_frame", pre, g1, d1)
    pyr0 = pre(g0, d0)
    pyr1 = pre(g1, d1)

    # stage 2: tracking
    track = jax.jit(lambda a, b: dense.dense_tracking(
        a, b, cam, init_T=jnp.eye(4), iters=ITERS, radii=RADII))
    timeit("dense_tracking", track, pyr0, pyr1)
    res = track(pyr0, pyr1)
    T_w = se3.inverse_T(res.T_ts)

    # stage 3: bilateral
    timeit("bilateral_filter", jax.jit(bilateral_filter), d1)
    d_f = jax.jit(bilateral_filter)(d1)

    # stage 4: touched keys
    kmax, stride = 4096, 6
    keys_fn = jax.jit(lambda d, T: tsdf_ops.touched_block_keys(
        d, T, cam.fx, cam.fy, cam.cx, cam.cy, 0.0125, 0.1,
        max_blocks=kmax, stride=stride))
    timeit("touched_block_keys", keys_fn, d_f, T_w)
    keys = keys_fn(d_f, T_w)

    # stage 5: hash insert (steady state: 1 claim round)
    table = dh.make_table(1 << 16, 16384)
    table, slots = dh.insert(table, keys, claim_rounds=12)

    ins = jax.jit(lambda t, k: dh.insert(t, k, claim_rounds=1))
    timeit("dh.insert (1 round, warm table)", ins, table, keys)
    _, slots = ins(table, keys)

    # stage 6: TSDF slot update of the pool
    cap = 16384
    slots_safe = jnp.where(slots < 0, cap, slots).astype(jnp.int32)
    T_cw = se3.inverse_T(T_w)

    def integ(v, k, s, d, g, t):
        return tsdf_triton.integrate_slots(
            v, k, s, d, g[..., None], t, cam.fx, cam.fy, cam.cx, cam.cy, 0.0125, 0.1)
    timeit("tsdf_triton.integrate_slots (k=4096)", jax.jit(integ), make_pool(cap), keys,
           slots_safe, d_f, g1, T_cw)

    # full fused step for comparison
    slam = FusedDenseFusion(cam, radii=RADII)
    slam.process_frame(g0, d0)
    st = slam._state

    def step(st, g, d):
        return fused_frame_step(
            st, g, d, None, cam, 0.0125, 0.1, 4096, 6,
            iters=ITERS, radii=RADII)

    # state is DONATED: thread it through every call (never reuse a donated
    # buffer), timing from a steady-state snapshot
    st, _ = step(st, g1, d1)  # compile + first step
    ns = 10
    jax.block_until_ready(st.vox)
    t0 = time.perf_counter()
    for _ in range(ns):
        st, out = step(st, g1, d1)
    jax.block_until_ready(st.vox)
    print(f"{'fused_frame_step (steady)':40s} {(time.perf_counter()-t0)/ns*1e3:8.2f} ms")


if __name__ == "__main__":
    main()
