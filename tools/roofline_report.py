#!/usr/bin/env python
"""Roofline analysis of the hot kernels on the attached GPU.

BASELINE.md requires per-device rooflines for the dense-odometry/ICP and
TSDF kernels. Every kernel is timed AMORTISED inside a jitted `lax.scan` of
N iterations — one dispatch for the whole loop, so per-iteration numbers
reflect on-device steady state and not dispatch overhead. Hoisting is defeated by alternating each iteration between
two input variants selected by the loop counter, and where natural the
kernel's own output is the next iteration's input (tracking pose chain,
TSDF pool, hash table).

Output: per-kernel achieved FLOP/s + HBM bandwidth vs the chip roofs, and
a PRODUCTION FRAME BUDGET — the measured per-stage cost of the fused dense
frame step, which is what optimisation decisions should read.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Published peaks by `device_kind` (NVIDIA H100 SXM data sheet, dense
# rates without sparsity, at the 700 W power limit). A device that is not
# in the table is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbs": 3350.0, "f32_tflops": 67.0, "bf16_tflops": 989.0},
}


def peaks_for(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {device_kind!r}")
    return PEAKS[device_kind]


def make_scan_bench(n_iter=150):
    import jax
    import jax.numpy as jnp

    def bench(fn, *variants):
        """Amortised per-call seconds for fn(variant) over a scanned loop.

        variants: one or two tuples of args; with two, iterations alternate
        (defeats loop-invariant hoisting of the body)."""
        if len(variants) == 1:
            variants = (variants[0], variants[0])
        a, b = variants

        @jax.jit
        def scanned(a, b):
            def body(c, i):
                args = jax.tree.map(
                    lambda x, y: jnp.where((i % 2) == 0, x, y), a, b
                )
                r = fn(*args)
                s = sum(
                    jnp.sum(jnp.asarray(l, jnp.float32).ravel()[:1])
                    for l in jax.tree.leaves(r)
                )
                return c + s, None
            out, _ = jax.lax.scan(
                body, jnp.float32(0.0), jnp.arange(n_iter)
            )
            return out

        r = scanned(a, b)
        np.asarray(r)
        t0 = time.perf_counter()
        r = scanned(a, b)
        np.asarray(r)
        return (time.perf_counter() - t0) / n_iter

    def bench_carried(step, init, n=n_iter):
        """Amortised seconds when the kernel's output IS the next input
        (pose chains, pool updates) — the realistic steady-state shape."""
        import jax

        import jax.numpy as jnp

        @jax.jit
        def scanned(init):
            def body(c, _):
                return step(c), None
            out, _ = jax.lax.scan(body, init, None, length=n)
            # tiny probe: fetching a 100+ MB carry would swamp the measurement
            return jnp.sum(jax.tree.leaves(out)[0].ravel()[:1].astype(jnp.float32))

        r = scanned(init)
        np.asarray(r)
        t0 = time.perf_counter()
        r = scanned(init)
        np.asarray(r)
        return (time.perf_counter() - t0) / n

    return bench, bench_carried


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from onepiece_tpu.utils import compile_cache

    compile_cache.enable()

    from onepiece_tpu.geometry.camera import TUM_CAMERA
    from onepiece_tpu.integration import device_hash as dh
    from onepiece_tpu.odometry import dense, sparse
    from onepiece_tpu.ops import tsdf as tsdf_ops
    from onepiece_tpu.ops import tsdf_triton
    from onepiece_tpu.integration.blocks import make_pool
    from onepiece_tpu.ops.image import bilateral_filter
    from onepiece_tpu.registration import icp
    from onepiece_tpu.utils import synthetic

    cam = TUM_CAMERA
    h, w = cam.height, cam.width
    npx = h * w
    dev = jax.devices()[0]
    peak = peaks_for(dev.device_kind)
    rows = []
    bench, bench_carried = make_scan_bench()

    def report(name, seconds, flops, bytes_moved):
        ai = flops / max(bytes_moved, 1)
        gflops = flops / seconds / 1e9
        gbs = bytes_moved / seconds / 1e9
        rows.append(
            {
                "kernel": name,
                "time_ms": round(seconds * 1e3, 3),
                "gflop_per_s": round(gflops, 1),
                "hbm_gb_per_s": round(gbs, 1),
                "arith_intensity": round(ai, 2),
                "pct_hbm_roof": round(100 * gbs / peak["hbm_gbs"], 1),
                "pct_f32_roof": round(100 * gflops / (peak["f32_tflops"] * 1e3), 1),
            }
        )

    scene = synthetic.default_scene()
    poses = synthetic.orbit_trajectory(3)
    d0, g0 = synthetic.render(scene, jnp.eye(4), cam.fx, cam.fy, cam.cx, cam.cy, h, w, num_steps=64)
    d1, g1 = synthetic.render(scene, jnp.asarray(poses[1]), cam.fx, cam.fy, cam.cx, cam.cy, h, w, num_steps=64)
    p0 = dense.preprocess_frame(g0, d0, cam)
    p1 = dense.preprocess_frame(g1, d1, cam)
    jax.block_until_ready((p0, p1))
    budget = {}

    # --- preprocess: pyramids + XYZ backprojection ------------------------
    t = bench(
        lambda g, d: dense.preprocess_frame(g, d, cam), (g0, d0), (g1, d1)
    )
    budget["preprocess_frame"] = t
    # traffic: gray+depth in, 3-level gray/depth/xyz pyramids out (~7 px-planes)
    report("preprocess_frame (640x480)", t, npx * 120, npx * 4 * (2 + 7))

    # --- dense tracking: full multiscale GN, pose-chained -----------------
    def track_step(T):
        return dense.dense_tracking(p0, p1, cam, init_T=T, radii=(4, 3, 2)).T_ts

    t = bench_carried(track_step, jnp.eye(4))
    budget["dense_tracking"] = t
    iters_px = 4 * npx + 8 * npx / 4 + 16 * npx / 16
    setup_px = npx * (1 + 1 / 4 + 1 / 16)
    flops = iters_px * (81 * 2 * 7 + 90) + setup_px * 28 * 6
    bytes_moved = iters_px * 26 * 4 + setup_px * 28 * 4 * 2
    report("dense_tracking (multiscale GN, 640x480)", t, flops, bytes_moved)

    # --- bilateral depth filter ------------------------------------------
    t = bench(bilateral_filter, (d0,), (d1,))
    budget["bilateral_filter"] = t
    report("bilateral_filter (640x480)", t, npx * 49 * 6, npx * 4 * 2)

    # --- touched-key extraction ------------------------------------------
    def keys_of(d, T):
        return tsdf_ops.touched_block_keys(
            d, T, cam.fx, cam.fy, cam.cx, cam.cy, 0.0125, 0.1,
            max_blocks=4096, stride=8,
        )

    t = bench(keys_of, (d0, jnp.eye(4)), (d1, jnp.asarray(poses[1], jnp.float32)))
    budget["touched_block_keys"] = t
    ns = (h // 8) * (w // 8) * 5
    report("touched_block_keys (stride 8 + unique)", t, ns * 40, ns * 4 * 6)

    # --- hash insert, steady state (all keys resolve in the lookup) -------
    keys0 = keys_of(d0, jnp.eye(4))
    keys1 = keys_of(d1, jnp.asarray(poses[1], jnp.float32))
    table = dh.make_table(1 << 16, 16384)
    table, _ = dh.insert(table, keys0, claim_rounds=12)
    table, _ = dh.insert(table, keys1, claim_rounds=12)
    jax.block_until_ready(table)

    def ins_step(tbl):
        tbl1, _ = dh.insert(tbl, keys0, claim_rounds=2)
        tbl2, _ = dh.insert(tbl1, keys1, claim_rounds=2)
        return tbl2

    t = bench_carried(ins_step, table) / 2.0
    budget["hash_insert"] = t
    report("device_hash.insert (steady, 4096 keys)", t, 4096 * 40, 4096 * 16 * 4 * 2)

    # --- TSDF integrate: production slot update, pool-carried --------------
    tbl_tmp = dh.make_table(1 << 16, 16384)
    _, slots0 = dh.insert(tbl_tmp, keys0, claim_rounds=12)
    slots0 = jnp.where(slots0 < 0, 16384, slots0).astype(jnp.int32)

    def integ_step(vox):
        return tsdf_triton.integrate_slots(
            vox, keys0, slots0, d0, g0[..., None], jnp.eye(4),
            cam.fx, cam.fy, cam.cx, cam.cy, 0.0125, 0.1,
        )

    t = bench_carried(integ_step, make_pool(16384))
    budget["tsdf_integrate"] = t
    nblocks = int(jnp.sum(keys0 != (1 << 30)))
    tsdf_flops = nblocks * 512 * 60  # projection + update per voxel
    report(
        f"tsdf_integrate ({nblocks} blocks)", t, tsdf_flops,
        nblocks * 512 * (5 * 4 * 2 + 2 * 4),  # pool rows in+out, 2 pixel reads
    )

    # --- sparse pipeline kernels ------------------------------------------
    f0 = sparse.extract_sparse_frame(g0, d0, cam, 1000, 0.01)
    f1 = sparse.extract_sparse_frame(g1, d1, cam, 1000, 0.01)
    jax.block_until_ready((f0, f1))
    t = bench(
        lambda g, d: sparse.extract_sparse_frame(g, d, cam, 1000, 0.01),
        (g0, d0), (g1, d1),
    )
    budget_sparse = {"feature_extract": t}
    report("sparse feature extract (FAST+BRIEF, 1k kp)", t, npx * 200, npx * 4 * 4)

    key = jax.random.PRNGKey(0)

    def track_sp(k):
        r, s = sparse._track_summary_inner(k, f0, f1, cam, 256)
        # fold the (tiny) pose into the key so the body cannot be DCE'd
        return jax.random.fold_in(
            k, jnp.asarray(s.T_ts[0, 3] * 1e-6, jnp.int32) + 1
        )

    t = bench_carried(track_sp, key)
    budget_sparse["sparse_track"] = t
    # hamming 1000x1000x256bit dominates FLOPs-wise
    report("sparse track (match+RanSaPC+RANSACx256)", t, 2 * 1000 * 1000 * 256 * 2, 2 * 1000 * 1000 * 4)

    # --- ICP (brute-force 1-NN) -------------------------------------------
    rng = np.random.default_rng(0)
    pts = jnp.asarray(rng.normal(size=(20000, 3)), jnp.float32)
    valid = jnp.ones((20000,), bool)

    def icp_step(p):
        r = icp.point_to_point(p, valid, pts, valid, threshold=0.5, iters=5)
        return p + 0.0 * r.T[0, 3]

    t = bench_carried(icp_step, pts, n=12)
    # bytes: the distance block is fused into the argmin, so memory sees
    # only the point arrays per tile pass; the kernel is bound by the f32
    # distance + running-min arithmetic
    n_tiles = 20000 // 2048 + 1
    report(
        "icp point_to_point (20k pts, 5 iters)", t,
        5 * 20000 * 20000 * 8, 5 * n_tiles * 2 * 20000 * 3 * 4,
    )

    # --- production fused frame step (the number that matters) ------------
    from onepiece_tpu.systems import fused_slam as fs

    state = fs.fused_init_step(
        g0, d0, None, cam, 0.0125, 0.1, capacity=16384, table_size=1 << 16
    )
    state = state._replace(T_w=jnp.eye(4), rel=jnp.eye(4))
    grays2 = jnp.stack([g0, g1])
    depths2 = jnp.stack([d0, d1])
    n_rep = 50
    gg = jnp.tile(grays2, (n_rep, 1, 1))
    dd = jnp.tile(depths2, (n_rep, 1, 1))
    st2, _ = fs.fused_chunk_step(
        state, gg, dd, None, cam, 0.0125, 0.1, radii=(4, 3, 2)
    )
    jax.block_until_ready(st2.vox)
    state2 = st2
    t0 = time.perf_counter()
    state3, _ = fs.fused_chunk_step(
        state2, gg, dd, None, cam, 0.0125, 0.1, radii=(4, 3, 2)
    )
    np.asarray(state3.T_w).ravel()[:1]
    t = (time.perf_counter() - t0) / (2 * n_rep)
    budget["fused_frame_step_total"] = t
    sum_stages = sum(
        budget[k] for k in (
            "preprocess_frame", "dense_tracking", "bilateral_filter",
            "touched_block_keys", "hash_insert", "tsdf_integrate",
        )
    )
    report(
        "fused_frame_step (track+alloc+fuse, scanned)", t,
        flops + tsdf_flops,
        bytes_moved + nblocks * 512 * 5 * 4 * 2,
    )

    frame_budget = [
        {
            "stage": k,
            "ms": round(v * 1e3, 2),
            "pct_of_frame": round(100 * v / budget["fused_frame_step_total"], 1),
        }
        for k, v in budget.items()
    ]
    frame_budget.append(
        {"stage": "stage_sum_vs_total", "ms": round(sum_stages * 1e3, 2),
         "pct_of_frame": round(100 * sum_stages / budget["fused_frame_step_total"], 1)}
    )
    sparse_budget = [
        {"stage": k, "ms": round(v * 1e3, 2)} for k, v in budget_sparse.items()
    ]

    out = {
        "device": {"platform": dev.platform, "kind": dev.device_kind},
        "peaks": peak,
        "notes": (
            "All rows are scan-amortised: each kernel runs 150+ iterations "
            "inside one jitted lax.scan (alternating inputs / carried "
            "outputs defeat hoisting). FLOP/byte models are analytic "
            "estimates per kernel; f32 roof = non-tensor-core f32 peak. "
            "frame_budget is the measured per-stage cost of the production "
            "fused dense step."
        ),
        "kernels": rows,
        "frame_budget": frame_budget,
        "sparse_stage_budget": sparse_budget,
    }
    if args.json:
        print(json.dumps(out))
    else:
        print(f"device: {dev.device_kind}; HBM roof {peak['hbm_gbs']} GB/s; "
              f"f32 {peak['f32_tflops']} TF/s")
        for r in rows:
            print(
                f"{r['kernel']:48s} {r['time_ms']:8.2f} ms  "
                f"{r['gflop_per_s']:9.1f} GF/s  {r['hbm_gb_per_s']:7.1f} GB/s  "
                f"AI {r['arith_intensity']:7.2f}  {r['pct_hbm_roof']:5.1f}% HBM "
                f"{r['pct_f32_roof']:5.1f}% f32"
            )
        print("\nproduction frame budget (fused dense step):")
        for s in frame_budget:
            print(f"  {s['stage']:28s} {s['ms']:7.2f} ms  {s['pct_of_frame']:5.1f}%")
        for s in sparse_budget:
            print(f"  [sparse] {s['stage']:20s} {s['ms']:7.2f} ms")


if __name__ == "__main__":
    main()
