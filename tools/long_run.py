"""Long-sequence robustness + SUSTAINED-throughput run: 200+ frames around
a CLOSED loop.

Exercises what the 16-frame bench cannot (VERDICT r2 weak #7, r3 weak #2):
sustained pool pressure with growth, keyframe-DB growth, genuine
loop-closure firing on the return leg, and pose-graph drift correction.
Runs both production systems on the same rendered sequence:

  1. FusedDenseFusion (dense VO + TSDF) in fixed-size chunks, with
     `maybe_grow` between chunks;
  2. FusedFBASlam (device-resident sparse VO + MILD LC + pose-graph).

Timing protocol (r4): executables are compiled/warmed on a throwaway
instance FIRST (the persistent compile cache makes this ~free after the
first ever run), then a fresh instance is timed over the whole sequence —
the steady-state number a production deployment would see. The wall-clock
including warmup is also recorded for honesty.

Writes LONGRUN.json (summary) and longrun_metrics.jsonl (per-chunk
metrics). Run on the GPU: `python tools/long_run.py [--frames 200]`.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--chunk", type=int, default=25)
    ap.add_argument("--out", type=str, default="LONGRUN.json")
    ap.add_argument("--metrics", type=str, default="longrun_metrics.jsonl")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from onepiece_tpu.utils import compile_cache

    compile_cache.enable()

    from onepiece_tpu.geometry.camera import TUM_CAMERA as cam
    from onepiece_tpu.io import trajectory as traj
    from onepiece_tpu.systems.fused_sparse import FusedFBASlam
    from onepiece_tpu.systems.fused_slam import FusedDenseFusion
    from onepiece_tpu.utils import synthetic

    n = args.frames
    ck = args.chunk
    scene = synthetic.default_scene()
    poses = synthetic.loop_trajectory(n)
    grays = []
    depths = []
    t0 = time.perf_counter()
    for i in range(n):
        d, g = synthetic.render(
            scene, jnp.asarray(poses[i]), cam.fx, cam.fy, cam.cx, cam.cy,
            cam.height, cam.width, num_steps=64,
        )
        grays.append(g)
        depths.append(d)
    grays = jnp.stack(grays)
    depths = jnp.stack(depths)
    jax.block_until_ready((grays, depths))
    print(f"rendered {n} frames in {time.perf_counter() - t0:.1f}s", flush=True)

    metrics = []

    # ---- 1. fused dense pipeline with pool growth --------------------------
    def run_dense(record: bool):
        slam = FusedDenseFusion(cam, capacity=8192, table_size=1 << 15)
        grew = 0
        for s in range(0, n, ck):
            slam.process_chunk(grays[s : s + ck], depths[s : s + ck])
            if slam.maybe_grow():
                grew += 1
            if record:
                metrics.append(
                    {
                        "system": "fused", "frame": min(s + ck, n),
                        "active_blocks": slam.num_active,
                        "capacity": slam.capacity, "overflow": slam.overflow,
                    }
                )
        est, rmses = slam.finalize()
        jax.block_until_ready(slam._state.vox)
        return slam, est, rmses, grew

    t0 = time.perf_counter()
    run_dense(record=False)  # warm every executable (init, K-1, K, growth)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    slam, est, rmses, grew = run_dense(record=True)
    dt = time.perf_counter() - t0
    fused_ate = float(traj.ate_rmse(est, poses))
    fused = {
        "fps": round(n / dt, 2), "ate_rmse_m": round(fused_ate, 5),
        "warmup_s": round(warm_s, 1), "steady_s": round(dt, 1),
        "active_blocks": slam.num_active, "capacity": slam.capacity,
        "pool_growths": grew, "block_overflow": slam.overflow,
        "key_saturated_frames": slam.key_saturated_frames,
        "max_rmse": round(float(np.max(rmses)), 5),
    }
    print("fused:", fused, flush=True)
    assert slam.overflow == 0, "pool overflowed despite growth"

    # ---- 2. device-resident sparse FBA with loop closure -------------------
    g_np = grays  # device arrays: FusedFBASlam takes jnp directly
    d_np = depths

    def run_sparse(record: bool):
        fba = FusedFBASlam(cam)
        for s in range(0, n, ck):
            info = fba.process_chunk(g_np[s : s + ck], d_np[s : s + ck])
            if record:
                metrics.append(
                    {
                        "system": "fba", "frame": min(s + ck, n),
                        "keyframes": fba.num_kf, "edges": fba.num_edges,
                        "lc_pairs": info["lc_pairs"],
                    }
                )
        return fba

    t0 = time.perf_counter()
    run_sparse(record=False)  # warm (capacity growth points compile here)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fba = run_sparse(record=True)
    dt = time.perf_counter() - t0
    est_fba = fba.trajectory()
    fba_ate = float(traj.ate_rmse(est_fba, poses))
    sparse = {
        "fps": round(n / dt, 2), "ate_rmse_m": round(fba_ate, 5),
        "warmup_s": round(warm_s, 1), "steady_s": round(dt, 1),
        "keyframes": fba.num_kf, "edges": fba.num_edges,
        "loop_edges": fba.lc_edges_total,
        "edge_overflow": fba.edge_overflow,
    }
    print("fba:", sparse, flush=True)
    assert fba.edge_overflow == 0, "edge store overflowed despite growth"
    # drift regression gate (VERDICT r3 weak #8): the post-optimisation
    # long-run ATE must stay at or under the reference CPU's measured
    # 22.8 mm (BASELINE_MEASURED sparse_fba_ate_rmse_m_cpu) + 20% headroom
    assert fba_ate <= 0.0228 * 1.2, f"long-run sparse drift regressed: {fba_ate}"

    with open(args.metrics, "w") as f:
        for m in metrics:
            f.write(json.dumps(m) + "\n")
    with open(args.out, "w") as f:
        json.dump({"frames": n, "fused": fused, "sparse_fba": sparse}, f, indent=1)
        f.write("\n")
    print(f"wrote {args.out} + {args.metrics}")


if __name__ == "__main__":
    main()
