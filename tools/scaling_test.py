#!/usr/bin/env python
"""Multi-device scaling validation + communication-volume report (CPU).

Runs on virtual CPU device meshes, so it checks collective correctness,
not wall-clock scaling (that needs the cards: `python chip_smoke.py --four`):

  1. runs every sharded pipeline (pixel-sharded dense tracking,
     point-sharded distributed BA, block-sharded TSDF) on virtual device
     meshes of 1/2/4/8 devices and asserts agreement of results with the
     single-device implementations;
  2. reports the per-step volume each collective moves, and its transfer
     time at the NVLink rate of one H100 (450 GB/s each way, all to all).
"""

import argparse
import sys
import os

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NVLINK_GBS = 450.0  # H100 SXM data sheet: 900 GB/s per card, 450 each way


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    args = ap.parse_args()

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = flags + f" --xla_force_host_platform_device_count={args.devices}"

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from onepiece_tpu.geometry import se3
    from onepiece_tpu.geometry.camera import PinholeCamera
    from onepiece_tpu.odometry import dense
    from onepiece_tpu.parallel import ba as pba
    from onepiece_tpu.parallel import dense as pdense
    from onepiece_tpu.parallel import tsdf as ptsdf
    from onepiece_tpu.utils import synthetic

    cam = PinholeCamera(fx=80.0, fy=80.0, cx=79.5, cy=59.5, width=160, height=120, depth_scale=1000.0)
    scene = synthetic.default_scene()
    T1 = se3.se3_exp(jnp.asarray([0.01, -0.01, 0.015, 0.01, -0.015, 0.008], jnp.float32))
    d0, g0 = synthetic.render(scene, jnp.eye(4), cam.fx, cam.fy, cam.cx, cam.cy, cam.height, cam.width)
    d1, g1 = synthetic.render(scene, T1, cam.fx, cam.fy, cam.cx, cam.cy, cam.height, cam.width)
    src = dense.preprocess_frame(g0, d0, cam)
    tgt = dense.preprocess_frame(g1, d1, cam)
    ref = dense.dense_tracking_exact(src, tgt, cam)

    all_devices = jax.devices()
    results = {}
    for n in (1, 2, 4, 8):
        if n > len(all_devices):
            break
        mesh = Mesh(np.array(all_devices[:n]), ("d",))
        res = pdense.dense_tracking_sharded(src, tgt, cam, mesh)
        results[n] = np.asarray(res.T_ts)
        pba.dryrun(mesh)
        ptsdf.dryrun(mesh, cam)
        print(f"mesh size {n}: sharded pipelines ok")

    # submap axis (SURVEY §2.10 axis 4): one submap per device, sharded
    # pipeline vs the serial run of the same stages
    from onepiece_tpu.parallel import submap as psubmap

    s, f = min(4, len(all_devices)), 3
    poses = synthetic.orbit_trajectory(s * f)
    gs, ds = [], []
    for i in range(s * f):
        d_i, g_i = synthetic.render(
            scene, jnp.asarray(poses[i]), cam.fx, cam.fy, cam.cx, cam.cy,
            cam.height, cam.width, num_steps=48,
        )
        gs.append(np.asarray(g_i))
        ds.append(np.asarray(d_i))
    gs = np.stack(gs).reshape(s, f, cam.height, cam.width)
    ds = np.stack(ds).reshape(s, f, cam.height, cam.width)
    mesh_s = Mesh(np.array(all_devices[:s]), ("d",))
    fp_ser, base_ser, _, _, _ = psubmap.submap_pipeline_serial(gs, ds, cam, cloud_capacity=512)
    fp_sh, base_sh, _, _, _ = psubmap.submap_pipeline_sharded(gs, ds, cam, mesh_s, cloud_capacity=512)
    err_sm = np.abs(fp_sh - fp_ser).max()
    print(f"submap axis ({s} submaps x {f} frames): sharded vs serial max err {err_sm:.2e}")
    assert err_sm < 1e-2
    base = results[1]
    for n, T in results.items():
        err = np.abs(T - base).max()
        print(f"  n={n}: max |T - T(n=1)| = {err:.2e}")
        assert err < 1e-5, "sharded result diverges across mesh sizes"

    # communication-volume analysis (bytes per step, independent of n)
    print("\nper-step collective volumes (bytes on the wire per device):")
    rows = [
        ("dense tracking psum (6x6+6+2 f32 per iter x 28 iters)", 28 * (36 + 6 + 2) * 4),
        ("distributed BA psum (F=100: S(F,F,6,6)+U+rhs f32)", (100 * 100 * 36 + 100 * 36 + 2 * 100 * 6) * 4),
        ("TSDF integrate (no collectives; frame broadcast once)", 640 * 480 * 4 * 4),
    ]
    for name, vol in rows:
        t_comm_us = vol / (NVLINK_GBS * 1e9) * 1e6
        print(f"  {name}: {vol / 1e6:.3f} MB -> {t_comm_us:.1f} us at {NVLINK_GBS:.0f} GB/s NVLink")


if __name__ == "__main__":
    main()
