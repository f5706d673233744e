#!/usr/bin/env python
"""Multi-process (multi-HOST path) bring-up for the distributed runtime.

The single-process tests exercise every collective on a virtual 8-device
mesh; what they cannot exercise is `jax.distributed.initialize` itself —
the coordinator handshake, cross-process device enumeration, and
collectives that actually cross a process boundary (Gloo on CPU here, the
same runtime path NCCL takes across GPU hosts; SURVEY §5 comm backend).

Launcher mode (default): spawns N worker subprocesses of this script and
verifies every one reports success.

Worker mode (--process-id given): initializes the distributed runtime,
builds the GLOBAL mesh over all processes' devices, then
  1. psum sanity over the global mesh,
  2. pixel-sharded dense tracking (parallel/dense.py) on a synthetic pair,
     checked against the single-device exact path computed locally.

Usage:  python tools/launch_distributed.py [--num-processes 2]
"""

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

OK_MARKER = "DISTRIBUTED-OK"


def worker(pid: int, nproc: int, coordinator: str) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coordinator, num_processes=nproc, process_id=pid
    )
    import jax.numpy as jnp
    import numpy as np
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    devs = np.array(jax.devices())
    assert len(devs) == nproc, f"expected {nproc} global devices, got {devs}"
    mesh = Mesh(devs, ("d",))

    # 1. cross-process psum sanity
    @lambda f: shard_map(f, mesh=mesh, in_specs=P("d"), out_specs=P())
    def total(x):
        return jax.lax.psum(jnp.sum(x), "d")[None]

    x = jnp.arange(float(len(devs) * 8)).reshape(len(devs), 8)
    got = float(total(x)[0])
    assert got == float(x.sum()), (got, float(x.sum()))
    print(f"[p{pid}] psum ok", flush=True)

    # 2. pixel-sharded dense tracking across the process boundary
    from onepiece_tpu.geometry import se3
    from onepiece_tpu.geometry.camera import PinholeCamera
    from onepiece_tpu.odometry import dense
    from onepiece_tpu.parallel import dense as pdense
    from onepiece_tpu.utils import synthetic

    h, w = 60, 80
    cam = PinholeCamera(
        fx=w / 2.0, fy=w / 2.0, cx=(w - 1) / 2.0, cy=(h - 1) / 2.0,
        width=w, height=h, depth_scale=1000.0,
    )
    scene = synthetic.default_scene()
    T1 = se3.se3_exp(jnp.asarray([0.01, -0.01, 0.015, 0.01, -0.015, 0.008]))
    d0, g0 = synthetic.render(scene, jnp.eye(4), cam.fx, cam.fy, cam.cx, cam.cy, h, w, num_steps=48)
    d1, g1 = synthetic.render(scene, T1, cam.fx, cam.fy, cam.cx, cam.cy, h, w, num_steps=48)
    src = dense.preprocess_frame(g0, d0, cam)
    tgt = dense.preprocess_frame(g1, d1, cam)
    res_sh = pdense.dense_tracking_sharded(src, tgt, cam, mesh)
    res_ref = dense.dense_tracking_exact(src, tgt, cam)
    err = float(jnp.abs(res_sh.T_ts - res_ref.T_ts).max())
    assert err < 1e-4, f"sharded-vs-exact pose mismatch {err}"
    print(f"[p{pid}] sharded dense tracking ok (max|dT|={err:.2e})", flush=True)
    print(f"[p{pid}] {OK_MARKER}", flush=True)


def launch(nproc: int, port: int) -> int:
    procs = []
    for pid in range(nproc):
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, os.path.abspath(__file__),
                    "--process-id", str(pid), "--num-processes", str(nproc),
                    "--coordinator", f"127.0.0.1:{port}",
                ],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
        )
    ok = 0
    for pid, p in enumerate(procs):
        out, _ = p.communicate(timeout=420)
        if p.returncode == 0 and OK_MARKER in out:
            ok += 1
        else:
            sys.stderr.write(f"--- worker {pid} failed (rc={p.returncode}) ---\n{out}\n")
    print(f"{ok}/{nproc} workers ok")
    return 0 if ok == nproc else 1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--process-id", type=int, default=-1)
    ap.add_argument("--coordinator", type=str, default="")
    ap.add_argument("--port", type=int, default=9377)
    args = ap.parse_args()
    if args.process_id >= 0:
        worker(args.process_id, args.num_processes, args.coordinator)
    else:
        sys.exit(launch(args.num_processes, args.port))


if __name__ == "__main__":
    main()
