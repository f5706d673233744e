"""Smoke test of the three device-resident SLAM systems on an NVIDIA GPU.

    python chip_smoke.py          # one card: phases 1-5
    python chip_smoke.py --four   # four cards: only the sharded parallel/ paths

Phases, each on 640x480 synthetic frames rendered from a seed:
  1. tsdf    one frame pair through the Triton TSDF kernel
             (`ops.tsdf_triton.integrate_slots`) at kmax=8192 on a
             16384-block pool, against the plain reference
             `ops.tsdf.integrate_blocks` run on the host CPU backend.
  2. dense   `FusedDenseFusion` at its defaults: a 16-frame orbit chunk
             (ATE gate), a 100-frame closed loop in chunks of 25 with
             `maybe_grow` (finite ATE, no pool overflow), then marching cubes.
  3. sparse  `FusedFBASlam`, 16 frames (ATE gate).
  4. ba      `FusedBASlam`, 16 frames (ATE gate).
  5. icp_nn  exact 1-NN (`ops.knn.knn`) and `icp.point_to_point` on 20k x 20k
             points ~4 m from the origin, against a float64 NumPy brute force.
  --four     `__graft_entry__.dryrun_multichip(4)` with dense tracking and
             TSDF at 640x480, each sharded result against its single-device
             result; no other phase.

The ATE gates are the reference CPU implementation's own ATE on the same
synthetic sequences (BASELINE_MEASURED.json). Every phase raises on failure;
nothing is caught and there is no CPU path. Each phase prints one JSON line
of its numbers; times are host-clock seconds around work that ends in
`block_until_ready` (the first call of each shape compiles, so every timed
call is preceded by a warm-up). The last line is the device record.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W = 480, 640

# phase-1 tolerances. The GPU and the CPU reference may round a voxel's
# projection or its (depth - z) differently in the last f32 bit (FMA
# contraction, summation order), which moves it to the neighbouring pixel or
# across the truncation cutoff. Such voxels are excluded: projection within
# 1e-4 px of a rounding boundary, or (depth - z) within 1e-5 m of -truncation.
# Everywhere else weights are equal and tsdf and color agree within 1e-5.
PX_EPS = 1e-4
CUT_EPS = 1e-5
VAL_TOL = 1e-5

# phase-5 tolerances: indices equal except at ties within 1e-9 m^2 of the
# exact nearest distance; squared distances within 1e-6 m^2.
TIE_EPS = 1e-9
D2_TOL = 1e-6


def _require(ok, what="") -> None:
    """A gate of this script: raises even under `python -O`."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _emit(phase: str, **numbers) -> dict:
    print(json.dumps({"phase": phase, **numbers}), flush=True)
    return numbers


def _camera(height: int = H, width: int = W):
    from onepiece_tpu.geometry.camera import TUM_CAMERA

    cam = TUM_CAMERA
    while cam.height > height:
        cam = cam.next_pyramid_level()
    _require((cam.height, cam.width) == (height, width), (cam.height, cam.width))
    return cam


def _render(cam, poses):
    import jax
    import jax.numpy as jnp

    from onepiece_tpu.utils import synthetic

    scene = synthetic.default_scene()
    frames = [
        synthetic.render(
            scene, jnp.asarray(p), cam.fx, cam.fy, cam.cx, cam.cy,
            cam.height, cam.width, num_steps=64,
        )
        for p in poses
    ]
    depths = jnp.stack([d for d, _ in frames])
    grays = jnp.stack([g for _, g in frames])
    return jax.block_until_ready((grays, depths))


def _baseline_ate() -> dict:
    with open(os.path.join(ROOT, "BASELINE_MEASURED.json")) as f:
        b = json.load(f)
    return {
        "dense": b["ate_rmse_m_cpu"],
        "sparse": b["sparse_fba_ate_rmse_m_cpu"],
        "ba": b["ba_ate_rmse_m_cpu"],
    }


# -- phase 1: TSDF slot update -------------------------------------------------


def _unpack(keys: np.ndarray) -> np.ndarray:
    """(K,) packed keys -> (K, 3) block coords (padding keys included)."""
    return np.stack([(keys >> 20) & 1023, (keys >> 10) & 1023, keys & 1023], -1) - 512


def _voxel_centers(keys: np.ndarray, voxel_size: float) -> np.ndarray:
    """(K,) packed keys -> (K, 512, 3) float64 voxel centers (x-major)."""
    c = _unpack(keys)
    lin = np.arange(512)
    local = np.stack([lin >> 6, (lin >> 3) & 7, lin & 7], -1)
    return ((c[:, None, :] * 8 + local[None]).astype(np.float64) + 0.5) * voxel_size


def ambiguous(u, v, sdf, truncation):
    """Voxels a last-bit difference can flip: projection (u, v) within PX_EPS
    px of a rounding boundary, or sdf = depth - z within CUT_EPS of the
    -truncation cutoff."""
    near = lambda x: np.abs(x - np.floor(x) - 0.5) < PX_EPS  # noqa: E731
    return near(u) | near(v) | (np.abs(sdf + truncation) < CUT_EPS)


def _ambiguous_voxels(keys, T_cw, depth, cam, voxel_size, truncation):
    """(K, 512) bool: `ambiguous` for every voxel of the blocks `keys`."""
    pc = _voxel_centers(keys, voxel_size) @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = np.where(pc[..., 2] > 1e-6, pc[..., 2], 1.0)
    u = pc[..., 0] / z * cam.fx + cam.cx
    v = pc[..., 1] / z * cam.fy + cam.cy
    ui = np.clip(np.round(u).astype(np.int64), 0, depth.shape[1] - 1)
    vi = np.clip(np.round(v).astype(np.int64), 0, depth.shape[0] - 1)
    return ambiguous(u, v, depth[vi, ui] - pc[..., 2], truncation)


def _reference_update(pool, keys, slots, depth, color, T_cw, cam, voxel_size, truncation):
    """The plain reference `integrate_blocks` on the host CPU backend."""
    import jax

    from onepiece_tpu.ops import tsdf as tsdf_ops

    cpu = jax.devices("cpu")[0]
    put = lambda x: jax.device_put(np.asarray(x), cpu)  # noqa: E731
    rows = pool[slots]
    s, w, c = tsdf_ops.integrate_blocks(
        put(rows[:, 0]), put(rows[:, 1]), put(np.moveaxis(rows[:, 2:5], 1, -1)),
        put(_unpack(keys).astype(np.int32)),
        put(keys != int(tsdf_ops.INVALID_KEY)), put(depth), put(color), put(T_cw),
        cam.fx, cam.fy, cam.cx, cam.cy, voxel_size, truncation,
    )
    pool[slots] = np.concatenate(
        [np.asarray(s)[:, None], np.asarray(w)[:, None], np.moveaxis(np.asarray(c), -1, 1)], 1
    )


def phase_tsdf(cam=None, capacity=16384, table_size=1 << 16, kmax=8192, reps=50,
               voxel_size=0.0125, truncation=0.1, interpret=False) -> dict:
    """Two frames through the TSDF kernel vs the reference, then its time."""
    import jax
    import jax.numpy as jnp

    from onepiece_tpu.geometry import se3
    from onepiece_tpu.integration import device_hash as dh
    from onepiece_tpu.integration.blocks import make_pool
    from onepiece_tpu.ops import tsdf as tsdf_ops
    from onepiece_tpu.ops import tsdf_triton
    from onepiece_tpu.utils import synthetic

    cam = cam or _camera()
    poses = synthetic.orbit_trajectory(16)[[0, 8]]
    grays, depths = _render(cam, poses)
    frames = []
    table = dh.make_table(table_size, capacity)
    for i, T_wc in enumerate(poses):
        keys = tsdf_ops.touched_block_keys(
            depths[i], jnp.asarray(T_wc), cam.fx, cam.fy, cam.cx, cam.cy,
            voxel_size, truncation, max_blocks=kmax, stride=8,
        )
        table, slots = dh.insert(table, keys, claim_rounds=12)
        slots = jnp.where(slots < 0, capacity, slots).astype(jnp.int32)
        T_cw = np.asarray(se3.inverse_T(jnp.asarray(T_wc)), np.float32)
        frames.append((keys, slots, depths[i], grays[i][..., None], jnp.asarray(T_cw)))
    _require(int(table.overflow) == 0, "TSDF phase: hash table overflowed")

    ref = np.array(make_pool(capacity))
    ambiguous = np.zeros((capacity + 1, 512), bool)
    for keys, slots, depth, color, T_cw in frames:
        k, s = np.asarray(keys), np.asarray(slots)
        ambiguous[s] |= _ambiguous_voxels(
            k, np.asarray(T_cw, np.float64), np.asarray(depth), cam, voxel_size, truncation
        )
        _reference_update(ref, k, s, depth, color, T_cw, cam, voxel_size, truncation)
    ref, ambiguous = ref[:capacity], ambiguous[:capacity]
    updated = ref[:, 1] > 0
    _require(updated.sum() > 100_000 * (cam.width * cam.height) / (W * H),
             "TSDF phase: too few voxels updated")

    out = {
        "slots": int(np.sum(np.asarray(frames[1][0]) != int(tsdf_ops.INVALID_KEY))),
        "kmax": kmax, "updated_voxels": int(updated.sum()),
        "ambiguous_voxels": int(ambiguous.sum()),
    }
    def update(vox, f):
        return tsdf_triton.integrate_slots(
            vox, *f, cam.fx, cam.fy, cam.cx, cam.cy, voxel_size, truncation,
            interpret=interpret,
        )

    vox = make_pool(capacity)
    for f in frames:
        vox = update(vox, f)
    got = np.asarray(vox)[:capacity]
    ok = ~ambiguous
    w_diff = int(np.sum((got[:, 1] != ref[:, 1]) & ok))
    sdf_err = float(np.abs(got[:, 0] - ref[:, 0])[ok].max())
    col_err = float(np.abs(got[:, 2:5] - ref[:, 2:5]).max(1)[ok].max())
    _require(w_diff == 0, f"{w_diff} weights differ from the reference")
    _require(sdf_err <= VAL_TOL and col_err <= VAL_TOL, (sdf_err, col_err))
    # device time per frame: back-to-back in-place updates of one pool
    vox = jax.block_until_ready(update(vox, frames[1]))
    t0 = time.perf_counter()
    for _ in range(reps):
        vox = update(vox, frames[1])
    jax.block_until_ready(vox)
    out["ms_per_frame"] = (time.perf_counter() - t0) / reps * 1e3
    out["max_abs_sdf_err"] = sdf_err
    out["max_abs_color_err"] = col_err
    return _emit("tsdf", **out)


# -- phase 2: dense fusion -----------------------------------------------------


def _timed_chunk(make, grays, depths, reps):
    """Warm once, then `reps` fresh systems on the same chunk; returns the
    last system and the per-run seconds."""
    import jax

    warm = make()
    warm.process_chunk(grays, depths)
    jax.block_until_ready(warm.finalize() if hasattr(warm, "finalize") else warm.trajectory())
    secs = []
    for _ in range(reps):
        slam = make()
        t0 = time.perf_counter()
        slam.process_chunk(grays, depths)
        jax.block_until_ready(slam.finalize() if hasattr(slam, "finalize") else slam.trajectory())
        secs.append(time.perf_counter() - t0)
    return slam, secs


def phase_dense(cam=None, n_chunk=16, n_loop=100, loop_chunk=25, reps=3,
                ate_gate=None, **slam_kw) -> dict:
    import jax

    from onepiece_tpu.io import trajectory as traj
    from onepiece_tpu.systems.fused_slam import FusedDenseFusion
    from onepiece_tpu.utils import synthetic

    cam = cam or _camera()
    ate_gate = _baseline_ate()["dense"] if ate_gate is None else ate_gate
    poses = synthetic.orbit_trajectory(16)[:n_chunk]
    grays, depths = _render(cam, poses)
    slam, secs = _timed_chunk(lambda: FusedDenseFusion(cam, **slam_kw), grays, depths, reps)
    est, _ = slam.finalize()
    ate = traj.ate_rmse(est, poses)
    _require(ate <= ate_gate, f"dense ATE {ate} above the reference's {ate_gate}")
    _require(slam.overflow == 0, "dense chunk: pool overflow")

    poses_l = synthetic.loop_trajectory(100)[:n_loop]
    grays_l, depths_l = _render(cam, poses_l)
    loop = FusedDenseFusion(cam, **slam_kw)
    t0 = time.perf_counter()
    for i in range(0, n_loop, loop_chunk):
        loop.process_chunk(grays_l[i : i + loop_chunk], depths_l[i : i + loop_chunk])
        loop.maybe_grow()
    est_l, _ = loop.finalize()
    loop_s = time.perf_counter() - t0
    ate_l = traj.ate_rmse(est_l, poses_l)
    _require(np.isfinite(ate_l) and loop.overflow == 0, (ate_l, loop.overflow))

    t0 = time.perf_counter()
    verts, cols = loop.to_volume().extract_mesh()
    mesh_s = time.perf_counter() - t0
    _require(len(verts) > 0 and np.isfinite(verts).all() and np.isfinite(cols).all(),
             "mesh empty or not finite")
    jax.block_until_ready(loop._state.vox)
    return _emit(
        "dense", chunk_frames=n_chunk, chunk_fps=[n_chunk / s for s in secs],
        chunk_ate_m=ate, ate_gate_m=ate_gate, active_blocks=slam.num_active,
        loop_frames=n_loop, loop_s_incl_growth_compiles=loop_s, loop_ate_m=ate_l,
        loop_active_blocks=loop.num_active, loop_capacity=loop.capacity,
        loop_kmax=loop.kmax, mesh_triangles=len(verts), mesh_s=mesh_s,
    )


# -- phases 3 and 4: sparse and BA ----------------------------------------------


def _phase_sparse_like(name, cls, cam, n_chunk, reps, ate_gate, **slam_kw) -> dict:
    from onepiece_tpu.io import trajectory as traj
    from onepiece_tpu.utils import synthetic

    cam = cam or _camera()
    ate_gate = _baseline_ate()[name] if ate_gate is None else ate_gate
    poses = synthetic.orbit_trajectory(16)[:n_chunk]
    grays, depths = _render(cam, poses)
    slam, secs = _timed_chunk(lambda: cls(cam, **slam_kw), grays, depths, reps)
    ate = traj.ate_rmse(slam.trajectory(), poses)
    _require(ate <= ate_gate, f"{name} ATE {ate} above the reference's {ate_gate}")
    return _emit(
        name, chunk_frames=n_chunk, chunk_fps=[n_chunk / s for s in secs],
        chunk_ate_m=ate, ate_gate_m=ate_gate, keyframes=slam.num_kf,
    )


def phase_sparse(cam=None, n_chunk=16, reps=3, ate_gate=None, **slam_kw) -> dict:
    from onepiece_tpu.systems.fused_sparse import FusedFBASlam

    return _phase_sparse_like("sparse", FusedFBASlam, cam, n_chunk, reps, ate_gate, **slam_kw)


def phase_ba(cam=None, n_chunk=16, reps=3, ate_gate=None, **slam_kw) -> dict:
    from onepiece_tpu.systems.fused_ba import FusedBASlam

    return _phase_sparse_like("ba", FusedBASlam, cam, n_chunk, reps, ate_gate, **slam_kw)


# -- phase 5: ICP nearest neighbours --------------------------------------------


def _surface_cloud(n: int, rng) -> np.ndarray:
    """n points ~1 cm apart on a curved 1.4 m patch about 4 m from the origin."""
    side = int(np.ceil(np.sqrt(n)))
    g = np.arange(side) * 0.01
    x, y = (a.reshape(-1)[:n] for a in np.meshgrid(g, g))
    z = 0.1 * np.sin(12.0 * x) * np.cos(10.0 * y)  # curved enough to pin all 6 DoF
    pts = np.stack([x, y, z], -1) + rng.uniform(-0.003, 0.003, (n, 3))
    return pts + np.array([2.0, -1.5, 3.0])


def phase_icp_nn(n=20000, n_check=2000, reps=10, seed=0) -> dict:
    import jax
    import jax.numpy as jnp

    from onepiece_tpu.geometry import se3
    from onepiece_tpu.ops import knn as knn_ops
    from onepiece_tpu.registration import icp

    rng = np.random.default_rng(seed)
    ref = _surface_cloud(n, rng)
    T_true = np.asarray(se3.se3_exp(jnp.asarray([0.01, -0.008, 0.006, 0.004, -0.006, 0.003])), np.float64)
    # src = T_true^-1 applied to the surface, with 1 mm sensor noise
    src = (ref - T_true[:3, 3]) @ T_true[:3, :3] + rng.normal(0, 0.001, ref.shape)
    ref32, src32 = jnp.asarray(ref, jnp.float32), jnp.asarray(src, jnp.float32)
    valid = jnp.ones(n, bool)

    idx, d2 = jax.block_until_ready(knn_ops.knn(src32, ref32, valid, k=1))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = knn_ops.knn(src32, ref32, valid, k=1)
    jax.block_until_ready(out)
    nn_ms = (time.perf_counter() - t0) / reps * 1e3

    # exact float64 brute force on the same (f32-rounded) coordinates
    q = np.asarray(src32, np.float64)[:n_check]
    r = np.asarray(ref32, np.float64)
    idx, d2 = np.asarray(idx)[:n_check, 0], np.asarray(d2)[:n_check, 0]
    ties = idx_err = 0
    d2_err = 0.0
    for lo in range(0, n_check, 250):
        dd = ((q[lo : lo + 250, None, :] - r[None]) ** 2).sum(-1)
        best = dd.argmin(-1)
        rows = np.arange(len(best))
        mism = idx[lo : lo + 250] != best
        gap = dd[rows, idx[lo : lo + 250]] - dd[rows, best]
        ties += int(np.sum(mism & (gap <= TIE_EPS)))
        idx_err += int(np.sum(mism & (gap > TIE_EPS)))
        d2_err = max(d2_err, float(np.abs(d2[lo : lo + 250] - dd[rows, best]).max()))
    _require(idx_err == 0, f"{idx_err} nearest-neighbour indices differ from the exact answer")
    _require(d2_err <= D2_TOL, f"squared distance error {d2_err} m^2")

    res = jax.block_until_ready(icp.point_to_point(src32, valid, ref32, valid))
    t0 = time.perf_counter()
    res = jax.block_until_ready(icp.point_to_point(src32, valid, ref32, valid))
    icp_s = time.perf_counter() - t0
    T = np.asarray(res.T, np.float64)
    t_err = float(np.linalg.norm(T[:3, 3] - T_true[:3, 3]))
    r_err = float(np.linalg.norm(T[:3, :3] - T_true[:3, :3]))
    _require(t_err < 2e-3 and r_err < 2e-3, (t_err, r_err))
    return _emit(
        "icp_nn", points=n, nn_ms=nn_ms, checked=n_check, ties=ties,
        max_abs_d2_err=d2_err, icp_iters=icp.DEFAULT_ITERS, icp_s=icp_s,
        icp_t_err_m=t_err, icp_R_err=r_err, icp_rmse_m=float(res.rmse),
    )


# -- phase --four: sharded paths -------------------------------------------------


def phase_four() -> None:
    sys.path.insert(0, ROOT)
    import __graft_entry__

    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(4, height=H, width=W)
    _emit("four", devices=4, seconds_incl_compiles=time.perf_counter() - t0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded parallel/ paths, on four cards")
    opts = ap.parse_args()

    from onepiece_tpu.utils import compile_cache

    compile_cache.enable()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs an NVIDIA GPU, JAX found {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(card, flush=True)

    if opts.four:
        phase_four()
    else:
        phase_tsdf()
        phase_dense()
        phase_sparse()
        phase_ba()
        phase_icp_nn()
    devices = jax.devices()
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(devices)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
