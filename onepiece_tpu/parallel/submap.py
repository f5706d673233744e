"""Submap-parallel DenseSlam (SURVEY §2.10 axis 4).

The reference's DenseFusion groups frames into 50-frame submaps that are
independent until registration (ref: example/DenseFusion/DenseSlam.h:123,
DenseSlam.cpp:38-125): within a submap only frame-to-frame dense VO runs;
across submaps only the fused/downsampled clouds interact (consecutive ICP
+ all-older RANSAC + pose-graph solve). That makes the submap axis the
natural multi-device scaling dimension for offline/recorded sequences:

  stage 1 (sharded)    per-device dense VO over its own submap's frames,
                       plus the boundary pair (previous submap's last
                       frame, resident locally) — no collectives.
  stage 2 (replicated) chain submap base poses from the all-gathered
                       (S, 4, 4) boundary steps (64 floats/submap).
  stage 3 (sharded)    fuse every CLOUD_STRIDE-th frame's cloud in
                       submap-base coords, voxel-downsample, fixed-size
                       compact, normals + FPFH — all local.
  stage 4 (sharded)    consecutive-submap ICP with the previous submap's
                       cloud fetched by `lax.ppermute`; loop-closure
                       FPFH-RANSAC + refine ICP of THIS submap against all
                       older submaps from one `all_gather` of the (small)
                       downsampled clouds — each device owns its submap's
                       pairs, so pair work is evenly distributed.
  stage 5 (replicated) pose-graph GN over the S base poses (tiny: S 6-dof
                       poses; every device/host solves the identical
                       gathered system).

`submap_pipeline_serial` runs the exact same stage functions sequentially
on one device — the sharded path must reproduce it (see
tests/test_parallel.py::test_submap_parallel_matches_serial). Both paths
are jitted: the sharded body compiles once as one SPMD program and each
serial stage once for all submaps (run eagerly, every primitive would be
compiled and dispatched on its own, which on a GPU costs minutes).
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..geometry import se3
from ..geometry.camera import PinholeCamera
from ..geometry.pointcloud import PointCloud, estimate_normals, voxel_downsample
from ..odometry import dense
from ..optimization import posegraph
from ..registration import fpfh as fpfh_mod
from ..registration import global_reg, icp

CLOUD_STRIDE = 3  # ref: DenseSlam.h:19-33 (every 3rd frame fused)
ICP_MIN_INLIERS = 50  # ref: DenseSlam.cpp ICP accept gate
LOOP_MIN_INLIERS = 100  # ref: DenseSlam.cpp refine accept gate
MAX_EDGE_CORRS = 512


class SubmapTrack(NamedTuple):
    rel: jax.Array  # (F, 4, 4) T_base_frame within the submap (rel[0]=I)
    step: jax.Array  # (4, 4) inv(T_ts) of the boundary pair (I for submap 0)
    rmse: jax.Array  # (F,)


class SubmapGeometry(NamedTuple):
    points: jax.Array  # (P, 3) downsampled cloud in submap-base coords
    normals: jax.Array  # (P, 3)
    valid: jax.Array  # (P,)
    fpfh: jax.Array  # (P, 33)


class SubmapEdges(NamedTuple):
    """Fixed-shape per-submap edge buffers (E = 1 + max_loops slots)."""

    dst: jax.Array  # (E,) destination submap (-1 invalid)
    T: jax.Array  # (E, 4, 4) src-submap -> dst-submap
    valid: jax.Array  # (E,)


# ---------------------------------------------------------------------------
# stage functions — shared verbatim by the serial and sharded paths
# ---------------------------------------------------------------------------


def track_one_submap(
    grays: jax.Array,  # (F, H, W)
    depths: jax.Array,  # (F, H, W)
    prev_gray: jax.Array,  # (H, W) last frame of the previous submap
    prev_depth: jax.Array,
    has_prev: jax.Array,  # () bool
    camera: PinholeCamera,
    iters: tuple[int, ...] = dense.DEFAULT_ITERS,
    radii: tuple[int, ...] = (4, 3, 2),
) -> SubmapTrack:
    """Dense VO within one submap + the boundary pair (identity init, as
    the serial DenseSlam does; ref DenseSlam.cpp:22)."""
    pyr0 = dense.preprocess_frame(grays[0], depths[0], camera)
    prev_pyr = dense.preprocess_frame(prev_gray, prev_depth, camera)
    res_b = dense.dense_tracking(prev_pyr, pyr0, camera, iters=iters, radii=radii)
    step = jnp.where(has_prev, se3.inverse_T(res_b.T_ts), jnp.eye(4))

    def body(carry, frame):
        prev, T_acc = carry
        g, d = frame
        pyr = dense.preprocess_frame(g, d, camera)
        res = dense.dense_tracking(prev, pyr, camera, iters=iters, radii=radii)
        T_acc = T_acc @ se3.inverse_T(res.T_ts)
        return (pyr, T_acc), (T_acc, res.rmse)

    (_, _), (rels, rmses) = jax.lax.scan(
        body, (pyr0, jnp.eye(4)), (grays[1:], depths[1:])
    )
    rel = jnp.concatenate([jnp.eye(4)[None], rels], axis=0)
    rmse = jnp.concatenate([jnp.zeros((1,)), rmses])
    return SubmapTrack(rel, step, rmse)


def chain_base_poses(rel_last: jax.Array, steps: jax.Array) -> jax.Array:
    """(S, 4, 4) world-from-submap-base poses from the boundary chain:
    T_base[s] = T_base[s-1] @ rel_last[s-1] @ steps[s]."""
    s = rel_last.shape[0]

    def body(T, x):
        rl_prev, st = x
        T = T @ rl_prev @ st
        return T, T

    _, rest = jax.lax.scan(body, jnp.eye(4), (rel_last[:-1], steps[1:]))
    return jnp.concatenate([jnp.eye(4)[None], rest], axis=0)


def build_submap_geometry(
    grays: jax.Array,
    depths: jax.Array,
    track: SubmapTrack,
    camera: PinholeCamera,
    voxel_size: float,
    capacity: int,
    params: global_reg.RansacParams,
) -> SubmapGeometry:
    """Fused + downsampled + feature-extracted submap model
    (ref DenseSlam.h:19-33 GenerateSubmapModel + DenseSlam.cpp:75)."""
    f = grays.shape[0]
    pts_all = []
    val_all = []
    for i in range(0, f, CLOUD_STRIDE):
        cloud = PointCloud.from_rgbd(
            depths[i], None, camera,
            depth_min=dense.MIN_DEPTH, depth_max=dense.MAX_DEPTH,
        )
        T = track.rel[i]
        pts_all.append(cloud.points @ T[:3, :3].T + T[:3, 3])
        val_all.append(cloud.valid)
    pts = jnp.concatenate(pts_all)
    val = jnp.concatenate(val_all)
    fused = PointCloud(pts, jnp.zeros_like(pts), jnp.zeros_like(pts), val)
    ds = voxel_downsample(fused, voxel_size)
    # fixed-size compaction (kNN/FPFH cost scales with capacity)
    (idx,) = jnp.nonzero(ds.valid, size=capacity, fill_value=ds.points.shape[0] - 1)
    keep_ok = jnp.arange(capacity) < jnp.sum(ds.valid.astype(jnp.int32))
    cpts = ds.points[idx]
    cval = ds.valid[idx] & keep_ok
    comp = PointCloud(cpts, jnp.zeros_like(cpts), jnp.zeros_like(cpts), cval)
    nn = estimate_normals(comp, k=params.normal_k)
    feats = fpfh_mod.compute_fpfh(
        nn.points, nn.normals, nn.valid, radius=params.fpfh_radius, k=params.fpfh_k
    )
    return SubmapGeometry(nn.points, nn.normals, nn.valid, feats)


def register_one_submap(
    sm_idx: jax.Array,  # () int32 — this submap's index
    geo: SubmapGeometry,  # this submap
    prev_geo: SubmapGeometry,  # submap sm_idx-1 (junk for sm_idx 0)
    all_geo: SubmapGeometry,  # (S, ...) all submaps (gathered)
    base_poses: jax.Array,  # (S, 4, 4) odometry-chained base poses
    icp_threshold: float,
    params: global_reg.RansacParams,
    max_loops: int,
) -> SubmapEdges:
    """Consecutive ICP + all-older loop registration for ONE submap
    (ref DenseSlam.cpp:87-115), fixed shapes + masks."""
    s_total = all_geo.points.shape[0]
    e = 1 + max_loops
    dst = jnp.full((e,), -1, jnp.int32)
    ts = jnp.tile(jnp.eye(4)[None], (e, 1, 1))
    ok = jnp.zeros((e,), bool)

    # consecutive ICP, init from the odometry chain
    prev_T = base_poses[jnp.maximum(sm_idx - 1, 0)]
    cur_T = base_poses[sm_idx]
    init = se3.inverse_T(prev_T) @ cur_T
    res = icp.point_to_point(
        geo.points, geo.valid, prev_geo.points, prev_geo.valid,
        init_T=init, threshold=icp_threshold,
    )
    cons_ok = (
        (sm_idx > 0)
        & jnp.isfinite(res.rmse)
        & (res.num_inliers > ICP_MIN_INLIERS)
        & jnp.all(jnp.isfinite(res.T))
    )
    dst = dst.at[0].set(jnp.where(cons_ok, sm_idx - 1, -1))
    ts = ts.at[0].set(jnp.where(cons_ok, res.T, jnp.eye(4)))
    ok = ok.at[0].set(cons_ok)

    # loop closures vs older submaps (ref :106-115): slot l targets submap l
    for l in range(max_loops):
        older_geo = jax.tree.map(lambda a: a[l], all_geo)
        feats_src = global_reg.CloudFeatures(geo.points, geo.normals, geo.valid, geo.fpfh)
        feats_dst = global_reg.CloudFeatures(
            older_geo.points, older_geo.normals, older_geo.valid, older_geo.fpfh
        )
        reg = global_reg.register(feats_src, feats_dst, params)
        refined = icp.point_to_point(
            geo.points, geo.valid, older_geo.points, older_geo.valid,
            init_T=reg.T, threshold=icp_threshold,
        )
        loop_ok = (
            (l < sm_idx - 1)
            & reg.success
            & (refined.num_inliers > LOOP_MIN_INLIERS)
            & jnp.all(jnp.isfinite(refined.T))
        )
        dst = dst.at[1 + l].set(jnp.where(loop_ok, l, -1))
        ts = ts.at[1 + l].set(jnp.where(loop_ok, refined.T, jnp.eye(4)))
        ok = ok.at[1 + l].set(loop_ok)
    del s_total
    return SubmapEdges(dst, ts, ok)


def solve_pose_graph(
    base_poses: np.ndarray,  # (S, 4, 4)
    edges: SubmapEdges,  # stacked (S, E, ...) buffers
    geos: SubmapGeometry,  # (S, ...) for edge correspondences
) -> np.ndarray:
    """Pose-graph GN over submap base poses (ref DenseSlam.cpp:120-125).

    The system is tiny (S poses); it is solved identically from the
    gathered edge set — 'replicated solve' in the multi-device runtime.
    """
    s = base_poses.shape[0]
    edge_list = []
    dst = np.asarray(edges.dst)
    ts = np.asarray(edges.T)
    ok = np.asarray(edges.valid)
    pts = np.asarray(geos.points)
    val = np.asarray(geos.valid)
    for src in range(s):
        for slot in range(dst.shape[1]):
            if not ok[src, slot]:
                continue
            p_all = pts[src][val[src]]
            p = p_all[:: max(1, len(p_all) // MAX_EDGE_CORRS)][:MAX_EDGE_CORRS]
            T = ts[src, slot]
            q = p @ T[:3, :3].T + T[:3, 3]
            edge_list.append(
                {"src": src, "dst": int(dst[src, slot]), "p_src": p, "p_dst": q}
            )
    if not edge_list or s < 2:
        return base_poses
    pg = posegraph.build_edges(edge_list, corr_capacity=MAX_EDGE_CORRS)
    opt, _ = posegraph.optimize_pose_graph(
        jnp.asarray(base_poses, jnp.float32), pg, iters=5
    )
    return np.asarray(opt)


# ---------------------------------------------------------------------------
# serial oracle
# ---------------------------------------------------------------------------


def submap_pipeline_serial(
    grays: np.ndarray,  # (S, F, H, W)
    depths: np.ndarray,
    camera: PinholeCamera,
    voxel_size: float = 0.05,
    icp_threshold: float = 0.1,
    cloud_capacity: int = 1024,
    iters: tuple[int, ...] = dense.DEFAULT_ITERS,
    radii: tuple[int, ...] = (4, 3, 2),
):
    """Same stages, sequential. Returns (frame_poses (S*F,4,4),
    base_poses, edges)."""
    s, f = grays.shape[:2]
    params = global_reg.RansacParams(voxel_size=voxel_size)
    max_loops = max(s - 2, 0)
    track = jax.jit(
        lambda g, d, pg, pd, hp: track_one_submap(g, d, pg, pd, hp, camera, iters, radii)
    )
    build = jax.jit(
        lambda g, d, t: build_submap_geometry(
            g, d, t, camera, voxel_size, cloud_capacity, params
        )
    )
    register = jax.jit(
        lambda i, geo, prev, all_geo, base: register_one_submap(
            i, geo, prev, all_geo, base, icp_threshold, params, max_loops
        )
    )
    tracks = []
    for i in range(s):
        pg = grays[i - 1, -1] if i > 0 else grays[0, 0]
        pd = depths[i - 1, -1] if i > 0 else depths[0, 0]
        tracks.append(
            track(
                jnp.asarray(grays[i]), jnp.asarray(depths[i]),
                jnp.asarray(pg), jnp.asarray(pd), jnp.bool_(i > 0),
            )
        )
    rel_last = jnp.stack([t.rel[-1] for t in tracks])
    steps = jnp.stack([t.step for t in tracks])
    base = chain_base_poses(rel_last, steps)
    geos = [
        build(jnp.asarray(grays[i]), jnp.asarray(depths[i]), tracks[i])
        for i in range(s)
    ]
    all_geo = jax.tree.map(lambda *a: jnp.stack(a), *geos)
    edges = [
        register(jnp.int32(i), geos[i], geos[i - 1] if i > 0 else geos[0], all_geo, base)
        for i in range(s)
    ]
    edges_st = jax.tree.map(lambda *a: jnp.stack(a), *edges)
    base_np = np.asarray(base)
    opt = solve_pose_graph(base_np, edges_st, all_geo)
    frame_poses = np.einsum("sij,sfjk->sfik", opt, np.asarray(jnp.stack([t.rel for t in tracks])))
    # base_np is the PRE-optimisation odometry chain (what registration's
    # ICP inits saw); returned for per-stage replay in tests
    return frame_poses.reshape(s * f, 4, 4), opt, edges_st, all_geo, base_np


# ---------------------------------------------------------------------------
# sharded pipeline
# ---------------------------------------------------------------------------


def submap_pipeline_sharded(
    grays: np.ndarray,  # (S, F, H, W), S == mesh size
    depths: np.ndarray,
    camera: PinholeCamera,
    mesh: Mesh,
    voxel_size: float = 0.05,
    icp_threshold: float = 0.1,
    cloud_capacity: int = 1024,
    iters: tuple[int, ...] = dense.DEFAULT_ITERS,
    radii: tuple[int, ...] = (4, 3, 2),
    axis: str = "d",
):
    """One submap per device; same stages and outputs as the serial path."""
    s, f = grays.shape[:2]
    n_dev = mesh.shape[axis]
    assert s == n_dev, "test/demo scope: one submap per device"
    params = global_reg.RansacParams(voxel_size=voxel_size)
    # boundary frames, resident with their consumer device
    prev_g = np.concatenate([grays[:1, 0], grays[:-1, -1]])  # (S, H, W)
    prev_d = np.concatenate([depths[:1, 0], depths[:-1, -1]])
    has_prev = np.arange(s) > 0

    @jax.jit
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P()),
        check_vma=False,
    )
    def run(g_l, d_l, pg_l, pd_l, hp_l):
        g_l, d_l = g_l[0], d_l[0]
        track = track_one_submap(
            g_l, d_l, pg_l[0], pd_l[0], hp_l[0], camera, iters, radii
        )
        # stage 2: 64-float all_gather + replicated chain
        rel_last_all = jax.lax.all_gather(track.rel[-1], axis)
        steps_all = jax.lax.all_gather(track.step, axis)
        base = chain_base_poses(rel_last_all, steps_all)

        geo = build_submap_geometry(
            g_l, d_l, track, camera, voxel_size, cloud_capacity, params
        )
        # stage 4a: previous submap's cloud via ppermute (ring shift +1)
        perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        prev_geo = jax.tree.map(
            lambda a: jax.lax.ppermute(a, axis, perm), geo
        )
        # stage 4b: all submaps' clouds for loop closure
        all_geo = jax.tree.map(lambda a: jax.lax.all_gather(a, axis), geo)
        sm_idx = jax.lax.axis_index(axis).astype(jnp.int32)
        edges = register_one_submap(
            sm_idx, geo, prev_geo, all_geo, base, icp_threshold, params,
            max_loops=max(n_dev - 2, 0),
        )
        add_leading = lambda a: a[None]
        return (
            jax.tree.map(add_leading, track),
            jax.tree.map(add_leading, (geo, edges)),
            base,
        )

    tracks, (geos, edges), base = run(
        jnp.asarray(grays), jnp.asarray(depths), jnp.asarray(prev_g),
        jnp.asarray(prev_d), jnp.asarray(has_prev),
    )
    base_np = np.asarray(base)
    opt = solve_pose_graph(base_np, edges, geos)
    frame_poses = np.einsum("sij,sfjk->sfik", opt, np.asarray(tracks.rel))
    return frame_poses.reshape(s * f, 4, 4), opt, edges, geos, base_np


def dryrun(mesh: Mesh, camera, axis: str = "d") -> None:
    """One submap per device on tiny frames: the sharded pipeline
    (ppermute consecutive ICP + all_gather loop registration + replicated
    pose-graph solve) against the serial run of the same stages. Joins
    `__graft_entry__.dryrun_multichip` so all five SURVEY scaling axes are
    covered."""
    import jax.numpy as jnp

    from ..utils import synthetic

    n_dev = mesh.shape[axis]
    s, f = n_dev, 2
    scene = synthetic.default_scene()
    poses = synthetic.orbit_trajectory(s * f)
    grays, depths = [], []
    for i in range(s * f):
        d, g = synthetic.render(
            scene, jnp.asarray(poses[i]), camera.fx, camera.fy, camera.cx,
            camera.cy, camera.height, camera.width, num_steps=32,
        )
        grays.append(np.asarray(g))
        depths.append(np.asarray(d))
    grays = np.stack(grays).reshape(s, f, camera.height, camera.width)
    depths = np.stack(depths).reshape(s, f, camera.height, camera.width)
    kw = dict(voxel_size=0.08, cloud_capacity=256)
    t0 = time.perf_counter()
    fp, base, edges, _geos, _braw = submap_pipeline_sharded(
        grays, depths, camera, mesh, axis=axis, **kw
    )
    sharded_s = time.perf_counter() - t0
    assert np.isfinite(fp).all(), "sharded submap pipeline produced non-finite poses"
    # single-device run of the same stages; the chained odometry
    # reassociates under the sharded body's fusion, hence the cm budget
    # (tests/test_parallel.py bounds each stage separately)
    t0 = time.perf_counter()
    fp_ser, _, edges_ser, _, _ = submap_pipeline_serial(grays, depths, camera, **kw)
    serial_s = time.perf_counter() - t0
    assert np.array_equal(np.asarray(edges.valid), np.asarray(edges_ser.valid))
    err = float(np.abs(fp - fp_ser).max())
    assert err < 3e-2, f"sharded submap poses differ from single-device: {err}"
    print(
        f"parallel.submap dryrun ok: {n_dev} submaps, max |pose diff| {err:.2e}"
        f" (sharded {sharded_s:.1f} s, serial {serial_s:.1f} s, compiles included)"
    )
