"""Multi-chip sharding paths on the 8-device virtual CPU mesh.

Covers SURVEY §2.10's scaling axes as pytest (previously only the driver
dry run exercised them): pixel-sharded dense tracking with psum'd normal
equations, point-sharded BA Schur psum, block-sharded TSDF integration,
and the sharded fused (device-hash + Pallas) TSDF step.
"""

import os
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from onepiece_tpu.geometry.camera import TUM_CAMERA


@pytest.fixture(scope="module")
def mesh():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices (see conftest)")
    return Mesh(np.array(devs[:8]), ("d",))


@pytest.fixture(scope="module")
def cam():
    return TUM_CAMERA.pyramid(3)[-1]  # 160x120


def test_dense_tracking_sharded_matches_local(mesh, cam):
    import jax.numpy as jnp

    from onepiece_tpu.geometry import se3
    from onepiece_tpu.odometry import dense
    from onepiece_tpu.parallel import dense as pdense
    from onepiece_tpu.utils import synthetic

    scene = synthetic.default_scene()
    T1 = se3.se3_exp(jnp.asarray([0.01, -0.01, 0.015, 0.01, -0.015, 0.008]))
    d0, g0 = synthetic.render(scene, jnp.eye(4), cam.fx, cam.fy, cam.cx,
                              cam.cy, cam.height, cam.width, num_steps=32)
    d1, g1 = synthetic.render(scene, T1, cam.fx, cam.fy, cam.cx, cam.cy,
                              cam.height, cam.width, num_steps=32)
    src = dense.preprocess_frame(g0, d0, cam)
    tgt = dense.preprocess_frame(g1, d1, cam)
    res_sh = pdense.dense_tracking_sharded(src, tgt, cam, mesh)
    assert np.isfinite(np.asarray(res_sh.T_ts)).all()
    # sharding must not change the math: compare against the local
    # reference-exact tracker (same formulation, same iteration counts)
    res_local = dense.dense_tracking_exact(src, tgt, cam)
    err = np.asarray(se3.se3_log(res_sh.T_ts @ np.asarray(se3.inverse_T(res_local.T_ts))))
    assert np.linalg.norm(err) < 1e-3, err


def test_ba_sharded_dryrun(mesh):
    from onepiece_tpu.parallel import ba

    ba.dryrun(mesh)  # self-checking (asserts convergence + cross-device agreement)


def test_posegraph_sharded_matches_replicated(mesh):
    """Edge-sharded pose-graph GN == the replicated solver (SURVEY §2.10
    axis 2, ref SimpleBA.cpp:80-156): same edges, same iterations, pose
    agreement at float-reassociation tolerance."""
    import jax.numpy as jnp

    from onepiece_tpu.geometry import se3
    from onepiece_tpu.optimization import posegraph
    from onepiece_tpu.parallel import posegraph as ppg

    rng = np.random.default_rng(7)
    n = 24
    pts = rng.uniform(-1, 1, (32, 3)).astype(np.float32)
    # ring + a few long-range closures, all with exact correspondences
    pairs = [(i, (i + 1) % n) for i in range(n)] + [(0, n // 2), (3, n - 4)]
    gt = np.stack([np.asarray(se3.se3_exp(jnp.asarray(
        rng.normal(0, 0.1, 6).astype(np.float32)))) for _ in range(n)])
    gt[0] = np.eye(4)
    edge_list = []
    for i, j in pairs:
        p_i = (np.linalg.inv(gt[i]) @ np.c_[pts, np.ones(32)].T).T[:, :3]
        p_j = (np.linalg.inv(gt[j]) @ np.c_[pts, np.ones(32)].T).T[:, :3]
        edge_list.append({"src": i, "dst": j, "p_src": p_i, "p_dst": p_j})
    edges = posegraph.build_edges(edge_list, corr_capacity=32)
    noise = rng.normal(0, 0.03, (n, 6)).astype(np.float32)
    noise[0] = 0
    init = jnp.asarray(np.einsum(
        "nij,njk->nik", np.asarray(se3.se3_exp(jnp.asarray(noise))), gt
    ).astype(np.float32))

    ref, cost_ref = posegraph.optimize_pose_graph(init, edges, iters=5)
    sh_edges = ppg.shard_edges(edges, mesh)
    sh, cost_sh = ppg.optimize_pose_graph_sharded(init, sh_edges, mesh, iters=5)
    np.testing.assert_allclose(np.asarray(sh), np.asarray(ref), atol=1e-4)
    # both recover ground truth
    np.testing.assert_allclose(np.asarray(sh), gt, atol=1e-3)


@pytest.mark.slow
def test_posegraph_sharded_at_scale(mesh):
    """10^3 keyframes (the SURVEY scale the replicated solver was unproven
    at): the edge-sharded psum assembly + replicated Cholesky converges and
    matches the single-device solver to mm."""
    import jax.numpy as jnp

    from onepiece_tpu.geometry import se3
    from onepiece_tpu.optimization import posegraph
    from onepiece_tpu.parallel import posegraph as ppg

    rng = np.random.default_rng(13)
    n = 1000
    c = 12
    pts = rng.uniform(-1, 1, (c, 3)).astype(np.float32)
    pairs = [(i, i + 1) for i in range(n - 1)]
    pairs += [(i, i + 50) for i in range(0, n - 50, 97)]  # sparse closures
    gt_xi = rng.normal(0, 0.05, (n, 6)).astype(np.float32)
    gt_xi[0] = 0
    gt = np.asarray(se3.se3_exp(jnp.asarray(gt_xi)))
    edge_list = []
    for i, j in pairs:
        p_i = (np.linalg.inv(gt[i]) @ np.c_[pts, np.ones(c)].T).T[:, :3]
        p_j = (np.linalg.inv(gt[j]) @ np.c_[pts, np.ones(c)].T).T[:, :3]
        edge_list.append({"src": i, "dst": j, "p_src": p_i, "p_dst": p_j})
    edges = posegraph.build_edges(edge_list, corr_capacity=c)
    noise = rng.normal(0, 0.01, (n, 6)).astype(np.float32)
    noise[0] = 0
    init = jnp.asarray(np.einsum(
        "nij,njk->nik", np.asarray(se3.se3_exp(jnp.asarray(noise))), gt
    ).astype(np.float32))

    sh_edges = ppg.shard_edges(edges, mesh)
    sh, _ = ppg.optimize_pose_graph_sharded(init, sh_edges, mesh, iters=3)
    ref, _ = posegraph.optimize_pose_graph(init, edges, iters=3)
    err_t = np.abs(np.asarray(sh)[:, :3, 3] - np.asarray(ref)[:, :3, 3]).max()
    assert err_t < 1e-3, err_t  # mm-level sharded-vs-replicated agreement
    # and the solve actually converged toward ground truth
    gt_err = np.abs(np.asarray(sh)[:, :3, 3] - gt[:, :3, 3]).max()
    assert gt_err < 5e-3, gt_err


def test_tsdf_sharded_dryrun(mesh, cam):
    from onepiece_tpu.parallel import tsdf

    tsdf.dryrun(mesh, cam)  # self-checking vs local integration


def test_fused_sharded_matches_single_device(mesh, cam):
    from onepiece_tpu.parallel import fused

    fused.dryrun(mesh, cam, interpret=True)  # raises on any mismatch vs single-device pool


@pytest.mark.slow
def test_mc_sharded_and_migration_match_single_device(mesh, cam):
    from onepiece_tpu.parallel import mc

    # self-checking: sharded halo-exchange meshing == single-device mesh,
    # and the mesh survives all_to_all block migration unchanged
    mc.dryrun(mesh, cam, interpret=True)


@pytest.mark.slow
def test_submap_parallel_matches_serial(mesh, cam):
    """One submap per device (SURVEY axis 4): the sharded pipeline
    (ppermute consecutive ICP, all_gather loop registration, replicated
    pose-graph solve) must reproduce the serial run of the same stages."""
    import jax.numpy as jnp

    from onepiece_tpu.parallel import submap
    from onepiece_tpu.utils import synthetic

    small = TUM_CAMERA.pyramid(3)[-1]  # 160x120
    s, f = 8, 4
    scene = synthetic.default_scene()
    poses = synthetic.orbit_trajectory(s * f)
    grays = []
    depths = []
    for i in range(s * f):
        d, g = synthetic.render(
            scene, jnp.asarray(poses[i]), small.fx, small.fy, small.cx,
            small.cy, small.height, small.width, num_steps=48,
        )
        grays.append(np.asarray(g))
        depths.append(np.asarray(d))
    grays = np.stack(grays).reshape(s, f, small.height, small.width)
    depths = np.stack(depths).reshape(s, f, small.height, small.width)

    kw = dict(voxel_size=0.05, cloud_capacity=512)
    fp_ser, base_ser, edges_ser, geos_ser, _ = submap.submap_pipeline_serial(
        grays, depths, small, **kw
    )
    fp_sh, base_sh, edges_sh, geos_sh, base_raw_sh = submap.submap_pipeline_sharded(
        grays, depths, small, mesh, **kw
    )
    assert np.array_equal(np.asarray(edges_sh.valid), np.asarray(edges_ser.valid))

    # PER-STAGE gates (VERDICT r4 weak #4: the end-chained 3 cm bound alone
    # could mask a collective bug; each stage must agree at mm level):
    # (a) per-submap downsampled clouds — local work, no collectives between
    #     it and the input beyond the boundary frame ppermute
    v_both = np.asarray(geos_sh.valid) & np.asarray(geos_ser.valid)
    assert v_both.any()
    dp = np.abs(np.asarray(geos_sh.points) - np.asarray(geos_ser.points))
    assert dp[v_both].max() < 1e-3, dp[v_both].max()
    # (b) per-edge ICP/registration transforms with the COLLECTIVES isolated:
    #     rerun the registration stage serially on the sharded run's own
    #     inputs (its clouds + its base poses). Any difference is then the
    #     ppermute/all_gather handover itself, which must be lossless —
    #     sub-mm per edge. (Comparing sharded edges against the *serial
    #     pipeline's* edges instead would re-import the odometry-init
    #     difference that the chained 3 cm budget below covers.)
    import jax.numpy as jnp
    from onepiece_tpu.registration import global_reg

    s_n = np.asarray(geos_sh.points).shape[0]
    params = global_reg.RansacParams(voxel_size=0.05)
    base_sh_j = jnp.asarray(base_raw_sh, jnp.float32)  # pre-opt chain: what
    # the in-shard registration's ICP inits actually saw
    edges_replay = []
    for i in range(s_n):
        geo_i = jax.tree.map(lambda a: jnp.asarray(a)[i], geos_sh)
        geo_p = jax.tree.map(lambda a: jnp.asarray(a)[max(i - 1, 0)], geos_sh)
        edges_replay.append(
            submap.register_one_submap(
                jnp.int32(i), geo_i, geo_p,
                jax.tree.map(jnp.asarray, geos_sh), base_sh_j,
                icp_threshold=0.1, params=params, max_loops=max(s_n - 2, 0),
            )
        )
    er = jax.tree.map(lambda *a: np.stack([np.asarray(x) for x in a]), *edges_replay)
    e_both = np.asarray(edges_sh.valid) & er.valid
    assert e_both.sum() >= s - 2
    t_sh = np.asarray(edges_sh.T)
    dt = np.abs(t_sh[..., :3, 3] - er.T[..., :3, 3]).max(-1)
    dr = np.abs(t_sh[..., :3, :3] - er.T[..., :3, :3]).reshape(*t_sh.shape[:2], 9).max(-1)
    assert dt[e_both].max() < 1e-4, dt[e_both].max()
    assert dr[e_both].max() < 1e-4, dr[e_both].max()

    # chained final poses: 28-iteration GN reductions reassociate under the
    # sharded body's different XLA fusion (bf16 quad-row casts land at
    # different points); compounded over 8 submap boundary pairs the
    # odometry CHAIN — not the collectives, which (a)+(b) bound at mm —
    # accumulates to ~cm, hence the looser end-to-end budget
    np.testing.assert_allclose(base_sh, base_ser, atol=3e-2)
    np.testing.assert_allclose(fp_sh, fp_ser, atol=3e-2)
    # the consecutive-ICP edges must actually have fired
    assert np.asarray(edges_sh.valid)[1:, 0].sum() >= s - 2


@pytest.mark.slow
def test_dryrun_multichip_on_four_devices():
    """The path `chip_smoke.py --four` runs on four cards: every sharded
    path against its single-device result, here on four virtual CPU
    devices with the TSDF kernel interpreted."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__

    __graft_entry__.dryrun_multichip(4, interpret=True)
