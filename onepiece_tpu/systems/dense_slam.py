"""DenseSlam: dense frame-to-frame VO + submap registration + pose graph.

Device rebuild of the reference's DenseFusion system (ref:
example/DenseFusion/DenseSlam.{h,cpp}, driver DenseFusion.cpp:9-112):

  per frame:
    - dense tracking vs previous frame (ref DenseSlam.cpp:22)
    - global pose chain T_w_cur = T_w_prev @ inv(T_ts) (ref :30)
    - frames grouped into submaps of SUBMAP_SIZE frames (ref :38-51,
      DenseSlam.h:123 = 50)
  per completed submap (ref :69-125 `RegisterSubmap`):
    - fuse every 3rd frame's cloud, voxel-downsample (ref DenseSlam.h:19-33)
    - FPFH features (ref :75)
    - ICP against the previous submap, initialised from odometry (ref :87-104)
    - RANSAC registration against ALL older submaps (loop closure, ref :106-115)
    - pose-graph FastBA over submap base poses + re-anchor (ref :120-125)

The final reconstruction (TSDF + marching cubes over optimised poses) lives
in the driver (tools/dense_fusion.py), matching DenseFusion.cpp:64-110.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import se3
from ..geometry.camera import PinholeCamera
from ..geometry.pointcloud import PointCloud, compact, merge, voxel_downsample
from ..odometry import dense
from ..optimization import posegraph
from ..registration import global_reg, icp

SUBMAP_SIZE = 50  # frames per submap (ref: DenseSlam.h:123)
CLOUD_STRIDE = 3  # fuse every 3rd frame (ref: DenseSlam.h:19-33)
MAX_EDGE_CORRS = 512


@dataclasses.dataclass
class DenseSlam:
    camera: PinholeCamera
    submap_size: int = SUBMAP_SIZE
    voxel_size: float = 0.05
    icp_threshold: float = 0.1

    def __post_init__(self):
        self.poses: list[np.ndarray] = []  # world-from-frame, per frame
        self.prev_pyramid = None
        self.submap_base: list[int] = []  # first frame index of each submap
        self.submap_poses: list[np.ndarray] = []  # world-from-submap-base
        self.rel_in_submap: list[np.ndarray] = []  # per frame: T_base_frame
        self.frame_submap: list[int] = []
        self.submap_clouds: list = []  # fused downsampled clouds (base coords)
        self.submap_features: list = []
        self.edges: list[dict] = []
        self._pending_clouds: list = []
        self.frame_count = 0
        self.metrics: list[dict] = []

    def update_frame(self, gray: np.ndarray, depth: np.ndarray) -> dict:
        fidx = self.frame_count
        self.frame_count += 1
        pyr = dense.preprocess_frame(jnp.asarray(gray), jnp.asarray(depth), self.camera)

        if fidx == 0:
            T_world = np.eye(4, dtype=np.float32)
            rmse = 0.0
        else:
            res = dense.dense_tracking(self.prev_pyramid, pyr, self.camera)
            # ONE blocking transfer per frame
            T_ts, rmse = jax.device_get((res.T_ts, res.rmse))
            T_world = self.poses[-1] @ np.linalg.inv(T_ts)
            rmse = float(rmse)
        self.prev_pyramid = pyr

        sm_idx = fidx // self.submap_size
        if sm_idx == len(self.submap_base):
            self.submap_base.append(fidx)
            self.submap_poses.append(T_world.astype(np.float32))
        self.frame_submap.append(sm_idx)
        T_base = self.submap_poses[sm_idx]
        self.rel_in_submap.append(np.linalg.inv(T_base) @ T_world)
        self.poses.append(T_world)

        # accumulate every CLOUD_STRIDE-th frame's cloud in submap-base coords
        if (fidx - self.submap_base[sm_idx]) % CLOUD_STRIDE == 0:
            cloud = PointCloud.from_rgbd(
                jnp.asarray(depth), None, self.camera,
                depth_min=dense.MIN_DEPTH, depth_max=dense.MAX_DEPTH,
            )
            self._pending_clouds.append(cloud.transform(jnp.asarray(self.rel_in_submap[-1], jnp.float32)))

        out = {"frame": fidx, "rmse": rmse, "submap": sm_idx}
        if fidx > 0 and (fidx + 1) % self.submap_size == 0:
            reg = self._finish_submap(sm_idx)
            out.update(reg)
        self.metrics.append(out)
        return out

    # ------------------------------------------------------------------

    def _finish_submap(self, sm_idx: int) -> dict:
        """Fuse the submap model + register (ref DenseSlam.cpp:69-125)."""
        fused = self._pending_clouds[0]
        for c in self._pending_clouds[1:]:
            fused = merge(fused, c)
        self._pending_clouds = []
        ds = voxel_downsample(fused, self.voxel_size, out_capacity=fused.capacity)
        ds = compact(ds)  # kNN/FPFH cost scales with capacity, not validity
        params = global_reg.RansacParams(voxel_size=self.voxel_size)
        feats = global_reg.extract_features(ds, params)
        self.submap_clouds.append(ds)
        self.submap_features.append(feats)

        info = {"submap_registered": sm_idx, "icp_ok": False, "loops": 0}
        if sm_idx == 0:
            return info

        # ICP vs previous submap, init from odometry chain (ref :87-104)
        T_prev = self.submap_poses[sm_idx - 1]
        T_cur = self.submap_poses[sm_idx]
        init = np.linalg.inv(T_prev) @ T_cur  # maps cur-base coords -> prev-base
        prev = self.submap_clouds[sm_idx - 1]
        cur = self.submap_clouds[sm_idx]
        res = icp.point_to_point(
            cur.points, cur.valid, prev.points, prev.valid,
            init_T=jnp.asarray(init, jnp.float32), threshold=self.icp_threshold,
        )
        T_icp, rmse_icp, nin_icp = jax.device_get((res.T, res.rmse, res.num_inliers))
        if np.isfinite(float(rmse_icp)) and int(nin_icp) > 50:
            self._add_edge(sm_idx, sm_idx - 1, np.asarray(T_icp), cur)
            info["icp_ok"] = True

        # RANSAC registration vs all older submaps (loop closures, ref :106-115)
        for older in range(sm_idx - 1):
            reg = global_reg.register(self.submap_features[sm_idx], self.submap_features[older], params)
            if bool(reg.success):
                refined = icp.point_to_point(
                    cur.points, cur.valid,
                    self.submap_clouds[older].points, self.submap_clouds[older].valid,
                    init_T=reg.T, threshold=self.icp_threshold,
                )
                if int(refined.num_inliers) > 100:
                    self._add_edge(sm_idx, older, np.asarray(refined.T), cur)
                    info["loops"] += 1

        self._optimize()
        return info

    def _add_edge(self, src_sm: int, dst_sm: int, T_src_to_dst: np.ndarray, src_cloud) -> None:
        """Edge: correspondences (p in src submap coords, T p in dst coords)."""
        pts = np.asarray(src_cloud.points)
        v = np.asarray(src_cloud.valid)
        p = pts[v][:: max(1, v.sum() // MAX_EDGE_CORRS)][:MAX_EDGE_CORRS]
        q = p @ T_src_to_dst[:3, :3].T + T_src_to_dst[:3, 3]
        self.edges.append({"src": src_sm, "dst": dst_sm, "p_src": p, "p_dst": q})

    def _optimize(self) -> None:
        n = len(self.submap_poses)
        if n < 2 or not self.edges:
            return
        edges = posegraph.build_edges(self.edges, corr_capacity=MAX_EDGE_CORRS)
        poses0 = jnp.asarray(np.stack(self.submap_poses), jnp.float32)
        opt, _ = posegraph.optimize_pose_graph(poses0, edges, iters=5)
        opt_np = np.asarray(opt)
        self.submap_poses = [opt_np[i] for i in range(n)]
        # re-anchor all frames
        for i in range(len(self.poses)):
            self.poses[i] = self.submap_poses[self.frame_submap[i]] @ self.rel_in_submap[i]

    def trajectory(self) -> np.ndarray:
        return np.stack(self.poses) if self.poses else np.zeros((0, 4, 4))
