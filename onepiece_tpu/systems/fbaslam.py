"""FBASlam: sparse keyframe odometry + loop closure + pose-graph optimisation.

Host-loop rebuild of the reference's FBAFusion system (ref:
example/FBAFusion/FBASlam.{h,cpp}, driver FBAFusion.cpp:10-105):

  per frame:
    - ORB-track against the last keyframe (ref FBASlam.cpp:23)
    - keyframe when average disparity >= 30 px (ref :32-41)
    - on keyframe: loop-closure candidates from the descriptor DB
      (ref :73), re-track each candidate to build graph edges (ref :81-123),
      insert into DB, pose-graph FastBA over keyframes (ref :140-147),
      re-anchor all frames (UpdateAllPoses)
    - relocalisation via LC candidates when tracking fails (ref :103-108)

Device work (feature extraction, matching, RANSAC, pose-graph GN) is jitted;
this module is the host-side frame loop, exactly the part of the reference
that is irregular control flow.

NOTE: the PRODUCTION sparse system is `systems/fused_sparse.FusedFBASlam`
(the whole chunk as one device program + one fetch). This host-loop version stays as the reference-shaped
implementation: easier to instrument, per-frame latency, and the oracle
the fused path is tested against.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import se3
from ..geometry.camera import PinholeCamera
from ..lcdetection.mild import LoopClosureDetector
from ..odometry import sparse
from ..optimization import posegraph
from .keyframe_slam import KEYFRAME_DISPARITY, KeyframeSlamState

MAX_EDGE_CORRS = 256
MAX_REPROJECTION_ERROR_3D = 0.05  # ref: KeyframeBasedSlam.h:58 (normalised err/z)


@dataclasses.dataclass
class FBASlam:
    camera: PinholeCamera
    max_keypoints: int = 1000
    fast_threshold: float = 0.01
    keyframe_disparity: float = KEYFRAME_DISPARITY

    def __post_init__(self):
        self.state = KeyframeSlamState(self.camera)
        self.lcd = LoopClosureDetector()
        self.keyframe_frames: list[sparse.SparseFrame] = []
        self.keyframe_poses: list[np.ndarray] = []  # world-from-keyframe
        self.edges: list[dict] = []
        self.frame_count = 0
        self._rng = np.random.default_rng(0)

    # ------------------------------------------------------------------

    def _extract(self, gray, depth) -> sparse.SparseFrame:
        return sparse.extract_sparse_frame(
            jnp.asarray(gray), jnp.asarray(depth), self.camera,
            max_keypoints=self.max_keypoints, threshold=self.fast_threshold,
        )

    def _track(self, src: sparse.SparseFrame, tgt: sparse.SparseFrame):
        """Track + fetch the scalar summary in ONE host transfer."""
        key = jax.random.PRNGKey(int(self._rng.integers(0, 2**31)))
        res, summ = sparse.sparse_tracking_with_summary(src, tgt, self.camera, key)
        return res, jax.device_get(summ)

    def _add_edge(self, src_kf: int, dst_kf: int, res) -> None:
        v = np.asarray(res.corr_valid)
        self.edges.append(
            {
                "src": src_kf,
                "dst": dst_kf,
                "p_src": np.asarray(res.corr_src)[v][:MAX_EDGE_CORRS],
                "p_dst": np.asarray(res.corr_dst)[v][:MAX_EDGE_CORRS],
            }
        )

    def update_frame(self, gray: np.ndarray, depth: np.ndarray) -> dict:
        """Process one frame; returns a metrics dict (pose, keyframe?, ...)."""
        fidx = self.frame_count
        self.frame_count += 1
        frame = self._extract(gray, depth)

        if fidx == 0:
            self.keyframe_frames.append(frame)
            self.keyframe_poses.append(np.eye(4, dtype=np.float32))
            self.state.promote_keyframe(0)
            self.lcd.insert(frame.kp.desc, frame.valid)
            self.state.add_frame(np.eye(4), 0, np.eye(4), True)
            return {"frame": 0, "keyframe": True, "success": True}

        kf_idx = len(self.keyframe_frames) - 1
        res, summ = self._track(self.keyframe_frames[kf_idx], frame)
        success = bool(summ.success)

        if not success:
            # relocalisation against loop-closure candidates (ref :103-108)
            for cand in self.lcd.select_candidates(frame.kp.desc, frame.valid, exclude_recent=0):
                res_c, summ_c = self._track(self.keyframe_frames[cand], frame)
                if bool(summ_c.success):
                    kf_idx = cand
                    res, summ = res_c, summ_c
                    success = True
                    break

        if not success:
            # keep last pose (constant-position fallback); mark failure
            last = self.state.poses[-1]
            self.state.add_frame(last, kf_idx, np.linalg.inv(self.keyframe_poses[kf_idx]) @ last, False)
            return {"frame": fidx, "keyframe": False, "success": False}

        T_ts = np.asarray(summ.T_ts)  # kf -> current (already fetched)
        T_rel = np.linalg.inv(T_ts)  # current in kf coords: T_kf_cur
        T_world = self.keyframe_poses[kf_idx] @ T_rel
        self.state.add_frame(T_world, kf_idx, T_rel, True)

        # keyframe decision on inlier disparity (ref :32-41), device-computed
        disp = float(summ.disparity)
        is_kf = disp >= self.keyframe_disparity
        if not is_kf:
            return {"frame": fidx, "keyframe": False, "success": True, "disparity": disp}

        # promote to keyframe
        new_kf = len(self.keyframe_frames)
        self.keyframe_frames.append(frame)
        self.keyframe_poses.append(T_world.astype(np.float32))
        self.state.promote_keyframe(fidx)
        self._add_edge(kf_idx, new_kf, res)

        # loop closure edges (ref :73-123)
        for cand in self.lcd.select_candidates(frame.kp.desc, frame.valid):
            if cand == kf_idx:
                continue
            res_c, summ_c = self._track(self.keyframe_frames[cand], frame)
            # loop edges carry far more leverage than odometry edges: gate
            # on the reference's reprojection rmse too (ref FBASlam.cpp:99)
            if bool(summ_c.success) and float(summ_c.rmse) < MAX_REPROJECTION_ERROR_3D:
                self._add_edge(cand, new_kf, res_c)

        self.lcd.insert(frame.kp.desc, frame.valid)
        self.optimize()
        return {"frame": fidx, "keyframe": True, "success": True, "disparity": disp}

    def process_chunk(self, grays: np.ndarray, depths: np.ndarray) -> dict:
        """Process K frames with ONE on-device keyframe-selection scan.

        Device-first reshaping of the reference's per-frame loop (ref
        FBAFusion.cpp:38-47): extraction and tracking-with-promotion run
        as single dispatches (odometry/sparse.py `sparse_chunk_scan`);
        loop-closure queries, edge building, and the pose-graph solve are
        batched at the chunk boundary (deferred <= one chunk vs the
        reference's per-keyframe schedule). Host<->device syncs per chunk:
        ~6, independent of frame or keyframe count. Tracking failures keep
        the previous pose (no in-chunk relocalisation).
        """
        import os as _os
        import time as _time

        import jax as _jax

        _timing = _os.environ.get("ONEPIECE_TIMING")
        _t0 = _time.perf_counter()

        def _tick(name):
            nonlocal _t0
            if _timing:
                now = _time.perf_counter()
                print(f"  [chunk] {name}: {(now - _t0) * 1e3:.0f} ms", flush=True)
                _t0 = now

        k = int(grays.shape[0])
        frames = sparse.extract_sparse_frames_batch(
            jnp.asarray(grays, jnp.float32), jnp.asarray(depths, jnp.float32),
            self.camera, max_keypoints=self.max_keypoints,
            threshold=self.fast_threshold,
        )
        first = self.frame_count == 0
        if first:
            f0 = _jax.tree.map(lambda a: a[0], frames)
            self.keyframe_frames.append(f0)
            self.keyframe_poses.append(np.eye(4, dtype=np.float32))
            self.state.promote_keyframe(0)
            self.lcd.insert(f0.kp.desc, f0.valid)
            self.state.add_frame(np.eye(4), 0, np.eye(4), True)
            self.frame_count = 1
            frames = _jax.tree.map(lambda a: a[1:], frames)
            k -= 1
            if k == 0:
                return {"frames": 1, "keyframes": 1}

        kf_entry_idx = len(self.keyframe_frames) - 1
        key = jax.random.PRNGKey(int(self._rng.integers(0, 2**31)))
        (kf_frame_out, kf_pose_out), outs = sparse.sparse_chunk_scan(
            self.keyframe_frames[-1],
            jnp.asarray(self.keyframe_poses[-1], jnp.float32),
            frames, self.camera, key, self.keyframe_disparity,
        )
        _tick("extract+scan dispatch")
        # ONE fetch for the whole chunk: scalar summaries AND the (small,
        # ~450 KB) per-frame correspondence buffers together — a second
        # round trip costs more than the extra bytes
        T_world, is_kf, ok, rmse, disp, pp, csrc_all, cdst_all, cval_all = jax.device_get(
            (outs.T_world, outs.is_kf, outs.success, outs.rmse,
             outs.disparity, outs.promote_prev,
             outs.corr_src, outs.corr_dst, outs.corr_valid)
        )
        _tick("summary+corr fetch")
        # failure recovery: frame i-1 promoted retroactively when frame i
        # lost tracking (see sparse_chunk_scan)
        is_kf = np.asarray(is_kf).copy()
        for i in np.nonzero(pp)[0]:
            if i >= 1 and not is_kf[i - 1] and ok[i - 1]:
                is_kf[i - 1] = True
        kf_rows = np.nonzero(is_kf)[0]
        if len(kf_rows):
            csrc = csrc_all[kf_rows]
            cdst = cdst_all[kf_rows]
            cval = cval_all[kf_rows]

        _tick("edge corr slice")
        new_kf_global = []  # global keyframe index per promoted row
        for i in range(k):
            fidx = self.frame_count
            self.frame_count += 1
            src_kf = len(self.keyframe_frames) - 1
            T_rel = np.linalg.inv(self.keyframe_poses[src_kf]) @ T_world[i]
            self.state.add_frame(T_world[i], src_kf, T_rel, bool(ok[i]))
            if not is_kf[i]:
                continue
            j = int(np.searchsorted(kf_rows, i))
            frame_i = _jax.tree.map(lambda a: a[i], frames)
            new_kf = len(self.keyframe_frames)
            self.keyframe_frames.append(frame_i)
            self.keyframe_poses.append(T_world[i].astype(np.float32))
            self.state.promote_keyframe(fidx)
            v = cval[j]
            self.edges.append({
                "src": src_kf, "dst": new_kf,
                "p_src": csrc[j][v][:MAX_EDGE_CORRS],
                "p_dst": cdst[j][v][:MAX_EDGE_CORRS],
            })
            self.lcd.insert(frame_i.kp.desc, frame_i.valid)
            new_kf_global.append(new_kf)

        _tick("promotion walk")
        # batched loop closure for the chunk's new keyframes
        if new_kf_global:
            descs = jnp.stack([self.keyframe_frames[g].kp.desc for g in new_kf_global])
            valids = jnp.stack([self.keyframe_frames[g].valid for g in new_kf_global])
            sims = self.lcd.similarity_batch(descs, valids)
            _tick("  lc similarity")
            pairs = []
            for q, g in enumerate(new_kf_global):
                for cand in self.lcd.candidates_from_sims(sims[q], limit=g - 1):
                    pairs.append((cand, g))
            if pairs:
                # pad the pair batch to a power of two: each distinct batch
                # size otherwise compiles its own lax.map executable
                n_real = len(pairs)
                n_pad = 1 << (n_real - 1).bit_length()
                pairs_p = pairs + [pairs[0]] * (n_pad - n_real)
                srcs = _jax.tree.map(
                    lambda *a: jnp.stack(a),
                    *[self.keyframe_frames[c] for c, _ in pairs_p],
                )
                tgts = _jax.tree.map(
                    lambda *a: jnp.stack(a),
                    *[self.keyframe_frames[g] for _, g in pairs_p],
                )
                keys = jax.random.split(
                    jax.random.PRNGKey(int(self._rng.integers(0, 2**31))), n_pad
                )
                # lax.map, not vmap: vmapped RANSAC/top-k lowers poorly
                _tick("  lc pair prep")
                res_b, summ_b = sparse.track_pairs_batch(
                    keys, srcs, tgts, self.camera
                )
                _tick(f"  lc pair track x{n_pad}")
                succ = np.asarray(summ_b.success) & (
                    np.asarray(summ_b.rmse) < MAX_REPROJECTION_ERROR_3D
                )
                succ[n_real:] = False  # padding
                good = np.nonzero(succ)[0]
                if len(good):
                    gi = jnp.asarray(good)
                    csrc2, cdst2, cval2 = jax.device_get(
                        (res_b.corr_src[gi], res_b.corr_dst[gi], res_b.corr_valid[gi])
                    )
                    for n, b in enumerate(good):
                        c, g = pairs[int(b)]
                        v = cval2[n]
                        self.edges.append({
                            "src": c, "dst": g,
                            "p_src": csrc2[n][v][:MAX_EDGE_CORRS],
                            "p_dst": cdst2[n][v][:MAX_EDGE_CORRS],
                        })
        _tick("loop closure batch")
        if new_kf_global:
            self.optimize()
        _tick("pose-graph optimize")
        return {"frames": self.frame_count, "keyframes": len(self.keyframe_frames)}

    def optimize(self, iters: int = posegraph.DEFAULT_ITERS) -> None:
        """Pose-graph FastBA over keyframes + re-anchor all frames
        (ref FBASlam.cpp:140-147 `Optimize`)."""
        n = len(self.keyframe_poses)
        if n < 2 or not self.edges:
            return
        # capacity bucketing: pad edge AND pose counts to powers of two so
        # the jitted GN solve compiles once per doubling, not once per
        # keyframe (each recompile costs seconds and was the dominant
        # per-keyframe cost)
        e_cap = 1 << (len(self.edges) - 1).bit_length()
        n_cap = 1 << (n - 1).bit_length()
        edges = posegraph.build_edges(
            self.edges, corr_capacity=MAX_EDGE_CORRS, num_edges_cap=e_cap
        )
        padded = np.tile(np.eye(4, dtype=np.float32), (n_cap, 1, 1))
        padded[:n] = np.stack(self.keyframe_poses)
        poses0 = jnp.asarray(padded)
        opt, _ = posegraph.optimize_pose_graph(poses0, edges, iters=iters)
        opt_np = np.asarray(opt)
        self.keyframe_poses = [opt_np[i] for i in range(n)]
        # re-anchor every frame: anchor_keyframe stores keyframe LIST index
        kf_pose_arr = np.stack(self.keyframe_poses)
        self.state.update_all_poses(kf_pose_arr)

    def trajectory(self) -> np.ndarray:
        return self.state.trajectory()
