"""BASlam: sparse keyframe SLAM with world-point tracks and full BA.

Host-loop rebuild of the reference's BAFusion system (ref:
example/BAFusion/BASlam.{h,cpp}): the same sparse front end as FBASlam, but
matches are chained into world-point TRACKS (local->global index maps,
ref BASlam.cpp:89-150), and optimisation is full bundle adjustment over
world points + keyframe poses with the Schur complement
(ref BASlam.cpp:281-289 -> optimization/bundle.py) instead of a pose graph.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry.camera import PinholeCamera
from ..lcdetection.mild import LoopClosureDetector
from ..odometry import sparse
from ..optimization import bundle
from .keyframe_slam import KEYFRAME_DISPARITY, KeyframeSlamState


@dataclasses.dataclass
class BASlam:
    camera: PinholeCamera
    max_keypoints: int = 1000
    fast_threshold: float = 0.01
    keyframe_disparity: float = KEYFRAME_DISPARITY
    ba_every: int = 1  # run BA on every ba_every-th keyframe

    def __post_init__(self):
        self.state = KeyframeSlamState(self.camera)
        self.lcd = LoopClosureDetector()
        self.keyframe_frames: list[sparse.SparseFrame] = []
        self.keyframe_poses: list[np.ndarray] = []  # world-from-keyframe
        # world-point tracks
        self.world_points: list[np.ndarray] = []
        self.track_of_kp: list[np.ndarray] = []  # per keyframe: (K,) global id or -1
        self.observations: list[tuple[int, int, float, float]] = []  # (kf, pid, u, v)
        self.frame_count = 0
        self._rng = np.random.default_rng(0)

    def _extract(self, gray, depth) -> sparse.SparseFrame:
        return sparse.extract_sparse_frame(
            jnp.asarray(gray), jnp.asarray(depth), self.camera,
            max_keypoints=self.max_keypoints, threshold=self.fast_threshold,
        )

    def _track(self, src, tgt):
        """Track + fetch the scalar summary in ONE host transfer."""
        key = jax.random.PRNGKey(int(self._rng.integers(0, 2**31)))
        res, summ = sparse.sparse_tracking_with_summary(src, tgt, self.camera, key)
        return res, jax.device_get(summ)

    def _add_observation(self, kf: int, pid: int, uv: np.ndarray) -> None:
        self.observations.append((kf, pid, float(uv[0]), float(uv[1])))

    def _link_tracks(self, src_kf: int, dst_kf: int, res) -> int:
        """Extend/create tracks from inlier matches between two keyframes.

        (ref BASlam.cpp:89-150 — local/global index maps with union on
        matches.) Returns the number of linked correspondences.
        """
        src_frame = self.keyframe_frames[src_kf]
        dst_frame = self.keyframe_frames[dst_kf]
        v = np.asarray(res.corr_valid)
        # the matched dst keypoint index is carried through the tracking
        # result (corr_idx) — no proximity recovery, so co-located keypoints
        # link unambiguously
        src_pts = np.asarray(res.corr_src)
        match_j = np.asarray(res.corr_idx)
        linked = 0
        src_tracks = self.track_of_kp[src_kf]
        dst_tracks = self.track_of_kp[dst_kf]
        src_uv = np.asarray(src_frame.kp.uv)
        dst_uv = np.asarray(dst_frame.kp.uv)
        T_src = self.keyframe_poses[src_kf]
        for i in np.nonzero(v)[0]:
            j = int(match_j[i])
            tid = src_tracks[i]
            if tid < 0 and dst_tracks[j] >= 0:
                tid = dst_tracks[j]
            if tid < 0:
                # new world point at the src keypoint's world position
                pw = T_src[:3, :3] @ src_pts[i] + T_src[:3, 3]
                tid = len(self.world_points)
                self.world_points.append(pw.astype(np.float32))
                self._add_observation(src_kf, tid, src_uv[i])
            if src_tracks[i] < 0:
                src_tracks[i] = tid
            if dst_tracks[j] < 0:
                dst_tracks[j] = tid
                self._add_observation(dst_kf, tid, dst_uv[j])
            linked += 1
        return linked

    def update_frame(self, gray: np.ndarray, depth: np.ndarray) -> dict:
        fidx = self.frame_count
        self.frame_count += 1
        frame = self._extract(gray, depth)

        if fidx == 0:
            self.keyframe_frames.append(frame)
            self.keyframe_poses.append(np.eye(4, dtype=np.float32))
            self.track_of_kp.append(np.full(self.max_keypoints, -1, np.int64))
            self.state.promote_keyframe(0)
            self.lcd.insert(frame.kp.desc, frame.valid)
            self.state.add_frame(np.eye(4), 0, np.eye(4), True)
            return {"frame": 0, "keyframe": True, "success": True}

        kf_idx = len(self.keyframe_frames) - 1
        res, summ = self._track(self.keyframe_frames[kf_idx], frame)
        success = bool(summ.success)
        if not success:
            for cand in self.lcd.select_candidates(frame.kp.desc, frame.valid, exclude_recent=0):
                res_c, summ_c = self._track(self.keyframe_frames[cand], frame)
                if bool(summ_c.success):
                    kf_idx, res, summ, success = cand, res_c, summ_c, True
                    break
        if not success:
            last = self.state.poses[-1]
            self.state.add_frame(last, kf_idx, np.linalg.inv(self.keyframe_poses[kf_idx]) @ last, False)
            return {"frame": fidx, "keyframe": False, "success": False}

        T_rel = np.linalg.inv(np.asarray(summ.T_ts))
        T_world = self.keyframe_poses[kf_idx] @ T_rel
        self.state.add_frame(T_world, kf_idx, T_rel, True)

        disp = float(summ.disparity)
        if disp < self.keyframe_disparity:
            return {"frame": fidx, "keyframe": False, "success": True, "disparity": disp}

        new_kf = len(self.keyframe_frames)
        self.keyframe_frames.append(frame)
        self.keyframe_poses.append(T_world.astype(np.float32))
        self.track_of_kp.append(np.full(self.max_keypoints, -1, np.int64))
        self.state.promote_keyframe(fidx)
        linked = self._link_tracks(kf_idx, new_kf, res)

        for cand in self.lcd.select_candidates(frame.kp.desc, frame.valid):
            if cand == kf_idx:
                continue
            res_c, summ_c = self._track(self.keyframe_frames[cand], frame)
            if bool(summ_c.success):
                self._link_tracks(cand, new_kf, res_c)

        self.lcd.insert(frame.kp.desc, frame.valid)
        if new_kf % self.ba_every == 0:
            self.optimize()
        return {"frame": fidx, "keyframe": True, "success": True, "linked": linked}

    def process_chunk(self, grays: np.ndarray, depths: np.ndarray) -> dict:
        """Chunked BAFusion: the same on-device keyframe-selection scan as
        FBASlam.process_chunk (odometry/sparse.py `sparse_chunk_scan`), but
        promoted keyframes feed world-point TRACKS (ref BASlam.cpp:89-150)
        and the per-chunk optimisation is FULL bundle adjustment with the
        Schur complement. Loop-closure candidate pairs are tracked in one
        batched dispatch and linked into the same track structure."""
        import types as _types

        import jax as _jax

        k = int(grays.shape[0])
        frames = sparse.extract_sparse_frames_batch(
            jnp.asarray(grays, jnp.float32), jnp.asarray(depths, jnp.float32),
            self.camera, max_keypoints=self.max_keypoints,
            threshold=self.fast_threshold,
        )
        if self.frame_count == 0:
            f0 = _jax.tree.map(lambda a: a[0], frames)
            self.keyframe_frames.append(f0)
            self.keyframe_poses.append(np.eye(4, dtype=np.float32))
            self.track_of_kp.append(np.full(self.max_keypoints, -1, np.int64))
            self.state.promote_keyframe(0)
            self.lcd.insert(f0.kp.desc, f0.valid)
            self.state.add_frame(np.eye(4), 0, np.eye(4), True)
            self.frame_count = 1
            frames = _jax.tree.map(lambda a: a[1:], frames)
            k -= 1
            if k == 0:
                return {"frames": 1, "keyframes": 1}

        key = jax.random.PRNGKey(int(self._rng.integers(0, 2**31)))
        _, outs = sparse.sparse_chunk_scan(
            self.keyframe_frames[-1],
            jnp.asarray(self.keyframe_poses[-1], jnp.float32),
            frames, self.camera, key, self.keyframe_disparity,
        )
        # one round trip: summaries + correspondence buffers together
        T_world, is_kf, ok, pp, csrc_all, cval_all, cidx_all = jax.device_get(
            (outs.T_world, outs.is_kf, outs.success, outs.promote_prev,
             outs.corr_src, outs.corr_valid, outs.corr_idx)
        )
        is_kf = np.asarray(is_kf).copy()
        for i in np.nonzero(pp)[0]:
            if i >= 1 and not is_kf[i - 1] and ok[i - 1]:
                is_kf[i - 1] = True
        kf_rows = np.nonzero(is_kf)[0]
        if len(kf_rows):
            csrc = csrc_all[kf_rows]
            cval = cval_all[kf_rows]
            cidx = cidx_all[kf_rows]

        new_kf_global = []
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
            self.track_of_kp.append(np.full(self.max_keypoints, -1, np.int64))
            self.state.promote_keyframe(fidx)
            res_like = _types.SimpleNamespace(
                corr_src=csrc[j], corr_valid=cval[j], corr_idx=cidx[j]
            )
            self._link_tracks(src_kf, new_kf, res_like)
            self.lcd.insert(frame_i.kp.desc, frame_i.valid)
            new_kf_global.append(new_kf)

        if new_kf_global:
            descs = jnp.stack([self.keyframe_frames[g].kp.desc for g in new_kf_global])
            valids = jnp.stack([self.keyframe_frames[g].valid for g in new_kf_global])
            sims = self.lcd.similarity_batch(descs, valids)
            pairs = []
            for q, g in enumerate(new_kf_global):
                for cand in self.lcd.candidates_from_sims(sims[q], limit=g - 1):
                    pairs.append((cand, g))
            if pairs:
                n_real = len(pairs)
                n_pad = 1 << (n_real - 1).bit_length()
                pairs_p = pairs + [pairs[0]] * (n_pad - n_real)
                srcs = _jax.tree.map(
                    lambda *a: jnp.stack(a), *[self.keyframe_frames[c] for c, _ in pairs_p]
                )
                tgts = _jax.tree.map(
                    lambda *a: jnp.stack(a), *[self.keyframe_frames[g] for _, g in pairs_p]
                )
                keys = jax.random.split(
                    jax.random.PRNGKey(int(self._rng.integers(0, 2**31))), n_pad
                )
                res_b, summ_b = sparse.track_pairs_batch(keys, srcs, tgts, self.camera)
                succ = np.asarray(summ_b.success).copy()
                succ[n_real:] = False
                good = np.nonzero(succ)[0]
                if len(good):
                    gi = jnp.asarray(good)
                    csrc2, cval2, cidx2 = jax.device_get(
                        (res_b.corr_src[gi], res_b.corr_valid[gi], res_b.corr_idx[gi])
                    )
                    for nn, b in enumerate(good):
                        c, g = pairs[int(b)]
                        res_like = _types.SimpleNamespace(
                            corr_src=csrc2[nn], corr_valid=cval2[nn], corr_idx=cidx2[nn]
                        )
                        self._link_tracks(c, g, res_like)
        # honour the ba_every schedule the per-frame path uses: run BA at a
        # chunk boundary only if one of the chunk's new keyframes landed on
        # the schedule (new_kf % ba_every == 0)
        if new_kf_global and any(g % self.ba_every == 0 for g in new_kf_global):
            self.optimize()
        return {"frames": self.frame_count, "keyframes": len(self.keyframe_frames)}

    def optimize(self, max_iters: int = 10) -> float | None:
        """Full BA over keyframe poses + world points (ref BASlam.cpp:281-289)."""
        n_kf = len(self.keyframe_poses)
        n_pts = len(self.world_points)
        if n_kf < 2 or n_pts < 8 or len(self.observations) < 24:
            return None
        obs = np.array(self.observations)
        # keep only points with >= 2 observations
        counts = np.bincount(obs[:, 1].astype(np.int64), minlength=n_pts)
        keep = counts >= 2
        remap = np.full(n_pts, -1, np.int64)
        remap[keep] = np.arange(keep.sum())
        sel = keep[obs[:, 1].astype(np.int64)]
        obs = obs[sel]
        if len(obs) < 24 or keep.sum() < 8:
            return None
        frame_idx = obs[:, 0].astype(np.int64)
        point_idx = remap[obs[:, 1].astype(np.int64)]
        uv = obs[:, 2:4].astype(np.float32)
        pts = np.stack(self.world_points)[keep]

        bao = bundle.build_observations(frame_idx, point_idx, uv, int(keep.sum()))
        T_cw = np.stack([np.linalg.inv(p) for p in self.keyframe_poses]).astype(np.float32)
        problem = bundle.BAProblem(jnp.asarray(T_cw), jnp.asarray(pts), bao)
        cam = self.camera
        opt, mse = bundle.optimize(problem, cam.fx, cam.fy, cam.cx, cam.cy, max_iters=max_iters)
        T_cw_new = np.asarray(opt.poses)
        self.keyframe_poses = [np.linalg.inv(T_cw_new[i]).astype(np.float32) for i in range(n_kf)]
        pts_new = np.asarray(opt.points)
        kept_ids = np.nonzero(keep)[0]
        for local, gid in enumerate(kept_ids):
            self.world_points[gid] = pts_new[local]
        self.state.update_all_poses(np.stack(self.keyframe_poses))
        return mse

    def trajectory(self) -> np.ndarray:
        return self.state.trajectory()
