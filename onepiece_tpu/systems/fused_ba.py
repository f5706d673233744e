"""Fully device-resident BAFusion: world-point tracks + full bundle
adjustment, one extra dispatch per chunk on top of the fused sparse front
end.

Device redesign of the reference's BAFusion system (ref:
example/BAFusion/BASlam.{h,cpp}, driver BAFusion.cpp:38-66): the same
sparse keyframe front end as FBAFusion, but inlier matches are chained
into world-point TRACKS (local->global index maps, ref BASlam.cpp:89-150)
and optimisation is FULL bundle adjustment over world points + keyframe
poses with the Schur complement (ref BASlam.cpp:281-289 ->
optimization/bundle.py), not a pose graph.

The host-loop rebuild (`systems/baslam.py`) keeps observations in a
growing Python list and re-packs them per BA call, which caps throughput
far below the front end's. Here the track
state lives on device next to the sparse state:

  - `track_of_kp` (N_CAP, F): per-keyframe global track id per keypoint
  - `pt_local`/`pt_anchor` (P_CAP,) — points in birth-keyframe coords
  - observation store (O_CAP,): (frame, point, uv) triples + count

and each chunk runs TWO jitted programs:

  1. `fused_sparse_chunk` (systems/fused_sparse.py) — extraction,
     tracking scan, keyframe promotion, LC edges, pose-graph warm start.
     Its EdgeStore now records the keypoint indices behind every
     compacted correspondence, which is all the linker needs.
  2. `link_and_ba` (this module) — a `fori_loop` over the chunk's new
     edges vector-links each edge's matches into tracks (the reference's
     sequential map-union loop, BASlam.cpp:89-150, becomes one
     cumsum+scatter per edge), then `bundle.optimize_device` runs the
     whole LM loop with Schur-as-matmul on device.

Per chunk the host fetches one small summary from each program; feature
arrays, tracks, observations, and the BA problem never leave the chip.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..optimization import bundle
from . import fused_sparse as fs


class TrackState(NamedTuple):
    """Device-resident world-point track + observation store.

    Points are stored in their BIRTH KEYFRAME's camera frame
    (`pt_local`, anchored by `pt_anchor`), not world coordinates: when
    the pose-graph warm start moves keyframes (loop closure), anchored
    points ride along automatically instead of going stale — the world
    positions are composed on the fly for each BA solve and decomposed
    back afterwards. (The reference keeps world coordinates and runs BA
    once at the end, ref BASlam.h:16 world_points; a per-chunk BA needs
    the anchored form.)"""

    track_of_kp: jax.Array  # (N_CAP, F) int32 global track id, -1 = none
    pt_local: jax.Array  # (P_CAP, 3) float32 birth-keyframe camera coords
    pt_anchor: jax.Array  # (P_CAP,) int32 birth keyframe index
    n_pts: jax.Array  # () int32
    obs_frame: jax.Array  # (O_CAP,) int32 keyframe index
    obs_point: jax.Array  # (O_CAP,) int32 world-point index
    obs_uv: jax.Array  # (O_CAP, 2) float32 observed pixels
    obs_pc: jax.Array  # (O_CAP, 3) float32 depth-backprojected camera point
    n_obs: jax.Array  # () int32
    linked_edges: jax.Array  # () int32 edges already consumed
    pt_overflow: jax.Array  # () int32 dropped world points
    obs_overflow: jax.Array  # () int32 dropped observations


def make_track_state(n_cap: int, f: int, p_cap: int, o_cap: int) -> TrackState:
    return TrackState(
        track_of_kp=jnp.full((n_cap, f), -1, jnp.int32),
        pt_local=jnp.zeros((p_cap, 3), jnp.float32),
        pt_anchor=jnp.zeros((p_cap,), jnp.int32),
        n_pts=jnp.int32(0),
        obs_frame=jnp.zeros((o_cap,), jnp.int32),
        obs_point=jnp.zeros((o_cap,), jnp.int32),
        obs_uv=jnp.zeros((o_cap, 2), jnp.float32),
        obs_pc=jnp.zeros((o_cap, 3), jnp.float32),
        n_obs=jnp.int32(0),
        linked_edges=jnp.int32(0),
        pt_overflow=jnp.int32(0),
        obs_overflow=jnp.int32(0),
    )


class BAChunkOut(NamedTuple):
    kf_pose: jax.Array  # (N_CAP, 4, 4) BA-refined world-from-keyframe
    n_pts: jax.Array  # ()
    n_obs: jax.Array  # ()
    pt_overflow: jax.Array  # ()
    obs_overflow: jax.Array  # ()
    mse: jax.Array  # () mean squared reprojection error after BA


def _link_edge(e, ts: TrackState, edges: fs.EdgeStore, kf_pose, kf_uv):
    """Vector-link ONE edge's matches into the track state.

    The reference walks matches sequentially, unioning local->global maps
    and appending world points one by one (ref BASlam.cpp:89-150). Here
    the whole edge links at once: adopt an existing track id from either
    endpoint, allocate contiguous new ids with a cumsum for matches
    neither endpoint knows, scatter the id into both keyframes' maps, and
    append (frame, point, uv) observations in two compacted blocks.
    Observation semantics match systems/baslam.py `_link_tracks`: a source
    observation is recorded only when the track is born there.
    """
    p_cap = ts.pt_local.shape[0]
    o_cap = ts.obs_frame.shape[0]
    f = ts.track_of_kp.shape[1]

    s = edges.src[e]
    d = edges.dst[e]
    i = edges.src_i[e]  # (C,)
    j = edges.dst_j[e]  # (C,)
    v = edges.valid[e]  # (C,)

    src_tr = ts.track_of_kp[s]  # (F,)
    dst_tr = ts.track_of_kp[d]
    t_src = src_tr[i]
    t_dst = dst_tr[j]
    tid0 = jnp.where(t_src >= 0, t_src, t_dst)
    new = v & (tid0 < 0)

    prefix = jnp.cumsum(new.astype(jnp.int32)) - 1  # rank among new
    nid = ts.n_pts + prefix
    fits_p = new & (nid < p_cap)
    tid = jnp.where(fits_p, nid, tid0)  # new-but-dropped stays -1

    # new points are born ANCHORED: stored in the source keyframe's camera
    # frame (edges.p_src rows are exactly that), with the keyframe index
    # recorded — world positions are composed at BA time from the current
    # keyframe pose, so pose-graph corrections never leave points stale
    wrow = jnp.where(fits_p, nid, p_cap)
    wp = ts.pt_local.at[wrow].set(edges.p_src[e], mode="drop")
    pa = ts.pt_anchor.at[wrow].set(s, mode="drop")
    n_new = jnp.sum(fits_p.astype(jnp.int32))
    pt_drop = jnp.sum((new & ~fits_p).astype(jnp.int32))

    # observations: src block (track born here), then dst block (first
    # sighting in dst)
    add_src = fits_p
    add_dst = v & (t_dst < 0) & (tid >= 0)
    uv_s = kf_uv[s][i]
    uv_d = kf_uv[d][j]

    ps = ts.n_obs + jnp.cumsum(add_src.astype(jnp.int32)) - 1
    fits_s = add_src & (ps < o_cap)
    w_s = jnp.where(fits_s, ps, o_cap)
    n_src = jnp.sum(fits_s.astype(jnp.int32))

    pd = ts.n_obs + n_src + jnp.cumsum(add_dst.astype(jnp.int32)) - 1
    fits_d = add_dst & (pd < o_cap)
    w_d = jnp.where(fits_d, pd, o_cap)
    n_dst = jnp.sum(fits_d.astype(jnp.int32))

    obs_frame = ts.obs_frame.at[w_s].set(s, mode="drop").at[w_d].set(d, mode="drop")
    obs_point = ts.obs_point.at[w_s].set(tid, mode="drop").at[w_d].set(tid, mode="drop")
    obs_uv = ts.obs_uv.at[w_s].set(uv_s, mode="drop").at[w_d].set(uv_d, mode="drop")
    # depth-backprojected camera-frame observation per side of the match
    obs_pc = (
        ts.obs_pc
        .at[w_s].set(edges.p_src[e], mode="drop")
        .at[w_d].set(edges.p_dst[e], mode="drop")
    )
    obs_drop = jnp.sum(((add_src & ~fits_s) | (add_dst & ~fits_d)).astype(jnp.int32))

    # union the id back into both keyframes' maps
    set_src = v & (t_src < 0) & (tid >= 0)
    set_dst = v & (t_dst < 0) & (tid >= 0)
    src_tr = src_tr.at[jnp.where(set_src, i, f)].set(tid, mode="drop")
    dst_tr = dst_tr.at[jnp.where(set_dst, j, f)].set(tid, mode="drop")
    track = ts.track_of_kp.at[s].set(src_tr)
    track = track.at[d].set(dst_tr)

    return ts._replace(
        track_of_kp=track,
        pt_local=wp,
        pt_anchor=pa,
        n_pts=ts.n_pts + n_new,
        obs_frame=obs_frame,
        obs_point=obs_point,
        obs_uv=obs_uv,
        obs_pc=obs_pc,
        n_obs=ts.n_obs + n_src + n_dst,
        pt_overflow=ts.pt_overflow + pt_drop,
        obs_overflow=ts.obs_overflow + obs_drop,
    )


def _link_and_ba_body(
    ts: TrackState,
    edges: fs.EdgeStore,
    kf_pose: jax.Array,  # (N_CAP, 4, 4) world-from-keyframe
    kf_uv: jax.Array,  # (N_CAP, F, 2) keypoint pixels per keyframe
    num_kf: jax.Array,  # () int32
    fx: float, fy: float, cx: float, cy: float,
    ba_iters: int = 8,
    ba_lam0: float = 3e-5,
    residual: str = "3d",
) -> tuple[TrackState, BAChunkOut]:
    """Link the chunk's new edges into tracks, then full BA on device.

    `residual="3d"` (default) uses the RGB-D observation model
    (bundle._residuals_jacobians_3d): depth anchors scale and depth, so BA
    strictly improves on the pose-graph warm start. `"2d"` reproduces the
    reference's pure-reprojection model (ref BundleAdjustment.cpp:290-331)
    for parity experiments — on depth-initialised maps with short tracks
    it is poorly conditioned and can trade ATE for reprojection error.
    """

    def body(e, ts_):
        return _link_edge(e, ts_, edges, kf_pose, kf_uv)

    ts = jax.lax.fori_loop(ts.linked_edges, edges.num, body, ts)
    ts = ts._replace(linked_edges=edges.num)

    n_cap = kf_pose.shape[0]
    o_cap = ts.obs_frame.shape[0]

    # BA over T_cw with capacity masks (bundle._ba_step_masked docstring)
    T_cw = jax.vmap(fs._inv)(kf_pose)
    obs_valid = jnp.arange(o_cap) < ts.n_obs
    obs = bundle.BAObservations(
        frame=ts.obs_frame, point=ts.obs_point, uv=ts.obs_uv,
        valid=obs_valid, obs_of_point=jnp.zeros((1, 1), jnp.int32),
    )
    fidx = jnp.arange(n_cap)
    has_obs = (
        jnp.zeros((n_cap,), jnp.int32)
        .at[ts.obs_frame].add(obs_valid.astype(jnp.int32))
    )
    solve_frame = (fidx > 0) & (fidx < num_kf) & (has_obs > 0)

    run = (num_kf >= 2) & (ts.n_pts >= 8) & (ts.n_obs >= 24)

    # compose world positions from the anchored (birth-keyframe) storage
    # using the CURRENT (post-warm-start) keyframe poses
    Ta = kf_pose[ts.pt_anchor]  # (P, 4, 4)
    world_pts = jnp.einsum("pij,pj->pi", Ta[:, :3, :3], ts.pt_local) + Ta[:, :3, 3]

    def do_ba(args):
        T_cw_, pts = args
        return bundle.optimize_device(
            T_cw_, pts, obs, solve_frame, fx, fy, cx, cy,
            max_iters=ba_iters, lam0=ba_lam0,
            anchor_scale=(residual == "2d"),
            pc_obs=ts.obs_pc if residual == "3d" else None,
        )

    T_cw, world_pts, mse = jax.lax.cond(
        run, do_ba, lambda a: (a[0], a[1], jnp.float32(0.0)),
        (T_cw, world_pts),
    )
    kf_pose_new = jax.vmap(fs._inv)(T_cw)
    # decompose back to anchored storage against the BA-refined poses
    Tna = T_cw[ts.pt_anchor]  # camera-from-world of the birth keyframe
    pt_local = jnp.einsum("pij,pj->pi", Tna[:, :3, :3], world_pts) + Tna[:, :3, 3]
    ts = ts._replace(pt_local=pt_local)

    out = BAChunkOut(
        kf_pose=kf_pose_new, n_pts=ts.n_pts, n_obs=ts.n_obs,
        pt_overflow=ts.pt_overflow, obs_overflow=ts.obs_overflow, mse=mse,
    )
    return ts, out


link_and_ba = functools.partial(
    jax.jit,
    static_argnames=("fx", "fy", "cx", "cy", "ba_iters", "ba_lam0", "residual"),
    donate_argnums=(0,),
)(_link_and_ba_body)


@functools.partial(
    jax.jit,
    static_argnames=(
        "camera", "max_keypoints", "threshold", "keyframe_disparity",
        "num_hypotheses", "gn_iters", "ba_iters", "ba_lam0", "residual",
    ),
    donate_argnums=(0, 1),
)
def fused_ba_chunk(
    state: fs.SparseDevState,
    ts: TrackState,
    grays: jax.Array,
    depths: jax.Array,
    frame_valid: jax.Array,
    key: jax.Array,
    camera,
    max_keypoints: int = 1000,
    threshold: float = 0.01,
    keyframe_disparity: float = 30.0,
    num_hypotheses: int = fs.DEFAULT_HYPOTHESES,
    gn_iters: int = 5,
    ba_iters: int = 8,
    ba_lam0: float = 3e-5,
    residual: str = "3d",
):
    """The ENTIRE BAFusion chunk as one program: sparse front end (track +
    promote + LC + pose-graph warm start) -> edge linker -> full BA ->
    re-anchor — one dispatch, one fetch: fusing the second program into
    the first halves the per-chunk blocking round trips."""
    state, out = fs._sparse_chunk_body(
        state, grays, depths, frame_valid, key, camera,
        max_keypoints=max_keypoints, threshold=threshold,
        keyframe_disparity=keyframe_disparity,
        num_hypotheses=num_hypotheses, gn_iters=gn_iters,
    )
    ts, ba_out = _link_and_ba_body(
        ts, state.edges, state.kf_pose, state.kf.kp.uv, state.num_kf,
        float(camera.fx), float(camera.fy), float(camera.cx), float(camera.cy),
        ba_iters=ba_iters, ba_lam0=ba_lam0, residual=residual,
    )
    # adopt the BA-refined poses on device (re-anchor the carried pose)
    state = state._replace(
        kf_pose=ba_out.kf_pose,
        last_T=ba_out.kf_pose[state.last_anchor] @ state.last_Trel,
    )
    out = out._replace(kf_pose=ba_out.kf_pose)
    return state, ts, out, ba_out


@dataclasses.dataclass
class FusedBASlam(fs.FusedFBASlam):
    """Production BAFusion: fused sparse front end + device track linking
    + full-BA refinement per chunk.

    API mirrors `FusedFBASlam` (`process_chunk`, `trajectory`); the
    pose-graph GN inside the front-end chunk acts as a warm start and the
    full BA refines keyframe poses + world points afterwards — strictly
    more optimisation than the reference's single end-of-run Optimize()
    (ref BAFusion.cpp:64-66). `ba_every_chunks` runs the (linking always
    happens) BA solve every N-th chunk; 1 = every chunk.
    """

    # BA cost scales with capacities (the dense W cross-term is (6F, 3P)),
    # so start small — `_maybe_grow` doubles at half-full between chunks,
    # one cached recompile per bucket (room-scale runs settle at 2-4k pts)
    pt_capacity: int = 1024
    obs_capacity: int = 4096
    ba_iters: int = 8
    ba_lam0: float = 3e-5
    ba_every_chunks: int = 1
    residual: str = "3d"  # "3d" RGB-D model (default) | "2d" ref parity

    def __post_init__(self):
        super().__post_init__()
        self._track = make_track_state(
            self.kf_capacity, self.max_keypoints,
            self.pt_capacity, self.obs_capacity,
        )
        self.n_pts = 0
        self.n_obs = 0
        self.pt_overflow = 0
        self.obs_overflow = 0
        self.ba_mse = 0.0
        self._chunks = 0

    def _maybe_grow(self, next_k: int) -> None:
        kf_cap0 = self.kf_capacity
        super()._maybe_grow(next_k)
        t = self._track
        if self.kf_capacity != kf_cap0:
            pad = self.kf_capacity - t.track_of_kp.shape[0]
            t = t._replace(
                track_of_kp=jnp.pad(
                    t.track_of_kp, ((0, pad), (0, 0)), constant_values=-1
                )
            )
        # saturation-driven doubling (one recompile per capacity, cached):
        # a chunk can add at most 2K keyframe edges x C corrs of points/obs,
        # but in practice far fewer — grow at half-full like the block pool
        while self.n_pts * 2 > self.pt_capacity:
            t = t._replace(
                pt_local=jnp.pad(t.pt_local, ((0, self.pt_capacity), (0, 0))),
                pt_anchor=jnp.pad(t.pt_anchor, (0, self.pt_capacity)),
            )
            self.pt_capacity *= 2
        while self.n_obs * 2 > self.obs_capacity:
            t = t._replace(
                obs_frame=jnp.pad(t.obs_frame, (0, self.obs_capacity)),
                obs_point=jnp.pad(t.obs_point, (0, self.obs_capacity)),
                obs_uv=jnp.pad(t.obs_uv, ((0, self.obs_capacity), (0, 0))),
                obs_pc=jnp.pad(t.obs_pc, ((0, self.obs_capacity), (0, 0))),
            )
            self.obs_capacity *= 2
        self._track = t

    def process_chunk(self, grays, depths) -> dict:
        """K frames through the single fused BAFusion program: ONE dispatch
        + ONE fetch per chunk (front end + linker + full BA together)."""
        grays = jnp.asarray(grays, jnp.float32)
        depths = jnp.asarray(depths, jnp.float32)
        k = int(grays.shape[0])
        if k == 0:
            return {"frames": self.frame_count, "keyframes": self.num_kf}
        k_pad = max(8, 1 << (k - 1).bit_length())
        if k_pad != k:
            pad = ((0, k_pad - k), (0, 0), (0, 0))
            grays = jnp.pad(grays, pad)
            depths = jnp.pad(depths, pad)
        fvalid = jnp.arange(k_pad) < k
        self._maybe_grow(k_pad)
        self._chunks += 1
        key = jax.random.PRNGKey(int(self._rng.integers(0, 2**31)))
        self._state, self._track, out, ba_out = fused_ba_chunk(
            self._state, self._track, grays, depths, fvalid, key, self.camera,
            max_keypoints=self.max_keypoints, threshold=self.fast_threshold,
            keyframe_disparity=self.keyframe_disparity,
            num_hypotheses=self.num_hypotheses,
            ba_iters=(
                self.ba_iters if self._chunks % self.ba_every_chunks == 0 else 0
            ),
            ba_lam0=self.ba_lam0,
            residual=self.residual,
        )
        h, hb = jax.device_get((out, ba_out))  # the ONE per-chunk fetch
        self.frame_count += k
        self.num_kf = int(h.num_kf)
        self.num_edges = int(h.num_edges)
        self.edge_overflow = int(h.edge_overflow)
        self.lc_edges_total += int(h.lc_edges)
        self._kf_pose = np.asarray(hb.kf_pose)
        for i in range(k):
            self._anchors.append(int(h.anchor[i]))
            self._Trels.append(np.asarray(h.T_rel[i]))
            self._ok.append(bool(h.ok[i]))
            self._iskf.append(bool(h.is_kf[i]))
        self.n_pts = int(hb.n_pts)
        self.n_obs = int(hb.n_obs)
        self.pt_overflow = int(hb.pt_overflow)
        self.obs_overflow = int(hb.obs_overflow)
        self.ba_mse = float(hb.mse)
        return {
            "frames": self.frame_count, "keyframes": self.num_kf,
            "edges": self.num_edges, "lc_pairs": int(h.lc_pairs),
            "relocs": int(np.sum(h.reloc)), "retro": int(np.sum(h.retro)),
            "world_points": self.n_pts, "observations": self.n_obs,
            "ba_mse": self.ba_mse, "pt_overflow": self.pt_overflow,
            "obs_overflow": self.obs_overflow,
        }
