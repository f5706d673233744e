"""Full bundle adjustment: poses + world points, LM with Schur complement.

Device redesign of `BundleAdjustment` (ref: src/Optimization/BundleAdjustment.cpp:60-289).
The reference assembles sparse U/V/W triplets in a scalar loop over
observations, inverts 3x3 point blocks, forms the reduced camera system with
Eigen block products, and solves with SimplicialLDLT. Here:

  - residuals + 2x6/2x3 Jacobians: one vmap over the padded observation
    tensor (ref ComputeJacobian, BundleAdjustment.cpp:290-331)
  - U (per-frame 6x6) and V (per-point 3x3): scatter-adds
  - V^-1: batched 3x3 solves
  - the Schur reduced system S = U - W V^-1 W^T: observations are grouped
    by point into fixed-width (P, Omax) lists; per-point pair products are
    one einsum, scatter-added into the dense (F, F, 6, 6) camera Hessian
  - LM damping with multiply/rollback schedule matching the reference
    (lambda x2 on error increase with rollback, x0.7 on decrease,
    ref: BundleAdjustment.cpp:248-280)

State: poses are T_cw (world->camera), so reprojection is
pi(T_cw p_w); pose 0 gauge-fixed (ref: :237-247 pose-0 handling).
Distribution: parallel/ba.py shards the observation tensor and psums
U/V/W/S contributions — the math here is written shard-compatible.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import se3

DEFAULT_MAX_ITERS = 20  # ref: BundleAdjustment.cpp LM outer iterations


class BAObservations(NamedTuple):
    frame: jax.Array  # (O,) int32
    point: jax.Array  # (O,) int32
    uv: jax.Array  # (O, 2) float32 observed pixels
    valid: jax.Array  # (O,) bool
    obs_of_point: jax.Array  # (P, Omax) int32 indices into O, -1 padded


class BAProblem(NamedTuple):
    poses: jax.Array  # (F, 4, 4) T_cw
    points: jax.Array  # (P, 3) world points
    obs: BAObservations


def build_observations(
    frame_idx: np.ndarray, point_idx: np.ndarray, uv: np.ndarray, num_points: int
) -> BAObservations:
    """Host helper: pack observation arrays + per-point gather lists."""
    o = len(frame_idx)
    counts = np.bincount(point_idx, minlength=num_points)
    omax = max(int(counts.max()) if o else 1, 1)
    lists = np.full((num_points, omax), -1, np.int64)
    fill = np.zeros(num_points, np.int64)
    for i, p in enumerate(point_idx):
        lists[p, fill[p]] = i
        fill[p] += 1
    return BAObservations(
        jnp.asarray(frame_idx, jnp.int32),
        jnp.asarray(point_idx, jnp.int32),
        jnp.asarray(uv, jnp.float32),
        jnp.ones((o,), bool),
        jnp.asarray(lists, jnp.int32),
    )


def _residuals_jacobians(poses, points, obs, fx, fy, cx, cy):
    """Per-observation r (O, 2), J_pose (O, 2, 6), J_point (O, 2, 3), w (O,)."""
    T = poses[obs.frame]  # (O, 4, 4)
    pw = points[obs.point]  # (O, 3)
    pc = jnp.einsum("oij,oj->oi", T[:, :3, :3], pw) + T[:, :3, 3]
    z = pc[:, 2]
    zs = jnp.where(z > 1e-6, z, 1.0)
    u = pc[:, 0] / zs * fx + cx
    v = pc[:, 1] / zs * fy + cy
    r = jnp.stack([u, v], -1) - obs.uv
    w = (obs.valid & (z > 1e-6)).astype(jnp.float32)

    iz = 1.0 / zs
    # d(u,v)/d p_cam  (O, 2, 3)
    J_pc = jnp.stack(
        [
            jnp.stack([fx * iz, jnp.zeros_like(z), -fx * pc[:, 0] * iz * iz], -1),
            jnp.stack([jnp.zeros_like(z), fy * iz, -fy * pc[:, 1] * iz * iz], -1),
        ],
        axis=1,
    )
    # pose: p_cam = exp(xi) T p_w => dp/dxi = [I | -[p_cam]_x]
    Jp_lin = J_pc
    Jp_ang = jnp.einsum("okj,oji->oki", J_pc, -se3.skew(pc))
    J_pose = jnp.concatenate([Jp_lin, Jp_ang], axis=-1)  # (O, 2, 6)
    J_point = jnp.einsum("okj,oji->oki", J_pc, T[:, :3, :3])  # (O, 2, 3)
    return r, J_pose, J_point, w


@functools.partial(jax.jit, static_argnames=("num_frames", "num_points"))
def ba_cost(problem: BAProblem, fx, fy, cx, cy, num_frames: int, num_points: int):
    r, _, _, w = _residuals_jacobians(problem.poses, problem.points, problem.obs, fx, fy, cx, cy)
    return jnp.sum(w * jnp.sum(r * r, -1)), jnp.sum(w)


@functools.partial(jax.jit, static_argnames=("num_frames", "num_points"))
def ba_step(
    problem: BAProblem,
    lam: jax.Array,
    fx, fy, cx, cy,
    num_frames: int,
    num_points: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """One damped step: returns (new_poses, new_points, predicted_ok).

    Schur complement as ONE dense matmul (the array-first formulation):
    the block-sparse cross term W (6F x 3P, one 6x3 block per observation)
    is scatter-assembled dense, the point-block inverse is applied as a
    batched (P, 3, 3) einsum, and S = U_diag - (W V^-1) W^T is one large matmul
    as a (6F, 3P) x (3P, 6F) contraction. This removes the r3 path's
    (P, Omax, Omax, 6, 6) pair tensor (7+ GB at P=20k, Omax=50) — memory
    is now 2 * 6F * 3P floats (288 MB at the F=200/P=20k/O=100k target
    scale) and the pair reduction is pure matmul FLOPs. (ref: the
    Eigen block products + SimplicialLDLT of BundleAdjustment.cpp:219-234.)
    """
    poses, points, obs = problem
    F, P = num_frames, num_points
    r, J_pose, J_point, w = _residuals_jacobians(poses, points, obs, fx, fy, cx, cy)

    U = jnp.zeros((F, 6, 6)).at[obs.frame].add(
        jnp.einsum("oki,o,okj->oij", J_pose, w, J_pose)
    )
    V = jnp.zeros((P, 3, 3)).at[obs.point].add(
        jnp.einsum("oki,o,okj->oij", J_point, w, J_point)
    )
    W = jnp.einsum("oki,o,okj->oij", J_pose, w, J_point)  # (O, 6, 3)
    b_c = jnp.zeros((F, 6)).at[obs.frame].add(jnp.einsum("oki,o,ok->oi", J_pose, w, r))
    b_p = jnp.zeros((P, 3)).at[obs.point].add(jnp.einsum("oki,o,ok->oi", J_point, w, r))

    # LM damping, Marquardt (diagonal-scaled) form. The reference adds an
    # absolute lambda (BundleAdjustment.cpp:175-187) but INITIALISES it from
    # the max diagonal (:48-58), i.e. its damping is diagonal-relative too.
    # An absolute 1e-4 vanishes in f32 once diagonals reach ~1e4 (eps(2e4) =
    # 2e-3), leaving near-singular V blocks whose f32 inverse NaNs.
    def damp(M, eye):
        d = jnp.einsum("bii->b", M) / eye.shape[0]
        return M + (lam * jnp.abs(M) + (1e-6 * d[:, None, None] + 1e-9)) * eye

    U = damp(U, jnp.eye(6))
    V = damp(V, jnp.eye(3))
    Vinv = jnp.linalg.inv(V)  # batched 3x3

    # dense block-sparse W: (F, 6, P, 3), one block per observation
    Wd = jnp.zeros((F, 6, P, 3)).at[obs.frame, :, obs.point, :].add(W)
    Y = jnp.einsum("fipk,pkl->fipl", Wd, Vinv)  # W V^-1, (F, 6, P, 3)
    Ym = Y.reshape(F * 6, P * 3)
    Wm = Wd.reshape(F * 6, P * 3)
    S = -Ym @ Wm.T  # (6F, 6F) — one matmul does the pair reduction
    fi = jnp.arange(F * 6).reshape(F, 6)
    S = S.at[fi[:, :, None], fi[:, None, :]].add(U)
    rhs_c = b_c.reshape(F * 6) - Ym @ b_p.reshape(P * 3)

    A = S[6:, 6:]
    # scale-aware jitter + LU (not Cholesky): at 10^4+ observations the f32
    # cancellation in U - W V^-1 W^T can leave S very slightly indefinite,
    # which NaNs a Cholesky; pivoted LU still produces a usable GN
    # direction and the LM rollback guards step quality.
    jitter = 1e-7 * jnp.mean(jnp.diag(A)) + 1e-9
    A = A + jitter * jnp.eye(6 * (F - 1))
    dc = jnp.linalg.solve(0.5 * (A + A.T), -rhs_c[6:])
    ok = jnp.all(jnp.isfinite(dc))
    dc = jnp.where(ok, dc, 0.0)
    delta_c = jnp.concatenate([jnp.zeros((1, 6)), dc.reshape(F - 1, 6)], axis=0)

    # back-substitute points: dp = -V^-1 (b_p + W^T dc)
    wtdc = (Wm.T @ delta_c.reshape(F * 6)).reshape(P, 3)
    dp = -jnp.einsum("pij,pj->pi", Vinv, b_p + wtdc)
    dp = jnp.where(ok, dp, 0.0)

    new_poses = jnp.einsum("fij,fjk->fik", se3.se3_exp(delta_c), poses)
    new_points = points + dp
    return new_poses, new_points, ok


# Depth-noise model for observation weighting: sigma(z) = A + B (z-0.4)^2
# (Khoshelham & Elberink 2012's Kinect axial fit — the same model
# utils/synthetic.corrupt_rgbd injects). The 3-D residual is weighted
# 1/sigma(z)^2 (heteroscedastic MLE: a far observation's 14 mm noise must
# not outvote a near one's 1.5 mm) and the Huber kernel operates in
# sigma-normalised units. Alternatives MEASURED and rejected on the
# clean/corrupted 16-frame + 100-frame suites: fixed-delta Huber (noise-
# blind, collapses under real sigma(z)), camera-frame anisotropic
# lateral/axial weights, and a hybrid [pixel, pixel, depth] residual —
# both of the latter over-trust lateral/pixel rows whose true error is
# dominated by integer-pixel FAST keypoints and matching jitter, not the
# depth model (clean-loop ATE 27-32 mm vs 18 mm for this form).
SIGMA_Z_A = 0.0015  # m — floor: quantisation + residual calibration
SIGMA_Z_B = 0.0019  # m^-1
HUBER_DELTA_SIGMA = 3.0  # residuals past 3 sigma are outlier-regime


def _residuals_jacobians_3d(poses, points, obs: BAObservations, pc_obs, fx, fy, cx, cy):
    """RGB-D observation model: 3-D point residual in the camera frame.

    r = T_cw p_w - p_obs with p_obs the depth-backprojected keypoint;
    J_pose = [I | -[p_cam]_x], J_point = R_cw. Unlike the reference's
    2-D-only model (BundleAdjustment.cpp:290-331) the depth information
    anchors scale and depth directly — no 7th gauge freedom, well
    conditioned on short tracks. Weights are per-component (O, 3) for
    uniformity with the step/cost plumbing (isotropic here; see the
    constants block for what was tried and rejected)."""
    T = poses[obs.frame]
    pw = points[obs.point]
    pc = jnp.einsum("oij,oj->oi", T[:, :3, :3], pw) + T[:, :3, 3]
    r = pc - pc_obs
    z_obs = jnp.maximum(pc_obs[:, 2], 0.0)
    sigma = SIGMA_Z_A + SIGMA_Z_B * jnp.square(jnp.maximum(z_obs - 0.4, 0.0))
    rn = jnp.linalg.norm(r, axis=-1) / sigma
    w_huber = jnp.minimum(1.0, HUBER_DELTA_SIGMA / jnp.clip(rn, 1e-9, None))
    w = (obs.valid.astype(jnp.float32) * w_huber / jnp.square(sigma))[:, None]
    w = jnp.broadcast_to(w, r.shape)
    O = r.shape[0]
    I3 = jnp.broadcast_to(jnp.eye(3), (O, 3, 3))
    J_pose = jnp.concatenate([I3, -se3.skew(pc)], axis=-1)  # (O, 3, 6)
    J_point = T[:, :3, :3]  # (O, 3, 3)
    return r, J_pose, J_point, w


def _ba_step_masked(poses, points, obs: BAObservations, solve_frame, lam, fx, fy, cx, cy, pc_obs=None):
    """One damped LM step over CAPACITY-PADDED arrays, fully on device.

    Same Schur-as-matmul formulation as `ba_step`, but sized by the array
    capacities rather than the live problem: `obs.valid` masks padding
    observations, `solve_frame` (F,) masks which pose blocks the reduced
    camera system actually solves (False rows get an identity row and a
    zero delta — this is how both the pose-0 gauge fix and capacity
    padding are expressed). Padding points have zero J columns, so their
    damped V inverts to a large diagonal that multiplies zeros — no point
    mask is needed. Used by the device LM loop (`optimize_device`), which
    systems/fused_ba.py traces into its per-chunk program.
    (ref: BundleAdjustment.cpp:113-287 — the LM outer loop this replaces.)
    """
    F = poses.shape[0]
    P = points.shape[0]
    if pc_obs is None:
        r, J_pose, J_point, w = _residuals_jacobians(poses, points, obs, fx, fy, cx, cy)
    else:
        r, J_pose, J_point, w = _residuals_jacobians_3d(poses, points, obs, pc_obs, fx, fy, cx, cy)
    if w.ndim == 1:  # scalar weights (2-D model) -> per-component
        w = jnp.broadcast_to(w[:, None], r.shape)

    U = jnp.zeros((F, 6, 6)).at[obs.frame].add(
        jnp.einsum("oki,ok,okj->oij", J_pose, w, J_pose)
    )
    V = jnp.zeros((P, 3, 3)).at[obs.point].add(
        jnp.einsum("oki,ok,okj->oij", J_point, w, J_point)
    )
    W = jnp.einsum("oki,ok,okj->oij", J_pose, w, J_point)
    b_c = jnp.zeros((F, 6)).at[obs.frame].add(jnp.einsum("oki,ok,ok->oi", J_pose, w, r))
    b_p = jnp.zeros((P, 3)).at[obs.point].add(jnp.einsum("oki,ok,ok->oi", J_point, w, r))

    def damp(M, eye):
        d = jnp.einsum("bii->b", M) / eye.shape[0]
        return M + (lam * jnp.abs(M) + (1e-6 * d[:, None, None] + 1e-9)) * eye

    U = damp(U, jnp.eye(6))
    V = damp(V, jnp.eye(3))
    Vinv = jnp.linalg.inv(V)

    Wd = jnp.zeros((F, 6, P, 3)).at[obs.frame, :, obs.point, :].add(W)
    Y = jnp.einsum("fipk,pkl->fipl", Wd, Vinv)
    Ym = Y.reshape(F * 6, P * 3)
    Wm = Wd.reshape(F * 6, P * 3)
    S = -Ym @ Wm.T
    fi = jnp.arange(F * 6).reshape(F, 6)
    S = S.at[fi[:, :, None], fi[:, None, :]].add(U)
    rhs_c = b_c.reshape(F * 6) - Ym @ b_p.reshape(P * 3)

    act = jnp.repeat(solve_frame.astype(poses.dtype), 6)  # (6F,)
    A = S * (act[:, None] * act[None, :]) + jnp.diag(1.0 - act)
    diag = jnp.diagonal(A)
    jitter = 1e-7 * jnp.sum(diag * act) / jnp.clip(jnp.sum(act), 1.0) + 1e-9
    A = A + jitter * jnp.eye(F * 6, dtype=A.dtype)
    rhs = rhs_c * act
    dc = jnp.linalg.solve(0.5 * (A + A.T), -rhs)
    ok = jnp.all(jnp.isfinite(dc))
    dc = jnp.where(ok, dc * act, 0.0)
    delta_c = dc.reshape(F, 6)

    wtdc = (Wm.T @ dc).reshape(P, 3)
    dp = -jnp.einsum("pij,pj->pi", Vinv, b_p + wtdc)
    dp = jnp.where(ok, dp, 0.0)

    new_poses = jnp.einsum("fij,fjk->fik", se3.se3_exp(delta_c), poses)
    new_points = points + dp
    return new_poses, new_points, ok


def optimize_device(
    poses, points, obs: BAObservations, solve_frame,
    fx, fy, cx, cy,
    max_iters: int = 10,
    lam0: float = 3e-5,
    anchor_scale: bool = True,
    pc_obs=None,
):
    """Whole LM loop (step + cost + accept/rollback + damping schedule) as
    traced device code — zero host round trips, callable from inside a
    larger jitted program (systems/fused_ba.py runs it per chunk).

    Matches `optimize`'s semantics: lambda x0.7 on cost decrease, x2 +
    rollback on increase (ref: BundleAdjustment.cpp:248-280), plus the
    7th-gauge scale re-anchor that pins the pose0->pose1 baseline length
    (see `optimize`'s docstring). With `pc_obs` (O, 3) the observation
    model switches to 3-D camera-frame residuals
    (`_residuals_jacobians_3d`) — scale is then observable and
    `anchor_scale` should be False. Returns (poses, points, mean sq err).
    """

    def cost_of(ps, pt):
        if pc_obs is None:
            r, _, _, w = _residuals_jacobians(ps, pt, obs, fx, fy, cx, cy)
        else:
            r, _, _, w = _residuals_jacobians_3d(ps, pt, obs, pc_obs, fx, fy, cx, cy)
        if w.ndim == 1:
            w = jnp.broadcast_to(w[:, None], r.shape)
        return jnp.sum(w * r * r), jnp.sum(w)

    def center(T_cw):
        return -T_cw[:3, :3].T @ T_cw[:3, 3]

    c0 = center(poses[0])
    baseline0 = jnp.linalg.norm(center(poses[1]) - c0)

    cost0, _ = cost_of(poses, points)

    def body(_, carry):
        ps, pt, lam, cost = carry
        np_, npt, ok = _ba_step_masked(
            ps, pt, obs, solve_frame, lam, fx, fy, cx, cy, pc_obs=pc_obs
        )
        new_cost, _ = cost_of(np_, npt)
        accept = ok & jnp.isfinite(new_cost) & (new_cost < cost)

        def sel(a, b):
            return jnp.where(accept, a, b)

        ps = jnp.where(accept, np_, ps)
        pt = jnp.where(accept, npt, pt)
        lam = sel(jnp.maximum(lam * 0.7, 1e-9), jnp.minimum(lam * 2.0, 1e6))
        cost = sel(new_cost, cost)
        return ps, pt, lam, cost

    poses, points, _, cost = jax.lax.fori_loop(
        0, max_iters, body, (poses, points, jnp.float32(lam0), cost0)
    )

    if anchor_scale:
        baseline1 = jnp.linalg.norm(center(poses[1]) - c0)
        s = jnp.where(
            (baseline0 > 1e-9) & (baseline1 > 1e-9), baseline0 / baseline1, 1.0
        )
        R = poses[:, :3, :3]
        centers = -jnp.einsum("fji,fj->fi", R, poses[:, :3, 3])
        new_centers = c0[None] + s * (centers - c0[None])
        new_t = -jnp.einsum("fij,fj->fi", R, new_centers)
        poses = poses.at[:, :3, 3].set(new_t)
        points = c0[None] + s * (points - c0[None])
        cost, _ = cost_of(poses, points)

    _, wsum = cost_of(poses, points)
    return poses, points, cost / jnp.clip(wsum, 1.0)


def optimize(
    problem: BAProblem,
    fx: float, fy: float, cx: float, cy: float,
    max_iters: int = DEFAULT_MAX_ITERS,
    lam0: float = 3e-5,
    anchor_scale: bool = True,
    verbose: bool = False,
) -> tuple[BAProblem, float]:
    """LM loop with rollback (host-controlled like the reference's outer loop).

    `anchor_scale`: pure-2D reprojection BA has a 7th gauge freedom —
    uniformly scaling all camera centers and points about the fixed pose 0
    leaves every reprojection unchanged, so LM can silently drift the
    metric scale the depth-initialised points carried. After the loop the
    solution is re-scaled (a zero-cost gauge transform) so the pose-0 ->
    pose-1 baseline keeps its initial length.

    Returns (optimized problem, final mean squared reprojection error).
    """
    F = problem.poses.shape[0]
    P = problem.points.shape[0]

    def center(T_cw):
        R = T_cw[:3, :3]
        return -R.T @ T_cw[:3, 3]

    init_poses = np.asarray(problem.poses)
    c0 = center(init_poses[0])
    baseline0 = float(np.linalg.norm(center(init_poses[1]) - c0)) if F >= 2 else 0.0

    lam = lam0
    cost, wsum = ba_cost(problem, fx, fy, cx, cy, F, P)
    cost = float(cost)
    for it in range(max_iters):
        new_poses, new_points, _ = ba_step(
            problem, jnp.float32(lam), fx, fy, cx, cy, F, P
        )
        cand = BAProblem(new_poses, new_points, problem.obs)
        new_cost = float(ba_cost(cand, fx, fy, cx, cy, F, P)[0])
        if new_cost < cost:
            problem = cand
            cost = new_cost
            lam = max(lam * 0.7, 1e-9)  # ref: lambda x0.7 on success
        else:
            lam = min(lam * 2.0, 1e6)  # ref: x2 + rollback on failure
        if verbose:
            print(f"BA iter {it}: cost {cost:.6f} lam {lam:.2e}")

    if anchor_scale and F >= 2 and baseline0 > 1e-9:
        poses_o = np.asarray(problem.poses)
        baseline1 = float(np.linalg.norm(center(poses_o[1]) - c0))
        if baseline1 > 1e-9:
            s = baseline0 / baseline1
            new_poses = poses_o.copy()
            for i in range(F):
                R = poses_o[i, :3, :3]
                ci = c0 + s * (center(poses_o[i]) - c0)
                new_poses[i, :3, 3] = -R @ ci
            new_points = c0[None] + s * (np.asarray(problem.points) - c0[None])
            problem = BAProblem(
                jnp.asarray(new_poses), jnp.asarray(new_points), problem.obs
            )
            cost = float(ba_cost(problem, fx, fy, cx, cy, F, P)[0])

    denom = float(ba_cost(problem, fx, fy, cx, cy, F, P)[1])
    return problem, cost / max(denom, 1.0)
