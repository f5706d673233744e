"""Pixel-sharded dense odometry over a device mesh.

The reference's per-frame hot loop is single-threaded C++ (SURVEY §2.10); the
device scaling axis for it is pixel data-parallelism: source pixels are
sharded over the mesh's data axis, every device computes the 6x6 partial
normal equations for its shard, and one `psum` reduces them — the solve is
6x6 and runs replicated. The interconnect carries 36+6 floats per iteration:
negligible.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..geometry import se3
from ..geometry.camera import PinholeCamera
from ..odometry import dense
from ..ops import dense_odometry as dops


def _pad_to_multiple(x: jax.Array, m: int) -> jax.Array:
    n = x.shape[0]
    pad = (-n) % m
    if pad == 0:
        return x
    cfg = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, cfg)


def dense_tracking_sharded(
    source: dense.FramePyramid,
    target: dense.FramePyramid,
    camera: PinholeCamera,
    mesh: Mesh,
    axis: str = "d",
    iters: tuple[int, ...] = dense.DEFAULT_ITERS,
    lambda_depth: float = dense.LAMBDA_HYBRID_DEPTH,
) -> dense.DenseTrackingResult:
    """Multi-scale dense tracking with pixels sharded over `mesh[axis]`.

    Target pyramids are replicated (a few MB); source pixel arrays are
    sharded. Identical math to odometry.dense.dense_tracking.
    """
    n_dev = mesh.shape[axis]
    levels = len(source.grays)
    cams = camera.pyramid(levels)
    T = jnp.eye(4, dtype=jnp.float32)
    ne = None
    for li in reversed(range(levels)):
        tgt = dops.build_term_data(target.grays[li], target.depths[li], dense.SOBEL_SCALE)
        src_pts = _pad_to_multiple(source.xyzs[li].reshape(-1, 3), n_dev)
        src_gray = _pad_to_multiple(source.grays[li].reshape(-1), n_dev)
        src_valid = _pad_to_multiple((source.xyzs[li][..., 2] > 0).reshape(-1), n_dev)
        cam = cams[li]
        n_it = iters[levels - 1 - li]

        @jax.jit
        @functools.partial(
            shard_map,
            mesh=mesh,
            in_specs=(P(), P(axis), P(axis), P(axis), P()),
            out_specs=(P(), P(), P(), P()),
            check_vma=False,
        )
        def level_step(T0, pts, gray, valid, _tgt, _cam=cam, _n=n_it):
            def body(_, carry):
                Tc, _ne = carry
                part = dops.normal_equations(
                    Tc, pts, gray, valid, _tgt,
                    jnp.float32(_cam.fx), jnp.float32(_cam.fy),
                    jnp.float32(_cam.cx), jnp.float32(_cam.cy),
                    jnp.float32(lambda_depth), jnp.float32(dense.DEPTH_DIFF_MAX),
                )
                full = dops.NormalEquations(
                    jax.lax.psum(part.JTJ, axis),
                    jax.lax.psum(part.JTr, axis),
                    jax.lax.psum(part.cost, axis),
                    jax.lax.psum(part.num_inliers, axis),
                )
                return dops.solve_and_update(Tc, full), full

            ne0 = dops.NormalEquations(
                jnp.zeros((6, 6), jnp.float32), jnp.zeros((6,), jnp.float32),
                jnp.float32(0.0), jnp.float32(0.0),
            )
            Tn, nef = jax.lax.fori_loop(0, _n, body, (T0, ne0))
            return Tn, nef.cost, nef.num_inliers, nef.JTr

        T, cost, cnt, _ = level_step(T, src_pts, src_gray, src_valid, tgt)
        ne = (cost, cnt)
    rmse = jnp.sqrt(ne[0] / jnp.clip(ne[1], 1.0, None))
    return dense.DenseTrackingResult(T, ne[0], ne[1], rmse)
