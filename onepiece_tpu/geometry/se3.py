"""SE(3) / SO(3) Lie-group math, batched-first.

Provides the functionality the reference gets from Sophus
(ref: src/Geometry/Geometry.cpp:9-18 `Se3ToSE3`/`SE3ToSe3`) as pure JAX,
written so every function vmaps cleanly. Twist convention matches the
reference/Sophus: ``xi = (rho, phi)`` with translation part first and the
exponential ``exp(xi) = [exp(phi_x) | V(phi) rho]``.

All functions take/return float32 arrays by default (the reference's
default scalar, ref: src/Geometry/Geometry.h:29-33).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def skew(v: jax.Array) -> jax.Array:
    """Skew-symmetric matrix [v]_x  (ref: src/Geometry/Geometry.cpp:264-271).

    v: (..., 3) -> (..., 3, 3)
    """
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(phi: jax.Array) -> jax.Array:
    """Rodrigues: axis-angle (..., 3) -> rotation matrix (..., 3, 3).

    Taylor-guarded near theta=0 so it is jit/grad safe everywhere.
    """
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    # sin(t)/t and (1-cos t)/t^2 with small-angle Taylor fallback
    use_taylor = theta2 < 1e-8
    a = jnp.where(use_taylor, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(use_taylor, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / (theta2 + _EPS * _EPS))
    K = skew(phi)
    KK = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * KK


def so3_log(R: jax.Array) -> jax.Array:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3).

    Uses the numerically-stable quaternion-free formulation with guards at
    theta ~ 0 and theta ~ pi.
    """
    trace = jnp.trace(R, axis1=-2, axis2=-1)
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    # antisymmetric part -> axis * sin(theta)
    w = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_theta = jnp.sin(theta)
    small = theta < 1e-4
    near_pi = theta > jnp.pi - 1e-3
    # generic: w * theta / (2 sin theta); small-angle: w * (0.5 + theta^2/12)
    scale = jnp.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / (2.0 * jnp.where(small | near_pi, 1.0, sin_theta)),
    )
    phi_generic = w * scale[..., None]
    # near pi: axis from diagonal of (R + I)/2 = I - (1-cos)K^2 ... use
    # B = (R + R^T)/2 ; axis_i = sqrt((B_ii - cos)/ (1-cos))
    Bdiag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis2 = jnp.clip(
        (Bdiag - cos_theta[..., None]) / jnp.clip(1.0 - cos_theta[..., None], 1e-9, None),
        0.0,
        1.0,
    )
    axis = jnp.sqrt(axis2)
    # fix signs from off-diagonals: sign(axis_x) taken +, others from R products
    sx = jnp.ones_like(axis[..., 0])
    sy = jnp.where(R[..., 0, 1] + R[..., 1, 0] >= 0.0, 1.0, -1.0)
    sz = jnp.where(R[..., 0, 2] + R[..., 2, 0] >= 0.0, 1.0, -1.0)
    axis = axis * jnp.stack([sx, sy, sz], axis=-1)
    nrm = jnp.linalg.norm(axis, axis=-1, keepdims=True)
    axis = axis / jnp.clip(nrm, 1e-9, None)
    phi_pi = axis * theta[..., None]
    return jnp.where(near_pi[..., None], phi_pi, phi_generic)


def _so3_left_jacobian(phi: jax.Array) -> jax.Array:
    """V(phi): the SO(3) left Jacobian, used by se3 exp. (..., 3) -> (..., 3, 3)."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    use_taylor = theta2 < 1e-8
    b = jnp.where(use_taylor, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / (theta2 + _EPS * _EPS))
    c = jnp.where(
        use_taylor,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - jnp.sin(theta)) / (theta2 * theta + _EPS * _EPS * _EPS),
    )
    K = skew(phi)
    KK = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + b[..., None, None] * K + c[..., None, None] * KK


def _so3_left_jacobian_inv(phi: jax.Array) -> jax.Array:
    """V(phi)^-1. (..., 3) -> (..., 3, 3)."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    use_taylor = theta2 < 1e-8
    half = 0.5 * theta
    cot_term = jnp.where(
        use_taylor,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * jnp.cos(half) / jnp.where(use_taylor, 1.0, jnp.sin(half))) / (theta2 + _EPS * _EPS),
    )
    K = skew(phi)
    KK = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye - 0.5 * K + cot_term[..., None, None] * KK


def se3_exp(xi: jax.Array) -> jax.Array:
    """Twist (..., 6) [rho, phi] -> homogeneous transform (..., 4, 4).

    Batched replacement of `Se3ToSE3` (ref: src/Geometry/Geometry.cpp:9-13).
    """
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = _so3_left_jacobian(phi)
    t = jnp.einsum("...ij,...j->...i", V, rho)
    return make_T(R, t)


def se3_log(T: jax.Array) -> jax.Array:
    """Homogeneous transform (..., 4, 4) -> twist (..., 6) [rho, phi].

    Batched replacement of `SE3ToSe3` (ref: src/Geometry/Geometry.cpp:14-18).
    """
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    Vinv = _so3_left_jacobian_inv(phi)
    rho = jnp.einsum("...ij,...j->...i", Vinv, t)
    return jnp.concatenate([rho, phi], axis=-1)


def make_T(R: jax.Array, t: jax.Array) -> jax.Array:
    """Assemble (..., 4, 4) from (..., 3, 3) and (..., 3)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (4,)
    )[..., None, :]
    return jnp.concatenate([top, bottom], axis=-2)


def inverse_T(T: jax.Array) -> jax.Array:
    """Closed-form SE(3) inverse: [R^T | -R^T t]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return make_T(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


def transform_points(T: jax.Array, pts: jax.Array) -> jax.Array:
    """Apply (..., 4, 4) to (..., N, 3) -> (..., N, 3).

    (ref: src/Geometry/Geometry.cpp:19-34 `TransformPoints`)
    """
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return jnp.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def transform_normals(T: jax.Array, normals: jax.Array) -> jax.Array:
    """Rotate normals by the rotation part of T (rigid transform, so R^-T = R)."""
    R = T[..., :3, :3]
    return jnp.einsum("...ij,...nj->...ni", R, normals)
