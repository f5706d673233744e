"""Pinhole camera model as a JAX pytree.

Replacement for `camera::PinholeCamera` (ref: src/Camera/Camera.h:38-119):
intrinsics live in a small frozen dataclass that is a pytree leaf-holder so a
camera can flow through jit boundaries; projection / back-projection are
batched array ops. Preset intrinsics match the reference's hard-coded camera
types (ref: src/Camera/Camera.h:77-119).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    """Intrinsics. width/height/depth_scale are static metadata fields."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int = dataclasses.field(metadata=dict(static=True))
    height: int = dataclasses.field(metadata=dict(static=True))
    depth_scale: float = dataclasses.field(metadata=dict(static=True))

    def next_pyramid_level(self) -> "PinholeCamera":
        """Camera for the half-resolution pyramid level.

        (ref: src/Camera/Camera.h:38-42 `GenerateNextPyramid`): intrinsics
        halve with image size; principal point follows the pyrDown grid.
        """
        return PinholeCamera(
            fx=self.fx * 0.5,
            fy=self.fy * 0.5,
            cx=(self.cx + 0.5) * 0.5 - 0.5,
            cy=(self.cy + 0.5) * 0.5 - 0.5,
            width=self.width // 2,
            height=self.height // 2,
            depth_scale=self.depth_scale,
        )

    def pyramid(self, levels: int) -> tuple["PinholeCamera", ...]:
        cams = [self]
        for _ in range(levels - 1):
            cams.append(cams[-1].next_pyramid_level())
        return tuple(cams)

    # -- device math ------------------------------------------------------

    def project(self, pts: jax.Array) -> tuple[jax.Array, jax.Array]:
        """Camera-frame points (..., 3) -> pixel coords (..., 2) [u, v], depth (...,)."""
        z = pts[..., 2]
        zsafe = jnp.where(jnp.abs(z) > 1e-9, z, 1e-9)
        u = pts[..., 0] / zsafe * self.fx + self.cx
        v = pts[..., 1] / zsafe * self.fy + self.cy
        return jnp.stack([u, v], axis=-1), z

    def backproject_grid(self, depth: jax.Array) -> jax.Array:
        """Depth image (H, W) -> camera-frame XYZ image (H, W, 3).

        Vectorised form of the per-pixel backprojection the reference does in
        `GetPcdFromDepth`-style loops (ref: src/Geometry/Geometry.cpp:72-106):
        one broadcasted iota instead of a pixel loop.
        """
        h, w = depth.shape
        v = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
        u = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
        x = (u - self.cx) / self.fx * depth
        y = (v - self.cy) / self.fy * depth
        return jnp.stack([x, y, depth], axis=-1)

    def backproject(self, uv: jax.Array, depth: jax.Array) -> jax.Array:
        """Pixels (..., 2) + depths (...,) -> camera-frame points (..., 3)."""
        x = (uv[..., 0] - self.cx) / self.fx * depth
        y = (uv[..., 1] - self.cy) / self.fy * depth
        return jnp.stack([x, y, depth], axis=-1)

    def in_bounds(self, uv: jax.Array, margin: float = 0.0) -> jax.Array:
        """Mask (...,) of pixel coords inside the image with a border margin."""
        u, v = uv[..., 0], uv[..., 1]
        return (
            (u >= margin)
            & (u <= self.width - 1 - margin)
            & (v >= margin)
            & (v <= self.height - 1 - margin)
        )

    def intrinsic_matrix(self) -> jax.Array:
        return jnp.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=jnp.float32,
        )


# Preset intrinsics (values from ref: src/Camera/Camera.h:77-119; distortion
# coefficients are ignored — the reference never undistorts either).
TUM_CAMERA = PinholeCamera(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640, height=480, depth_scale=5000.0)
OPEN3D_CAMERA = PinholeCamera(fx=514.817, fy=515.375, cx=318.771, cy=238.447, width=640, height=480, depth_scale=1000.0)
MI_CAMERA = PinholeCamera(fx=2209.84366, fy=2210.23057, cx=756.24762, cy=530.00418, width=1440, height=1080, depth_scale=1000.0)

PRESETS = {"tum": TUM_CAMERA, "open3d": OPEN3D_CAMERA, "mi": MI_CAMERA}
