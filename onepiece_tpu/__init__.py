"""onepiece_tpu — a device-resident RGB-D SLAM & 3D reconstruction framework.

A from-scratch rebuild of the capabilities of the OnePiece C++ library
(reference: wlsdzyzl/OnePiece), designed array-first in JAX:

- All hot kernels (dense RGB-D odometry, ICP, TSDF integration, marching
  cubes, bundle-adjustment Schur reduction) are JAX/XLA programs.
- Irregular, data-dependent bookkeeping (voxel-block hash tables, keyframe
  lists, RANSAC orchestration) lives on the host; device code works over
  fixed-capacity padded pools with validity masks.
- Multi-device scaling uses `jax.sharding.Mesh` + `shard_map` with XLA
  collectives (psum for BA Schur reduction, sharded voxel-block pools).

Layer map (mirrors reference SURVEY.md §1, re-designed):
  geometry/     core math: SE3, camera, point clouds, meshes     (ref: src/Geometry, src/Camera)
  ops/          device kernels & batched numerics                (ref: hot loops across src/)
  odometry/     sparse ORB + dense direct RGB-D tracking         (ref: src/Odometry)
  lcdetection/  loop-closure detection (MILD-equivalent)         (ref: src/LCDetection, 3rdparty/MILD)
  registration/ ICP, FPFH, global RANSAC registration            (ref: src/Registration)
  optimization/ pose-graph GN and full BA with Schur             (ref: src/Optimization)
  integration/  voxel-block TSDF + marching cubes                (ref: src/Integration)
  algorithm/    clustering, patch detection, DCEL rooms          (ref: src/Algorithm)
  parallel/     device-mesh sharding of BA and TSDF pools
  systems/      end-to-end SLAM systems (Dense/BA/FBA fusion)    (ref: example/)
  io/           TUM/ScanNet loaders, PLY/OBJ, trajectories       (ref: src/Tool/IO*)
  utils/        config, timers, metrics, logging
  viz/          offline rendering / debug dumps                  (ref: src/Visualization)
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry math (SE3 chains, 6x6 normal equations, 3x3 covariances) must not
# silently run matmuls at reduced precision: TF32 or bf16 would inject
# ~1e-3..1e-2 errors into Rodrigues/Kabsch. Matmuls that tolerate less opt
# out explicitly with a `precision` argument.
_jax.config.update("jax_default_matmul_precision", "highest")
