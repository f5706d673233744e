"""Reference-binary TSDF volume interop.

Reads/writes the C++ reference's sparse cube file format so volumes can be
exchanged with reference-produced files (ref: src/Integration/CubeHandler.h
:40-128 ReadFromFile/WriteToFile, VoxelCube.h:128-167 WriteToBuffer/
ReadFromBuffer; consumed by example/MergeMultipleSubmaps.cpp:34-42 and
FBAFusion.cpp:96). Format, reverse-engineered from the spec (all 32-bit
little-endian float words):

  word 0          : cube count, stored as a uint32 BIT-PATTERN in the
                    float slot (the reference reinterprets the bytes)
  per cube        : cube_id x, y, z as floats, then for every voxel with
                    |sdf| < 1 and weight != 0 a 6-word run
                    [voxel_index, sdf, weight, r, g, b], then a -2.0
                    terminator word
  voxel index     : x + 8*y + 64*z (x fastest, ref VoxelCube.h:81-86);
                    this module permutes to/from the pool layout's
                    64*x + 8*y + z (z fastest, integration/blocks.py)

sdf is truncation-normalised ([-1, 1]) in both systems; colors are [0, 1]
floats.
"""

from __future__ import annotations

import numpy as np

from ..integration.blocks import TSDFVolume
from ..ops.tsdf import CUBE_SIZE

N = CUBE_SIZE
NV = N**3

# permutation between the reference's x-fastest linear voxel index and the
# pool's z-fastest one. ref_of_pool[pool_idx] = ref_idx
_x, _y, _z = np.meshgrid(np.arange(N), np.arange(N), np.arange(N), indexing="ij")
_REF_OF_POOL = (_x + N * _y + N * N * _z).reshape(-1)  # pool idx (x*64+8y+z) -> ref idx
_POOL_OF_REF = np.empty(NV, np.int64)
_POOL_OF_REF[_REF_OF_POOL] = np.arange(NV)


def write_ref_tsdf(path: str, vol: TSDFVolume) -> None:
    """Write a TSDFVolume in the reference's binary cube format."""
    na = vol.num_active
    sdf = np.asarray(vol.sdf[:na]).reshape(na, NV)
    wgt = np.asarray(vol.weight[:na]).reshape(na, NV)
    col = np.asarray(vol.color[:na]).reshape(na, NV, 3)
    coords = np.asarray(vol.block_coords[:na])

    words: list[np.ndarray] = []
    header = np.zeros(1, np.float32)
    header.view(np.uint32)[0] = np.uint32(na)
    words.append(header)
    for b in range(na):
        words.append(coords[b].astype(np.float32))
        keep = (np.abs(sdf[b]) < 1.0) & (wgt[b] != 0.0)
        idx_pool = np.nonzero(keep)[0]
        if len(idx_pool):
            runs = np.empty((len(idx_pool), 6), np.float32)
            runs[:, 0] = _REF_OF_POOL[idx_pool].astype(np.float32)
            runs[:, 1] = sdf[b, idx_pool]
            runs[:, 2] = wgt[b, idx_pool]
            runs[:, 3:6] = col[b, idx_pool]
            words.append(runs.reshape(-1))
        words.append(np.float32([-2.0]))
    np.concatenate(words).astype("<f4").tofile(path)


def read_ref_tsdf(path: str, voxel_size: float = 0.0125, truncation: float = 0.1) -> TSDFVolume:
    """Read a reference-format binary cube file into a TSDFVolume."""
    buf = np.fromfile(path, dtype="<f4")
    count = int(buf[:1].view(np.uint32)[0])
    cap = max(1, 1 << (max(count, 1) - 1).bit_length())
    vol = TSDFVolume(voxel_size=voxel_size, truncation=truncation, capacity=cap)
    sdf = np.asarray(vol.sdf).copy().reshape(cap, NV)
    wgt = np.asarray(vol.weight).copy().reshape(cap, NV)
    col = np.asarray(vol.color).copy().reshape(cap, NV, 3)
    coords = np.zeros((cap, 3), np.int32)

    ptr = 1
    for b in range(count):
        coords[b] = buf[ptr : ptr + 3].astype(np.int32)
        ptr += 3
        while buf[ptr] != -2.0:
            run = buf[ptr : ptr + 6]
            i = _POOL_OF_REF[int(run[0])]
            sdf[b, i] = run[1]
            wgt[b, i] = run[2]
            col[b, i] = run[3:6]
            ptr += 6
        ptr += 1

    import jax.numpy as jnp

    vol.sdf = jnp.asarray(sdf.reshape(cap, N, N, N))
    vol.weight = jnp.asarray(wgt.reshape(cap, N, N, N))
    vol.color = jnp.asarray(col.reshape(cap, N, N, N, 3))
    vol.block_coords[:count] = coords[:count]
    vol.slot_of = {tuple(c): i for i, c in enumerate(coords[:count].tolist())}
    vol.num_active = count
    return vol
