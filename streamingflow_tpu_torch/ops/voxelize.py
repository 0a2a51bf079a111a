"""Hard voxelization: point cloud -> fixed-capacity voxel set.

Port of streamingflow_tpu/ops/voxelize.py.  Points are stably sorted by
linearised voxel id; each distinct id takes one slot, in ascending id order
(the sparse ops downstream rely on it); a voxel's feature is the fp32 mean
of its first ``max_points`` points in point order, cast to ``out_dtype``.
Over ``max_voxels`` the lowest ids are kept.  Shapes are static: the voxel
set has ``max_voxels`` slots and a mask.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

# id of an empty slot (int32 max), as in the JAX package
LARGE_ID = 2 ** 31 - 1


class VoxelSet(NamedTuple):
    """feats (V_cap, C) mean point features; coords (V_cap, 3) int32
    (x, y, z); ids (V_cap,) int32 ascending, LARGE_ID where empty; mask
    (V_cap,) bool."""
    feats: torch.Tensor
    coords: torch.Tensor
    ids: torch.Tensor
    mask: torch.Tensor


def linearize(coords: torch.Tensor, shape: Tuple[int, int, int]):
    nx, ny, nz = shape
    return (coords[..., 0] * ny + coords[..., 1]) * nz + coords[..., 2]


def delinearize(ids: torch.Tensor, shape: Tuple[int, int, int]):
    nx, ny, nz = shape
    return torch.stack([ids // (nz * ny), (ids // nz) % ny, ids % nz], -1)


def voxelize(points: torch.Tensor, point_mask: torch.Tensor,
             point_cloud_range, voxel_size, max_points: int,
             max_voxels: int, out_dtype=None) -> VoxelSet:
    """points (P, C>=3), xyz leading, in fp32 (quantisation floors
    ``(p - lo) / size`` in fp32, as a division); point_mask (P,)."""
    dev = points.device
    shape = tuple(int(round(float((point_cloud_range[d + 3]
                                   - point_cloud_range[d]) / voxel_size[d])))
                  for d in range(3))
    lo = torch.tensor(point_cloud_range[:3], dtype=torch.float32, device=dev)
    size = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    coords = torch.floor((points[:, :3].float() - lo) / size).long()
    in_range = ((coords >= 0) & (coords < torch.tensor(shape, device=dev))
                ).all(-1)
    valid = in_range & point_mask
    ids = torch.where(valid, linearize(coords, shape),
                      torch.full_like(coords[:, 0], LARGE_ID))

    ids_s, order = torch.sort(ids, stable=True)
    pts_s = points[order].float()
    valid_s = valid[order]
    first = torch.ones_like(valid_s)
    first[1:] = ids_s[1:] != ids_s[:-1]
    first &= valid_s
    run_rank = torch.cumsum(first, 0) - 1                 # voxel slot
    seg = run_rank.clamp(0, max_voxels - 1)
    pos = torch.arange(ids_s.shape[0], device=dev)
    run_start = torch.full((max_voxels,), -1, dtype=torch.long, device=dev)
    run_start.scatter_reduce_(0, seg, torch.where(first, pos, -1), 'amax')
    within = pos - run_start[seg]
    keep = valid_s & (within < max_points) & (run_rank < max_voxels)

    slot = torch.where(keep, run_rank, max_voxels)
    sums = torch.zeros(max_voxels + 1, points.shape[1], device=dev)
    sums.index_add_(0, slot, torch.where(keep[:, None], pts_s, 0.0))
    counts = torch.zeros(max_voxels + 1, device=dev)
    counts.index_add_(0, slot, keep.float())
    feats = (sums[:max_voxels] / counts[:max_voxels, None].clamp(min=1.0)
             ).to(out_dtype if out_dtype is not None else points.dtype)

    slot_ids = torch.full((max_voxels,), LARGE_ID, dtype=torch.long,
                          device=dev)
    slot_ids.scatter_reduce_(
        0, seg, torch.where(first & (run_rank < max_voxels), ids_s,
                            LARGE_ID), 'amin')
    vmask = slot_ids < LARGE_ID
    vcoords = torch.where(vmask[:, None],
                          delinearize(torch.where(vmask, slot_ids, 0), shape),
                          0)
    return VoxelSet(feats, vcoords.int(), slot_ids.int(), vmask)
