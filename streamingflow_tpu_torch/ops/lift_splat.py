"""Lift-splat BEV pooling (camera frustum -> BEV grid) with the discounted
accumulation over past frames.

Port of streamingflow_tpu/ops/lift_splat.py.  Backends of the pool:
``'scatter'`` (index_add_ into the grid, the plain pool), ``'sorted'``
(stable sort by bin first) and ``'pallas_patch'`` (the patch-budget pool of
ops/patch_pool.py, a hand-written CUDA kernel on the card).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .patch_pool import patch_pool_frames


def quantize_geometry(geometry: torch.Tensor, bev_start_position,
                      bev_resolution) -> torch.Tensor:
    """Float ego-frame points -> int32 voxel coords, truncating toward zero
    (not flooring), as the JAX package and the reference do."""
    start = torch.as_tensor(bev_start_position, dtype=geometry.dtype,
                            device=geometry.device)
    res = torch.as_tensor(bev_resolution, dtype=geometry.dtype,
                          device=geometry.device)
    return ((geometry - (start - res / 2.0)) / res).to(torch.int32)


def in_grid(coords: torch.Tensor, nx: int, ny: int, nz: int) -> torch.Tensor:
    """Rows whose voxel coords (..., 3) fall inside the (nx, ny, nz) grid."""
    return ((coords[..., 0] >= 0) & (coords[..., 0] < nx)
            & (coords[..., 1] >= 0) & (coords[..., 1] < ny)
            & (coords[..., 2] >= 0) & (coords[..., 2] < nz))


def bev_pool(x: torch.Tensor, geometry: torch.Tensor, bev_start_position,
             bev_resolution, bev_dimension: Tuple[int, int, int],
             backend: str = 'scatter') -> torch.Tensor:
    """Pool one frame: x (P, C) features at geometry (P, 3) ego points ->
    (X, Y, C), Z summed out, points outside the grid dropped."""
    nx, ny, nz = (int(v) for v in bev_dimension)
    coords = quantize_geometry(geometry, bev_start_position, bev_resolution)
    kept = in_grid(coords, nx, ny, nz)
    n_bins = nx * ny * nz
    flat = (coords[:, 0] * ny + coords[:, 1]) * nz + coords[:, 2]
    flat = torch.where(kept, flat, torch.full_like(flat, n_bins)).long()
    if backend == 'sorted':
        order = torch.argsort(flat, stable=True)
        x, flat = x[order], flat[order]
    elif backend != 'scatter':
        raise ValueError(f'unknown bev_pool backend {backend}')
    sums = x.new_zeros(n_bins + 1, x.shape[-1]).index_add_(0, flat, x)
    return sums[:n_bins].reshape(nx, ny, nz, -1).sum(dim=2)


def warp_geometry_to_present(geometry: torch.Tensor,
                             future_egomotion_mat: torch.Tensor
                             ) -> torch.Tensor:
    """Move past-frame frustum points (B, S, N, D, H, W, 3) into the present
    ego frame: frame k by T_{S-2} @ ... @ T_k (identity for the present)."""
    B, S = geometry.shape[:2]
    eye = torch.eye(4, dtype=geometry.dtype, device=geometry.device)
    cum = eye.expand(B, 4, 4)
    mats = []
    for k in range(S - 1, -1, -1):
        mats.append(cum)
        if k > 0:
            cum = cum @ future_egomotion_mat[:, k - 1]
    cum_mats = torch.stack(mats[::-1], dim=1)            # (B, S, 4, 4)
    out = torch.einsum('bsij,bsndhwj->bsndhwi', cum_mats[..., :3, :3],
                       geometry)
    return out + cum_mats[..., :3, 3][:, :, None, None, None, None, :]


def _patch_backend(x, geom, bev_start_position, bev_resolution,
                   bev_dimension):
    B, S, N, D, fH, fW, C = x.shape
    nx, ny, nz = (int(v) for v in bev_dimension)
    coords = quantize_geometry(geom, bev_start_position, bev_resolution)
    kept = in_grid(coords, nx, ny, nz)
    pooled, _drops = patch_pool_frames(
        x.reshape(B * S, N, D, fH, fW, C),
        coords[..., :2].reshape(B * S, N, D, fH, fW, 2).contiguous(),
        kept.reshape(B * S, N, D, fH, fW), nx, ny)
    return pooled.reshape(B, S, nx, ny, C).to(x.dtype)


def projection_to_birds_eye_view(x: torch.Tensor, geometry: torch.Tensor,
                                 future_egomotion_mat: torch.Tensor,
                                 bev_start_position, bev_resolution,
                                 bev_dimension, discount: float,
                                 backend: str = 'scatter') -> torch.Tensor:
    """x (B, S, N, D, fH, fW, C) depth-weighted camera features at geometry
    (B, S, N, D, fH, fW, 3) -> BEV features (B, S, X, Y, C), each frame the
    discounted sum acc = acc * discount + frame."""
    B, S, N, D, fH, fW, C = x.shape
    geom = warp_geometry_to_present(geometry, future_egomotion_mat)
    if backend == 'pallas_patch':
        pooled = _patch_backend(x, geom, bev_start_position, bev_resolution,
                                bev_dimension)
    else:
        flat_x = x.reshape(B * S, -1, C)
        flat_g = geom.reshape(B * S, -1, 3)
        pooled = torch.stack([
            bev_pool(flat_x[i], flat_g[i], bev_start_position,
                     bev_resolution, bev_dimension, backend)
            for i in range(B * S)]).reshape(B, S, int(bev_dimension[0]),
                                            int(bev_dimension[1]), C)
    acc = torch.zeros_like(pooled[:, 0])
    frames = []
    for s in range(S):
        acc = acc * discount + pooled[:, s]
        frames.append(acc)
    return torch.stack(frames, dim=1)
