"""Geometry for the forward pass: BEV grid parameters, 6-DoF poses, frustum.

Port of streamingflow_tpu/geometry.py (the parts the eval-mode forward
needs; the feature warps belong to the training slice).  Poses and
geometry stay float32 whatever the model's compute dtype.
"""
from __future__ import annotations

import numpy as np
import torch


def calculate_birds_eye_view_parameters(x_bounds, y_bounds, z_bounds):
    """Resolution / start position / dimension of the BEV grid, as numpy
    arrays (static shapes)."""
    bounds = [x_bounds, y_bounds, z_bounds]
    bev_resolution = np.array([row[2] for row in bounds], dtype=np.float32)
    bev_start_position = np.array([row[0] + row[2] / 2.0 for row in bounds],
                                  dtype=np.float32)
    bev_dimension = np.array([(row[1] - row[0]) / row[2] for row in bounds],
                             dtype=np.int64)
    return bev_resolution, bev_start_position, bev_dimension


def euler2mat(angle: torch.Tensor) -> torch.Tensor:
    """Euler angles (..., 3) -> rotation matrices (..., 3, 3), composed
    x @ y @ z."""
    x, y, z = angle[..., 0], angle[..., 1], angle[..., 2]
    cosz, sinz = torch.cos(z), torch.sin(z)
    cosy, siny = torch.cos(y), torch.sin(y)
    cosx, sinx = torch.cos(x), torch.sin(x)
    zeros = torch.zeros_like(z)
    ones = torch.ones_like(z)
    zmat = torch.stack([cosz, -sinz, zeros, sinz, cosz, zeros,
                        zeros, zeros, ones], -1).reshape(*z.shape, 3, 3)
    ymat = torch.stack([cosy, zeros, siny, zeros, ones, zeros,
                        -siny, zeros, cosy], -1).reshape(*z.shape, 3, 3)
    xmat = torch.stack([ones, zeros, zeros, zeros, cosx, -sinx,
                        zeros, sinx, cosx], -1).reshape(*z.shape, 3, 3)
    return xmat @ ymat @ zmat


def pose_vec2mat(vec: torch.Tensor) -> torch.Tensor:
    """6-DoF vector (..., 6) -> (..., 4, 4) transformation matrix."""
    rot = euler2mat(vec[..., 3:])
    transform = torch.cat([rot, vec[..., :3, None]], dim=-1)   # (..., 3, 4)
    bottom = torch.zeros_like(transform[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([transform, bottom], dim=-2)


def create_frustum(final_dim, downsample: int, d_bound) -> np.ndarray:
    """Image-plane frustum grid (D, fH, fW, 3): (x_px, y_px, depth_m)."""
    h, w = final_dim
    fh, fw = h // downsample, w // downsample
    depth_grid = np.arange(*d_bound, dtype=np.float32)
    frustum = np.zeros((depth_grid.shape[0], fh, fw, 3), dtype=np.float32)
    frustum[..., 0] = np.linspace(0, w - 1, fw, dtype=np.float32)[None, None]
    frustum[..., 1] = np.linspace(0, h - 1, fh, dtype=np.float32)[None, :,
                                                                  None]
    frustum[..., 2] = depth_grid[:, None, None]
    return frustum


def get_geometry(frustum: torch.Tensor, intrinsics: torch.Tensor,
                 extrinsics: torch.Tensor) -> torch.Tensor:
    """Lift the frustum (D, fH, fW, 3) to ego-frame points with
    intrinsics (B, N, 3, 3) and extrinsics (B, N, 4, 4).
    Returns (B, N, D, fH, fW, 3)."""
    rotation = extrinsics[..., :3, :3]
    translation = extrinsics[..., :3, 3]
    points = torch.cat([frustum[..., :2] * frustum[..., 2:3],
                        frustum[..., 2:3]], dim=-1)
    combined = rotation @ torch.linalg.inv(intrinsics)
    pts = torch.einsum('bnij,dhwj->bndhwi', combined, points)
    return pts + translation[:, :, None, None, None, :]
