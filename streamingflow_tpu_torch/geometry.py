"""Geometry: BEV grid parameters, 6-DoF poses, feature warps, frustum.

Port of streamingflow_tpu/geometry.py.  Poses and geometry stay float32
whatever the model's compute dtype.  Feature maps given to the warps are
channels-last (B, H, W, C), as in the JAX package; the warps follow its
sampling rule (``affine_grid`` + ``grid_sample`` with align_corners=False and
zero padding, 'nearest' rounding half to even), which decides integer labels.
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


def update_intrinsics(intrinsics, top_crop=0.0, left_crop=0.0,
                      scale_width=1.0, scale_height=1.0) -> np.ndarray:
    """Adjust (..., 3, 3) intrinsics (numpy, float32) for a resize then a
    crop."""
    intrinsics = np.array(intrinsics, dtype=np.float32, copy=True)
    intrinsics[..., 0, 0] *= scale_width
    intrinsics[..., 0, 2] *= scale_width
    intrinsics[..., 1, 1] *= scale_height
    intrinsics[..., 1, 2] *= scale_height
    intrinsics[..., 0, 2] -= left_crop
    intrinsics[..., 1, 2] -= top_crop
    return intrinsics


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


def mat2pose_vec(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) pose matrix -> 6-DoF vector (tx, ty, tz, rx, ry, rz)."""
    rotx = torch.atan2(-matrix[..., 1, 2], matrix[..., 2, 2])
    cosy = torch.sqrt(matrix[..., 1, 2] ** 2 + matrix[..., 2, 2] ** 2)
    roty = torch.atan2(matrix[..., 0, 2], cosy)
    rotz = torch.atan2(-matrix[..., 0, 1], matrix[..., 0, 0])
    return torch.cat([matrix[..., :3, 3],
                      torch.stack([rotx, roty, rotz], dim=-1)], dim=-1)


def invert_pose_matrix(x: torch.Tensor) -> torch.Tensor:
    """Invert (..., 4, 4) rigid pose matrices."""
    rot_t = x[..., :3, :3].transpose(-1, -2)
    top = torch.cat([rot_t, -(rot_t @ x[..., :3, 3:])], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def _grid_sample_2d(img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
                    mode: str) -> torch.Tensor:
    """Sample (B, H, W, C) images at float pixel coords (B, H', W'), zero
    outside the image."""
    B, H, W, _ = img.shape
    batch = torch.arange(B, device=img.device)[:, None, None]

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        vals = img[batch, yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
        return torch.where(valid[..., None], vals, torch.zeros_like(vals))

    if mode == 'nearest':
        # torch.round rounds half to even, as jnp.rint
        return gather(torch.round(iy).long(), torch.round(ix).long())
    if mode == 'bilinear':
        x0, y0 = torch.floor(ix), torch.floor(iy)
        wx1, wy1 = ix - x0, iy - y0
        wx0, wy0 = 1.0 - wx1, 1.0 - wy1
        x0, y0 = x0.long(), y0.long()
        x1, y1 = x0 + 1, y0 + 1
        return (gather(y0, x0) * (wy0 * wx0)[..., None]
                + gather(y0, x1) * (wy0 * wx1)[..., None]
                + gather(y1, x0) * (wy1 * wx0)[..., None]
                + gather(y1, x1) * (wy1 * wx1)[..., None])
    raise ValueError(f'Unknown mode {mode}')


def affine_warp(x: torch.Tensor, theta: torch.Tensor,
                mode: str = 'nearest') -> torch.Tensor:
    """Warp (B, H, W, C) by per-sample 2x3 affine ``theta`` in normalised
    coordinates (affine_grid with align_corners=False, then the sampling)."""
    B, H, W, C = x.shape
    kw = dict(dtype=torch.float32, device=x.device)
    xs = torch.linspace(-1.0, 1.0, W, **kw) * ((W - 1) / W)
    ys = torch.linspace(-1.0, 1.0, H, **kw) * ((H - 1) / H)
    gy, gx = torch.meshgrid(ys, xs, indexing='ij')
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)   # (H, W, 3)
    sample = torch.einsum('hwj,bij->bhwi', base, theta.float())
    ix = ((sample[..., 0] + 1.0) * W - 1.0) / 2.0
    iy = ((sample[..., 1] + 1.0) * H - 1.0) / 2.0
    return _grid_sample_2d(x, ix, iy, mode)


def warp_features(x: torch.Tensor, flow, mode: str = 'nearest',
                  spatial_extent=None) -> torch.Tensor:
    """Apply the in-plane rotation + translation of a 6-DoF ``flow`` (B, 6)
    to x (B, H, W, C)."""
    if flow is None:
        return x
    angle = flow[:, 5]
    tx = -flow[:, 0] / spatial_extent[0]
    ty = flow[:, 1] / spatial_extent[1]
    cos_t, sin_t = torch.cos(angle), torch.sin(angle)
    theta = torch.stack([torch.stack([cos_t, -sin_t, ty], dim=-1),
                         torch.stack([sin_t, cos_t, tx], dim=-1)],
                        dim=1).to(x.dtype)
    return affine_warp(x, theta, mode=mode)


def cumulative_warp_features(x: torch.Tensor, flow: torch.Tensor,
                             mode: str = 'nearest',
                             spatial_extent=None) -> torch.Tensor:
    """Warp past frames into the present frame by accumulating egomotion.
    x (B, T, H, W, C); flow (B, T, 6), the pose from t to t + 1.  x[:, -1]
    stays; x[:, t] is warped by flow[t] @ ... @ flow[T-2]."""
    T = x.shape[1]
    if T == 1:
        return x
    mats = pose_vec2mat(flow)
    out = [x[:, -1]]
    cum = mats[:, -2]
    for t in reversed(range(T - 1)):
        out.append(warp_features(x[:, t], mat2pose_vec(cum), mode=mode,
                                 spatial_extent=spatial_extent))
        cum = mats[:, t - 1] @ cum
    return torch.stack(out[::-1], dim=1)


def cumulative_warp_features_reverse(x: torch.Tensor, flow: torch.Tensor,
                                     mode: str = 'nearest',
                                     spatial_extent=None) -> torch.Tensor:
    """Warp future frames back into the first (present) frame."""
    mats = pose_vec2mat(flow)
    out = [x[:, 0]]
    cum = None
    for i in range(1, x.shape[1]):
        inv = invert_pose_matrix(mats[:, i - 1])
        cum = inv if cum is None else cum @ inv
        out.append(warp_features(x[:, i], mat2pose_vec(cum), mode=mode,
                                 spatial_extent=spatial_extent))
    return torch.stack(out, dim=1)


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
