"""Dense pillar LiDAR backbone ("pillar8x").

Port of streamingflow_tpu/models/pillar_encoder.py:

  points -> pillar statistics of all clouds by one bin-sum
            (ops/bin_sum.py::bin_sum_clouds, a hand-written CUDA kernel on
            the card), bf16, channel first
         -> space-to-depth 4x (channel order (sx*4+sy)*F + c)
         -> dense 2D conv stages 3 and 4 (BN eps 1e-3)
         -> (B, T, 2*OUTPUT_CHANNELS, X/8, Y/8) BEV features.

Points stay float32 (pillar quantisation floors in fp32); the branch emits
SPARSE_ENCODER.COMPUTE_DTYPE ('auto' = the points' dtype).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import SparseEncoderConfig
from ..layers.conv import batch_norm, conv2d
from ..ops.bin_sum import BINS_PER_TILE, bin_sum_clouds


def pillar_grid(point_cloud_range, voxel_size):
    nx = int(round(float((point_cloud_range[3] - point_cloud_range[0])
                         / voxel_size[0])))
    ny = int(round(float((point_cloud_range[4] - point_cloud_range[1])
                         / voxel_size[1])))
    return nx, ny


def pillar_rows(points: torch.Tensor, point_mask: torch.Tensor,
                point_cloud_range, voxel_size, n_z_bins: int = 8):
    """The bin-sum rows of :func:`pillarize`: data (P, 1 + C + 1 + n_z_bins)
    = [1, point, z^2, one_hot(z bin)] (zero for dropped points) and pillar
    ids (P,), points outside the grid in the trash bin nx*ny."""
    nx, ny = pillar_grid(point_cloud_range, voxel_size)
    pc = torch.as_tensor(point_cloud_range, dtype=torch.float32,
                         device=points.device)
    vs = torch.as_tensor(voxel_size, dtype=torch.float32,
                         device=points.device)
    z_lo, z_hi = float(point_cloud_range[2]), float(point_cloud_range[5])
    cx = torch.floor((points[:, 0] - pc[0]) / vs[0]).to(torch.int32)
    cy = torch.floor((points[:, 1] - pc[1]) / vs[1]).to(torch.int32)
    z = points[:, 2]
    inb = ((cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
           & (z >= z_lo) & (z < z_hi) & point_mask)
    pid = torch.where(inb, cx * ny + cy, torch.full_like(cx, nx * ny))
    zbin = ((z - z_lo) / (z_hi - z_lo) * n_z_bins).to(torch.int32).clamp(
        0, n_z_bins - 1)
    data = torch.cat([
        torch.ones_like(z)[:, None], points, (z * z)[:, None],
        F.one_hot(zbin.long(), n_z_bins).to(torch.float32)], dim=1)
    return torch.where(inb[:, None], data, torch.zeros_like(data)), pid


def pillarize(points: torch.Tensor, point_mask: torch.Tensor,
              point_cloud_range, voxel_size, n_z_bins: int = 8,
              out_dtype: torch.dtype = torch.float32,
              presorted: bool = False, layout: str = 'bev') -> torch.Tensor:
    """points (P, C>=3) -> pillar features (nx, ny, F), or (F, nx, ny) with
    ``layout='cf'``.  F = 1 + C + 1 + n_z_bins: log1p count, feature means,
    z std and z occupancy, all from one bin-sum of :func:`pillar_rows`
    (:func:`pillarize_batch` of the one cloud)."""
    feats = pillarize_batch(points[None], point_mask[None], point_cloud_range,
                            voxel_size, n_z_bins, out_dtype, presorted)[0]
    return feats if layout == 'cf' else feats.permute(1, 2, 0)


def pillarize_batch(points: torch.Tensor, point_mask: torch.Tensor,
                    point_cloud_range, voxel_size, n_z_bins: int = 8,
                    out_dtype: torch.dtype = torch.float32,
                    presorted: bool = False) -> torch.Tensor:
    """:func:`pillarize` of clouds (N, P, C) -> (N, F, nx, ny) in one
    bin-sum (the JAX package's ``pillarize_batch``).  Cloud k's pillar ids
    are offset by k times the cloud's bins rounded up to a whole tile, so
    tiles never straddle clouds and each cloud's tile-sorted rows stay
    sorted; the kernel writes each cloud's statistics straight into its
    slice of the result, and the trash bin nx*ny is never stored."""
    nx, ny = pillar_grid(point_cloud_range, voxel_size)
    n, p, c = points.shape
    n_pillars = nx * ny
    data, pid = pillar_rows(points.reshape(n * p, c),
                            point_mask.reshape(n * p), point_cloud_range,
                            voxel_size, n_z_bins)
    per_cloud = cloud_bins(n_pillars)
    first = torch.arange(0, n * per_cloud, per_cloud, dtype=pid.dtype,
                         device=pid.device)
    pid = (pid.view(n, p) + first[:, None]).view(-1)
    feats = bin_sum_clouds(data, pid, n, per_cloud, n_pillars,
                           pillar_features=c, out_dtype=out_dtype,
                           presorted=presorted)
    return feats.reshape(n, -1, nx, ny)


def cloud_bins(n_pillars: int) -> int:
    """Bins a cloud takes in :func:`pillarize_batch`: its pillars and the
    trash bin, rounded up to a whole bin-sum tile."""
    return -(-(n_pillars + 1) // BINS_PER_TILE) * BINS_PER_TILE


class ConvBNReLU(nn.Module):

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = conv2d(cin, cout, 3, stride=stride)
        self.BatchNorm_0 = batch_norm(cout, eps=1e-3, momentum=0.01)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class PillarBEVEncoder(nn.Module):
    """points (B, T, P, C) -> BEV features (B, T, 2*OUTPUT_CHANNELS, X, Y)
    with X, Y the pillar grid over 8.

    ``tile_sorted``: points arrive grouped by 2048-bin tile
    (MODEL.LIDAR.TILE_SORTED_POINTS), so the bin-sum skips its sort."""

    def __init__(self, cfg: SparseEncoderConfig, n_z_bins: int = 8,
                 tile_sorted: bool = False):
        super().__init__()
        self.cfg = cfg
        self.out_channels = 2 * cfg.OUTPUT_CHANNELS
        self.n_z_bins = n_z_bins
        self.tile_sorted = tile_sorted
        n_feat = 1 + cfg.IN_CHANNELS + 1 + n_z_bins
        c3 = cfg.ENCODER_CHANNELS[-2][-1]
        c4 = cfg.ENCODER_CHANNELS[-1][-1]
        self.stage3_conv1 = ConvBNReLU(16 * n_feat, c3)
        self.stage3_conv2 = ConvBNReLU(c3, c3)
        self.stage4_down = ConvBNReLU(c3, c4, stride=2)
        self.stage4_conv = ConvBNReLU(c4, c4)
        self.conv_out = conv2d(c4, 2 * cfg.OUTPUT_CHANNELS, 1)
        self.BatchNorm_0 = batch_norm(2 * cfg.OUTPUT_CHANNELS, eps=1e-3,
                                      momentum=0.01)

    def forward(self, points):
        return self.ladder(self.pillar_features(points))

    def pillar_features(self, points):
        """points (B, T, P, C) -> bf16 pillar statistics (B, T, F, nx, ny),
        one bin-sum for all clouds; no gradient flows (the input is
        points)."""
        cfg = self.cfg
        B, T, P, C = points.shape
        if C != cfg.IN_CHANNELS:
            raise ValueError(f'points have {C} channels, '
                             f'SPARSE_ENCODER.IN_CHANNELS is {cfg.IN_CHANNELS}')
        flat = points.reshape(B * T, P, C)
        pmask = (flat[..., :3] != 0).any(dim=-1)
        h = pillarize_batch(flat, pmask, cfg.POINT_CLOUD_RANGE,
                            cfg.VOXEL_SIZE, self.n_z_bins,
                            out_dtype=torch.bfloat16,
                            presorted=self.tile_sorted)   # (BT, F, nx, ny)
        return h.reshape(B, T, *h.shape[1:])

    def ladder(self, h):
        """Pillar statistics (B, T, F, nx, ny) -> BEV features: 4x
        space-to-depth and the dense conv stages."""
        cfg = self.cfg
        B, T = h.shape[:2]
        h = h.flatten(0, 1)
        bt, f, nx, ny = h.shape
        s = 4
        h = h.reshape(bt, f, nx // s, s, ny // s, s).permute(
            0, 3, 5, 1, 2, 4).reshape(bt, s * s * f, nx // s, ny // s)
        # bf16 pillar features meet the conv weights in the wider dtype
        h = h.to(torch.promote_types(h.dtype,
                                     self.stage3_conv1.Conv_0.weight.dtype))
        h = self.stage3_conv1(h)
        h = self.stage3_conv2(h)
        h = self.stage4_down(h)
        h = self.stage4_conv(h)
        h = F.relu(self.BatchNorm_0(self.conv_out(h)))
        # 'auto' = the points' dtype, float32
        out_dtype = (getattr(torch, cfg.COMPUTE_DTYPE)
                     if cfg.COMPUTE_DTYPE != 'auto' else torch.float32)
        return h.to(out_dtype).reshape(B, T, *h.shape[1:])
