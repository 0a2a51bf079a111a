"""Sparse LiDAR backbone ("spconv8x") on the column engine.

Port of streamingflow_tpu/models/lidar_encoder.py::LidarBEVEncoder with
SPARSE_ENCODER.ENGINE='column' and DENSE_TAIL_FROM_STAGE=3, the reference's
mmdet3d SparseEncoder (channels [[16,16,32],[32,32,64],[64,64,128],
[128,128]], BN eps 1e-3):

  points -> voxelize (fp32 binning, mean in COMPUTE_DTYPE)
         -> column set (ops/sparse_columns.py), conv_input
         -> stages 1-2 on columns: submanifold convs (ops/winfuse.py, kernel
            K3 on the card) and strided column convs down1, down2
         -> dense tail from stage 3: F.conv3d over (N, C, X, Y, Z) grids,
            the masked BN restoring the sparse active set
         -> conv_out (1,1,3)/(1,1,2) -> (B, T, OUTPUT_CHANNELS * nz, X, Y)
            with channel c*nz + z (nz = 2 at the flagship).

Z_FORMULATION 'winfuse' and 'sep' compute the same conv; 'winfuse' drops
the taps the TPU kernel's window plan drops (ops/winfuse.py::fused_found).
Submodule and parameter names are the flax paths; the conv weights keep the
JAX (taps, Cin, Cout) layout (convert.py reads ``JAX_LAYOUT``).  The
clouds of a batch go through each submanifold conv in one kernel launch.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import SparseEncoderConfig
from ..ops import sparse_columns as SC
from ..ops.voxelize import LARGE_ID, linearize, voxelize
from ..ops.winfuse import fused_found, subm_conv_winfuse

DENSE_TAIL_FROM_STAGE = 3
FORMULATIONS = ('winfuse', 'sep')


class MaskedBatchNorm(nn.BatchNorm1d):
    """Eval-mode BatchNorm over the active sites, in two layouts: fused
    columns x (..., V, nz*C) with mask (..., V, nz), and dense grids x
    (N, C, X, Y, Z) with mask (N, X, Y, Z).  Normalises in the input's type
    and zeroes the inactive sites."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-3, momentum=0.01)

    def forward(self, x, mask):
        if self.training:
            raise NotImplementedError('MaskedBatchNorm in train mode is not '
                                      'ported yet (ROADMAP.md, Queue 1 item '
                                      '14c: spconv8x training)')
        c = self.num_features
        inv = torch.rsqrt(self.running_var.float() + self.eps) * \
            self.weight.float()
        mean, inv, bias = (t.to(x.dtype) for t in
                           (self.running_mean, inv, self.bias))
        if mask.dim() == x.dim():
            xv = x.reshape(*x.shape[:-1], mask.shape[-1], c)
            y = (xv - mean) * inv + bias
            return torch.where(mask[..., None], y, 0).reshape(x.shape)
        shape = (1, c) + (1,) * (x.dim() - 2)
        y = (x - mean.view(shape)) * inv.view(shape) + bias.view(shape)
        return torch.where(mask[:, None], y, 0)


def _tap_weights(taps: int, cin: int, cout: int) -> nn.Parameter:
    """(taps, Cin, Cout), flax's variance_scaling(1, fan_in, uniform)."""
    bound = math.sqrt(3.0 / (taps * cin))
    return nn.Parameter(torch.empty(taps, cin, cout).uniform_(-bound, bound))


class ColumnGeo(NamedTuple):
    """One stage's neighbour map over the stacked clouds: nbr (9, N*V)
    int32 rows of the (N*V, nz*C) features, found (9, N*V) bool, and the
    taps 'winfuse' dropped in each cloud, (N,) int32."""
    nbr: torch.Tensor
    found: torch.Tensor
    n_dropped: torch.Tensor


class DenseGrid:
    """Geometry sentinel of the dense-tail stages."""


DENSE = DenseGrid()


def _conv3d(x, w, kernel, stride=(1, 1, 1), padding=(1, 1, 1)):
    """x (N, C, X, Y, Z) with the x-major (prod(kernel), Cin, Cout) taps."""
    w5 = w.reshape(*kernel, w.shape[1], w.shape[2]).permute(4, 3, 0, 1, 2)
    return F.conv3d(x, w5.to(x.dtype), stride=stride, padding=padding)


def subm(feats, mask, geo, w):
    """Submanifold 3x3x3 conv: fused columns (N, V, nz*Cin) over a
    ColumnGeo, or a dense grid (N, Cin, X, Y, Z) under DENSE."""
    if isinstance(geo, DenseGrid):
        return _conv3d(feats, w, (3, 3, 3))
    n, v, _ = feats.shape
    out = subm_conv_winfuse(feats.reshape(n * v, -1), geo.nbr, geo.found, w,
                            mask.shape[-1])
    return out.reshape(n, v, -1)


def column_sets(points, point_mask, cfg: SparseEncoderConfig,
                out_dtype) -> SC.ColumnSet:
    """Clouds (N, P, C) -> their stage-1 column sets, stacked (N, ...)."""
    shape = tuple(cfg.SPARSE_SHAPE)
    cap0 = min(cfg.COLUMN_CAPS[0], shape[0] * shape[1])
    sets = []
    for pts, pmask in zip(points, point_mask):
        vox = voxelize(pts, pmask, cfg.POINT_CLOUD_RANGE, cfg.VOXEL_SIZE,
                       cfg.MAX_NUM_POINTS, cfg.MAX_VOXELS, out_dtype=out_dtype)
        # the voxel grid's z (40 at the flagship) re-linearised into
        # SPARSE_SHAPE's (41): the order of the ids is kept
        ids = torch.where(vox.mask, linearize(vox.coords.long(), shape),
                          LARGE_ID)
        sets.append(SC.from_sites(vox.feats, ids, vox.mask, shape, cap0))
    return SC.stack_sets(sets)


def column_geometry(cs: SC.ColumnSet, grid, cfg: SparseEncoderConfig
                    ) -> ColumnGeo:
    """The neighbour map of stacked column sets, with the taps the
    'winfuse' plan keeps."""
    n, cap = cs.col_ids.shape
    nbrs, founds, drops = [], [], []
    for i in range(n):
        cmap = SC.build_column_map(SC.cloud(cs, i), grid)
        found = cmap.found
        dropped = torch.zeros((), dtype=torch.int32, device=found.device)
        if cfg.Z_FORMULATION == 'winfuse':
            found, dropped = fused_found(cmap, cfg.WINDOW_BLOCK,
                                         cfg.WINFUSE_WINDOW,
                                         cfg.WINDOW_RESID_BLOCKS)
        nbrs.append(cmap.nbr + i * cap)
        founds.append(found)
        drops.append(dropped)
    return ColumnGeo(torch.cat(nbrs, 1).int(), torch.cat(founds, 1),
                     torch.stack(drops))


class SubMConvBNReLU(nn.Module):
    JAX_LAYOUT = True

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = _tap_weights(27, cin, cout)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(cout)

    def forward(self, feats, mask, geo):
        return F.relu(self.MaskedBatchNorm_0(subm(feats, mask, geo,
                                                  self.kernel), mask))


class SparseBasicBlock(nn.Module):
    """Residual block of two submanifold convs (mmdet3d sparse_block.py)."""
    JAX_LAYOUT = True

    def __init__(self, channels: int):
        super().__init__()
        self.kernel1 = _tap_weights(27, channels, channels)
        self.kernel2 = _tap_weights(27, channels, channels)
        self.bn1 = MaskedBatchNorm(channels)
        self.bn2 = MaskedBatchNorm(channels)

    def forward(self, feats, mask, geo):
        h = F.relu(self.bn1(subm(feats, mask, geo, self.kernel1), mask))
        h = self.bn2(subm(h, mask, geo, self.kernel2), mask)
        return F.relu(h + feats)


class ColumnSparseConvBNReLU(nn.Module):
    """Strided sparse conv + BN + ReLU over the stacked clouds' columns."""
    JAX_LAYOUT = True

    def __init__(self, cin, cout, kernel, stride, padding, cap):
        super().__init__()
        self.conv = (tuple(kernel), tuple(stride), tuple(padding))
        self.cap = cap
        self.kernel = _tap_weights(math.prod(kernel), cin, cout)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(cout)

    def forward(self, cs: SC.ColumnSet, shape):
        kernel, stride, padding = self.conv
        out_shape = SC.conv_out_shape(shape, kernel, stride, padding)
        cap = min(self.cap, out_shape[0] * out_shape[1])
        out = SC.stack_sets([SC.sparse_conv_columns(
            SC.cloud(cs, i), self.kernel, kernel, stride, padding, shape,
            cap)[0] for i in range(cs.feats.shape[0])])
        feats = F.relu(self.MaskedBatchNorm_0(out.feats, out.zmask))
        return out._replace(feats=feats), out_shape


class DenseConvBNReLU(nn.Module):
    """Strided conv + BN + ReLU over dense (N, C, X, Y, Z) grids; the output
    occupancy is the SparseConv3d rule (any active input in the window),
    a max-pool of the input occupancy."""
    JAX_LAYOUT = True

    def __init__(self, cin, cout, kernel, stride, padding):
        super().__init__()
        self.conv = (tuple(kernel), tuple(stride), tuple(padding))
        self.kernel = _tap_weights(math.prod(kernel), cin, cout)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(cout)

    def forward(self, x, mask):
        kernel, stride, padding = self.conv
        h = _conv3d(x, self.kernel, kernel, stride, padding)
        omask = F.max_pool3d(mask[:, None].float(), kernel, stride,
                             padding)[:, 0] > 0
        return F.relu(self.MaskedBatchNorm_0(h, omask)), omask


class LidarBEVEncoder(nn.Module):
    """points (B, T, P, C) -> BEV features (B, T, out_channels, X, Y).

    After each forward, ``last_n_dropped`` holds the taps 'winfuse' dropped
    per stage ({'stage1': (N,), 'stage2': (N,)} device tensors)."""

    def __init__(self, cfg: SparseEncoderConfig):
        super().__init__()
        if cfg.ENGINE != 'column' or cfg.Z_FORMULATION not in FORMULATIONS:
            raise NotImplementedError(
                f'SPARSE_ENCODER.ENGINE={cfg.ENGINE!r} / Z_FORMULATION='
                f'{cfg.Z_FORMULATION!r} is not ported yet (ROADMAP.md, Queue '
                f"1 items 14d and 16); the port runs ENGINE='column' with "
                f"Z_FORMULATION in {FORMULATIONS}")
        if cfg.DENSE_TAIL_FROM_STAGE != DENSE_TAIL_FROM_STAGE:
            raise NotImplementedError(
                f'SPARSE_ENCODER.DENSE_TAIL_FROM_STAGE='
                f'{cfg.DENSE_TAIL_FROM_STAGE} is not ported yet (ROADMAP.md, '
                f'Queue 1 item 14b); the port runs {DENSE_TAIL_FROM_STAGE}')
        self.cfg = cfg
        self.last_n_dropped: Dict[str, torch.Tensor] = {}
        self.conv_input = SubMConvBNReLU(cfg.IN_CHANNELS, cfg.BASE_CHANNELS)
        paddings = [(1, 1, 1), (1, 1, 1), (1, 1, 0)]
        n_stages = len(cfg.ENCODER_CHANNELS)
        prev = cfg.BASE_CHANNELS
        for i, blocks in enumerate(cfg.ENCODER_CHANNELS):
            for j, ch in enumerate(blocks):
                if j == len(blocks) - 1 and i != n_stages - 1:
                    args = (prev, ch, (3, 3, 3), (2, 2, 2), paddings[i])
                    down = (DenseConvBNReLU(*args)
                            if i + 1 >= DENSE_TAIL_FROM_STAGE else
                            ColumnSparseConvBNReLU(*args,
                                                   cfg.COLUMN_CAPS[i + 1]))
                    self.add_module(f'down{i + 1}', down)
                else:
                    self.add_module(f'stage{i + 1}_block{j}',
                                    SparseBasicBlock(ch))
                prev = ch
        self.conv_out = DenseConvBNReLU(prev, cfg.OUTPUT_CHANNELS, (1, 1, 3),
                                        (1, 1, 2), (0, 0, 0))
        # BEV channels: OUTPUT_CHANNELS times the z left after the ladder
        # (41 -> 21 -> 11 -> 5 -> 2 at the flagship)
        shape = tuple(cfg.SPARSE_SHAPE)
        for p in paddings:
            shape = SC.conv_out_shape(shape, (3, 3, 3), (2, 2, 2), p)
        nz = SC.conv_out_shape(shape, (1, 1, 3), (1, 1, 2), (0, 0, 0))[2]
        self.out_channels = cfg.OUTPUT_CHANNELS * nz

    def _column_stage(self, s: int, cs: SC.ColumnSet, shape):
        """Stage s on columns: its blocks over one neighbour map, then the
        strided conv to the next stage's columns."""
        geo = column_geometry(cs, shape[:2], self.cfg)
        self.last_n_dropped[f'stage{s}'] = geo.n_dropped
        if s == 1:
            cs = cs._replace(feats=self.conv_input(cs.feats, cs.zmask, geo))
        for j in range(len(self.cfg.ENCODER_CHANNELS[s - 1]) - 1):
            block = getattr(self, f'stage{s}_block{j}')
            cs = cs._replace(feats=block(cs.feats, cs.zmask, geo))
        return getattr(self, f'down{s}')(cs, shape)

    def forward(self, points):
        cfg = self.cfg
        B, T, P, C = points.shape
        flat = points.reshape(B * T, P, C)
        # zero rows are padding (the reference pads clouds with zeros)
        pmask = (flat[..., :3] != 0).any(-1)
        out_dtype = (getattr(torch, cfg.COMPUTE_DTYPE)
                     if cfg.COMPUTE_DTYPE != 'auto' else points.dtype)
        shape = tuple(cfg.SPARSE_SHAPE)
        cs = column_sets(flat, pmask, cfg, out_dtype)
        self.last_n_dropped = {}
        for s in (1, 2):
            cs, shape = self._column_stage(s, cs, shape)

        # dense tail: (N, C, X, Y, Z) grids and (N, X, Y, Z) occupancy
        c = cfg.ENCODER_CHANNELS[1][-1]
        dense = [SC.columns_to_dense(SC.cloud(cs, i), shape, c)
                 for i in range(B * T)]
        x = torch.stack([d[0] for d in dense]).permute(0, 4, 1, 2, 3)
        mask = torch.stack([d[1] for d in dense])
        n_stages = len(cfg.ENCODER_CHANNELS)
        for s in range(DENSE_TAIL_FROM_STAGE, n_stages + 1):
            down = s < n_stages          # the last stage has no down conv
            for j in range(len(cfg.ENCODER_CHANNELS[s - 1]) - down):
                x = getattr(self, f'stage{s}_block{j}')(x, mask, DENSE)
            if down:
                x, mask = getattr(self, f'down{s}')(x, mask)
        x, _ = self.conv_out(x, mask)
        n, ch, nx, ny, nz = x.shape
        # channel c*nz + z, as the reference's dense view
        x = x.permute(0, 1, 4, 2, 3).reshape(B, T, ch * nz, nx, ny)
        return x.to(out_dtype)
