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

A forward is :meth:`LidarBEVEncoder.geometry` (voxelize, column sets, the
column maps with the kept and the full found taps, the reversed maps, the
strided convs' taps and output columns, the dense tail's occupancy: no
gradient, computed once) and :meth:`LidarBEVEncoder.ladder` (the learned
part).  In train mode the masked BNs take batch statistics, and
SPARSE_ENCODER.REMAT_LADDER recomputes each submanifold conv, basic block
and down conv in the backward pass (``torch.utils.checkpoint``), with the
geometry outside every checkpoint.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import SparseEncoderConfig
from ..layers.trainmode import BatchNorm, global_moments, remat
from ..ops import sparse_columns as SC
from ..ops.voxelize import LARGE_ID, linearize, voxelize
from ..ops.winfuse import fused_found, reverse_map, subm_conv_winfuse

DENSE_TAIL_FROM_STAGE = 3
FORMULATIONS = ('winfuse', 'sep')
# flax's BatchNorm momentum: running = 0.99 * running + 0.01 * batch
FLAX_MOMENTUM = 0.99
# elements a chunk of the batch statistics widens to fp32 at once
STATS_CHUNK = 1 << 24


def _stat_chunks(x, mask, c):
    """(x chunk, mask chunk, reduced dims, channel shape, slice) pieces of
    at most ~STATS_CHUNK elements: fused columns x (..., V, nz*C) with mask
    (..., V, nz) by rows, each chunk (rows, nz, C); dense grids
    x (N, C, X, Y, Z) with mask (N, X, Y, Z) by (n, x) slabs, each chunk
    (C, x, Y, Z) as it lies in memory.  The mask chunk broadcasts against
    the x chunk, a per-channel vector shaped ``channel shape`` too."""
    if mask.dim() == x.dim():
        nz = mask.shape[-1]
        xr = x.reshape(-1, nz, c)
        mr = mask.reshape(-1, nz)
        step = max(1, STATS_CHUNK // (nz * c))
        for r0 in range(0, xr.shape[0], step):
            sl = (slice(r0, r0 + step),)
            yield xr[sl], mr[sl][..., None], (0, 1), (c,), sl
        return
    n, _, nx, ny, nz = x.shape
    step = max(1, STATS_CHUNK // (c * ny * nz))
    for i in range(n):
        for x0 in range(0, nx, step):
            sl = (i, slice(None), slice(x0, x0 + step))
            yield (x[sl], mask[i, x0:x0 + step][None], (1, 2, 3),
                   (c, 1, 1, 1), sl)


class _MaskedMoments(torch.autograd.Function):
    """Per-channel sums over the active sites, (sum x, sum x^2), summed in
    fp32 (fp64 for fp64 input) a chunk at a time, so no widened copy of a
    whole grid exists (a stage-3 dense grid is ~1.1 GB in bf16).  The
    backward is that of the JAX package's ``sum(xf * mf)``,
    ``sum(xf * xf * mf)`` with ``xf = x.astype(float32)``: d x = m (d s1 +
    2 x d s2), rounded to x's type, again a chunk at a time."""

    @staticmethod
    def forward(ctx, x, mask, c):
        dt = torch.promote_types(x.dtype, torch.float32)
        s1 = torch.zeros(c, dtype=dt, device=x.device)
        s2 = torch.zeros(c, dtype=dt, device=x.device)
        for xc, mc, dims, _, _ in _stat_chunks(x, mask, c):
            xf = xc.to(dt) * mc
            s1 += xf.sum(dims)
            s2 += (xf * xf).sum(dims)
        ctx.save_for_backward(x, mask)
        ctx.c = c
        return s1, s2

    @staticmethod
    def backward(ctx, ds1, ds2):
        x, mask = ctx.saved_tensors
        dx = x.new_empty(x.shape)
        view = dx.reshape(-1, mask.shape[-1], ctx.c) \
            if mask.dim() == x.dim() else dx
        for xc, mc, _, cshape, sl in _stat_chunks(x, mask, ctx.c):
            view[sl] = (mc * (ds1.view(cshape) + 2 * xc.to(ds1.dtype)
                              * ds2.view(cshape))).to(x.dtype)
        return dx, None, None


class MaskedBatchNorm(BatchNorm):
    """BatchNorm over the active sites, in two layouts: fused columns x
    (..., V, nz*C) with mask (..., V, nz), and dense grids x (N, C, X, Y, Z)
    with mask (N, X, Y, Z).  Normalises in the input's type and zeroes the
    inactive sites.

    Train mode, as the JAX package's MaskedBatchNorm: fp32 statistics over
    the active sites (:class:`_MaskedMoments`), n = max(count, 1), the
    biased variance max(E[x^2] - mean^2, 0) normalises, and the running
    statistics move by flax's momentum 0.99 (torch ``momentum`` 0.01),
    the variance's toward the unbiased n / max(n - 1, 1) times it.  Under a
    data-parallel shard the sums and n are the global batch's.  Under a
    rematerialised region's second run (layers/trainmode.py::remat) the
    running statistics stay where the first run left them."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-3, momentum=1 - FLAX_MOMENTUM)

    def forward(self, x, mask):
        c = self.num_features
        if self.training:
            s1, s2 = _MaskedMoments.apply(x, mask, c)
            n = mask.sum().to(s1.dtype)
            if self.shard is not None and self.shard.pg is not None:
                # the global batch's sums and count (a rank may hold no
                # active site)
                s1, s2, n = global_moments(s1, s2, n, self.shard.pg)
            n = n.clamp(min=1.0)
            mean = s1 / n
            var = torch.maximum(s2 / n - mean * mean, torch.zeros_like(s1))
            if self.update_stats:
                with torch.no_grad():
                    m = FLAX_MOMENTUM
                    unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                    self.running_mean.copy_(m * self.running_mean
                                            + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var
                                           + (1 - m) * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        dt = torch.promote_types(var.dtype, torch.float32)
        inv = torch.rsqrt(var.to(dt) + self.eps) * self.weight.to(dt)
        mean, inv, bias = (t.to(x.dtype) for t in (mean, inv, self.bias))
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
    int32 rows of the (N*V, nz*C) features, found (9, N*V) bool the taps
    the forward takes ('winfuse': the window plan's kept taps), the taps
    'winfuse' dropped in each cloud (N,) int32; for the backward, which
    takes every found tap as the JAX package's ``_winfuse_bwd`` does,
    grad_found (9, N*V) the map's full found and src_t (9, N*V) its
    reversal (ops/winfuse.py::reverse_map)."""
    nbr: torch.Tensor
    found: torch.Tensor
    n_dropped: Optional[torch.Tensor]
    grad_found: Optional[torch.Tensor] = None
    src_t: Optional[torch.Tensor] = None


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
                            mask.shape[-1], grad_found=geo.grad_found,
                            src_t=geo.src_t)
    return out.reshape(n, v, -1)


def _entry(points, point_mask, cfg: SparseEncoderConfig, out_dtype
           ) -> Tuple[SC.ColumnSet, torch.Tensor]:
    """Clouds (N, P, C) -> their stage-1 column sets, stacked (N, ...), and
    the number of voxel sites of all clouds (int64 device scalar)."""
    shape = tuple(cfg.SPARSE_SHAPE)
    cap0 = min(cfg.COLUMN_CAPS[0], shape[0] * shape[1])
    sets, n_sites = [], 0
    for pts, pmask in zip(points, point_mask):
        vox = voxelize(pts, pmask, cfg.POINT_CLOUD_RANGE, cfg.VOXEL_SIZE,
                       cfg.MAX_NUM_POINTS, cfg.MAX_VOXELS, out_dtype=out_dtype)
        # the voxel grid's z (40 at the flagship) re-linearised into
        # SPARSE_SHAPE's (41): the order of the ids is kept
        ids = torch.where(vox.mask, linearize(vox.coords.long(), shape),
                          LARGE_ID)
        sets.append(SC.from_sites(vox.feats, ids, vox.mask, shape, cap0))
        n_sites = n_sites + vox.mask.sum()
    return SC.stack_sets(sets), n_sites


def column_sets(points, point_mask, cfg: SparseEncoderConfig,
                out_dtype) -> SC.ColumnSet:
    """Clouds (N, P, C) -> their stage-1 column sets, stacked (N, ...)."""
    return _entry(points, point_mask, cfg, out_dtype)[0]


def column_geometry(cs: SC.ColumnSet, grid, cfg: SparseEncoderConfig
                    ) -> ColumnGeo:
    """The neighbour map of stacked column sets, with the taps the
    'winfuse' plan keeps, and the full found and the reversed map that the
    gradient takes."""
    n, cap = cs.col_ids.shape
    nbrs, founds, fulls, drops = [], [], [], []
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
        fulls.append(cmap.found)
        drops.append(dropped)
    nbr = torch.cat(nbrs, 1).int()
    full = torch.cat(fulls, 1)
    return ColumnGeo(nbr, torch.cat(founds, 1), torch.stack(drops), full,
                     reverse_map(nbr, full, n * cap))


def stacked_strided_geometry(cs: SC.ColumnSet, kernel, stride, padding,
                             shape, cap: int) -> SC.StridedGeo:
    """:func:`ops.sparse_columns.strided_geometry` of each cloud, stacked:
    src rows offset by each cloud's first row (N*V_in where none), the
    output ColumnSet (N, cap, ...)."""
    n, v_in = cs.col_ids.shape
    geos = [SC.strided_geometry(SC.cloud(cs, i), kernel, stride, padding,
                                shape, cap) for i in range(n)]
    src = torch.cat([torch.where(g.src < v_in, g.src + i * v_in, n * v_in)
                     for i, g in enumerate(geos)], 1)
    out = SC.ColumnSet(None, *(torch.stack(f) for f in
                               list(zip(*[g.out for g in geos]))[1:]))
    return SC.StridedGeo(src, out, geos[0].shape)


class LadderGeo(NamedTuple):
    """What a forward's ladder runs over, none of it taking a gradient:
    feats (N, V1, nz1*Cin) the voxel features in stage-1 columns; per
    column stage s (1, 2) its zmask (N, V, nz) and ColumnGeo, and the
    strided conv's geometry to stage s + 1; the dense entry's cells and the
    occupancy of each dense stage, then of conv_out's output; the (B, T)
    of the clouds and the branch's type."""
    feats: torch.Tensor
    zmasks: List[torch.Tensor]
    columns: List[ColumnGeo]
    strided: List[SC.StridedGeo]
    dense_idx: torch.Tensor
    dense_masks: List[torch.Tensor]
    batch: Tuple[int, int]
    out_dtype: torch.dtype


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

    def out_cap(self, shape) -> int:
        out_shape = SC.conv_out_shape(shape, *self.conv)
        return min(self.cap, out_shape[0] * out_shape[1])

    def forward(self, feats, nz: int, geo: SC.StridedGeo):
        """feats (N, V_in, nz*Cin) over the geometry of
        :func:`stacked_strided_geometry` -> (N, cap, nz_out*Cout)."""
        n, v_in, _ = feats.shape
        out = SC.strided_features(feats.reshape(n * v_in, -1), geo.src,
                                  self.kernel, *self.conv, nz, geo.shape[2])
        out = out.reshape(n, -1, out.shape[-1])
        return F.relu(self.MaskedBatchNorm_0(out, geo.out.zmask))


class DenseConvBNReLU(nn.Module):
    """Strided conv + BN + ReLU over dense (N, C, X, Y, Z) grids; the output
    occupancy is the SparseConv3d rule (any active input in the window),
    a max-pool of the input occupancy (:meth:`out_mask`)."""
    JAX_LAYOUT = True

    def __init__(self, cin, cout, kernel, stride, padding):
        super().__init__()
        self.conv = (tuple(kernel), tuple(stride), tuple(padding))
        self.kernel = _tap_weights(math.prod(kernel), cin, cout)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(cout)

    def out_mask(self, mask):
        return F.max_pool3d(mask[:, None].float(), *self.conv)[:, 0] > 0

    def forward(self, x, omask):
        h = _conv3d(x, self.kernel, *self.conv)
        return F.relu(self.MaskedBatchNorm_0(h, omask))


class LidarBEVEncoder(nn.Module):
    """points (B, T, P, C) -> BEV features (B, T, out_channels, X, Y).

    After each forward, ``last_n_dropped`` holds the taps 'winfuse' dropped
    per stage ({'stage1': (N,), 'stage2': (N,)} device tensors) and
    ``last_diagnostics`` the JAX package's sown 'diagnostics' (int32 device
    scalars, nothing read to the host): ``lidar_dropped_sites_entry`` (voxel
    sites less those the entry's column cap kept), ``lidar_columns_stage1``
    .. ``3`` (the most active columns of a cloud at each column stage) and
    ``lidar_column_cap_hit_stage2`` / ``3`` (1 when a cloud filled the
    strided conv's column cap: columns were dropped).

    SPARSE_ENCODER.REMAT_LADDER (train mode, gradients on) checkpoints each
    submanifold conv, basic block and down conv on its own.  The JAX
    package nests that per-block remat inside MODEL.REMAT's remat of the
    whole encoder; remat never changes the function, so the port's
    per-block checkpoints alone give the same values and gradients
    (models/streamingflow.py checkpoints the whole ladder only when
    REMAT_LADDER is off)."""

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
        self.last_diagnostics: Dict[str, torch.Tensor] = {}
        self.conv_input = SubMConvBNReLU(cfg.IN_CHANNELS, cfg.BASE_CHANNELS)
        self.paddings = [(1, 1, 1), (1, 1, 1), (1, 1, 0)]
        n_stages = len(cfg.ENCODER_CHANNELS)
        prev = cfg.BASE_CHANNELS
        for i, blocks in enumerate(cfg.ENCODER_CHANNELS):
            for j, ch in enumerate(blocks):
                if j == len(blocks) - 1 and i != n_stages - 1:
                    args = (prev, ch, (3, 3, 3), (2, 2, 2), self.paddings[i])
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
        for p in self.paddings:
            shape = SC.conv_out_shape(shape, (3, 3, 3), (2, 2, 2), p)
        nz = SC.conv_out_shape(shape, (1, 1, 3), (1, 1, 2), (0, 0, 0))[2]
        self.out_channels = cfg.OUTPUT_CHANNELS * nz

    def _blocks(self, s: int) -> List[nn.Module]:
        n_stages = len(self.cfg.ENCODER_CHANNELS)
        down = s < n_stages
        return [getattr(self, f'stage{s}_block{j}')
                for j in range(len(self.cfg.ENCODER_CHANNELS[s - 1]) - down)]

    def geometry(self, points) -> LadderGeo:
        """Everything of a forward that takes no gradient; sets
        ``last_n_dropped`` and ``last_diagnostics``."""
        cfg = self.cfg
        B, T, P, C = points.shape
        flat = points.reshape(B * T, P, C)
        # zero rows are padding (the reference pads clouds with zeros)
        pmask = (flat[..., :3] != 0).any(-1)
        out_dtype = (getattr(torch, cfg.COMPUTE_DTYPE)
                     if cfg.COMPUTE_DTYPE != 'auto' else points.dtype)
        shape = tuple(cfg.SPARSE_SHAPE)
        cs, n_sites = _entry(flat, pmask, cfg, out_dtype)
        i32 = torch.int32
        diag = {'lidar_dropped_sites_entry':
                (n_sites - cs.zmask.sum()).to(i32),
                'lidar_columns_stage1': cs.col_mask.sum(-1).max().to(i32)}
        feats = cs.feats
        zmasks, columns, strided = [], [], []
        self.last_n_dropped = {}
        for s in range(1, DENSE_TAIL_FROM_STAGE):
            geo = column_geometry(cs, shape[:2], cfg)
            self.last_n_dropped[f'stage{s}'] = geo.n_dropped
            zmasks.append(cs.zmask)
            columns.append(geo)
            down = getattr(self, f'down{s}')
            sgeo = stacked_strided_geometry(cs, *down.conv, shape,
                                            down.out_cap(shape))
            strided.append(sgeo)
            cs, shape = sgeo.out, sgeo.shape
            per_cloud = cs.col_mask.sum(-1)
            diag[f'lidar_columns_stage{s + 1}'] = per_cloud.max().to(i32)
            diag[f'lidar_column_cap_hit_stage{s + 1}'] = (
                per_cloud == cs.col_mask.shape[-1]).any().to(i32)
        # dense tail: (N, X, Y, Z) occupancy of each stage, then conv_out's
        idx, mask = SC.dense_cells(cs.col_ids, cs.col_mask, cs.zmask, shape)
        masks = [mask]
        for s in range(DENSE_TAIL_FROM_STAGE, len(cfg.ENCODER_CHANNELS)):
            masks.append(getattr(self, f'down{s}').out_mask(masks[-1]))
        masks.append(self.conv_out.out_mask(masks[-1]))
        self.last_diagnostics = diag
        return LadderGeo(feats, zmasks, columns, strided, idx, masks,
                         (B, T), out_dtype)

    def _run(self, module, *args):
        """``module(*args)``, checkpointed under REMAT_LADDER when a
        backward pass will follow (its BN statistics frozen in the
        recompute)."""
        if self.cfg.REMAT_LADDER and self.training and \
                torch.is_grad_enabled():
            return remat(module, module, None, *args)
        return module(*args)

    def ladder(self, feats, geo: LadderGeo):
        """The learned part: stage-1 column features (N, V1, nz1*Cin) over
        ``geo`` -> (B, T, OUTPUT_CHANNELS * nz, X, Y) in the branch's
        type."""
        cfg = self.cfg
        h = feats
        for s in range(1, DENSE_TAIL_FROM_STAGE):
            zmask, cgeo = geo.zmasks[s - 1], geo.columns[s - 1]
            if s == 1:
                h = self._run(self.conv_input, h, zmask, cgeo)
            for block in self._blocks(s):
                h = self._run(block, h, zmask, cgeo)
            h = self._run(getattr(self, f'down{s}'), h, zmask.shape[-1],
                          geo.strided[s - 1])

        # dense tail: (N, C, X, Y, Z) grids and (N, X, Y, Z) occupancy
        last = geo.strided[-1]
        c = cfg.ENCODER_CHANNELS[DENSE_TAIL_FROM_STAGE - 2][-1]
        x = SC.dense_features(h, last.out.zmask, geo.dense_idx, last.shape,
                              c).permute(0, 4, 1, 2, 3)
        n_stages = len(cfg.ENCODER_CHANNELS)
        for s in range(DENSE_TAIL_FROM_STAGE, n_stages + 1):
            mask = geo.dense_masks[s - DENSE_TAIL_FROM_STAGE]
            for block in self._blocks(s):
                x = self._run(block, x, mask, DENSE)
            if s < n_stages:             # the last stage has no down conv
                x = self._run(getattr(self, f'down{s}'), x,
                              geo.dense_masks[s - DENSE_TAIL_FROM_STAGE + 1])
        x = self._run(self.conv_out, x, geo.dense_masks[-1])
        _, ch, nx, ny, nz = x.shape
        # channel c*nz + z, as the reference's dense view
        x = x.permute(0, 1, 4, 2, 3).reshape(*geo.batch, ch * nz, nx, ny)
        return x.to(geo.out_dtype)

    def forward(self, points):
        geo = self.geometry(points)
        return self.ladder(geo.feats, geo)
