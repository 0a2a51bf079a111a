"""Sparse LiDAR backbone ("spconv8x"): every engine, z formulation and
dense-tail stage of the JAX package.

Port of streamingflow_tpu/models/lidar_encoder.py::LidarBEVEncoder, the
reference's mmdet3d SparseEncoder (channels [[16,16,32],[32,32,64],
[64,64,128],[128,128]], BN eps 1e-3):

  points -> voxelize (fp32 binning, mean in COMPUTE_DTYPE)
         -> conv_input, stages 1-4 of submanifold convs (basic blocks)
            joined by strided convs down1-3
         -> conv_out (1,1,3)/(1,1,2) -> (B, T, OUTPUT_CHANNELS * nz, X, Y)
            with channel c*nz + z (nz = 2 at the flagship).

SPARSE_ENCODER.ENGINE picks how the sparse convs run:

- 'column' (ops/sparse_columns.py): (x, y)-sparse columns with a dense z
  axis, z-fused (V, nz*C) features; the submanifold convs are K3
  (ops/winfuse.py; the hand kernel on the card), the strided convs plain
  column convs.  Stages from DENSE_TAIL_FROM_STAGE (1-4; 5 = conv_out only;
  0 = none) leave the columns for dense (N, C, X, Y, Z) grids (F.conv3d, the
  masked BN restoring the active set); conv_input always runs on columns.
  Z_FORMULATION: 'sep', 'banded' and 'conv' are one function (the JAX
  package's three matmul shapes of the same sums), 'winfuse' and 'win'
  drop the taps their TPU window plans drop (ops/winfuse.py::fused_found,
  window_found).
- 'gather' (ops/sparse.py): site rows and per-stage site caps
  (STAGE_CAPS), a gathered neighbourhood product per conv.
- 'tiled' (ops/sparse_tiled.py): the gather engine's sums under the tiled
  engine's capacity rule (occupied 8x8x8 tiles capped at TILE_CAPS).

The JAX encoder treats any ENGINE other than 'column' and 'tiled' as
'gather'; this port accepts the three documented names and raises
ValueError for any other, as it does for an unknown Z_FORMULATION or a
DENSE_TAIL_FROM_STAGE outside 0-5.

Submodule and parameter names are the flax paths under every setting
(``down{s}`` and ``conv_out`` hold ``kernel`` and ``MaskedBatchNorm_0``
whatever they run on), so one state_dict loads into each; the conv weights
keep the JAX (taps, Cin, Cout) layout (convert.py reads ``JAX_LAYOUT``).
The clouds of a batch go through each conv together (one K3 launch).

A forward is :meth:`LidarBEVEncoder.geometry` (voxelize, the maps, the
strided convs' taps and output sites or columns, the capacity rules, the
dense tail's occupancy: no gradient, computed once) and
:meth:`LidarBEVEncoder.ladder` (the learned part).  In train mode the
masked BNs take batch statistics.  On the column engine
SPARSE_ENCODER.REMAT_LADDER recomputes each submanifold conv, basic block
and down conv in the backward pass (``torch.utils.checkpoint``), with the
geometry outside every checkpoint; the site engines have no per-block
remat in the JAX package (MODEL.REMAT checkpoints their whole ladder,
models/streamingflow.py).
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import SparseEncoderConfig
from ..layers.trainmode import BatchNorm, global_moments, remat
from ..ops import sparse as S
from ..ops import sparse_columns as SC
from ..ops import sparse_tiled as ST
from ..ops.voxelize import LARGE_ID, linearize, voxelize
from ..ops.winfuse import (fused_found, reverse_map, subm_conv_winfuse,
                           window_found)

ENGINES = ('column', 'gather', 'tiled')
FORMULATIONS = ('winfuse', 'win', 'sep', 'banded', 'conv')
DENSE_TAIL_STAGES = tuple(range(6))
# the strided convs: down1-3 (3x3x3, stride 2), then conv_out
STAGE_PADDINGS = ((1, 1, 1), (1, 1, 1), (1, 1, 0))
CONV_OUT = ((1, 1, 3), (1, 1, 2), (0, 0, 0))
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
    """BatchNorm over the active sites, in three layouts: fused columns x
    (..., V, nz*C) with mask (..., V, nz); site rows x (..., V, C) with mask
    (..., V), told apart by the mask's rank as the JAX package's ``_cin_of``
    does (a site row is a fused column of one z); and dense grids x (N, C,
    X, Y, Z) with mask (N, X, Y, Z).  Normalises in the input's type and
    zeroes the inactive sites.

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
        if mask.dim() == x.dim() - 1 and x.dim() < 5:
            mask = mask[..., None]                # site rows
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
    the forward takes ('winfuse' and 'win': their window plans' kept taps),
    the taps those plans dropped in each cloud (N,) int32; for the
    backward, grad_found (9, N*V) the taps it takes and src_t (9, N*V)
    their reversal (ops/winfuse.py::reverse_map): under 'winfuse' the map's
    full found, as the JAX package's ``_winfuse_bwd`` takes every found
    tap; under the other formulations, whose JAX gradient is autodiff of
    their forward ('win': dropped taps get none), ``found``."""
    nbr: torch.Tensor
    found: torch.Tensor
    n_dropped: Optional[torch.Tensor]
    grad_found: Optional[torch.Tensor] = None
    src_t: Optional[torch.Tensor] = None


class SiteGeo(NamedTuple):
    """A conv over the site rows of stacked clouds: src (K, N*V_out) long,
    the input row (of the N*V_in stacked rows) under each tap of every
    output row, N*V_in (a zero row) where the tap finds no site."""
    src: torch.Tensor


class DenseGrid:
    """Geometry sentinel of the dense-tail stages."""


DENSE = DenseGrid()


def _conv3d(x, w, kernel, stride=(1, 1, 1), padding=(1, 1, 1)):
    """x (N, C, X, Y, Z) with the x-major (prod(kernel), Cin, Cout) taps."""
    w5 = w.reshape(*kernel, w.shape[1], w.shape[2]).permute(4, 3, 0, 1, 2)
    return F.conv3d(x, w5.to(x.dtype), stride=stride, padding=padding)


def subm(feats, mask, geo, w):
    """Submanifold 3x3x3 conv: fused columns (N, V, nz*Cin) over a
    ColumnGeo, site rows (N, V, Cin) over a SiteGeo, or a dense grid (N,
    Cin, X, Y, Z) under DENSE.  Inactive outputs are not zeroed: the masked
    BN after every conv zeroes them."""
    if isinstance(geo, DenseGrid):
        return _conv3d(feats, w, (3, 3, 3))
    n, v, c = feats.shape
    if isinstance(geo, SiteGeo):
        return S.gather_product(feats.reshape(n * v, c), geo.src,
                                w).reshape(n, v, -1)
    out = subm_conv_winfuse(feats.reshape(n * v, -1), geo.nbr, geo.found, w,
                            mask.shape[-1], grad_found=geo.grad_found,
                            src_t=geo.src_t)
    return out.reshape(n, v, -1)


def _voxel_sets(points, point_mask, cfg: SparseEncoderConfig, out_dtype):
    """Clouds (N, P, C) -> each cloud's voxel set and its ids re-linearised
    into SPARSE_SHAPE (the voxel grid's z, 40 at the flagship, in
    SPARSE_SHAPE's 41; the order of the ids is kept)."""
    shape = tuple(cfg.SPARSE_SHAPE)
    out = []
    for pts, pmask in zip(points, point_mask):
        vox = voxelize(pts, pmask, cfg.POINT_CLOUD_RANGE, cfg.VOXEL_SIZE,
                       cfg.MAX_NUM_POINTS, cfg.MAX_VOXELS, out_dtype=out_dtype)
        out.append((vox, torch.where(vox.mask,
                                     linearize(vox.coords.long(), shape),
                                     LARGE_ID)))
    return out


def _entry(points, point_mask, cfg: SparseEncoderConfig, out_dtype
           ) -> Tuple[SC.ColumnSet, torch.Tensor]:
    """Clouds (N, P, C) -> their stage-1 column sets, stacked (N, ...), and
    the number of voxel sites of all clouds (int64 device scalar)."""
    shape = tuple(cfg.SPARSE_SHAPE)
    cap0 = min(cfg.COLUMN_CAPS[0], shape[0] * shape[1])
    sets, n_sites = [], 0
    for vox, ids in _voxel_sets(points, point_mask, cfg, out_dtype):
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
    'winfuse' or 'win' plan keeps (every found tap under the other
    formulations), and the taps and the reversed map that the gradient
    takes (:class:`ColumnGeo`)."""
    n, cap = cs.col_ids.shape
    form = cfg.Z_FORMULATION
    nbrs, founds, fulls, drops = [], [], [], []
    for i in range(n):
        cmap = SC.build_column_map(SC.cloud(cs, i), grid)
        found = cmap.found
        dropped = torch.zeros((), dtype=torch.int32, device=found.device)
        if form == 'winfuse':
            found, dropped = fused_found(cmap, cfg.WINDOW_BLOCK,
                                         cfg.WINFUSE_WINDOW,
                                         cfg.WINDOW_RESID_BLOCKS)
        elif form == 'win':
            found, dropped = window_found(cmap, cfg.WINDOW_BLOCK,
                                          cfg.WINDOW_WIDTH,
                                          cfg.WINDOW_RESID_BLOCKS)
        nbrs.append(cmap.nbr + i * cap)
        founds.append(found)
        fulls.append(cmap.found)
        drops.append(dropped)
    nbr = torch.cat(nbrs, 1).int()
    found = torch.cat(founds, 1)
    grad = torch.cat(fulls, 1) if form == 'winfuse' else found
    return ColumnGeo(nbr, found, torch.stack(drops), grad,
                     reverse_map(nbr, grad, n * cap))


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


class DenseEntry(NamedTuple):
    """The dense tail's entry: idx the flat cell of each column slot of the
    last column stage (:func:`ops.sparse_columns.dense_cells`), zmask and
    shape of that stage, and the (N, X, Y, Z) occupancy of each dense
    stage, then of conv_out's output."""
    idx: torch.Tensor
    zmask: torch.Tensor
    shape: Tuple[int, int, int]
    masks: List[torch.Tensor]


class LadderGeo(NamedTuple):
    """What a column-engine forward's ladder runs over, none of it taking a
    gradient: feats (N, V1, nz1*Cin) the voxel features in stage-1 columns;
    per column stage its zmask (N, V, nz) and ColumnGeo (stage 1's always:
    conv_input runs on columns), and each column strided conv's geometry;
    conv_out's when it runs on columns (DENSE_TAIL_FROM_STAGE 0), else the
    dense tail's entry; the (B, T) of the clouds and the branch's type."""
    feats: torch.Tensor
    zmasks: List[torch.Tensor]
    columns: List[ColumnGeo]
    strided: List[SC.StridedGeo]
    conv_out: Optional[SC.StridedGeo]
    dense: Optional[DenseEntry]
    batch: Tuple[int, int]
    out_dtype: torch.dtype


class SiteStage(NamedTuple):
    """A stage of the site engines: its submanifold convs' SiteGeo and kept
    (N, V) bool, the sites they run over and their BNs take statistics
    over ('gather': every active site; 'tiled': those whose tile is under
    the stage's TILE_CAPS)."""
    subm: SiteGeo
    kept: torch.Tensor


class SiteDown(NamedTuple):
    """A strided conv of the site engines: its SiteGeo into the stage's
    sites, its output sites' mask (N, V_out), and for 'tiled' src_kept
    (N, V_out), the output site's least contributing input site is kept
    (None for 'gather')."""
    conv: SiteGeo
    mask: torch.Tensor
    src_kept: Optional[torch.Tensor]


class SiteLadderGeo(NamedTuple):
    """What a site-engine forward's ladder runs over: feats (N, V0, Cin)
    the voxel features; the four stages and the four strided convs (down1-3,
    conv_out); conv_out's output coords (N, V, 3) and grid; the (B, T) of
    the clouds and the branch's type."""
    feats: torch.Tensor
    stages: List[SiteStage]
    downs: List[SiteDown]
    out_coords: torch.Tensor
    out_shape: Tuple[int, int, int]
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


class SparseConvBNReLU(nn.Module):
    """Strided sparse conv + BN + ReLU over the site rows of stacked clouds
    (the 'gather' and 'tiled' engines): the gathered taps' product into the
    output sites, under 'tiled' zero where the output site's least
    contributing input site lies in a dropped tile; every output site
    counts in the BN."""
    JAX_LAYOUT = True

    def __init__(self, cin, cout, kernel, stride, padding, cap):
        super().__init__()
        self.conv = (tuple(kernel), tuple(stride), tuple(padding))
        self.cap = cap
        self.kernel = _tap_weights(math.prod(kernel), cin, cout)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(cout)

    def forward(self, feats, down: SiteDown):
        n, v_in, c = feats.shape
        out = S.gather_product(feats.reshape(n * v_in, c), down.conv.src,
                               self.kernel).reshape(n, -1,
                                                    self.kernel.shape[2])
        if down.src_kept is not None:
            out = torch.where(down.src_kept[..., None], out, 0)
        return F.relu(self.MaskedBatchNorm_0(out, down.mask))


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

    After each forward on the column engine ``last_n_dropped`` holds the
    taps 'winfuse' or 'win' dropped per column stage ({'stage1': (N,),
    ...} device tensors) and ``last_diagnostics`` the JAX package's sown
    'diagnostics' (int32 device scalars, nothing read to the host):
    ``lidar_dropped_sites_entry`` (voxel sites less those the entry's
    column cap kept), ``lidar_columns_stage1`` and, for each column strided
    conv down{s}, ``lidar_columns_stage{s+1}`` (the most active columns of
    a cloud) and ``lidar_column_cap_hit_stage{s+1}`` (1 when a cloud filled
    its column cap: columns were dropped).  The site engines sow nothing
    in the JAX package; there ``last_capacity`` holds, per stage, the most
    active sites of a cloud (``sites_stage{s}``), whether a strided conv
    filled its STAGE_CAPS (``site_cap_hit_stage{s}``) and, under 'tiled',
    the sites past the tile caps (``tile_dropped_sites_stage{s}``).

    On the column engine SPARSE_ENCODER.REMAT_LADDER (train mode, gradients
    on) checkpoints each submanifold conv, basic block and down conv on its
    own.  The JAX package nests that per-block remat inside MODEL.REMAT's
    remat of the whole encoder; remat never changes the function, so the
    port's per-block checkpoints alone give the same values and gradients
    (models/streamingflow.py checkpoints the whole ladder when
    ``remat_ladder`` is off)."""

    def __init__(self, cfg: SparseEncoderConfig):
        super().__init__()
        for key, allowed in (('ENGINE', ENGINES),
                             ('Z_FORMULATION', FORMULATIONS),
                             ('DENSE_TAIL_FROM_STAGE', DENSE_TAIL_STAGES)):
            if getattr(cfg, key) not in allowed:
                raise ValueError(f'SPARSE_ENCODER.{key}={getattr(cfg, key)!r}'
                                 f' is not one of {allowed}')
        self.cfg = cfg
        self.column = cfg.ENGINE == 'column'
        n_stages = len(cfg.ENCODER_CHANNELS)
        tail = cfg.DENSE_TAIL_FROM_STAGE
        # stages whose blocks run on columns (conv_input always does)
        self.n_column = (0 if not self.column else n_stages if tail == 0
                         else min(tail - 1, n_stages))
        self.last_n_dropped: Dict[str, torch.Tensor] = {}
        self.last_diagnostics: Dict[str, torch.Tensor] = {}
        self.last_capacity: Dict[str, torch.Tensor] = {}
        self.conv_input = SubMConvBNReLU(cfg.IN_CHANNELS, cfg.BASE_CHANNELS)
        prev = cfg.BASE_CHANNELS
        for i, blocks in enumerate(cfg.ENCODER_CHANNELS):
            for j, ch in enumerate(blocks):
                if j == len(blocks) - 1 and i != n_stages - 1:
                    self.add_module(f'down{i + 1}', self._strided(
                        prev, ch, ((3, 3, 3), (2, 2, 2), STAGE_PADDINGS[i]),
                        i + 1, i + 1 <= self.n_column))
                else:
                    self.add_module(f'stage{i + 1}_block{j}',
                                    SparseBasicBlock(ch))
                prev = ch
        self.conv_out = self._strided(prev, cfg.OUTPUT_CHANNELS, CONV_OUT,
                                      -1, self.column and tail == 0)
        # BEV channels: OUTPUT_CHANNELS times the z left after the ladder
        # (41 -> 21 -> 11 -> 5 -> 2 at the flagship)
        shape = tuple(cfg.SPARSE_SHAPE)
        for p in STAGE_PADDINGS:
            shape = SC.conv_out_shape(shape, (3, 3, 3), (2, 2, 2), p)
        nz = SC.conv_out_shape(shape, *CONV_OUT)[2]
        self.out_channels = cfg.OUTPUT_CHANNELS * nz

    def _strided(self, cin, cout, conv, stage, on_columns):
        """down{stage} (conv_out for stage -1) on the engine's layout."""
        cfg = self.cfg
        if not self.column:
            return SparseConvBNReLU(cin, cout, *conv, cfg.STAGE_CAPS[stage])
        if on_columns:
            return ColumnSparseConvBNReLU(cin, cout, *conv,
                                          cfg.COLUMN_CAPS[stage])
        return DenseConvBNReLU(cin, cout, *conv)

    @property
    def remat_ladder(self) -> bool:
        """Whether the encoder checkpoints each block itself."""
        return self.column and self.cfg.REMAT_LADDER

    def _blocks(self, s: int) -> List[nn.Module]:
        n_stages = len(self.cfg.ENCODER_CHANNELS)
        down = s < n_stages
        return [getattr(self, f'stage{s}_block{j}')
                for j in range(len(self.cfg.ENCODER_CHANNELS[s - 1]) - down)]

    def _strided_convs(self) -> List[nn.Module]:
        """down1 .. down{n-1}, then conv_out."""
        n_stages = len(self.cfg.ENCODER_CHANNELS)
        return [getattr(self, f'down{s}') for s in range(1, n_stages)] + \
            [self.conv_out]

    def geometry(self, points):
        """Everything of a forward that takes no gradient; sets
        ``last_n_dropped``, ``last_diagnostics`` and ``last_capacity``."""
        cfg = self.cfg
        B, T, P, C = points.shape
        flat = points.reshape(B * T, P, C)
        # zero rows are padding (the reference pads clouds with zeros)
        pmask = (flat[..., :3] != 0).any(-1)
        out_dtype = (getattr(torch, cfg.COMPUTE_DTYPE)
                     if cfg.COMPUTE_DTYPE != 'auto' else points.dtype)
        self.last_n_dropped, self.last_diagnostics = {}, {}
        self.last_capacity = {}
        if self.column:
            return self._column_geometry(flat, pmask, out_dtype, (B, T))
        return self._site_geometry(flat, pmask, out_dtype, (B, T))

    def _column_geometry(self, flat, pmask, out_dtype, batch) -> LadderGeo:
        cfg = self.cfg
        n_stages = len(cfg.ENCODER_CHANNELS)
        shape = tuple(cfg.SPARSE_SHAPE)
        cs, n_sites = _entry(flat, pmask, cfg, out_dtype)
        i32 = torch.int32
        diag = {'lidar_dropped_sites_entry':
                (n_sites - cs.zmask.sum()).to(i32),
                'lidar_columns_stage1': cs.col_mask.sum(-1).max().to(i32)}
        feats = cs.feats
        zmasks, columns, strided = [], [], []
        for s in range(1, max(self.n_column, 1) + 1):
            geo = column_geometry(cs, shape[:2], cfg)
            self.last_n_dropped[f'stage{s}'] = geo.n_dropped
            zmasks.append(cs.zmask)
            columns.append(geo)
            if s > self.n_column or s == n_stages:
                continue
            down = getattr(self, f'down{s}')
            sgeo = stacked_strided_geometry(cs, *down.conv, shape,
                                            down.out_cap(shape))
            strided.append(sgeo)
            cs, shape = sgeo.out, sgeo.shape
            per_cloud = cs.col_mask.sum(-1)
            diag[f'lidar_columns_stage{s + 1}'] = per_cloud.max().to(i32)
            diag[f'lidar_column_cap_hit_stage{s + 1}'] = (
                per_cloud == cs.col_mask.shape[-1]).any().to(i32)
        self.last_diagnostics = diag
        conv_out = dense = None
        if isinstance(self.conv_out, ColumnSparseConvBNReLU):
            conv_out = stacked_strided_geometry(
                cs, *self.conv_out.conv, shape, self.conv_out.out_cap(shape))
        else:
            # dense tail: (N, X, Y, Z) occupancy of each stage, then
            # conv_out's
            idx, mask = SC.dense_cells(cs.col_ids, cs.col_mask, cs.zmask,
                                       shape)
            masks = [mask]
            for s in range(self.n_column + 1, n_stages):
                masks.append(getattr(self, f'down{s}').out_mask(masks[-1]))
            masks.append(self.conv_out.out_mask(masks[-1]))
            dense = DenseEntry(idx, cs.zmask, shape, masks)
        return LadderGeo(feats, zmasks, columns, strided, conv_out, dense,
                         batch, out_dtype)

    def _site_geometry(self, flat, pmask, out_dtype, batch
                       ) -> SiteLadderGeo:
        cfg = self.cfg
        tiled = cfg.ENGINE == 'tiled'
        tile = tuple(cfg.TILE_SHAPE)
        shape = tuple(cfg.SPARSE_SHAPE)
        vox = _voxel_sets(flat, pmask, cfg, out_dtype)
        feats = torch.stack([v.feats for v, _ in vox])
        sts = [S.SparseTensor(None, v.coords, ids, v.mask, shape)
               for v, ids in vox]
        cap = self.last_capacity
        stages, downs = [], []
        for i, conv in enumerate(self._strided_convs()):
            v_in = sts[0].ids.shape[0]
            masks = torch.stack([st.mask for st in sts])
            kept = masks
            if tiled:
                t_cap = ST.stage_tile_cap(cfg.TILE_CAPS[i], shape, tile)
                kept = torch.stack([ST.build_tile_map(
                    st.coords, st.ids, st.mask, shape, t_cap, tile).kept
                    for st in sts])
                cap[f'tile_dropped_sites_stage{i + 1}'] = \
                    (masks & ~kept).sum()
            cap[f'sites_stage{i + 1}'] = masks.sum(-1).max()
            stages.append(SiteStage(SiteGeo(S.stacked_src(
                [S.build_neighbor_map(st) for st in sts], v_in)), kept))
            out_shape = S.conv_out_shape(shape, *conv.conv)
            sites = [S.generate_output_sites(st, *conv.conv, out_shape,
                                             conv.cap, return_nmap=True,
                                             return_src=tiled)
                     for st in sts]
            out_mask = torch.stack([o.mask for o in sites])
            src_kept = (torch.stack([kept[j][o.src] for j, o in
                                     enumerate(sites)]) & out_mask
                        if tiled else None)
            if i + 1 < len(cfg.ENCODER_CHANNELS):
                cap[f'site_cap_hit_stage{i + 2}'] = \
                    (out_mask.sum(-1) == conv.cap).any()
            downs.append(SiteDown(SiteGeo(S.stacked_src(
                [o.nmap for o in sites], v_in)), out_mask, src_kept))
            sts = [S.SparseTensor(None, o.coords, o.ids, o.mask, out_shape)
                   for o in sites]
            shape = out_shape
        coords = torch.stack([st.coords for st in sts])
        return SiteLadderGeo(feats, stages, downs, coords, shape, batch,
                             out_dtype)

    def _run(self, module, *args):
        """``module(*args)``, checkpointed under REMAT_LADDER when a
        backward pass will follow (its BN statistics frozen in the
        recompute)."""
        if self.remat_ladder and self.training and torch.is_grad_enabled():
            return remat(module, module, None, *args)
        return module(*args)

    def ladder(self, feats, geo):
        """The learned part: the entry's features (stage-1 columns (N, V1,
        nz1*Cin), or voxel site rows (N, V0, Cin)) over ``geo`` -> (B, T,
        OUTPUT_CHANNELS * nz, X, Y) in the branch's type."""
        if self.column:
            return self._column_ladder(feats, geo)
        return self._site_ladder(feats, geo)

    def _column_ladder(self, feats, geo: LadderGeo):
        cfg = self.cfg
        n_stages = len(cfg.ENCODER_CHANNELS)
        h = feats
        for s, (zmask, cgeo) in enumerate(zip(geo.zmasks, geo.columns), 1):
            if s == 1:
                h = self._run(self.conv_input, h, zmask, cgeo)
            if s > self.n_column:
                break
            for block in self._blocks(s):
                h = self._run(block, h, zmask, cgeo)
            if s < n_stages:
                h = self._run(getattr(self, f'down{s}'), h, zmask.shape[-1],
                              geo.strided[s - 1])
        if geo.conv_out is not None:
            o = geo.conv_out
            h = self._run(self.conv_out, h, geo.zmasks[-1].shape[-1], o)
            nx, ny, nz = o.shape
            bev = SC.to_dense_bev(o.out._replace(feats=h), (nx, ny), nz,
                                  cfg.OUTPUT_CHANNELS)
            return bev.permute(0, 3, 1, 2).reshape(
                *geo.batch, -1, nx, ny).to(geo.out_dtype)

        # dense tail: (N, C, X, Y, Z) grids and (N, X, Y, Z) occupancy
        d = geo.dense
        c = h.shape[-1] // d.zmask.shape[-1]
        x = SC.dense_features(h, d.zmask, d.idx, d.shape, c).permute(
            0, 4, 1, 2, 3)
        first = self.n_column + 1
        for s in range(first, n_stages + 1):
            mask = d.masks[s - first]
            for block in self._blocks(s):
                x = self._run(block, x, mask, DENSE)
            if s < n_stages:             # the last stage has no down conv
                x = self._run(getattr(self, f'down{s}'), x,
                              d.masks[s - first + 1])
        x = self._run(self.conv_out, x, d.masks[-1])
        _, ch, nx, ny, nz = x.shape
        # channel c*nz + z, as the reference's dense view
        x = x.permute(0, 1, 4, 2, 3).reshape(*geo.batch, ch * nz, nx, ny)
        return x.to(geo.out_dtype)

    def _site_ladder(self, feats, geo: SiteLadderGeo):
        tiled = self.cfg.ENGINE == 'tiled'
        h = feats
        for s, (stage, down, conv) in enumerate(
                zip(geo.stages, geo.downs, self._strided_convs()), 1):
            if tiled:
                # a stage holds only its kept tiles' sites
                h = torch.where(stage.kept[..., None], h, 0)
            if s == 1:
                h = self.conv_input(h, stage.kept, stage.subm)
            for block in self._blocks(s):
                h = block(h, stage.kept, stage.subm)
            h = conv(h, down)
        # densify: (N, nx, ny, nz, C) -> channel c*nz + z (the reference's
        # dense view, sparse_encoder.py:126-133)
        nx, ny, nz = geo.out_shape
        dense = torch.stack([S.to_dense(S.SparseTensor(
            f, c, None, m, geo.out_shape)) for f, c, m in
            zip(h, geo.out_coords, geo.downs[-1].mask)])
        x = dense.permute(0, 4, 3, 1, 2).reshape(*geo.batch, -1, nx, ny)
        return x.to(geo.out_dtype)

    def forward(self, points):
        geo = self.geometry(points)
        return self.ladder(geo.feats, geo)
