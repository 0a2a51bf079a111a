"""Per-bin sums of rows by id, with the optional pillar-statistics epilogue.

Port of streamingflow_tpu/ops/pallas_bin.py::bin_sum.  On a CUDA tensor
:func:`bin_sum` launches the hand-written kernel csrc/bin_sum.cu (one block
per 2048-bin tile, sums in shared memory, epilogue fused, output written
once in its final type); on a CPU tensor it takes the plain PyTorch version
:func:`bin_sum_plain`, which sums in fp32 as the JAX package's XLA fallback
does.  There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib

BINS_PER_TILE = 2048
# shared memory holds C x 2048 fp32 sums: 27 channels = 216 KiB of the
# 227 KiB a Hopper block may take
MAX_KERNEL_CHANNELS = 27

# kernel launches since the last reset (chip_smoke.py reads it)
launches = 0


def pillar_finalize(acc: torch.Tensor, n_feat: int) -> torch.Tensor:
    """(C, bins) sums of [count, n_feat point features, z^2, z-occupancy]
    -> [log1p(count), feature means, z std, occupancy clamped to 1], zero
    where the count is 0 (pillar_encoder.py::_pillar_finalize in JAX)."""
    c = n_feat
    count = acc[0:1]
    denom = count.clamp(min=1.0)
    mean = acc[1:1 + c] / denom
    z_mean = mean[2:3]
    z_var = (acc[1 + c:2 + c] / denom - z_mean * z_mean).clamp(min=0.0)
    occ = acc[2 + c:].clamp(max=1.0)
    out = torch.cat([torch.log1p(count), mean, torch.sqrt(z_var), occ], 0)
    return torch.where(count > 0, out, torch.zeros_like(out))


def bin_sum_plain(data: torch.Tensor, ids: torch.Tensor, n_bins: int,
                  pillar_features: Optional[int] = None,
                  out_dtype: torch.dtype = torch.float32,
                  transposed_out: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`bin_sum` (fp32 index_add_)."""
    ids = ids.clamp(0, n_bins - 1).long()
    sums = torch.zeros(n_bins, data.shape[1], dtype=torch.float32,
                       device=data.device)
    out = sums.index_add_(0, ids, data.float()).t()
    if pillar_features is not None:
        out = pillar_finalize(out, pillar_features)
    return (out if transposed_out else out.t()).to(out_dtype)


def bin_sum(data: torch.Tensor, ids: torch.Tensor, n_bins: int,
            pillar_features: Optional[int] = None,
            out_dtype: torch.dtype = torch.float32, presorted: bool = False,
            transposed_out: bool = False) -> torch.Tensor:
    """Sum rows of ``data`` (P, C) into ``n_bins`` bins by ``ids`` (P,).

    Out-of-range ids are clipped.  ``pillar_features`` = c applies the
    pillar epilogue (:func:`pillar_finalize`) to the sums of
    [count, c features, z^2, z bins].  Returns (n_bins, C) in ``out_dtype``,
    or (C, n_bins) with ``transposed_out``.  ``presorted``: rows already
    grouped by 2048-bin tile (the loader's tile sort), so the kernel path
    skips its stable sort; the result does not depend on it."""
    if data.device.type == 'cpu':
        return bin_sum_plain(data, ids, n_bins, pillar_features, out_dtype,
                             transposed_out)
    if data.device.type != 'cuda':
        raise ValueError(f'bin_sum: unsupported device {data.device}')
    return _bin_sum_cuda(data, ids, n_bins, pillar_features, out_dtype,
                         presorted, transposed_out)


def _bin_sum_cuda(data, ids, n_bins, pillar_features, out_dtype, presorted,
                  transposed_out):
    global launches
    if data.dim() != 2 or ids.shape != data.shape[:1]:
        raise ValueError(f'bin_sum: data {tuple(data.shape)} and ids '
                         f'{tuple(ids.shape)} must be (P, C) and (P,)')
    if data.dtype != torch.float32 or not data.is_contiguous():
        raise ValueError('bin_sum kernel takes contiguous float32 rows')
    if ids.device != data.device or ids.dtype not in (torch.int32,
                                                      torch.int64):
        raise ValueError('bin_sum: ids must be integers on the data device')
    c = data.shape[1]
    if not 1 <= c <= MAX_KERNEL_CHANNELS:
        raise ValueError(f'bin_sum kernel takes 1..{MAX_KERNEL_CHANNELS} '
                         f'channels, got {c}')
    if pillar_features is not None and not 3 <= pillar_features <= c - 2:
        raise ValueError(f'pillar epilogue: {pillar_features} features do '
                         f'not fit {c} channels')
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'bin_sum kernel writes float32 or bfloat16, not '
                         f'{out_dtype}')
    if not 0 < n_bins < 2 ** 31 - BINS_PER_TILE:
        raise ValueError(f'bin_sum: n_bins {n_bins} out of range')

    ids = ids.clamp(0, n_bins - 1).to(torch.int32)
    if not presorted:
        ids, order = torch.sort(ids, stable=True)
        data = data[order]
    n_tiles = -(-n_bins // BINS_PER_TILE)
    tile_starts = torch.arange(n_tiles + 1, dtype=torch.int32,
                               device=data.device)
    offsets = torch.searchsorted(ids // BINS_PER_TILE, tile_starts,
                                 out_int32=True)
    out = torch.empty(c, n_bins, dtype=out_dtype, device=data.device)
    err = cuda_lib.kernel('bin_sum')(
        data.data_ptr(), ids.data_ptr(), offsets.data_ptr(), out.data_ptr(),
        n_tiles, n_bins, c, -1 if pillar_features is None else pillar_features,
        int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(data.device).cuda_stream)
    cuda_lib.check('bin_sum', err)
    launches += 1
    return out if transposed_out else out.t()
