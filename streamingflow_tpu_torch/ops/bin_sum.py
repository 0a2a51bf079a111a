"""Per-bin sums of rows by id, with the optional pillar-statistics epilogue.

Port of streamingflow_tpu/ops/pallas_bin.py::bin_sum.  On a CUDA tensor
:func:`bin_sum` launches the hand-written kernel csrc/bin_sum.cu (a block
per 512-bin sub-tile of a 2048-bin tile, sums in shared memory, epilogue
fused, output written once in its final type with 16-byte stores); on a
CPU tensor it takes the plain PyTorch version :func:`bin_sum_plain`, which
sums in fp32 as the JAX package's XLA fallback does.  There is no fallback
from the kernel to the plain version.

:func:`bin_sum_clouds` sums several clouds in one launch: each cloud's ids
are offset by a multiple of the tile, so no tile straddles two clouds (the
JAX package's ``pillarize_batch``), and the kernel writes each cloud's
bins straight into its slice of one (clouds, C, bins) output.

:func:`bin_sum_grouped` is the same function through the grouped kernel
csrc/bin_sum_grouped.cu (the JAX package's experiment
tools/exp_bin_variants.py::bin_sum_grouped: ``k_tiles`` consecutive tiles a
block, an empty tile written as zeros without accumulating).  The model
keeps :func:`bin_sum`; tools/exp_bin_variants.py of this package times one
against the other.

The kernels take ids grouped by 2048-bin tile (the loader's tile sort) and
the first row of each tile (:func:`tile_bounds`, one ``searchsorted``);
they clip the ids themselves.  :func:`launch` runs a kernel on prepared
inputs.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import cuda_lib

BINS_PER_TILE = 2048
# one row is summed by a group of up to 32 lanes, lane c its channel c
MAX_KERNEL_CHANNELS = 32

# launches of csrc/bin_sum.cu and of csrc/bin_sum_grouped.cu since the last
# reset (chip_smoke.py reads them)
launches = 0
launches_grouped = 0


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


def bin_sum_clouds_plain(data: torch.Tensor, ids: torch.Tensor,
                         n_clouds: int, bins_per_cloud: int, n_store: int,
                         pillar_features: Optional[int] = None,
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Plain PyTorch version of :func:`bin_sum_clouds`."""
    out = bin_sum_plain(data, ids, n_clouds * bins_per_cloud,
                        pillar_features, out_dtype, transposed_out=True)
    return out.reshape(-1, n_clouds, bins_per_cloud)[:, :, :n_store] \
        .transpose(0, 1)


def bin_sum(data: torch.Tensor, ids: torch.Tensor, n_bins: int,
            pillar_features: Optional[int] = None,
            out_dtype: torch.dtype = torch.float32, presorted: bool = False,
            transposed_out: bool = False) -> torch.Tensor:
    """Sum rows of ``data`` (P, C) into ``n_bins`` bins by ``ids`` (P,).

    Out-of-range ids are clipped.  ``pillar_features`` = c applies the
    pillar epilogue (:func:`pillar_finalize`) to the sums of
    [count, c features, z^2, z bins].  Returns (n_bins, C) in ``out_dtype``,
    or (C, n_bins) with ``transposed_out`` (from the kernel a view whose
    rows are padded to a multiple of 8 bins).  ``presorted``: rows already
    grouped by 2048-bin tile (the loader's tile sort), so the kernel path
    skips its stable sort; the result does not depend on it."""
    return _dispatch(data, ids, n_bins, pillar_features, out_dtype, presorted,
                     transposed_out, None)


def bin_sum_clouds(data: torch.Tensor, ids: torch.Tensor, n_clouds: int,
                   bins_per_cloud: int, n_store: int,
                   pillar_features: Optional[int] = None,
                   out_dtype: torch.dtype = torch.float32,
                   presorted: bool = False) -> torch.Tensor:
    """:func:`bin_sum` of ``n_clouds`` clouds in one launch.

    ``ids`` (P,) index ``n_clouds * bins_per_cloud`` bins (clipped), bin j of
    cloud k at ``k * bins_per_cloud + j``; ``bins_per_cloud`` is a multiple
    of BINS_PER_TILE when there are several clouds.  Returns
    (n_clouds, C, n_store): the first ``n_store`` bins of each cloud,
    channel first (a bin past ``n_store``, such as the pillar trash bin, is
    summed by the plain version but never stored).  ``presorted`` as for
    :func:`bin_sum`, of the concatenated rows."""
    if n_clouds < 1 or not 0 < n_store <= bins_per_cloud or (
            n_clouds > 1 and bins_per_cloud % BINS_PER_TILE):
        raise ValueError(f'bin_sum_clouds: {n_clouds} clouds of '
                         f'{bins_per_cloud} bins storing {n_store}: want '
                         f'0 < n_store <= bins_per_cloud, a multiple of '
                         f'{BINS_PER_TILE} for several clouds')
    if data.device.type == 'cpu':
        return bin_sum_clouds_plain(data, ids, n_clouds, bins_per_cloud,
                                    n_store, pillar_features, out_dtype)
    return _bin_sum_cuda(data, ids, n_clouds, bins_per_cloud, n_store,
                         pillar_features, out_dtype, presorted, None)


def bin_sum_grouped(data: torch.Tensor, ids: torch.Tensor, n_bins: int,
                    pillar_features: Optional[int] = None,
                    out_dtype: torch.dtype = torch.float32,
                    presorted: bool = False, transposed_out: bool = False,
                    k_tiles: int = 8) -> torch.Tensor:
    """:func:`bin_sum` through the grouped kernel: one block takes
    ``k_tiles`` consecutive 2048-bin tiles.  Same arguments, same result."""
    if k_tiles < 1:
        raise ValueError(f'bin_sum_grouped: k_tiles {k_tiles} < 1')
    return _dispatch(data, ids, n_bins, pillar_features, out_dtype, presorted,
                     transposed_out, k_tiles)


def _dispatch(data, ids, n_bins, pillar_features, out_dtype, presorted,
              transposed_out, k_tiles):
    """One cloud: the plain version for a CPU tensor, else K1 or K1'."""
    if data.device.type == 'cpu':
        return bin_sum_plain(data, ids, n_bins, pillar_features, out_dtype,
                             transposed_out)
    out = _bin_sum_cuda(data, ids, 1, n_bins, n_bins, pillar_features,
                        out_dtype, presorted, k_tiles)[0]
    return out if transposed_out else out.t()


def padded_bins(n_store: int) -> int:
    """Row length of the kernels' output: ``n_store`` rounded up to 8 bins,
    so every row starts 16-byte aligned."""
    return -(-n_store // 8) * 8


@functools.lru_cache(maxsize=16)
def _tile_starts(n_tiles: int, device: torch.device) -> torch.Tensor:
    return torch.arange(BINS_PER_TILE, n_tiles * BINS_PER_TILE,
                        BINS_PER_TILE, dtype=torch.int32, device=device)


def tile_bounds(ids: torch.Tensor, n_bins: int) -> torch.Tensor:
    """First row of tiles 1 .. n_tiles - 1 of int32 ``ids`` grouped by
    2048-bin tile of the id clipped to [0, n_bins) (int32, n_tiles - 1).
    Clipping keeps the order, and for these tiles a row lies before tile t
    exactly when its unclipped id is below t * 2048."""
    n_tiles = -(-n_bins // BINS_PER_TILE)
    return torch.searchsorted(ids, _tile_starts(n_tiles, ids.device),
                              out_int32=True)


def launch(data: torch.Tensor, ids: torch.Tensor, bounds: torch.Tensor,
           out: torch.Tensor, n_bins: int, bins_per_cloud: int, n_store: int,
           pillar_features: Optional[int] = None,
           k_tiles: Optional[int] = None,
           defines: Tuple[str, ...] = (), scale: float = 0.0) -> None:
    """Run csrc/bin_sum.cu (``k_tiles`` None) or csrc/bin_sum_grouped.cu on
    prepared inputs: contiguous fp32 ``data`` (P, C), int32 ``ids`` grouped
    by tile, ``bounds`` = :func:`tile_bounds` (ids, n_bins), ``out``
    (clouds, C, row length >= n_store) with unit stride along the bins.
    ``defines`` build a variant of the source (cuda_lib; the experiment
    tool's).  ``scale`` > 0 (csrc/bin_sum.cu only): the deterministic
    route, its sums exact integers in units of 1 / scale."""
    global launches, launches_grouped
    if not all(x.is_cuda for x in (data, ids, bounds, out)):
        raise ValueError('bin_sum kernel takes CUDA tensors')
    if data.dim() != 2 or data.dtype != torch.float32 or \
            not data.is_contiguous():
        raise ValueError('bin_sum kernel takes contiguous float32 rows '
                         '(P, C)')
    n_rows, c = data.shape
    if not 1 <= c <= MAX_KERNEL_CHANNELS:
        raise ValueError(f'bin_sum kernel takes 1..{MAX_KERNEL_CHANNELS} '
                         f'channels, got {c}')
    if pillar_features is not None and not 3 <= pillar_features <= c - 2:
        raise ValueError(f'pillar epilogue: {pillar_features} features do '
                         f'not fit {c} channels')
    n_tiles = -(-n_bins // BINS_PER_TILE)
    if ids.shape != (n_rows,) or ids.dtype != torch.int32 or \
            not ids.is_contiguous() or bounds.shape != (n_tiles - 1,) or \
            bounds.dtype != torch.int32 or not bounds.is_contiguous():
        raise ValueError('bin_sum kernel takes contiguous int32 ids (P,) and '
                         'tile bounds (n_tiles - 1,)')
    if out.dim() != 3 or out.stride(2) != 1 or out.shape[1] != c or \
            out.shape[2] < n_store or \
            out.shape[0] * bins_per_cloud < n_bins or \
            out.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'bin_sum kernel writes float32 or bfloat16 '
                         f'(clouds, {c}, >= {n_store}) with unit bin stride, '
                         f'not {out.dtype} {tuple(out.shape)}')
    args = (data.data_ptr(), ids.data_ptr(), bounds.data_ptr(),
            out.data_ptr(), n_rows, n_bins, n_tiles, bins_per_cloud, n_store,
            out.stride(1), out.stride(0), c,
            -1 if pillar_features is None else pillar_features,
            int(out.dtype == torch.bfloat16))
    stream = torch.cuda.current_stream(data.device).cuda_stream
    if k_tiles is None:
        cuda_lib.check('bin_sum', cuda_lib.kernel(
            'bin_sum', defines=defines)(*args, float(scale), stream))
        launches += 1
    else:
        cuda_lib.check('bin_sum_grouped', cuda_lib.kernel(
            'bin_sum_grouped', defines=defines)(*args, k_tiles, stream))
        launches_grouped += 1


def _bin_sum_cuda(data, ids, n_clouds, bins_per_cloud, n_store,
                  pillar_features, out_dtype, presorted, k_tiles):
    """Sort if asked, build the tile bounds and the output and launch;
    returns (n_clouds, C, n_store), a view of rows padded to 8 bins.
    :func:`launch` checks the prepared tensors.  Its shared-memory atomic
    adds sum in an order that varies from run to run; under
    ``torch.use_deterministic_algorithms`` K1 takes its deterministic route
    (exact integer sums: the same bits every run), and K1', which has none,
    warns or raises as ATen does."""
    deterministic = torch.are_deterministic_algorithms_enabled()
    if deterministic and k_tiles:
        cuda_lib.alert_not_deterministic('bin_sum_grouped')
    if data.dim() != 2 or ids.shape != data.shape[:1]:
        raise ValueError(f'bin_sum: data {tuple(data.shape)} and ids '
                         f'{tuple(ids.shape)} must be (P, C) and (P,)')
    if ids.device != data.device or ids.dtype not in (torch.int32,
                                                      torch.int64):
        raise ValueError('bin_sum: ids must be integers on the data device')
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'bin_sum kernel writes float32 or bfloat16, not '
                         f'{out_dtype}')
    n_bins = n_clouds * bins_per_cloud
    if not 0 < n_bins < 2 ** 31 - BINS_PER_TILE:
        raise ValueError(f'bin_sum: n_bins {n_bins} out of range')

    if ids.dtype != torch.int32:     # clip first: int64 ids may not fit
        ids = ids.clamp(0, n_bins - 1).to(torch.int32)
    ids = ids.contiguous()
    if not presorted:
        ids, order = torch.sort(ids, stable=True)
        data = data[order]
    out = torch.empty(n_clouds, data.shape[1], padded_bins(n_store),
                      dtype=out_dtype, device=data.device)
    route = {}
    if deterministic and not k_tiles:
        # a bin sums at most every row's value of its channel
        route['scale'] = cuda_lib.fixed_point_scale(
            float(data.abs().amax()) * data.shape[0] if data.numel() else 0.0)
    launch(data, ids, tile_bounds(ids, n_bins), out, n_bins, bins_per_cloud,
           n_store, pillar_features, k_tiles, **route)
    return out[..., :n_store]
