"""Camera lift-splat pool with the patch budget, forward.

Port of streamingflow_tpu/ops/pallas_patch_pool.py::patch_pool_frames.
Frustum rows are grouped by (frame, camera, depth bin, 4 image columns); a
group's patch origin is its min kept x and its min kept y floored to a
multiple of 8, clamped into the grid; a kept row is summed into its cell
only if it lies in the 16 x 24 patch from that origin, and the kept rows
that do not are counted per frame.  Features are rounded to bf16 before the
fp32 sum, as in the JAX package.

On a CUDA tensor :func:`patch_pool_frames` launches the hand-written kernel
csrc/patch_pool.cu (one block per group, fp32 atomics into the grid, all
frames in one launch); on a CPU tensor it takes the plain PyTorch version
:func:`patch_pool_frames_plain`.  There is no fallback from the kernel to
the plain version.  The kernel takes C = 64 features, the width of the
main path (the JAX kernel takes only 64 too).
"""
from __future__ import annotations

import torch

from . import cuda_lib

PATCH_H = 16          # x cells per patch
PATCH_W = 24          # y cells per patch
UBLOCK = 4            # image columns per group
ROWS = 128            # most rows a group may have (fH * UBLOCK)
KERNEL_CHANNELS = 64

# kernel launches since the last reset (chip_smoke.py reads it)
launches = 0
# per-frame drop counts of the latest pool, either path (a device tensor:
# reading it is the caller's synchronisation, not the pool's)
last_drops = None


def fits_mask(coords: torch.Tensor, kept: torch.Tensor, nx: int, ny: int):
    """Per-row (valid, fits) masks (F, N, D, fH, fW) of the patch budget."""
    f, n, d, fh, fw = kept.shape
    wb = -(-fw // UBLOCK)
    pad = wb * UBLOCK - fw
    cx = torch.where(kept, coords[..., 0], torch.full_like(coords[..., 0], -1))
    cy = torch.where(kept, coords[..., 1], torch.full_like(coords[..., 1], -1))
    valid = cx >= 0
    if pad:
        cx = torch.nn.functional.pad(cx, (0, pad), value=-1)
        cy = torch.nn.functional.pad(cy, (0, pad), value=-1)
        valid = torch.nn.functional.pad(valid, (0, pad), value=False)
    cx = cx.reshape(f, n, d, fh, wb, UBLOCK)
    cy = cy.reshape(f, n, d, fh, wb, UBLOCK)
    vg = valid.reshape(f, n, d, fh, wb, UBLOCK)
    big = torch.full_like(cx, 2 ** 30)
    minx = torch.where(vg, cx, big).amin(dim=(3, 5), keepdim=True)
    miny = torch.where(vg, cy, big).amin(dim=(3, 5), keepdim=True)
    x0 = torch.clamp(minx, min=0).clamp(max=nx - PATCH_H)
    y0 = torch.clamp(torch.div(miny, 8, rounding_mode='floor') * 8,
                     min=0).clamp(max=ny - PATCH_W)
    lx, ly = cx - x0, cy - y0
    fits = vg & (lx >= 0) & (lx < PATCH_H) & (ly >= 0) & (ly < PATCH_W)
    fits = fits.reshape(f, n, d, fh, wb * UBLOCK)[..., :fw]
    return valid[..., :fw], fits


def patch_pool_frames_plain(x: torch.Tensor, coords: torch.Tensor,
                            kept: torch.Tensor, nx: int, ny: int):
    """Plain PyTorch version of :func:`patch_pool_frames` (any C <= 64)."""
    f, c = x.shape[0], x.shape[-1]
    valid, fits = fits_mask(coords, kept, nx, ny)
    drops = (valid & ~fits).reshape(f, -1).sum(1).to(torch.int32)
    frame = torch.arange(f, device=x.device).view(f, 1, 1, 1, 1)
    cell = (frame * (nx * ny) + coords[..., 0] * ny + coords[..., 1])[fits]
    feats = x.to(torch.bfloat16).float()[fits]
    out = torch.zeros(f * nx * ny, c, dtype=torch.float32, device=x.device)
    out.index_add_(0, cell.long(), feats)
    return out.reshape(f, nx, ny, c), drops


def patch_pool_frames(x: torch.Tensor, coords: torch.Tensor,
                      kept: torch.Tensor, nx: int, ny: int):
    """Pool frames: x (F, N, D, fH, fW, C), coords (F, N, D, fH, fW, 2) int
    cells, kept (F, N, D, fH, fW) bool -> (bev (F, nx, ny, C) fp32,
    drops (F,) int32, the kept rows lost to the patch budget)."""
    global last_drops
    if x.device.type == 'cpu':
        out, last_drops = patch_pool_frames_plain(x, coords, kept, nx, ny)
    elif x.device.type == 'cuda':
        out, last_drops = _patch_pool_cuda(x, coords, kept, nx, ny)
    else:
        raise ValueError(f'patch_pool_frames: unsupported device {x.device}')
    return out, last_drops


def _patch_pool_cuda(x, coords, kept, nx, ny):
    global launches
    if x.dim() != 6 or x.shape[-1] != KERNEL_CHANNELS:
        raise ValueError(f'patch_pool kernel takes x (F, N, D, fH, fW, '
                         f'{KERNEL_CHANNELS}), got {tuple(x.shape)}')
    f, n, d, fh, fw, _ = x.shape
    if fh * UBLOCK > ROWS:
        raise ValueError(f'patch_pool kernel: fH * {UBLOCK} = {fh * UBLOCK} '
                         f'rows exceed the {ROWS}-row group budget')
    if tuple(coords.shape) != (f, n, d, fh, fw, 2) or \
            coords.dtype != torch.int32:
        raise ValueError('patch_pool kernel: coords must be int32 '
                         f'{(f, n, d, fh, fw, 2)}')
    if tuple(kept.shape) != (f, n, d, fh, fw) or kept.dtype != torch.bool:
        raise ValueError(f'patch_pool kernel: kept must be bool '
                         f'{(f, n, d, fh, fw)}')
    if not (x.device == coords.device == kept.device):
        raise ValueError('patch_pool kernel: inputs on different devices')
    x = x.to(torch.bfloat16)
    if not (x.is_contiguous() and coords.is_contiguous()
            and kept.is_contiguous()):
        raise ValueError('patch_pool kernel takes contiguous inputs')
    out = torch.zeros(f, nx, ny, KERNEL_CHANNELS, dtype=torch.float32,
                      device=x.device)
    drops = torch.zeros(f, dtype=torch.int32, device=x.device)
    err = cuda_lib.kernel('patch_pool')(
        x.data_ptr(), coords.data_ptr(), kept.data_ptr(), out.data_ptr(),
        drops.data_ptr(), f, n, d, fh, fw, nx, ny,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check('patch_pool', err)
    launches += 1
    return out, drops
