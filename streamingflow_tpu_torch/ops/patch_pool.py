"""Camera lift-splat pool with the patch budget, forward and backward.

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

:func:`patch_pool_frames` is differentiable in ``x`` (the JAX package's
custom VJP ``_pool_bwd``): the pool is linear, so a row's gradient is the
output cotangent at its cell, and exactly zero for a row that was not
summed.  Only ``coords`` and ``kept`` are saved for it.  The forward rounds
``x`` to bf16, the backward does not round: the gradient comes back in
``x``'s dtype.  :func:`patch_pool_grad` launches the second kernel of
csrc/patch_pool.cu on a CUDA tensor and takes :func:`patch_pool_grad_plain`
on a CPU tensor; :func:`patch_pool_frames_plain` gives the same gradient
through ordinary autograd.
"""
from __future__ import annotations

import torch

from . import cuda_lib

PATCH_H = 16          # x cells per patch
PATCH_W = 24          # y cells per patch
UBLOCK = 4            # image columns per group
ROWS = 128            # most rows a group may have (fH * UBLOCK)
KERNEL_CHANNELS = 64

# launches of the forward and of the backward kernel since the last reset
# (chip_smoke.py reads them)
launches = 0
launches_bwd = 0
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
    # bf16 rounding of the value, identity for the gradient
    rounded = x + (x.to(torch.bfloat16).to(x.dtype) - x).detach()
    feats = rounded.float()[fits]
    out = torch.zeros(f * nx * ny, c, dtype=torch.float32, device=x.device)
    out.index_add_(0, cell.long(), feats)
    return out.reshape(f, nx, ny, c), drops


def patch_pool_grad_plain(dout: torch.Tensor, coords: torch.Tensor,
                          kept: torch.Tensor, nx: int, ny: int,
                          dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of :func:`patch_pool_grad`."""
    f, c = dout.shape[0], dout.shape[-1]
    fits = fits_mask(coords, kept, nx, ny)[1]
    cell = coords[..., 0] * ny + coords[..., 1]
    cell = torch.where(fits, cell, torch.zeros_like(cell)).reshape(f, -1)
    g = torch.gather(dout.reshape(f, nx * ny, c), 1,
                     cell.long()[..., None].expand(-1, -1, c))
    g = g.reshape(*kept.shape, c)
    return torch.where(fits[..., None], g, torch.zeros_like(g)).to(dtype)


def patch_pool_grad(dout: torch.Tensor, coords: torch.Tensor,
                    kept: torch.Tensor, nx: int, ny: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """Gradient of the pool w.r.t. its rows: dout (F, nx, ny, C) fp32 ->
    (F, N, D, fH, fW, C) in ``dtype``, the cotangent at each summed row's
    cell and zero for every other row."""
    if dout.device.type == 'cpu':
        return patch_pool_grad_plain(dout, coords, kept, nx, ny, dtype)
    if dout.device.type != 'cuda':
        raise ValueError(f'patch_pool_grad: unsupported device {dout.device}')
    return _patch_pool_grad_cuda(dout, coords, kept, nx, ny, dtype)


class _PatchPool(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, coords, kept, nx, ny):
        if x.device.type == 'cpu':
            with torch.no_grad():
                out, drops = patch_pool_frames_plain(x, coords, kept, nx, ny)
        elif x.device.type == 'cuda':
            out, drops = _patch_pool_cuda(x, coords, kept, nx, ny)
        else:
            raise ValueError(f'patch_pool_frames: unsupported device '
                             f'{x.device}')
        ctx.save_for_backward(coords, kept)
        ctx.grid = (nx, ny)
        ctx.x_dtype = x.dtype
        ctx.mark_non_differentiable(drops)
        return out, drops

    @staticmethod
    def backward(ctx, dout, _ddrops):
        coords, kept = ctx.saved_tensors
        dx = patch_pool_grad(dout.float().contiguous(), coords, kept,
                             *ctx.grid, ctx.x_dtype)
        return dx, None, None, None, None


def patch_pool_frames(x: torch.Tensor, coords: torch.Tensor,
                      kept: torch.Tensor, nx: int, ny: int):
    """Pool frames: x (F, N, D, fH, fW, C), coords (F, N, D, fH, fW, 2) int
    cells, kept (F, N, D, fH, fW) bool -> (bev (F, nx, ny, C) fp32,
    drops (F,) int32, the kept rows lost to the patch budget)."""
    global last_drops
    out, last_drops = _PatchPool.apply(x, coords, kept, nx, ny)
    return out, last_drops


def _check_rows(what, lead, coords, kept, device):
    f, n, d, fh, fw = lead
    if fh * UBLOCK > ROWS:
        raise ValueError(f'{what}: fH * {UBLOCK} = {fh * UBLOCK} '
                         f'rows exceed the {ROWS}-row group budget')
    if tuple(coords.shape) != (f, n, d, fh, fw, 2) or \
            coords.dtype != torch.int32:
        raise ValueError(f'{what}: coords must be int32 '
                         f'{(f, n, d, fh, fw, 2)}')
    if tuple(kept.shape) != (f, n, d, fh, fw) or kept.dtype != torch.bool:
        raise ValueError(f'{what}: kept must be bool {(f, n, d, fh, fw)}')
    if not (device == coords.device == kept.device):
        raise ValueError(f'{what}: inputs on different devices')
    if not (coords.is_contiguous() and kept.is_contiguous()):
        raise ValueError(f'{what} takes contiguous inputs')


def _patch_pool_grad_cuda(dout, coords, kept, nx, ny, dtype):
    global launches_bwd
    f = dout.shape[0]
    if tuple(dout.shape) != (f, nx, ny, KERNEL_CHANNELS) or \
            dout.dtype != torch.float32 or not dout.is_contiguous():
        raise ValueError(f'patch_pool backward kernel takes a contiguous '
                         f'float32 cotangent (F, {nx}, {ny}, '
                         f'{KERNEL_CHANNELS}), got {tuple(dout.shape)} '
                         f'{dout.dtype}')
    # the kernel writes bfloat16 or float32; any other dtype is cast from
    # float32, which holds the gathered float32 cotangent exactly
    written = dtype if dtype == torch.bfloat16 else torch.float32
    _check_rows('patch_pool backward kernel', kept.shape, coords, kept,
                dout.device)
    n, d, fh, fw = kept.shape[1:]
    dx = torch.empty(*kept.shape, KERNEL_CHANNELS, dtype=written,
                     device=dout.device)
    err = cuda_lib.kernel('patch_pool', 'sf_patch_pool_bwd')(
        dout.data_ptr(), coords.data_ptr(), kept.data_ptr(), dx.data_ptr(),
        f, n, d, fh, fw, nx, ny, int(written == torch.bfloat16),
        torch.cuda.current_stream(dout.device).cuda_stream)
    cuda_lib.check('patch_pool_bwd', err)
    launches_bwd += 1
    return dx.to(dtype)


def _patch_pool_cuda(x, coords, kept, nx, ny):
    global launches
    if x.dim() != 6 or x.shape[-1] != KERNEL_CHANNELS:
        raise ValueError(f'patch_pool kernel takes x (F, N, D, fH, fW, '
                         f'{KERNEL_CHANNELS}), got {tuple(x.shape)}')
    f, n, d, fh, fw, _ = x.shape
    _check_rows('patch_pool kernel', x.shape[:5], coords, kept, x.device)
    x = x.to(torch.bfloat16)
    if not x.is_contiguous():
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
