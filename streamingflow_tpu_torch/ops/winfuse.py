"""Submanifold 3x3x3 conv over z-fused columns (kernel K3, 'winfuse').

Port of streamingflow_tpu/ops/pallas_winfuse.py::subm_conv_winfuse.  The
function, for output column v, output z ``zo`` and output channel j:

    out[v, zo*Cout + j] = sum over in-plane taps k < 9 with found[k, v],
                          z taps tz < 3 with 0 <= zo + tz - 1 < nz,
                          input channels i of
                          feats[nbr[k, v], (zo + tz - 1)*Cin + i] * w[3k + tz, i, j]

summed in fp32 and written once in the features' type, at every slot and
every z (the masked BN that follows zeroes the inactive sites).  The TPU
kernel read each block of output columns through fixed-size windows of
source rows; a block whose window overflows past the residual cap loses
found taps, and the plan counts them.  :func:`fused_found` reproduces that
rule as an effective ``found`` mask and the same count, so the port computes
the same function, drops included, without the windows.

On a CUDA tensor :func:`subm_conv_winfuse` launches the hand-written kernel
csrc/winfuse.cu; on a CPU tensor it takes the plain PyTorch version
:func:`subm_conv_plain`.  There is no fallback from the kernel to the plain
version.  bf16 features go to the tensor-core kernel, which takes its
inputs as :func:`pitch_rows` and :func:`tap_weights` prepare them; fp32
features go to the exact CUDA-core kernel (:func:`route`).
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .sparse_columns import ColumnMap, padded_rows, z_windows
from .voxelize import LARGE_ID

# widths the kernel takes: Cin, Cout of the column stages (5, 16, 32)
MAX_CHANNELS = 32
# z the kernels take (the fp32 kernel gives each output z of a tile of
# columns one thread)
MAX_NZ = 256

# kernel launches since the last reset (chip_smoke.py reads it)
launches = 0


def fused_found(cmap: ColumnMap, block: int, window: int,
                resid_blocks: int):
    """The taps the TPU kernel's window plan keeps (build_fused_plan of the
    JAX package): (found (9, V) bool, n_dropped () int32).

    Output slots go in blocks of ``block`` (SPARSE_ENCODER.WINDOW_BLOCK);
    for each dx row a block reads ``window`` (WINFUSE_WINDOW) source rows
    from an 8-aligned start.  A block with a found tap past its window
    overflows; the first ``resid_blocks`` (WINDOW_RESID_BLOCKS) overflowing
    blocks keep every tap, later ones lose the taps past the window.
    ``n_dropped`` counts every found tap of a block that loses any, as the
    JAX plan counts it."""
    nbr, found = cmap.nbr.long(), cmap.found
    cap = nbr.shape[1]
    window = min(window, cap)
    n_blocks = -(-cap // block)
    pad = n_blocks * block - cap
    slots = torch.cat([nbr, nbr.new_zeros(9, pad)], 1).view(9, n_blocks,
                                                            block)
    fnd = torch.cat([found, found.new_zeros(9, pad)], 1).view(9, n_blocks,
                                                              block)
    rels = []
    for d in range(3):                       # dx = -1, 0, +1
        s3, f3 = slots[3 * d:3 * d + 3], fnd[3 * d:3 * d + 3]
        smin = torch.where(f3, s3, LARGE_ID).amin(dim=(0, 2))
        start = torch.where(smin < LARGE_ID, (smin // 8) * 8, 0).clamp(
            0, max(cap - window, 0))
        rels.append(s3 - start[None, :, None])
    past = torch.cat(rels) >= window
    block_over = (fnd & past).any(2).any(0)
    in_resid = block_over & (torch.cumsum(block_over, 0) - 1 < resid_blocks)
    lost = (block_over & ~in_resid)[None, :, None]
    n_dropped = (fnd & lost).sum().int()
    keep = fnd & ~(lost & past)
    return keep.reshape(9, -1)[:, :cap], n_dropped


def subm_conv_plain(feats: torch.Tensor, nbr: torch.Tensor,
                    found: torch.Tensor, weights: torch.Tensor,
                    nz: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`subm_conv_winfuse`: for each
    in-plane tap one gather of the three z taps and a (3*Cin, Cout)
    product, summed in fp32."""
    cin, cout = weights.shape[1], weights.shape[2]
    v = nbr.shape[1]
    f = padded_rows(feats.float(), nz, 1, nz + 2)
    src = torch.where(found, nbr, feats.shape[0]).long()
    w = weights.float()
    acc = torch.zeros(v, nz, cout, dtype=torch.float32, device=feats.device)
    for k in range(9):
        x = z_windows(f.index_select(0, src[k]), nz, 3, 1)
        acc += x.reshape(v, nz, cin * 3) @ \
            w[3 * k:3 * k + 3].permute(1, 0, 2).reshape(cin * 3, cout)
    return acc.to(feats.dtype).reshape(v, nz * cout)


def subm_conv_winfuse(feats: torch.Tensor, nbr: torch.Tensor,
                      found: torch.Tensor, weights: torch.Tensor,
                      nz: int) -> torch.Tensor:
    """feats (R, nz*Cin) column rows; nbr (9, V) int32 rows of ``feats``
    (the clouds of a batch stacked, each cloud's slots offset by its first
    row); found (9, V) bool (from :func:`fused_found` for 'winfuse');
    weights (27, Cin, Cout), row 3k + tz -> (V, nz*Cout) in feats' type."""
    if weights.shape[0] != 27:
        raise ValueError('subm_conv_winfuse is specialised to 3x3x3: '
                         f'weights {tuple(weights.shape)}')
    if feats.device.type == 'cpu':
        return subm_conv_plain(feats, nbr, found, weights, nz)
    if feats.device.type != 'cuda':
        raise ValueError(f'subm_conv_winfuse: unsupported device '
                         f'{feats.device}')
    return _winfuse_cuda(feats, nbr, found, weights, nz)


def route(dtype: torch.dtype) -> str:
    """Which units compute the kernel's products for features of ``dtype``."""
    return ('tensor cores (mma.sync bf16, fp32 sums)'
            if dtype == torch.bfloat16 else 'CUDA cores (fp32 FMA)')


def channel_pitch(cin: int) -> int:
    """Channels of a z row as the tensor-core kernel stages it (8, 16 or
    32): whole 16-byte chunks of bf16, one ldmatrix row each."""
    return 8 if cin <= 8 else 16 if cin <= 16 else 32


def tap_weights(weights: torch.Tensor, cp: int) -> torch.Tensor:
    """(27, Cin, Cout) -> the tensor-core kernel's per-tap B, (9, K, N) bf16:
    B[k, tz*cp + i, j] = weights[3k + tz, i, j], zero for i >= Cin, for
    j >= Cout and in the K rows past 3*cp.  K = 3*cp rounded up to 16 (the
    mma's depth), N = 16 if Cout <= 16 else 32."""
    _, cin, cout = weights.shape
    k = -(-3 * cp // 16) * 16
    n = 16 if cout <= 16 else 32
    b = weights.new_zeros(9, k, n, dtype=torch.bfloat16)
    b[:, :3 * cp].view(9, 3, cp, n)[:, :, :cin, :cout] = \
        weights.reshape(9, 3, cin, cout)
    return b


def pitch_rows(feats: torch.Tensor, nz: int, cp: int) -> torch.Tensor:
    """Fused rows (R, nz*Cin) -> (R, nz*cp) with channels Cin .. cp - 1 zero,
    starting on 16 bytes: the rows themselves when they already are (Cin ==
    cp, aligned), else one copy (conv_input's Cin = 5 at pitch 8)."""
    rows, cin = feats.shape[0], feats.shape[1] // nz
    if cin == cp and feats.data_ptr() % 16 == 0:
        return feats
    out = feats.new_zeros(rows, nz, cp)
    out[:, :, :cin] = feats.view(rows, nz, cin)
    return out.view(rows, nz * cp)


def _winfuse_cuda(feats, nbr, found, weights, nz):
    global launches
    cin, cout = weights.shape[1], weights.shape[2]
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'winfuse kernel takes float32 or bfloat16 '
                         f'features, not {feats.dtype}')
    if not (1 <= cin <= MAX_CHANNELS and 1 <= cout <= MAX_CHANNELS):
        raise ValueError(f'winfuse kernel takes 1..{MAX_CHANNELS} channels '
                         f'in and out, got {cin} -> {cout}')
    if not 1 <= nz <= MAX_NZ:
        raise ValueError(f'winfuse kernel takes nz 1..{MAX_NZ}, got {nz}')
    if feats.dim() != 2 or feats.shape[1] != nz * cin or \
            not feats.is_contiguous():
        raise ValueError(f'winfuse kernel takes contiguous feats (R, '
                         f'{nz * cin}), got {tuple(feats.shape)}')
    v = nbr.shape[1]
    if tuple(nbr.shape) != (9, v) or nbr.dtype != torch.int32 or \
            tuple(found.shape) != (9, v) or found.dtype != torch.bool:
        raise ValueError('winfuse kernel takes nbr (9, V) int32 and found '
                         '(9, V) bool')
    if not (feats.device == nbr.device == found.device == weights.device):
        raise ValueError('winfuse kernel: inputs on different devices')
    # one source row per tap, -1 where the tap is not taken
    src = torch.where(found, nbr, -1).contiguous()
    out = torch.empty(v, nz * cout, dtype=feats.dtype, device=feats.device)
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    if feats.dtype == torch.bfloat16:
        cp = channel_pitch(cin)
        rows, w = pitch_rows(feats, nz, cp), tap_weights(weights, cp)
        err = cuda_lib.kernel('winfuse', 'sf_winfuse_bf16')(
            rows.data_ptr(), src.data_ptr(), w.data_ptr(), out.data_ptr(), v,
            nz, cp, cout, stream)
    else:
        w = weights.float().contiguous()
        err = cuda_lib.kernel('winfuse', 'sf_winfuse_fp32')(
            feats.data_ptr(), src.data_ptr(), w.data_ptr(), out.data_ptr(), v,
            nz, cin, cout, stream)
    cuda_lib.check('winfuse', err)
    launches += 1
    return out
