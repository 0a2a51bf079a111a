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

The gradient (:class:`WinfuseConv`) is that of the JAX package's
``_winfuse_bwd``: the XLA 'sep' conv differentiated over the map's full
``found``, the taps the window plan dropped included.  So the forward takes
the kept taps and the backward every found tap.  d feats
(:func:`subm_conv_dgrad`) is the same conv run backwards: K3's forward on
the cotangent over the reversed map (:func:`reverse_map`) with the weights
flipped and transposed.  d weights (:func:`subm_conv_wgrad`) is the kernel
csrc/winfuse_wgrad.cu on the card (bf16 on the tensor cores, its rows as
:func:`wgrad_rows` prepares them; fp32 on the CUDA cores) and
:func:`subm_conv_wgrad_plain` on the CPU.
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

# kernel launches since the last reset (chip_smoke.py reads them): the
# forward, d feats (the forward's kernels over the reversed map) and d weights
launches = 0
launches_dgrad = 0
launches_wgrad = 0


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
    product, summed in fp32 (in fp64 for fp64 features)."""
    cin, cout = weights.shape[1], weights.shape[2]
    v = nbr.shape[1]
    dt = _sum_dtype(feats.dtype)
    f = padded_rows(feats.to(dt), nz, 1, nz + 2)
    src = torch.where(found, nbr, feats.shape[0]).long()
    w = weights.to(dt)
    acc = torch.zeros(v, nz, cout, dtype=dt, device=feats.device)
    for k in range(9):
        x = z_windows(f.index_select(0, src[k]), nz, 3, 1)
        acc += x.reshape(v, nz, cin * 3) @ \
            w[3 * k:3 * k + 3].permute(1, 0, 2).reshape(cin * 3, cout)
    return acc.to(feats.dtype).reshape(v, nz * cout)


def _sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the plain versions sum in: fp32, fp64 for fp64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def _conv(feats, nbr, found, weights, nz):
    """The forward on the features' device: the kernel on the card, the
    plain version on the CPU."""
    if feats.device.type == 'cpu':
        return subm_conv_plain(feats, nbr, found, weights, nz)
    if feats.device.type != 'cuda':
        raise ValueError(f'subm_conv_winfuse: unsupported device '
                         f'{feats.device}')
    return _winfuse_cuda(feats, torch.where(found, nbr, -1), weights, nz)


class WinfuseConv(torch.autograd.Function):
    """K3 with the JAX package's gradient (``_winfuse_bwd``): the forward
    over the kept taps ``found``, the backward over every found tap
    ``grad_found``.  It saves feats, weights, nbr, grad_found and the
    reversed map (made in the backward when not given).  d feats only when
    feats takes a gradient (conv_input's voxel features take none)."""

    @staticmethod
    def forward(ctx, feats, weights, nbr, found, grad_found, src_t, nz):
        ctx.nz = nz
        ctx.save_for_backward(feats, weights, nbr, grad_found, src_t)
        return _conv(feats, nbr, found, weights, nz)

    @staticmethod
    def backward(ctx, g):
        feats, weights, nbr, grad_found, src_t = ctx.saved_tensors
        g = g.contiguous()
        dfeats = dweights = None
        if ctx.needs_input_grad[0]:
            if src_t is None:
                src_t = reverse_map(nbr, grad_found, feats.shape[0])
            dfeats = subm_conv_dgrad(g, src_t, weights, ctx.nz)
        if ctx.needs_input_grad[1]:
            dweights = subm_conv_wgrad(feats, nbr, grad_found, g,
                                       ctx.nz).to(weights.dtype)
        return dfeats, dweights, None, None, None, None, None


def subm_conv_winfuse(feats: torch.Tensor, nbr: torch.Tensor,
                      found: torch.Tensor, weights: torch.Tensor,
                      nz: int, grad_found: torch.Tensor = None,
                      src_t: torch.Tensor = None) -> torch.Tensor:
    """feats (R, nz*Cin) column rows; nbr (9, V) int32 rows of ``feats``
    (the clouds of a batch stacked, each cloud's slots offset by its first
    row); found (9, V) bool (from :func:`fused_found` for 'winfuse');
    weights (27, Cin, Cout), row 3k + tz -> (V, nz*Cout) in feats' type.

    Differentiable in feats and weights (:class:`WinfuseConv`): the
    backward runs over ``grad_found`` (the map's full found; ``found`` when
    not given) and ``src_t`` (:func:`reverse_map` of nbr and grad_found,
    made in the backward when not given)."""
    if weights.shape[0] != 27:
        raise ValueError('subm_conv_winfuse is specialised to 3x3x3: '
                         f'weights {tuple(weights.shape)}')
    return WinfuseConv.apply(feats, weights, nbr, found,
                             found if grad_found is None else grad_found,
                             src_t, nz)


def reverse_map(nbr: torch.Tensor, found: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """The map run backwards, (9, n_rows) int32: src_t[8 - k, u] = v where
    nbr[k, v] = u and found[k, v], -1 where no tap lands on row u.  In-plane
    tap k = (dx, dy) read from v lands on u, so u reads v through tap
    8 - k = (-dx, -dy).  One scatter of the whole map; the stacked clouds'
    row offsets carry over.  No symmetry of the map is assumed: only the
    found taps are scattered."""
    v = nbr.shape[1]
    src_t = torch.full((9, n_rows), -1, dtype=torch.int32, device=nbr.device)
    k = torch.arange(8, -1, -1, device=nbr.device).view(9, 1).expand(9, v)
    cols = torch.arange(v, dtype=torch.int32, device=nbr.device).expand(9, v)
    src_t[k[found], nbr.long()[found]] = cols[found]
    return src_t


def flipped_weights(weights: torch.Tensor) -> torch.Tensor:
    """(27, Cin, Cout) -> the backward conv's (27, Cout, Cin):
    W'[3(8 - k) + 2 - tz] = W[3k + tz] transposed."""
    return weights.flip(0).transpose(1, 2).contiguous()


def subm_conv_dgrad(g: torch.Tensor, src_t: torch.Tensor,
                    weights: torch.Tensor, nz: int) -> torch.Tensor:
    """d feats of :func:`subm_conv_winfuse` for the cotangent g (V, nz*Cout):

        dfeats[u, zi, i] = sum over taps (k, tz) and v with nbr[k, v] = u,
                           found[k, v] of
                           W[3k + tz, i, :] . g[v, zi - tz + 1, :]

    which is the forward conv on g over the reversed map with the flipped
    weights: K3's own kernels on the card (Cin' = Cout, Cout' = Cin), the
    plain version on the CPU.  (R, nz*Cin) in g's type."""
    global launches_dgrad
    w = flipped_weights(weights)
    if g.device.type == 'cpu':
        return subm_conv_plain(g, src_t.clamp(min=0), src_t >= 0, w, nz)
    if g.device.type != 'cuda':
        raise ValueError(f'subm_conv_dgrad: unsupported device {g.device}')
    out = _winfuse_cuda(g, src_t, w, nz, count=False)
    launches_dgrad += 1
    return out


def subm_conv_wgrad_plain(feats: torch.Tensor, nbr: torch.Tensor,
                          found: torch.Tensor, g: torch.Tensor,
                          nz: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`subm_conv_wgrad`: per in-plane tap
    one gather of the three z taps and one contraction over (V, z)."""
    cin, cout = feats.shape[1] // nz, g.shape[1] // nz
    v = nbr.shape[1]
    dt = _sum_dtype(feats.dtype)
    f = padded_rows(feats.to(dt), nz, 1, nz + 2)
    src = torch.where(found, nbr, feats.shape[0]).long()
    gv = g.to(dt).reshape(v, nz, cout)
    dw = torch.stack([
        torch.einsum('vzit,vzj->tij',
                     z_windows(f.index_select(0, src[k]), nz, 3, 1), gv)
        for k in range(9)])
    return dw.reshape(27, cin, cout)


def subm_conv_wgrad(feats: torch.Tensor, nbr: torch.Tensor,
                    found: torch.Tensor, g: torch.Tensor,
                    nz: int) -> torch.Tensor:
    """d weights of :func:`subm_conv_winfuse` for the cotangent g
    (V, nz*Cout), over the found taps (the backward's full found):

        dW[3k + tz, i, j] = sum over v with found[k, v], output z zo with
                            0 <= zo + tz - 1 < nz of
                            feats[nbr[k, v], zo + tz - 1, i] * g[v, zo, j]

    (27, Cin, Cout), summed and returned in fp32 (fp64 for fp64 features),
    for bf16 features too, unrounded.  The JAX vjp of bf16 features rounds
    differently: its 'sep' conv multiplies bf16 band matrices, so each
    tap's partial sum over the columns for one (output z, input z) pair is
    rounded to bf16 (the cotangent of the band's cast), and those partials
    are summed over z in fp32.  Rounding the whole sum once instead would
    land further from JAX's value than the unrounded sum does
    (tests/test_torch_winfuse_grad.py measures both), and following JAX's
    per-pair rounding would need a partial per output z.  So the port keeps
    the exact fp32 sum, within JAX's own rounding of it.

    On the card the kernel csrc/winfuse_wgrad.cu, the same sums in a fixed
    order (no float atomics: the same gradient from run to run): bf16 as
    one GEMM a tap on the tensor cores, its depth the cotangent's nonzero
    (column, z) rows; fp32 on the CUDA cores.  On the CPU
    :func:`subm_conv_wgrad_plain`."""
    if feats.device.type == 'cpu':
        return subm_conv_wgrad_plain(feats, nbr, found, g, nz)
    if feats.device.type != 'cuda':
        raise ValueError(f'subm_conv_wgrad: unsupported device '
                         f'{feats.device}')
    return _wgrad_cuda(feats, nbr, found, g, nz)


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


def _check_rows(name, rows, nz, c):
    if rows.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'{name} kernel takes float32 or bfloat16 rows, not '
                         f'{rows.dtype}')
    if not 1 <= nz <= MAX_NZ:
        raise ValueError(f'{name} kernel takes nz 1..{MAX_NZ}, got {nz}')
    if rows.dim() != 2 or rows.shape[1] != nz * c or \
            not rows.is_contiguous():
        raise ValueError(f'{name} kernel takes contiguous rows (R, {nz * c}),'
                         f' got {tuple(rows.shape)}')


def _winfuse_cuda(feats, src, weights, nz, count=True):
    """K3 on the card: src (9, V) int32, a source row per tap, -1 where the
    tap is not taken."""
    global launches
    cin, cout = weights.shape[1], weights.shape[2]
    if not (1 <= cin <= MAX_CHANNELS and 1 <= cout <= MAX_CHANNELS):
        raise ValueError(f'winfuse kernel takes 1..{MAX_CHANNELS} channels '
                         f'in and out, got {cin} -> {cout}')
    _check_rows('winfuse', feats, nz, cin)
    v = src.shape[1]
    if tuple(src.shape) != (9, v) or src.dtype != torch.int32:
        raise ValueError('winfuse kernel takes a (9, V) int32 map')
    if not (feats.device == src.device == weights.device):
        raise ValueError('winfuse kernel: inputs on different devices')
    src = src.contiguous()
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
    if count:
        launches += 1
    return out


# partial sums the wgrad kernel may write: one per block, at most this many
# blocks an SM
WGRAD_BLOCKS_PER_SM = 2


def wgrad_rows(feats: torch.Tensor, g: torch.Tensor, nz: int):
    """The bf16 d-weights kernel's rows: (feats at Cin's channel pitch cp,
    cp, g at Cout's pitch np, np), each from :func:`pitch_rows` (the rows
    themselves where Cin or Cout already is a pitch, 8, 16 or 32).  Every
    z row then starts on 16 bytes, as the kernel's 16-byte copies and its
    ldmatrix rows need."""
    cin, cout = feats.shape[1] // nz, g.shape[1] // nz
    cp, np_ = channel_pitch(cin), channel_pitch(cout)
    return pitch_rows(feats, nz, cp), cp, pitch_rows(g, nz, np_), np_


def _wgrad_cuda(feats, nbr, found, g, nz):
    global launches_wgrad
    cin, cout = feats.shape[1] // nz, g.shape[1] // nz
    if not (1 <= cin <= MAX_CHANNELS and 1 <= cout <= MAX_CHANNELS):
        raise ValueError(f'winfuse wgrad kernel takes 1..{MAX_CHANNELS} '
                         f'channels in and out, got {cin} -> {cout}')
    _check_rows('winfuse wgrad', feats, nz, cin)
    _check_rows('winfuse wgrad', g, nz, cout)
    v = nbr.shape[1]
    if g.dtype != feats.dtype or g.shape[0] != v:
        raise ValueError(f'winfuse wgrad kernel takes a cotangent (V={v}, '
                         f'nz*Cout) of the features\' type, got '
                         f'{tuple(g.shape)} {g.dtype}')
    if tuple(nbr.shape) != (9, v) or nbr.dtype != torch.int32 or \
            tuple(found.shape) != (9, v) or found.dtype != torch.bool:
        raise ValueError('winfuse wgrad kernel takes nbr (9, V) int32 and '
                         'found (9, V) bool')
    if not (feats.device == nbr.device == found.device == g.device):
        raise ValueError('winfuse wgrad kernel: inputs on different devices')
    src = torch.where(found, nbr, -1).contiguous()
    dev = feats.device
    max_parts = WGRAD_BLOCKS_PER_SM * \
        torch.cuda.get_device_properties(dev).multi_processor_count
    scratch = torch.empty(max_parts, 27 * cin * cout, dtype=torch.float32,
                          device=dev)
    out = torch.empty(27, cin, cout, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if feats.dtype == torch.bfloat16:
        rows, cp, g_rows, np_ = wgrad_rows(feats, g, nz)
        err = cuda_lib.kernel('winfuse_wgrad', 'sf_winfuse_wgrad_bf16')(
            rows.data_ptr(), src.data_ptr(), g_rows.data_ptr(),
            scratch.data_ptr(), max_parts, out.data_ptr(), v, nz, cp, cin,
            np_, cout, stream)
    else:
        err = cuda_lib.kernel('winfuse_wgrad', 'sf_winfuse_wgrad_fp32')(
            feats.data_ptr(), src.data_ptr(), g.data_ptr(),
            scratch.data_ptr(), max_parts, out.data_ptr(), v, nz, cin, cout,
            stream)
    cuda_lib.check('winfuse_wgrad', err)
    launches_wgrad += 1
    return out
