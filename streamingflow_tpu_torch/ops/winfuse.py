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
csrc/winfuse.cu (bf16) or csrc/winfuse_fp32.cu (fp32); on a CPU tensor it
takes the plain PyTorch version :func:`subm_conv_plain`.  There is no
fallback from the kernel to the plain version.  bf16 features go to the
tensor-core kernel, which takes its inputs as :func:`pitch_rows` and
:func:`tap_weights` prepare them; fp32 features to the tensor cores in
3xTF32 (each operand split into two TF32 pieces, three products a pair:
fp32's order of error), on :func:`pitch_rows` and :func:`tf32_tap_weights`.
Past 32 channels in or out both types take the wide kernels, on
:func:`wide_tap_weights` (bf16) or :func:`wide_tf32_tap_weights` (fp32)
(:func:`route`).

The gradient (:class:`WinfuseConv`) takes the taps its caller gives as
``grad_found``.  For 'winfuse' that is the JAX package's ``_winfuse_bwd``:
the XLA 'sep' conv differentiated over the map's full ``found``, the taps
the window plan dropped included, so the forward takes the kept taps and
the backward every found tap.  'win' has no custom VJP in the JAX package,
so its backward takes the kept taps (models/lidar_encoder.py::
column_geometry).  d feats
(:func:`subm_conv_dgrad`) is the same conv run backwards: K3's forward on
the cotangent over the reversed map (:func:`reverse_map`) with the weights
flipped and transposed.  d weights (:func:`subm_conv_wgrad`) is the kernel
csrc/winfuse_wgrad.cu on the card (its rows as :func:`wgrad_rows` prepares
them: bf16 on the tensor cores, fp32 in 3xTF32) and
:func:`subm_conv_wgrad_plain` on the CPU.
"""
from __future__ import annotations

import functools

import torch

from . import cuda_lib
from .sparse_columns import ColumnMap, padded_rows, z_windows
from .voxelize import LARGE_ID

# widths the kernels take: Cin, Cout of the column stages (5 .. 128); past
# NARROW_CHANNELS in or out the wide kernels run (stages 3 and 4 on columns)
MAX_CHANNELS = 128
NARROW_CHANNELS = 32
# z the kernels take
MAX_NZ = 256

# kernel launches since the last reset (chip_smoke.py reads them): the
# forward, d feats (the forward's kernels over the reversed map) and d
# weights, every route; the *_fp32 counts those of them on fp32 rows (bf16:
# the rest); the *_wide dicts those that ran the wide kernels, by the
# wider side's pitch (64 at stage 3, 128 at stage 4)
launches = 0
launches_dgrad = 0
launches_wgrad = 0
launches_fp32 = 0
launches_dgrad_fp32 = 0
launches_wgrad_fp32 = 0
launches_wide = {}
launches_dgrad_wide = {}
launches_wgrad_wide = {}


def is_wide(cin: int, cout: int) -> bool:
    """Whether a conv of these widths runs the wide kernels."""
    return max(cin, cout) > NARROW_CHANNELS


def _count_wide(counts: dict, cin: int, cout: int) -> None:
    if is_wide(cin, cout):
        key = wide_pitch(max(cin, cout))
        counts[key] = counts.get(key, 0) + 1


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


def window_found(cmap: ColumnMap, block: int, window: int,
                 resid_blocks: int):
    """The taps the JAX package's 'win' formulation keeps
    (ops/sparse_columns.py::build_window_plan and _subm_windowed): (found
    (9, V) bool, n_dropped () int32).

    The dx = 0 taps are always taken.  For each side row (dx = -1, +1) a
    block of ``block`` output slots reads ``window`` (WINDOW_WIDTH) source
    rows from the block's least found slot of that row, unaligned, the
    start clipped to cap - window.  A side tap past its window is kept when
    its block is one of the first ``resid_blocks`` blocks with such a tap
    (the residual gathers take all six side taps of those blocks), dropped
    otherwise; ``n_dropped`` counts the dropped taps."""
    nbr, found = cmap.nbr.long(), cmap.found
    cap = nbr.shape[1]
    window = min(window, cap)
    n_blocks = -(-cap // block)
    pad = n_blocks * block - cap
    slots = torch.cat([nbr, nbr.new_zeros(9, pad)], 1).view(9, n_blocks,
                                                            block)
    fnd = torch.cat([found, found.new_zeros(9, pad)], 1).view(9, n_blocks,
                                                              block)
    past = torch.zeros_like(fnd)
    for d in (0, 2):                         # dx = -1, +1
        s3, f3 = slots[3 * d:3 * d + 3], fnd[3 * d:3 * d + 3]
        smin = torch.where(f3, s3, LARGE_ID).amin(dim=(0, 2))
        start = torch.where(smin < LARGE_ID, smin, 0).clamp(
            0, max(cap - window, 0))
        past[3 * d:3 * d + 3] = s3 - start[None, :, None] >= window
    over = fnd & past
    block_over = over.any(2).any(0)
    in_resid = block_over & (torch.cumsum(block_over, 0) - 1 < resid_blocks)
    dropped = over & ~in_resid[None, :, None]
    keep = fnd & ~dropped
    return keep.reshape(9, -1)[:, :cap], dropped.sum().int()


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
    global launches, launches_fp32
    out = _winfuse_cuda(feats, torch.where(found, nbr, -1), weights, nz)
    launches += 1
    launches_fp32 += feats.dtype == torch.float32
    _count_wide(launches_wide, weights.shape[1], weights.shape[2])
    return out


class WinfuseConv(torch.autograd.Function):
    """K3 with the JAX package's gradient: the forward over the kept taps
    ``found``, the backward over ``grad_found`` (every found tap for
    'winfuse', as ``_winfuse_bwd``; the kept taps otherwise).  It saves
    feats, weights, nbr, grad_found and the reversed map (made in the
    backward when not given).  d feats only when feats takes a gradient
    (conv_input's voxel features take none)."""

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
    backward runs over ``grad_found`` ('winfuse': the map's full found;
    ``found`` when not given) and ``src_t`` (:func:`reverse_map` of nbr and grad_found,
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
    global launches_dgrad, launches_dgrad_fp32
    w = flipped_weights(weights)
    if g.device.type == 'cpu':
        return subm_conv_plain(g, src_t.clamp(min=0), src_t >= 0, w, nz)
    if g.device.type != 'cuda':
        raise ValueError(f'subm_conv_dgrad: unsupported device {g.device}')
    out = _winfuse_cuda(g, src_t, w, nz)
    launches_dgrad += 1
    launches_dgrad_fp32 += g.dtype == torch.float32
    _count_wide(launches_dgrad_wide, w.shape[1], w.shape[2])
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
    (V, nz*Cout), over the found taps (the backward's ``grad_found``):

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
    order (no float atomics: the same gradient from run to run): one GEMM a
    tap on the tensor cores, its depth the cotangent's nonzero (column, z)
    rows, bf16 or fp32 in 3xTF32.  On the CPU
    :func:`subm_conv_wgrad_plain`."""
    if feats.device.type == 'cpu':
        return subm_conv_wgrad_plain(feats, nbr, found, g, nz)
    if feats.device.type != 'cuda':
        raise ValueError(f'subm_conv_wgrad: unsupported device '
                         f'{feats.device}')
    return _wgrad_cuda(feats, nbr, found, g, nz)


def route(dtype: torch.dtype, cin: int = 1, cout: int = 1) -> str:
    """Which units compute the kernel's products for features of ``dtype``,
    and at these widths which kernel: the narrow one up to 32 channels,
    the wide one past them."""
    units = ('tensor cores (mma.sync bf16, fp32 sums)'
             if dtype == torch.bfloat16 else
             'tensor cores (mma.sync 3xTF32, fp32 sums)')
    return units + (', wide kernel' if is_wide(cin, cout) else '')


def channel_pitch(cin: int) -> int:
    """Channels of a z row as the tensor-core kernel stages it (8, 16 or
    32): whole 16-byte chunks of bf16, one ldmatrix row each."""
    return 8 if cin <= 8 else 16 if cin <= 16 else 32


def wide_pitch(c: int) -> int:
    """Channels of a z row as the wide tensor-core kernels take it: 32,
    64 or 128."""
    return 32 if c <= 32 else 64 if c <= 64 else 128


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


def tf32_channels(cp: int) -> torch.Tensor:
    """(4, 2 * cp / 8) int64: channel ch[t, w] of a z row that lane t (of
    the four lanes of a fragment row) of the 3xTF32 forward holds as its
    w-th value, the kernel's permutation of K.  In k8 step s of a z tap
    the lane's a0 is value s and a2 value cp / 8 + s: cp 32 reads 16-byte
    chunks t and t + 4, cp 16 chunk t, cp 8 the 8 bytes at 8 t."""
    t = torch.arange(4).view(4, 1)
    w = torch.arange(2 * (cp // 8)).view(1, -1)
    if cp == 32:
        return 4 * t + w % 4 + 16 * (w // 4)
    return (4 if cp == 16 else 2) * t + w


def tf32_tap_weights(weights: torch.Tensor, cp: int) -> torch.Tensor:
    """(27, Cin, Cout) -> the 3xTF32 forward's B, fp32 (9, 3*cp/8, n/16, 32,
    4) with n = 16 if Cout <= 16 else 32: lane l = 4 g + t of k8 step ks =
    tz*S + s (S = cp / 8) holds, for n-tile pair p,

        (b0, b1 of n-tile 2p, b0, b1 of n-tile 2p + 1),
        b0 = weights[3k + tz, ch[t, s], 8 nt + g],
        b1 = weights[3k + tz, ch[t, S + s], 8 nt + g]

    (ch = :func:`tf32_channels`; zero past Cin and Cout), in the order the
    kernel stages them.  Unrounded fp32: the kernel splits them."""
    _, cin, cout = weights.shape
    n = 16 if cout <= 16 else 32
    sz = cp // 8
    b = weights.new_zeros(9, 3, cp, n, dtype=torch.float32)
    b[:, :, :cin, :cout] = weights.float().reshape(9, 3, cin, cout)
    ch = tf32_channels(cp).to(weights.device)
    s = torch.arange(sz, device=weights.device).view(sz, 1, 1, 1)
    p = torch.arange(n // 16, device=weights.device).view(1, -1, 1, 1)
    lane = torch.arange(32, device=weights.device).view(1, 1, 32, 1)
    word = torch.arange(4, device=weights.device).view(1, 1, 1, 4)
    g, t = lane // 4, lane % 4
    nt = 2 * p + word // 2
    chan = ch[t, s + sz * (word % 2)]        # b0: value s, b1: value S + s
    # (9, 3, S, n/16, 32, 4) -> (9, 3*S, n/16, 32, 4), ks = tz*S + s
    return b[:, :, chan, 8 * nt + g].reshape(9, 3 * sz, n // 16, 32, 4)


# z the wide forwards' per-row activity masks cover (csrc/winfuse_masks.cuh's
# rowmask::kMaxMaskZ; past it every z of a found column is read)
WIDE_MASK_Z = 32


def wide_groups(cout: int, nz: int) -> int:
    """Groups of 64 output channels a block of the wide bf16 forward
    computes: 2 where Cout passes 64 and a tile's items still fill the
    fragments of half its warps (nz <= 128), else 1 (csrc/winfuse.cu's
    wide::groups, the same rule)."""
    return 2 if cout > 64 and nz <= 128 else 1


def wide_tap_weights(weights: torch.Tensor, cp: int,
                     nz: int) -> torch.Tensor:
    """(27, Cin, Cout) -> the wide tensor-core kernel's B fragments, bf16
    (chunks, 9, 3*cp/16, 4*groups, 32, 4, 2), groups = wide_groups(Cout,
    nz) and chunks = ceil(Cout / (64*groups)) blocks of output channels.
    B[k, kk, n] = weights[3k + kk // cp, kk % cp, n] (zero past Cin and
    Cout), and lane l of k16 step s holds, for n-tile pair p, word w and
    half h:

        B[k, 16 s + 2 (l % 4) + 8 (w % 2) + h,
          64 groups chunk + 8 (2p + w // 2) + l // 4]

    the order in which the narrow kernel stages w_s (its b0 and b1 of two
    n-tiles a 16-byte load) for 8*groups n-tiles.  The cp/16 steps of z
    tap tz are one contiguous slab of a (chunk, tap), as the kernel streams
    them.  One gather of the padded (9, 3*cp, Cout) weights by a cached
    order."""
    _, cin, cout = weights.shape
    width = 64 * wide_groups(cout, nz)
    chunks = -(-cout // width)
    b = weights.new_zeros(9, 3 * cp, chunks * width, dtype=torch.bfloat16)
    b.view(9, 3, cp, chunks * width)[:, :, :cin, :cout] = \
        weights.reshape(9, 3, cin, cout)
    order = _wide_order(cp, width, chunks, weights.device)
    return b.view(-1)[order].view(chunks, 9, 3 * cp // 16, width // 16, 32,
                                  4, 2)


@functools.lru_cache(maxsize=None)
def _wide_order(cp: int, width: int, chunks: int,
                device: torch.device) -> torch.Tensor:
    """Flat indices into the padded (9, 3*cp, chunks*width) B of
    :func:`wide_tap_weights`' fragments, in their order."""
    s = torch.arange(3 * cp // 16, device=device).view(-1, 1, 1, 1, 1)
    p = torch.arange(width // 16, device=device).view(1, -1, 1, 1, 1)
    lane = torch.arange(32, device=device).view(1, 1, 32, 1, 1)
    word = torch.arange(4, device=device).view(1, 1, 1, 4, 1)
    half = torch.arange(2, device=device).view(1, 1, 1, 1, 2)
    kk = 16 * s + 2 * (lane % 4) + 8 * (word % 2) + half
    n = 8 * (2 * p + word // 2) + lane // 4
    chunk = torch.arange(chunks, device=device).view(-1, 1, 1)
    tap = torch.arange(9, device=device).view(1, -1, 1)
    return ((tap * 3 * cp).view(1, 9, 1, 1, 1, 1, 1, 1) + kk) * \
        (chunks * width) + (chunk * width).view(-1, 1, 1, 1, 1, 1, 1, 1) + n


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32 as the kernels' cvt.rna.tf32.f32 does (10
    stored mantissa bits, ties away from zero), on its int32 view: the sign
    bit lies apart from the magnitude the carry runs through."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


# items (column, z) of a tile of the wide fp32 forward: 8 warps of 3 m16
# fragments (csrc/winfuse_wide_tf32.cuh's kMaxItems)
WIDE_TF32_ITEMS = 384


def wide_tf32_groups(cout: int, nz: int) -> int:
    """Groups of 64 output channels a block of the wide fp32 forward
    computes: 2 where Cout passes 64 and a tile's items still fill the
    fragments of half its warps (nz <= 192), else 1.  The one place of
    this rule: B is laid out for it and the kernel is launched with it."""
    return 2 if cout > 64 and nz <= WIDE_TF32_ITEMS // 2 else 1


def wide_tf32_tap_weights(weights: torch.Tensor, cp: int,
                          nz: int) -> torch.Tensor:
    """(27, Cin, Cout) -> the wide fp32 forward's B, fp32 (chunks, 9, cp/32,
    3, 4, width/8, 32, 4) for chunks of width = 64 * wide_tf32_groups(Cout,
    nz) output channels: lane l = 4 g + t of k8 step s of row step (tap k,
    32-channel block q) and z tap tz holds for n-tile nt

        (hi(b0), hi(b1), lo(b0), lo(b1)),
        b0 = weights[3k + tz, 32 q + ch[t, s], width chunk + 8 nt + g],
        b1 = weights[3k + tz, 32 q + ch[t, 4 + s], width chunk + 8 nt + g]

    (ch = ``tf32_channels(32)``, the narrow kernel's K order in each
    32-channel block; zero past Cin and Cout), hi = :func:`tf32_rna` of the
    value and lo = tf32_rna of the rest: the 3xTF32 split done once here
    rather than by every warp.  Each (chunk, k, q, tz) is one contiguous
    slab, in the order the kernel streams them.  One gather of the padded
    (9, 3, cp, chunks*width) weights by a cached order."""
    _, cin, cout = weights.shape
    width = 64 * wide_tf32_groups(cout, nz)
    chunks = -(-cout // width)
    b = weights.new_zeros(9, 3, cp, chunks * width, dtype=torch.float32)
    b[:, :, :cin, :cout] = weights.float().reshape(9, 3, cin, cout)
    b = b.view(-1)[_wide_tf32_order(cp, width, chunks, weights.device)]
    hi = tf32_rna(b)
    return torch.cat([hi, tf32_rna(b - hi)], -1)


@functools.lru_cache(maxsize=None)
def _wide_tf32_order(cp: int, width: int, chunks: int,
                     device: torch.device) -> torch.Tensor:
    """Flat indices into the padded (9, 3, cp, chunks*width) B of
    :func:`wide_tf32_tap_weights`' (b0, b1) pairs, (chunks, 9, cp/32, 3, 4,
    width/8, 32, 2) in their order."""
    ch = tf32_channels(32).to(device)
    shape = (chunks, 9, cp // 32, 3, 4, width // 8, 32, 2)

    def axis(dim):
        view = [1] * len(shape)
        view[dim] = shape[dim]
        return torch.arange(shape[dim], device=device).view(view)
    chunk, tap, q, tz, s, nt, lane, word = (axis(d) for d in range(8))
    i = 32 * q + ch[lane % 4, s + 4 * word]
    n = width * chunk + 8 * nt + lane // 4
    return ((tap * 3 + tz) * cp + i) * (chunks * width) + n


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


def _winfuse_cuda(feats, src, weights, nz):
    """K3 on the card: src (9, V) int32, a source row per tap, -1 where the
    tap is not taken.  Past NARROW_CHANNELS in or out the wide kernels
    (bf16 or fp32), with a scratch of each source row's activity mask."""
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
    bf16, wide = feats.dtype == torch.bfloat16, is_wide(cin, cout)
    if wide:
        cp = wide_pitch(cin)
        w = (wide_tap_weights if bf16 else wide_tf32_tap_weights)(weights,
                                                                  cp, nz)
    else:
        cp = channel_pitch(cin)
        w = (tap_weights if bf16 else tf32_tap_weights)(weights, cp)
    rows = pitch_rows(feats, nz, cp)
    masks = torch.empty(rows.shape[0] if wide and nz <= WIDE_MASK_Z else 1,
                        dtype=torch.int32, device=feats.device)
    args = (rows.data_ptr(), src.data_ptr(), w.data_ptr(), out.data_ptr(), v,
            nz, cp, cout, masks.data_ptr(), rows.shape[0])
    if bf16:
        err = cuda_lib.kernel('winfuse', 'sf_winfuse_bf16')(*args, stream)
    else:
        # the groups B was laid out for: the kernel launches with them
        ng = wide_tf32_groups(cout, nz) if wide else 1
        err = cuda_lib.kernel('winfuse_fp32')(*args, ng, stream)
    cuda_lib.check('winfuse', err)
    return out


# partial sums the wgrad kernel may write: one per block, at most this many
# blocks an SM
WGRAD_BLOCKS_PER_SM = 2
# items (column, z) of a chunk of the wide d weights' lists, at most
# (csrc/winfuse_wgrad.cu's wide::kListItems)
WGRAD_LIST_ITEMS = 2048


def wgrad_rows(feats: torch.Tensor, g: torch.Tensor, nz: int):
    """The d-weights kernels' rows: (feats at Cin's channel pitch cp, cp,
    g at Cout's pitch np, np), each from :func:`pitch_rows` (the rows
    themselves where Cin or Cout already is a pitch: 8, 16 or 32, or for
    the wide kernels 32, 64 or 128).
    Every z row then starts on 16 bytes, as the kernels' 16-byte copies and
    their fragment loads need."""
    cin, cout = feats.shape[1] // nz, g.shape[1] // nz
    pitch = wide_pitch if is_wide(cin, cout) else channel_pitch
    cp, np_ = pitch(cin), pitch(cout)
    return pitch_rows(feats, nz, cp), cp, pitch_rows(g, nz, np_), np_


def wgrad_pieces(cp: int, np_: int) -> int:
    """Pieces of dW the wide d weights cut it into, one block row each: per
    tap all three z taps where their (3*cp, np) fp32 sums fit 64 registers
    of 256 threads, else one z tap a piece (csrc/winfuse_wgrad.cu's
    wide::Geo::kTZ and csrc/winfuse_wgrad_wide_tf32.cuh's
    wide_tf32::Geo::kTZ).  The fp32 kernel keeps the bf16 rule and runs
    one block an SM: its split operands take the registers a second block
    would have."""
    return 9 if 3 * cp * np_ <= 64 * 256 else 27


def wgrad_chunk_columns(nz: int) -> int:
    """Columns of a chunk of the wide d weights' item lists."""
    return max(1, WGRAD_LIST_ITEMS // nz)


def wgrad_list_ints(v: int, nz: int) -> int:
    """int32 scratch the wide d weights' lists take for V columns: a list
    of tv*nz items and a count for each chunk of tv columns."""
    tv = wgrad_chunk_columns(nz)
    chunks = -(-v // tv)
    return chunks * tv * nz + chunks


def wgrad_parts(sms: int, cin: int, cout: int) -> int:
    """Partial sums the d-weights kernels may write on a card of ``sms``
    multiprocessors: WGRAD_BLOCKS_PER_SM a multiprocessor, shared by the
    block rows of the wide kernels (:func:`wgrad_pieces`)."""
    rows = (wgrad_pieces(wide_pitch(cin), wide_pitch(cout))
            if is_wide(cin, cout) else 1)
    return max(1, WGRAD_BLOCKS_PER_SM * sms // rows)


def _wgrad_cuda(feats, nbr, found, g, nz):
    global launches_wgrad, launches_wgrad_fp32
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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    max_parts = wgrad_parts(sms, cin, cout)
    scratch = torch.empty(max_parts, 27 * cin * cout, dtype=torch.float32,
                          device=dev)
    out = torch.empty(27, cin, cout, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows, cp, g_rows, np_ = wgrad_rows(feats, g, nz)
    lists = torch.empty(wgrad_list_ints(v, nz) if is_wide(cin, cout) else 1,
                        dtype=torch.int32, device=dev)
    symbol = ('sf_winfuse_wgrad_bf16' if feats.dtype == torch.bfloat16 else
              'sf_winfuse_wgrad_fp32')
    err = cuda_lib.kernel('winfuse_wgrad', symbol)(
        rows.data_ptr(), src.data_ptr(), g_rows.data_ptr(),
        scratch.data_ptr(), max_parts, lists.data_ptr(), out.data_ptr(), v,
        nz, cp, cin, np_, cout, stream)
    cuda_lib.check('winfuse_wgrad', err)
    launches_wgrad += 1
    launches_wgrad_fp32 += feats.dtype == torch.float32
    _count_wide(launches_wgrad_wide, cin, cout)
    return out
