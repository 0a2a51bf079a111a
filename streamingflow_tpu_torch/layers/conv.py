"""2-D convolutional building blocks (NCHW).

Port of streamingflow_tpu/layers/conv.py.  Submodules carry the names of
the flax modules they stand for (``Conv_0``, ``BatchNorm_0``, ...), so a
flax variable path maps onto a torch parameter name by rule
(streamingflow_tpu_torch/convert.py).  BatchNorm follows the JAX package:
eps 1e-5 unless set, torch momentum = 1 - flax momentum, and flax's
train-mode rule (layers/trainmode.py).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .trainmode import BatchNorm, Dropout


def batch_norm(channels: int, eps: float = 1e-5,
               momentum: float = 0.1) -> BatchNorm:
    return BatchNorm(channels, eps=eps, momentum=momentum)


def conv2d(cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1,
           groups: int = 1, bias: bool = False) -> nn.Conv2d:
    """k x k conv with symmetric padding (k // 2) * dilation."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=(k // 2) * dilation,
                     dilation=dilation, groups=groups, bias=bias)


def make_activation(activation: str):
    return {
        'relu': F.relu,
        'lrelu': lambda x: F.leaky_relu(x, 0.1),
        'tanh': torch.tanh,
        'none': None,
    }[activation]


def channel_layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the channel axis of an NCHW map."""
    return ln(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize with half-pixel centres (jax.image.resize 'bilinear'
    when upsampling; torch align_corners=False)."""
    return F.interpolate(x, size=tuple(out_hw), mode='bilinear',
                         align_corners=False)


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest resize; equal to jax.image.resize 'nearest' at the integer
    upsampling factors the model uses."""
    return F.interpolate(x, size=tuple(out_hw), mode='nearest')


class ConvTranspose2d(nn.Conv2d):
    """The flax ``ConvTranspose`` (``transpose_kernel=False``): the input
    dilated by ``stride`` with zeros, padded by (``pad_lo``, ``pad_hi``) on
    each spatial axis and correlated with the kernel as it is stored.  The
    weight keeps the layout of a Conv2d (O, I, kH, kW), so it converts by
    the Conv2d rule (convert.py); the forward is ``conv_transpose2d`` with
    that kernel flipped and its channel axes swapped, padding
    ``k - 1 - pad_lo`` and output padding ``pad_hi - pad_lo``.  Output size
    (H - 1) stride + 1 + pad_lo + pad_hi - k + 1."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 pad_lo: int, pad_hi: int, bias: bool = False):
        super().__init__(cin, cout, k, bias=bias)
        self.t_stride = stride
        self.t_padding = k - 1 - pad_lo
        self.t_output_padding = pad_hi - pad_lo
        if self.t_padding < 0 or not 0 <= self.t_output_padding < stride:
            raise ValueError(f'padding ({pad_lo}, {pad_hi}) of a k={k}, '
                             f'stride {stride} transposed conv')

    def forward(self, x):
        w = self.weight.flip(2, 3).transpose(0, 1)
        return F.conv_transpose2d(x, w, self.bias, stride=self.t_stride,
                                  padding=self.t_padding,
                                  output_padding=self.t_output_padding)


class ConvBlock(nn.Module):
    """Conv (or transposed conv) -> optional norm -> activation.

    The flax block's stride-1 ConvTranspose with symmetric padding is a
    plain correlation with the same kernel, so it spells F.conv2d here
    (only the submodule name differs); a strided one correlates the
    zero-dilated input (:class:`ConvTranspose2d`): 2H - 1 rows out of H for
    k 3, stride 2.  ``norm``: 'bn', 'in' (instance norm: GroupNorm with one
    channel a group, scale and bias, eps 1e-5) or 'none'."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, norm: str = 'bn', activation: str = 'relu',
                 bias: bool = False, transpose: bool = False):
        super().__init__()
        k = kernel_size
        if transpose and stride != 1:
            conv = ConvTranspose2d(cin, cout, k, stride, k // 2, k // 2,
                                   bias=bias)
        else:
            conv = conv2d(cin, cout, k, stride=stride, bias=bias)
        self.conv_name = 'ConvTranspose_0' if transpose else 'Conv_0'
        self.add_module(self.conv_name, conv)
        if norm == 'bn':
            self.BatchNorm_0 = batch_norm(cout)
        elif norm == 'in':
            self.GroupNorm_0 = nn.GroupNorm(cout, cout, eps=1e-5)
        elif norm != 'none':
            raise ValueError(f'Invalid norm {norm}')
        self.norm = norm
        self.act = make_activation(activation)

    def forward(self, x):
        x = getattr(self, self.conv_name)(x)
        if self.norm == 'bn':
            x = self.BatchNorm_0(x)
        elif self.norm == 'in':
            x = self.GroupNorm_0(x)
        return x if self.act is None else self.act(x)


class Bottleneck(nn.Module):
    """1x1 down-projection -> k x k conv (plain, stride 2, or transposed x2)
    -> 1x1 up-projection, each with BN and ReLU, optional dropout, and a
    residual: the identity, or (bilinear x2 / 2x2 max pool) -> 1x1 conv ->
    BN when the width or the size changes.  The upsampling conv is the flax
    ConvTranspose of stride 2 padded (k - 1 - k // 2, k - 1): 2H x 2W out
    of H x W."""

    def __init__(self, cin: int, cout: Optional[int] = None,
                 kernel_size: int = 3, upsample: bool = False,
                 downsample: bool = False, dropout: float = 0.0):
        super().__init__()
        cout = cout or cin
        mid = cin // 2
        k, pad = kernel_size, kernel_size // 2
        self.upsample, self.downsample = upsample, downsample
        self.Conv_0 = conv2d(cin, mid, 1)
        if upsample:
            self.ConvTranspose_0 = ConvTranspose2d(mid, mid, k, 2, k - 1 - pad,
                                                   k - 1)
            mid_conv, up, skip = 'ConvTranspose_0', 'Conv_1', 'Conv_2'
        else:
            self.Conv_1 = conv2d(mid, mid, k, stride=2 if downsample else 1)
            mid_conv, up, skip = 'Conv_1', 'Conv_2', 'Conv_3'
        self.mid_conv, self.up_conv = mid_conv, up
        self.add_module(up, conv2d(mid, cout, 1))
        for i in range(3):
            self.add_module(f'BatchNorm_{i}', batch_norm(mid if i < 2
                                                         else cout))
        self.dropout = Dropout(dropout)
        self.identity = cout == cin and not downsample and not upsample
        if not self.identity:
            self.skip_conv = skip
            self.add_module(skip, conv2d(cin, cout, 1))
            self.BatchNorm_3 = batch_norm(cout)

    def forward(self, x):
        h = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        h = F.relu(self.BatchNorm_1(getattr(self, self.mid_conv)(h)))
        h = F.relu(self.BatchNorm_2(getattr(self, self.up_conv)(h)))
        h = self.dropout(h)
        if self.identity:
            return h + x
        skip = x
        if self.upsample:
            skip = resize_bilinear(skip, (x.shape[2] * 2, x.shape[3] * 2))
        elif self.downsample:
            skip = F.max_pool2d(skip, 2, 2)
        skip = self.BatchNorm_3(getattr(self, self.skip_conv)(skip))
        return h + skip


class UpsamplingConcat(nn.Module):
    """Bilinear x2 upsample, concat the skip in front, two conv-bn-relu."""

    def __init__(self, cin_up: int, cin_skip: int, cout: int,
                 scale_factor: int = 2):
        super().__init__()
        self.scale_factor = scale_factor
        self.Conv_0 = conv2d(cin_skip + cin_up, cout, 3)
        self.BatchNorm_0 = batch_norm(cout)
        self.Conv_1 = conv2d(cout, cout, 3)
        self.BatchNorm_1 = batch_norm(cout)

    def forward(self, x_to_upsample, x):
        h, w = x_to_upsample.shape[-2:]
        up = resize_bilinear(x_to_upsample,
                             (h * self.scale_factor, w * self.scale_factor))
        out = torch.cat([x, up], dim=1)
        out = F.relu(self.BatchNorm_0(self.Conv_0(out)))
        return F.relu(self.BatchNorm_1(self.Conv_1(out)))


class UpsamplingAdd(nn.Module):
    """Bilinear upsample -> 1x1 conv -> bn, then add the skip."""

    def __init__(self, cin: int, cout: int, scale_factor: int = 2):
        super().__init__()
        self.scale_factor = scale_factor
        self.Conv_0 = conv2d(cin, cout, 1)
        self.BatchNorm_0 = batch_norm(cout)

    def forward(self, x, x_skip):
        h, w = x.shape[-2:]
        x = resize_bilinear(x, (h * self.scale_factor, w * self.scale_factor))
        return self.BatchNorm_0(self.Conv_0(x)) + x_skip


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: 1x1, three dilated 3x3, image pool."""

    def __init__(self, cin: int, cout: int = 256,
                 atrous_rates: Sequence[int] = (12, 24, 36)):
        super().__init__()
        self.Conv_0 = conv2d(cin, cout, 1)
        for i, rate in enumerate(atrous_rates):
            self.add_module(f'Conv_{i + 1}', conv2d(cin, cout, 3,
                                                    dilation=rate))
        self.Conv_4 = conv2d(cin, cout, 1)
        self.Conv_5 = conv2d(5 * cout, cout, 1)
        for i in range(6):
            self.add_module(f'BatchNorm_{i}', batch_norm(cout))
        self.dropout = Dropout(0.5)

    def forward(self, x):
        def bn_relu(i, h):
            return F.relu(getattr(self, f'BatchNorm_{i}')(h))

        res = [bn_relu(i, getattr(self, f'Conv_{i}')(x)) for i in range(4)]
        pooled = bn_relu(4, self.Conv_4(x.mean(dim=(2, 3), keepdim=True)))
        res.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        out = bn_relu(5, self.Conv_5(torch.cat(res, dim=1)))
        return self.dropout(out)


class DeepLabHead(nn.Module):
    """ASPP -> 3x3 conv-bn-relu -> 1x1 conv (with bias)."""

    def __init__(self, cin: int, num_classes: int, hidden_channel: int = 256):
        super().__init__()
        self.ASPP_0 = ASPP(cin, hidden_channel)
        self.Conv_0 = conv2d(hidden_channel, hidden_channel, 3)
        self.BatchNorm_0 = batch_norm(hidden_channel)
        self.Conv_1 = conv2d(hidden_channel, num_classes, 1, bias=True)

    def forward(self, x):
        x = self.ASPP_0(x)
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        return self.Conv_1(x)


class ConvNeXtBlock(nn.Module):
    """dwconv7x7 -> LN -> linear x4 -> GELU -> linear, layer scale +
    residual."""

    def __init__(self, dim: int):
        super().__init__()
        self.Conv_0 = conv2d(dim, dim, 7, groups=dim, bias=True)
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-6)
        self.Dense_0 = nn.Linear(dim, 4 * dim)
        self.Dense_1 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x):
        h = self.Conv_0(x).permute(0, 2, 3, 1)
        h = self.Dense_1(F.gelu(self.Dense_0(self.LayerNorm_0(h))))
        return x + (self.gamma * h).permute(0, 3, 1, 2)


class Bottleblock(nn.Module):
    """7x7 -> LN -> GELU -> 1x1 -> LN -> GELU -> 3x3 -> LN -> GELU, with a
    residual (1x1 + GELU projection when the width changes)."""

    def __init__(self, cin: int, cout: Optional[int] = None):
        super().__init__()
        cout = cout or cin
        mid = cin // 2
        self.same = cout == cin
        self.Conv_0 = conv2d(cin, mid, 7)
        self.LayerNorm_0 = nn.LayerNorm(mid, eps=1e-6)
        self.Conv_1 = conv2d(mid, mid, 1)
        self.LayerNorm_1 = nn.LayerNorm(mid, eps=1e-6)
        self.Conv_2 = conv2d(mid, cout, 3)
        self.LayerNorm_2 = nn.LayerNorm(cout, eps=1e-6)
        if not self.same:
            self.Conv_3 = conv2d(cin, cout, 1)

    def forward(self, x):
        h = x
        for i in range(3):
            h = getattr(self, f'Conv_{i}')(h)
            h = F.gelu(channel_layer_norm(getattr(self, f'LayerNorm_{i}'), h))
        if self.same:
            return h + x
        return h + F.gelu(self.Conv_3(x))
