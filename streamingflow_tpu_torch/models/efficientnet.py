"""EfficientNet backbone (B0/B4/B7), truncated at 8x for the camera encoder.

Port of streamingflow_tpu/models/efficientnet.py: TF hyper-parameters (BN
eps 1e-3, momentum 0.99 in flax terms), swish activations, and TF 'SAME'
padding, which pads a strided conv asymmetrically (more at the end) and so
is spelled as an explicit F.pad before an unpadded conv.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..layers.conv import batch_norm

# (num_repeat, kernel, stride, expand_ratio, input_filters, output_filters,
#  se_ratio)
_BASE_BLOCK_ARGS = [
    (1, 3, 1, 1, 32, 16, 0.25),
    (2, 3, 2, 6, 16, 24, 0.25),
    (2, 5, 2, 6, 24, 40, 0.25),
    (3, 3, 2, 6, 40, 80, 0.25),
    (3, 5, 1, 6, 80, 112, 0.25),
    (4, 5, 2, 6, 112, 192, 0.25),
    (1, 3, 1, 6, 192, 320, 0.25),
]

# width_coefficient, depth_coefficient, dropout_rate
_PARAMS = {
    'efficientnet-b0': (1.0, 1.0, 0.2),
    'efficientnet-b4': (1.4, 1.8, 0.4),
    'efficientnet-b7': (2.0, 3.1, 0.5),
}

# truncation index for DOWNSAMPLE == 8
_TRUNCATE_IDX_DS8 = {'b0': 10, 'b4': 21, 'b7': 37}

_DROP_CONNECT_RATE = 0.2


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new_filters = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_filters < 0.9 * filters:
        new_filters += divisor
    return int(new_filters)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def _bn(c: int) -> nn.Module:
    return batch_norm(c, eps=1e-3, momentum=0.01)


class SameConv2d(nn.Conv2d):
    """Conv2d with TF 'SAME' padding (total pad max((ceil(n/s)-1)*s + k - n,
    0), split with the extra cell at the end)."""

    def __init__(self, cin, cout, k, stride=1, groups=1, bias=False):
        super().__init__(cin, cout, k, stride=stride, groups=groups,
                         bias=bias)

    def forward(self, x):
        pads = []
        for n, k, s in zip(x.shape[-1:-3:-1], self.kernel_size[::-1],
                           self.stride[::-1]):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads))


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck with squeeze-excitation."""

    def __init__(self, in_filters: int, out_filters: int, kernel: int,
                 stride: int, expand_ratio: int, se_ratio: float,
                 drop_connect_rate: float = 0.0):
        super().__init__()
        expanded = in_filters * expand_ratio
        self.expand = expand_ratio != 1
        self.residual = stride == 1 and in_filters == out_filters
        self.drop_connect_rate = drop_connect_rate
        bns = iter(range(3))
        if self.expand:
            self.expand_conv = nn.Conv2d(in_filters, expanded, 1, bias=False)
            self.bn_expand = f'BatchNorm_{next(bns)}'
            self.add_module(self.bn_expand, _bn(expanded))
        self.depthwise_conv = SameConv2d(expanded, expanded, kernel, stride,
                                         groups=expanded)
        self.bn_depthwise = f'BatchNorm_{next(bns)}'
        self.add_module(self.bn_depthwise, _bn(expanded))
        self.se = se_ratio > 0
        if self.se:
            se_channels = max(1, int(in_filters * se_ratio))
            self.se_reduce = nn.Conv2d(expanded, se_channels, 1)
            self.se_expand = nn.Conv2d(se_channels, expanded, 1)
        self.project_conv = nn.Conv2d(expanded, out_filters, 1, bias=False)
        self.bn_project = f'BatchNorm_{next(bns)}'
        self.add_module(self.bn_project, _bn(out_filters))

    def forward(self, x):
        inputs = x
        if self.expand:
            x = F.silu(getattr(self, self.bn_expand)(self.expand_conv(x)))
        x = F.silu(getattr(self, self.bn_depthwise)(self.depthwise_conv(x)))
        if self.se:
            s = x.mean(dim=(2, 3), keepdim=True)
            s = self.se_expand(F.silu(self.se_reduce(s)))
            x = torch.sigmoid(s) * x
        x = getattr(self, self.bn_project)(self.project_conv(x))
        if self.residual:
            if self.training and self.drop_connect_rate > 0:
                raise NotImplementedError(
                    'drop connect (train mode) belongs to the training '
                    'slice (ROADMAP.md, Queue 1 item 11)')
            x = x + inputs
        return x


def _block_list(width: float, depth: float
                ) -> List[Tuple[int, int, int, int, int, float]]:
    blocks = []
    for (r, k, s, e, ci, co, se) in _BASE_BLOCK_ARGS:
        ci_r = round_filters(ci, width)
        co_r = round_filters(co, width)
        for i in range(round_repeats(r, depth)):
            blocks.append((k, s if i == 0 else 1, e,
                           ci_r if i == 0 else co_r, co_r, se))
    return blocks


class EfficientNetBackbone(nn.Module):
    """Truncated EfficientNet returning (input_1, input_2): the deepest
    endpoint and the one a factor 2 shallower.  ``channels`` holds their
    widths."""

    def __init__(self, name_version: str = 'efficientnet-b4',
                 downsample: int = 8):
        super().__init__()
        if downsample != 8:
            raise NotImplementedError('only DOWNSAMPLE == 8 is built')
        width, depth, _ = _PARAMS[name_version]
        version = name_version.split('-')[1]
        blocks = _block_list(width, depth)[:_TRUNCATE_IDX_DS8[version] + 1]
        self.n_blocks = len(blocks)
        stem = round_filters(32, width)
        self.conv_stem = SameConv2d(3, stem, 3, 2)
        self.BatchNorm_0 = _bn(stem)
        # endpoint widths: an endpoint is recorded before each stride-2
        # block, and the last block's output closes the list
        widths, prev = [], stem
        for idx, (k, s, e, ci, co, se) in enumerate(blocks):
            rate = _DROP_CONNECT_RATE * idx / self.n_blocks
            self.add_module(f'block_{idx}',
                            MBConvBlock(ci, co, k, s, e, se, rate))
            if s > 1:
                widths.append(prev)
            prev = co
        widths.append(prev)
        self.index = int(math.log2(downsample))
        self.channels = (widths[self.index], widths[self.index - 1])

    def forward(self, x):
        x = F.silu(self.BatchNorm_0(self.conv_stem(x)))
        endpoints = []
        prev = x
        for idx in range(self.n_blocks):
            x = getattr(self, f'block_{idx}')(x)
            if prev.shape[2] > x.shape[2]:
                endpoints.append(prev)
            prev = x
        endpoints.append(x)
        return endpoints[self.index], endpoints[self.index - 1]
