"""SRVP-style small encoder/decoder and the latent-parameter ConvNet (NCHW).

Port of streamingflow_tpu/layers/srvp.py.  Every ConvBlock here uses
LeakyReLU(0.1) unless stated, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .conv import ConvBlock, conv2d, resize_nearest
from .trainmode import Dropout


class ResBlock(nn.Module):
    """Two ConvBlocks + dropout, residual with a 1x1 projection (with bias)
    when the width changes."""

    def __init__(self, cin: int, cout: Optional[int] = None, norm: str = 'bn',
                 activation: str = 'lrelu'):
        super().__init__()
        cout = cout or cin
        self.ConvBlock_0 = ConvBlock(cin, cin, 3, norm=norm,
                                     activation=activation)
        self.ConvBlock_1 = ConvBlock(cin, cout, 3, norm=norm,
                                     activation=activation)
        self.dropout = Dropout(0.25)
        self.project = cout != cin
        if self.project:
            self.Conv_0 = conv2d(cin, cout, 1, bias=True)

    def forward(self, x):
        h = self.dropout(self.ConvBlock_1(self.ConvBlock_0(x)))
        if self.project:
            x = self.Conv_0(x)
        return x + h


class SmallEncoder(nn.Module):
    """4x-downsampling encoder: 5 ResBlocks with a maxpool before blocks 1
    and 2, then a tanh ConvBlock."""

    def __init__(self, cin: int, nh: int, nf: int):
        super().__init__()
        widths = [nf, nf * 2, nf * 2, nf * 2, nf * 4]
        c = cin
        for i, w in enumerate(widths):
            self.add_module(f'ResBlock_{i}', ResBlock(c, w))
            c = w
        self.ConvBlock_0 = ConvBlock(c, nh, 3, activation='tanh')

    def forward(self, x):
        h = x
        for i in range(5):
            if i in (1, 2):
                h = F.max_pool2d(h, 2, 2)
            h = getattr(self, f'ResBlock_{i}')(h)
        return self.ConvBlock_0(h)


class SmallDecoder(nn.Module):
    """4x-upsampling decoder mirroring SmallEncoder (no skip connections)."""

    def __init__(self, cin: int, nh: int, nf: int, skip: bool = False):
        super().__init__()
        if skip:
            raise NotImplementedError('SmallDecoder skip connections')
        self.ConvBlock_0 = ConvBlock(cin, nf * 4, transpose=True,
                                     activation='lrelu')
        widths = [nf * 2, nf * 2, nf * 2, nf, nf]
        c = nf * 4
        for i, w in enumerate(widths):
            self.add_module(f'ResBlock_{i}', ResBlock(c, w))
            c = w
        self.ConvBlock_1 = ConvBlock(c, nf, 3, activation='lrelu')
        self.ConvBlock_2 = ConvBlock(nf, nh, 3, transpose=True, bias=True,
                                     norm='none', activation='lrelu')

    def forward(self, z):
        h = self.ConvBlock_0(z)
        for i in range(5):
            h = getattr(self, f'ResBlock_{i}')(h)
            if i in (2, 3):
                h = resize_nearest(h, (h.shape[2] * 2, h.shape[3] * 2))
        return self.ConvBlock_2(self.ConvBlock_1(h))


class SELayer(nn.Module):
    """Squeeze-and-excitation."""

    def __init__(self, c: int, reduction: int = 8):
        super().__init__()
        self.Dense_0 = nn.Linear(c, c // reduction, bias=False)
        self.Dense_1 = nn.Linear(c // reduction, c, bias=False)

    def forward(self, x):
        y = x.mean(dim=(2, 3))
        y = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(y))))
        return x * y[:, :, None, None]


class ConvNet(nn.Module):
    """Latent-parameter head (p_model): ResBlock/SE x2 + ConvBlock."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.ResBlock_0 = ResBlock(cin, cout)
        self.SELayer_0 = SELayer(cout)
        self.ResBlock_1 = ResBlock(cout, cout)
        self.SELayer_1 = SELayer(cout)
        self.ConvBlock_0 = ConvBlock(cout, cout, 3, bias=True, norm='none',
                                     activation='lrelu')

    def forward(self, x):
        h = self.SELayer_0(self.ResBlock_0(x))
        h = self.SELayer_1(self.ResBlock_1(h))
        return self.ConvBlock_0(h)
