"""VGG64-style SRVP encoder / decoder variants (NCHW).

Port of streamingflow_tpu/layers/srvp_vgg.py (reference
streamingflow/layers/srvp_models.py: VGG64Encoder:59, VGG64Decoder:138),
dormant in the shipped config (the main path uses the Small* pair of
layers/srvp.py).  64 x 64 inputs, 4 double-conv stages with a 2 x 2 max
pool between, a mirrored decoder with optional skip connections.
Submodules carry the flax names (``VGGBlock_i``, ``Conv_0``,
``ConvTranspose_0``, ``BatchNorm_0``), so convert.py maps a JAX tree onto
them by its rules.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .conv import ConvTranspose2d, batch_norm, conv2d, resize_nearest


class VGGBlock(nn.Module):
    """3 x 3 conv (no bias) -> BatchNorm -> LeakyReLU(0.2)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.Conv_0 = conv2d(cin, features, 3)
        self.BatchNorm_0 = batch_norm(features)

    def forward(self, x):
        return F.leaky_relu(self.BatchNorm_0(self.Conv_0(x)), 0.2)


class VGG64Encoder(nn.Module):
    """(B, cin, 64, 64) -> (B, nh, 1, 1) latent (tanh); with
    ``return_skip`` also each stage's output, the deepest first."""

    def __init__(self, cin: int, nh: int, nf: int = 64):
        super().__init__()
        widths = [nf, nf * 2, nf * 4, nf * 8]
        c = cin
        for i, w in enumerate(widths):
            self.add_module(f'VGGBlock_{2 * i}', VGGBlock(c, w))
            self.add_module(f'VGGBlock_{2 * i + 1}', VGGBlock(w, w))
            c = w
        self.Conv_0 = nn.Conv2d(c, nh, 4, padding=0, bias=False)

    def forward(self, x, return_skip: bool = False):
        skips = []
        h = x
        for i in range(4):
            if i > 0:
                h = F.max_pool2d(h, 2, 2)
            h = getattr(self, f'VGGBlock_{2 * i}')(h)
            h = getattr(self, f'VGGBlock_{2 * i + 1}')(h)
            skips.append(h)
        h = torch.tanh(self.Conv_0(F.max_pool2d(h, 2, 2)))
        if return_skip:
            return h, skips[::-1]
        return h


class VGG64Decoder(nn.Module):
    """Latent (B, nh, h0, w0) -> (B, nc, 16 (h0 + 3), 16 (w0 + 3)) frame
    (64 x 64 from a 1 x 1 latent), mirroring VGG64Encoder; with ``skip``
    each stage takes the encoder's skip of its size."""

    def __init__(self, nh: int, nc: int, nf: int = 64, skip: bool = False):
        super().__init__()
        self.skip = skip
        widths = [nf * 8, nf * 4, nf * 2, nf]
        # flax ConvTranspose 'VALID', stride 1: padded k - 1 on each side
        self.ConvTranspose_0 = ConvTranspose2d(nh, widths[0], 4, 1, 3, 3)
        self.BatchNorm_0 = batch_norm(widths[0])
        c = widths[0]
        for i, w in enumerate(widths):
            # the encoder's stage i from the deepest has widths[i] channels
            cin = c + (w if skip else 0)
            self.add_module(f'VGGBlock_{2 * i}', VGGBlock(cin, w))
            self.add_module(f'VGGBlock_{2 * i + 1}', VGGBlock(w, w))
            c = w
        self.Conv_0 = conv2d(c, nc, 3, bias=True)

    def forward(self, z, skip: Optional[Sequence[torch.Tensor]] = None,
                sigmoid: bool = True):
        if (skip is None) != (not self.skip):
            raise ValueError('skips are given exactly when the decoder was '
                             'built with skip=True')
        h = F.leaky_relu(self.BatchNorm_0(self.ConvTranspose_0(z)), 0.2)
        for i in range(4):
            h = resize_nearest(h, (h.shape[2] * 2, h.shape[3] * 2))
            if skip is not None:
                h = torch.cat([h, skip[i]], dim=1)
            h = getattr(self, f'VGGBlock_{2 * i}')(h)
            h = getattr(self, f'VGGBlock_{2 * i + 1}')(h)
        h = self.Conv_0(h)
        return torch.sigmoid(h) if sigmoid else h
