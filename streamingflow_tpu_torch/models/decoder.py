"""BEV multi-head decoder (ResNet18-style trunk + skip upsampling).

Port of streamingflow_tpu/models/decoder.py.  Takes (B, S, C, H, W) and
returns NCHW-per-frame head outputs (B, S, K, H, W); hdmap is (B, K, H, W)
and costvolume (B, S, H, W).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..layers.conv import UpsamplingAdd, batch_norm, conv2d


class BasicBlock(nn.Module):
    """torchvision resnet18 BasicBlock with a zero-initialised residual BN."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = conv2d(cin, features, 3, stride=stride)
        self.BatchNorm_0 = batch_norm(features)
        self.Conv_1 = conv2d(features, features, 3)
        self.BatchNorm_1 = batch_norm(features)
        nn.init.zeros_(self.BatchNorm_1.weight)
        self.project = stride != 1 or cin != features
        if self.project:
            self.Conv_2 = conv2d(cin, features, 1, stride=stride)
            self.BatchNorm_2 = batch_norm(features)

    def forward(self, x):
        h = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        h = self.BatchNorm_1(self.Conv_1(h))
        identity = self.BatchNorm_2(self.Conv_2(x)) if self.project else x
        return F.relu(h + identity)


def _add_head(module: nn.Module, name: str, cin: int, cout: int):
    """3x3 conv-bn-relu -> 1x1 conv (with bias), as flat submodules
    ``{name}_conv1``, ``{name}_bn``, ``{name}_conv2`` of ``module``."""
    module.add_module(f'{name}_conv1', conv2d(cin, cin, 3))
    module.add_module(f'{name}_bn', batch_norm(cin))
    module.add_module(f'{name}_conv2', conv2d(cin, cout, 1, bias=True))


def _run_head(module: nn.Module, name: str, x, sigmoid: bool = False):
    h = getattr(module, f'{name}_conv1')(x)
    h = F.relu(getattr(module, f'{name}_bn')(h))
    h = getattr(module, f'{name}_conv2')(h)
    return torch.sigmoid(h) if sigmoid else h


class Decoder(nn.Module):

    def __init__(self, in_channels: int, n_classes: int, n_present: int,
                 n_hdmap: int = 2, predict_pedestrian: bool = True,
                 perceive_hdmap: bool = True, predict_instance: bool = True,
                 predict_future_flow: bool = True, planning: bool = False):
        super().__init__()
        c = in_channels
        self.n_present = n_present
        self.first_conv = nn.Conv2d(c, 64, 7, stride=2, padding=3, bias=False)
        self.BatchNorm_0 = batch_norm(64)
        for i, (cin, feat, stride) in enumerate(
                [(64, 64, 1), (64, 64, 1), (64, 128, 2), (128, 128, 1),
                 (128, 256, 2), (256, 256, 1)]):
            self.add_module(f'BasicBlock_{i}', BasicBlock(cin, feat, stride))
        self.up3_skip = UpsamplingAdd(256, 128)
        self.up2_skip = UpsamplingAdd(128, 64)
        self.up1_skip = UpsamplingAdd(64, c)
        self.heads = {'segmentation': n_classes}
        if predict_pedestrian:
            self.heads['pedestrian'] = n_classes
        if perceive_hdmap:
            self.heads['hdmap'] = 2 * n_hdmap
        if predict_instance:
            self.heads['instance_center'] = 1
            self.heads['instance_offset'] = 2
        if predict_future_flow:
            self.heads['instance_future'] = 2
        if planning:
            self.heads['costvolume'] = 1
        for name, cout in self.heads.items():
            _add_head(self, f'{name}_head', c, cout)

    def forward(self, x) -> Dict[str, Optional[torch.Tensor]]:
        b, s, c, H, W = x.shape
        flat = x.reshape(b * s, c, H, W)
        skip1 = flat
        h = F.relu(self.BatchNorm_0(self.first_conv(flat)))
        h = self.BasicBlock_1(self.BasicBlock_0(h))
        skip2 = h
        h = self.BasicBlock_3(self.BasicBlock_2(h))
        skip3 = h
        h = self.BasicBlock_5(self.BasicBlock_4(h))
        h = self.up3_skip(h, skip3)
        h = self.up2_skip(h, skip2)
        h = self.up1_skip(h, skip1)

        def unflat(y):
            return y.reshape(b, s, *y.shape[1:])

        out = {k: None for k in ('segmentation', 'pedestrian', 'hdmap',
                                 'instance_center', 'instance_offset',
                                 'instance_flow', 'costvolume')}
        out['segmentation'] = unflat(_run_head(self, 'segmentation_head', h))
        if 'pedestrian' in self.heads:
            out['pedestrian'] = unflat(_run_head(self, 'pedestrian_head', h))
        if 'hdmap' in self.heads:
            # hdmap only from the present frame
            present = unflat(h)[:, self.n_present - 1]
            out['hdmap'] = _run_head(self, 'hdmap_head', present)
        if 'instance_center' in self.heads:
            out['instance_center'] = unflat(_run_head(
                self, 'instance_center_head', h, sigmoid=True))
            out['instance_offset'] = unflat(_run_head(
                self, 'instance_offset_head', h))
        if 'instance_future' in self.heads:
            out['instance_flow'] = unflat(_run_head(
                self, 'instance_future_head', h))
        if 'costvolume' in self.heads:
            out['costvolume'] = unflat(_run_head(
                self, 'costvolume_head', h))[:, :, 0]
        return out
