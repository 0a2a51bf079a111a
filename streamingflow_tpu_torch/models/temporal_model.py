"""Per-modality temporal fusion over the past frames.

Port of streamingflow_tpu/models/temporal_model.py.  Sequences are
(B, T, C, H, W) in and out; the 3-D blocks run on (B, C, T, H, W).
"""
from __future__ import annotations

from typing import Tuple

from torch import nn

from ..layers.conv import DeepLabHead
from ..layers.temporal import Bottleneck3D, TemporalBlock


class TemporalModel(nn.Module):

    def __init__(self, in_channels: int, receptive_field: int,
                 input_shape: Tuple[int, int], start_out_channels: int = 64,
                 extra_in_channels: int = 0, inbetween_layers: int = 0,
                 use_pyramid_pooling: bool = True):
        super().__init__()
        self.input_shape = tuple(input_shape)
        h, w = self.input_shape
        self.n_temporal_layers = receptive_field - 1
        self.inbetween_layers = inbetween_layers
        cin, out_channels = in_channels, start_out_channels
        n_bottleneck = 0
        for i in range(self.n_temporal_layers):
            pool_sizes = [(2, h, w)] if use_pyramid_pooling else None
            self.add_module(f'TemporalBlock_{i}', TemporalBlock(
                cin, out_channels, use_pyramid_pooling, pool_sizes))
            for _ in range(inbetween_layers):
                self.add_module(f'Bottleneck3D_{n_bottleneck}', Bottleneck3D(
                    out_channels, out_channels, kernel_size=(1, 3, 3)))
                n_bottleneck += 1
            cin = out_channels
            out_channels += extra_in_channels
        self.final_conv = DeepLabHead(cin, out_channels, hidden_channel=128)

    def forward(self, x):
        """x: (B, T, C, H, W) -> (B, T, start_out_channels, H, W)."""
        if tuple(x.shape[3:5]) != self.input_shape:
            raise ValueError(
                f'temporal model input spatial {tuple(x.shape[3:5])} != BEV '
                f'grid {self.input_shape}: LIFT.*_BOUND and SPARSE_ENCODER '
                f'POINT_CLOUD_RANGE/VOXEL_SIZE must give the same BEV grid')
        x = x.transpose(1, 2)
        n_bottleneck = 0
        for i in range(self.n_temporal_layers):
            x = getattr(self, f'TemporalBlock_{i}')(x)
            for _ in range(self.inbetween_layers):
                x = getattr(self, f'Bottleneck3D_{n_bottleneck}')(x)
                n_bottleneck += 1
        b, c, t, h, w = x.shape
        flat = self.final_conv(x.transpose(1, 2).reshape(b * t, c, h, w))
        return flat.reshape(b, t, *flat.shape[1:])


class TemporalModelIdentity(nn.Module):
    """Pass-through for TEMPORAL_MODEL.NAME 'identity' (a receptive field of
    one frame)."""

    def forward(self, x):
        return x
