"""Camera encoder: truncated EfficientNet + DeepLab feature/depth necks.

Port of streamingflow_tpu/models/encoder.py.  NCHW: (B', 3, H, W) images
-> (B', C, H/8, W/8) features and (B', D, H/8, W/8) depth logits.
"""
from __future__ import annotations

from torch import nn

from ..layers.conv import DeepLabHead, UpsamplingConcat
from .efficientnet import EfficientNetBackbone


class Encoder(nn.Module):

    def __init__(self, out_channels: int, depth_channels: int,
                 backbone_name: str = 'efficientnet-b4', downsample: int = 8,
                 use_depth_distribution: bool = True):
        super().__init__()
        self.backbone = EfficientNetBackbone(backbone_name, downsample)
        c1, c2 = self.backbone.channels
        self.feature_layer_1 = DeepLabHead(c1, c1, hidden_channel=64)
        self.feature_layer_2 = UpsamplingConcat(c1, c2, out_channels)
        self.use_depth_distribution = use_depth_distribution
        if use_depth_distribution:
            self.depth_layer_1 = DeepLabHead(c1, c1, hidden_channel=64)
            self.depth_layer_2 = UpsamplingConcat(c1, c2, depth_channels)

    def forward(self, x):
        input_1, input_2 = self.backbone(x)
        feature = self.feature_layer_2(self.feature_layer_1(input_1), input_2)
        depth = None
        if self.use_depth_distribution:
            depth = self.depth_layer_2(self.depth_layer_1(input_1), input_2)
        return feature, depth
