from .conv import (ASPP, Bottleblock, ConvBlock, ConvNeXtBlock,  # noqa: F401
                   DeepLabHead, UpsamplingAdd, UpsamplingConcat,
                   resize_bilinear, resize_nearest)
from .ode import GRUODEBayes, softplus_rsample  # noqa: F401
from .srvp import ConvNet, ResBlock, SELayer, SmallDecoder, SmallEncoder  # noqa: F401
from .temporal import (Bottleneck3D, CausalConv3d, DualGRUCell,  # noqa: F401
                       GRUGates, PyramidSpatioTemporalPooling, SpatialGRU,
                       TemporalBlock)
