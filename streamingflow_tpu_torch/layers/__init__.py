from .conv import (ASPP, Bottleblock, Bottleneck, ConvBlock,  # noqa: F401
                   ConvNeXtBlock, ConvTranspose2d, DeepLabHead,
                   UpsamplingAdd, UpsamplingConcat, resize_bilinear,
                   resize_nearest)
from .ode import GRUODEBayes, softplus_rsample  # noqa: F401
from .srvp import ConvNet, ResBlock, SELayer, SmallDecoder, SmallEncoder  # noqa: F401
from .temporal import (BiGRU, Bottleneck3D, CausalConv3d, DualGRUCell,  # noqa: F401
                       GRUGates, PyramidSpatioTemporalPooling, SpatialGRU,
                       TemporalBlock)
