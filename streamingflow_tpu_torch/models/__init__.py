from .decoder import Decoder  # noqa: F401
from .distributions import (DistributionModule,  # noqa: F401
                            distribution_forward)
from .efficientnet import EfficientNetBackbone  # noqa: F401
from .encoder import Encoder  # noqa: F401
from .future_prediction import FuturePredictionODE, merge_observations  # noqa: F401
from .lidar_encoder import LidarBEVEncoder  # noqa: F401
from .pillar_encoder import (PillarBEVEncoder, pillarize,  # noqa: F401
                             pillarize_batch)
from .streamingflow import StreamingFlow, build_model  # noqa: F401
from .temporal_model import TemporalModel, TemporalModelIdentity  # noqa: F401
