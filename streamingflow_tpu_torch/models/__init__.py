from .decoder import Decoder  # noqa: F401
from .efficientnet import EfficientNetBackbone  # noqa: F401
from .encoder import Encoder  # noqa: F401
from .future_prediction import FuturePredictionODE, merge_observations  # noqa: F401
from .lidar_encoder import LidarBEVEncoder  # noqa: F401
from .pillar_encoder import PillarBEVEncoder, pillarize  # noqa: F401
from .streamingflow import StreamingFlow, build_model  # noqa: F401
from .temporal_model import TemporalModel  # noqa: F401
