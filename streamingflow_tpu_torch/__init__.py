"""PyTorch + CUDA port of streamingflow_tpu for NVIDIA Hopper (H100).

The JAX package ``streamingflow_tpu`` stays the reference; this package
imports nothing of it (nor of JAX).  Each Pallas kernel of the ported path
is a hand-written CUDA kernel here (``csrc/``), built at first use, beside a
plain PyTorch version that runs for CPU tensors.  Entry points run on the
card unless the caller asks for the CPU.
"""

__version__ = '0.1.0'

from .config import Config, get_cfg, load_cfg  # noqa: F401
from .models.streamingflow import StreamingFlow, build_model  # noqa: F401
from .training.trainer import batch_to_model_args  # noqa: F401
