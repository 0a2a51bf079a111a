"""Small tensor utilities (port of streamingflow_tpu/utils/network.py;
reference streamingflow/utils/network.py)."""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def pack_sequence_dim(x: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) -> (B*T, ...). Reference network.py:5-7."""
    b, t = x.shape[:2]
    return x.reshape(b * t, *x.shape[2:])


def unpack_sequence_dim(x: torch.Tensor, b: int, t: int) -> torch.Tensor:
    """(B*T, ...) -> (B, T, ...). Reference network.py:10-12."""
    return x.reshape(b, t, *x.shape[1:])


def preprocess_batch(batch, device=None):
    """A host batch's numpy arrays as tensors on ``device`` ('cuda' unless
    asked for 'cpu'; raises when CUDA is absent and no device was given),
    anything else as it is (reference network.py:14-24)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
            else v for k, v in batch.items()}
