"""Device choice and numerics of the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` they take ``'cuda'``, and they raise when CUDA is absent rather
than run on the CPU without being asked to.

Every CLI, and the card's smoke test and tools, pins TF32 off for cuBLAS
matmuls and cuDNN convolutions (:func:`pin_tf32`), so that fp32 work runs in
full fp32 as in the JAX package's parity bars (PyTorch's own default lets
cuDNN run fp32 convolutions in TF32).  The setting is printed in the run's
log and stored in each checkpoint (:func:`tf32_setting`).
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA is not available; pass device="cpu" to run on the CPU')
    return dev


def tf32_setting() -> Dict[str, bool]:
    """The process's TF32 flags, as a checkpoint and a run's log record
    them."""
    return {'matmul_allow_tf32': bool(torch.backends.cuda.matmul.allow_tf32),
            'cudnn_allow_tf32': bool(torch.backends.cudnn.allow_tf32)}


def pin_tf32() -> Dict[str, bool]:
    """Turn TF32 off for matmuls and cuDNN convolutions in this process;
    returns :func:`tf32_setting`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return tf32_setting()
