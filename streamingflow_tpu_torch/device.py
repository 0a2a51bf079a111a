"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` they take ``'cuda'``, and they raise when CUDA is absent rather
than run on the CPU without being asked to."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA is not available; pass device="cpu" to run on the CPU')
    return dev
