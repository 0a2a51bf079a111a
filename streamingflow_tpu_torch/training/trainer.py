"""Batch -> model arguments (port of streamingflow_tpu/training/trainer.py
::batch_to_model_args; the training step is a later slice)."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device


def batch_to_model_args(batch, cfg: Config, device=None,
                        image_dtype: Optional[torch.dtype] = None
                        ) -> Dict[str, Optional[torch.Tensor]]:
    """Select the model's inputs from a batch dict (numpy or tensors) and
    place them on ``device`` ('cuda' unless asked for 'cpu').  Points,
    poses and times stay float32; ``image_dtype`` casts the images only (the
    mixed-precision forward runs bf16 images)."""
    dev = resolve_device(device)
    use_camera = cfg.MODEL.MODALITY.USE_CAMERA
    use_lidar = cfg.MODEL.MODALITY.USE_LIDAR

    def put(key, dtype=None):
        v = batch[key]
        t = torch.from_numpy(np.asarray(v)) if not torch.is_tensor(v) else v
        return t.to(device=dev, dtype=dtype)

    return dict(
        image=put('image', image_dtype) if use_camera else None,
        intrinsics=put('intrinsics') if use_camera else None,
        extrinsics=put('extrinsics') if use_camera else None,
        future_egomotion=put('future_egomotion'),
        camera_timestamp=put('camera_timestamp'),
        points=put('points') if use_lidar else None,
        lidar_timestamp=put('lidar_timestamp'),
        target_timestamp=put('target_timestamp'))
