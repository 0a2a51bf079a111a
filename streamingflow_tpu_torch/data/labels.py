"""Instance label generation: center heatmaps, offsets, future flow.

Port of streamingflow_tpu/data/labels.py (reference streamingflow/utils/
instance.py:12-77, convert_instance_mask_to_center_and_offset_label), used
by the data pipeline on the host.  The pose algebra and the nearest warp
run through the port's geometry on CPU tensors in float32, as the JAX
package runs them through its own.  Outputs channels-last numpy.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import geometry as G


def _warp_nearest(img: np.ndarray, pose_vec: np.ndarray,
                  spatial_extent) -> np.ndarray:
    """Single-image nearest warp (host-side)."""
    out = G.warp_features(torch.from_numpy(img)[None, :, :, None],
                          torch.from_numpy(pose_vec)[None], mode='nearest',
                          spatial_extent=spatial_extent)
    return out[0, :, :, 0].numpy()


def convert_instance_mask_to_center_and_offset_label(
        instance_img: np.ndarray, future_egomotion: np.ndarray,
        num_instances: int, ignore_index: int = 255,
        subtract_egomotion: bool = True, sigma: float = 3.0,
        spatial_extent=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """instance_img: (T, H, W) int ids; future_egomotion: (T, 6).

    Returns (center (T, H, W, 1), offset (T, H, W, 2),
    flow (T, H, W, 2)) with ignore_index padding outside instances."""
    seq_len, h, w = instance_img.shape
    center_label = np.zeros((seq_len, h, w, 1), np.float32)
    offset_label = np.full((seq_len, h, w, 2), ignore_index, np.float32)
    flow_label = np.full((seq_len, h, w, 2), ignore_index, np.float32)
    x, y = np.meshgrid(np.arange(h, dtype=np.float32),
                       np.arange(w, dtype=np.float32), indexing='ij')

    if subtract_egomotion:
        mats = G.pose_vec2mat(torch.as_tensor(future_egomotion,
                                              dtype=torch.float32))
        ego_inv = G.mat2pose_vec(G.invert_pose_matrix(mats)).numpy()

    warped_instance_seg = {}
    for t in range(1, seq_len):
        warped_instance_seg[t] = _warp_nearest(
            instance_img[t].astype(np.float32), ego_inv[t - 1],
            spatial_extent)

    for instance_id in range(1, num_instances + 1):
        prev_xc = prev_yc = prev_mask = None
        for t in range(seq_len):
            instance_mask = instance_img[t] == instance_id
            if instance_mask.sum() == 0:
                prev_xc = prev_yc = prev_mask = None
                continue
            xc = np.round(x[instance_mask].mean())
            yc = np.round(y[instance_mask].mean())
            off_x = xc - x
            off_y = yc - y
            g = np.exp(-(off_x ** 2 + off_y ** 2) / sigma ** 2)
            center_label[t, :, :, 0] = np.maximum(center_label[t, :, :, 0], g)
            offset_label[t, :, :, 0][instance_mask] = off_x[instance_mask]
            offset_label[t, :, :, 1][instance_mask] = off_y[instance_mask]

            if prev_xc is not None:
                warped_mask = warped_instance_seg[t] == instance_id
                if warped_mask.sum() > 0:
                    warped_xc = np.round(x[warped_mask].mean())
                    warped_yc = np.round(y[warped_mask].mean())
                    flow_label[t - 1, :, :, 0][prev_mask] = warped_xc - prev_xc
                    flow_label[t - 1, :, :, 1][prev_mask] = warped_yc - prev_yc
            prev_xc, prev_yc, prev_mask = xc, yc, instance_mask

    return center_label, offset_label, flow_label
