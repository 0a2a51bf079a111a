"""Instance post-processing: center NMS, pixel grouping, temporal ID matching.

A copy of streamingflow_tpu/postprocess/instance.py, kept in the port so
that it imports nothing of the JAX package.  Host-side numpy port of
reference streamingflow/utils/instance.py
(find_instance_centers:80, group_pixels:94, consecutive ids:165, Hungarian
temporal matching:173-269 and the _short_interval variant:272-368, top-level
predict_instance_segmentation_and_trajectories:370/:432).  Not on the
device path — mirrors the reference ops exactly for VPQ parity.

Layout: model outputs are channels-last; heatmaps (T, H, W), offsets/flow
(T, H, W, 2) with component 0 = row (vertical) and 1 = column displacement.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment


def _max_pool2d_same(x: np.ndarray, k: int) -> np.ndarray:
    """Stride-1 max pool with SAME padding (-inf border)."""
    pad = (k - 1) // 2
    padded = np.pad(x, ((pad, pad), (pad, pad)), constant_values=-np.inf)
    h, w = x.shape
    strides = padded.strides
    from numpy.lib.stride_tricks import as_strided
    windows = as_strided(padded, shape=(h, w, k, k),
                         strides=strides + strides)
    return windows.max(axis=(2, 3))


def find_instance_centers(center_prediction: np.ndarray,
                          conf_threshold: float = 0.1,
                          nms_kernel_size: int = 3) -> np.ndarray:
    """Peak NMS on a (H, W) heatmap -> (N, 2) row/col centers.

    Reference: instance.py:80-91 (threshold -> maxpool -> keep local maxima)."""
    x = np.where(center_prediction > conf_threshold, center_prediction, -1.0)
    pooled = _max_pool2d_same(x, nms_kernel_size)
    x = np.where(x != pooled, -1.0, x)
    return np.argwhere(x > 0)


def group_pixels(centers: np.ndarray, offset_predictions: np.ndarray
                 ) -> np.ndarray:
    """Assign every pixel to the nearest (pixel + offset)-space center.

    centers: (N, 2); offset_predictions: (H, W, 2).  Returns (H, W) ids
    starting at 1.  Reference: instance.py:94-113."""
    h, w = offset_predictions.shape[:2]
    grid = np.stack(np.meshgrid(np.arange(h, dtype=np.float32),
                                np.arange(w, dtype=np.float32),
                                indexing='ij'), axis=-1)
    loc = grid + offset_predictions                       # (H, W, 2)
    d = np.linalg.norm(loc[None] - centers[:, None, None].astype(np.float32),
                       axis=-1)                           # (N, H, W)
    return np.argmin(d, axis=0).astype(np.int64) + 1


def update_instance_ids(instance_seg: np.ndarray, old_ids, new_ids
                        ) -> np.ndarray:
    """Relabel ids via an old->new table (reference instance.py:147-162)."""
    indices = np.arange(int(np.max(old_ids)) + 1)
    for old_id, new_id in zip(old_ids, new_ids):
        indices[old_id] = new_id
    return indices[instance_seg]


def make_instance_seg_consecutive(instance_seg: np.ndarray) -> np.ndarray:
    unique_ids = np.unique(instance_seg)
    return update_instance_ids(instance_seg, unique_ids,
                               np.arange(len(unique_ids)))


def get_instance_segmentation_and_centers(
        center_predictions: np.ndarray, offset_predictions: np.ndarray,
        foreground_mask: np.ndarray, conf_threshold: float = 0.1,
        nms_kernel_size: int = 3, max_n_instance_centers: int = 100
        ) -> Tuple[np.ndarray, np.ndarray]:
    """(H, W) heatmap + (H, W, 2) offsets + (H, W) mask -> labelled instances.

    Reference: instance.py:116-144."""
    centers = find_instance_centers(center_predictions,
                                    conf_threshold=conf_threshold,
                                    nms_kernel_size=nms_kernel_size)
    if not len(centers):
        return (np.zeros(center_predictions.shape, np.int64),
                np.zeros((0, 2)))
    centers = centers[:max_n_instance_centers]
    instance_ids = group_pixels(centers, offset_predictions)
    instance_seg = instance_ids * foreground_mask.astype(np.int64)
    return make_instance_seg_consecutive(instance_seg), centers


def _instance_centers_of(seg: np.ndarray, ids, grid) -> np.ndarray:
    return np.stack([grid[:, seg == i].mean(axis=1) for i in ids])


def make_instance_id_temporally_consistent(
        pred_inst: np.ndarray, future_flow: Optional[np.ndarray],
        matching_threshold: float = 3.0, use_flow: bool = True) -> np.ndarray:
    """Propagate instance identities across time via Hungarian matching of
    (optionally flow-warped) instance centers.

    pred_inst: (1, T, H, W); future_flow: (1, T, H, W, 2) or None.
    ``use_flow=False`` with threshold 10 is the _short_interval variant
    (reference instance.py:272-368).  Reference: instance.py:173-269."""
    assert pred_inst.shape[0] == 1, 'assumes batch size 1'
    consistent = [pred_inst[0, 0]]
    largest_instance_id = int(consistent[0].max())
    _, seq_len, h, w = pred_inst.shape
    base_grid = np.stack(np.meshgrid(np.arange(h, dtype=np.float32),
                                     np.arange(w, dtype=np.float32),
                                     indexing='ij'))

    for t in range(seq_len - 1):
        grid = base_grid.copy()
        if use_flow:
            grid = grid + np.moveaxis(future_flow[0, t], -1, 0)
        t_instance_ids = np.unique(consistent[-1])[1:]
        if len(t_instance_ids) == 0:
            consistent.append(pred_inst[0, t + 1])
            continue
        warped_centers = _instance_centers_of(consistent[-1], t_instance_ids,
                                              grid)

        n_instances = int(pred_inst[0, t + 1].max())
        if n_instances == 0:
            consistent.append(pred_inst[0, t + 1])
            continue
        centers = _instance_centers_of(pred_inst[0, t + 1],
                                       range(1, n_instances + 1), base_grid)

        distances = np.linalg.norm(centers[None] - warped_centers[:, None],
                                   axis=-1)
        ids_t, ids_t_one = linear_sum_assignment(distances)
        matching_distances = distances[ids_t, ids_t_one]
        ids_t = ids_t + 1
        ids_t_one = ids_t_one + 1
        # map matrix rows back to real (non-consecutive) ids at time t
        ids_t = t_instance_ids[ids_t - 1]

        keep = matching_distances < matching_threshold
        ids_t, ids_t_one = ids_t[keep], ids_t_one[keep]

        remaining = (set(np.unique(pred_inst[0, t + 1]).tolist())
                     - set(ids_t_one.tolist()) - {0})
        for rid in sorted(remaining):
            largest_instance_id += 1
            ids_t = np.append(ids_t, largest_instance_id)
            ids_t_one = np.append(ids_t_one, rid)

        consistent.append(update_instance_ids(pred_inst[0, t + 1],
                                              old_ids=ids_t_one,
                                              new_ids=ids_t))
    return np.stack(consistent)[None]


def predict_instance_segmentation_and_trajectories(
        output: Dict[str, np.ndarray], compute_matched_centers: bool = False,
        make_consistent: bool = True, vehicles_id: int = 1,
        short_interval: bool = False):
    """Full pipeline: segmentation logits -> consistent instance video.

    output dict uses channels-last model outputs: segmentation
    (B, T, H, W, C), instance_center (B, T, H, W, 1), instance_offset /
    instance_flow (B, T, H, W, 2).  Reference: instance.py:370-428 (:432 for
    the short-interval variant)."""
    seg = np.asarray(output['segmentation'])
    preds = np.argmax(seg, axis=-1)
    foreground = preds == vehicles_id
    B, T = preds.shape[:2]

    center = np.asarray(output['instance_center'])[..., 0]
    offset = np.asarray(output['instance_offset'])

    pred_inst = np.zeros((B, T) + preds.shape[2:], np.int64)
    for b in range(B):
        for t in range(T):
            inst_t, _ = get_instance_segmentation_and_centers(
                center[b, t], offset[b, t], foreground[b, t])
            pred_inst[b, t] = inst_t

    if make_consistent:
        flow = output.get('instance_flow')
        if flow is None:
            flow = np.zeros_like(offset)
        flow = np.asarray(flow)
        threshold = 10.0 if short_interval else 3.0
        consistent = np.concatenate([
            make_instance_id_temporally_consistent(
                pred_inst[b:b + 1], flow[b:b + 1],
                matching_threshold=threshold, use_flow=not short_interval)
            for b in range(B)], axis=0)
    else:
        consistent = pred_inst

    if compute_matched_centers:
        assert B == 1
        matched_centers: Dict[int, list] = {}
        h, w = consistent.shape[2:]
        grid = np.stack(np.meshgrid(np.arange(h, dtype=np.float32),
                                    np.arange(w, dtype=np.float32),
                                    indexing='ij'))
        for instance_id in np.unique(consistent[0, 0])[1:]:
            for t in range(T):
                mask = consistent[0, t] == instance_id
                if mask.sum() > 0:
                    matched_centers.setdefault(int(instance_id), []).append(
                        grid[:, mask].mean(axis=1))
        matched = {k: np.stack(v)[:, ::-1]
                   for k, v in matched_centers.items()}
        return consistent, matched
    return consistent
