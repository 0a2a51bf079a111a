"""Visualisation: flow colouring, heatmaps, prediction videos.

A copy of what the port's ``--plot`` and ``VIS_INTERVAL`` use of
streamingflow_tpu/utils/visualisation.py, kept in the port so that it
imports nothing of the JAX package (the planning and instance-map plots
wait for the planning branch, ROADMAP item 15).

Reference: streamingflow/utils/visualisation.py (flow_to_image:13,
apply_colour_map:43, heatmap_image:68, make_contour:167,
visualise_output:208-326).  Pure numpy — produces (T, H, W, 3) uint8
frames for TensorBoard-style video logging.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def flow_to_image(flow: np.ndarray, autoscale: bool = False) -> np.ndarray:
    """(2, H, W) or (H, W, 2) flow -> (H, W, 3) uint8 angle/magnitude colours.

    Reference flow_to_image:13-31 (Middlebury-style colour wheel)."""
    if flow.shape[0] == 2 and flow.ndim == 3:
        flow = np.moveaxis(flow, 0, -1)
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u * u + v * v)
    maxrad = max(float(rad.max()), 1e-6) if autoscale else max(
        float(np.percentile(rad, 99)), 1.0)
    return compute_color(u / maxrad, v / maxrad)


def make_color_wheel() -> np.ndarray:
    """55-entry RYGCBM colour wheel (reference make_color_wheel:116-164)."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    wheel = []
    for n, (c0, c1) in zip(
            [ry, yg, gc, cb, bm, mr],
            [((255, 0, 0), (255, 255, 0)), ((255, 255, 0), (0, 255, 0)),
             ((0, 255, 0), (0, 255, 255)), ((0, 255, 255), (0, 0, 255)),
             ((0, 0, 255), (255, 0, 255)), ((255, 0, 255), (255, 0, 0))]):
        t = np.linspace(0, 1, n, endpoint=False)[:, None]
        wheel.append((1 - t) * np.asarray(c0) + t * np.asarray(c1))
    return np.concatenate(wheel, axis=0)


_WHEEL = make_color_wheel()


def compute_color(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Bilinear lookup into the colour wheel (reference compute_color:81)."""
    ncols = len(_WHEEL)
    rad = np.sqrt(u * u + v * v)
    a = np.arctan2(-v, -u) / np.pi                  # [-1, 1]
    fk = (a + 1.0) / 2.0 * (ncols - 1)
    k0 = np.floor(fk).astype(int) % ncols
    k1 = (k0 + 1) % ncols
    f = (fk - np.floor(fk))[..., None]
    col = (1 - f) * _WHEEL[k0] / 255.0 + f * _WHEEL[k1] / 255.0
    rad_c = np.clip(rad, 0, 1)[..., None]
    col = 1 - rad_c * (1 - col)                     # desaturate small flows
    return (col * 255).astype(np.uint8)


def _normalise(image: np.ndarray) -> np.ndarray:
    lo, hi = float(image.min()), float(image.max())
    return (image - lo) / max(hi - lo, 1e-6)


def apply_colour_map(image: np.ndarray, autoscale: bool = True) -> np.ndarray:
    """(H, W) scalar -> (H, W, 3) uint8 viridis-like ramp
    (reference apply_colour_map:43-66, without the matplotlib dependency)."""
    x = _normalise(image) if autoscale else np.clip(image, 0, 1)
    # piecewise-linear viridis approximation
    stops = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140],
                      [94, 201, 98], [253, 231, 37]], np.float64)
    pos = x * (len(stops) - 1)
    i0 = np.clip(pos.astype(int), 0, len(stops) - 2)
    f = (pos - i0)[..., None]
    rgb = (1 - f) * stops[i0] + f * stops[i0 + 1]
    return rgb.astype(np.uint8)


def heatmap_image(image: np.ndarray) -> np.ndarray:
    """Centerness heatmap colouring (reference heatmap_image:68-78)."""
    return apply_colour_map(image, autoscale=True)


def make_contour(img: np.ndarray, colour=(0, 0, 0),
                 double_line: bool = False) -> np.ndarray:
    """Draw a 1-px (or 2-px) frame around a (H, W, 3) panel
    (reference make_contour:167-185)."""
    out = img.copy()
    c = np.asarray(colour, np.uint8)
    out[0, :] = c
    out[-1, :] = c
    out[:, 0] = c
    out[:, -1] = c
    if double_line:
        out[1, :] = c
        out[-2, :] = c
        out[:, 1] = c
        out[:, -2] = c
    return out


def visualise_output(labels: Dict[str, np.ndarray],
                     output: Dict[str, np.ndarray],
                     n_present: int = 3) -> np.ndarray:
    """Prediction-vs-label video (T, 2H+pad, 2W+pad, 3) uint8.

    Panel grid mirrors reference visualise_output:208-326: top row =
    segmentation pred | gt, bottom row = instance-centerness heatmap (or
    instance overlay) pred | flow colouring.  Inputs are the channel-last
    batch dicts used throughout this package; panel 0 uses batch element 0."""
    seg_pred = np.argmax(np.asarray(output['segmentation']), axis=-1)[0]
    seg_gt = np.asarray(labels['segmentation'])[0, :, :, :, 0]
    T, H, W = seg_pred.shape

    center_pred = output.get('instance_center')
    flow_pred = output.get('instance_flow')
    frames = []
    pad_v = np.zeros((H, 4, 3), np.uint8)
    for t in range(T):
        a = np.full((H, W, 3), 255, np.uint8)
        a[seg_pred[t] == 1] = [31, 119, 180]
        b = np.full((H, W, 3), 255, np.uint8)
        b[seg_gt[t] == 1] = [255, 127, 14]
        top = np.concatenate([make_contour(a), pad_v, make_contour(b)], 1)

        if center_pred is not None:
            c = heatmap_image(np.asarray(center_pred)[0, t, :, :, 0])
        else:
            c = np.full((H, W, 3), 255, np.uint8)
        if flow_pred is not None:
            d = flow_to_image(np.asarray(flow_pred)[0, t])
        else:
            d = np.full((H, W, 3), 255, np.uint8)
        bottom = np.concatenate([make_contour(c), pad_v, make_contour(d)], 1)
        pad_h = np.zeros((4, top.shape[1], 3), np.uint8)
        frames.append(np.concatenate([top, pad_h, bottom], 0))
    return np.stack(frames)
