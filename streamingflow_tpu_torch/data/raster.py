"""Host-side raster helpers of the data path, without OpenCV.

The JAX package draws its box labels with ``cv2.fillPoly``, resizes depth
maps with ``cv2.resize(INTER_LINEAR)`` and reads camera frames with PIL
(streamingflow_tpu/data/nuscenes.py:31-38, :176-181).  The port imports no
cv2, so this module does the three itself:

- :func:`fill_poly`: OpenCV's polygon fill (8-connected outline, then the
  edge-table scan fill in 16.16 fixed point), pixel for pixel;
- :func:`resize_linear`: OpenCV's INTER_LINEAR resize of a float32 map
  (half-pixel centres, edge clamp, the horizontal pass then the vertical,
  in float32);
- :func:`read_image` / :func:`resize_image`: frames decoded by PIL where it
  is installed, binary PPM (P6) by a small numpy reader otherwise, and
  resized by ``torch.nn.functional.interpolate(mode='bilinear',
  antialias=True)`` on uint8, PIL's triangle filter.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


# ------------------------------------------------------------- polygon fill
def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's clipLine on the image rectangle: (inside, x1, y1, x2, y2),
    the end points as clipLine leaves them (moved even when the segment
    turns out to lie outside)."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line(img: np.ndarray, x1: int, y1: int, x2: int, y2: int,
          value) -> None:
    """OpenCV's 8-connected line (LineIterator, left to right)."""
    h, w = img.shape[:2]
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:                                  # walk left to right
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    # major step (minus) and the extra minor step (plus) of Bresenham
    major, minor = (0, sy), (sx, 0)
    if dy > dx:
        dx, dy = dy, dx
    else:
        major, minor = (sx, 0), (0, sy)
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = value
        if err < 0:
            err += 2 * dx - 2 * dy
            x += major[0] + minor[0]
            y += major[1] + minor[1]
        else:
            err -= 2 * dy
            x += major[0]
            y += major[1]


def _trunc_div(a: int, b: int) -> int:
    """C integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def fill_poly(img: np.ndarray, pts: np.ndarray, value) -> None:
    """``cv2.fillPoly(img, [pts], value)`` in place for one polygon of
    integer (x, y) vertices ``pts`` (N, 2): its 8-connected outline, then
    the scan fill between the edges (OpenCV's CollectPolyEdges and
    FillEdgeCollection, 16.16 fixed point, shift 0)."""
    h, w = img.shape[:2]
    v = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    edges = []                                  # (y0, y1, x at y0, dx)
    x0, y0 = v[-1]
    for x1, y1 in v:
        t0x, t0y, t1x, t1y = x0, y0, x1, y1
        _line(img, t0x, t0y, t1x, t1y, value)
        p0x, p0y, p1x, p1y = x0 << XY_SHIFT, y0, x1 << XY_SHIFT, y1
        if not (0 <= t0x < w and 0 <= t1x < w and 0 <= t0y < h
                and 0 <= t1y < h):
            # clipped endpoints give the edge
            _, c0x, c0y, c1x, c1y = _clip_line(w, h, t0x, t0y, t1x, t1y)
            p0x, p1x = c0x << XY_SHIFT, c1x << XY_SHIFT
            if c0y != c1y:
                p0y, p1y = c0y, c1y
        if y0 != y1:
            dx = _trunc_div(p1x - p0x, p1y - p0y)
            if y0 < y1:
                edges.append((y0, y1, p0x + (y0 - p0y) * dx, dx))
            else:
                edges.append((y1, y0, p1x + (y1 - p1y) * dx, dx))
        x0, y0 = x1, y1
    if len(edges) < 2:
        return
    ends = [x for y0, y1, x, dx in edges for x in (x, x + (y1 - y0) * dx)]
    if max(ends) < 0 or min(ends) >= w << XY_SHIFT:
        return
    y_lo = max(min(e[0] for e in edges), 0)
    y_hi = min(max(e[1] for e in edges), h)
    for y in range(y_lo, y_hi):
        xs = sorted(e[2] + (y - e[0]) * e[3] for e in edges
                    if e[0] <= y < e[1])
        for a, b in zip(xs[::2], xs[1::2]):
            xa, xb = (a + XY_ONE - 1) >> XY_SHIFT, b >> XY_SHIFT
            if xa < w and xb >= 0:
                img[y, max(xa, 0):min(xb, w - 1) + 1] = value


# ------------------------------------------------------------- depth resize
def _linear_taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's INTER_LINEAR source index and weight of each output pixel:
    centre (d + 0.5) * scale - 0.5, clamped at the borders."""
    scale = 1.0 / (n_out / n_in)
    f = (np.arange(n_out) + 0.5) * scale - 0.5          # float64
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    low = s < 0
    s[low], f[low] = 0, 0.0
    high = s >= n_in - 1
    s[high], f[high] = n_in - 1, 0.0
    s1 = np.minimum(s + 1, n_in - 1)
    return np.stack([s, s1]), np.stack([1.0 - f, f])


def resize_linear(img: np.ndarray, out_wh) -> np.ndarray:
    """``cv2.resize(img, out_wh, interpolation=cv2.INTER_LINEAR)`` of a 2-D
    float32 map: the horizontal pass, then the vertical, in float32."""
    img = np.asarray(img, np.float32)
    w_out, h_out = int(out_wh[0]), int(out_wh[1])
    h_in, w_in = img.shape
    (xs0, xs1), (xa0, xa1) = _linear_taps(w_in, w_out)
    (ys0, ys1), (ya0, ya1) = _linear_taps(h_in, h_out)
    rows = np.unique(np.concatenate([ys0, ys1]))
    horiz = np.zeros((h_in, w_out), np.float32)
    horiz[rows] = img[rows][:, xs0] * xa0 + img[rows][:, xs1] * xa1
    return horiz[ys0] * ya0[:, None] + horiz[ys1] * ya1[:, None]


# -------------------------------------------------------------- camera frames
def _have_pil() -> bool:
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return False
    return True


def image_decoder() -> str:
    """'PIL' where PIL is installed, else 'ppm' (binary PPM frames only)."""
    return 'PIL' if _have_pil() else 'ppm'


def read_ppm(path: str) -> np.ndarray:
    """A binary PPM (P6, maxval 255) frame as (H, W, 3) uint8."""
    with open(path, 'rb') as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b'#':           # comment to end of line
            pos = data.index(b'\n', pos) + 1
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    if fields[0] != b'P6' or int(fields[3]) != 255:
        raise ValueError(f'{path}: not a binary 8-bit PPM (P6) frame')
    w, h = int(fields[1]), int(fields[2])
    pos += 1                                     # the one whitespace byte
    return np.frombuffer(data, np.uint8, w * h * 3, pos).reshape(
        h, w, 3).copy()


def write_ppm(path: str, rgb: np.ndarray) -> None:
    """Write (H, W, 3) uint8 as a binary PPM (P6) frame."""
    h, w = rgb.shape[:2]
    with open(path, 'wb') as f:
        f.write(f'P6\n{w} {h}\n255\n'.encode('ascii'))
        f.write(np.ascontiguousarray(rgb, np.uint8).tobytes())


def read_image(path: str) -> np.ndarray:
    """A camera frame as (H, W, 3) uint8 RGB: PIL where installed (any
    format it reads, PPM included), else binary PPM only."""
    if _have_pil():
        from PIL import Image
        with Image.open(path) as img:
            return np.array(img.convert('RGB'))
    with open(path, 'rb') as f:
        magic = f.read(2)
    if magic != b'P6':
        kind = os.path.splitext(path)[1] or repr(magic)
        raise RuntimeError(
            f'{path}: a {kind} frame needs PIL, which is not installed; '
            f'only binary PPM (P6) frames are read without it')
    return read_ppm(path)


def resize_image(rgb: np.ndarray, out_wh) -> np.ndarray:
    """(H, W, 3) uint8 resized to (w, h) = ``out_wh`` with the antialiased
    bilinear (triangle) filter of PIL's ``resize(BILINEAR)``."""
    x = torch.from_numpy(np.ascontiguousarray(rgb)).permute(2, 0, 1)[None]
    x = x.contiguous(memory_format=torch.channels_last)
    y = torch.nn.functional.interpolate(
        x, size=(int(out_wh[1]), int(out_wh[0])), mode='bilinear',
        align_corners=False, antialias=True)
    return y[0].permute(1, 2, 0).contiguous().numpy()


def crop_image(rgb: np.ndarray, box) -> np.ndarray:
    """PIL's ``crop((left, top, right, bottom))``: zeros outside the
    image."""
    left, top, right, bottom = (int(b) for b in box)
    h, w = rgb.shape[:2]
    out = np.zeros((bottom - top, right - left) + rgb.shape[2:], rgb.dtype)
    y0, y1 = max(top, 0), min(bottom, h)
    x0, x1 = max(left, 0), min(right, w)
    if y1 > y0 and x1 > x0:
        out[y0 - top:y1 - top, x0 - left:x1 - left] = rgb[y0:y1, x0:x1]
    return out
