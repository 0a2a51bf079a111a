"""Native (C++) host-side point-cloud engine with numpy fallbacks.

A copy of the JAX package's host engine (streamingflow_tpu/native), kept in
the port so that it imports nothing of that package.  It serves the data
pipeline, not the device: GIL-free loops for multisweep rigid transforms,
close-range filtering, first-come voxel binning, fixed-capacity padding and
the loader's tile sort.  The library is compiled on first use with g++ (no
pybind11: a plain C ABI through ctypes) into ``streamingflow_tpu_torch/
_build/`` under a name of its own, ``libsf_torch_native_<hash>.so``; every
entry point has a numpy fallback so the package works without a toolchain.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'src',
                    'pointcloud_engine.cc')
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _cache_dir() -> str:
    d = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), '_build')
    os.makedirs(d, exist_ok=True)
    return d


def _build() -> Optional[str]:
    with open(_SRC, 'rb') as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_cache_dir(), f'libsf_torch_native_{tag}.so')
    if os.path.exists(out):
        return out
    # a name of this process's own: loader workers may build at once
    tmp = f'{out}.{os.getpid()}.tmp'
    cmd = ['g++', '-O3', '-std=c++17', '-shared', '-fPIC', _SRC, '-o', tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (subprocess.SubprocessError, OSError):
        return None


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    i32, i64, f32p = ctypes.c_int32, ctypes.c_int64, \
        np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
    f64p = np.ctypeslib.ndpointer(np.float64, flags='C_CONTIGUOUS')
    i32p = np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')
    lib.sf_transform_points.argtypes = [f32p, i64, i32, f64p]
    lib.sf_transform_points.restype = None
    lib.sf_range_filter.argtypes = [f32p, i64, i32, ctypes.c_float]
    lib.sf_range_filter.restype = i64
    lib.sf_sweep_transform.argtypes = [f32p, i64, i32, f64p, ctypes.c_float,
                                       f32p, i32, i32, ctypes.c_float]
    lib.sf_sweep_transform.restype = i64
    lib.sf_hard_voxelize.argtypes = [f32p, i64, i32, f32p, f32p, i32, i64,
                                     f32p, i32p, i32p]
    lib.sf_hard_voxelize.restype = i64
    lib.sf_dynamic_scatter.argtypes = [f32p, i64, i32, f32p, f32p, i32, i64,
                                       f32p, i32p, i32p]
    lib.sf_dynamic_scatter.restype = i64
    lib.sf_group_pad.argtypes = [f32p, i64, i32, i32p, i32, i64, f32p, i32p]
    lib.sf_group_pad.restype = None
    lib.sf_tile_sort_points.argtypes = [f32p, i64, i32, f32p, f32p, i64]
    lib.sf_tile_sort_points.restype = None
    _LIB = lib
    return _LIB


def available() -> bool:
    """True when the compiled engine is loadable."""
    return _lib() is not None


# ------------------------------------------------------------------ wrappers
def transform_points(points: np.ndarray, tm: np.ndarray) -> np.ndarray:
    """Rigid-transform xyz columns of (N, C>=3) float32 points (in place when
    native; returns the array either way)."""
    lib = _lib()
    pts = np.ascontiguousarray(points, np.float32)
    m = np.ascontiguousarray(tm, np.float64)
    if lib is not None and pts.shape[0] > 0:
        lib.sf_transform_points(pts, pts.shape[0], pts.shape[1], m)
        return pts
    xyz1 = np.concatenate([pts[:, :3],
                           np.ones((len(pts), 1), np.float32)], axis=1)
    pts[:, :3] = (xyz1 @ m.T.astype(np.float32))[:, :3]
    return pts


def sweep_transform(points: np.ndarray, tm: np.ndarray, min_dist: float,
                    time_lag: float, out_channels: int = 0,
                    time_col: int = -1) -> np.ndarray:
    """Fused close-range filter + rigid transform + time-lag stamp for one
    sweep (reference utils/data_classes.py:560-590).

    points: (N, C) float32 in the sweep sensor frame.  Returns (M, C') with
    C' = max(C, out_channels); column ``time_col`` (if >= 0) = time_lag."""
    pts = np.ascontiguousarray(points, np.float32)
    n, c = pts.shape
    c_out = max(c, out_channels)
    lib = _lib()
    if lib is not None:
        # zeros: the kernel only writes columns [0, C) + time_col, so any
        # extra out_channels columns must be pre-cleared
        dst = np.zeros((n, c_out), np.float32)
        m = np.ascontiguousarray(tm, np.float64)
        w = lib.sf_sweep_transform(pts, n, c, m, np.float32(min_dist), dst,
                                   c_out, time_col, np.float32(time_lag))
        return dst[:w]
    keep = np.linalg.norm(pts[:, :2], axis=1) >= min_dist
    kept = pts[keep]
    out = np.zeros((len(kept), c_out), np.float32)
    out[:, 3:c] = kept[:, 3:]
    xyz1 = np.concatenate([kept[:, :3],
                           np.ones((len(kept), 1), np.float32)], axis=1)
    out[:, :3] = (xyz1 @ np.asarray(tm, np.float64).T)[:, :3]
    if time_col >= 0:
        out[:, time_col] = time_lag
    return out


def hard_voxelize(points: np.ndarray, point_cloud_range, voxel_size,
                  max_points: int, max_voxels: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """First-come hard voxelization (reference voxelization_cpu.cpp
    semantics).  Returns (voxels (V, max_points, C), coords (V, 3) xyz,
    num_points (V,)) trimmed to the V produced voxels."""
    pts = np.ascontiguousarray(points, np.float32)
    n, c = pts.shape
    rng = np.ascontiguousarray(point_cloud_range, np.float32)
    vsz = np.ascontiguousarray(voxel_size, np.float32)
    lib = _lib()
    if lib is not None:
        voxels = np.zeros((max_voxels, max_points, c), np.float32)
        coords = np.zeros((max_voxels, 3), np.int32)
        counts = np.zeros((max_voxels,), np.int32)
        nv = lib.sf_hard_voxelize(pts, n, c, rng, vsz, max_points,
                                  max_voxels, voxels, coords, counts)
        return voxels[:nv], coords[:nv], counts[:nv]
    # numpy fallback (same first-come semantics, python dict)
    nx = int(round((rng[3] - rng[0]) / vsz[0]))
    ny = int(round((rng[4] - rng[1]) / vsz[1]))
    nz = int(round((rng[5] - rng[2]) / vsz[2]))
    voxels, coords, counts, voxel_of = [], [], [], {}
    cs = np.floor((pts[:, :3] - rng[None, :3]) / vsz[None, :]).astype(np.int64)
    ok = ((cs >= 0).all(1) & (cs[:, 0] < nx) & (cs[:, 1] < ny)
          & (cs[:, 2] < nz))
    for i in np.nonzero(ok)[0]:
        key = tuple(cs[i])
        v = voxel_of.get(key)
        if v is None:
            if len(voxels) >= max_voxels:
                continue
            v = len(voxels)
            voxel_of[key] = v
            voxels.append(np.zeros((max_points, c), np.float32))
            coords.append(np.asarray(key, np.int32))
            counts.append(0)
        if counts[v] < max_points:
            voxels[v][counts[v]] = pts[i]
            counts[v] += 1
    if not voxels:
        return (np.zeros((0, max_points, c), np.float32),
                np.zeros((0, 3), np.int32), np.zeros((0,), np.int32))
    return (np.stack(voxels), np.stack(coords),
            np.asarray(counts, np.int32))


def dynamic_scatter(points: np.ndarray, point_cloud_range, voxel_size,
                    mode: str = 'mean', max_voxels: int = 200000
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Uncapped per-voxel mean/max reduce (reference DynamicScatter,
    mmdet3d/ops/voxel/scatter_points.py:8-98).  Returns (reduced (V, C),
    coords (V, 3), counts (V,))."""
    pts = np.ascontiguousarray(points, np.float32)
    n, c = pts.shape
    rng = np.ascontiguousarray(point_cloud_range, np.float32)
    vsz = np.ascontiguousarray(voxel_size, np.float32)
    mode_i = {'mean': 0, 'max': 1}[mode]
    lib = _lib()
    if lib is not None:
        reduced = np.zeros((max_voxels, c), np.float32)
        coords = np.zeros((max_voxels, 3), np.int32)
        counts = np.zeros((max_voxels,), np.int32)
        nv = lib.sf_dynamic_scatter(pts, n, c, rng, vsz, mode_i, max_voxels,
                                    reduced, coords, counts)
        return reduced[:nv], coords[:nv], counts[:nv]
    vox, coords, counts = hard_voxelize(pts, rng, vsz,
                                        max_points=max(n, 1),
                                        max_voxels=max_voxels)
    if len(vox) == 0:
        return (np.zeros((0, c), np.float32), coords, counts)
    if mode == 'mean':
        red = vox.sum(1) / np.maximum(counts[:, None], 1)
    else:
        big = np.where(np.arange(vox.shape[1])[None, :, None]
                       < counts[:, None, None], vox, -np.inf)
        red = big.max(1)
    return red.astype(np.float32), coords, counts


def tile_sort_points(points: np.ndarray, n_valid: int, point_cloud_range,
                     voxel_size, bins_per_tile: int) -> np.ndarray:
    """Group the first ``n_valid`` rows of (N, C>=3) float32 points by BEV
    bin tile in place (stable counting sort; within-tile order free).

    This is the loader half of the tile-sorted point contract consumed by
    the binning kernel (ops/bin_sum.py): the kernel can then skip its
    device-side sort.  Out-of-range points land in the last bucket (the
    device trash bin's tile).  Returns the array."""
    pts = np.ascontiguousarray(points, np.float32)
    n_valid = int(min(n_valid, pts.shape[0]))
    if n_valid <= 0:
        return pts
    rng = np.ascontiguousarray(point_cloud_range, np.float32)
    vsz = np.ascontiguousarray(voxel_size, np.float32)
    lib = _lib()
    if lib is not None:
        lib.sf_tile_sort_points(pts, n_valid, pts.shape[1], rng, vsz,
                                bins_per_tile)
        return pts
    head = pts[:n_valid]
    nx = int(round((rng[3] - rng[0]) / vsz[0]))
    ny = int(round((rng[4] - rng[1]) / vsz[1]))
    cx = np.floor((head[:, 0] - rng[0]) / vsz[0]).astype(np.int64)
    cy = np.floor((head[:, 1] - rng[1]) / vsz[1]).astype(np.int64)
    ok = ((cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
          & (head[:, 2] >= rng[2]) & (head[:, 2] < rng[5])
          & np.isfinite(head[:, :3]).all(axis=1))
    n_tiles = (nx * ny + 1 + bins_per_tile - 1) // bins_per_tile
    tile = np.where(ok, (cx * ny + cy) // bins_per_tile, n_tiles - 1)
    pts[:n_valid] = head[np.argsort(tile, kind='stable')]
    return pts


def group_pad(points: np.ndarray, group_of: np.ndarray, n_groups: int,
              cap: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pack points into (n_groups, cap, C) zero-padded groups
    (reference NuscenesData.py:869-873).  Returns (padded, lengths)."""
    pts = np.ascontiguousarray(points, np.float32)
    grp = np.ascontiguousarray(group_of, np.int32)
    lib = _lib()
    if lib is not None:
        dst = np.empty((n_groups, cap, pts.shape[1]), np.float32)
        lens = np.empty((n_groups,), np.int32)
        lib.sf_group_pad(pts, pts.shape[0], pts.shape[1], grp, n_groups, cap,
                         dst, lens)
        return dst, lens
    dst = np.zeros((n_groups, cap, pts.shape[1]), np.float32)
    lens = np.zeros((n_groups,), np.int32)
    for i in range(len(pts)):
        g = grp[i]
        if 0 <= g < n_groups and lens[g] < cap:
            dst[g, lens[g]] = pts[i]
            lens[g] += 1
    return dst, lens
