"""Synthetic batch generator shaped exactly like the nuScenes pipeline output.

A copy of streamingflow_tpu/data/synthetic.py: the same seed gives the same
arrays (images, intrinsics, extrinsics, labels, padded point clouds,
relative timestamps), channels last, as numpy.  Point clouds are grouped by
2048-bin BEV tile (``tile_sort_points``), the order the pillar bin-sum
kernel takes with ``presorted=True``.  ``tiny_config`` shrinks every axis
for CPU-runnable tests.
"""
from __future__ import annotations

import numpy as np

from ..config import Config

# bins of one tile of the pillar bin-sum (ops/bin_sum.py)
BINS_PER_TILE = 2048


def tile_sort_points(points: np.ndarray, n_valid: int, point_cloud_range,
                     voxel_size, bins_per_tile: int) -> np.ndarray:
    """Group the first ``n_valid`` rows of (N, C>=3) float32 points by BEV
    bin tile (stable sort by tile; out-of-range points land in the last
    tile, the trash bin's).  Returns the array, sorted in place."""
    pts = np.ascontiguousarray(points, np.float32)
    n_valid = int(min(n_valid, pts.shape[0]))
    if n_valid <= 0:
        return pts
    rng = np.asarray(point_cloud_range, np.float32)
    vsz = np.asarray(voxel_size, np.float32)
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


def tiny_config() -> Config:
    """A miniature but structurally faithful model config (CPU-testable)."""
    cfg = Config()
    cfg.BATCHSIZE = 1
    cfg.TIME_RECEPTIVE_FIELD = 2
    cfg.N_FUTURE_FRAMES = 2
    cfg.IMAGE.FINAL_DIM = (32, 64)
    cfg.IMAGE.NAMES = ['CAM_FRONT', 'CAM_BACK']
    cfg.LIFT.X_BOUND = [-8.0, 8.0, 0.5]
    cfg.LIFT.Y_BOUND = [-8.0, 8.0, 0.5]
    cfg.LIFT.Z_BOUND = [-10.0, 10.0, 20.0]
    cfg.LIFT.D_BOUND = [2.0, 10.0, 1.0]
    cfg.MODEL.ENCODER.NAME = 'efficientnet-b0'
    cfg.MODEL.ENCODER.OUT_CHANNELS = 16
    cfg.MODEL.TEMPORAL_MODEL.START_OUT_CHANNELS = 16
    cfg.MODEL.DISTRIBUTION.LATENT_DIM = 16
    cfg.MODEL.SMALL_ENCODER.FILTER_SIZE = 8
    cfg.MODEL.MODALITY.USE_CAMERA = True
    cfg.MODEL.MODALITY.USE_LIDAR = False
    cfg.MODEL.FUTURE_PRED.USE_VARIABLE_ODE_STEP = True
    cfg.MODEL.IMPUTE = True
    cfg.SEMANTIC_SEG.PEDESTRIAN.ENABLED = False
    cfg.SEMANTIC_SEG.HDMAP.ENABLED = False
    cfg.PLANNING.ENABLED = False
    # LiDAR (only used when USE_LIDAR toggled on)
    se = cfg.MODEL.SPARSE_ENCODER
    se.POINT_CLOUD_RANGE = [-8.0, -8.0, -4.0, 8.0, 8.0, 3.68]
    se.VOXEL_SIZE = [0.0625, 0.0625, 0.32]
    se.SPARSE_SHAPE = (256, 256, 25)
    se.MAX_VOXELS = 2048
    # stride-2 site generation dilates the active set, so later stages
    # need MORE slots than their inputs (see SparseEncoderConfig)
    se.STAGE_CAPS = [2048, 3072, 2560, 1280]
    se.TILE_CAPS = [1024, 512, 256, 128]
    se.MAX_NUM_POINTS = 10
    return cfg


def flagship_config() -> Config:
    """The flagship forecast of bench.py::full_cfg (its defaults): camera
    (6 x 224x480, EfficientNet-B4) + LiDAR (pillar8x, 1600^2 pillars),
    'pallas_patch' camera pool, 200x200 BEV, variable-step GRU-ODE,
    3 past frames -> 4 futures, LiDAR branch in bf16."""
    cfg = Config()
    cfg.TIME_RECEPTIVE_FIELD = 3
    cfg.N_FUTURE_FRAMES = 4
    cfg.MODEL.MODALITY.USE_CAMERA = True
    cfg.MODEL.MODALITY.USE_LIDAR = True
    cfg.MODEL.FUTURE_PRED.USE_VARIABLE_ODE_STEP = True
    cfg.MODEL.IMPUTE = True
    cfg.MODEL.BEV_POOL_BACKEND = 'pallas_patch'
    cfg.SEMANTIC_SEG.PEDESTRIAN.ENABLED = False
    cfg.SEMANTIC_SEG.HDMAP.ENABLED = False
    cfg.PLANNING.ENABLED = False
    cfg.MODEL.SPARSE_ENCODER.COMPUTE_DTYPE = 'bfloat16'
    return cfg


def _lidar_like_clouds(rng, lead_shape, n_points, pc_range):
    """Synthetic clouds with real-LiDAR spatial statistics.

    Uniform random points are the *worst case* for sparse-voxel
    occupancy (every point its own voxel/tile) and nothing like a
    spinning LiDAR, whose returns cluster on the ground plane and on
    object surfaces with ~1/r radial density.  Benches and capacity
    defaults (MAX_VOXELS, TILE_CAPS) should see realistic occupancy, so
    this generator emits: 70% ground-plane returns with p(r) ∝ 1/r,
    25% points on ~40 vertical object surfaces, 5% uniform clutter
    (roughly matching nuScenes multisweep cloud statistics).
    """
    xlo, ylo, zlo, xhi, yhi, zhi = (pc_range[0], pc_range[1], pc_range[2],
                                    pc_range[3], pc_range[4], pc_range[5])
    r_max = min(xhi, yhi)
    out = np.empty(lead_shape + (n_points, 5), np.float32)
    flat = out.reshape(-1, n_points, 5)
    for ci in range(flat.shape[0]):
        n_g = int(n_points * 0.70)
        n_o = int(n_points * 0.25)
        n_u = n_points - n_g - n_o
        # ground: log-uniform radius (1/r density), uniform azimuth
        r = np.exp(rng.uniform(np.log(1.5), np.log(r_max), n_g))
        th = rng.uniform(0, 2 * np.pi, n_g)
        ground = np.stack([r * np.cos(th), r * np.sin(th),
                           zlo + 0.12 * (zhi - zlo)
                           + 0.02 * r * rng.randn(n_g)], -1)
        # objects: vertical surfaces at clustered (x, y)
        n_obj = 40
        cx = np.exp(rng.uniform(np.log(3.0), np.log(r_max), n_obj))
        cth = rng.uniform(0, 2 * np.pi, n_obj)
        centers = np.stack([cx * np.cos(cth), cx * np.sin(cth)], -1)
        which = rng.randint(0, n_obj, n_o)
        obj = np.concatenate([
            centers[which] + 0.25 * rng.randn(n_o, 2),
            (zlo + (zhi - zlo) * (0.1 + 0.25 * np.abs(rng.randn(n_o))))
            [:, None]], -1)
        unif = np.stack([rng.uniform(xlo, xhi, n_u),
                         rng.uniform(ylo, yhi, n_u),
                         rng.uniform(zlo, zhi, n_u)], -1)
        xyz = np.concatenate([ground, obj, unif]).astype(np.float32)
        flat[ci, :, :3] = xyz
        flat[ci, :, 3] = rng.rand(n_points)          # intensity
        flat[ci, :, 4] = rng.rand(n_points) * 0.05   # sweep dt
    return out


def n_lidar_sweeps(cfg: Config) -> int:
    """Number of grouped LiDAR observations over the past second.

    Reference NuscenesData.py:683-737: 20 sweeps grouped per FRAME_SKIP."""
    return max(1, 20 // cfg.DATASET.FRAME_SKIP)


def make_batch(cfg: Config, batch_size: int = 1, seed: int = 0,
               n_points: int = 2048):
    """Random batch dict with reference-shaped arrays (channels-last)."""
    rng = np.random.RandomState(seed)
    B = batch_size
    S = cfg.TIME_RECEPTIVE_FIELD
    F = cfg.N_FUTURE_FRAMES
    T = S + F
    N = len(cfg.IMAGE.NAMES)
    H, W = cfg.IMAGE.FINAL_DIM
    Xb, Yb = (int((cfg.LIFT.X_BOUND[1] - cfg.LIFT.X_BOUND[0]) / cfg.LIFT.X_BOUND[2]),
              int((cfg.LIFT.Y_BOUND[1] - cfg.LIFT.Y_BOUND[0]) / cfg.LIFT.Y_BOUND[2]))

    image = rng.rand(B, T, N, H, W, 3).astype(np.float32)

    intrinsics = np.zeros((B, T, N, 3, 3), np.float32)
    intrinsics[..., 0, 0] = W * 0.9
    intrinsics[..., 1, 1] = W * 0.9
    intrinsics[..., 0, 2] = W / 2
    intrinsics[..., 1, 2] = H / 2
    intrinsics[..., 2, 2] = 1.0

    extrinsics = np.tile(np.eye(4, dtype=np.float32), (B, T, N, 1, 1))
    for ni in range(N):
        yaw = 2 * np.pi * ni / N
        R = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                      [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]], np.float32)
        # camera->ego: x right, y down, z forward mapped into ego axes
        perm = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
        extrinsics[:, :, ni, :3, :3] = (R @ perm)[None, None]
        extrinsics[:, :, ni, :3, 3] = (R @ np.array([1.0, 0, 1.5], np.float32))

    future_egomotion = np.zeros((B, T, 6), np.float32)
    future_egomotion[..., 0] = 0.5 * rng.rand(B, T)
    future_egomotion[..., 5] = 0.02 * rng.randn(B, T)

    # relative timestamps (seconds, relative to present keyframe;
    # reference NuscenesData.py:898-905)
    camera_timestamp = np.tile(
        np.linspace(-0.5 * (S - 1), 0.0, S, dtype=np.float32), (B, 1))
    n_lidar = n_lidar_sweeps(cfg)
    lidar_timestamp = np.tile(
        np.linspace(-1.0 + 1.0 / n_lidar, 0.0, n_lidar, dtype=np.float32),
        (B, 1))
    target_timestamp = np.tile(np.concatenate([
        np.linspace(-0.5 * (S - 1), 0.0, S, dtype=np.float32),
        np.arange(1, F + 1, dtype=np.float32) * 0.5]), (B, 1))

    pc_range = cfg.MODEL.SPARSE_ENCODER.POINT_CLOUD_RANGE
    pts = _lidar_like_clouds(rng, (B, n_lidar), n_points, pc_range)
    if cfg.MODEL.LIDAR.TILE_SORTED_POINTS:
        # honour the loader contract (MODEL.LIDAR.TILE_SORTED_POINTS): point
        # groups arrive bucket-grouped by BEV bin tile
        for b in range(B):
            for t in range(n_lidar):
                pts[b, t] = tile_sort_points(
                    pts[b, t], n_points, pc_range,
                    cfg.MODEL.SPARSE_ENCODER.VOXEL_SIZE, BINS_PER_TILE)
    points = pts

    seg = (rng.rand(B, T, Xb, Yb, 1) > 0.95).astype(np.int64)
    inst = np.where(seg[..., 0] > 0,
                    rng.randint(1, 5, size=(B, T, Xb, Yb)), 0).astype(np.int64)
    batch = {
        'image': image,
        'intrinsics': intrinsics,
        'extrinsics': extrinsics,
        'future_egomotion': future_egomotion,
        'camera_timestamp': camera_timestamp,
        'lidar_timestamp': lidar_timestamp,
        'target_timestamp': target_timestamp,
        'points': points,
        'segmentation': seg,
        'instance': inst,
        'centerness': rng.rand(B, T, Xb, Yb, 1).astype(np.float32),
        'offset': rng.randn(B, T, Xb, Yb, 2).astype(np.float32),
        'flow': rng.randn(B, T, Xb, Yb, 2).astype(np.float32),
        'pedestrian': (rng.rand(B, T, Xb, Yb, 1) > 0.98).astype(np.int64),
        'hdmap': (rng.rand(B, 2, Xb, Yb) > 0.5).astype(np.int64),
        'depths': (rng.rand(B, T, N, H, W).astype(np.float32)
                   * (cfg.LIFT.D_BOUND[1] - cfg.LIFT.D_BOUND[0])
                   + cfg.LIFT.D_BOUND[0]),
        'gt_trajectory': rng.randn(B, F + 1, 3).astype(np.float32),
        'command': rng.randint(0, 3, size=(B,)).astype(np.int64),
        'sample_trajectory': rng.randn(B, cfg.PLANNING.SAMPLE_NUM, F + 1, 3
                                       ).astype(np.float32),
        'target_point': rng.randn(B, 2).astype(np.float32),
    }
    return batch
