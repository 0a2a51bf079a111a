"""Lyft Level-5 dataset variant (port of streamingflow_tpu/data/lyft.py).

Reference: streamingflow/datas/LyftData.py (FuturePredictionDatasetLyft:134).
Lyft L5 ships in the nuScenes table schema, so this subclasses the nuScenes
reader (data/nuscenes.py) and overrides what differs (reference §2d):

* scene split: Lyft has no canonical split — the reference hard-codes one;
  here a deterministic hash split (80/20 by scene name) with the same
  train/val semantics.
* categories are flat names ('car', 'truck', ...) instead of the nuScenes
  'vehicle.*' / 'human.*' hierarchy.
* no CAN bus: candidate-trajectory sampling returns zeros and the command
  defaults to FORWARD; gt trajectory still derives from ego poses.
* no HD map rasters (reference LyftData has no hdmap path).
* image geometry: Lyft cameras are 1224x1024 (cfg.IMAGE.ORIGINAL_* should
  be set accordingly in the Lyft config).
"""
from __future__ import annotations

import hashlib

import numpy as np

from . import raster
from .nuscenes import FuturePredictionDataset

VEHICLE_CATEGORIES = {'car', 'truck', 'bus', 'emergency_vehicle',
                      'other_vehicle', 'trailer'}
HUMAN_CATEGORIES = {'pedestrian'}


def _scene_bucket(name: str) -> float:
    h = hashlib.sha1(name.encode()).hexdigest()
    return int(h[:8], 16) / 0xFFFFFFFF


class FuturePredictionDatasetLyft(FuturePredictionDataset):
    """Lyft L5 windows with the same batch-dict contract as nuScenes."""

    def __init__(self, nusc, is_train: int, cfg):
        self._split_fraction = 0.8
        super().__init__(nusc, is_train, cfg)

    # ------------------------------------------------------------- overrides
    def _get_scenes(self):
        names = sorted(s['name'] for s in self.nusc.scene)
        if self.is_train == 0:
            return [n for n in names
                    if _scene_bucket(n) < self._split_fraction]
        return [n for n in names if _scene_bucket(n) >= self._split_fraction]

    def _category_kind(self, category_name: str):
        if category_name in VEHICLE_CATEGORIES:
            return 'vehicle'
        if category_name in HUMAN_CATEGORIES:
            return 'human'
        # tolerate nuScenes-style dotted names in mixed exports
        if 'vehicle' in category_name:
            return 'vehicle'
        if 'human' in category_name or 'pedestrian' in category_name:
            return 'human'
        return None

    def get_label(self, rec, instance_map, in_pred):
        """Same rasterisation as nuScenes, Lyft category names
        (reference LyftData.py label path; visibility tokens are absent)."""
        translation, rotation = self._get_top_lidar_pose(rec)
        nx, ny = int(self.bev_dimension[0]), int(self.bev_dimension[1])
        segmentation = np.zeros((nx, ny))
        pedestrian = np.zeros((nx, ny))
        instance = np.zeros((nx, ny))

        for ann_token in rec['anns']:
            ann = self.nusc.get('sample_annotation', ann_token)
            if in_pred and ann['instance_token'] not in instance_map:
                continue
            kind = self._category_kind(ann['category_name'])
            if kind == 'vehicle':
                if ann['instance_token'] not in instance_map:
                    instance_map[ann['instance_token']] = len(instance_map) + 1
                iid = instance_map[ann['instance_token']]
                poly = self._poly_region(ann, translation, rotation)
                raster.fill_poly(instance, poly, iid)
                raster.fill_poly(segmentation, poly, 1.0)
            elif kind == 'human':
                if ann['instance_token'] not in instance_map:
                    instance_map[ann['instance_token']] = len(instance_map) + 1
                poly = self._poly_region(ann, translation, rotation)
                raster.fill_poly(pedestrian, poly, 1.0)
        return (segmentation.astype(np.int64), instance.astype(np.int64),
                pedestrian.astype(np.int64), instance_map)

    def get_trajectory_sampling(self, rec, rng=None) -> np.ndarray:
        """Lyft has no CAN bus (reference LyftData omits planning inputs)."""
        return np.zeros((self.cfg.PLANNING.SAMPLE_NUM,
                         self.cfg.N_FUTURE_FRAMES + 1, 3), np.float32)
