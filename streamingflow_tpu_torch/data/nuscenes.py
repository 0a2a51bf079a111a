"""nuScenes streaming future-prediction dataset.

Port of streamingflow_tpu/data/nuscenes.py: the same items, key for key,
from the same on-disk tree.  It runs on the host (numpy, and torch on the
CPU for the pose algebra), imports no cv2 (polygons, the depth resize and
the frames go through data/raster.py) and reads frames with PIL where it is
installed, binary PPM without it.  Nothing is drawn at random per item but
``sample_trajectory``, the candidate trajectories of the planning inputs,
and that only where the tree has a CAN bus.  They are drawn from a
``np.random.RandomState`` seeded from the dataset's ``seed`` (the loader's,
data/dataloader.py) and the item's index, so an item gives the same
candidates in the main thread and in any loader worker.  This departs from
the JAX dataset, which draws them from numpy's global state (reseeded in
every worker by PyTorch's loader, where they would depend on the worker
that loaded the item).  Every other key of an item is the JAX dataset's.

Channels-last re-implementation of reference
streamingflow/datas/NuscenesData.py (FuturePredictionDataset:47,
__getitem__:739-907) on top of the self-contained SDK in nuscenes_sdk.py:
contiguous (past + future) keyframe windows, resized/cropped/normalised
multi-camera images with updated intrinsics, BEV box rasterisation,
center/offset/flow labels, per-FRAME_SKIP grouped multisweep LiDAR streams
padded to a fixed point count, and relative timestamps for the GRU-ODE.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from .. import geometry as G
from .. import native
from ..config import Config
from ..ops.bin_sum import BINS_PER_TILE
from . import raster
from .labels import convert_instance_mask_to_center_and_offset_label
from .nuscenes_sdk import (Box, NuScenes, NuScenesCanBus, Quaternion,
                           create_splits_scenes, instance_boxes_over_sweeps,
                           locate_message, multisweep_lidar, transform_matrix)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
MAX_LIDAR_POINTS = 350000


def convert_egopose_to_matrix(egopose: dict) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = Quaternion(egopose['rotation']).rotation_matrix
    m[:3, 3] = np.asarray(egopose['translation'])
    return m


def invert_rigid(m: np.ndarray) -> np.ndarray:
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = m[:3, :3].T
    out[:3, 3] = -m[:3, :3].T @ m[:3, 3]
    return out


def get_global_pose(rec: dict, nusc: NuScenes, inverse: bool = False
                    ) -> np.ndarray:
    """lidar-sensor <-> global transform (reference utils/geometry.py:71-84)."""
    sd = nusc.get('sample_data', rec['data']['LIDAR_TOP'])
    ep = nusc.get('ego_pose', sd['ego_pose_token'])
    cs = nusc.get('calibrated_sensor', sd['calibrated_sensor_token'])
    if not inverse:
        return (transform_matrix(ep['translation'], Quaternion(ep['rotation']))
                @ transform_matrix(cs['translation'],
                                   Quaternion(cs['rotation'])))
    return (transform_matrix(cs['translation'], Quaternion(cs['rotation']),
                             inverse=True)
            @ transform_matrix(ep['translation'], Quaternion(ep['rotation']),
                               inverse=True))


class FuturePredictionDataset:
    """Iterable of per-sample dicts shaped like data/synthetic.py batches
    (without the leading batch axis)."""

    SAMPLE_INTERVAL = 0.5  # seconds between keyframes

    def __init__(self, nusc: NuScenes, is_train: int, cfg: Config,
                 seed: int = 0):
        self.nusc = nusc
        # with the item's index, the seed of its candidate trajectories
        self.seed = seed
        self.cfg = cfg
        self.is_train = is_train
        self.dataroot = nusc.dataroot
        self.can = NuScenesCanBus(self.dataroot)
        self.receptive_field = cfg.TIME_RECEPTIVE_FIELD
        self.sequence_length = cfg.TIME_RECEPTIVE_FIELD + cfg.N_FUTURE_FRAMES
        self.spatial_extent = (cfg.LIFT.X_BOUND[1], cfg.LIFT.Y_BOUND[1])
        (self.bev_resolution, self.bev_start_position,
         self.bev_dimension) = G.calculate_birds_eye_view_parameters(
            cfg.LIFT.X_BOUND, cfg.LIFT.Y_BOUND, cfg.LIFT.Z_BOUND)

        self.scenes = self._get_scenes()
        self.ixes = self._prepro()
        self.indices = self._get_indices()
        self.augmentation = self._augmentation_parameters()

    # ------------------------------------------------------------- selection
    def _get_scenes(self) -> List[str]:
        split = {'v1.0-trainval': {0: 'train', 1: 'val', 2: 'test'},
                 'v1.0-mini': {0: 'mini_train', 1: 'mini_val'}}[
            self.nusc.version][self.is_train]
        blacklist = [419] + self.can.can_blacklist
        blacklist = ['scene-' + str(n).zfill(4) for n in blacklist]
        scenes = list(create_splits_scenes(self.nusc)[split])
        return [s for s in scenes if s not in blacklist]

    def _prepro(self) -> List[dict]:
        samples = [s for s in self.nusc.sample
                   if self.nusc.get('scene', s['scene_token'])['name']
                   in self.scenes]
        samples.sort(key=lambda x: (x['scene_token'], x['timestamp']))
        return samples

    def _get_indices(self) -> np.ndarray:
        indices = []
        for index in range(len(self.ixes)):
            current, prev = [], None
            ok = True
            for t in range(self.sequence_length):
                it = index + t
                if it >= len(self.ixes):
                    ok = False
                    break
                rec = self.ixes[it]
                if prev is not None and rec['scene_token'] != prev['scene_token']:
                    ok = False
                    break
                current.append(it)
                prev = rec
            if ok:
                indices.append(current)
        return np.asarray(indices)

    def _augmentation_parameters(self) -> dict:
        scale = self.cfg.IMAGE.RESIZE_SCALE
        fh, fw = self.cfg.IMAGE.FINAL_DIM
        rw = int(self.cfg.IMAGE.ORIGINAL_WIDTH * scale)
        rh = int(self.cfg.IMAGE.ORIGINAL_HEIGHT * scale)
        top = self.cfg.IMAGE.TOP_CROP
        left = int(max(0, (rw - fw) / 2))
        return {'resize_dims': (rw, rh),
                'crop': (left, top, left + fw, top + fh),
                'scale_width': scale, 'scale_height': scale}

    def __len__(self):
        return len(self.indices)

    # ----------------------------------------------------------- camera data
    def get_input_data(self, rec: dict):
        """images (N, H, W, 3) float normalised; intrinsics (N, 3, 3);
        extrinsics camera->lidar-egoframe (N, 4, 4); depths (N, H, W).

        Reference: NuscenesData.py:190-303."""
        images, intrinsics, extrinsics, depths = [], [], [], []
        lidar_sample = self.nusc.get('sample_data', rec['data']['LIDAR_TOP'])
        lidar_pose = self.nusc.get('ego_pose', lidar_sample['ego_pose_token'])
        yaw = Quaternion(lidar_pose['rotation']).yaw_pitch_roll[0]
        lidar_rot = Quaternion(scalar=np.cos(yaw / 2),
                               vector=[0, 0, np.sin(yaw / 2)])
        lidar_to_world = np.eye(4)
        lidar_to_world[:3, :3] = lidar_rot.rotation_matrix
        lidar_to_world[:3, 3] = np.asarray(lidar_pose['translation'])

        crop = self.augmentation['crop']
        for cam in self.cfg.IMAGE.NAMES:
            cam_sample = self.nusc.get('sample_data', rec['data'][cam])
            egopose = self.nusc.get('ego_pose', cam_sample['ego_pose_token'])
            world_to_ego = transform_matrix(
                egopose['translation'], Quaternion(egopose['rotation']),
                inverse=True)
            cs = self.nusc.get('calibrated_sensor',
                               cam_sample['calibrated_sensor_token'])
            ego_to_sensor = transform_matrix(
                cs['translation'], Quaternion(cs['rotation']), inverse=True)
            lidar_to_sensor = ego_to_sensor @ world_to_ego @ lidar_to_world
            sensor_to_lidar = np.linalg.inv(lidar_to_sensor).astype(np.float32)

            rgb = raster.read_image(os.path.join(self.dataroot,
                                                 cam_sample['filename']))
            orig_size = (rgb.shape[1], rgb.shape[0])
            rgb = raster.crop_image(raster.resize_image(
                rgb, self.augmentation['resize_dims']), crop)
            arr = rgb.astype(np.float32) / 255.0
            arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
            images.append(arr)

            intrinsic = G.update_intrinsics(
                np.asarray(cs['camera_intrinsic'], np.float32),
                top_crop=crop[1], left_crop=crop[0],
                scale_width=self.augmentation['scale_width'],
                scale_height=self.augmentation['scale_height'])
            intrinsics.append(intrinsic)
            extrinsics.append(sensor_to_lidar)

            if self.cfg.LIFT.GT_DEPTH:
                depths.append(self._get_depth(rec, cam_sample, orig_size,
                                              crop))

        return (np.stack(images), np.stack(intrinsics), np.stack(extrinsics),
                np.stack(depths) if depths else None)

    def _get_depth(self, rec, cam_sample, orig_size, crop) -> np.ndarray:
        """Sparse lidar depth in the camera image, resized like the RGB.

        Two sources (reference NuscenesData.py:271-290): cached ``depth_gt``
        .bin files, or — with cfg.GEN.GEN_DEPTH — online projection of the
        keyframe lidar sweep (get_depth_from_lidar:313-321)."""
        depth = np.full((orig_size[1], orig_size[0]), -1.0, np.float32)
        if self.cfg.GEN.GEN_DEPTH:
            from .nuscenes_sdk import map_pointcloud_to_image
            lidar_sample = self.nusc.get('sample_data',
                                         rec['data']['LIDAR_TOP'])
            uv, d = map_pointcloud_to_image(self.nusc, lidar_sample,
                                            cam_sample, orig_size)
            depth[uv[1].astype(np.int32), uv[0].astype(np.int32)] = d
        else:
            path = os.path.join(
                self.dataroot, 'depth_gt',
                os.path.split(cam_sample['filename'])[-1] + '.bin')
            if os.path.exists(path):
                cam_depth = np.fromfile(path, np.float32).reshape(-1, 3)
                coords = cam_depth[:, :2].astype(np.int16)
                depth[coords[:, 1], coords[:, 0]] = cam_depth[:, 2]
        depth = raster.resize_linear(depth, self.augmentation['resize_dims'])
        depth = depth[crop[1]:crop[3], crop[0]:crop[2]]
        return np.round(depth)

    # -------------------------------------------------------------- labels
    def _get_top_lidar_pose(self, rec):
        egopose = self.nusc.get(
            'ego_pose',
            self.nusc.get('sample_data',
                          rec['data']['LIDAR_TOP'])['ego_pose_token'])
        trans = -np.array(egopose['translation'])
        yaw = Quaternion(egopose['rotation']).yaw_pitch_roll[0]
        rot = Quaternion(scalar=np.cos(yaw / 2),
                         vector=[0, 0, np.sin(yaw / 2)]).inverse
        return trans, rot

    def _poly_region(self, annotation, translation, rotation):
        box = Box(annotation['translation'], annotation['size'],
                  Quaternion(annotation['rotation']))
        box.translate(translation)
        box.rotate(rotation)
        pts = box.bottom_corners()[:2].T
        pts = np.round((pts - self.bev_start_position[:2]
                        + self.bev_resolution[:2] / 2.0)
                       / self.bev_resolution[:2]).astype(np.int32)
        return pts[:, ::-1]

    def get_label(self, rec, instance_map, in_pred):
        """BEV segmentation / instance / pedestrian rasters for one frame.

        Reference: NuscenesData.py:394-439."""
        translation, rotation = self._get_top_lidar_pose(rec)
        nx, ny = int(self.bev_dimension[0]), int(self.bev_dimension[1])
        segmentation = np.zeros((nx, ny))
        pedestrian = np.zeros((nx, ny))
        instance = np.zeros((nx, ny))

        for ann_token in rec['anns']:
            ann = self.nusc.get('sample_annotation', ann_token)
            if (self.cfg.DATASET.FILTER_INVISIBLE_VEHICLES
                    and int(ann['visibility_token']) == 1 and not in_pred):
                continue
            if in_pred and ann['instance_token'] not in instance_map:
                continue
            if 'vehicle' in ann['category_name']:
                if ann['instance_token'] not in instance_map:
                    instance_map[ann['instance_token']] = len(instance_map) + 1
                iid = instance_map[ann['instance_token']]
                poly = self._poly_region(ann, translation, rotation)
                raster.fill_poly(instance, poly, iid)
                raster.fill_poly(segmentation, poly, 1.0)
            elif 'human' in ann['category_name']:
                if ann['instance_token'] not in instance_map:
                    instance_map[ann['instance_token']] = len(instance_map) + 1
                poly = self._poly_region(ann, translation, rotation)
                raster.fill_poly(pedestrian, poly, 1.0)
        return (segmentation.astype(np.int64), instance.astype(np.int64),
                pedestrian.astype(np.int64), instance_map)

    def _poly_from_box(self, box) -> np.ndarray:
        """BEV polygon of an ego-frame box (reference
        _get_poly_region_in_image_box_input, NuscenesData.py:385-395)."""
        pts = box.bottom_corners()[:2].T
        pts = np.round((pts - self.bev_start_position[:2]
                        + self.bev_resolution[:2] / 2.0)
                       / self.bev_resolution[:2]).astype(np.int32)
        return pts[:, ::-1]

    def get_label_multisweep(self, rec, instance_map, in_pred,
                             nsweeps: int = 10):
        """Per-sweep labels on the 0.05 s sweep lattice after keyframe `rec`.

        Sweep 0 is the keyframe itself; boxes at intermediate sweeps are
        devkit-interpolated (nuscenes_sdk.get_instance_box).  Reference:
        get_birds_eye_view_label_multisweep (NuscenesData.py:323-378).
        Returns (segmentation, instance, pedestrian) each (n_sweeps, X, Y)
        plus the per-sweep time lags (ref - sweep, seconds, <= 0)."""
        sd = self.nusc.get('sample_data', rec['data']['LIDAR_TOP'])
        nx, ny = int(self.bev_dimension[0]), int(self.bev_dimension[1])

        # the sweep lattice itself is annotation-independent
        lags, walk = [], sd
        ref_time = 1e-6 * sd['timestamp']
        for _ in range(nsweeps):
            lags.append(ref_time - 1e-6 * walk['timestamp'])
            if not walk.get('next'):
                break
            walk = self.nusc.get('sample_data', walk['next'])

        per_ann = []
        for ann_token in rec['anns']:
            ann = self.nusc.get('sample_annotation', ann_token)
            if (self.cfg.DATASET.FILTER_INVISIBLE_VEHICLES
                    and int(ann['visibility_token']) == 1 and not in_pred):
                continue
            if in_pred and ann['instance_token'] not in instance_map:
                continue
            if ('vehicle' not in ann['category_name']
                    and 'human' not in ann['category_name']):
                continue
            boxes, _ = instance_boxes_over_sweeps(
                self.nusc, sd, ann['instance_token'], nsweeps)
            per_ann.append((ann, boxes))

        n_sweeps = len(lags)
        segmentation = np.zeros((n_sweeps, nx, ny))
        pedestrian = np.zeros((n_sweeps, nx, ny))
        instance = np.zeros((n_sweeps, nx, ny))
        for t in range(n_sweeps):
            for ann, boxes in per_ann:
                if t >= len(boxes) or boxes[t] is None:
                    continue
                poly = self._poly_from_box(boxes[t])
                if 'vehicle' in ann['category_name']:
                    if ann['instance_token'] not in instance_map:
                        instance_map[ann['instance_token']] = \
                            len(instance_map) + 1
                    raster.fill_poly(instance[t], poly,
                               instance_map[ann['instance_token']])
                    raster.fill_poly(segmentation[t], poly, 1.0)
                else:
                    if ann['instance_token'] not in instance_map:
                        instance_map[ann['instance_token']] = \
                            len(instance_map) + 1
                    raster.fill_poly(pedestrian[t], poly, 1.0)
        return (segmentation.astype(np.int64), instance.astype(np.int64),
                pedestrian.astype(np.int64), instance_map,
                np.asarray(lags, np.float64))

    # ------------------------------------------------------------- egomotion
    def get_future_egomotion(self, rec, index) -> np.ndarray:
        """6-DoF pose t -> t+1 in the lidar keyframe frames
        (reference NuscenesData.py:460-501)."""
        out = np.eye(4, dtype=np.float32)
        if index < len(self.ixes) - 1:
            rec_t1 = self.ixes[index + 1]
            if rec['scene_token'] == rec_t1['scene_token']:
                ep0 = convert_egopose_to_matrix(self.nusc.get(
                    'ego_pose', self.nusc.get(
                        'sample_data',
                        rec['data']['LIDAR_TOP'])['ego_pose_token']))
                ep1 = convert_egopose_to_matrix(self.nusc.get(
                    'ego_pose', self.nusc.get(
                        'sample_data',
                        rec_t1['data']['LIDAR_TOP'])['ego_pose_token']))
                out = invert_rigid(ep1) @ ep0
                out[3, :3] = 0.0
                out[3, 3] = 1.0
        return G.mat2pose_vec(torch.from_numpy(out)).numpy()

    # -------------------------------------------------------------- planning
    def get_gt_trajectory(self, rec, ref_index):
        """Future ego positions + driving command
        (reference NuscenesData.py:619-646)."""
        n_output = self.cfg.N_FUTURE_FRAMES
        gt = np.zeros((n_output + 1, 3), np.float64)
        ego_cur_inv = get_global_pose(rec, self.nusc, inverse=True)
        for i in range(n_output + 1):
            index = ref_index + i
            if index < len(self.ixes):
                rec_future = self.ixes[index]
                if rec_future['scene_token'] != rec['scene_token']:
                    break
                ego_future = get_global_pose(rec_future, self.nusc)
                rel = ego_cur_inv @ ego_future
                theta = np.arctan2(rel[1, 0], rel[0, 0])
                gt[i] = [rel[0, 3], rel[1, 3], theta]
        if gt[-1][0] >= 2:
            command = 2  # RIGHT
        elif gt[-1][0] <= -2:
            command = 0  # LEFT
        else:
            command = 1  # FORWARD
        return gt.astype(np.float32), command

    def get_trajectory_sampling(self, rec, rng=None) -> np.ndarray:
        """Sample candidate trajectories from CAN speed/steering
        (reference NuscenesData.py:503-551), drawn from ``rng`` (numpy's
        global state when None)."""
        from . import sampler as trajectory_sampler
        scene = self.nusc.get('scene', rec['scene_token'])
        pose_msgs = self.can.get_messages(scene['name'], 'pose')
        steer_msgs = self.can.get_messages(scene['name'], 'steeranglefeedback')
        n_future = self.cfg.N_FUTURE_FRAMES
        if not pose_msgs or not steer_msgs:
            return np.zeros((self.cfg.PLANNING.SAMPLE_NUM, n_future + 1, 3),
                            np.float32)
        pose_uts = [m['utime'] for m in pose_msgs]
        steer_uts = [m['utime'] for m in steer_msgs]
        ref = rec['timestamp']
        v0 = pose_msgs[locate_message(pose_uts, ref)]['vel'][0]
        steering = steer_msgs[locate_message(steer_uts, ref)]['value']
        location = self.nusc.get(
            'log', scene['log_token'])['location']
        flip_flag = True if location.startswith('singapore') else False
        if flip_flag:
            steering *= -1
        Kappa = 2 * steering / 2.588
        trajs = trajectory_sampler.sample(
            v0, Kappa, self.cfg.PLANNING.SAMPLE_NUM,
            n_future * self.SAMPLE_INTERVAL, n_future, rng=rng)
        return trajs.astype(np.float32)

    # ----------------------------------------------------------------- lidar
    def get_points_from_multisweeps(self, index):
        """Grouped multisweep clouds (T_l clouds of (350k, 5)) + absolute
        sweep timestamps (reference NuscenesData.py:683-737)."""
        rec = self.ixes[self.indices[index][self.receptive_field - 1]]
        sd = self.nusc.get('sample_data', rec['data']['LIDAR_TOP'])
        nsweeps_back = int((self.receptive_field - 1) * 0.5 / 0.05)
        frame_skip = self.cfg.DATASET.FRAME_SKIP

        pc, times = multisweep_lidar(self.nusc, sd, nsweeps_back=nsweeps_back)
        pc = np.concatenate([pc, times[None]], axis=0)  # (5|6, P)
        pc = pc[:5] if pc.shape[0] > 5 else pc
        _, sort_idx = np.unique(times, return_index=True)
        unique_times = times[np.sort(sort_idx)]  # ascending time-lag

        # Static group count for batchability: near scene starts the prev
        # chain is short (the reference tolerates a variable count because
        # it runs BATCHSIZE=1, NuscenesData.py:683-737); pad the front by
        # duplicating the oldest group (same timestamp -> the ODE applies an
        # extra jump with the identical observation), truncate any excess.
        target = max(1, nsweeps_back // frame_skip)
        n_raw = -(-len(unique_times) // frame_skip)

        # per-point final group slot: raw group (time-lag ascending) g maps
        # to slot target-1-g (group 0 = oldest kept); slot < 0 => truncated
        k = np.searchsorted(unique_times, times)         # unique-time index
        group_of = (target - 1 - k // frame_skip).astype(np.int32)
        # no group may exceed the static capacity (points would be dropped)
        most = int(np.bincount(group_of[group_of >= 0], minlength=1).max())
        if most > MAX_LIDAR_POINTS:
            raise ValueError(f'a LiDAR group of {most} points exceeds the '
                             f'capacity of {MAX_LIDAR_POINTS}')
        padded, lens = native.group_pad(
            pc.T, group_of, n_groups=target, cap=MAX_LIDAR_POINTS)
        if self.cfg.MODEL.LIDAR.TILE_SORTED_POINTS:
            # loader contract: bucket-group each cloud by BEV bin tile so the
            # device binning kernel skips its sort (ops/bin_sum.py)
            se = self.cfg.MODEL.SPARSE_ENCODER
            for g in range(target):
                padded[g] = native.tile_sort_points(
                    padded[g], int(lens[g]), se.POINT_CLOUD_RANGE,
                    se.VOXEL_SIZE, BINS_PER_TILE)

        selected_times = unique_times[::frame_skip]      # per raw group
        sel = np.zeros((target,), np.float64)
        sel[target - 1 - np.arange(min(n_raw, target))] = \
            selected_times[:target]
        n_dup = max(0, target - n_raw)
        if n_dup:                                        # duplicate oldest
            padded[:n_dup] = padded[n_dup]
            sel[:n_dup] = sel[n_dup]

        lidar_timestamps = (sd['timestamp'] - sel * 1e6).astype(np.int64)
        return padded, lidar_timestamps

    RADAR_CHANNELS = ['RADAR_BACK_RIGHT', 'RADAR_BACK_LEFT', 'RADAR_FRONT',
                      'RADAR_FRONT_LEFT', 'RADAR_FRONT_RIGHT']

    def get_radar_data(self, rec, nsweeps: int = 1,
                       min_distance: float = 2.2) -> np.ndarray:
        """Aggregate all radar channels into the reference ego frame.

        (19, V) — 18 radar fields + per-return time lag, zero-padded to the
        static capacity V = 700 * nsweeps.  Reference: LyftData.py:540-595
        (called under MODEL.MODALITY.USE_RADAR, NuscenesData.py:851)."""
        from .nuscenes_sdk import load_radar_points

        cap = 700 * nsweeps
        ref_sd = self.nusc.get('sample_data', rec['data']['LIDAR_TOP'])
        ref_pose = self.nusc.get('ego_pose', ref_sd['ego_pose_token'])
        car_from_global = transform_matrix(
            ref_pose['translation'], Quaternion(ref_pose['rotation']),
            inverse=True)
        ref_time = 1e-6 * ref_sd['timestamp']

        chunks = []
        for chan in self.RADAR_CHANNELS:
            if chan not in rec['data']:
                continue
            sd = self.nusc.get('sample_data', rec['data'][chan])
            for _ in range(nsweeps):
                pts = load_radar_points(
                    os.path.join(self.dataroot, sd['filename']))
                pose = self.nusc.get('ego_pose', sd['ego_pose_token'])
                cs = self.nusc.get('calibrated_sensor',
                                   sd['calibrated_sensor_token'])
                tm = (car_from_global
                      @ transform_matrix(pose['translation'],
                                         Quaternion(pose['rotation']))
                      @ transform_matrix(cs['translation'],
                                         Quaternion(cs['rotation'])))
                lag = ref_time - 1e-6 * sd['timestamp']
                rows = native.sweep_transform(
                    pts.T, tm, min_dist=min_distance, time_lag=lag,
                    out_channels=19, time_col=18)
                chunks.append(rows)
                if not sd.get('prev'):
                    break
                sd = self.nusc.get('sample_data', sd['prev'])
        out = np.zeros((19, cap), np.float32)
        if chunks:
            allpts = np.concatenate(chunks, axis=0)[:cap]
            out[:, :allpts.shape[0]] = allpts.T
        return out

    def get_lidar_range_data(self, rec, nsweeps: int = 1,
                             min_distance: float = 2.2,
                             cap: int = 35000) -> np.ndarray:
        """Ego-frame lidar returns with a time-lag channel, zero-padded.

        (5, cap * nsweeps) — x, y, z, intensity, time lag.  The loader-side
        input of the (dormant-in-shipped-config) range-view path; reference:
        LyftData.get_lidar_range_data:264-330, gated by MODEL.LIDAR.USE_RANGE
        + GEN.GEN_RANGE (NuscenesData.py:853)."""
        from .nuscenes_sdk import load_lidar_points

        ref_sd = self.nusc.get('sample_data', rec['data']['LIDAR_TOP'])
        ref_pose = self.nusc.get('ego_pose', ref_sd['ego_pose_token'])
        car_from_global = transform_matrix(
            ref_pose['translation'], Quaternion(ref_pose['rotation']),
            inverse=True)
        ref_time = 1e-6 * ref_sd['timestamp']

        chunks = []
        sd = ref_sd
        for _ in range(nsweeps):
            pts = load_lidar_points(self.nusc, sd)[:, :4]
            pose = self.nusc.get('ego_pose', sd['ego_pose_token'])
            cs = self.nusc.get('calibrated_sensor',
                               sd['calibrated_sensor_token'])
            tm = (car_from_global
                  @ transform_matrix(pose['translation'],
                                     Quaternion(pose['rotation']))
                  @ transform_matrix(cs['translation'],
                                     Quaternion(cs['rotation'])))
            lag = ref_time - 1e-6 * sd['timestamp']
            chunks.append(native.sweep_transform(
                pts, tm, min_dist=min_distance, time_lag=lag,
                out_channels=5, time_col=4))
            if not sd.get('prev'):
                break
            sd = self.nusc.get('sample_data', sd['prev'])
        out = np.zeros((5, cap * nsweeps), np.float32)
        allpts = np.concatenate(chunks, axis=0)[:cap * nsweeps]
        out[:, :allpts.shape[0]] = allpts.T
        return out

    # ---------------------------------------------------------------- getitem
    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rf = self.receptive_field
        data: Dict[str, list] = {k: [] for k in [
            'image', 'intrinsics', 'extrinsics', 'depths', 'segmentation',
            'instance', 'pedestrian', 'future_egomotion', 'camera_timestamp',
            'target_timestamp']}
        instance_map: Dict[str, int] = {}

        rec_ref = self.ixes[self.indices[index][rf - 1]]
        ref_sd = self.nusc.get('sample_data', rec_ref['data']['LIDAR_TOP'])
        current_time = ref_sd['timestamp']

        use_ms = cfg.DATASET.USE_MULTISWEEP
        n_seq = len(self.indices[index])
        radar: list = []
        range_clouds: list = []
        status = 'valid'
        for i, index_t in enumerate(self.indices[index]):
            in_pred = i >= rf
            rec = self.ixes[index_t]
            if i < rf:
                images, intr, extr, depths = self.get_input_data(rec)
                data['image'].append(images)
                data['intrinsics'].append(intr)
                data['extrinsics'].append(extr)
                if depths is not None:
                    data['depths'].append(depths)
                data['camera_timestamp'].append(rec['timestamp'])

            if use_ms and rf - 1 <= i < n_seq - 1:
                # expand this keyframe into per-sweep labels on the 0.05 s
                # lattice (reference NuscenesData.py:819-841: static egomotion
                # between sweeps, the real keyframe egomotion on the last).
                # Label failures mark the sample invalid instead of raising
                # (data-level fault tolerance, reference :840-841); the
                # loader drops invalid samples (dataloader.py).
                try:
                    seg_ms, inst_ms, ped_ms, instance_map, lags = \
                        self.get_label_multisweep(
                            rec, instance_map, in_pred,
                            nsweeps=cfg.DATASET.MULTISWEEP_NSWEEPS)
                except Exception:
                    status = 'invalid'
                    nx, ny = (int(self.bev_dimension[0]),
                              int(self.bev_dimension[1]))
                    seg_ms = np.zeros((1, nx, ny), np.int64)
                    inst_ms = np.zeros((1, nx, ny), np.int64)
                    ped_ms = np.zeros((1, nx, ny), np.int64)
                    lags = np.zeros((1,))
                ego_kf = self.get_future_egomotion(rec, index_t)
                for s in range(len(lags)):
                    data['segmentation'].append(seg_ms[s][..., None])
                    data['instance'].append(inst_ms[s])
                    data['pedestrian'].append(ped_ms[s][..., None])
                    last = s == len(lags) - 1
                    data['future_egomotion'].append(
                        ego_kf if last else np.zeros(6, np.float32))
                    data['target_timestamp'].append(
                        rec['timestamp'] - 1e6 * lags[s])
            else:
                seg, inst, ped, instance_map = self.get_label(
                    rec, instance_map, in_pred)
                data['segmentation'].append(seg[..., None])
                data['instance'].append(inst)
                data['pedestrian'].append(ped[..., None])
                data['future_egomotion'].append(
                    self.get_future_egomotion(rec, index_t))
                data['target_timestamp'].append(rec['timestamp'])

            if cfg.MODEL.MODALITY.USE_RADAR:
                radar.append(self.get_radar_data(rec, nsweeps=1,
                                                 min_distance=2.2))
            if cfg.MODEL.LIDAR.USE_RANGE:
                range_clouds.append(self.get_lidar_range_data(
                    rec, nsweeps=1, min_distance=2.2))

            if i == rf - 1:
                gt_traj, command = self.get_gt_trajectory(rec, index_t)
                gt_trajectory = gt_traj
                sample_trajectory = self.get_trajectory_sampling(
                    rec, rng=np.random.RandomState([self.seed, index]))

        padded_points, lidar_times = self.get_points_from_multisweeps(index)

        out = {
            'image': np.stack(data['image']).astype(np.float32),
            'intrinsics': np.stack(data['intrinsics']),
            'extrinsics': np.stack(data['extrinsics']),
            'segmentation': np.stack(data['segmentation']),
            'instance': np.stack(data['instance']),
            'pedestrian': np.stack(data['pedestrian']),
            'future_egomotion': np.stack(data['future_egomotion']),
            'points': np.asarray(padded_points, np.float32),
            'gt_trajectory': gt_trajectory,
            'command': np.int64(command),
            'sample_trajectory': sample_trajectory,
            'target_point': np.zeros(2, np.float32),
            'status': status,
        }
        if data['depths']:
            out['depths'] = np.stack(data['depths']).astype(np.float32)
        if radar:
            out['radar_pointclouds'] = np.stack(radar)
        if range_clouds:
            out['range_clouds'] = np.stack(range_clouds)

        center, offset, flow = convert_instance_mask_to_center_and_offset_label(
            out['instance'], out['future_egomotion'],
            num_instances=len(instance_map),
            ignore_index=cfg.DATASET.IGNORE_INDEX, subtract_egomotion=True,
            spatial_extent=self.spatial_extent)
        out['centerness'] = center
        out['offset'] = offset
        out['flow'] = flow

        out['camera_timestamp'] = (
            (np.asarray(data['camera_timestamp']) - current_time) / 1e6
        ).astype(np.float32)
        out['lidar_timestamp'] = (
            (lidar_times - current_time) / 1e6).astype(np.float32)
        out['target_timestamp'] = (
            (np.asarray(data['target_timestamp']) - current_time) / 1e6
        ).astype(np.float32)
        return out
