"""Minimal self-contained nuScenes SDK.

A copy of streamingflow_tpu/data/nuscenes_sdk.py, kept in the port so that
it imports nothing of the JAX package (its point-cloud loops use the port's
own host engine, ``streamingflow_tpu_torch.native``).

A from-scratch replacement for the slices of the vendored nuscenes-devkit the
reference pipeline uses (table access, quaternions, boxes, CAN bus,
multisweep lidar aggregation — see reference streamingflow/datas/
NuscenesData.py imports and utils/data_classes.py:454-600).  Only the
standard library + numpy.

The dataset layout is the public nuScenes format: JSON tables under
``<dataroot>/<version>/*.json`` and binary sweeps under ``<dataroot>/
samples|sweeps/...``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


# ----------------------------------------------------------------- quaternion
class Quaternion:
    """Minimal wxyz quaternion with the operations the pipeline needs."""

    def __init__(self, wxyz=None, scalar: Optional[float] = None,
                 vector=None):
        if wxyz is not None:
            self.q = np.asarray(wxyz, np.float64)
        else:
            self.q = np.concatenate([[scalar], np.asarray(vector, np.float64)])

    @property
    def rotation_matrix(self) -> np.ndarray:
        w, x, y, z = self.q / np.linalg.norm(self.q)
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])

    @property
    def inverse(self) -> 'Quaternion':
        w, x, y, z = self.q
        n = np.dot(self.q, self.q)
        return Quaternion([w / n, -x / n, -y / n, -z / n])

    def __mul__(self, other: 'Quaternion') -> 'Quaternion':
        w1, x1, y1, z1 = self.q
        w2, x2, y2, z2 = other.q
        return Quaternion([
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])

    @property
    def yaw_pitch_roll(self) -> Tuple[float, float, float]:
        """Intrinsic z-y'-x'' Tait-Bryan angles (devkit convention)."""
        w, x, y, z = self.q / np.linalg.norm(self.q)
        yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
        pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1, 1))
        roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
        return yaw, pitch, roll

    def rotate(self, v: np.ndarray) -> np.ndarray:
        return self.rotation_matrix @ np.asarray(v, np.float64)

    @staticmethod
    def slerp(q0: 'Quaternion', q1: 'Quaternion', t: float) -> 'Quaternion':
        """Spherical interpolation (shortest path), t in [0, 1]."""
        a = q0.q / np.linalg.norm(q0.q)
        b = q1.q / np.linalg.norm(q1.q)
        dot = float(np.dot(a, b))
        if dot < 0.0:
            b, dot = -b, -dot
        if dot > 0.9995:  # nearly parallel: lerp
            out = a + t * (b - a)
            return Quaternion(out / np.linalg.norm(out))
        theta = np.arccos(np.clip(dot, -1.0, 1.0))
        s = np.sin(theta)
        return Quaternion((np.sin((1 - t) * theta) / s) * a
                          + (np.sin(t * theta) / s) * b)


def quaternion_yaw(q: Quaternion) -> float:
    """Yaw of a quaternion around +z (devkit eval/common/utils semantics)."""
    v = q.rotation_matrix @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))


def transform_matrix(translation, rotation: Quaternion,
                     inverse: bool = False) -> np.ndarray:
    """4x4 homogeneous transform (devkit geometry_utils semantics)."""
    tm = np.eye(4)
    if inverse:
        rot = rotation.rotation_matrix.T
        tm[:3, :3] = rot
        tm[:3, 3] = rot @ (-np.asarray(translation, np.float64))
    else:
        tm[:3, :3] = rotation.rotation_matrix
        tm[:3, 3] = np.asarray(translation, np.float64)
    return tm


# ------------------------------------------------------------------------ box
class Box:
    """3-D oriented box (center, wlh size, quaternion orientation)."""

    def __init__(self, center, size, orientation: Quaternion):
        self.center = np.asarray(center, np.float64)
        self.wlh = np.asarray(size, np.float64)
        self.orientation = orientation

    def translate(self, x):
        self.center = self.center + np.asarray(x, np.float64)

    def rotate(self, quaternion: Quaternion):
        self.center = quaternion.rotation_matrix @ self.center
        self.orientation = quaternion * self.orientation

    def corners(self) -> np.ndarray:
        """(3, 8) corners; first four face forward (devkit order)."""
        w, l, h = self.wlh
        x = l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1])
        y = w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1])
        z = h / 2 * np.array([1, 1, -1, -1, 1, 1, -1, -1])
        corners = np.vstack([x, y, z])
        corners = self.orientation.rotation_matrix @ corners
        return corners + self.center[:, None]

    def bottom_corners(self) -> np.ndarray:
        """(3, 4) corners of the bottom face (devkit order [2, 3, 7, 6])."""
        return self.corners()[:, [2, 3, 7, 6]]


# --------------------------------------------------------------------- tables
NUSCENES_TABLES = ['category', 'attribute', 'visibility', 'instance',
                   'sensor', 'calibrated_sensor', 'ego_pose', 'log', 'scene',
                   'sample', 'sample_data', 'sample_annotation', 'map']


class NuScenes:
    """Token-indexed access to the nuScenes relational tables."""

    def __init__(self, version: str = 'v1.0-trainval',
                 dataroot: str = 'data/nuscenes', verbose: bool = False):
        self.version = version
        self.dataroot = dataroot
        self._tables: Dict[str, List[dict]] = {}
        self._index: Dict[str, Dict[str, dict]] = {}
        table_root = os.path.join(dataroot, version)
        for table in NUSCENES_TABLES:
            path = os.path.join(table_root, f'{table}.json')
            records = []
            if os.path.exists(path):
                with open(path) as f:
                    records = json.load(f)
            self._tables[table] = records
            self._index[table] = {r['token']: r for r in records}
        self._link_keyframes()

    def _link_keyframes(self):
        """Reverse index: sample token -> {channel: sample_data token} and
        annotation list, mirroring the devkit's table decoration."""
        for sample in self.sample:
            sample.setdefault('data', {})
            sample.setdefault('anns', [])
        for sd in self.sample_data:
            if sd.get('is_key_frame'):
                sample = self._index['sample'].get(sd['sample_token'])
                if sample is not None:
                    sensor = self.get(
                        'sensor',
                        self.get('calibrated_sensor',
                                 sd['calibrated_sensor_token'])['sensor_token'])
                    sample['data'][sensor['channel']] = sd['token']
        for ann in self.sample_annotation:
            sample = self._index['sample'].get(ann['sample_token'])
            if sample is not None:
                sample['anns'].append(ann['token'])
            # devkit decoration: join instance -> category name
            if 'category_name' not in ann:
                inst = self._index['instance'].get(ann.get('instance_token'))
                if inst is not None:
                    cat = self._index['category'].get(inst['category_token'])
                    ann['category_name'] = cat['name'] if cat else ''
                else:
                    ann['category_name'] = ''

    def __getattr__(self, name):
        if name in NUSCENES_TABLES:
            return self._tables[name]
        raise AttributeError(name)

    def get(self, table: str, token: str) -> dict:
        return self._index[table][token]


# --------------------------------------------------------------------- splits
def create_splits_scenes(nusc: Optional[NuScenes] = None,
                         splits_file: Optional[str] = None) -> Dict[str, List[str]]:
    """Official scene splits.

    Resolution order: the real ``nuscenes`` package if importable, an explicit
    ``splits.json`` ({split: [scene names]}) next to the tables, else a
    deterministic 85/15 fallback over the scenes present (documented
    divergence — install the official split file for benchmark parity)."""
    try:  # pragma: no cover - depends on environment
        from nuscenes.utils.splits import create_splits_scenes as _official
        return _official()
    except ImportError:
        pass
    if splits_file and os.path.exists(splits_file):
        with open(splits_file) as f:
            return json.load(f)
    if nusc is not None:
        default = os.path.join(nusc.dataroot, 'splits.json')
        if os.path.exists(default):
            with open(default) as f:
                return json.load(f)
        names = sorted(s['name'] for s in nusc.scene)
        cut = max(1, int(0.85 * len(names)))
        return {'train': names[:cut], 'val': names[cut:],
                'mini_train': names[:cut], 'mini_val': names[cut:],
                'test': names}
    return {'train': [], 'val': [], 'mini_train': [], 'mini_val': [],
            'test': []}


# -------------------------------------------------------------------- can bus
class NuScenesCanBus:
    """CAN bus message access (devkit can_bus_api semantics).

    Messages live in ``<dataroot>/can_bus/<scene>_<channel>.json``."""

    # scenes without any CAN data in the official release
    can_blacklist = [161, 162, 163, 164, 165, 166, 167, 168, 170, 171, 172,
                     173, 174, 175, 176, 309, 310, 311, 312, 313, 314]

    def __init__(self, dataroot: str):
        self.can_dir = os.path.join(dataroot, 'can_bus')

    def get_messages(self, scene_name: str, channel: str) -> List[dict]:
        path = os.path.join(self.can_dir, f'{scene_name}_meta_{channel}.json')
        if not os.path.exists(path):
            path = os.path.join(self.can_dir, f'{scene_name}_{channel}.json')
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return json.load(f)


def locate_message(utimes, utime):
    """Nearest message index (reference NuscenesData.py:41-45)."""
    i = int(np.searchsorted(utimes, utime))
    if i == len(utimes) or (i > 0 and utime - utimes[i - 1] < utimes[i] - utime):
        i -= 1
    return i


# ----------------------------------------------------------------- radar i/o
_PCD_TYPES = {('F', 4): '<f4', ('F', 8): '<f8', ('I', 1): '<i1',
              ('I', 2): '<i2', ('I', 4): '<i4', ('U', 1): '<u1',
              ('U', 2): '<u2', ('U', 4): '<u4'}

# devkit default radar filters (data_classes.py RadarPointCloud:1038-1043)
RADAR_INVALID_STATES = [0]
RADAR_DYNPROP_STATES = list(range(7))
RADAR_AMBIG_STATES = [3]


def load_radar_points(path: str,
                      invalid_states=None, dynprop_states=None,
                      ambig_states=None) -> np.ndarray:
    """Parse a nuScenes radar .pcd file -> (18, N) float32 with the devkit's
    default state filters (RadarPointCloud.from_file semantics,
    reference utils/data_classes.py:1053-1150).

    Fields: x y z dyn_prop id rcs vx vy vx_comp vy_comp is_quality_valid
    ambig_state x_rms y_rms invalid_state pdh0 vx_rms vy_rms."""
    invalid_states = (RADAR_INVALID_STATES if invalid_states is None
                      else invalid_states)
    dynprop_states = (RADAR_DYNPROP_STATES if dynprop_states is None
                      else dynprop_states)
    ambig_states = RADAR_AMBIG_STATES if ambig_states is None else ambig_states

    with open(path, 'rb') as f:
        header = {}
        while True:
            line = f.readline().decode('ascii', 'ignore').strip()
            if not line or line.startswith('#'):
                continue
            key, _, val = line.partition(' ')
            header[key] = val
            if key == 'DATA':
                break
        fields = header['FIELDS'].split()
        sizes = [int(s) for s in header['SIZE'].split()]
        types = header['TYPE'].split()
        n = int(header.get('POINTS', header.get('WIDTH', '0')))
        if header['DATA'] != 'binary':
            raise ValueError(f'unsupported PCD data mode {header["DATA"]}')
        dtype = np.dtype([(name, _PCD_TYPES[(t, s)])
                          for name, t, s in zip(fields, types, sizes)])
        raw = np.frombuffer(f.read(dtype.itemsize * n), dtype, count=n)

    pts = np.stack([raw[name].astype(np.float32) for name in fields])
    keep = (np.isin(raw['invalid_state'], invalid_states)
            & np.isin(raw['dyn_prop'], dynprop_states)
            & np.isin(raw['ambig_state'], ambig_states))
    return pts[:, keep]


# -------------------------------------------------------- box interpolation
def get_instance_box(nusc: NuScenes, sample_data_token: str,
                     instance_token: str) -> Optional[Box]:
    """Global-frame box of an instance at a sample_data's timestamp.

    Devkit ``NuScenes.get_instance_box`` semantics (used by the reference's
    forked devkit for per-sweep labels, utils/data_classes.py:713-796): at a
    keyframe, the annotation itself; at an intermediate sweep, linear
    interpolation of center and slerp of orientation between the previous
    and current keyframes' annotations.  Returns None when the instance is
    not annotated at the bracketing keyframe(s)."""
    sd = nusc.get('sample_data', sample_data_token)
    sample = nusc.get('sample', sd['sample_token'])

    def ann_of(sample_rec):
        for tok in sample_rec['anns']:
            ann = nusc.get('sample_annotation', tok)
            if ann['instance_token'] == instance_token:
                return ann
        return None

    curr = ann_of(sample)
    if sd.get('is_key_frame'):
        if curr is None:
            return None
        return Box(curr['translation'], curr['size'],
                   Quaternion(curr['rotation']))

    prev_sample = (nusc.get('sample', sample['prev'])
                   if sample.get('prev') else None)
    prev = ann_of(prev_sample) if prev_sample is not None else None
    if curr is None and prev is None:
        return None
    if curr is None or prev is None:
        a = curr if curr is not None else prev
        return Box(a['translation'], a['size'], Quaternion(a['rotation']))
    t0, t1 = prev_sample['timestamp'], sample['timestamp']
    t = 0.0 if t1 == t0 else np.clip(
        (sd['timestamp'] - t0) / (t1 - t0), 0.0, 1.0)
    center = ((1 - t) * np.asarray(prev['translation'], np.float64)
              + t * np.asarray(curr['translation'], np.float64))
    rot = Quaternion.slerp(Quaternion(prev['rotation']),
                           Quaternion(curr['rotation']), float(t))
    return Box(center, curr['size'], rot)


def instance_boxes_over_sweeps(nusc: NuScenes, ref_sample_data: dict,
                               instance_token: str, nsweeps_forward: int
                               ) -> Tuple[list, list]:
    """Per-sweep boxes of an instance, mapped to the reference ego frame.

    Mirrors the forked devkit's get_instance_boxes_multisweep_sample_data
    (reference utils/data_classes.py:713-796, forward walk): sweep 0 is the
    reference sample_data itself, then the ``next`` chain; boxes translate/
    rotate into the reference ego-pose frame (full quaternion).  Returns
    (boxes (len <= nsweeps, entries may be None), time_lags (ref - sweep,
    seconds, <= 0))."""
    ref_pose = nusc.get('ego_pose', ref_sample_data['ego_pose_token'])
    ref_time = 1e-6 * ref_sample_data['timestamp']
    inv_rot = Quaternion(ref_pose['rotation']).inverse
    neg_trans = -np.asarray(ref_pose['translation'], np.float64)

    boxes, lags = [], []
    sd = ref_sample_data
    for _ in range(nsweeps_forward):
        box = get_instance_box(nusc, sd['token'], instance_token)
        if box is not None:
            box.translate(neg_trans)
            box.rotate(inv_rot)
        boxes.append(box)
        lags.append(ref_time - 1e-6 * sd['timestamp'])
        if not sd.get('next'):
            break
        sd = nusc.get('sample_data', sd['next'])
    return boxes, lags


# ------------------------------------------------------------------ lidar i/o
def load_lidar_points(nusc: NuScenes, sample_data: dict) -> np.ndarray:
    """Read one sweep: (N, 5) [x, y, z, intensity, ring] float32."""
    path = os.path.join(nusc.dataroot, sample_data['filename'])
    scan = np.fromfile(path, dtype=np.float32).reshape(-1, 5)
    return scan


def map_pointcloud_to_image(nusc: NuScenes, lidar_sd: dict, cam_sd: dict,
                            image_size: Tuple[int, int],
                            min_dist: float = 1.0
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Project a lidar sweep into a camera image.

    Devkit ``NuScenesExplorer.map_pointcloud_to_image`` semantics (the
    reference's online GT-depth path, NuscenesData.py get_depth_from_lidar
    :313-321): lidar sensor -> ego(t_lidar) -> global -> ego(t_cam) ->
    camera -> pixels.  image_size: (W, H).  Returns (pixel coords (2, N),
    depths (N,)) for the points that survive the devkit mask (depth >
    min_dist, 1 px inside the image border)."""
    pts = load_lidar_points(nusc, lidar_sd)[:, :3].T.astype(np.float64)

    cs_l = nusc.get('calibrated_sensor', lidar_sd['calibrated_sensor_token'])
    pts = Quaternion(cs_l['rotation']).rotation_matrix @ pts
    pts = pts + np.asarray(cs_l['translation'], np.float64)[:, None]
    ep_l = nusc.get('ego_pose', lidar_sd['ego_pose_token'])
    pts = Quaternion(ep_l['rotation']).rotation_matrix @ pts
    pts = pts + np.asarray(ep_l['translation'], np.float64)[:, None]

    ep_c = nusc.get('ego_pose', cam_sd['ego_pose_token'])
    pts = pts - np.asarray(ep_c['translation'], np.float64)[:, None]
    pts = Quaternion(ep_c['rotation']).rotation_matrix.T @ pts
    cs_c = nusc.get('calibrated_sensor', cam_sd['calibrated_sensor_token'])
    pts = pts - np.asarray(cs_c['translation'], np.float64)[:, None]
    pts = Quaternion(cs_c['rotation']).rotation_matrix.T @ pts

    depths = pts[2]
    K = np.asarray(cs_c['camera_intrinsic'], np.float64)
    with np.errstate(divide='ignore', invalid='ignore'):
        uv = K @ pts
        uv = uv[:2] / np.maximum(uv[2:3], 1e-9)
    w, h = image_size
    mask = ((depths > min_dist) & (uv[0] > 1) & (uv[0] < w - 1)
            & (uv[1] > 1) & (uv[1] < h - 1))
    return uv[:, mask], depths[mask]


def multisweep_lidar(nusc: NuScenes, ref_sample_data: dict,
                     nsweeps_back: int = 20,
                     min_distance: float = 1.0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Aggregate past sweeps into the reference sensor frame.

    Returns (points (4or5, P) [x, y, z, intensity, ...], time_lags (P,)
    seconds before the reference sweep).  Re-implements the behaviour of the
    reference's forked devkit ``from_file_multisweep_bf_sample_data``
    (utils/data_classes.py:454-600): walk the ``prev`` chain, transform each
    sweep into the reference sensor frame via (sensor->ego->global) poses.
    """
    ref_pose = nusc.get('ego_pose', ref_sample_data['ego_pose_token'])
    ref_cs = nusc.get('calibrated_sensor',
                      ref_sample_data['calibrated_sensor_token'])
    car_from_global = transform_matrix(
        ref_pose['translation'], Quaternion(ref_pose['rotation']), inverse=True)
    ref_from_car = transform_matrix(
        ref_cs['translation'], Quaternion(ref_cs['rotation']), inverse=True)

    from .. import native

    all_points = []
    sd = ref_sample_data
    ref_time = 1e-6 * ref_sample_data['timestamp']
    for _ in range(nsweeps_back):
        pts = load_lidar_points(nusc, sd)
        pose = nusc.get('ego_pose', sd['ego_pose_token'])
        cs = nusc.get('calibrated_sensor', sd['calibrated_sensor_token'])
        global_from_car = transform_matrix(
            pose['translation'], Quaternion(pose['rotation']), inverse=False)
        car_from_sensor = transform_matrix(
            cs['translation'], Quaternion(cs['rotation']), inverse=False)
        tm = ref_from_car @ car_from_global @ global_from_car @ car_from_sensor
        time_lag = ref_time - 1e-6 * sd['timestamp']
        # fused filter + transform + time stamp in the native engine
        # (GIL-free; falls back to numpy without a toolchain)
        nc = pts.shape[1]
        all_points.append(native.sweep_transform(
            pts, tm, min_dist=min_distance, time_lag=time_lag,
            out_channels=nc + 1, time_col=nc))
        if not sd.get('prev'):
            break
        sd = nusc.get('sample_data', sd['prev'])
    stamped = np.concatenate(all_points, axis=0)
    return stamped[:, :-1].T, stamped[:, -1]
