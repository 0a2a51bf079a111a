"""Write a nuScenes-format tree: the JSON tables, camera frames, LiDAR
sweeps and radar returns the data path reads (the public layout, see
data/nuscenes_sdk.py), from a seed.

A parametrised copy of the test fixture ``tests/fixtures_nuscenes.py::
make_mini_nuscenes``: at its defaults :func:`make_mini_nuscenes` writes the
fixture's files byte for byte (JPEG frames through PIL); the parameters
scale it to a realistic size (cameras, image size, points a sweep, sweeps
between keyframes, boxes a scene), ``image_format='ppm'`` writes binary
PPM frames where PIL is not installed, and ``can_bus=True`` adds each
scene's CAN bus (``can_bus/<scene>_pose.json`` at 50 Hz and
``<scene>_steeranglefeedback.json`` at 100 Hz, the ego's speed and a
steering angle), from which the dataset samples the planner's candidate
trajectories.

    python -m streamingflow_tpu_torch.data.mini_nuscenes ROOT [--flagship]
        [--can-bus]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .nuscenes_sdk import Quaternion
from .raster import write_ppm

W_IMG, H_IMG = 160, 90
# the nuScenes camera rig: yaw of each camera's optical axis about ego z
CAMERA_YAW_DEG = {'CAM_FRONT_LEFT': 55.0, 'CAM_FRONT': 0.0,
                  'CAM_FRONT_RIGHT': -55.0, 'CAM_BACK_LEFT': 110.0,
                  'CAM_BACK': 180.0, 'CAM_BACK_RIGHT': -110.0}
NUSCENES_CAMERAS = list(CAMERA_YAW_DEG)
# optical frame (z forward, x right, y down) of a camera looking along ego +x
_FRONT_OPTICAL = [0.5, -0.5, 0.5, -0.5]


def camera_rotation(channel: str) -> list:
    """Sensor -> ego rotation (wxyz) of a camera of the rig."""
    if channel == 'CAM_FRONT':
        return list(_FRONT_OPTICAL)
    if channel == 'CAM_BACK':
        return [0.5, -0.5, -0.5, 0.5]
    half = np.deg2rad(CAMERA_YAW_DEG[channel]) / 2
    yaw = Quaternion([np.cos(half), 0.0, 0.0, np.sin(half)])
    return [float(v) for v in (yaw * Quaternion(_FRONT_OPTICAL)).q]

RADAR_FIELDS = ('x y z dyn_prop id rcs vx vy vx_comp vy_comp '
                'is_quality_valid ambig_state x_rms y_rms invalid_state '
                'pdh0 vx_rms vy_rms')
RADAR_SIZES = '4 4 4 1 2 4 4 4 4 4 1 1 1 1 1 1 1 1'
RADAR_TYPES = 'F F F I I F F F F F I I I I I I I I'


def write_radar_pcd(path: str, rng, n: int = 40) -> None:
    """Write a minimal binary nuScenes-format radar .pcd file."""
    dtype = np.dtype([(f, {'F': f'<f{s}', 'I': f'<i{s}'}[t])
                      for f, s, t in zip(RADAR_FIELDS.split(),
                                         RADAR_SIZES.split(),
                                         RADAR_TYPES.split())])
    rows = np.zeros(n, dtype)
    rows['x'] = rng.uniform(3, 40, n)
    rows['y'] = rng.uniform(-20, 20, n)
    rows['rcs'] = rng.uniform(-10, 30, n)
    rows['vx'] = rng.uniform(-5, 5, n)
    rows['ambig_state'] = 3                     # devkit default keep-filter
    rows['invalid_state'] = 0
    rows['dyn_prop'] = rng.randint(0, 7, n)
    # one return that the default filters must drop
    rows['invalid_state'][0] = 5
    header = (f'VERSION 0.7\nFIELDS {RADAR_FIELDS}\nSIZE {RADAR_SIZES}\n'
              f'TYPE {RADAR_TYPES}\n'
              f'COUNT {" ".join(["1"] * 18)}\nWIDTH {n}\nHEIGHT 1\n'
              f'VIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA binary\n')
    with open(path, 'wb') as f:
        f.write(header.encode('ascii'))
        f.write(rows.tobytes())


def _camera_token(channel: str) -> str:
    short = {'CAM_FRONT': 'f', 'CAM_BACK': 'b'}.get(channel)
    return f'sensor_cam_{short}' if short else f'sensor_{channel.lower()}'


def make_mini_nuscenes(root: str, version: str = 'v1.0-mini',
                       n_scenes: int = 2, n_samples: int = 9,
                       n_sweeps_between: int = 1, seed: int = 0,
                       category: str = 'vehicle.car',
                       cameras=('CAM_FRONT', 'CAM_BACK'),
                       image_size=(W_IMG, H_IMG), n_points: int = 512,
                       n_instances: int = 1,
                       image_format: str = 'jpg',
                       can_bus: bool = False) -> None:
    """Write the tree under ``root``.  ``image_size`` is (W, H) of every
    frame (focal length 100 px at the fixture's 160 px width, scaled with
    it); ``n_points`` the returns of a LiDAR sweep; ``n_instances`` the
    moving boxes of a scene (the first as in the fixture, the others placed
    around the ego from their own seed); ``image_format`` 'jpg' (PIL) or
    'ppm'; ``can_bus``: write the scenes' CAN bus (:func:`write_can_bus`,
    from a seed of its own: the other files stay as they are)."""
    if image_format not in ('jpg', 'ppm'):
        raise ValueError(f'image_format {image_format!r}: jpg or ppm')
    rng = np.random.RandomState(seed)
    layout = np.random.RandomState(seed + 1)   # the extra boxes' placement
    w_img, h_img = (int(v) for v in image_size)
    os.makedirs(os.path.join(root, version), exist_ok=True)
    os.makedirs(os.path.join(root, 'samples', 'LIDAR_TOP'), exist_ok=True)
    os.makedirs(os.path.join(root, 'sweeps', 'LIDAR_TOP'), exist_ok=True)

    sensors = [{'token': 'sensor_lidar', 'channel': 'LIDAR_TOP',
                'modality': 'lidar'}]
    sensors += [{'token': _camera_token(c), 'channel': c,
                 'modality': 'camera'} for c in cameras]
    sensors.append({'token': 'sensor_radar', 'channel': 'RADAR_FRONT',
                    'modality': 'radar'})
    for s in sensors[1:]:
        os.makedirs(os.path.join(root, 'samples', s['channel']), exist_ok=True)

    calibrated, ego_poses = [], []
    cs_by_sensor = {}
    focal = 100.0 * w_img / W_IMG
    K = [[focal, 0.0, w_img / 2], [0.0, focal, h_img / 2], [0.0, 0.0, 1.0]]
    for s in sensors:
        tok = 'cs_' + s['token']
        cs_by_sensor[s['token']] = tok
        calibrated.append({
            'token': tok, 'sensor_token': s['token'],
            'translation': [0.0, 0.0, 1.6],
            'rotation': (camera_rotation(s['channel'])
                         if s['modality'] == 'camera'
                         else [1.0, 0.0, 0.0, 0.0]),
            'camera_intrinsic': K if s['modality'] == 'camera' else []})

    logs = [{'token': 'log0', 'location': 'boston-seaport'}]
    scenes, samples, sample_datas, annotations = [], [], [], []
    instances, categories = [], [{'token': 'cat0', 'name': category}]

    t0 = 1_000_000_000_000_000  # microseconds

    for si in range(n_scenes):
        scene_tok = f'scene{si}'
        first = last = ''
        sample_toks = [f's{si}_{k}' for k in range(n_samples)]
        inst_toks = [f'inst{si}'] + [f'inst{si}_{j}'
                                     for j in range(1, n_instances)]
        for inst_tok in inst_toks:
            instances.append({'token': inst_tok, 'category_token': 'cat0',
                              'nbr_annotations': n_samples})
        # boxes after the first: start (x, y) around the ego, speed along
        # x, yaw
        extra = [(layout.uniform(-40, 40), layout.uniform(-40, 40),
                  layout.uniform(-3, 3), layout.uniform(-np.pi, np.pi))
                 for _ in range(1, n_instances)]

        prev_lidar_sd = ''
        for k in range(n_samples):
            ts = t0 + si * 10**9 + k * 500_000  # 0.5 s keyframes
            tok = sample_toks[k]
            samples.append({
                'token': tok, 'scene_token': scene_tok, 'timestamp': ts,
                'prev': sample_toks[k - 1] if k else '',
                'next': sample_toks[k + 1] if k < n_samples - 1 else ''})

            # ego pose: straight line along x, 2 m per keyframe
            def add_pose(ptok, t, jitter=0.0):
                ego_poses.append({
                    'token': ptok, 'timestamp': t,
                    'translation': [si * 1000.0 + (t - t0 - si * 10**9)
                                    / 500_000 * 2.0, jitter, 0.0],
                    'rotation': [1.0, 0.0, 0.0, 0.0]})

            # keyframe lidar + intermediate sweeps (prev chain)
            sweep_ts = [ts - j * 50_000
                        for j in range(n_sweeps_between, 0, -1)]
            lidar_chain = []
            for j, st in enumerate(sweep_ts + [ts]):
                is_key = (st == ts)
                sd_tok = f'sd_l_{si}_{k}_{j}'
                folder = 'samples' if is_key else 'sweeps'
                fname = f'{folder}/LIDAR_TOP/{sd_tok}.pcd.bin'
                pts = rng.uniform(-30, 30, size=(n_points, 5)).astype(
                    np.float32)
                pts[:, 2] = rng.uniform(-2, 2, size=n_points)
                pts.tofile(os.path.join(root, fname))
                ptok = f'pose_l_{si}_{k}_{j}'
                add_pose(ptok, st)
                sample_datas.append({
                    'token': sd_tok, 'sample_token': tok,
                    'ego_pose_token': ptok,
                    'calibrated_sensor_token': cs_by_sensor['sensor_lidar'],
                    'filename': fname, 'timestamp': st,
                    'is_key_frame': is_key, 'prev': '', 'next': ''})
                lidar_chain.append(sd_tok)
            # link prev pointers (most recent first walk)
            by_tok = {sd['token']: sd for sd in sample_datas}
            for j in range(len(lidar_chain) - 1, 0, -1):
                by_tok[lidar_chain[j]]['prev'] = lidar_chain[j - 1]
            by_tok[lidar_chain[0]]['prev'] = prev_lidar_sd
            prev_lidar_sd = lidar_chain[-1]

            # cameras + radar (keyframes only)
            for s in sensors[1:]:
                sd_tok = f'sd_{s["token"]}_{si}_{k}'
                if s['modality'] == 'camera':
                    fname = f'samples/{s["channel"]}/{sd_tok}.{image_format}'
                    arr = rng.randint(0, 255, size=(h_img, w_img, 3),
                                      dtype=np.uint8)
                    if image_format == 'ppm':
                        write_ppm(os.path.join(root, fname), arr)
                    else:
                        from PIL import Image
                        Image.fromarray(arr).save(os.path.join(root, fname))
                else:
                    fname = f'samples/{s["channel"]}/{sd_tok}.pcd'
                    write_radar_pcd(os.path.join(root, fname), rng)
                ptok = f'pose_{s["token"]}_{si}_{k}'
                add_pose(ptok, ts)
                sample_datas.append({
                    'token': sd_tok, 'sample_token': tok,
                    'ego_pose_token': ptok,
                    'calibrated_sensor_token': cs_by_sensor[s['token']],
                    'filename': fname, 'timestamp': ts,
                    'is_key_frame': True, 'prev': '', 'next': ''})

            # the moving boxes, each annotated at every keyframe
            annotations.append({
                'token': f'ann{si}_{k}', 'sample_token': tok,
                'instance_token': inst_toks[0],
                'translation': [si * 1000.0 + k * 2.0 + 8.0, 3.0, 0.5],
                'size': [2.0, 4.5, 1.5],
                'rotation': [1.0, 0.0, 0.0, 0.0],
                'visibility_token': '4'})
            for j, (bx, by, v, yaw) in enumerate(extra, start=1):
                annotations.append({
                    'token': f'ann{si}_{k}_{j}', 'sample_token': tok,
                    'instance_token': inst_toks[j],
                    'translation': [si * 1000.0 + bx + k * v, by, 0.5],
                    'size': [2.0, 4.5, 1.5],
                    'rotation': [float(np.cos(yaw / 2)), 0.0, 0.0,
                                 float(np.sin(yaw / 2))],
                    'visibility_token': '4'})

        first, last = sample_toks[0], sample_toks[-1]
        scenes.append({'token': scene_tok, 'name': f'scene-{si:04d}',
                       'log_token': 'log0', 'nbr_samples': n_samples,
                       'first_sample_token': first, 'last_sample_token': last})

    # derive next pointers from the prev chains (needed by the multisweep
    # label path, which walks forward over the 0.05 s sweep lattice)
    by_tok = {sd['token']: sd for sd in sample_datas}
    for sd in sample_datas:
        if sd['prev']:
            by_tok[sd['prev']]['next'] = sd['token']

    tables = {
        'scene': scenes, 'sample': samples, 'sample_data': sample_datas,
        'ego_pose': ego_poses, 'calibrated_sensor': calibrated,
        'sensor': sensors, 'sample_annotation': annotations,
        'instance': instances, 'category': categories, 'log': logs,
        'attribute': [], 'visibility': [], 'map': [],
    }
    for name, records in tables.items():
        with open(os.path.join(root, version, f'{name}.json'), 'w') as f:
            json.dump(records, f)
    # scene splits for the fallback loader
    with open(os.path.join(root, 'splits.json'), 'w') as f:
        json.dump({'train': ['scene-0000'], 'val': ['scene-0001'],
                   'mini_train': ['scene-0000'], 'mini_val': ['scene-0001']},
                  f)
    if can_bus:
        write_can_bus(root, scenes, samples, seed + 2)


def write_can_bus(root: str, scenes, samples, seed: int) -> None:
    """Each scene's CAN bus messages (the devkit's can_bus layout) from one
    second before its first keyframe to one second after its last: ``pose``
    at 50 Hz with the ego's velocity (4 m/s along x, as its poses move,
    with a little noise) and ``steeranglefeedback`` at 100 Hz (a slow
    swing of +-0.2 rad with noise)."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, 'can_bus'), exist_ok=True)
    for scene in scenes:
        ts = [s['timestamp'] for s in samples
              if s['scene_token'] == scene['token']]
        lo, hi = min(ts) - 1_000_000, max(ts) + 1_000_000
        pose = [{'utime': int(u), 'vel': [4.0 + 0.1 * float(rng.randn()),
                                          0.0, 0.0],
                 'pos': [0.0, 0.0, 0.0], 'orientation': [1.0, 0.0, 0.0, 0.0]}
                for u in range(lo, hi, 20_000)]
        steer = [{'utime': int(u),
                  'value': 0.2 * float(np.sin((u - lo) / 1.5e6))
                  + 0.01 * float(rng.randn())}
                 for u in range(lo, hi, 10_000)]
        for channel, msgs in (('pose', pose), ('steeranglefeedback', steer)):
            with open(os.path.join(root, 'can_bus',
                                   f"{scene['name']}_{channel}.json"),
                      'w') as f:
                json.dump(msgs, f)


def flagship_tree(root: str, image_format: str = 'jpg') -> None:
    """The tree of the flagship configuration at a realistic size: the 6
    cameras at 1600x900, 34,720-point LiDAR sweeps at 20 Hz (9 sweeps
    between the 2 Hz keyframes), 20 moving boxes a scene, 2 scenes of 9
    keyframes, and the scenes' CAN bus (the planner's candidates)."""
    make_mini_nuscenes(root, n_scenes=2, n_samples=9, n_sweeps_between=9,
                       cameras=NUSCENES_CAMERAS, image_size=(1600, 900),
                       n_points=34720, n_instances=20,
                       image_format=image_format, can_bus=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('root')
    ap.add_argument('--flagship', action='store_true',
                    help='the flagship-size tree (flagship_tree)')
    ap.add_argument('--image-format', default='jpg', choices=('jpg', 'ppm'))
    ap.add_argument('--can-bus', action='store_true',
                    help='add the CAN bus to the small tree (the flagship '
                         'tree has it)')
    args = ap.parse_args(argv)
    if args.flagship:
        flagship_tree(args.root, args.image_format)
    else:
        make_mini_nuscenes(args.root, image_format=args.image_format,
                           can_bus=args.can_bus)


if __name__ == '__main__':
    main()
