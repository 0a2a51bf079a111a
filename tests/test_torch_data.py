"""The port's data path against the JAX package's, on the on-disk fixture.

- the port's tree writer (data/mini_nuscenes.py) at the fixture's defaults
  writes the fixture's files byte for byte;
- ``FuturePredictionDataset`` items equal the JAX package's key for key on
  the same tree (integers exact, floats within 1e-6): camera only,
  camera+LiDAR with the tile-sorted points, multisweep labels, online
  depth, Lyft, and a tree with boxes across the BEV border;
- the loader gives the JAX loader's batches over 2 shuffled epochs, at 0
  and 2 workers, dropping invalid items as it does;
- the raster helpers that replace OpenCV and PIL: the polygon fill equals
  ``cv2.fillPoly`` exactly, the depth resize ``cv2.resize(INTER_LINEAR)``,
  the frame resize PIL's within one uint8 level, the PPM reader PIL's
  decode.
"""
import filecmp
import os
import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from fixtures_nuscenes import make_mini_nuscenes  # noqa: E402

from streamingflow_tpu.config import Config as JConfig  # noqa: E402
from streamingflow_tpu.data import dataloader as JD  # noqa: E402
from streamingflow_tpu_torch.config import Config as PConfig  # noqa: E402
from streamingflow_tpu_torch.data import dataloader as PD  # noqa: E402
from streamingflow_tpu_torch.data import mini_nuscenes, raster  # noqa: E402

torch.set_num_threads(2)

BASE = {
    'TIME_RECEPTIVE_FIELD': 2, 'N_FUTURE_FRAMES': 2, 'N_WORKERS': 0,
    'DATASET': {'VERSION': 'mini', 'FRAME_SKIP': 5},
    'IMAGE': {'NAMES': ['CAM_FRONT', 'CAM_BACK'], 'ORIGINAL_WIDTH': 160,
              'ORIGINAL_HEIGHT': 90, 'FINAL_DIM': [32, 64],
              'RESIZE_SCALE': 0.5, 'TOP_CROP': 8},
    'LIFT': {'X_BOUND': [-16.0, 16.0, 0.5], 'Y_BOUND': [-16.0, 16.0, 0.5],
             'GT_DEPTH': False},
}
CASES = {
    'camera': {},
    'camera_lidar': {'MODEL': {'MODALITY': {'USE_LIDAR': True},
                               'LIDAR': {'BACKBONE': 'pillar8x',
                                         'TILE_SORTED_POINTS': True}}},
    'multisweep': {'DATASET': {'USE_MULTISWEEP': True,
                               'MULTISWEEP_NSWEEPS': 2}},
    'gen_depth': {'LIFT': {'GT_DEPTH': True}, 'GEN': {'GEN_DEPTH': True}},
    'lyft': {'DATASET': {'NAME': 'lyft', 'VERSION': 'v1.0-mini'}},
    'boxes_across_border': {'LIFT': {'X_BOUND': [-18.0, 18.0, 0.5],
                                     'Y_BOUND': [-18.0, 18.0, 0.5]}},
}


def _merge(a, b):
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(a[k], v) if isinstance(v, dict) and k in a else v
    return out


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    def make(name, **kw):
        root = str(tmp_path_factory.mktemp(name))
        make_mini_nuscenes(root, **kw)
        return root
    fixture = make('nusc', n_scenes=2, n_samples=9, n_sweeps_between=1)
    lyft = make('lyft', n_scenes=4, n_samples=6, n_sweeps_between=1,
                category='car')
    border = str(tmp_path_factory.mktemp('border'))
    mini_nuscenes.make_mini_nuscenes(border, n_scenes=2, n_samples=7,
                                     n_sweeps_between=1, n_instances=12)
    return {'fixture': fixture, 'lyft': lyft, 'border': border}


def _datasets(case, trees):
    root = {'lyft': trees['lyft'],
            'boxes_across_border': trees['border']}.get(case,
                                                        trees['fixture'])
    d = _merge(BASE, CASES[case])
    d = _merge(d, {'DATASET': {'DATAROOT': root}})
    _, _, jt, jv = JD.prepare_dataloaders(JConfig().merge_dict(d),
                                          return_dataset=True)
    _, _, pt, pv = PD.prepare_dataloaders(PConfig().merge_dict(d),
                                          return_dataset=True)
    return (jt, pt), (jv, pv)


def _assert_items_equal(want, got, what):
    assert want.keys() == got.keys(), (what, want.keys() ^ got.keys())
    for k, w in want.items():
        g = got[k]
        if not isinstance(w, np.ndarray):
            assert w == g, (what, k, w, g)
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, \
            (what, k, g.shape, w.shape, g.dtype, w.dtype)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=f'{what} {k}')
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                       err_msg=f'{what} {k}')


def test_writer_at_the_fixture_defaults_writes_the_fixture(tmp_path):
    a, b = tmp_path / 'fixture', tmp_path / 'port'
    make_mini_nuscenes(str(a))
    mini_nuscenes.make_mini_nuscenes(str(b))
    cmp = filecmp.dircmp(a, b)

    def walk(c):
        assert not (c.left_only or c.right_only or c.diff_files
                    or c.funny_files), (c.left, c.left_only, c.right_only,
                                        c.diff_files)
        for sub in c.subdirs.values():
            walk(sub)
    walk(cmp)
    _, mismatch, errors = filecmp.cmpfiles(
        a, b, ['splits.json'], shallow=False)
    assert not mismatch and not errors


@pytest.mark.parametrize('case', sorted(CASES))
def test_items_equal_the_jax_dataset(case, trees):
    n_items = 0
    for split, (jds, pds) in zip(('train', 'val'), _datasets(case, trees)):
        assert len(pds) == len(jds)
        np.testing.assert_array_equal(pds.indices, jds.indices)
        for i in sorted({0, len(jds) - 1} & set(range(len(jds)))):
            n_items += 1
            _assert_items_equal(jds[i], pds[i], f'{case} {split}[{i}]')
    assert n_items >= 2


def test_boxes_cross_the_bev_border(trees):
    """The border case reaches the clipping branches of the fill."""
    (_, pds), _ = _datasets('boxes_across_border', trees)
    seg = pds[0]['segmentation'][..., 0]
    edges = np.concatenate([seg[:, 0], seg[:, -1], seg[:, :, 0],
                            seg[:, :, -1]], axis=None)
    assert edges.any() and seg.sum() > edges.sum()


class _Indexed:
    """A dataset of index items; every fifth item invalid."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {'index': np.array([i]),
                'status': 'invalid' if i % 5 == 4 else 'valid'}


@pytest.mark.parametrize('workers', [0, 2])
def test_loader_order_equals_the_jax_loader(workers):
    for shuffle, drop_last in ((True, True), (False, False)):
        j = JD.DataLoader(_Indexed(11), 3, shuffle=shuffle,
                          drop_last=drop_last)
        p = PD.DataLoader(_Indexed(11), 3, shuffle=shuffle,
                          drop_last=drop_last, num_workers=workers)
        assert len(p) == len(j)
        for epoch in range(2):
            want = [b['index'][:, 0].tolist() for b in j]
            batches = list(p)
            assert all(isinstance(b['index'], torch.Tensor) for b in batches)
            assert [b['index'][:, 0].tolist() for b in batches] == want, \
                (shuffle, epoch)
        assert p.epoch == j.epoch == 2


def _boxes(n, h, w, seed):
    rng = np.random.RandomState(seed)
    for i in range(n):
        cx, cy = rng.uniform(-20, w + 20), rng.uniform(-20, h + 20)
        half = np.array([rng.uniform(0.5, 15), rng.uniform(0.25, 6)])
        th = rng.uniform(0, 2 * np.pi)
        rot = np.array([[np.cos(th), np.sin(th)], [-np.sin(th), np.cos(th)]])
        corners = np.array([[1, 1], [1, -1], [-1, -1], [-1, 1]]) * half
        pts = np.round(corners @ rot + [cx, cy]).astype(np.int32)
        yield pts if i % 2 else pts[::-1].copy()


def test_fill_poly_equals_opencv():
    """2,400 seeded rotated boxes on a 200 x 200 grid (inside, across
    every edge and corner, outside, degenerate) and 600 random polygons,
    both orientations: every pixel equal to cv2.fillPoly's."""
    n_clipped = 0
    shapes = list(_boxes(2400, 200, 200, 0))
    rng = np.random.RandomState(1)
    shapes += [rng.randint(-30, 230, size=(rng.randint(3, 8), 2)).astype(
        np.int32) for _ in range(600)]
    for pts in shapes:
        want = np.zeros((200, 200))
        got = np.zeros((200, 200))
        cv2.fillPoly(want, [pts], 3.0)
        raster.fill_poly(got, pts, 3.0)
        np.testing.assert_array_equal(got, want, err_msg=str(pts.tolist()))
        n_clipped += bool((pts < 0).any() or (pts > 199).any())
    assert n_clipped > 500


def test_depth_resize_matches_opencv():
    """Sparse depth maps (-1 background) resized as the dataset resizes
    them: within 2 float32 ulp of the map's largest value of
    cv2.resize(INTER_LINEAR), equal after the dataset's rounding (measured
    at 1600x900 -> 480x270: 7.6e-6 at values up to 60, ~1 ulp)."""
    rng = np.random.RandomState(0)
    for (h, w), out in (((900, 1600), (480, 270)), ((90, 160), (80, 45)),
                        ((1024, 1224), (367, 307)), ((50, 70), (140, 100))):
        d = np.full((h, w), -1.0, np.float32)
        n = h * w // 20
        d[rng.randint(0, h, n), rng.randint(0, w, n)] = rng.uniform(1, 60, n)
        want = cv2.resize(d, out, interpolation=cv2.INTER_LINEAR)
        got = raster.resize_linear(d, out)
        assert got.shape == want.shape and got.dtype == np.float32
        ulp = np.spacing(np.float32(np.abs(d).max()))
        assert np.abs(got - want).max() <= 2 * ulp
        np.testing.assert_array_equal(np.round(got), np.round(want))


def test_image_resize_matches_pil():
    """The antialiased bilinear resize of uint8 frames: within one level of
    PIL's resize(BILINEAR) (measured: at most 1, on noise at 1600x900 ->
    480x270; 0 on the fixture's 160x90 -> 80x45), and the crop as PIL's
    (zeros outside the frame)."""
    rng = np.random.RandomState(0)
    for (h, w), out in (((900, 1600), (480, 270)), ((90, 160), (80, 45))):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        want = np.asarray(Image.fromarray(img).resize(out, Image.BILINEAR))
        got = raster.resize_image(img, out)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.abs(got.astype(int) - want).max() <= 1
        if out == (80, 45):
            np.testing.assert_array_equal(got, want)
        box = (8, -4, 8 + out[0], out[1] + 6)
        np.testing.assert_array_equal(
            raster.crop_image(want, box),
            np.asarray(Image.fromarray(want).crop(box)))


def test_ppm_reader_equals_pil(tmp_path):
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    path = str(tmp_path / 'frame.ppm')
    raster.write_ppm(path, img)
    np.testing.assert_array_equal(raster.read_ppm(path), img)
    np.testing.assert_array_equal(raster.read_ppm(path),
                                  np.asarray(Image.open(path)))
    # PIL's own PPM, with a comment in the header
    Image.fromarray(img).save(str(tmp_path / 'pil.ppm'))
    with open(tmp_path / 'pil.ppm', 'rb') as f:
        data = f.read()
    with open(tmp_path / 'commented.ppm', 'wb') as f:
        f.write(data.replace(b'P6\n', b'P6\n# a comment\n', 1))
    np.testing.assert_array_equal(
        raster.read_ppm(str(tmp_path / 'commented.ppm')), img)


def test_jpeg_without_pil_names_the_file_type(tmp_path, monkeypatch):
    path = str(tmp_path / 'frame.jpg')
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(path)
    monkeypatch.setattr(raster, '_have_pil', lambda: False)
    with pytest.raises(RuntimeError, match=r'\.jpg frame needs PIL'):
        raster.read_image(path)


def _live_descendants():
    """Pids of the live processes below this one."""
    parent = {}
    for entry in filter(str.isdigit, os.listdir('/proc')):
        try:
            with open(f'/proc/{entry}/stat') as f:
                state, ppid = f.read().rsplit(')', 1)[1].split()[:2]
        except (OSError, ValueError):
            continue
        if state != 'Z':
            parent[int(entry)] = int(ppid)
    found, frontier = set(), {os.getpid()}
    while frontier:
        frontier = {p for p, pp in parent.items() if pp in frontier}
        found |= frontier
    return found


def test_close_and_stop_leave_no_process():
    """A loader's workers end with ``close``, and the fork server and
    resource tracker they came from with ``stop_worker_server``: no process
    that the loader started outlives the two."""
    before = _live_descendants()
    loader = PD.DataLoader(_Indexed(11), 3, shuffle=True, num_workers=2)
    assert len(list(loader)) == 3
    running = _live_descendants() - before
    assert len(running) >= 2           # the workers, at least
    loader.close()
    PD.stop_worker_server()
    assert not (_live_descendants() & running)
    assert len(list(loader)) == 3      # a closed loader starts anew
    loader.close()
    PD.stop_worker_server()
    assert _live_descendants() <= before
