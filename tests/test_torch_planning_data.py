"""The planner's inputs on the nuScenes data path: candidate trajectories
drawn per item from a seeded ``RandomState`` (data/nuscenes.py), equal at
any number of loader workers, and equal to the JAX dataset's when its
global state is set to that ``RandomState``; the sampler against the JAX
package's with one explicit ``RandomState``; the tree writer's CAN bus
(data/mini_nuscenes.py, ``can_bus=True``), which leaves the other files as
they are.
"""
import hashlib
import os

import numpy as np
import pytest

from streamingflow_tpu.config import Config as JConfig
from streamingflow_tpu.data import dataloader as JD
from streamingflow_tpu.data import sampler as JS
from streamingflow_tpu_torch.config import Config as PConfig
from streamingflow_tpu_torch.data import dataloader as PD
from streamingflow_tpu_torch.data import mini_nuscenes
from streamingflow_tpu_torch.data import sampler as PS

CFG = {
    'TIME_RECEPTIVE_FIELD': 2, 'N_FUTURE_FRAMES': 2, 'N_WORKERS': 0,
    'BATCHSIZE': 2,
    'DATASET': {'VERSION': 'mini', 'FRAME_SKIP': 5},
    'IMAGE': {'NAMES': ['CAM_FRONT', 'CAM_BACK'], 'ORIGINAL_WIDTH': 160,
              'ORIGINAL_HEIGHT': 90, 'FINAL_DIM': [32, 64],
              'RESIZE_SCALE': 0.5, 'TOP_CROP': 8},
    'LIFT': {'X_BOUND': [-16.0, 16.0, 0.5], 'Y_BOUND': [-16.0, 16.0, 0.5],
             'GT_DEPTH': False},
    'PLANNING': {'ENABLED': True, 'SAMPLE_NUM': 30},
}


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('nusc_can'))
    mini_nuscenes.make_mini_nuscenes(root, n_scenes=2, n_samples=9,
                                     can_bus=True)
    return root


def _cfg(tree, cls=PConfig, **kw):
    return cls().merge_dict({**CFG, 'DATASET': {**CFG['DATASET'],
                                                'DATAROOT': tree}, **kw})


@pytest.mark.parametrize('kappa', [0.0, 0.08, -0.05])
def test_sampler_matches_jax_with_one_random_state(kappa):
    want = JS.sample(5.0, kappa, 60, 2.0, 4,
                     rng=np.random.RandomState(3))
    got = PS.sample(5.0, kappa, 60, 2.0, 4, rng=np.random.RandomState(3))
    np.testing.assert_array_equal(got, want)


def _candidates(cfg):
    """Each train item's candidates, by index, through the loader."""
    train, _, ds, _ = PD.prepare_dataloaders(cfg, return_dataset=True)
    out = {}
    try:
        for batch in train:
            for row, traj in enumerate(batch['sample_trajectory']):
                key = hashlib.sha1(
                    batch['image'][row].numpy().tobytes()).hexdigest()
                out[key] = traj.numpy()
    finally:
        train.close()
        PD.stop_worker_server()
    return out, ds


def test_candidates_equal_at_zero_and_two_workers(tree):
    """The same item gives the same candidates in the main thread and in
    either of two workers (items keyed by their images),
    and they are the sampler's at RandomState([seed, index])."""
    got0, ds = _candidates(_cfg(tree))
    got2, _ = _candidates(_cfg(tree, N_WORKERS=2))
    assert len(got0) == len(ds) > 2
    assert got0.keys() == got2.keys()
    for k, v in got0.items():
        np.testing.assert_array_equal(got2[k], v)
        assert np.abs(v).max() > 0         # sampled from the CAN bus
    item = ds[1]
    again = ds[1]
    np.testing.assert_array_equal(item['sample_trajectory'],
                                  again['sample_trajectory'])
    assert not np.array_equal(item['sample_trajectory'],
                              ds[2]['sample_trajectory'])


@pytest.mark.parametrize('index', [0, 3])
def test_item_equals_the_jax_dataset_on_a_can_bus_tree(tree, index):
    """Every key of an item equals the JAX dataset's, the candidates
    included once numpy's global state (which the JAX dataset draws them
    from) is set to the item's RandomState([0, index])."""
    _, _, jt, _ = JD.prepare_dataloaders(_cfg(tree, JConfig),
                                         return_dataset=True)
    _, _, pt, _ = PD.prepare_dataloaders(_cfg(tree), return_dataset=True)
    state = np.random.get_state()
    try:
        np.random.set_state(np.random.RandomState([0, index]).get_state())
        want = jt[index]
    finally:
        np.random.set_state(state)
    got = pt[index]
    assert want.keys() == got.keys()
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6,
                                       err_msg=k)
        else:
            assert got[k] == w, k
    assert np.abs(got['sample_trajectory']).max() > 0


def _digests(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, 'rb') as fh:
                out[os.path.relpath(path, root)] = hashlib.sha1(
                    fh.read()).hexdigest()
    return out


def test_can_bus_leaves_the_other_files_as_they_are(tree, tmp_path,
                                                    monkeypatch):
    plain = str(tmp_path / 'plain')
    mini_nuscenes.make_mini_nuscenes(plain, n_scenes=2, n_samples=9)
    with_can = _digests(tree)
    can = {k for k in with_can if k.startswith('can_bus')}
    assert can == {f'can_bus/scene-000{i}_{c}.json' for i in range(2)
                   for c in ('pose', 'steeranglefeedback')}
    assert {k: v for k, v in with_can.items() if k not in can} == \
        _digests(plain)
    # the flagship tree asks for the CAN bus
    seen = {}
    monkeypatch.setattr(mini_nuscenes, 'make_mini_nuscenes',
                        lambda root, **kw: seen.update(kw))
    mini_nuscenes.flagship_tree(str(tmp_path / 'flagship'))
    assert seen['can_bus'] is True and seen['n_points'] == 34720
