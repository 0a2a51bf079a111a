"""Planning in evaluation: ``training/metrics.py::PlanningMetric`` against
the JAX metric (L2 in float64 at 1e-12, equal collision counts, equal ego
cells at the tiny and the default grids; its state summed across metrics),
and ``evaluate.run_planner`` against the JAX package's ``_run_planner``
(the root evaluate.py) on one batch of a nuScenes-format tree with a CAN
bus, at 1e-5.
"""
import types

import jax
import numpy as np
import pytest
import torch

import evaluate as jax_evaluate
from streamingflow_tpu.config import Config as JConfig
from streamingflow_tpu.data import tiny_config as jax_tiny_config
from streamingflow_tpu.training import metrics as JM
from streamingflow_tpu.training import trainer as JT
import streamingflow_tpu_torch as P
from streamingflow_tpu_torch import evaluate as PE
from streamingflow_tpu_torch.config import Config as PConfig
from streamingflow_tpu_torch.convert import load_flax_variables
from streamingflow_tpu_torch.data import dataloader as PD
from streamingflow_tpu_torch.data import mini_nuscenes
from streamingflow_tpu_torch.data import tiny_config
from streamingflow_tpu_torch.training import metrics as PM

from torch_parity import assert_close, init_jax, jnp_tree, port_like


@pytest.mark.parametrize('which', ['tiny', 'default'])
def test_ego_cells_equal_the_jax_metrics(which):
    jcfg = jax_tiny_config() if which == 'tiny' else JConfig()
    pcfg = tiny_config() if which == 'tiny' else PConfig()
    want = {tuple(c) for c in JM.PlanningMetric(jcfg)._ego_box_cells()}
    got = {tuple(c) for c in PM.PlanningMetric(pcfg).ego_box_cells()}
    assert got == want
    assert len(got) == (32 if which == 'default' else len(want)) > 4


def _updates(n_future, seed, H=64, B=3):
    """Trajectories near the ego (one point leaving the grid), the ground
    truth 8 m to the side, occupancy of small blobs and, for the first two
    rows, the cells the trajectories pass (32 x 32 m grid at 0.5 m)."""
    rng = np.random.RandomState(seed)
    trajs = np.cumsum(rng.uniform(-1, 2, (B, n_future, 3)), 1)
    trajs[0, -1, :2] = [60.0, -80.0]
    gt = trajs + np.array([8.0, 0.0, 0.0]) + rng.randn(B, n_future, 3) * 0.3
    seg = np.zeros((B, n_future, H, H), np.int64)
    for b in range(B):
        for _ in range(4):
            r, c = rng.randint(0, H - 3, 2)
            seg[b, :, r:r + 3, c:c + 3] = 1
    for b in range(2):
        for s in range(1, n_future):
            r = int((trajs[b, s, 1] + 15.75) / 0.5)
            c = int((-trajs[b, s, 0] + 15.75) / 0.5)
            if 0 <= r < H and 0 <= c < H:
                seg[b, s, r, c] = 1
    return trajs, gt, seg


def _cfgs():
    out = []
    for cls in (JConfig, PConfig):
        cfg = cls()
        cfg.LIFT.X_BOUND = [-16.0, 16.0, 0.5]
        cfg.LIFT.Y_BOUND = [-16.0, 16.0, 0.5]
        out.append(cfg)
    return out


@pytest.mark.parametrize('n_future', [2, 4])
def test_planning_metric_matches_jax(n_future):
    jcfg, pcfg = _cfgs()
    jm = JM.PlanningMetric(jcfg, n_future)
    pm = PM.PlanningMetric(pcfg, n_future)
    for seed in range(3):
        args = _updates(n_future, seed)
        jm.update(*args)
        pm.update(*args)
    np.testing.assert_allclose(pm.L2, jm.L2, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(pm.obj_col, jm.obj_col)
    np.testing.assert_array_equal(pm.obj_box_col, jm.obj_box_col)
    assert pm.total == jm.total == 9
    assert pm.obj_box_col.sum() > 0 and pm.obj_col.sum() > 0
    for k, v in jm.compute().items():
        np.testing.assert_allclose(pm.compute()[k], v, rtol=1e-12)


def test_planning_metric_states_sum():
    """Two metrics' summed states, loaded into a third, are one metric
    updated with both batches (the sharded validation's sum)."""
    _, pcfg = _cfgs()
    a, b, both = (PM.PlanningMetric(pcfg, 4) for _ in range(3))
    for m, seeds in ((a, [0]), (b, [1, 2]), (both, [0, 1, 2])):
        for s in seeds:
            m.update(*_updates(4, s))
    merged = PM.PlanningMetric(pcfg, 4)
    merged.load_state(a.state() + b.state())
    np.testing.assert_allclose(merged.state(), both.state(), rtol=1e-12)
    assert merged.total == 9
    for k, v in both.compute().items():
        np.testing.assert_allclose(merged.compute()[k], v, rtol=1e-12)


TREE_CFG = {
    'TIME_RECEPTIVE_FIELD': 2, 'N_FUTURE_FRAMES': 2, 'N_WORKERS': 0,
    'DATASET': {'VERSION': 'mini', 'FRAME_SKIP': 5},
    'IMAGE': {'NAMES': ['CAM_FRONT', 'CAM_BACK'], 'ORIGINAL_WIDTH': 160,
              'ORIGINAL_HEIGHT': 90, 'FINAL_DIM': [32, 64],
              'RESIZE_SCALE': 0.5, 'TOP_CROP': 8},
    'LIFT': {'X_BOUND': [-16.0, 16.0, 0.5], 'Y_BOUND': [-16.0, 16.0, 0.5],
             'D_BOUND': [2.0, 10.0, 1.0], 'GT_DEPTH': False},
    'MODEL': {'ENCODER': {'NAME': 'efficientnet-b0', 'OUT_CHANNELS': 16},
              'TEMPORAL_MODEL': {'START_OUT_CHANNELS': 16},
              'DISTRIBUTION': {'LATENT_DIM': 16},
              'SMALL_ENCODER': {'FILTER_SIZE': 8},
              'MODALITY': {'USE_CAMERA': True, 'USE_LIDAR': False}},
    'SEMANTIC_SEG': {'PEDESTRIAN': {'ENABLED': False},
                     'HDMAP': {'ENABLED': False}},
    'PROBABILISTIC': {'ENABLED': False},
    'PLANNING': {'ENABLED': True, 'SAMPLE_NUM': 30, 'GRU_STATE_SIZE': 16},
}


@pytest.mark.parametrize('hdmap_head', [False, True])
def test_run_planner_matches_jax(tmp_path, hdmap_head):
    """One validation batch (B 2) of a tree with a CAN bus: the port's
    forecast, then the planner of each package on it, with the same
    weights; the zero map without the map head, the predicted map (moved
    to (B, C, H, W)) with it."""
    root = str(tmp_path / 'nusc')
    mini_nuscenes.make_mini_nuscenes(root, n_scenes=2, n_samples=9,
                                     can_bus=True)
    d = {**TREE_CFG, 'BATCHSIZE': 2,
         'DATASET': {**TREE_CFG['DATASET'], 'DATAROOT': root},
         'SEMANTIC_SEG': {**TREE_CFG['SEMANTIC_SEG'],
                          'HDMAP': {'ENABLED': hdmap_head}}}
    jcfg, pcfg = JConfig().merge_dict(d), PConfig().merge_dict(d)
    _, val = PD.prepare_dataloaders(pcfg)
    batch = next(iter(val))
    val.close()
    if hdmap_head:
        # the loader rasterises no map (as the reference's): a map label
        # for the label warps; the planner takes the predicted map
        batch['hdmap'] = torch.zeros(2, 2, 64, 64, dtype=torch.int64)
    assert np.abs(batch['sample_trajectory'].numpy()).max() > 0
    module = JT.StreamingFlowTrainModule(jcfg)
    jb = jnp_tree({k: v.numpy() for k, v in batch.items()
                   if torch.is_tensor(v)})
    variables = init_jax(module, like=port_like(jcfg, train=True))
    trainer = P.build_trainer(pcfg, device='cpu')
    load_flax_variables(trainer.module, variables)
    _, output, _ = PE.forward_and_labels(trainer, batch, pcfg)
    assert ('hdmap' in output) == hdmap_head
    rf = pcfg.TIME_RECEPTIVE_FIELD
    seg_pred = np.argmax(output['segmentation'], axis=-1)
    got = PE.run_planner(trainer.module.model.planning, pcfg, batch, output,
                         seg_pred, None, 'cpu')
    state = types.SimpleNamespace(apply_fn=module.apply,
                                  params=variables['params'],
                                  batch_stats=variables['batch_stats'])
    with jax.default_matmul_precision('highest'):
        want = jax_evaluate._run_planner(
            state, jcfg, jb, None,
            {k: jax.numpy.asarray(v) for k, v in output.items()
             if isinstance(v, np.ndarray)}, seg_pred, None, rf)
    assert got.shape == (2, pcfg.N_FUTURE_FRAMES, 3)
    assert_close(got, want, 1e-5, 'final_traj')


def test_evaluate_prints_planning_per_future_second(tmp_path, capsys):
    """``run_eval`` with PLANNING.ENABLED and 4 futures: one metric per
    future second, printed and returned, finite, with their summed states,
    over candidates sampled from the CAN bus."""
    root = str(tmp_path / 'nusc')
    mini_nuscenes.make_mini_nuscenes(root, n_scenes=2, n_samples=9,
                                     can_bus=True)
    cfg = PConfig().merge_dict(
        {**TREE_CFG, 'N_FUTURE_FRAMES': 4,
         'DATASET': {**TREE_CFG['DATASET'], 'DATAROOT': root}})
    seen, items = [], []
    planner = PE.run_planner

    def read(planning, cfg, batch, *a, **kw):
        seen.append(float(batch['sample_trajectory'].abs().max()))
        items.append(len(batch['sample_trajectory']))
        return planner(planning, cfg, batch, *a, **kw)

    PE.run_planner = read
    try:
        results = PE.run_eval(cfg, None, device='cpu')
    finally:
        PE.run_planner = planner
    printed = capsys.readouterr().out
    assert len(results['planning']) == 2 and seen and min(seen) > 0
    for j, m in enumerate(results['planning']):
        for k in ('obj_col', 'obj_box_col', 'L2'):
            assert f'planning@{j + 1}s {k}:' in printed
            assert np.isfinite(m[k]).all() and m[k].shape == (2 * (j + 1),)
        state = results['states'][f'planning@{j + 1}s']
        assert state[-1] == sum(items) > 1
    assert len(results['planner_s']) == len(seen)
