"""The import of a reference (PyTorch Lightning) checkpoint into the port,
against the JAX package's conversion of the same state dict.

No reference checkpoint is needed: random JAX variables of the flagship's
channel structure (EfficientNet-B4, spconv8x with 'winfuse', the shipped
yml's temporal, ODE and head widths, PROBABILISTIC on) at a tiny spatial
size are written under the reference's names by inverting the JAX rule
table (tests/torch_reference_names.py).  Then:

* the JAX package's own apply_mapping gives every mapped leaf back, bit for
  bit (the inverse is right);
* the port's import of that state dict equals ``convert.flax_to_state_dict``
  of the same JAX variables, bit for bit (the distribution head, which no
  reference tensor fills, keeps the module's own seeded initialisation on
  both sides);
* the port's report equals the JAX report on the same input, after the
  rule tables' ignore lists;
* a wrong-shaped tensor raises under strict shapes and is missing when
  lenient, as in the JAX package;
* a Lightning-style ``.ckpt`` goes through the port's CLI, and the
  checkpoint it writes restores into a trainer as ``evaluate`` restores it.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from streamingflow_tpu.config import load_cfg as jload_cfg
from streamingflow_tpu.training import trainer as JTR
from streamingflow_tpu.utils import torch_convert as JTC
from streamingflow_tpu_torch.config import Config as PConfig
from streamingflow_tpu_torch.convert import flax_to_state_dict
from streamingflow_tpu_torch.tools import convert_checkpoint as PCLI
from streamingflow_tpu_torch.training.checkpoint import CheckpointManager
from streamingflow_tpu_torch.training.trainer import (
    StreamingFlowTrainModule, build_trainer)
from streamingflow_tpu_torch.utils import torch_convert as PTC

from torch_parity import init_jax, port_like
from torch_reference_names import reference_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'tools'))
import rules_prediction_lc_ode_variable as JRULES  # noqa: E402

PRULES = PCLI.load_rules(PCLI.DEFAULT_RULES)
SEED = 11


def _cfg():
    """The shipped yml (EfficientNet-B4, 64-wide temporal models and
    GRU-ODE, PROBABILISTIC, flow and depth heads) with the reference's
    LiDAR channel flow (spconv8x with 'winfuse', no pre-reduce 1x1 conv;
    the yml's own comment), at the tiny spatial size of tiny_config."""
    cfg = jload_cfg(os.path.join(ROOT, 'configs',
                                 'prediction_lc_ode_variable.yml'))
    cfg.IMAGE.FINAL_DIM = (32, 64)
    cfg.IMAGE.NAMES = ['CAM_FRONT', 'CAM_BACK']
    cfg.LIFT.X_BOUND = [-8.0, 8.0, 0.5]
    cfg.LIFT.Y_BOUND = [-8.0, 8.0, 0.5]
    cfg.LIFT.Z_BOUND = [-10.0, 10.0, 20.0]
    cfg.LIFT.D_BOUND = [2.0, 10.0, 1.0]
    cfg.MODEL.LIDAR.BACKBONE = 'spconv8x'
    cfg.MODEL.LIDAR.PRE_REDUCE_TEMPORAL = False
    cfg.MODEL.LIDAR.TILE_SORTED_POINTS = False
    se = cfg.MODEL.SPARSE_ENCODER
    se.ENGINE = 'column'
    se.Z_FORMULATION = 'winfuse'
    se.POINT_CLOUD_RANGE = [-8.0, -8.0, -4.0, 8.0, 8.0, 3.68]
    se.VOXEL_SIZE = [0.0625, 0.0625, 0.32]
    se.SPARSE_SHAPE = (256, 256, 25)
    se.MAX_VOXELS = 2048
    se.COLUMN_CAPS = [512, 768, 512, 256]
    return cfg


@pytest.fixture(scope='module')
def case():
    cfg = _cfg()
    variables = init_jax(JTR.StreamingFlowTrainModule(cfg), seed=SEED,
                         like=port_like(cfg, train=True))
    flat = {p: np.asarray(v) for p, v in
            JTC.flatten_tree(variables).items()}
    sd = reference_state_dict(flat, JRULES.RULES)
    # the geometry buffers a real checkpoint carries beside the weights
    for k in ('bev_resolution', 'bev_start_position', 'bev_dimension',
              'frustum'):
        sd[k] = np.zeros(3, np.float32)
    return cfg, PConfig().merge_dict(cfg.to_dict()), variables, flat, sd


def _seeded_module(pcfg):
    torch.manual_seed(SEED)
    return StreamingFlowTrainModule(pcfg)


def _ignored(report, rules):
    return PTC.without_ignored(report, rules.IGNORED_TORCH,
                               rules.IGNORED_FLAX)


def test_the_inverse_is_right(case):
    """The JAX package's apply_mapping fills every leaf from the state
    dict, bit for bit, and takes every weight key."""
    _, _, variables, flat, sd = case
    assert 'present_distribution' not in variables['params']['model']
    new, report = JTC.convert_variables(variables, sd, JRULES.RULES)
    new = JTC.flatten_tree(new)
    kept = _ignored(report, JRULES)
    assert kept == {'missing': [], 'unused_torch': []}
    filled = set(report['filled'])
    assert filled == set(flat)
    for p in filled:
        np.testing.assert_array_equal(np.asarray(new[p]), flat[p], err_msg=p)
    # the EfficientNet blocks without an expand conv use the shifted names
    assert 'encoder.backbone._blocks.0._bn0.weight' not in sd
    assert 'encoder.backbone._blocks.0._bn2.weight' in sd


def test_import_equals_the_bridge_bit_for_bit(case):
    _, pcfg, variables, _, sd = case
    torch.manual_seed(SEED)
    state, report = PTC.import_reference_state_dict(pcfg, sd, PRULES.RULES)
    want = flax_to_state_dict(_seeded_module(pcfg), variables)
    assert set(state) == set(want)
    for k, w in want.items():
        assert state[k].dtype == w.dtype, k
        assert torch.equal(state[k], w), k
    head = [p for p in report['missing'] if 'present_distribution' in p]
    assert head, 'the distribution head is reported, not filled'


def test_report_equals_the_jax_report(case):
    pcfg, variables, sd = case[1], case[2], case[4]
    _, jreport = JTC.convert_variables(variables, sd, JRULES.RULES)
    _, preport = PTC.import_reference_state_dict(pcfg, sd, PRULES.RULES)
    assert preport['unused_torch'] == jreport['unused_torch']
    assert _ignored(preport, PRULES) == _ignored(jreport, JRULES)
    assert set(preport['filled']) == set(jreport['filled'])


def test_wrong_shape(case):
    cfg, pcfg, variables, _, sd = case
    key = 'decoder.first_conv.weight'
    bad = dict(sd)
    bad[key] = np.concatenate([sd[key], sd[key][:1]])
    for convert in (lambda s: JTC.convert_variables(variables, bad,
                                                    JRULES.RULES, s),
                    lambda s: PTC.import_reference_state_dict(
                        pcfg, bad, PRULES.RULES, s)):
        with pytest.raises(ValueError, match='first_conv'):
            convert(True)
        _, report = convert(False)
        assert 'params/model/decoder/first_conv/kernel' in report['missing']
        assert key in report['unused_torch']


def test_cli_checkpoint_restores_as_evaluate_does(case, tmp_path, capsys):
    """A ``{'state_dict': {'model.' + key: tensor}}`` checkpoint through
    ``python -m streamingflow_tpu_torch.tools.convert_checkpoint``: one JSON
    line of counts, then the names; the directory it writes restores into
    ``build_trainer`` as ``evaluate --checkpoint`` restores it."""
    cfg, pcfg, variables, _, sd = case
    ckpt = tmp_path / 'reference.ckpt'
    torch.save({'epoch': 19, 'state_dict': {
        'model.' + k: torch.from_numpy(np.array(v)) for k, v in sd.items()}},
        ckpt)
    yml = tmp_path / 'cfg.yml'
    # JSON is YAML
    yml.write_text(json.dumps(cfg.to_dict(), default=list))
    out = tmp_path / 'out'
    result = PCLI.main(['--torch-ckpt', str(ckpt), '--config-file', str(yml),
                        '--out', str(out), 'MODEL.LIDAR.BACKBONE',
                        'spconv8x', 'MODEL.LIDAR.PRE_REDUCE_TEMPORAL',
                        'False'])
    lines = capsys.readouterr().out.splitlines()
    summary = json.loads(lines[0])
    report = result['report']
    assert summary == {**{k: len(v) for k, v in report.items()},
                       'ignored': {'missing': summary['missing'],
                                   'unused_torch': summary['unused_torch']}}
    assert summary['filled'] > 1000 and summary['missing'] > 0
    assert all('present_distribution' in p for p in report['missing'])
    assert lines[1:41] == [f'missing: {p}' for p in report['missing'][:40]]

    manager = CheckpointManager(str(out))
    assert manager.latest_step() == 0
    ecfg = manager.load_cfg()
    assert ecfg.to_dict() == pcfg.to_dict()
    trainer = build_trainer(ecfg, device='cpu', seed=0)
    manager.restore(trainer)
    want = flax_to_state_dict(trainer.module, variables)
    got = trainer.module.state_dict()
    for k, w in want.items():
        if 'present_distribution' in k:
            continue
        assert torch.equal(got[k], w), k


def test_pillar8x_refuses_as_the_jax_tool_does(case):
    """The table maps the reference's sparse LiDAR encoder onto spconv8x.
    Under the yml's pillar8x the LiDAR temporal model's widths differ from
    the reference's: both packages refuse under strict shapes, naming the
    same leaf, and give the same report when lenient (the sparse encoder's
    keys unused, the pillar ladder missing)."""
    sd = case[4]
    cfg = _cfg()
    cfg.MODEL.LIDAR.BACKBONE = 'pillar8x'
    variables = init_jax(JTR.StreamingFlowTrainModule(cfg), seed=SEED,
                         like=port_like(cfg, train=True))
    pcfg = PConfig().merge_dict(cfg.to_dict())
    with pytest.raises(ValueError) as jerr:
        JTC.convert_variables(variables, sd, JRULES.RULES)
    with pytest.raises(ValueError) as perr:
        PTC.import_reference_state_dict(pcfg, sd, PRULES.RULES)
    assert str(perr.value) == str(jerr.value)
    _, jreport = JTC.convert_variables(variables, sd, JRULES.RULES, False)
    _, preport = PTC.import_reference_state_dict(pcfg, sd, PRULES.RULES,
                                                 False)
    assert _ignored(preport, PRULES) == _ignored(jreport, JRULES)
    lidar = [k for k in sd if k.startswith('encoders.lidar.backbone.')]
    assert lidar and set(lidar) <= set(preport['unused_torch'])
