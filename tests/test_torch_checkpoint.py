"""The port's checkpoints (training/checkpoint.py) and the JAX -> port
conversion (convert.save_flax_variables_as_checkpoint).

- a save/restore round trip is exact: parameters, BatchNorm buffers, Adam
  state, step, generator;
- 2 steps in a row equal 1 step, save, restore into another trainer, then
  1 step;
- ``warm_start`` loads every non-decoder tensor of matching shape and
  touches no decoder tensor;
- a JAX orbax checkpoint, carried across, gives the JAX ``eval_forward``'s
  outputs within the forward's bar (5e-3 of each output's scale);
- an orbax directory given to the port raises and names the conversion.
"""
import os

import jax
import numpy as np
import optax
import pytest
import torch

from streamingflow_tpu.data import make_batch, tiny_config
from streamingflow_tpu.training import trainer as JT
from streamingflow_tpu.training.checkpoint import \
    CheckpointManager as JCheckpointManager
import streamingflow_tpu_torch as P
from streamingflow_tpu_torch import evaluate as PE
from streamingflow_tpu_torch.config import Config as PConfig
from streamingflow_tpu_torch.convert import save_flax_variables_as_checkpoint
from streamingflow_tpu_torch.training.checkpoint import (
    FILENAME, CheckpointManager, ForeignCheckpointError, warm_start)

from torch_parity import assert_close, init_jax, jnp_tree, port_like

FORWARD_BAR = 5e-3


def _cfg():
    cfg = tiny_config()
    cfg.MODEL.MODALITY.USE_LIDAR = True
    cfg.MODEL.ENCODER.OUT_CHANNELS = 64
    cfg.PROBABILISTIC.ENABLED = False
    return cfg


def _pcfg():
    return PConfig().merge_dict(_cfg().to_dict())


def _batch(seed):
    return make_batch(_cfg(), 1, seed=seed, n_points=1024)


def _step(trainer, batch, gen):
    return P.train_step(trainer, batch, generator=gen)


def _assert_trees_equal(a, b, what):
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype, what
        assert torch.equal(a, b), what
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), (what, a.keys() ^ b.keys())
        for k in a:
            _assert_trees_equal(a[k], b[k], f'{what}/{k}')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f'{what}[{i}]')
    else:
        assert a == b, (what, a, b)


@pytest.fixture(scope='module')
def stepped():
    """A trainer two steps in, and its generator."""
    trainer = P.build_trainer(_pcfg(), device='cpu', seed=0)
    gen = torch.Generator().manual_seed(3)
    for seed in (1, 2):
        _step(trainer, _batch(seed), gen)
    return trainer, gen


def test_round_trip_is_exact(stepped, tmp_path):
    trainer, gen = stepped
    ckpt = CheckpointManager(str(tmp_path))
    path = ckpt.save(2, trainer, trainer.cfg, generator=gen)
    assert path == os.path.join(str(tmp_path), '2', FILENAME)
    assert ckpt.latest_step() == 2
    raw = torch.load(path, weights_only=True)
    assert raw['step'] == raw['optimizer_step'] == 2
    assert raw['optimizer']['state']

    other = P.build_trainer(ckpt.load_cfg(), device='cpu', seed=9)
    other_gen = torch.Generator().manual_seed(11)
    ckpt.restore(other, generator=other_gen)
    _assert_trees_equal(other.module.state_dict(),
                        trainer.module.state_dict(), 'module')
    _assert_trees_equal(other.optimizer.state_dict(),
                        trainer.optimizer.state_dict(), 'adam')
    assert other.step == trainer.step == 2
    assert torch.equal(other_gen.get_state(), gen.get_state())
    assert any('running_mean' in k for k in raw['model'])


def test_resume_continues_the_run(tmp_path):
    cfg = _pcfg()
    straight = P.build_trainer(cfg, device='cpu', seed=0)
    gen = torch.Generator().manual_seed(3)
    for seed in (1, 2):
        last = _step(straight, _batch(seed), gen)

    first = P.build_trainer(cfg, device='cpu', seed=0)
    gen1 = torch.Generator().manual_seed(3)
    _step(first, _batch(1), gen1)
    ckpt = CheckpointManager(str(tmp_path))
    # labelled as train labels it, by epochs done, not by optimizer steps
    ckpt.save(7, first, cfg, generator=gen1)

    resumed = P.build_trainer(cfg, device='cpu', seed=5)
    gen2 = torch.Generator().manual_seed(7)
    ckpt.restore(resumed, generator=gen2)
    assert resumed.step == 1
    again = _step(resumed, _batch(2), gen2)
    assert resumed.step == straight.step == 2
    _assert_trees_equal(resumed.module.state_dict(),
                        straight.module.state_dict(), 'module')
    _assert_trees_equal(resumed.optimizer.state_dict(),
                        straight.optimizer.state_dict(), 'adam')
    for k, v in last.items():
        assert torch.equal(again[k], v), k


def test_a_cut_save_leaves_the_last_whole_step(stepped, tmp_path):
    trainer, gen = stepped
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, trainer, trainer.cfg)
    # what a run killed while writing step 2 leaves behind
    os.makedirs(tmp_path / '.2.tmp.12345')
    (tmp_path / '.2.tmp.12345' / FILENAME).write_bytes(b'\x80half')
    assert ckpt.latest_step() == 1
    ckpt.restore(P.build_trainer(trainer.cfg, device='cpu'))


def test_warm_start_drops_the_decoder(stepped, tmp_path):
    trainer, _ = stepped
    CheckpointManager(str(tmp_path)).save(2, trainer, trainer.cfg)
    fresh = P.build_trainer(trainer.cfg, device='cpu', seed=4)
    before = {k: v.clone() for k, v in fresh.module.state_dict().items()}
    _, n = warm_start(fresh, str(tmp_path))
    src = trainer.module.state_dict()
    loaded = [k for k in src if 'decoder' not in k
              and not k.endswith('num_batches_tracked')]
    assert n == len(loaded) > 0
    after = fresh.module.state_dict()
    for k in src:
        if 'decoder' in k:
            assert torch.equal(after[k], before[k]), k
        elif k in loaded:
            assert torch.equal(after[k], src[k]), k
    assert any('decoder' in k for k in src)
    assert any(not torch.equal(before[k], src[k]) for k in loaded)


@pytest.fixture(scope='module')
def orbax_run(tmp_path_factory):
    """An orbax checkpoint of the JAX package (random variables, as a JAX
    training run would leave them) and the JAX eval forward on them."""
    cfg = _cfg()
    batch = _batch(4)
    module = JT.StreamingFlowTrainModule(cfg)
    variables = init_jax(module, like=port_like(cfg, train=True))
    state = JT.TrainState.create(
        apply_fn=module.apply, params=variables['params'],
        tx=optax.adam(cfg.OPTIMIZER.LR), batch_stats=variables['batch_stats'])
    directory = str(tmp_path_factory.mktemp('orbax'))
    JCheckpointManager(directory).save(3, state, cfg)
    with jax.default_matmul_precision('highest'):
        want = jax.jit(lambda s, b: JT.eval_forward(s, b, cfg))(
            state, jnp_tree(batch))
    return directory, batch, jax.tree.map(np.asarray, want)


def test_jax_checkpoint_carried_across_gives_the_jax_forward(orbax_run,
                                                             tmp_path):
    directory, batch, want = orbax_run
    jckpt = JCheckpointManager(directory)
    pcfg = PConfig().merge_dict(jckpt.load_cfg().to_dict())
    save_flax_variables_as_checkpoint(jckpt.restore_raw(), pcfg,
                                      str(tmp_path), jckpt.latest_step())
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.latest_step() == 3
    assert ckpt.restore_raw()['optimizer'] is None
    trainer = ckpt.restore(P.build_trainer(ckpt.load_cfg(), device='cpu'))
    got = P.eval_forward(trainer, batch)
    keys = [k for k in want if k != 'diagnostics' and want[k] is not None]
    assert {'segmentation', 'instance_center', 'instance_offset',
            'instance_flow'} <= set(keys)
    for k in keys:
        assert_close(got[k], want[k], FORWARD_BAR, k)


def test_an_orbax_directory_raises(orbax_run):
    directory = orbax_run[0]
    with pytest.raises(ForeignCheckpointError,
                       match='save_flax_variables_as_checkpoint'):
        CheckpointManager(directory).latest_step()
    with pytest.raises(ForeignCheckpointError, match='random weights'):
        PE.main(['--checkpoint', directory, '--device', 'cpu'])
