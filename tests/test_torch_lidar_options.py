"""The spconv8x encoder's other settings (streamingflow_tpu_torch/models/
lidar_encoder.py) against the JAX package's on the CPU: the z formulations
'sep', 'banded', 'conv' and 'win' on the column engine (and 'win' with
forced drops), each with the same converted variables; one state_dict
loaded strictly into every setting; unknown values refused.  The helpers
serve tests/test_torch_lidar_engines.py ('gather', 'tiled'),
test_torch_lidar_tails.py (DENSE_TAIL_FROM_STAGE) and
test_torch_lidar_options_grad.py (gradients).

Each setting at the micro size of tests/test_torch_lidar.py, with caps
that the micro clouds do not fill (ROOMY): the eval
output within 1e-4 of its scale (the encoder's bar), and in train mode the
output within 1e-4, the updated running statistics within 1e-5 and the
sown diagnostics equal.  One jit a setting computes both modes on the JAX
side.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from streamingflow_tpu.models import lidar_encoder as JL
from streamingflow_tpu_torch.convert import flatten, state_to_flax
from streamingflow_tpu_torch.models import lidar_encoder as PL

from test_torch_lidar import _micro_se, _port_se
from torch_parity import assert_close, init_jax, port, t


def points():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-4, 4, size=(1, 2, 256, 5)).astype(np.float32)
    pts[..., 2] = rng.uniform(-4, 3.5, size=(1, 2, 256))
    return pts


# caps with room for the micro clouds (test_torch_lidar.py's fill the
# column and site caps of stage 2: the overflow cases use those)
ROOMY = dict(STAGE_CAPS=[512, 1024, 512, 256],
             COLUMN_CAPS=[256, 512, 256, 128])


def micro(engine='column', formulation='sep', tail=3, **changes):
    cfg = _micro_se(formulation)
    cfg.ENGINE = engine
    cfg.DENSE_TAIL_FROM_STAGE = tail
    changes = {**ROOMY, **changes}
    for k, v in changes.items():
        setattr(cfg, k, v)
    return cfg


def jax_both_modes(cfg, pts):
    """The JAX encoder's eval output, train-mode output, updated
    batch_stats and diagnostics, one jit."""
    module = JL.LidarBEVEncoder(cfg)
    variables = init_jax(module, jnp.asarray(pts))

    def run(v, p):
        ev = module.apply(v, p)
        tr, upd = module.apply(v, p, train=True,
                               mutable=['batch_stats', 'diagnostics'])
        return ev, tr, upd

    with jax.default_matmul_precision('highest'):
        ev, tr, upd = jax.jit(run)(variables, jnp.asarray(pts))
    diag = {k.split('/')[-1]: int(np.asarray(v).reshape(-1)[0])
            for k, v in flatten(upd.get('diagnostics', {})).items()}
    return variables, np.asarray(ev), np.asarray(tr), \
        flatten(upd['batch_stats']), diag


def check_setting(cfg, pts=None):
    """Hold the port's encoder at cfg against the JAX one in both modes;
    returns the port's encoder after its train-mode forward."""
    pts = points() if pts is None else pts
    variables, ev, tr, stats, diag = jax_both_modes(cfg, pts)
    enc = port(PL.LidarBEVEncoder(_port_se(cfg)), variables)
    with torch.no_grad():
        got = enc(t(pts))
    assert_close(got.permute(0, 1, 3, 4, 2), ev, 1e-4, 'eval output')
    assert float(np.abs(ev).max()) > 1e-2
    enc.train()
    with torch.no_grad():
        got = enc(t(pts))
    assert_close(got.permute(0, 1, 3, 4, 2), tr, 1e-4, 'train output')
    got_stats = state_to_flax(enc)['batch_stats']
    assert set(got_stats) == set(stats)
    for k, w in stats.items():
        assert_close(got_stats[k], w, 1e-5, f'batch_stats {k}')
    assert {k: int(v) for k, v in enc.last_diagnostics.items()} == diag
    return enc


@pytest.mark.parametrize('formulation', ['sep', 'banded', 'conv', 'win'])
def test_z_formulations_match_jax(formulation):
    enc = check_setting(micro(formulation=formulation))
    assert [int(v.sum()) for v in enc.last_n_dropped.values()] == [0, 0]


def test_win_overflow_matches_jax():
    """'win' with a window too short for its blocks and one residual
    block: side taps drop, counted as the JAX plan counts them, and the
    encoder still equals the JAX one."""
    enc = check_setting(micro(formulation='win', WINDOW_WIDTH=4,
                              WINDOW_RESID_BLOCKS=1))
    assert int(enc.last_n_dropped['stage1'].sum()) > 0


def test_sep_banded_and_conv_take_one_route():
    """The three formulations are one function in the port: equal outputs
    bit for bit, the same taps."""
    pts = t(points())
    outs = []
    for form in ('sep', 'banded', 'conv'):
        torch.manual_seed(0)
        enc = PL.LidarBEVEncoder(_port_se(micro(formulation=form))).eval()
        with torch.no_grad():
            outs.append(enc(pts))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


SETTINGS = [('column', f, d) for f in PL.FORMULATIONS
            for d in PL.DENSE_TAIL_STAGES] + [
    ('gather', 'sep', 3), ('tiled', 'sep', 3)]


def test_one_state_dict_loads_into_every_setting():
    """The parameter tree is the same under every engine, formulation and
    tail stage: one state_dict loads strictly into each, and each gives
    the 'sep' tail-3 output where no cap is hit (the micro clouds hit
    none)."""
    pts = t(points())
    torch.manual_seed(0)
    ref = PL.LidarBEVEncoder(_port_se(micro())).eval()
    sd = ref.state_dict()
    with torch.no_grad():
        want = ref(pts)
    for engine, form, tail in SETTINGS:
        enc = PL.LidarBEVEncoder(_port_se(micro(engine, form, tail)))
        enc.load_state_dict(sd, strict=True)
        with torch.no_grad():
            got = enc.eval()(pts)
        assert_close(got, want.numpy(), 1e-5, f'{engine} {form} {tail}')


@pytest.mark.parametrize('key,value', [
    ('ENGINE', 'sparse'), ('ENGINE', 'columns'), ('Z_FORMULATION', 'taps'),
    ('DENSE_TAIL_FROM_STAGE', 6)])
def test_unknown_values_are_refused(key, value):
    se = _port_se(micro())
    setattr(se, key, value)
    with pytest.raises(ValueError, match=key):
        PL.LidarBEVEncoder(se)


def test_micro_config_is_the_jax_one():
    """The port's config carries every SPARSE_ENCODER field the tests set."""
    cfg = micro('tiled', 'win', 0, TILE_CAPS=[8, 4, 2, 1])
    se = _port_se(cfg)
    for f in dataclasses.fields(cfg):
        got, want = getattr(se, f.name), getattr(cfg, f.name)
        assert (list(got) if isinstance(got, (list, tuple)) else got) == \
            (list(want) if isinstance(want, (list, tuple)) else want), f.name
