"""The dormant helpers (ROADMAP item 18), on the cases of
tests/test_utils_misc.py, against the JAX package's: the VGG64 SRVP
encoder and decoder (layers/srvp_vgg.py) at 1e-5 in eval and train mode,
``gen_dx_bx``, ``cumsum_trick``, ``KalmanFilter``, the network helpers and
the planning and instance-map plots equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamingflow_tpu.config import Config as JConfig
from streamingflow_tpu.layers import srvp_vgg as JV
from streamingflow_tpu.utils import network as JN
from streamingflow_tpu.utils import tools as JTo
from streamingflow_tpu.utils import visualisation as JVis
from streamingflow_tpu_torch.config import Config as PConfig
from streamingflow_tpu_torch.convert import flatten, load_flax_variables, \
    state_to_flax
from streamingflow_tpu_torch.layers import srvp_vgg as PV
from streamingflow_tpu_torch.utils import network as PN
from streamingflow_tpu_torch.utils import tools as PTo
from streamingflow_tpu_torch.utils import visualisation as PVis

from torch_parity import apply_jax, assert_close, init_jax, nchw, t


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope='module')
def encoder():
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    jm = JV.VGG64Encoder(nh=16, nf=8)
    variables = init_jax(jm, jnp.asarray(x), return_skip=True)
    return x, jm, variables


@pytest.mark.parametrize('train', [False, True])
def test_vgg64_encoder_matches_jax(encoder, train):
    x, jm, variables = encoder
    kw = dict(train=True, mutable=['batch_stats']) if train else {}
    out = apply_jax(jm, variables, jnp.asarray(x), return_skip=True, **kw)
    (z, skips) = out[0] if train else out
    pm = load_flax_variables(PV.VGG64Encoder(3, 16, 8), variables)
    pm.train(train)
    pz, pskips = pm(nchw(x), return_skip=True)
    assert z.shape == (2, 1, 1, 16)
    assert_close(_nhwc(pz), z, 1e-5, 'z')
    assert [s.shape[2] for s in pskips] == [8, 16, 32, 64]
    for i, (g, w) in enumerate(zip(pskips, skips)):
        assert_close(_nhwc(g), w, 1e-5, f'skip {i}')
    if train:
        stats = state_to_flax(pm)['batch_stats']
        for k, w in flatten(out[1]['batch_stats']).items():
            assert_close(stats[k], w, 1e-5, k)


@pytest.mark.parametrize('skip', [False, True])
def test_vgg64_decoder_matches_jax(encoder, skip):
    x, jm, variables = encoder
    z, skips = apply_jax(jm, variables, jnp.asarray(x), return_skip=True)
    jd = JV.VGG64Decoder(nc=3, nf=8, skip=skip)
    sk = [jnp.asarray(s) for s in skips] if skip else None
    dvars = init_jax(jd, jnp.asarray(z), skip=sk, seed=1)
    want = apply_jax(jd, dvars, jnp.asarray(z), skip=sk)
    pd = load_flax_variables(PV.VGG64Decoder(16, 3, 8, skip=skip),
                             dvars).eval()
    got = pd(nchw(z), skip=[nchw(s) for s in skips] if skip else None)
    assert want.shape == (2, 64, 64, 3)
    assert_close(_nhwc(got), want, 1e-5)
    with pytest.raises(ValueError):
        pd(nchw(z), skip=None if skip else [nchw(s) for s in skips])


def test_gen_dx_bx_equal():
    for bounds in (([-50, 50, 0.5], [-50, 50, 0.5], [-10, 10, 20]),
                   ([-8.0, 8.0, 0.25], [-16.0, 16.0, 0.5], [-4, 4, 1])):
        for a, b in zip(PTo.gen_dx_bx(*bounds), JTo.gen_dx_bx(*bounds)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('seed', [0, 1])
def test_cumsum_trick_matches_jax(seed):
    rng = np.random.RandomState(seed)
    ranks = np.sort(rng.randint(0, 6, size=32)).astype(np.int32)
    x = rng.randn(32, 3).astype(np.float32)
    jsums, jkept = JTo.cumsum_trick(jnp.asarray(x), jnp.asarray(ranks))
    sums, kept = PTo.cumsum_trick(t(x), t(ranks))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jkept))
    assert_close(sums, np.asarray(jsums), 1e-5)
    for r in np.unique(ranks):
        end = np.where(ranks == r)[0][-1]
        np.testing.assert_allclose(sums[end].numpy(), x[ranks == r].sum(0),
                                   rtol=1e-5, atol=1e-5)


def test_kalman_filter_equal():
    obs = np.stack([np.arange(10) * 1.0, np.sin(np.arange(10))], axis=-1)
    want = JTo.KalmanFilter(dt=0.5).track(obs)
    got = PTo.KalmanFilter(dt=0.5).track(obs)
    np.testing.assert_array_equal(got, want)
    assert abs(got[-1, 0] - 9.0) < 0.5


def test_network_helpers_equal():
    x = np.random.RandomState(2).randn(2, 3, 4, 5).astype(np.float32)
    packed = PN.pack_sequence_dim(t(x))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(JN.pack_sequence_dim(x)))
    np.testing.assert_array_equal(
        PN.unpack_sequence_dim(packed, 2, 3).numpy(),
        np.asarray(JN.unpack_sequence_dim(np.asarray(packed), 2, 3)))
    batch = {'a': x, 'name': 'scene-0000', 'n': 3}
    want = JN.preprocess_batch(batch)
    got = PN.preprocess_batch(batch, device='cpu')
    assert torch.is_tensor(got['a']) and got['a'].device.type == 'cpu'
    np.testing.assert_array_equal(got['a'].numpy(), np.asarray(want['a']))
    assert got['name'] == want['name'] and got['n'] == want['n']


def test_plots_equal():
    rng = np.random.RandomState(3)
    inst = rng.randint(0, 30, (24, 32))
    bg = rng.randint(0, 255, (24, 32, 3)).astype(np.uint8)
    for kw in ({}, {'instance_map': {3: 1, 7: 2, 29: 3}}, {'bg_image': bg}):
        np.testing.assert_array_equal(PVis.plot_instance_map(inst, **kw),
                                      JVis.plot_instance_map(inst, **kw))
    assert {k: v.tolist() for k, v in
            PVis.generate_instance_colours({1: 0, 24: 1}).items()} == \
        {k: v.tolist() for k, v in
         JVis.generate_instance_colours({1: 0, 24: 1}).items()}
    hd = (rng.rand(200, 200, 2) > 0.8).astype(np.float32)
    traj = np.cumsum(rng.uniform(-1, 3, (6, 3)), 0)
    traj[-1] = [80.0, 0.0, 0.0]                    # off the grid
    got = PVis.plot_planning(hd, traj, PConfig())
    np.testing.assert_array_equal(got, JVis.plot_planning(hd, traj,
                                                          JConfig()))
    assert (got == [214, 39, 40]).all(-1).any()
