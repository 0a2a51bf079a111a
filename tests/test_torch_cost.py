"""The planner's cost library: streamingflow_tpu_torch/ops/cost.py against
streamingflow_tpu/ops/cost.py on the same seeded numpy inputs, fp32, 1e-5
of each output's scale (the JAX functions run op by op).

Cases: 2- and 4-channel maps (the 4-channel ones are the map head's logits,
through the softmax), an empty lane raster, zero and nonzero target points,
trajectories that leave the grid; the tiny and the flagship grids.  The
host part (``make_cost_grid``, ``polygon_fill``) gives equal cells, and
``lr_divider_cost`` equals a brute force over the lane cells.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import streamingflow_tpu.ops.cost as JC
from streamingflow_tpu.config import Config as JConfig
import streamingflow_tpu_torch.ops.cost as PC

from torch_parity import assert_close, t

GRIDS = {'tiny': ([-8.0, 8.0, 0.5], [-8.0, 8.0, 0.5]),
         'flagship': ([-50.0, 50.0, 0.5], [-50.0, 50.0, 0.5])}
EGO = dict(ego_width=1.85, ego_height=4.084, safety_lambda=1.0)


def grids(name):
    xb, yb = GRIDS[name]
    return JC.make_cost_grid(xb, yb, **EGO), PC.make_cost_grid(xb, yb, **EGO)


def inputs(name, channels=2, empty_lane=False, target='nonzero',
           leave=False, seed=0):
    """trajs (B, N, T, 2), rasters (B, T, H, W), a map of ``channels``,
    target points.  ``leave``: trajectories reaching 1.5x past the grid's
    edge.  Small grids get trajectories within a few metres of the ego."""
    rng = np.random.RandomState(seed)
    (xb, yb), (B, N, T) = GRIDS[name], (2, 6, 4)
    H = int(round((xb[1] - xb[0]) / xb[2]))
    W = int(round((yb[1] - yb[0]) / yb[2]))
    reach = 1.5 * xb[1] if leave else min(6.0, 0.6 * xb[1])
    trajs = rng.uniform(-reach, reach, (B, N, T, 2)).astype(np.float32)
    if name == 'flagship':
        # candidates that sweep through the occupied cells near the ego
        trajs[:, :3] = np.cumsum(rng.uniform(-1.5, 3.0, (B, 3, T, 2)),
                                 axis=2)
    occ = (rng.rand(B, T, H, W) > 0.8).astype(np.float32)
    cv = (rng.rand(B, T, H, W) * 1.2 - 0.1).astype(np.float32)
    if channels == 2:
        hd = (rng.rand(B, 2, H, W) > 0.7).astype(np.float32)
    else:
        hd = rng.randn(B, 4, H, W).astype(np.float32)
    if empty_lane:
        hd[:, :channels // 2] = 0.0 if channels == 2 else np.array(
            [5.0, -5.0], np.float32)[:, None, None]
    tp = {'nonzero': rng.randn(B, 2), 'zero': np.zeros((B, 2))}[target]
    return dict(trajs=trajs, occ=occ, cv=cv, hd=hd,
                tp=tp.astype(np.float32), channels=channels)


def _maps(x):
    h = x['channels'] // 2
    return x['hd'][:, :h], x['hd'][:, h:]


CASES = [dict(name='tiny'), dict(name='tiny', channels=4),
         dict(name='tiny', empty_lane=True),
         dict(name='tiny', channels=4, empty_lane=True),
         dict(name='tiny', target='zero'), dict(name='tiny', leave=True),
         dict(name='flagship'), dict(name='flagship', leave=True,
                                     target='zero')]
IDS = ['-'.join(f'{k}={v}' for k, v in c.items()) for c in CASES]


def _pair(case):
    jg, pg = grids(case['name'])
    x = inputs(**case)
    return jg, pg, x


@pytest.mark.parametrize('case', CASES, ids=IDS)
def test_total_cost_matches_jax(case):
    jg, pg, x = _pair(case)
    lane, drivable = _maps(x)
    cost = JConfig().COST_FUNCTION
    jfc, jfo = JC.total_cost(jg, cost, jnp.asarray(x['cv']),
                             jnp.asarray(x['trajs']), jnp.asarray(x['occ']),
                             jnp.asarray(lane), jnp.asarray(drivable),
                             jnp.asarray(x['tp']))
    pfc, pfo = PC.total_cost(pg, cost, t(x['cv']), t(x['trajs']),
                             t(x['occ']), t(lane), t(drivable), t(x['tp']))
    assert_close(pfc, np.asarray(jfc), 1e-5, 'cost_fc')
    assert_close(pfo, np.asarray(jfo), 1e-5, 'cost_fo')
    assert np.abs(np.asarray(jfo)).max() > 0


SUBCOSTS = {
    'safety': lambda M, g, x, lane, drv: M.safety_cost(
        g, x['trajs'], x['occ'], 1.0, 0.1),
    'headway': lambda M, g, x, lane, drv: M.headway_cost(
        g, x['trajs'], x['occ'], drv, 1.0),
    'lr_divider': lambda M, g, x, lane, drv: M.lr_divider_cost(
        g, x['trajs'], lane, 10.0),
    'comfort': lambda M, g, x, lane, drv: M.comfort_cost(x['trajs'], 0.1),
    'progress': lambda M, g, x, lane, drv: M.progress_cost(
        x['trajs'], x['tp'], 0.5),
    'rule': lambda M, g, x, lane, drv: M.rule_cost(g, x['trajs'], drv),
    'costvolume': lambda M, g, x, lane, drv: M.costvolume_cost(
        g, x['trajs'], x['cv'], 100.0),
    'area_inflated': lambda M, g, x, lane, drv: M.compute_area(
        g, x['occ'], x['trajs'], inflated=True),
    'velocity': lambda M, g, x, lane, drv: M.ego_velocity_profile(
        x['trajs']),
}


@pytest.mark.parametrize('case', CASES[:6], ids=IDS[:6])
@pytest.mark.parametrize('sub', sorted(SUBCOSTS))
def test_sub_costs_match_jax(sub, case):
    jg, pg, x = _pair(case)
    lane, drv = _maps(x)
    fn = SUBCOSTS[sub]
    want = np.asarray(fn(JC, jg, {k: (jnp.asarray(v) if k != 'channels'
                                      else v) for k, v in x.items()},
                         jnp.asarray(lane), jnp.asarray(drv)))
    got = fn(PC, pg, {k: (t(v) if k != 'channels' else v)
                      for k, v in x.items()}, t(lane), t(drv))
    assert_close(got, want, 1e-5, sub)


@pytest.mark.parametrize('case', CASES, ids=IDS)
def test_discretize_matches_jax(case):
    jg, pg, x = _pair(case)
    for got, want in zip(PC.discretize(pg, t(x['trajs'])),
                         JC.discretize(jg, jnp.asarray(x['trajs']))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('name', sorted(GRIDS))
@pytest.mark.parametrize('lam', [0.0, 1.0, 2.0])
def test_cost_grid_and_polygon_fill_equal(name, lam):
    xb, yb = GRIDS[name]
    jg = JC.make_cost_grid(xb, yb, 1.85, 4.084, lam)
    pg = PC.make_cost_grid(xb, yb, 1.85, 4.084, lam)
    for a, b in zip(jg, pg):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    pts = np.random.RandomState(3).uniform(-5, 5, (4, 2))
    pts = pts[np.argsort(np.arctan2(pts[:, 1], pts[:, 0]))]  # convex order
    np.testing.assert_array_equal(PC.polygon_fill(pts), JC.polygon_fill(pts))


def test_lr_divider_matches_bruteforce():
    """The chunked running minimum against the reference's loop over the
    lane cells (LR_divider:264-305), a chunk smaller than the grid."""
    _, g = grids('tiny')
    rng = np.random.RandomState(1)
    B, N, T = 2, 5, 3
    H, W = g.bev_dimension
    lane = np.zeros((B, 1, H, W), np.float32)
    lane[0, 0, 10, 5] = lane[0, 0, 20, 25] = lane[0, 0, 16, 16] = 1.0
    lane[1, 0, 3:6, 30] = 1.0
    trajs = rng.uniform(-6, 6, size=(B, N, T, 2)).astype(np.float32)
    # points on the lane cell (16, 16) and one and two cells beside it
    trajs[0, 0] = [[0.4, 0.3], [0.9, 0.3], [1.4, 0.3]]
    got = PC.lr_divider_cost(g, t(trajs), t(lane), factor=1.0,
                             chunk=100).numpy()
    expect = np.zeros((B, N, T))
    yi = np.clip((trajs[..., 1] - g.bx[0]) / g.dx[0], 0, H - 1).astype(int)
    xi = np.clip((trajs[..., 0] - g.bx[1]) / g.dx[1], 0, W - 1).astype(int)
    for b in range(B):
        cells = np.argwhere(lane[b, 0] > 0)
        for n in range(N):
            for s in range(T):
                yx = np.array([yi[b, n, s], xi[b, n, s]], float)
                d = np.sqrt((((yx - cells) * g.dx[::-1]) ** 2).sum(-1)).min()
                expect[b, n, s] = 0.0 if d > 1.0 else (1.0 - d) ** 2
    assert (expect > 0).any()
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-7)
    # an empty lane raster costs nothing
    zero = PC.lr_divider_cost(g, t(trajs), t(np.zeros_like(lane)), 1.0)
    assert float(zero.abs().max()) == 0.0


def test_progress_flag_is_over_the_whole_batch():
    """One row with a goal switches the goal term on for every row (JAX
    cost.py:274), the coupling a data-parallel rank takes globally."""
    rng = np.random.RandomState(2)
    trajs = t(rng.randn(2, 3, 4, 2).astype(np.float32))
    tp = np.zeros((2, 2), np.float32)
    tp[0] = [3.0, 4.0]
    both = PC.progress_cost(trajs, t(tp), 1.0)
    alone = PC.progress_cost(trajs[1:], t(tp[1:]), 1.0)
    assert not torch.allclose(both[1], alone[0])
    want = JC.progress_cost(jnp.asarray(trajs.numpy()), jnp.asarray(tp), 1.0)
    assert_close(both, np.asarray(want), 1e-6)
