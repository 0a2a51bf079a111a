"""The spconv8x encoder's site engines, 'gather' (ops/sparse.py) and
'tiled' (ops/sparse_tiled.py), against the JAX package's on the CPU at the
micro size, in eval and train mode (tests/test_torch_lidar_options.py's
``check_setting`` and bars): with caps the micro clouds do not fill, and
with each engine's own cap overflowing (STAGE_CAPS for 'gather', TILE_CAPS
for 'tiled'), where the two engines compute different functions and each
must equal its JAX engine.
"""
import pytest

from test_torch_lidar_options import check_setting, micro


def _capacity(enc):
    return {k: int(v) for k, v in enc.last_capacity.items()}


@pytest.mark.parametrize('engine', ['gather', 'tiled'])
def test_site_engines_match_jax(engine):
    enc = check_setting(micro(engine))
    assert enc.last_diagnostics == {} and enc.last_n_dropped == {}
    cap = _capacity(enc)
    assert cap['sites_stage1'] > 100
    assert not any(v for k, v in cap.items() if 'hit' in k or 'dropped' in k)


def test_gather_stage_cap_overflow_matches_jax():
    """STAGE_CAPS of tests/test_torch_lidar.py's micro config: stages 2 and
    3 keep their lowest output ids."""
    enc = check_setting(micro('gather', STAGE_CAPS=[512, 256, 128, 64]))
    cap = _capacity(enc)
    assert cap['site_cap_hit_stage2'] and cap['site_cap_hit_stage3']


def test_tiled_tile_cap_overflow_matches_jax():
    """4x4x4 tiles (the micro grids hold one 8x8x8 tile past stage 2),
    capped short of the clouds' at stages 1-3: the highest tiles' sites
    drop from their stage, and outputs whose least contributing input lies
    in a dropped tile read zero."""
    enc = check_setting(micro('tiled', TILE_CAPS=[120, 40, 6, 1],
                              TILE_SHAPE=(4, 4, 4)))
    cap = _capacity(enc)
    assert all(cap[f'tile_dropped_sites_stage{s}'] > 0 for s in (1, 2, 3))
