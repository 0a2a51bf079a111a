"""The spconv8x encoder at every other DENSE_TAIL_FROM_STAGE (streamingflow_
tpu_torch/models/lidar_encoder.py) against the JAX package's on the CPU at
the micro size, in eval and train mode (tests/test_torch_lidar_options.py's
``check_setting`` and bars; tail 3 is tests/test_torch_lidar.py's):

- 0: columns all the way, conv_out a column conv into ``to_dense_bev``;
  'winfuse', so K3's plain version runs at stage 3's 64 and stage 4's 128
  channels against the interpret-mode Pallas kernel;
- 1 and 2: the dense grid entered after conv_input or after down1;
- 4 and 5: before stage 4, or before conv_out only.
"""
import pytest

from test_torch_lidar_options import check_setting, micro


@pytest.mark.parametrize('tail,formulation,column_stages', [
    (0, 'winfuse', 4), (1, 'sep', 1), (2, 'sep', 1), (4, 'sep', 3),
    (5, 'sep', 4)])
def test_dense_tail_stage_matches_jax(tail, formulation, column_stages):
    enc = check_setting(micro(formulation=formulation, tail=tail))
    # the column stages' maps (conv_input's stage 1 always) and their
    # capacity counters, as the JAX encoder sows them
    assert len(enc.last_n_dropped) == column_stages
    n_down = min(max(tail - 1, 0), 3) if tail else 3
    assert {k for k in enc.last_diagnostics if 'cap_hit' in k} == {
        f'lidar_column_cap_hit_stage{s + 1}' for s in range(1, n_down + 1)}
