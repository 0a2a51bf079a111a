"""The port's kernels under ``torch.use_deterministic_algorithms``, as ATen's
ops behave there.  K1 (bin sums) and K2 (the camera pool) add fp32 values
with atomics, in an order that varies from run to run on the card; there
they take their deterministic route, exact 64-bit integer sums in units of
1 / 2^S (``cuda_lib.fixed_point_scale``), which the wrappers prepare and
turn back into fp32.  K1' (the experiment tool's grouped bin sum) has no
such route: it warns under ``warn_only`` and raises otherwise, with ATen's
message, before any work.  The plain versions, which the CPU runs, sum in a
fixed order.  The kernels themselves run only on the card
(chip_smoke.py, phase determinism); here the wrappers' side of each
route."""
import math
import warnings

import numpy as np
import pytest
import torch

from streamingflow_tpu_torch.ops import bin_sum as B
from streamingflow_tpu_torch.ops import cuda_lib
from streamingflow_tpu_torch.ops import patch_pool as PP


@pytest.fixture
def deterministic():
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())

    def set_mode(enabled=True, warn_only=False):
        torch.use_deterministic_algorithms(enabled, warn_only=warn_only)

    yield set_mode
    torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])


@pytest.mark.parametrize('bound', [0.0, 1e-30, 0.7, 1.0, 3.0, 2.0 ** 40,
                                   123456.789, 2.0 ** 70])
def test_fixed_point_scale_keeps_the_sums_in_int64(bound):
    scale = cuda_lib.fixed_point_scale(bound)
    assert math.frexp(scale)[0] == 0.5          # a power of two
    assert bound * scale < 2.0 ** 61
    if 2.0 ** -59 < bound < 2.0 ** 60:
        # the finest such unit (S is capped at 120 for tiny bounds)
        assert bound * scale >= 2.0 ** 60


def test_fixed_point_scale_refuses_what_is_not_finite():
    for bound in (math.inf, math.nan):
        with pytest.raises(ValueError):
            cuda_lib.fixed_point_scale(bound)


def _k1_args():
    data = torch.tensor([[1.0, -3.5], [1.0, 2.0], [1.0, 0.25]])
    ids = torch.zeros(3, dtype=torch.int32)
    return data, ids


def test_grouped_bin_sum_refuses_strict_determinism(deterministic):
    deterministic(warn_only=False)
    data, ids = _k1_args()
    with pytest.raises(RuntimeError, match='^bin_sum_grouped does not have '
                                           'a deterministic implementation'):
        B._bin_sum_cuda(data, ids, 1, 2048, 2048, None, torch.float32, True,
                        4)


def test_grouped_bin_sum_warns_under_warn_only(deterministic):
    deterministic(warn_only=True)
    data, ids = _k1_args()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        with pytest.raises(ValueError, match='CUDA tensors'):
            B._bin_sum_cuda(data, ids, 1, 2048, 2048, None, torch.float32,
                            True, 4)
    assert [str(w.message).split()[0] for w in caught] == ['bin_sum_grouped']


@pytest.mark.parametrize('enabled', [False, True])
def test_bin_sum_route(enabled, deterministic, monkeypatch):
    """K1's wrapper launches the deterministic route (scale 2^S for the
    rows' summed magnitudes, 3 x 3.5) exactly when deterministic algorithms
    are on, and says nothing either way."""
    deterministic(enabled)
    seen = {}
    monkeypatch.setattr(B, 'launch', lambda *a, scale=0.0, **kw:
                        seen.setdefault('scale', scale))
    data, ids = _k1_args()
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        B._bin_sum_cuda(data, ids, 1, 2048, 2048, None, torch.float32, True,
                        None)
    want = cuda_lib.fixed_point_scale(3 * 3.5) if enabled else 0.0
    assert seen['scale'] == want


@pytest.mark.parametrize('enabled', [False, True])
def test_patch_pool_route(enabled, deterministic, monkeypatch):
    """K2's wrapper: under deterministic algorithms an int64 grid and scale
    2^S for a frame's summed magnitudes, turned back into fp32 (the nearest
    float of each exact sum); else the fp32 grid as the kernel leaves it."""
    deterministic(enabled)
    x = torch.full((2, 1, 1, 8, 4, 64), -0.75)
    coords = torch.zeros(2, 1, 1, 8, 4, 2, dtype=torch.int32)
    kept = torch.ones(2, 1, 1, 8, 4, dtype=torch.bool)
    seen = {}

    def fake_launch(x, coords, kept, out, drops, nx, ny, scale=0.0):
        seen['dtype'], seen['scale'] = out.dtype, scale
        out[..., 0] = 3 if scale == 0 else int(3 * scale) + 1

    monkeypatch.setattr(PP, 'launch', fake_launch)
    out, drops = PP._patch_pool_cuda(x, coords, kept, 4, 4)
    assert out.dtype == torch.float32 and out.shape == (2, 4, 4, 64)
    if not enabled:
        assert seen == {'dtype': torch.float32, 'scale': 0.0}
        return
    scale = cuda_lib.fixed_point_scale(0.75 * (1 + 2 ** -8) * 32)
    assert seen == {'dtype': torch.int64, 'scale': scale}
    np.testing.assert_array_equal(
        out[..., 0].numpy(), np.float32((int(3 * scale) + 1) / scale))


def test_plain_versions_run_under_strict_determinism(deterministic):
    deterministic(warn_only=False)
    data = torch.rand(50, 3)
    ids = torch.randint(0, 7, (50,), dtype=torch.int32)
    want = torch.zeros(7, 3).index_add_(0, ids.long(), data)
    torch.testing.assert_close(B.bin_sum(data, ids, 7), want)
    x = torch.rand(1, 1, 1, 8, 4, 64)
    coords = torch.randint(0, 4, (1, 1, 1, 8, 4, 2), dtype=torch.int32)
    kept = torch.ones(1, 1, 1, 8, 4, dtype=torch.bool)
    out, drops = PP.patch_pool_frames(x, coords, kept, 4, 4)
    assert out.shape == (1, 4, 4, 64) and int(drops.sum()) == 0
