"""Experiment: does the grouped bin-sum kernel beat the shipped one?

    python3 -m streamingflow_tpu_torch.tools.exp_bin_variants [k_tiles ...]

Port of the JAX package's tools/exp_bin_variants.py.  The pillar bin-sum
(ops/bin_sum.py::bin_sum, one 2048-bin tile a block) is compared with
:func:`~streamingflow_tpu_torch.ops.bin_sum.bin_sum_grouped` (``k_tiles``
consecutive tiles a block, an empty tile written as zeros without
accumulating) on the same bench-like rows: 5 clouds of 80k points on the
1600 x 1600 pillar grid, host-sorted by pillar id, pillar epilogue, bf16
out.  Each ``k_tiles`` (4, 8 and 16 unless given) is first held against the
shipped kernel and against the plain PyTorch version, then timed with CUDA
events over the 5 clouds.  Prints one JSON line with the card's name and
power limit.  Needs a CUDA card; raises without one.
"""
from __future__ import annotations

import json
import subprocess
import sys
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import bin_sum as B

POINT_CLOUD_RANGE = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)
VOXEL_SIZE = (0.0625, 0.0625, 0.2)
N_Z_BINS = 8
N_FEAT = 5
# bf16 outputs: an fp32 sum in another order may round to the next bf16
# value (rel 2^-8)
TOLERANCE = dict(rtol=2 ** -7, atol=1e-2)


def bench_rows(n_clouds: int = 5, n_points: int = 80000, seed: int = 0
               ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Sorted (data (T, P, 15), ids (T, P), n_bins) rows of synthetic clouds
    with bench-like spatial statistics, built as the pillar encoder builds
    them: [1, point, z^2, one_hot(z bin)], zero for a dropped point, the
    trash bin nx * ny for a point outside the grid."""
    rng = np.random.default_rng(seed)
    pc, vs = POINT_CLOUD_RANGE, VOXEL_SIZE
    shape = (n_clouds, n_points)
    r = np.abs(rng.normal(0.0, 22.0, shape))
    th = rng.uniform(0, 2 * np.pi, shape)
    flat = np.stack([r * np.cos(th), r * np.sin(th),
                     rng.uniform(-3.0, 1.0, shape), rng.uniform(0, 1, shape),
                     rng.uniform(0, 0.5, shape)], axis=-1).astype(np.float32)
    nx = int(round((pc[3] - pc[0]) / vs[0]))
    ny = int(round((pc[4] - pc[1]) / vs[1]))
    datas, idss = [], []
    for pts in flat:
        pmask = np.any(pts[:, :3] != 0, axis=-1)
        cx = np.floor((pts[:, 0] - pc[0]) / vs[0]).astype(np.int32)
        cy = np.floor((pts[:, 1] - pc[1]) / vs[1]).astype(np.int32)
        z = pts[:, 2]
        inb = ((cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
               & (z >= pc[2]) & (z < pc[5]) & pmask)
        pid = np.where(inb, cx * ny + cy, nx * ny).astype(np.int32)
        zbin = np.clip(((z - pc[2]) / (pc[5] - pc[2]) * N_Z_BINS
                        ).astype(np.int32), 0, N_Z_BINS - 1)
        data = np.concatenate(
            [np.ones((n_points, 1), np.float32), pts, (z * z)[:, None],
             np.eye(N_Z_BINS, dtype=np.float32)[zbin]], axis=-1)
        data = np.where(inb[:, None], data, 0.0).astype(np.float32)
        order = np.argsort(pid, kind='stable')
        datas.append(data[order])
        idss.append(pid[order])
    return np.stack(datas), np.stack(idss), nx * ny + 1


def _event_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run(k_list: Sequence[int] = (4, 8, 16), device=None, n_clouds: int = 5,
        n_points: int = 80000, reps: int = 10) -> Dict:
    """Check every ``k_tiles`` of ``k_list`` against the shipped kernel and
    the plain version, then time them (on a CUDA device; a CPU run, where
    every wrapper takes the plain version, checks only)."""
    dev = resolve_device(device)
    datas, idss, n_bins = bench_rows(n_clouds, n_points)
    datas = torch.from_numpy(datas).to(dev)
    idss = torch.from_numpy(idss).to(dev)
    kw = dict(pillar_features=N_FEAT, out_dtype=torch.bfloat16,
              presorted=True)

    def over_clouds(fn, **extra):
        return [fn(datas[i], idss[i], n_bins, **kw, **extra)
                for i in range(n_clouds)]

    tiles = torch.unique(idss[0] // B.BINS_PER_TILE).numel()
    result = {'n_tiles': -(-n_bins // B.BINS_PER_TILE),
              'nonempty_tiles_cloud0': int(tiles), 'clouds': n_clouds,
              'points': n_points, 'tolerance': TOLERANCE,
              'max_abs_diff_vs_bin_sum': {}, 'max_abs_diff_vs_plain': {}}
    base = torch.stack(over_clouds(B.bin_sum)).float()
    plain = torch.stack([
        B.bin_sum_plain(datas[i], idss[i], n_bins, N_FEAT, torch.bfloat16)
        for i in range(n_clouds)]).float()
    for k in k_list:
        got = torch.stack(over_clouds(B.bin_sum_grouped, k_tiles=k)).float()
        for name, want in (('bin_sum', base), ('plain', plain)):
            if not torch.allclose(got, want, **TOLERANCE):
                raise AssertionError(
                    f'bin_sum_grouped k_tiles={k} disagrees with {name}: '
                    f'max abs {float((got - want).abs().max()):.3g}')
            result[f'max_abs_diff_vs_{name}'][str(k)] = float(
                (got - want).abs().max())
    if dev.type != 'cuda':
        return result
    result['bin_sum_ms_5_clouds'] = _event_ms(
        lambda: over_clouds(B.bin_sum), reps)
    result['grouped_ms_5_clouds'] = {
        str(k): _event_ms(lambda: over_clouds(B.bin_sum_grouped, k_tiles=k),
                          reps) for k in k_list}
    result['card'] = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return result


def main(argv=None):
    ks = [int(a) for a in (sys.argv[1:] if argv is None else argv)]
    print(json.dumps(run(ks or (4, 8, 16))))


if __name__ == '__main__':
    main()
