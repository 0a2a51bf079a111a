#!/usr/bin/env python3
"""Card gate of the PyTorch port: build its CUDA kernels, hold each against
its plain PyTorch version, serve full-width forecasts and take full-width
training steps on one GPU.

    python3 chip_smoke.py [--requests 3] [--train-steps 3]
                          [--out runs/chip_smoke.json]

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit.  Phases, each printing one JSON line:

  1. device      the card, and nvidia-smi's name and power limit
  2. build       nvcc of every csrc/*.cu (and the pool's loads-only
                 variant), all at once, with its time
  3. bin_sum     kernel vs plain version at flagship shapes (one 80k-point
                 cloud, 1600^2 pillar grid, pillar epilogue, bf16 out,
                 presorted and unsorted; raw fp32 sums too; a hot trash bin
                 holding half the rows); its time alone on prepared inputs
                 and through its wrapper, the raw fp32 mode against
                 index_add_ into a grid zeroed in the same call; the 5
                 clouds of a request in one launch (pillarize_batch) against
                 the per-cloud loop and torch.stack
  4. patch_pool  K2 vs plain version at flagship shapes (3 frames x 6
                 cameras x 48 depth bins x 28 x 60 x 64 from the synthetic
                 calibration) in bf16 and in fp32 rows, fp32 rows on bf16
                 rounding ties, one cell a group and one cell a row (exact
                 for tie rows), a ragged width and a forced overflow, drops
                 equal in every case; its time through the wrapper and
                 alone, in bf16 and fp32, against its bounds and the cast it
                 saves; the row-atomic design it replaced with and without
                 its atomics, and its own loads alone; its reductions
                 (runs) counted from the coords, its ptxas report; the
                 lift's depth x feature product and permute
  5. winfuse     K3 vs plain version at flagship geometry (the 5 clouds of
                 one request voxelized into columns: conv_input 5->16 and
                 stage 1 16->16 at nz 41, stage 2 32->32 at nz 21 behind the
                 plain down1, bf16 on the tensor cores and fp32 on the CUDA
                 cores; 16->16 at the tiny config's nz 25) and a forced-drop
                 plan, with the route of each case and the kernels' ptxas
                 report (registers, spills)
  6. tiny        a tiny camera+LiDAR forward on the card (kernels) vs the
                 same weights on the CPU (plain versions)
  7. tiny_spconv the same on the spconv8x backbone ('winfuse')
  8. tiny_bf16   the bf16 forward of both tiny configurations on the card
                 vs the CPU's fp32 forward, at a bar derived from the CPU's
                 own bf16 forward
  9. forward     the flagship forward (bench.py's full_cfg: 6 cameras at
                 224x480 with EfficientNet-B4, 5 clouds of 80k points on the
                 pillar8x backbone, 200x200 BEV, variable-step GRU-ODE,
                 3 past frames -> 4 futures) in bf16, answering --requests
                 requests with kernel launch counts read around them
 10. forward_spconv  the same on the spconv8x backbone (full_cfg with
                 STREAMINGFLOW_BENCH_BACKBONE=spconv8x, ZFORM=winfuse)
 11. bin_sum_grouped  the grouped bin-sum kernel vs the plain version and vs
                 bin_sum at the same cloud (presorted and unsorted, bf16 and
                 raw fp32, k_tiles 4 / 8 / 16, alone and through the
                 wrapper; the hot trash bin), then the experiment tool
                 (tools/exp_bin_variants.py of the port: 5 bench-like clouds)
                 with the kernel's launches read around it
 12. patch_pool_bwd  the pool's gradient on the card (backward kernel) vs the
                 plain version's autograd gradient at flagship shapes and in
                 the forced-overflow case
 13. train_tiny  one tiny camera+LiDAR training step on the card (kernels)
                 vs the same step on the CPU (plain versions), both in float64
 14. train       --train-steps flagship training steps (fp32 parameters,
                 batch 1, MODEL.REMAT as configured) after one warm-up, with
                 the kernel launch counts read around each step (K2 on the
                 fp32 rows, uncast)
 15. cli         the port's entry points on the nuScenes data path: a
                 flagship-size tree written from a seed (6 cameras at
                 1600x900, 20 Hz LiDAR of 34,720-point sweeps, 20 moving
                 boxes a scene, 2 scenes of 9 keyframes), the host time of
                 an item's parts, the loader's host time a batch at 0 and
                 at N_WORKERS workers, train.main on
                 configs/prediction_lc_ode_variable.yml with the
                 'pallas_patch' pool for one epoch (3 steps, validation, a
                 checkpoint reloaded and held equal to the trained state),
                 then evaluate.main on that checkpoint; K1, K2 and K2's
                 backward counted around each step and each forecast
 16. kernels     every kernel of the port with its launches, error and times
                 (cli_launches: of phase cli); then a check that every
                 process a phase started (nvcc, the loaders' workers, their
                 fork server and resource tracker) has ended

The last line is {"ok": true, "device": {...}}.  Any failed phase raises, so
the script exits non-zero with no result; so does a machine without CUDA,
and a directory without the port beside this script.  TF32 is off for both
matmuls and cuDNN convolutions (torch.backends.cuda.matmul.allow_tf32 =
torch.backends.cudnn.allow_tf32 = False): fp32 work runs in full fp32.
"""
import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM peaks (NVIDIA data sheet, at 700 W): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores, dense bf16 FLOP/s of the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Mean device time of fn over reps launches (CUDA events)."""
    import torch
    for _ in range(warmup):
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


def max_err(got, want):
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    return float(diff.max()), float((diff / want.abs().clamp(min=1e-6)).max())


def check_close(name, got, want, rtol, atol):
    import torch
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        a, r = max_err(got, want)
        raise AssertionError(f'{name}: kernel disagrees with its plain '
                             f'version (max abs {a:.3g}, max rel {r:.3g}; '
                             f'rtol {rtol}, atol {atol})')


def flagship_clouds(cfg, dev):
    """The 5 tile-sorted flagship clouds of one request (80k points each,
    1600^2 pillars) and their point masks, as the model takes them."""
    import torch
    from streamingflow_tpu_torch.data import make_batch
    pts = torch.from_numpy(make_batch(cfg, 1, seed=0, n_points=80000)
                           ['points'][0]).to(dev)
    return pts, (pts[..., :3] != 0).any(-1)


def flagship_cloud_rows(cfg, dev):
    """The bin-sum rows of one flagship cloud (80k points, 1600^2 pillars):
    data (P, 15), pillar ids, bins, point features."""
    from streamingflow_tpu_torch.models.pillar_encoder import (pillar_grid,
                                                               pillar_rows)
    se = cfg.MODEL.SPARSE_ENCODER
    pts, mask = flagship_clouds(cfg, dev)
    data, pid = pillar_rows(pts[0], mask[0], se.POINT_CLOUD_RANGE,
                            se.VOXEL_SIZE)
    nx, ny = pillar_grid(se.POINT_CLOUD_RANGE, se.VOXEL_SIZE)
    return data, pid, nx * ny + 1, pts.shape[-1]


def bin_sum_bound_ms(data, pid, n_bins, out_bytes=2):
    """Rows and ids read once, the (C, n_bins) output written once (bf16
    unless ``out_bytes`` says otherwise); one add a value and a
    four-operation epilogue a bin."""
    c = data.shape[1]
    n_bytes = data.numel() * 4 + pid.numel() * 4 + c * n_bins * out_bytes
    flops = data.numel() + n_bins * c * 4
    return max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3, n_bytes


# bf16 outputs: fp32 sums in another order may round to the next bf16 value
# (rel 2^-8); rtol 2^-7 with atol 1e-2 for values near zero.  Raw fp32 sums
# differ by reassociation only.
BF16_TOL = dict(rtol=2 ** -7, atol=1e-2)
FP32_TOL = dict(rtol=1e-5, atol=1e-4)


def hot_trash_case(name, fn, data, pid, n_bins, n_feat, **extra):
    """Every other row moved to the trash bin n_bins - 1 (40k rows on one
    bin, one block's work): the pillar epilogue in bf16, presorted by a
    stable sort and unsorted, and raw fp32 sums of integer-valued rows
    (exact in any order), each against the plain version; returns the
    errors and the time of the presorted bf16 call."""
    import torch
    from streamingflow_tpu_torch.ops import bin_sum as B
    hot = pid.clone()
    hot[::2] = n_bins - 1
    hot_sorted, order = torch.sort(hot, stable=True)
    data_sorted = data[order]
    kw = dict(pillar_features=n_feat, out_dtype=torch.bfloat16,
              transposed_out=True)
    want = B.bin_sum_plain(data, hot, n_bins, **kw)
    errs = {}
    for presorted, d, i in ((True, data_sorted, hot_sorted),
                            (False, data, hot)):
        got = fn(d, i, n_bins, presorted=presorted, **kw, **extra)
        torch.cuda.synchronize()
        check_close(f'{name} hot trash bin presorted={presorted}', got, want,
                    **BF16_TOL)
        errs[f'bf16_presorted={presorted}'] = max_err(got, want)[0]
    gen = torch.Generator(device=data.device).manual_seed(2)
    ints = torch.randint(-8, 9, data.shape, device=data.device,
                         generator=gen).float()
    raw_want = B.bin_sum_plain(ints, hot, n_bins, transposed_out=True)
    raw = fn(ints[order], hot_sorted, n_bins, presorted=True,
             transposed_out=True, **extra)
    torch.cuda.synchronize()
    check_close(f'{name} hot trash bin raw fp32', raw, raw_want, **FP32_TOL)
    errs['raw_fp32'] = max_err(raw, raw_want)[0]
    ms = cuda_ms(lambda: fn(data_sorted, hot_sorted, n_bins, presorted=True,
                            **kw, **extra))
    return dict(trash_rows=int((hot == n_bins - 1).sum()), max_abs_err=errs,
                wrapper_ms=ms)


def kernel_alone_ms(data, pid, n_bins, n_feat, out_dtype, k_tiles=None):
    """The kernel's time on prepared inputs: tile bounds and output made
    beforehand, one launch a call."""
    import torch
    from streamingflow_tpu_torch.ops import bin_sum as B
    bounds = B.tile_bounds(pid, n_bins)
    out = torch.empty(1, data.shape[1], B.padded_bins(n_bins),
                      dtype=out_dtype, device=data.device)
    return cuda_ms(lambda: B.launch(data, pid, bounds, out, n_bins, n_bins,
                                    n_bins, n_feat, k_tiles))


def phase_bin_sum(cfg, dev, results):
    """K1 at one flagship cloud (alone, through its wrapper, raw fp32 against
    index_add_, the hot trash bin), then the 5 clouds of one request in one
    launch against the per-cloud loop and torch.stack."""
    import torch
    from streamingflow_tpu_torch.models import pillar_encoder as PE
    from streamingflow_tpu_torch.ops import bin_sum as B
    data, pid, n_bins, n_feat = flagship_cloud_rows(cfg, dev)
    c = data.shape[1]
    kw = dict(pillar_features=n_feat, out_dtype=torch.bfloat16,
              transposed_out=True)
    want = B.bin_sum_plain(data, pid, n_bins, **kw)
    errs = []
    for presorted in (True, False):
        got = B.bin_sum(data, pid, n_bins, presorted=presorted, **kw)
        torch.cuda.synchronize()
        check_close(f'bin_sum presorted={presorted}', got, want, **BF16_TOL)
        errs.append(max_err(got, want))
    # raw fp32 sums (no epilogue), rows shuffled: fp32 reassociation only
    perm = torch.randperm(data.shape[0], device=dev)
    raw = B.bin_sum(data[perm], pid[perm], n_bins, transposed_out=True)
    raw_want = B.bin_sum_plain(data, pid, n_bins, transposed_out=True)
    torch.cuda.synchronize()
    check_close('bin_sum raw fp32', raw, raw_want, **FP32_TOL)
    hot = hot_trash_case('bin_sum', B.bin_sum, data, pid, n_bins, n_feat)

    ms = kernel_alone_ms(data, pid, n_bins, n_feat, torch.bfloat16)
    wrapper_ms = cuda_ms(lambda: B.bin_sum(data, pid, n_bins, presorted=True,
                                           **kw))
    raw_ms = kernel_alone_ms(data, pid, n_bins, None, torch.float32)
    plain_ms = cuda_ms(lambda: B.bin_sum_plain(data, pid, n_bins, **kw))
    ids64 = pid.long()
    # the honest yardstick of the raw fp32 mode: a zeroed grid and the
    # scatter, both inside the timed call
    library_ms = cuda_ms(lambda: torch.zeros(n_bins, c, device=dev)
                         .index_add_(0, ids64, data))
    bound_ms, n_bytes = bin_sum_bound_ms(data, pid, n_bins)
    raw_bound_ms = bin_sum_bound_ms(data, pid, n_bins, out_bytes=4)[0]

    # the model's path: 5 clouds, one launch, against the per-cloud loop
    se = cfg.MODEL.SPARSE_ENCODER
    pts, mask = flagship_clouds(cfg, dev)
    args = (se.POINT_CLOUD_RANGE, se.VOXEL_SIZE)

    def batched():
        return PE.pillarize_batch(pts, mask, *args, out_dtype=torch.bfloat16,
                                  presorted=True)

    def loop():
        return torch.stack([
            PE.pillarize(pts[i], mask[i], *args, out_dtype=torch.bfloat16,
                         presorted=True, layout='cf')
            for i in range(pts.shape[0])])
    before = B.launches
    got5 = batched()
    torch.cuda.synchronize()
    if B.launches != before + 1:
        raise AssertionError(f'pillarize_batch launched K1 '
                             f'{B.launches - before} times, not once')
    want5 = loop()
    data5, pid5 = PE.pillar_rows(pts.flatten(0, 1), mask.flatten(), *args)
    nx, ny = PE.pillar_grid(*args)
    per_cloud = PE.cloud_bins(nx * ny)
    pid5 = pid5 + torch.arange(pts.shape[0], device=dev).repeat_interleave(
        pts.shape[1]) * per_cloud
    plain5 = B.bin_sum_clouds_plain(
        data5, pid5, pts.shape[0], per_cloud, nx * ny, n_feat,
        torch.bfloat16).reshape(got5.shape)
    torch.cuda.synchronize()
    check_close('pillarize_batch vs the per-cloud loop', got5, want5,
                **BF16_TOL)
    check_close('pillarize_batch vs the plain version', got5, plain5,
                **BF16_TOL)
    batched_ms = cuda_ms(batched)
    loop_ms = cuda_ms(loop)

    results['bin_sum'] = dict(
        max_abs_err=errs[0][0], ms=ms, wrapper_ms=wrapper_ms,
        plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
        bound_by='bytes')
    emit({'phase': 'bin_sum', 'points': int(data.shape[0]), 'n_bins': n_bins,
          'channels': c, 'max_abs_err_presorted': errs[0][0],
          'max_rel_err_presorted': errs[0][1],
          'max_abs_err_unsorted': errs[1][0], 'tolerance': BF16_TOL,
          'raw_tolerance': FP32_TOL, 'kernel_ms': ms,
          'wrapper_ms': wrapper_ms, 'raw_fp32_kernel_ms': raw_ms,
          'raw_fp32_bound_us': raw_bound_ms * 1e3, 'twin_ms': plain_ms,
          'library_ms': library_ms,
          'library_call': 'torch.zeros((n_bins, C)).index_add_ of the raw '
                          'fp32 sums, the zeroing inside the timed call (the '
                          'raw fp32 mode\'s function; no epilogue)',
          'bound_us': bound_ms * 1e3, 'bytes': n_bytes, 'hot_trash': hot,
          'clouds': {'n': pts.shape[0],
                     'max_abs_err_vs_loop': max_err(got5, want5)[0],
                     'max_abs_err_vs_plain': max_err(got5, plain5)[0],
                     'batched_ms': batched_ms, 'loop_and_stack_ms': loop_ms,
                     'batched_launches': 1}})


def phase_bin_sum_grouped(cfg, dev, results):
    """The grouped bin-sum at one flagship cloud, against the plain version
    and bin_sum, alone and through its wrapper, and the hot trash bin; then
    the experiment tool's path, its launches counted."""
    import torch
    from streamingflow_tpu_torch.ops import bin_sum as B
    from streamingflow_tpu_torch.tools import exp_bin_variants
    data, pid, n_bins, n_feat = flagship_cloud_rows(cfg, dev)
    kw = dict(pillar_features=n_feat, out_dtype=torch.bfloat16,
              transposed_out=True)
    want = B.bin_sum_plain(data, pid, n_bins, **kw)
    base = B.bin_sum(data, pid, n_bins, presorted=True, **kw)
    raw_want = B.bin_sum_plain(data, pid, n_bins, transposed_out=True)
    perm = torch.randperm(data.shape[0], device=dev)
    errs, ms, wrapper_ms = {}, {}, {}
    for k in (4, 8, 16):
        for presorted in (True, False):
            got = B.bin_sum_grouped(data, pid, n_bins, presorted=presorted,
                                    k_tiles=k, **kw)
            torch.cuda.synchronize()
            name = f'bin_sum_grouped k_tiles={k} presorted={presorted}'
            check_close(name + ' vs plain', got, want, **BF16_TOL)
            check_close(name + ' vs bin_sum', got, base, **BF16_TOL)
            if presorted:
                errs[str(k)] = max_err(got, want)[0]
        raw = B.bin_sum_grouped(data[perm], pid[perm], n_bins,
                                transposed_out=True, k_tiles=k)
        torch.cuda.synchronize()
        check_close(f'bin_sum_grouped k_tiles={k} raw fp32', raw, raw_want,
                    **FP32_TOL)
        ms[str(k)] = kernel_alone_ms(data, pid, n_bins, n_feat,
                                     torch.bfloat16, k_tiles=k)
        wrapper_ms[str(k)] = cuda_ms(lambda: B.bin_sum_grouped(
            data, pid, n_bins, presorted=True, k_tiles=k, **kw))
    hot = hot_trash_case('bin_sum_grouped', B.bin_sum_grouped, data, pid,
                         n_bins, n_feat, k_tiles=8)
    bin_sum_ms = kernel_alone_ms(data, pid, n_bins, n_feat, torch.bfloat16)
    plain_ms = cuda_ms(lambda: B.bin_sum_plain(data, pid, n_bins, **kw))
    ids64 = pid.long()
    library_ms = cuda_ms(lambda: torch.zeros(n_bins, data.shape[1],
                                             device=dev)
                         .index_add_(0, ids64, data))
    bound_ms, n_bytes = bin_sum_bound_ms(data, pid, n_bins)

    # the kernel's own path: the experiment tool, counts read around it
    B.launches_grouped = 0
    tool = exp_bin_variants.run((4, 8, 16), device=dev)
    launches = B.launches_grouped
    if launches < 1:
        raise AssertionError('exp_bin_variants did not launch the grouped '
                             'kernel')
    results['bin_sum_grouped'] = dict(
        launches=launches, max_abs_err=errs['8'], ms=ms['8'],
        wrapper_ms=wrapper_ms['8'], plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=bound_ms, bound_by='bytes')
    emit({'phase': 'bin_sum_grouped', 'points': int(data.shape[0]),
          'n_bins': n_bins, 'max_abs_err_by_k_tiles': errs,
          'tolerance': BF16_TOL, 'kernel_ms_by_k_tiles': ms,
          'wrapper_ms_by_k_tiles': wrapper_ms, 'bin_sum_kernel_ms': bin_sum_ms,
          'twin_ms': plain_ms, 'library_ms': library_ms,
          'library_call': 'torch.zeros((n_bins, C)).index_add_, as in phase '
                          'bin_sum', 'bound_us': bound_ms * 1e3,
          'bytes': n_bytes, 'hot_trash': hot, 'tool_launches': launches,
          'tool': tool})


def flagship_pool_inputs(cfg, dev, gen):
    """Flagship pool inputs from the synthetic calibration, as the model
    builds them: frustum -> get_geometry -> warp -> quantize -> kept."""
    import torch
    from streamingflow_tpu_torch import geometry as G
    from streamingflow_tpu_torch.data import make_batch
    from streamingflow_tpu_torch.ops import lift_splat as LS
    batch = make_batch(cfg, 1, seed=0, n_points=16)
    s = cfg.TIME_RECEPTIVE_FIELD
    res, start, dim = G.calculate_birds_eye_view_parameters(
        cfg.LIFT.X_BOUND, cfg.LIFT.Y_BOUND, cfg.LIFT.Z_BOUND)
    frustum = torch.as_tensor(G.create_frustum(
        cfg.IMAGE.FINAL_DIM, cfg.MODEL.ENCODER.DOWNSAMPLE, cfg.LIFT.D_BOUND),
        device=dev)
    intr = torch.from_numpy(batch['intrinsics'][:, :s]).to(dev)
    extr = torch.from_numpy(batch['extrinsics'][:, :s]).to(dev)
    n = intr.shape[2]
    geom = G.get_geometry(frustum, intr.reshape(s, n, 3, 3),
                          extr.reshape(s, n, 4, 4))[None]
    ego = G.pose_vec2mat(torch.from_numpy(
        batch['future_egomotion'][:, :s]).to(dev))
    geom = LS.warp_geometry_to_present(geom, ego)
    nx, ny, nz = (int(v) for v in dim)
    coords = LS.quantize_geometry(geom, start, res)[0]
    kept = LS.in_grid(coords, nx, ny, nz)
    coords = coords[..., :2].contiguous()
    x = torch.randn(*kept.shape, 64, device=dev, generator=gen,
                    dtype=torch.bfloat16)
    return x, coords, kept, nx, ny


def tie_rows(shape, dev, gen):
    """fp32 rows that sit exactly on bf16 rounding ties: +-(1 + m 2^-8) 2^e
    with m odd, halfway between two bf16 neighbours, so a rounding other
    than to nearest even shows."""
    import torch
    m = torch.randint(0, 128, shape, device=dev, generator=gen) * 2 + 1
    e = torch.randint(-3, 4, shape, device=dev, generator=gen)
    sign = torch.randint(0, 2, shape, device=dev, generator=gen) * 2 - 1
    return sign * (1 + m * 2.0 ** -8) * torch.exp2(e.float())


def collision_coords(shape, nx, ny, one_cell):
    """Coords, in a 16 x 8 corner of each group's own patch (groups tiled
    over the grid, so no two groups share a cell), that put every row of a
    group in one cell (``one_cell``: the longest runs) or every row in a
    cell of its own (no run longer than a row).  All rows fit."""
    import torch
    f, n, d, fh, fw = shape
    wb = -(-fw // 4)
    per_row = nx // 16
    if n * d * wb > per_row * (ny // 8) or fh > 32:
        raise ValueError('collision_coords: the groups do not fit the grid')
    g = torch.arange(n * d * wb).view(1, n, d, 1, wb, 1)
    gx, gy = g % per_row * 16, g // per_row * 8
    h = torch.arange(fh).view(1, 1, 1, fh, 1, 1)
    q = torch.arange(4).view(1, 1, 1, 1, 1, 4)
    if one_cell:
        cx, cy = gx + 0 * h * q, gy + 0 * h * q
    else:
        cx, cy = gx + h % 16, gy + h // 16 * 4 + q
    c = torch.stack(torch.broadcast_tensors(cx, cy), -1).expand(
        f, n, d, fh, wb, 4, 2).reshape(f, n, d, fh, wb * 4, 2)
    return c[..., :fw, :].contiguous().int()


def pool_runs(coords, kept, nx, ny):
    """Runs of the pool kernel on these inputs: stretches of summed rows of
    one image column of a group, down h, that share a cell.  Each run is
    one add of 64 fp32 sums (16 float4 reductions) into the grid."""
    import torch
    from streamingflow_tpu_torch.ops import patch_pool as PP
    fits = PP.fits_mask(coords, kept, nx, ny)[1]
    cell = coords[..., 0] * ny + coords[..., 1]
    f, n, d, fh, fw = kept.shape
    column = torch.arange(f * n * d * fw, device=cell.device).view(
        f, n, d, 1, fw).expand(f, n, d, fh, fw)
    # (f, n, d, w, h): each column's rows in the order the kernel walks them
    col = column.permute(0, 1, 2, 4, 3)[fits.permute(0, 1, 2, 4, 3)]
    cel = cell.permute(0, 1, 2, 4, 3)[fits.permute(0, 1, 2, 4, 3)]
    if col.numel() == 0:
        return 0
    new = torch.ones_like(col, dtype=torch.bool)
    new[1:] = (col[1:] != col[:-1]) | (cel[1:] != cel[:-1])
    return int(new.sum())


def phase_patch_pool(cfg, dev, results):
    """K2's forward at the flagship frame stack in bf16 and in fp32 rows,
    rows on bf16 ties, the one-cell and all-distinct collision cases, a
    ragged width and one forced overflow, each against the plain version;
    its times against its bounds, the cast it saves, an ablation of the
    row-atomic design it replaced, its reductions and registers, and the
    lift's product and permute that make its rows."""
    import torch
    from streamingflow_tpu_torch.ops import cuda_lib
    from streamingflow_tpu_torch.ops import patch_pool as PP
    gen = torch.Generator(device=dev).manual_seed(0)
    x, coords, kept, nx, ny = flagship_pool_inputs(cfg, dev, gen)
    x32 = torch.randn(x.shape, device=dev, generator=gen)
    # fp32 sums of the same bf16 rows, reductions in a run-to-run order:
    # equal up to fp32 reassociation over up to a few hundred rows a cell
    tol = dict(rtol=1e-4, atol=1e-4)
    cases = {}

    def check(name, x, coords, kept, exact=False, want_drops=None):
        got, drops = PP.patch_pool_frames(x, coords, kept, nx, ny)
        want, plain_drops = PP.patch_pool_frames_plain(x, coords, kept, nx,
                                                       ny)
        torch.cuda.synchronize()
        if not torch.equal(drops.cpu(), plain_drops.cpu()):
            raise AssertionError(f'patch_pool {name}: drops {drops.tolist()}'
                                 f' != plain {plain_drops.tolist()}')
        if want_drops is not None and not want_drops(drops):
            raise AssertionError(f'patch_pool {name}: drops {drops.tolist()}')
        if exact and not torch.equal(got, want):
            raise AssertionError(f'patch_pool {name}: one row a cell must '
                                 f'give the plain sums exactly (max abs '
                                 f'{max_err(got, want)[0]:.3g})')
        check_close(f'patch_pool {name}', got, want, **tol)
        cases[name] = dict(dtype=str(x.dtype).split('.')[-1],
                           shape=list(x.shape), drops=drops.tolist(),
                           max_abs_err=max_err(got, want)[0],
                           runs=pool_runs(coords, kept, nx, ny))

    check('flagship_bf16', x, coords, kept,
          want_drops=lambda d: int(d.sum()) == 0)
    check('flagship_fp32', x32, coords, kept,
          want_drops=lambda d: int(d.sum()) == 0)
    check('flagship_ties_fp32', tie_rows(x.shape, dev, gen), coords, kept)
    # the collision cases: 3 frames x 3 cameras x 4 depth bins of 28 x 60
    # rows, 180 groups a frame tiled over the 200 x 200 grid
    cshape = (3, 3, 4, 28, 60)
    ckept = torch.ones(cshape, dtype=torch.bool, device=dev)
    for one_cell in (True, False):
        cc = collision_coords(cshape, nx, ny, one_cell).to(dev)
        name = 'one_cell' if one_cell else 'all_distinct'
        check(f'{name}_bf16', torch.randn(*cshape, 64, device=dev,
                                          generator=gen).bfloat16(),
              cc, ckept, want_drops=lambda d: int(d.sum()) == 0)
        # ties in fp32: with one row a cell the sums are the rounded rows
        check(f'{name}_ties_fp32', tie_rows((*cshape, 64), dev, gen), cc,
              ckept, exact=not one_cell,
              want_drops=lambda d: int(d.sum()) == 0)
    # a ragged width (7) and fH * 4 < 128, a fifth of the rows not kept
    rshape = (2, 2, 3, 20, 7)
    rc = collision_coords(rshape, nx, ny, False).to(dev)
    rk = torch.rand(rshape, device=dev, generator=gen) > 0.2
    check('ragged_fw7_fp32', torch.randn(*rshape, 64, device=dev,
                                         generator=gen), rc, rk)
    # forced overflow: cells scattered over the grid within each group
    ox = torch.randn(2, 2, 3, 28, 8, 64, device=dev, generator=gen,
                     dtype=torch.bfloat16)
    oc = torch.randint(0, nx, (2, 2, 3, 28, 8, 2), device=dev,
                       generator=gen, dtype=torch.int32)
    ok = torch.rand(2, 2, 3, 28, 8, device=dev, generator=gen) > 0.2
    check('overflow', ox, oc, ok, want_drops=lambda d: int(d.min()) > 0)

    # times at the flagship stack: through the wrapper (zeroed grid
    # included), and alone on prepared inputs
    fits = PP.fits_mask(coords, kept, nx, ny)[1]
    n_fit = int(fits.sum())
    frames = x.shape[0]
    cell = (torch.arange(frames, device=dev).view(-1, 1, 1, 1, 1)
            * (nx * ny) + coords[..., 0] * ny + coords[..., 1])[fits].long()
    rows = x[fits].float()
    grid = torch.zeros(frames * nx * ny, 64, device=dev)
    out = torch.zeros(frames, nx, ny, 64, device=dev)
    drops = torch.zeros(frames, dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: PP.patch_pool_frames(x, coords, kept, nx, ny))
    fp32_ms = cuda_ms(lambda: PP.patch_pool_frames(x32, coords, kept, nx,
                                                   ny))
    cast_ms = cuda_ms(lambda: PP.patch_pool_frames(x32.bfloat16(), coords,
                                                   kept, nx, ny))
    alone = {}
    for name, rows_in, defines in (
            ('bf16', x, ()), ('fp32', x32, ()),
            ('bf16_loads_only', x, ('PATCH_POOL_LOADS_ONLY=1',)),
            ('fp32_loads_only', x32, ('PATCH_POOL_LOADS_ONLY=1',))):
        alone[name] = cuda_ms(lambda: PP.launch(rows_in, coords, kept, out,
                                                drops, nx, ny, defines))
    # the row-atomic design this kernel replaced, with its atomics and with
    # its loads alone (sums kept in registers, one store a block)
    f_, n_, d_, fh_, fw_ = kept.shape
    groups = f_ * n_ * d_ * -(-fw_ // 4)
    sink = torch.empty(groups, 64, device=dev)
    old = cuda_lib.kernel('patch_pool_ablation', 'sf_patch_pool_row_atomics')
    stream = torch.cuda.current_stream(dev).cuda_stream

    def row_atomic(atomics, rows_in=x):
        cuda_lib.check('patch_pool_row_atomics', old(
            rows_in.data_ptr(), coords.data_ptr(), kept.data_ptr(),
            out.data_ptr(), drops.data_ptr(), sink.data_ptr(), f_, n_, d_,
            fh_, fw_, nx, ny, atomics, stream))
    out.zero_()
    drops.zero_()
    row_atomic(1)
    torch.cuda.synchronize()
    check_close('patch_pool row-atomic design', out,
                PP.patch_pool_frames_plain(x, coords, kept, nx, ny)[0], **tol)
    row_atomic_ms = cuda_ms(lambda: row_atomic(1))
    row_atomic_loads_ms = cuda_ms(lambda: row_atomic(0))
    # what the fp32 rows cost before: the wrapper's cast, then the
    # row-atomic kernel on a zeroed grid
    cast_row_atomic_ms = cuda_ms(lambda: (
        out.zero_(), row_atomic(1, x32.to(torch.bfloat16))))
    plain_ms = cuda_ms(
        lambda: PP.patch_pool_frames_plain(x, coords, kept, nx, ny))
    library_ms = cuda_ms(lambda: grid.index_add_(0, cell, rows))

    def bound(row_bytes):
        """The features of the rows that are summed, every row's coords and
        mask, the grid and the counts; one add a summed value."""
        n_bytes = (n_fit * 64 * row_bytes + coords.numel() * 4
                   + kept.numel() + out.numel() * 4 + drops.numel() * 4)
        flops = n_fit * 64
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
        return max(t_bytes, t_ops) * 1e3, n_bytes, (
            'bytes' if t_bytes >= t_ops else 'operations')
    bound_ms, n_bytes, bound_by = bound(2)
    fp32_bound_ms, fp32_bytes, _ = bound(4)
    runs = cases['flagship_bf16']['runs']

    # the lift's depth x feature product and its permute, which make K2's
    # rows (models/streamingflow.py), at the flagship shapes
    f, n, d, fh, fw, c = x.shape
    lift = {}
    for dtype in (torch.bfloat16, torch.float32):
        prob = torch.rand(f * n, d, fh, fw, device=dev, generator=gen
                          ).to(dtype)
        feat = torch.randn(f * n, c, fh, fw, device=dev, generator=gen
                           ).to(dtype)
        prod = prob[:, :, None] * feat[:, None]
        key = str(dtype).split('.')[-1]
        lift[key] = dict(
            product_ms=cuda_ms(lambda: prob[:, :, None] * feat[:, None]),
            permute_ms=cuda_ms(lambda: prod.permute(0, 1, 3, 4, 2)
                               .contiguous()),
            both_ms=cuda_ms(lambda: (prob[:, :, None] * feat[:, None])
                            .permute(0, 1, 3, 4, 2).contiguous()),
            tensor_bytes=prod.numel() * prod.element_size())
        del prod

    results['patch_pool'] = dict(
        max_abs_err=cases['flagship_bf16']['max_abs_err'], ms=ms,
        plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
        bound_by=bound_by, fp32_ms=fp32_ms, fp32_bound_ms=fp32_bound_ms)
    emit({'phase': 'patch_pool', 'x_shape': list(x.shape),
          'kept_rows': int(kept.sum()), 'summed_rows': n_fit,
          'tolerance': tol, 'cases': cases,
          'kernel_ms': {'bf16': ms, 'fp32': fp32_ms},
          'kernel_alone_ms': alone,
          'fp32_cast_then_bf16_kernel_ms': cast_ms,
          'fp32_cast_then_row_atomic_kernel_ms': cast_row_atomic_ms,
          'ablation_row_atomic_design_ms': {
              'loads_and_atomics': row_atomic_ms,
              'loads_only': row_atomic_loads_ms},
          'reductions': {
              'runs': runs, 'float4': runs * 16,
              'row_atomic_design_scalar': n_fit * 64},
          'ptxas': _ptxas_report(cuda_lib.BUILD_LOG.get('patch_pool', '')),
          'twin_ms': plain_ms, 'library_ms': library_ms,
          'library_call': 'index_add_ of the fitting rows into the grid',
          'bound_us': bound_ms * 1e3, 'bytes': n_bytes,
          'fp32_bound_us': fp32_bound_ms * 1e3, 'fp32_bytes': fp32_bytes,
          'lift_product_permute': lift})


def phase_patch_pool_bwd(cfg, dev, results):
    """The pool's gradient: backward kernel vs the plain version's autograd
    gradient, at the flagship frame stack and in a forced overflow."""
    import torch
    from streamingflow_tpu_torch.ops import patch_pool as PP
    gen = torch.Generator(device=dev).manual_seed(1)
    x, coords, kept, nx, ny = flagship_pool_inputs(cfg, dev, gen)
    x = x.float()                    # the training step's features are fp32

    def both(x, coords, kept):
        """(kernel gradient, plain autograd gradient, fits) for one random
        cotangent."""
        dout = torch.randn(x.shape[0], nx, ny, 64, device=dev, generator=gen)
        grads = []
        for pool in (PP.patch_pool_frames, PP.patch_pool_frames_plain):
            xin = x.clone().requires_grad_()
            pool(xin, coords, kept, nx, ny)[0].backward(dout)
            grads.append(xin.grad)
        torch.cuda.synchronize()
        return grads[0], grads[1], PP.fits_mask(coords, kept, nx, ny)[1], dout

    before = PP.launches_bwd
    got, want, fits, dout = both(x, coords, kept)
    if PP.launches_bwd != before + 1:
        raise AssertionError('the pool\'s backward did not launch its kernel')
    # a gather of fp32 values in both: equal, not only close
    if got.dtype != torch.float32 or not torch.equal(got, want):
        raise AssertionError(f'patch_pool backward disagrees with the plain '
                             f'gradient (max abs {max_err(got, want)[0]:.3g})')
    if bool(got[~fits].any()):
        raise AssertionError('patch_pool backward: a row that was not summed '
                             'has a gradient')
    # forced overflow: the rows lost to the budget get exactly zero
    ox = torch.randn(2, 2, 3, 28, 8, 64, device=dev, generator=gen)
    oc = torch.randint(0, nx, (2, 2, 3, 28, 8, 2), device=dev,
                       generator=gen, dtype=torch.int32)
    ok = torch.rand(2, 2, 3, 28, 8, device=dev, generator=gen) > 0.2
    o_got, o_want, o_fits, _ = both(ox, oc, ok)
    n_dropped = int((ok & ~o_fits).sum())
    if n_dropped <= 0 or not torch.equal(o_got, o_want) or \
            bool(o_got[ok & ~o_fits].any()):
        raise AssertionError('patch_pool backward, forced overflow: dropped '
                             'rows must get exactly zero gradient')
    # bf16 features get a bf16 gradient of the same fp32 cotangent
    g16 = PP.patch_pool_grad(dout, coords, kept, nx, ny, torch.bfloat16)
    torch.cuda.synchronize()
    if not torch.equal(g16, want.to(torch.bfloat16)):
        raise AssertionError('patch_pool backward: bf16 gradient differs')

    ms = cuda_ms(lambda: PP.patch_pool_grad(dout, coords, kept, nx, ny,
                                            torch.float32))
    plain_ms = cuda_ms(lambda: PP.patch_pool_grad_plain(
        dout, coords, kept, nx, ny, torch.float32), reps=5)
    # one PyTorch call for the same function: rows of the cotangent (a zero
    # row appended for the rows not summed) selected by a precomputed index
    frame = torch.arange(x.shape[0], device=dev).view(-1, 1, 1, 1, 1)
    cell = frame * (nx * ny) + coords[..., 0] * ny + coords[..., 1]
    index = torch.where(fits, cell, torch.full_like(
        cell, x.shape[0] * nx * ny)).flatten().long()
    table = torch.cat([dout.reshape(-1, 64), dout.new_zeros(1, 64)])
    library_ms = cuda_ms(lambda: torch.index_select(table, 0, index))
    # the cotangent read once, every row's coords and mask, one fp32
    # gradient row written per frustum row
    n_bytes = (dout.numel() * 4 + coords.numel() * 4 + kept.numel()
               + got.numel() * 4)
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    results['patch_pool_bwd'] = dict(
        max_abs_err=max_err(got, want)[0], ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=bound_ms, bound_by='bytes')
    emit({'phase': 'patch_pool_bwd', 'x_shape': list(x.shape),
          'rows_summed': int(fits.sum()), 'overflow_rows_dropped': n_dropped,
          'max_abs_err': max_err(got, want)[0], 'tolerance': 'equal',
          'kernel_ms': ms, 'twin_ms': plain_ms, 'library_ms': library_ms,
          'library_call': 'index_select of the cotangent rows by a '
                          'precomputed index (a zero row for rows not summed)',
          'bound_us': bound_ms * 1e3, 'bytes': n_bytes})


def _winfuse_case(name, feats, geo, w, nz, zmask=None, reps=10):
    """K3 vs its plain version on one input; times, bytes and FLOPs.

    FLOPs: ``flops_dense_z`` counts every z of every found tap (what the
    fused layout computes), ``flops`` what these inputs need: with
    ``zmask`` (the features are zero at inactive sites, as on the main
    path) only the products of active input sites."""
    import torch
    from streamingflow_tpu_torch.ops import winfuse as WF
    got = WF.subm_conv_winfuse(feats, geo.nbr, geo.found, w, nz)
    want = WF.subm_conv_plain(feats, geo.nbr, geo.found, w, nz)
    torch.cuda.synchronize()
    bf16 = feats.dtype == torch.bfloat16
    scale = float(want.float().abs().max())
    # fp32: sums in another order; bf16: one rounding of an fp32 sum that
    # differs in order may land one bf16 step away (K1's bar)
    tol = (dict(rtol=2 ** -7, atol=1e-2) if bf16 else
           dict(rtol=1e-5, atol=1e-5 * scale))
    check_close(f'winfuse {name}', got, want, **tol)
    cin, cout = w.shape[1], w.shape[2]
    n_found = int(geo.found.sum())
    flops_dense = 2 * cin * cout * n_found * (3 * nz - 2)
    if zmask is None:
        flops = flops_dense
    else:
        # products per active input site: its valid output z (2 at the edges)
        per_z = torch.full((nz,), 3, device=feats.device)
        per_z[0] = per_z[-1] = 2
        per_col = (zmask.reshape(-1, nz) * per_z).sum(-1)
        nbr = geo.nbr.long()
        flops = 2 * cin * cout * int((per_col[nbr] * geo.found).sum())
    # input rows a taken tap reads (not the empty column slots), the whole
    # output, the weights and the maps
    es = feats.element_size()
    n_rows = int(torch.unique(geo.nbr[geo.found]).numel())
    n_bytes = (n_rows * feats.shape[1] + got.numel() + w.numel()) * es + \
        geo.nbr.numel() * 4 + geo.found.numel()
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / (BF16_FLOPS if bf16 else FP32_FLOPS)
    ms = cuda_ms(lambda: WF.subm_conv_winfuse(feats, geo.nbr, geo.found, w,
                                              nz), reps=reps)
    plain_ms = cuda_ms(lambda: WF.subm_conv_plain(feats, geo.nbr, geo.found,
                                                  w, nz), reps=3, warmup=1)
    return dict(case=name, dtype=str(feats.dtype).split('.')[-1], nz=nz,
                cin=cin, cout=cout, route=WF.route(feats.dtype),
                rows=geo.nbr.shape[1], rows_read=n_rows, found_taps=n_found,
                found_share=n_found / geo.found.numel(),
                max_abs_err=max_err(got, want)[0],
                max_abs_want=scale, tolerance=tol, kernel_ms=ms,
                twin_ms=plain_ms, bytes=n_bytes, flops=flops,
                flops_dense_z=flops_dense,
                bound_us=max(t_bytes, t_ops) * 1e6,
                bound_by='bytes' if t_bytes >= t_ops else 'operations')


def k3_inputs(dev):
    """K3's inputs at the flagship spconv8x geometry of one request (the 5
    clouds of 80k points voxelized into columns, stacked as the main path
    launches it), random features from seed 0 zeroed at the inactive sites
    as on the main path: the three bf16 cases {name: (feats, geo, weights,
    nz, zmask)}, and what phase_winfuse builds its other cases from."""
    import types
    import torch
    from streamingflow_tpu_torch.data import flagship_config, make_batch
    from streamingflow_tpu_torch.models import lidar_encoder as L
    from streamingflow_tpu_torch.ops import sparse_columns as SC
    cfg = flagship_config(backbone='spconv8x')
    se = cfg.MODEL.SPARSE_ENCODER
    pts = torch.from_numpy(make_batch(cfg, 1, seed=0, n_points=80000)
                           ['points'][0]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def rand(*shape, dtype=bf16, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).to(
            dtype)

    def weights(cin, cout, dtype=bf16):
        return rand(27, cin, cout, dtype=dtype, scale=(27 * cin) ** -0.5)

    shape1 = tuple(se.SPARSE_SHAPE)
    cs1 = L.column_sets(pts, (pts[..., :3] != 0).any(-1), se, bf16)
    geo1 = L.column_geometry(cs1, shape1[:2], se)
    n, cap1 = cs1.col_ids.shape
    nz1 = shape1[2]
    # stage-2 columns behind the plain strided conv down1
    feats16 = SC.mask_fused(rand(n, cap1, nz1 * 16), cs1.zmask)
    w_down1 = weights(16, 32)

    def down1(i):
        return SC.sparse_conv_columns(
            SC.cloud(cs1._replace(feats=feats16), i), w_down1, (3, 3, 3),
            (2, 2, 2), (1, 1, 1), shape1, se.COLUMN_CAPS[1])[0]
    cs2 = SC.stack_sets([down1(i) for i in range(n)])
    shape2 = SC.conv_out_shape(shape1, (3, 3, 3), (2, 2, 2), (1, 1, 1))
    geo2 = L.column_geometry(cs2, shape2[:2], se)
    nz2 = shape2[2]

    def path_like(cs, nz, c, zmask=None):
        zmask = cs.zmask if zmask is None else zmask
        return SC.mask_fused(rand(n, cs.col_ids.shape[1], nz * c),
                             zmask).reshape(-1, nz * c)

    cases = {
        'conv_input': (SC.mask_fused(cs1.feats, cs1.zmask).reshape(
            n * cap1, -1), geo1, weights(5, 16), nz1, cs1.zmask),
        'stage1': (path_like(cs1, nz1, 16), geo1, weights(16, 16), nz1,
                   cs1.zmask),
        'stage2': (path_like(cs2, nz2, 32), geo2, weights(32, 32), nz2,
                   cs2.zmask),
    }
    return cases, types.SimpleNamespace(
        se=se, n=n, cs1=cs1, cs2=cs2, geo1=geo1, geo2=geo2, shape2=shape2,
        nz1=nz1, nz2=nz2, cap1=cap1, cap2=cs2.col_ids.shape[1], rand=rand,
        weights=weights, path_like=path_like, down1=down1)


def _ptxas_report(log):
    """Registers, shared memory, spills and stack of each kernel in an nvcc
    -Xptxas -v log."""
    import re
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
        if m and name:
            out.append({'kernel': name, 'stack_bytes': int(m.group(1)),
                        'spill_stores': int(m.group(2)),
                        'spill_loads': int(m.group(3))})
        m = re.search(r'Used (\d+) registers', line)
        if m and out and out[-1]['kernel'] == name:
            out[-1]['registers'] = int(m.group(1))
            m = re.search(r'(\d+) bytes smem', line)
            out[-1]['smem_bytes'] = int(m.group(1)) if m else 0
    return out


def phase_winfuse(dev, results):
    """K3 at the flagship spconv8x geometry of one request (5 clouds of 80k
    points), stacked as the main path launches it, and a forced drop."""
    import torch
    from streamingflow_tpu_torch.models import lidar_encoder as L
    from streamingflow_tpu_torch.ops import cuda_lib
    from streamingflow_tpu_torch.ops import sparse_columns as SC
    from streamingflow_tpu_torch.ops import winfuse as WF
    inputs, x = k3_inputs(dev)
    se, n, cap1, cap2, nz1, nz2 = x.se, x.n, x.cap1, x.cap2, x.nz1, x.nz2
    rand, weights, cs1, cs2 = x.rand, x.weights, x.cs1, x.cs2
    geo1, geo2, shape2 = x.geo1, x.geo2, x.shape2
    down1_ms = cuda_ms(lambda: x.down1(0), reps=3, warmup=1)
    cases = [_winfuse_case(name, f, geo, w, nz, zmask)
             for name, (f, geo, w, nz, zmask) in inputs.items()]
    # the wrapper's copy of conv_input's rows (Cin 5) to an 8-channel pitch,
    # inside conv_input's time above
    f0, _, _, nz0, _ = inputs['conv_input']
    pitch_ms = cuda_ms(lambda: WF.pitch_rows(f0, nz0, 8))
    cases += [
        _winfuse_case('stage1_fp32_dense', rand(n * cap1, nz1 * 16,
                                                dtype=torch.float32),
                      geo1, weights(16, 16, torch.float32), nz1, reps=3),
        _winfuse_case('stage2_fp32_dense', rand(n * cap2, nz2 * 32,
                                                dtype=torch.float32),
                      geo2, weights(32, 32, torch.float32), nz2, reps=3),
        # the tiny config's z (25) on the stage-1 columns, their first 25 z
        _winfuse_case('nz25', x.path_like(cs1, 25, 16, cs1.zmask[..., :25]),
                      geo1, weights(16, 16), 25, cs1.zmask[..., :25]),
    ]
    # forced drop: a window of one block plus 8 rows and no residual
    # blocks; the drop count on the card equals the count on the CPU
    nbrs, founds, drops, cpu_drops = [], [], [], []
    for i in range(n):
        cmap = SC.build_column_map(SC.cloud(cs2, i), shape2[:2])
        found, dropped = WF.fused_found(cmap, se.WINDOW_BLOCK,
                                        se.WINDOW_BLOCK + 8, 0)
        cmap_cpu = SC.ColumnMap(cmap.nbr.cpu(), cmap.found.cpu())
        cpu_drops.append(int(WF.fused_found(cmap_cpu, se.WINDOW_BLOCK,
                                            se.WINDOW_BLOCK + 8, 0)[1]))
        nbrs.append(cmap.nbr + i * cap2)
        founds.append(found)
        drops.append(int(dropped))
    if drops != cpu_drops or min(drops) <= 0:
        raise AssertionError(f'winfuse forced drop: card {drops}, CPU '
                             f'{cpu_drops}')
    geo_drop = L.ColumnGeo(torch.cat(nbrs, 1).int(), torch.cat(founds, 1),
                           None)
    cases.append(_winfuse_case('stage2_drop', rand(n * cap2, nz2 * 32),
                               geo_drop, weights(32, 32), nz2, reps=3))
    main = cases[2]
    ms = {c['case']: c['kernel_ms'] for c in cases}
    results['winfuse'] = dict(
        max_abs_err=main['max_abs_err'], ms=main['kernel_ms'],
        plain_ms=main['twin_ms'], library_ms=None,
        bound_ms=main['bound_us'] / 1e3, bound_by=main['bound_by'])
    emit({'phase': 'winfuse', 'clouds': n,
          'active_columns': {'stage1': int(cs1.col_mask.sum()),
                             'stage2': int(cs2.col_mask.sum())},
          'active_sites': {'stage1': int(cs1.zmask.sum()),
                           'stage2': int(cs2.zmask.sum())},
          'column_slots': {'stage1': n * cap1, 'stage2': n * cap2},
          'n_dropped': {'stage1': geo1.n_dropped.tolist(),
                        'stage2': geo2.n_dropped.tolist(),
                        'forced': drops},
          'cases': cases,
          'ptxas': _ptxas_report(cuda_lib.BUILD_LOG.get('winfuse', '')),
          'down1_plain_ms_per_cloud': down1_ms,
          'conv_input_pitch_rows_ms': pitch_ms,
          'forecast_ms_est': ms['conv_input'] + 4 * ms['stage1']
          + 4 * ms['stage2'],
          'library_call': 'none: no one call computes this function'})


def _tiny_lidar_config():
    """tiny_config with LiDAR on (pillar8x), 64 camera channels (K2's width)
    and the patch pool."""
    from streamingflow_tpu_torch.data import tiny_config
    cfg = tiny_config()
    cfg.MODEL.MODALITY.USE_LIDAR = True
    cfg.MODEL.ENCODER.OUT_CHANNELS = 64
    cfg.MODEL.BEV_POOL_BACKEND = 'pallas_patch'
    cfg.PROBABILISTIC.ENABLED = False
    return cfg


def _tiny_spconv_config():
    """The tiny LiDAR configuration on the spconv8x backbone, with column
    caps and a window plan sized to it (tiny_config keeps the flagship's
    65536 slots)."""
    cfg = _tiny_lidar_config()
    cfg.MODEL.LIDAR.BACKBONE = 'spconv8x'
    se = cfg.MODEL.SPARSE_ENCODER
    se.ENGINE = 'column'
    se.Z_FORMULATION = 'winfuse'
    se.COLUMN_CAPS = [512, 768, 512, 256]
    se.WINDOW_BLOCK = 16
    se.WINFUSE_WINDOW = 64
    return cfg


def phase_tiny_spconv(dev):
    """Tiny camera + spconv8x forecast: card (K2, K3) vs CPU (plain
    versions), same weights and inputs, fp32."""
    import torch
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch.data import make_batch
    from streamingflow_tpu_torch.ops import patch_pool as PP
    from streamingflow_tpu_torch.ops import winfuse as WF
    cfg = _tiny_spconv_config()
    cpu_model = P.build_model(cfg, device='cpu', seed=0)
    gpu_model = P.build_model(cfg, device=dev)
    gpu_model.load_state_dict(cpu_model.state_dict())
    batch = make_batch(cfg, 1, seed=1, n_points=512)
    k2, k3 = PP.launches, WF.launches
    with torch.no_grad():
        want = cpu_model(**P.batch_to_model_args(batch, cfg, device='cpu'))
        got = gpu_model(**P.batch_to_model_args(batch, cfg, device=dev))
    torch.cuda.synchronize()
    if PP.launches == k2 or WF.launches == k3:
        raise AssertionError('tiny spconv8x forward did not launch K2 and K3')
    errs = {}
    for k, w in want.items():
        if w is None:
            continue
        g = got[k].cpu()
        if not torch.isfinite(g).all():
            raise AssertionError(f'tiny spconv8x forward: {k} not finite')
        errs[k] = max_err(g, w)[0]
        check_close(f'tiny spconv8x forward {k}', g, w, rtol=5e-3, atol=5e-3)
    emit({'phase': 'tiny_spconv', 'max_abs_err': errs,
          'launches': {'patch_pool': PP.launches - k2,
                       'winfuse': WF.launches - k3},
          'tolerance': dict(rtol=5e-3, atol=5e-3)})


def phase_tiny(dev):
    """Tiny camera+LiDAR forecast: card (kernels) vs CPU (plain versions),
    same weights and inputs, fp32, deterministic."""
    import torch
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch.data import make_batch
    from streamingflow_tpu_torch.ops import bin_sum as B
    from streamingflow_tpu_torch.ops import patch_pool as PP
    cfg = _tiny_lidar_config()
    cpu_model = P.build_model(cfg, device='cpu', seed=0)
    gpu_model = P.build_model(cfg, device=dev)
    gpu_model.load_state_dict(cpu_model.state_dict())
    batch = make_batch(cfg, 1, seed=1, n_points=4096)
    k1, k2 = B.launches, PP.launches
    with torch.no_grad():
        want = cpu_model(**P.batch_to_model_args(batch, cfg, device='cpu'))
        got = gpu_model(**P.batch_to_model_args(batch, cfg, device=dev))
    torch.cuda.synchronize()
    if B.launches == k1 or PP.launches == k2:
        raise AssertionError('tiny forward did not launch both kernels')
    # pillar features are bf16: an fp32 sum in another order can round a
    # feature to the next bf16 value, and the convs carry that on
    errs = {}
    for k, w in want.items():
        if w is None:
            continue
        g = got[k].cpu()
        if not torch.isfinite(g).all():
            raise AssertionError(f'tiny forward: {k} not finite')
        errs[k] = max_err(g, w)[0]
        check_close(f'tiny forward {k}', g, w, rtol=5e-3, atol=5e-3)
    emit({'phase': 'tiny', 'max_abs_err': errs,
          'tolerance': dict(rtol=5e-3, atol=5e-3)})


def phase_tiny_bf16(dev):
    """The bf16 forward on the card against the CPU port's fp32 forward,
    same weights and inputs, for the tiny pillar8x (K1, K2) and the tiny
    spconv8x (K2, K3 in bf16) configurations.  The bar is derived, not
    picked: per output, the card's error may be at most twice the CPU
    port's own bf16 forward's error against the same fp32 forward, or 4
    bf16 steps (4 x 2^-8) of the output's largest value, whichever is
    larger (the bf16 forward rounds in other places on the two devices)."""
    import torch
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch.data import make_batch
    from streamingflow_tpu_torch.ops import bin_sum as B
    from streamingflow_tpu_torch.ops import patch_pool as PP
    from streamingflow_tpu_torch.ops import winfuse as WF
    bf16 = torch.bfloat16
    line = {'phase': 'tiny_bf16'}
    for name, make_cfg, n_points, kernels in (
            ('tiny', _tiny_lidar_config, 4096, ('bin_sum', 'patch_pool')),
            ('tiny_spconv', _tiny_spconv_config, 512,
             ('patch_pool', 'winfuse'))):
        cfg, cfg16 = make_cfg(), make_cfg()
        # the serving forward's mixed precision: bf16 parameters, images and
        # LiDAR branch (flagship_config)
        cfg16.MODEL.SPARSE_ENCODER.COMPUTE_DTYPE = 'bfloat16'
        ref_model = P.build_model(cfg, device='cpu', seed=0)
        state = ref_model.state_dict()
        cpu16 = P.build_model(cfg16, device='cpu', dtype=bf16)
        cpu16.load_state_dict(state)
        gpu16 = P.build_model(cfg16, device=dev, dtype=bf16)
        gpu16.load_state_dict(state)
        batch = make_batch(cfg, 1, seed=1, n_points=n_points)
        counters = {'bin_sum': B, 'patch_pool': PP, 'winfuse': WF}
        before = {k: counters[k].launches for k in kernels}
        with torch.no_grad():
            ref = ref_model(**P.batch_to_model_args(batch, cfg, device='cpu'))
            low = cpu16(**P.batch_to_model_args(batch, cfg16, device='cpu',
                                                image_dtype=bf16))
            got = gpu16(**P.batch_to_model_args(batch, cfg16, device=dev,
                                                image_dtype=bf16))
        torch.cuda.synchronize()
        launched = {k: counters[k].launches - before[k] for k in kernels}
        if not all(launched.values()):
            raise AssertionError(f'tiny_bf16 {name}: launches {launched}')
        outputs = {}
        for k, w in ref.items():
            if w is None:
                continue
            g = got[k].cpu()
            if g.dtype != bf16 or not torch.isfinite(g).all():
                raise AssertionError(f'tiny_bf16 {name} {k}: {g.dtype}, '
                                     f'finite {bool(torch.isfinite(g).all())}')
            card = float((g.float() - w).abs().max())
            cpu = float((low[k].float() - w).abs().max())
            bar = max(2 * cpu, 4 * 2 ** -8 * float(w.abs().max()))
            if card > bar:
                raise AssertionError(f'tiny_bf16 {name} {k}: card error '
                                     f'{card:.3g} > bar {bar:.3g} (CPU bf16 '
                                     f'error {cpu:.3g})')
            outputs[k] = {'card_err': card, 'cpu_bf16_err': cpu, 'bar': bar}
        line[name] = {'launches': launched, 'outputs': outputs}
    emit({**line, 'bar': 'max(2 x the CPU bf16 error, 4 x 2^-8 x max|fp32 '
                         'output|) against the CPU fp32 forward'})


def phase_forward(cfg, dev, n_requests, card, n_points=80000):
    """The flagship forward on cfg's LiDAR backbone, every kernel count set
    to 0 before the requests and read after them."""
    import torch
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch.data import make_batch
    from streamingflow_tpu_torch.ops import bin_sum as B
    from streamingflow_tpu_torch.ops import patch_pool as PP
    from streamingflow_tpu_torch.ops import winfuse as WF
    model = P.build_model(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    spconv = cfg.MODEL.LIDAR.BACKBONE == 'spconv8x'
    s = cfg.TIME_RECEPTIVE_FIELD
    t = s + cfg.N_FUTURE_FRAMES
    nx, ny = (int(v) for v in model.bev_dimension[:2])
    n = len(cfg.IMAGE.NAMES)
    d, fh, fw = model.frustum.shape[:3]
    counters = {'bin_sum': B, 'patch_pool': PP, 'winfuse': WF}
    # one K2 launch for all frames; pillar8x: one bin-sum for all clouds;
    # spconv8x: one K3 launch over the stacked clouds per submanifold conv
    # (conv_input and the two convs of each block of stages 1 and 2)
    se = cfg.MODEL.SPARSE_ENCODER
    blocks = [len(c) - 1 for c in se.ENCODER_CHANNELS[:2]]
    expect = ({'bin_sum': 0, 'patch_pool': 1, 'winfuse': 1 + 2 * sum(blocks)}
              if spconv else {'bin_sum': 1, 'patch_pool': 1, 'winfuse': 0})

    def request(seed):
        batch = make_batch(cfg, 1, seed=seed, n_points=n_points)
        args = P.batch_to_model_args(batch, cfg, device=dev,
                                     image_dtype=torch.bfloat16)
        gen = torch.Generator(device=dev).manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model(**args, generator=gen)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    request(100)                                  # warm-up, not counted
    torch.cuda.reset_peak_memory_stats()
    for m in counters.values():
        m.launches = 0
    lat, drops, per_request, n_dropped = [], [], [], []
    for seed in range(1, n_requests + 1):
        before = {k: m.launches for k, m in counters.items()}
        out, dt = request(seed)
        per_request.append({k: m.launches - before[k]
                            for k, m in counters.items()})
        lat.append(dt)
        drops.append(PP.last_drops.tolist())
        if spconv:
            n_dropped.append({k: v.tolist() for k, v in
                              model.lidar_encoder.last_n_dropped.items()})
        want = {'segmentation': (1, t, nx, ny, 2),
                'instance_center': (1, t, nx, ny, 1),
                'instance_offset': (1, t, nx, ny, 2),
                'instance_flow': (1, t, nx, ny, 2),
                'depth_prediction': (1, s, n, fh, fw, d),
                'cam_front': (1, fh, fw, cfg.MODEL.ENCODER.OUT_CHANNELS)}
        for k, shape in want.items():
            if tuple(out[k].shape) != shape:
                raise AssertionError(f'{k}: shape {tuple(out[k].shape)} != '
                                     f'{shape}')
            if not torch.isfinite(out[k]).all():
                raise AssertionError(f'{k}: values not finite')
    launches = {k: m.launches for k, m in counters.items()}
    for i, got in enumerate(per_request):
        if got != expect:
            raise AssertionError(f'request {i}: launches {got}, want '
                                 f'{expect}')
    line = {'phase': 'forward_spconv' if spconv else 'forward',
            'backbone': cfg.MODEL.LIDAR.BACKBONE, 'requests': n_requests,
            'latency_s': lat, 'median_latency_s': statistics.median(lat),
            'forecasts_per_s': 1.0 / statistics.median(lat),
            'launches': launches, 'per_request_launches': per_request,
            'patch_pool_drops': drops}
    if spconv:
        line['winfuse_n_dropped'] = n_dropped
    emit({**line, 'peak_mem_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
          'card': card})
    return launches


def phase_train_tiny(dev):
    """One tiny camera+LiDAR training step: card (K1, K2 forward and
    backward) vs CPU (plain versions), same initial weights and batch,
    dropout off (the two devices' generators draw different masks).

    Both run in float64.  What is left between them is then what the kernels
    and their plain versions differ by (the order of K2's fp32 sums, a K1
    feature one bf16 step off), so the backward is held: the gradient norm
    to 5e-3, every gradient leaf to 0.1 of its scale, the whole gradient's
    cosine above 0.999, and every parameter whose gradient is well above
    that noise to the same Adam update.  In fp32 the step's own rounding
    moves the gradient leaves by several percent of their scale between two
    runs that sum in another order (tests/test_torch_train_step.py measures
    it on the CPU), which would hide a wrong gradient."""
    import torch
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch.data import make_batch
    from streamingflow_tpu_torch.layers.trainmode import Dropout
    from streamingflow_tpu_torch.ops import bin_sum as B
    from streamingflow_tpu_torch.ops import patch_pool as PP
    tol = {'losses': 1e-5, 'grad_norm': 5e-3, 'grad_leaf': 0.1,
           'grad_cosine': 0.999, 'bn_buffers': 1e-4,
           'parameters': '2 * lr; 1e-3 * lr where |g| >= 0.1 of the leaf'}
    cfg = _tiny_lidar_config()
    cfg.MODEL.SPARSE_ENCODER.COMPUTE_DTYPE = 'float64'
    cpu = P.build_trainer(cfg, device='cpu', seed=0)
    gpu = P.build_trainer(cfg, device=dev)
    gpu.module.load_state_dict(cpu.module.state_dict())
    for trainer in (cpu, gpu):
        trainer.module.double()
        for m in trainer.module.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
    batch = make_batch(cfg, 1, seed=1, n_points=4096)
    before = {k: v.clone() for k, v in cpu.module.state_dict().items()}
    counts = (B.launches, PP.launches, PP.launches_bwd)
    want = P.train_step(cpu, batch)
    got = P.train_step(gpu, batch)
    torch.cuda.synchronize()
    if any(a == b for a, b in zip(counts, (B.launches, PP.launches,
                                           PP.launches_bwd))):
        raise AssertionError('tiny train step did not launch K1, K2 and '
                             'K2\'s backward')
    errs = {}
    for k, w in want.items():
        g = got[k].cpu()
        if not torch.isfinite(g).all():
            raise AssertionError(f'tiny train step: {k} not finite')
        errs[k] = float((g - w).abs())
        t = tol['grad_norm'] if k == 'grad_norm' else tol['losses']
        check_close(f'tiny train step {k}', g, w, rtol=t, atol=t)

    # the gradients as backward left them: train_step clips in place
    def grads(trainer, metrics):
        unclip = max(float(metrics['grad_norm']) / cfg.GRAD_NORM_CLIP, 1.0)
        return {k: p.grad.cpu() * unclip
                for k, p in trainer.module.named_parameters()}

    g_cpu, g_gpu = grads(cpu, want), grads(gpu, got)
    scale = {k: float(g.abs().max()) for k, g in g_cpu.items()}
    floor = statistics.median(scale.values())
    leaf = {k: float((g_gpu[k] - g).abs().max()) / max(scale[k], floor)
            for k, g in g_cpu.items()}
    worst = max(leaf, key=leaf.get)
    if leaf[worst] > tol['grad_leaf']:
        raise AssertionError(f'tiny train step: gradient of {worst} differs '
                             f'by {leaf[worst]:.3g} of its scale')
    dot = sum(float((g_gpu[k] * g).sum()) for k, g in g_cpu.items())
    cosine = dot / (sum(float((g ** 2).sum()) for g in g_cpu.values())
                    * sum(float((g ** 2).sum()) for g in g_gpu.values())
                    ) ** 0.5
    if cosine < tol['grad_cosine']:
        raise AssertionError(f'tiny train step: gradient cosine {cosine}')

    lr = cfg.OPTIMIZER.LR
    moved, n_sure, n_all, sure_diff = 0.0, 0, 0, 0.0
    gpu_state = gpu.module.state_dict()
    for k, w in cpu.module.state_dict().items():
        diff = (gpu_state[k].cpu() - w).abs()
        if k in g_cpu:
            if float(diff.max()) > 2.001 * lr:
                raise AssertionError(f'tiny train step: parameter {k} differs '
                                     f'by {float(diff.max()):.3g} > 2 * lr')
            # Adam's first update is lr * sign(g) but for eps: it is the
            # same on both devices wherever |g| is well above their noise
            sure = g_cpu[k].abs() >= tol['grad_leaf'] * max(scale[k], floor)
            n_sure += int(sure.sum())
            n_all += sure.numel()
            if sure.any():
                sure_diff = max(sure_diff, float(diff[sure].max()))
            moved = max(moved, float((w - before[k]).abs().max()))
        elif 'num_batches' not in k:
            check_close(f'tiny train step buffer {k}', gpu_state[k].cpu(), w,
                        rtol=tol['bn_buffers'], atol=tol['bn_buffers'])
    if sure_diff > 1e-3 * lr or n_sure < 0.1 * n_all:
        raise AssertionError(f'tiny train step: parameters with a sure '
                             f'gradient ({n_sure} of {n_all}) differ by '
                             f'{sure_diff / lr:.3g} * lr')
    if moved < 0.5 * lr:
        raise AssertionError('tiny train step: no parameter moved')
    emit({'phase': 'train_tiny', 'dtype': 'float64', 'max_abs_err': errs,
          'grad_norm': [float(want['grad_norm']), float(got['grad_norm'])],
          'grad_leaf_rel': {'worst': leaf[worst], 'worst_leaf': worst,
                            'median': statistics.median(leaf.values())},
          'grad_cosine': cosine,
          'sure_parameters': {'share': n_sure / n_all,
                              'max_diff_over_lr': sure_diff / lr},
          'losses': {k: float(v) for k, v in got.items()},
          'tolerance': tol})


def phase_train(cfg, dev, n_steps, card, n_points=80000):
    """Flagship training steps (fp32 parameters, batch 1), every kernel
    count set to 0 before the steps and read after them."""
    import torch
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch.data import make_batch
    from streamingflow_tpu_torch.ops import bin_sum as B
    from streamingflow_tpu_torch.ops import patch_pool as PP
    trainer = P.build_trainer(cfg, device=dev, seed=0)
    # one bin-sum for all the step's clouds, one pool for all its frames,
    # on the fp32 rows as they are (no cast before the launch)
    expect = {'bin_sum': 1, 'patch_pool': 1, 'patch_pool_fp32_rows': 1,
              'patch_pool_bwd': 1}

    def counts():
        return {'bin_sum': B.launches, 'patch_pool': PP.launches,
                'patch_pool_fp32_rows': PP.launches_fp32,
                'patch_pool_bwd': PP.launches_bwd}

    def step(seed):
        batch = make_batch(cfg, 1, seed=seed, n_points=n_points)
        gen = torch.Generator(device=dev).manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = P.train_step(trainer, batch, generator=gen)
        torch.cuda.synchronize()
        return metrics, time.perf_counter() - t0

    state = trainer.module.state_dict()
    start = {k: v.clone() for k, v in state.items()}
    step(100)                                     # warm-up, not counted
    torch.cuda.reset_peak_memory_stats()
    B.launches = PP.launches = PP.launches_fp32 = PP.launches_bwd = 0
    times, losses, per_step, drops = [], [], [], []
    for seed in range(1, n_steps + 1):
        before = counts()
        metrics, dt = step(seed)
        per_step.append({k: v - before[k] for k, v in counts().items()})
        times.append(dt)
        drops.append(PP.last_drops.tolist())
        for k, v in metrics.items():
            if not torch.isfinite(v).all():
                raise AssertionError(f'train step {seed}: {k} not finite')
        losses.append({k: float(v) for k, v in metrics.items()})
    for i, got in enumerate(per_step):
        if got != expect:
            raise AssertionError(f'train step {i}: launches {got}, want '
                                 f'{expect}')
    if any(any(d) for d in drops):
        raise AssertionError(f'train: the patch pool dropped rows: {drops}')
    names = {k for k, _ in trainer.module.named_parameters()}
    moved = {'parameters': 0, 'bn_buffers': 0}
    for k, v in trainer.module.state_dict().items():
        if 'num_batches' in k:
            continue
        if not torch.isfinite(v).all():
            raise AssertionError(f'train: {k} not finite after the steps')
        if not torch.equal(v, start[k]):
            moved['parameters' if k in names else 'bn_buffers'] += 1
    n_buffers = sum(1 for k in state if k not in names
                    and 'num_batches' not in k)
    # a parameter that is 0 and gets an exactly zero gradient stays (Adam's
    # update of 0 is 0), so not every tensor need move; every BN ran
    if moved['parameters'] < 0.9 * len(names) or \
            moved['bn_buffers'] != n_buffers:
        raise AssertionError(f'train: moved {moved} of {len(names)} '
                             f'parameters and {n_buffers} BN buffers')
    emit({'phase': 'train', 'steps': n_steps, 'remat': cfg.MODEL.REMAT,
          'step_s': times, 'median_step_s': statistics.median(times),
          'losses': losses, 'launches': counts(),
          'per_step_launches': per_step, 'patch_pool_drops': drops,
          'moved': {**moved, 'of_parameters': len(names),
                    'of_bn_buffers': n_buffers},
          'peak_mem_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
          'card': card})
    return counts()


def _loader_times(cfg, n_workers, dev):
    """Host seconds a batch of the train loader at ``n_workers`` workers.
    The flagship tree has only a few train windows, so the loader reads
    them over and over (a ``Subset`` that repeats the indices) for
    max(3 x workers, 2 x windows) batches: the first batch's time (the
    workers' start included), and the steady time a batch from the end of
    the workers' first wave (batch ``max(n_workers, 1)``) to the last."""
    import torch
    from torch.utils.data import Subset
    from streamingflow_tpu_torch.data.dataloader import (DataLoader,
                                                         prepare_dataloaders)
    _, _, train_ds, _ = prepare_dataloaders(cfg, return_dataset=True)
    wave = max(n_workers, 1)
    n_batches = max(3 * n_workers, 2 * len(train_ds) // cfg.BATCHSIZE)
    repeated = Subset(train_ds, [i % len(train_ds)
                                 for i in range(n_batches * cfg.BATCHSIZE)])
    loader = DataLoader(repeated, cfg.BATCHSIZE, num_workers=n_workers,
                        pin_memory=torch.device(dev).type == 'cuda')
    t0 = time.perf_counter()
    arrivals = [time.perf_counter() - t0 for _batch in loader]
    loader.close()
    if len(arrivals) != n_batches:
        raise AssertionError(f'cli: the loader gave {len(arrivals)} of '
                             f'{n_batches} batches')
    return {'n_workers': n_workers, 'batches': n_batches,
            'train_windows': len(train_ds), 'first_batch_s': arrivals[0],
            'arrivals': arrivals, 'per_batch_s': (arrivals[-1] - arrivals[wave - 1])
            / (n_batches - wave)}


def _item_breakdown(cfg, n_items=3):
    """Host seconds of the parts of a train item (the loader's work), each
    summed over an item and averaged over ``n_items`` items after one
    warm-up item: frames
    (decode, resize, crop, normalise), depth maps (projection and
    resize), LiDAR (20 sweeps grouped, padded, tile-sorted), BEV labels
    (box rasters, then centers, offsets and flow)."""
    from streamingflow_tpu_torch.data import nuscenes as N
    from streamingflow_tpu_torch.data.dataloader import prepare_dataloaders
    _, _, ds, _ = prepare_dataloaders(cfg, return_dataset=True)
    spent = {}

    def timed(name, fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
        return wrapped

    for name in ('get_input_data', '_get_depth', 'get_label',
                 'get_points_from_multisweeps'):
        setattr(ds, name, timed(name, getattr(ds, name)))
    centers = N.convert_instance_mask_to_center_and_offset_label
    N.convert_instance_mask_to_center_and_offset_label = timed(
        'instance_labels', centers)
    try:
        ds[0]                      # warm-up: first imports, file cache
        spent.clear()
        t0 = time.perf_counter()
        for i in range(n_items):
            ds[i]
        item_s = (time.perf_counter() - t0) / n_items
    finally:
        N.convert_instance_mask_to_center_and_offset_label = centers
    parts = {k: v / n_items for k, v in spent.items()}
    parts['frames'] = parts.pop('get_input_data') - parts['_get_depth']
    parts['depth'] = parts.pop('_get_depth')
    parts['lidar'] = parts.pop('get_points_from_multisweeps')
    parts['box_labels'] = parts.pop('get_label')
    parts['other'] = item_s - sum(parts.values())
    return {'item_s': item_s, **parts}


def phase_cli(dev, card):
    """The port's own entry points on the nuScenes data path: a
    flagship-size tree written from a seed (data/mini_nuscenes.py), the
    loader's host time a batch at 0 workers and at the config's N_WORKERS,
    then ``train.main`` (one epoch of the shipped flagship config with the
    'pallas_patch' pool: 3 steps, validation, a checkpoint) and
    ``evaluate.main`` on the checkpoint it wrote, every kernel count set to
    0 before the two and read after, and read around each step and each
    forecast."""
    import contextlib
    import io
    import shutil
    import tempfile
    import torch
    from streamingflow_tpu_torch import evaluate as E
    from streamingflow_tpu_torch import native
    from streamingflow_tpu_torch import train as T
    from streamingflow_tpu_torch.config import get_cfg
    from streamingflow_tpu_torch.data import mini_nuscenes, raster
    from streamingflow_tpu_torch.data.dataloader import stop_worker_server
    from streamingflow_tpu_torch.ops import bin_sum as B
    from streamingflow_tpu_torch.ops import patch_pool as PP
    from streamingflow_tpu_torch.training.checkpoint import (
        FILENAME, CheckpointManager)
    if not native.available():
        raise AssertionError('cli: the host point-cloud engine '
                             '(streamingflow_tpu_torch/native) did not '
                             'build or load')
    cfg_file = os.path.join(ROOT, 'configs', 'prediction_lc_ode_variable.yml')
    decoder = raster.image_decoder()
    tmp = tempfile.mkdtemp(prefix='streamingflow_cli_')
    try:
        tree, log_dir = os.path.join(tmp, 'nuscenes'), os.path.join(tmp, 'log')
        t0 = time.perf_counter()
        image_format = 'jpg' if decoder == 'PIL' else 'ppm'
        mini_nuscenes.flagship_tree(tree, image_format)
        write_s = time.perf_counter() - t0
        opts = ['DATASET.DATAROOT', tree, 'DATASET.VERSION', 'mini',
                'MODEL.BEV_POOL_BACKEND', 'pallas_patch', 'EPOCHS', '1',
                'LOGGING_INTERVAL', '1', 'LOG_DIR', log_dir]
        cfg = get_cfg(argparse.Namespace(config_file=cfg_file, opts=opts))
        item = _item_breakdown(cfg)
        loader = [_loader_times(cfg, n, dev) for n in (0, cfg.N_WORKERS)]

        def counts():
            return {'bin_sum': B.launches, 'patch_pool': PP.launches,
                    'patch_pool_fp32_rows': PP.launches_fp32,
                    'patch_pool_bwd': PP.launches_bwd}

        per = {'step': [], 'forecast': []}

        def sync():
            if torch.device(dev).type == 'cuda':
                torch.cuda.synchronize()

        def read_around(kind, fn):
            def wrapped(*a, **kw):
                before = counts()
                sync()
                t = time.perf_counter()
                out = fn(*a, **kw)
                sync()
                per[kind].append({'s': time.perf_counter() - t, **{
                    k: v - before[k] for k, v in counts().items()}})
                return out
            return wrapped

        step_fn, fwd_fn = T.train_step, E.eval_forward
        T.train_step = read_around('step', step_fn)
        E.eval_forward = read_around('forecast', fwd_fn)
        B.launches = PP.launches = PP.launches_fp32 = PP.launches_bwd = 0
        try:
            out = T.main(['--config-file', cfg_file, '--device', str(dev),
                          *opts])
            n_val = len(per['forecast'])
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                results = E.main(['--checkpoint', out['checkpoint_dir'],
                                  '--device', str(dev)])
        finally:
            T.train_step, E.eval_forward = step_fn, fwd_fn
        launches = counts()
        print(text.getvalue(), end='', flush=True)

        trainer = out['trainer']
        if trainer.device != torch.device(dev):
            raise AssertionError(f'cli: trained on {trainer.device}')
        for i, losses in enumerate(out['losses']):
            bad = [k for k, v in losses.items() if not math.isfinite(v)]
            if bad:
                raise AssertionError(f'cli: step {i}: {bad} not finite')
        # K1 once a step and a forecast, K2 once each (the step's and the
        # fp32 model's forecasts on fp32 rows), K2's backward once a step
        want = {'step': {'bin_sum': 1, 'patch_pool': 1,
                         'patch_pool_fp32_rows': 1, 'patch_pool_bwd': 1},
                'forecast': {'bin_sum': 1, 'patch_pool': 1,
                             'patch_pool_fp32_rows': 1, 'patch_pool_bwd': 0}}
        for kind, calls in per.items():
            for i, got in enumerate(calls):
                got = {k: v for k, v in got.items() if k != 's'}
                if got != want[kind]:
                    raise AssertionError(f'cli: {kind} {i}: launches {got}, '
                                         f'want {want[kind]}')
        if len(per['step']) != len(out['losses']) or not per['step']:
            raise AssertionError(f"cli: {len(per['step'])} steps counted, "
                                 f"{len(out['losses'])} logged")
        for key in ('vehicle IoU:', 'pq:', 'sq:', 'rq:',
                    'mean forward time:'):
            if key not in text.getvalue():
                raise AssertionError(f'cli: evaluate printed no {key!r}')

        # the checkpoint, reloaded, is the trained state exactly
        ckpt = CheckpointManager(out['checkpoint_dir'])
        path = os.path.join(out['checkpoint_dir'], str(ckpt.latest_step()),
                            FILENAME)
        t0 = time.perf_counter()
        raw = ckpt.restore_raw()
        load_s = time.perf_counter() - t0
        state = trainer.module.state_dict()
        opt = trainer.optimizer.state_dict()
        if raw['model'].keys() != state.keys() or not all(
                torch.equal(raw['model'][k], v.cpu())
                for k, v in state.items()):
            raise AssertionError('cli: the checkpoint\'s module state '
                                 'differs from the trained one')
        if raw['optimizer']['param_groups'] != opt['param_groups'] or \
                raw['optimizer']['state'].keys() != opt['state'].keys() or \
                not all(torch.equal(raw['optimizer']['state'][i][k],
                                    v.cpu())
                        for i, st in opt['state'].items()
                        for k, v in st.items()):
            raise AssertionError('cli: the checkpoint\'s Adam state '
                                 'differs from the trained one')
        prof = out['profiler']
        line = {
            'phase': 'cli', 'config': os.path.relpath(cfg_file, ROOT),
            'native_engine': native.available(),
            'image_decoder': decoder, 'image_format': image_format,
            'tree_write_s': write_s, 'item_host_s': item, 'loader': loader,
            'train_batches': len(per['step']),
            'step_s': [c['s'] for c in per['step']],
            'median_step_s': statistics.median(c['s'] for c in per['step']),
            'eval_forward_s': [c['s'] for c in per['forecast']],
            'median_eval_forward_s': statistics.median(
                c['s'] for c in per['forecast'][n_val:]),
            'train_spans_s': dict(prof.totals),
            'losses': out['losses'], 'val': out['val'],
            'eval': {'vehicle_iou': results['iou'].tolist(),
                     **{k: v.tolist() for k, v in results['pq'].items()}},
            'checkpoint': {'bytes': os.path.getsize(path),
                           'save_s': prof.totals['checkpoint'],
                           'load_s': load_s},
            'launches': launches,
            'per_step_launches': [{k: v for k, v in c.items() if k != 's'}
                                  for c in per['step']],
            'card': card}
        emit(line)
        return launches
    finally:
        # the loaders closed their workers; stop the server they were
        # forked from
        stop_worker_server()
        shutil.rmtree(tmp, ignore_errors=True)


def _descendants():
    """(pid, command line) of every live process below this one."""
    parent = {}
    for entry in filter(str.isdigit, os.listdir('/proc')):
        try:
            with open(f'/proc/{entry}/stat') as f:
                state, ppid = f.read().rsplit(')', 1)[1].split()[:2]
        except (OSError, ValueError):
            continue
        if state != 'Z':
            parent[int(entry)] = int(ppid)
    found, frontier = [], [os.getpid()]
    while frontier:
        kids = [p for p, pp in parent.items() if pp in frontier]
        found += kids
        frontier = kids
    out = []
    for pid in found:
        try:
            with open(f'/proc/{pid}/cmdline') as f:
                out.append((pid, f.read().replace('\0', ' ')[:200]))
        except OSError:
            pass
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--requests', type=int, default=3)
    ap.add_argument('--train-steps', type=int, default=3)
    ap.add_argument('--out', default=os.path.join(ROOT, 'runs',
                                                  'chip_smoke.json'))
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available; nothing was run',
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, 'streamingflow_tpu_torch')):
        print('chip_smoke: streamingflow_tpu_torch/ is not beside this '
              'script; run it from the repository root', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = torch.device('cuda', 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({'phase': 'device', 'name': name, 'nvidia_smi': smi,
          'count': torch.cuda.device_count(), 'torch': torch.__version__,
          'cuda': torch.version.cuda})

    from concurrent.futures import ThreadPoolExecutor
    from streamingflow_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    # every source and the pool's loads-only variant (phase patch_pool), all
    # nvcc processes started together
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(cuda_lib.build),
                pool.submit(cuda_lib.build, ['patch_pool'],
                            ('PATCH_POOL_LOADS_ONLY=1',))]
        for job in jobs:
            job.result()
    emit({'phase': 'build', 'seconds': time.perf_counter() - t0,
          'ptxas': {k: [ln for ln in v.splitlines() if 'registers' in ln
                        or 'spill' in ln] for k, v in
                    cuda_lib.BUILD_LOG.items()}})

    from streamingflow_tpu_torch.data import flagship_config
    cfg = flagship_config()
    results = {}
    phase_bin_sum(cfg, dev, results)
    phase_patch_pool(cfg, dev, results)
    phase_winfuse(dev, results)
    phase_tiny(dev)
    phase_tiny_spconv(dev)
    phase_tiny_bf16(dev)
    launches = phase_forward(cfg, dev, args.requests, smi)
    launches['winfuse'] = phase_forward(
        flagship_config(backbone='spconv8x'), dev, args.requests,
        smi)['winfuse']
    phase_bin_sum_grouped(cfg, dev, results)
    phase_patch_pool_bwd(cfg, dev, results)
    phase_train_tiny(dev)
    train_launches = phase_train(cfg, dev, args.train_steps, smi)
    cli_launches = phase_cli(dev, smi)

    # launches: of the serving path's requests (bin_sum, patch_pool,
    # winfuse), of the training steps (patch_pool_bwd; train_launches for the
    # forward kernels), of the experiment tool (bin_sum_grouped)
    kernels = [
        dict(name='bin_sum', route='cuda',
             source='streamingflow_tpu_torch/csrc/bin_sum.cu',
             replaces='streamingflow_tpu/ops/pallas_bin.py:63',
             launches=launches['bin_sum'],
             train_launches=train_launches['bin_sum'],
             cli_launches=cli_launches['bin_sum'], **results['bin_sum']),
        dict(name='patch_pool', route='cuda',
             source='streamingflow_tpu_torch/csrc/patch_pool.cu',
             replaces='streamingflow_tpu/ops/pallas_patch_pool.py:49',
             launches=launches['patch_pool'],
             train_launches=train_launches['patch_pool'],
             cli_launches=cli_launches['patch_pool'],
             **results['patch_pool']),
        dict(name='winfuse', route='cuda',
             source='streamingflow_tpu_torch/csrc/winfuse.cu',
             replaces='streamingflow_tpu/ops/pallas_winfuse.py:153',
             launches=launches['winfuse'], **results['winfuse']),
        dict(name='bin_sum_grouped', route='cuda',
             source='streamingflow_tpu_torch/csrc/bin_sum_grouped.cu',
             replaces='tools/exp_bin_variants.py:26',
             **results['bin_sum_grouped']),
        dict(name='patch_pool_bwd', route='cuda',
             source='streamingflow_tpu_torch/csrc/patch_pool.cu',
             replaces='streamingflow_tpu/ops/pallas_patch_pool.py:257',
             launches=train_launches['patch_pool_bwd'],
             cli_launches=cli_launches['patch_pool_bwd'],
             **results['patch_pool_bwd']),
    ]
    for k in kernels:
        if k['launches'] < 1:
            raise AssertionError(f"{k['name']} was not launched on the main "
                                 f"path")
    # every process a phase started (nvcc, loader workers, the workers'
    # fork server and resource tracker) has ended
    left = _descendants()
    if left:
        raise AssertionError(f'processes still running: {left}')
    line = {'kernels': kernels}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump({'card': smi, **line}, f, indent=1)
    emit(line)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
