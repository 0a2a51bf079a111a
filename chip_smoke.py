#!/usr/bin/env python3
"""Card gate of the PyTorch port: build its CUDA kernels, hold each against
its plain PyTorch version, serve full-width forecasts and take full-width
training steps on one GPU.

    python3 chip_smoke.py [--requests 3] [--train-steps 3]
                          [--out runs/chip_smoke.json]

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit.  Phases, each printing one JSON line:

  1. device      the card, and nvidia-smi's name and power limit
  2. build       nvcc of every csrc/*.cu, all at once, with its time
  3. bin_sum     kernel vs plain version at flagship shapes (one 80k-point
                 cloud, 1600^2 pillar grid, pillar epilogue, bf16 out,
                 presorted and unsorted; raw fp32 sums too; a hot trash bin
                 holding half the rows); its time alone on prepared inputs
                 and through its wrapper, the raw fp32 mode against
                 index_add_ into a grid zeroed in the same call; the 5
                 clouds of a request in one launch (pillarize_batch) against
                 the per-cloud loop and torch.stack
  4. patch_pool  kernel vs plain version at flagship shapes (3 frames x 6
                 cameras x 48 depth bins x 28 x 60 x 64 from the synthetic
                 calibration) and a forced-overflow case
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
  8. forward     the flagship forward (bench.py's full_cfg: 6 cameras at
                 224x480 with EfficientNet-B4, 5 clouds of 80k points on the
                 pillar8x backbone, 200x200 BEV, variable-step GRU-ODE,
                 3 past frames -> 4 futures) in bf16, answering --requests
                 requests with kernel launch counts read around them
  9. forward_spconv  the same on the spconv8x backbone (full_cfg with
                 STREAMINGFLOW_BENCH_BACKBONE=spconv8x, ZFORM=winfuse)
 10. bin_sum_grouped  the grouped bin-sum kernel vs the plain version and vs
                 bin_sum at the same cloud (presorted and unsorted, bf16 and
                 raw fp32, k_tiles 4 / 8 / 16, alone and through the
                 wrapper; the hot trash bin), then the experiment tool
                 (tools/exp_bin_variants.py of the port: 5 bench-like clouds)
                 with the kernel's launches read around it
 11. patch_pool_bwd  the pool's gradient on the card (backward kernel) vs the
                 plain version's autograd gradient at flagship shapes and in
                 the forced-overflow case
 12. train_tiny  one tiny camera+LiDAR training step on the card (kernels)
                 vs the same step on the CPU (plain versions), both in float64
 13. train       --train-steps flagship training steps (fp32 parameters,
                 batch 1, MODEL.REMAT as configured) after one warm-up, with
                 the kernel launch counts read around each step
 14. kernels     every kernel of the port with its launches, error and times

The last line is {"ok": true, "device": {...}}.  Any failed phase raises, so
the script exits non-zero with no result; so does a machine without CUDA,
and a directory without the port beside this script.  TF32 is off for both
matmuls and cuDNN convolutions (torch.backends.cuda.matmul.allow_tf32 =
torch.backends.cudnn.allow_tf32 = False): fp32 work runs in full fp32.
"""
import argparse
import json
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


def phase_patch_pool(cfg, dev, results):
    """K2 at the flagship frame stack, and one forced overflow."""
    import torch
    from streamingflow_tpu_torch.ops import patch_pool as PP
    gen = torch.Generator(device=dev).manual_seed(0)
    x, coords, kept, nx, ny = flagship_pool_inputs(cfg, dev, gen)
    got, drops = PP.patch_pool_frames(x, coords, kept, nx, ny)
    want, want_drops = PP.patch_pool_frames_plain(x, coords, kept, nx, ny)
    torch.cuda.synchronize()
    if not torch.equal(drops.cpu(), want_drops.cpu()):
        raise AssertionError(f'patch_pool drops {drops.tolist()} != plain '
                             f'{want_drops.tolist()}')
    # fp32 sums of the same bf16 rows, atomics in a run-to-run order: equal
    # up to fp32 reassociation over up to a few hundred rows a cell
    tol = dict(rtol=1e-4, atol=1e-4)
    check_close('patch_pool', got, want, **tol)
    err = max_err(got, want)

    # forced overflow: cells scattered over the grid within each group
    ox = torch.randn(2, 2, 3, 28, 8, 64, device=dev, generator=gen,
                     dtype=torch.bfloat16)
    oc = torch.randint(0, nx, (2, 2, 3, 28, 8, 2), device=dev,
                       generator=gen, dtype=torch.int32)
    ok = torch.rand(2, 2, 3, 28, 8, device=dev, generator=gen) > 0.2
    o_got, o_drops = PP.patch_pool_frames(ox, oc, ok, nx, ny)
    o_want, o_want_drops = PP.patch_pool_frames_plain(ox, oc, ok, nx, ny)
    torch.cuda.synchronize()
    if not torch.equal(o_drops.cpu(), o_want_drops.cpu()) or \
            int(o_drops.min()) <= 0:
        raise AssertionError(f'patch_pool overflow drops {o_drops.tolist()}'
                             f' vs plain {o_want_drops.tolist()}')
    check_close('patch_pool overflow', o_got, o_want, **tol)

    fits = PP.fits_mask(coords, kept, nx, ny)[1]
    cell = (torch.arange(x.shape[0], device=dev).view(-1, 1, 1, 1, 1)
            * (nx * ny) + coords[..., 0] * ny + coords[..., 1])[fits].long()
    rows = x[fits].float()
    grid = torch.zeros(x.shape[0] * nx * ny, 64, device=dev)
    ms = cuda_ms(lambda: PP.patch_pool_frames(x, coords, kept, nx, ny))
    plain_ms = cuda_ms(
        lambda: PP.patch_pool_frames_plain(x, coords, kept, nx, ny))
    library_ms = cuda_ms(lambda: grid.index_add_(0, cell, rows))
    # the features of the rows that are summed, every row's coords and
    # mask, the grid and the counts
    n_fit = int(fits.sum())
    n_bytes = (n_fit * 64 * 2 + coords.numel() * 4 + kept.numel()
               + got.numel() * 4 + drops.numel() * 4)
    flops = n_fit * 64
    bound_ms = max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
    results['patch_pool'] = dict(
        max_abs_err=err[0], ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_by='bytes')
    emit({'phase': 'patch_pool', 'x_shape': list(x.shape),
          'kept_rows': int(kept.sum()), 'drops': drops.tolist(),
          'max_abs_err': err[0], 'max_rel_err': err[1], 'tolerance': tol,
          'overflow_drops': o_drops.tolist(), 'kernel_ms': ms,
          'twin_ms': plain_ms, 'library_ms': library_ms,
          'library_call': 'index_add_ of the fitting rows into the grid',
          'bound_us': bound_ms * 1e3, 'bytes': n_bytes})


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
    """Registers, spills and stack of each kernel in an nvcc -Xptxas -v
    log."""
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


def _tiny_spconv_config():
    """tiny_config on the spconv8x backbone, with column caps and a window
    plan sized to it (tiny_config keeps the flagship's 65536 slots)."""
    from streamingflow_tpu_torch.data import tiny_config
    cfg = tiny_config()
    cfg.MODEL.MODALITY.USE_LIDAR = True
    cfg.MODEL.ENCODER.OUT_CHANNELS = 64
    cfg.MODEL.BEV_POOL_BACKEND = 'pallas_patch'
    cfg.PROBABILISTIC.ENABLED = False
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
    from streamingflow_tpu_torch.data import make_batch, tiny_config
    from streamingflow_tpu_torch.ops import bin_sum as B
    from streamingflow_tpu_torch.ops import patch_pool as PP
    cfg = tiny_config()
    cfg.MODEL.MODALITY.USE_LIDAR = True
    cfg.MODEL.ENCODER.OUT_CHANNELS = 64
    cfg.MODEL.BEV_POOL_BACKEND = 'pallas_patch'
    cfg.PROBABILISTIC.ENABLED = False
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
    # pillar8x: one bin-sum for all clouds; spconv8x: one K3 launch over
    # the stacked clouds per submanifold conv (conv_input and the two convs
    # of each block of stages 1 and 2)
    se = cfg.MODEL.SPARSE_ENCODER
    blocks = [len(c) - 1 for c in se.ENCODER_CHANNELS[:2]]
    expect = ({'bin_sum': 0, 'winfuse': 1 + 2 * sum(blocks)} if spconv
              else {'bin_sum': 1, 'winfuse': 0})

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
        if any(got[k] != v for k, v in expect.items()) or \
                got['patch_pool'] < 1:
            raise AssertionError(f'request {i}: launches {got}, want '
                                 f'{expect} and patch_pool >= 1')
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


def _tiny_train_config():
    from streamingflow_tpu_torch.data import tiny_config
    cfg = tiny_config()
    cfg.MODEL.MODALITY.USE_LIDAR = True
    cfg.MODEL.ENCODER.OUT_CHANNELS = 64
    cfg.MODEL.BEV_POOL_BACKEND = 'pallas_patch'
    cfg.PROBABILISTIC.ENABLED = False
    return cfg


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
    cfg = _tiny_train_config()
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
    # one bin-sum for all the step's clouds
    expect = {'bin_sum': 1, 'patch_pool': 1, 'patch_pool_bwd': 1}

    def counts():
        return {'bin_sum': B.launches, 'patch_pool': PP.launches,
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
    B.launches = PP.launches = PP.launches_bwd = 0
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

    from streamingflow_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    cuda_lib.build()
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
    launches = phase_forward(cfg, dev, args.requests, smi)
    launches['winfuse'] = phase_forward(
        flagship_config(backbone='spconv8x'), dev, args.requests,
        smi)['winfuse']
    phase_bin_sum_grouped(cfg, dev, results)
    phase_patch_pool_bwd(cfg, dev, results)
    phase_train_tiny(dev)
    train_launches = phase_train(cfg, dev, args.train_steps, smi)

    # launches: of the serving path's requests (bin_sum, patch_pool,
    # winfuse), of the training steps (patch_pool_bwd; train_launches for the
    # forward kernels), of the experiment tool (bin_sum_grouped)
    kernels = [
        dict(name='bin_sum', route='cuda',
             source='streamingflow_tpu_torch/csrc/bin_sum.cu',
             replaces='streamingflow_tpu/ops/pallas_bin.py:63',
             launches=launches['bin_sum'],
             train_launches=train_launches['bin_sum'], **results['bin_sum']),
        dict(name='patch_pool', route='cuda',
             source='streamingflow_tpu_torch/csrc/patch_pool.cu',
             replaces='streamingflow_tpu/ops/pallas_patch_pool.py:49',
             launches=launches['patch_pool'],
             train_launches=train_launches['patch_pool'],
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
             **results['patch_pool_bwd']),
    ]
    for k in kernels:
        if k['launches'] < 1:
            raise AssertionError(f"{k['name']} was not launched on the main "
                                 f"path")
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
