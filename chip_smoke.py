#!/usr/bin/env python3
"""Card gate of the PyTorch port: build its CUDA kernels, hold each against
its plain PyTorch version, serve full-width forecasts and take full-width
training steps on one GPU.

    python3 chip_smoke.py [--requests 3] [--train-steps 3]
                          [--out runs/chip_smoke.json]

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit.  ``--out`` receives the kernels line and every phase's
line (``phases``).  Phases, each printing one JSON line:

  1. device      the card, and nvidia-smi's name and power limit
  2. build       nvcc of every csrc/*.cu (and the pool's loads-only
                 variant and the d weights' two ablations), all at once,
                 with its time
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
                 report (registers, spills); its backward at stage 1 and
                 stage 2 in bf16 and fp32 and over the forced-drop plan:
                 d feats (the forward's kernels over the reversed map) and
                 d weights (csrc/winfuse_wgrad.cu) vs the plain forward's
                 autograd over the full found, with times and bounds, and
                 conv_input's d weights (Cin 5); d weights launched three
                 times a case for equal bits, the bf16 d weights' ptxas
                 report free of spills, beside it torch.matmul of the
                 compacted, pre-gathered products alone (gemm_alone_ms),
                 and its time split by two ablations (kernel_parts); the
                 wide kernels (past 32 channels) at stage 3 (64 -> 64, nz
                 11) and stage 4 (128 -> 128, nz 5) of the same clouds'
                 DENSE_TAIL_FROM_STAGE 0 geometry, forward, d feats and d
                 weights, bf16 and fp32, under the same bars
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
 10b. sparse_options  the spconv8x encoder's other settings at flagship
                 width with the seed-0 weights of one build_model: 'win',
                 'sep' (equal to 'banded' and 'conv'), DENSE_TAIL_FROM_STAGE
                 0, 2, 4 and 5, ENGINE 'gather' and 'tiled': --requests
                 bf16 forecasts each (median latency, peak memory, K3
                 launches a request held to K3_PER_FORECAST, capacity
                 counters) and the encoder alone in fp32 against the 'sep',
                 tail-3 one at 1e-4 of its scale (against its own plain
                 versions on the card where a cap is hit); tail 1 (the
                 stage-1 grid dense) as the bf16 encoder alone at the clouds
                 its reckoned peak allows, fp32 on one cloud; one flagship
                 training step on 'gather' and one on tail 0 (the wide d
                 feats and d weights)
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
 14b. train_tiny_spconv  one tiny camera + spconv8x training step on the
                 card (K2, K3 forward, d feats, d weights) vs the same step
                 on the CPU, fp32, at a bar derived from the CPU's own fp32
                 step against its fp64 step
 14c. train_spconv  --train-steps flagship spconv8x training steps
                 (fp32 parameters, batch 1, LiDAR branch in bf16, MODEL.REMAT
                 and REMAT_LADDER on) after one warm-up: step time, peak
                 memory, launches a step, the diag/* capacity counters
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
 16. dp_nccl1    the data-parallel step through an NCCL group of one rank
                 (a spawned process on cuda:0) against train_step here: the
                 flagship pillar8x training step at batch 1, PROBABILISTIC,
                 dropout and drop-connect on, beside train_step against
                 itself run twice (the card's run-to-run spread)
 17. dp_gloo2    two gloo ranks on cuda:0, one data-parallel flagship
                 pillar8x step of global batch 2 against one process's
                 batch-2 step (and that step's spread); the measures against
                 the JAX package's DP bars, held at DP_BARS['card']; each
                 rank's step time (3 after the first), the gradient
                 all-reduce's time and bytes, collectives a step, peak
                 memory and K1 / K2 / K2 backward launches, the ranks'
                 parameters equal
 18. dp_spconv   the same on the tiny spconv8x configuration (K2, K3, d
                 feats, d weights in each rank; MaskedBatchNorm's global
                 statistics), at the tiny fp32 step's bars
 19. dp_cli      python -m torch.distributed.run --nproc_per_node 2 -m
                 streamingflow_tpu_torch.train --dist-backend gloo on phase
                 cli's tree (BATCHSIZE 2, one epoch): rank 0's checkpoint,
                 and the validation sharded over the ranks equal to
                 evaluate.main of it in one process (IoU, PQ, SQ, RQ 1e-3)
 14d. bf16_flagship  the flagship bf16 forecast (pillar8x, then spconv8x)
                 against the card's own fp32 forecast with the same weights,
                 output by output, at max(2 x the error of the bf16
                 forecast with every hand kernel replaced by its plain
                 version on the card, 4 bf16 steps of the output's scale)
 14e. determinism  each hand kernel (K1, K2 forward and backward, K3
                 forward and d feats) launched twice on one input, equal
                 bits or not; K1's and K2's deterministic routes (exact
                 integer sums, under torch.use_deterministic_algorithms):
                 equal bits, error against the atomic route and the plain
                 version, times; the flagship pillar8x training step twice
                 in a spawned process as the other phases run it, and
                 twice with cuBLAS's fixed workspace, cuDNN's deterministic
                 algorithms and ATen's deterministic mode (warn only; the
                 ops without a deterministic route named), which must
                 repeat bit for bit
 15b. reference_import  a seeded flagship spconv8x train module's weights
                 written as a reference (Lightning) checkpoint under the
                 reference's names (tests/torch_reference_names.py),
                 imported by python -m streamingflow_tpu_torch.tools.
                 convert_checkpoint and held equal to them bit for bit
                 (the distribution head aside); a bf16 forecast with each
                 set of weights within the forecast's own run-to-run
                 spread; evaluate.main on the imported checkpoint over
                 phase cli's tree (K2 and K3 counted); distribution_forward
                 of the three methods at the flagship present state, card
                 against CPU (1e-5)
 14f. planning   (after train) the flagship with PLANNING.ENABLED (600
                 candidates of the CAN-bus sampler, GRU state 64): --requests
                 bf16 forecasts, each followed by the planner as evaluate
                 runs it (median latency with and without it, K1 and K2 once
                 a request); the planner alone at flagship shapes (B 3, one
                 item per command) in fp32 train mode, card against CPU:
                 costs, loss, trajectory (beyond near ties), gradients of
                 its parameters and the cost volume (PLAN_BARS); its
                 forward, costs and lane cost times at batch 1;
                 --train-steps flagship steps with the planning loss
                 (finite, nonzero gradients of the planner and the
                 costvolume head, step time and peak memory beside phase
                 train's, K1, K2 and K2's backward once a step)
 15c. planning_cli  evaluate.main on phase cli's tree (with a CAN bus) with
                 PLANNING.ENABLED: finite planning@1s and @2s obj_col,
                 obj_box_col and L2, candidates not all zero, K1 and K2 once
                 a forecast
 20. kernels     every kernel of the port with its launches, error and times
                 (the wide K3 rows: launches of sparse_options' tail-0
                 forecasts and step)
                 (cli_launches: of phase cli; import_launches: of phase
                 reference_import's evaluation; planning_launches: of phases
                 planning and planning_cli); then a check that every
                 process a phase started (nvcc, the loaders' workers, their
                 fork server and resource tracker) has ended

The last line is {"ok": true, "device": {...}}.  Any failed phase raises, so
the script exits non-zero with no result; so does a machine without CUDA,
and a directory without the port beside this script.  TF32 is off for both
matmuls and cuDNN convolutions (device.pin_tf32, as in the port's CLIs):
fp32 work runs in full fp32.
"""
import argparse
import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM peaks (NVIDIA data sheet, at 700 W): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores, dense bf16 FLOP/s of the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12


# every line the phases print, kept for the --out file (a long run's output
# may be read only from its end)
EMITTED = []


def emit(obj):
    EMITTED.append(obj)
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


# ---------------------------------------------------------- sparse options
# The spconv8x encoder's other settings, each a change to
# flagship_config(backbone='spconv8x').MODEL.SPARSE_ENCODER ('winfuse',
# dense tail from stage 3): phase sparse_options.  'sep' stands for 'banded'
# and 'conv' too (one route in the port, checked equal).
SPARSE_OPTIONS = (
    ('win', {'Z_FORMULATION': 'win'}),
    ('sep', {'Z_FORMULATION': 'sep'}),
    ('tail0', {'DENSE_TAIL_FROM_STAGE': 0}),
    ('tail2', {'DENSE_TAIL_FROM_STAGE': 2}),
    ('tail4', {'DENSE_TAIL_FROM_STAGE': 4}),
    ('tail5', {'DENSE_TAIL_FROM_STAGE': 5}),
    ('gather', {'ENGINE': 'gather'}),
    ('tiled', {'ENGINE': 'tiled'}),
)
# K3 launches a spconv8x forecast by DENSE_TAIL_FROM_STAGE on the column
# engine (5 clouds stacked, one launch a submanifold conv: conv_input, then
# two a basic block of each column stage); none on the site engines
K3_PER_FORECAST = {3: 9, 0: 17, 5: 17, 4: 13, 2: 5, 1: 1}
# the encoder's fp32 output against the 'sep', tail-3 one (or the setting's
# own with every kernel's plain version, where a cap is hit), of its scale
SPARSE_OPTIONS_BAR = 1e-4


def _sparse_cfg(changes):
    from streamingflow_tpu_torch.data import flagship_config
    cfg = flagship_config(backbone='spconv8x')
    for k, v in changes.items():
        setattr(cfg.MODEL.SPARSE_ENCODER, k, v)
    return cfg


def _k3_expected(se):
    return (K3_PER_FORECAST[se.DENSE_TAIL_FROM_STAGE]
            if se.ENGINE == 'column' else 0)


def _capacity(enc):
    """The encoder's capacity counters of its last forward (host ints) and
    the caps hit: column caps filled, sites dropped at the entry, taps the
    window plans dropped, site caps filled, sites past the tile caps."""
    counts = {k: int(v) for k, v in {**enc.last_diagnostics,
                                     **enc.last_capacity}.items()}
    counts.update({f'n_dropped_{k}': int(v.sum())
                   for k, v in enc.last_n_dropped.items()})
    hits = sorted(k for k, v in counts.items() if v and (
        'hit' in k or 'dropped' in k))
    return counts, hits


def _encoder_fp32(se, enc_state, pts, plain=False):
    """The LiDAR encoder of ``se`` alone in fp32 (TF32 off) with the
    seed-0 encoder weights on points (1, N, P, 5): (output, encoder, its
    ``taps`` the found taps of its column stages); with ``plain`` every
    kernel replaced by its plain version on the card."""
    import copy
    import torch
    from streamingflow_tpu_torch.models import lidar_encoder as L
    se = copy.deepcopy(se)
    se.COMPUTE_DTYPE = 'float32'
    enc = L.LidarBEVEncoder(se).to(pts.device).eval()
    enc.load_state_dict(enc_state)
    with torch.no_grad(), (_plain_on_card() if plain
                           else contextlib.nullcontext()):
        geo = enc.geometry(pts)
        out = enc.ladder(geo.feats, geo)
    torch.cuda.synchronize()
    # the taps the column stages took (the route of a z formulation)
    enc.taps = (torch.cat([g.found for g in geo.columns], 1)
                if enc.column else None)
    return out, enc


def _held(out, ref):
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    return {'max_abs_err': err, 'scale': scale,
            'err_of_scale': err / max(scale, 1e-30),
            'ok': err <= SPARSE_OPTIONS_BAR * scale}


def _spconv_step(cfg, dev):
    """One flagship spconv8x training step of cfg (fp32 parameters, the
    LiDAR branch in bf16, MODEL.REMAT and REMAT_LADDER as configured), K3's
    launches read around it: step s, peak GiB, losses, launches."""
    import torch
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch.data import make_batch
    from streamingflow_tpu_torch.ops import winfuse as WF
    trainer = P.build_trainer(cfg, device=dev, seed=0)
    batch = make_batch(cfg, 1, seed=1, n_points=80000)
    for a in ('launches', 'launches_dgrad', 'launches_wgrad'):
        setattr(WF, a, 0)
        setattr(WF, a + '_wide', {})
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(1)
    metrics = P.train_step(trainer, batch, generator=gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for k, v in metrics.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f'sparse_options step: {k} not finite')
    for k, v in trainer.module.state_dict().items():
        if not torch.isfinite(v).all():
            raise AssertionError(f'sparse_options step: {k} not finite')
    out = {'step_s': dt,
           'peak_mem_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
           'losses': {k: float(v) for k, v in metrics.items()
                      if not k.startswith('diag/')},
           'diagnostics': {k[5:]: int(v) for k, v in metrics.items()
                           if k.startswith('diag/')},
           'launches': {a: getattr(WF, a) for a in (
               'launches', 'launches_dgrad', 'launches_wgrad',
               'launches_wide', 'launches_dgrad_wide',
               'launches_wgrad_wide')}}
    del trainer
    torch.cuda.empty_cache()
    return out


def phase_sparse_options(dev, n_requests, card):
    """The spconv8x encoder's other settings at flagship width, one set of
    seed-0 weights through build_model: for each of SPARSE_OPTIONS,
    n_requests bf16 forecasts (after a warm-up) with their median latency,
    peak memory, K3 launches a request (held to K3_PER_FORECAST) and the
    capacity counters; the encoder alone in fp32 (TF32 off) on one
    request's 5 clouds against the 'sep', tail-3 encoder, or against its own
    plain-on-card output where a cap is hit in either, at
    SPARSE_OPTIONS_BAR of the output's scale.  DENSE_TAIL_FROM_STAGE 1 (the
    stage-1 grid dense): its peak reckoned first, the bf16 encoder alone
    at the clouds that fit, its fp32 output on one cloud.  Then one
    flagship training step each on ENGINE 'gather' and on
    DENSE_TAIL_FROM_STAGE 0 (the wide d feats and d weights).  Returns the
    wide kernels' launches: forecasts (tail 0) and step (tail 0)."""
    import math
    import torch
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch.data import make_batch
    from streamingflow_tpu_torch.models import lidar_encoder as L
    from streamingflow_tpu_torch.ops import winfuse as WF
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    base = _sparse_cfg({})
    state = P.build_model(base, device=dev, seed=0).state_dict()
    enc_state = {k[len('lidar_encoder.'):]: v for k, v in state.items()
                 if k.startswith('lidar_encoder.')}
    pts = torch.from_numpy(make_batch(base, 1, seed=1, n_points=80000)
                           ['points']).to(dev)
    ref_se = _sparse_cfg({'Z_FORMULATION': 'sep'}).MODEL.SPARSE_ENCODER
    ref, ref_enc = _encoder_fp32(ref_se, enc_state, pts)
    _, ref_hits = _capacity(ref_enc)
    del ref_enc
    line = {'phase': 'sparse_options', 'clouds': pts.shape[1],
            'reference': "'sep', DENSE_TAIL_FROM_STAGE 3, fp32",
            'reference_caps_hit': ref_hits, 'bar': SPARSE_OPTIONS_BAR,
            'settings': {}}
    wide = {}
    for name, changes in SPARSE_OPTIONS:
        cfg = _sparse_cfg(changes)
        se = cfg.MODEL.SPARSE_ENCODER
        model = P.build_model(cfg, device=dev, dtype=bf16)
        model.load_state_dict(state)
        t, t_ = cfg.TIME_RECEPTIVE_FIELD, cfg.N_FUTURE_FRAMES

        def request(seed):
            batch = make_batch(cfg, 1, seed=seed, n_points=80000)
            args = P.batch_to_model_args(batch, cfg, device=dev,
                                         image_dtype=bf16)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with torch.no_grad():
                out = model(**args, generator=torch.Generator(
                    device=dev).manual_seed(seed))
            torch.cuda.synchronize()
            return out, time.perf_counter() - t1

        request(100)                              # warm-up, not counted
        torch.cuda.reset_peak_memory_stats()
        WF.launches, WF.launches_wide = 0, {}
        lat, per_request = [], []
        for seed in range(1, n_requests + 1):
            before = WF.launches
            out, dt = request(seed)
            lat.append(dt)
            per_request.append(WF.launches - before)
            seg = out['segmentation']
            if seg.shape[:2] != (1, t + t_) or not torch.isfinite(seg).all():
                raise AssertionError(f'sparse_options {name}: segmentation '
                                     f'{tuple(seg.shape)}, finite '
                                     f'{bool(torch.isfinite(seg).all())}')
        counts, hits = _capacity(model.lidar_encoder)
        entry = {'changes': changes, 'latency_s': lat,
                 'median_latency_s': statistics.median(lat),
                 'peak_mem_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
                 'k3_launches_per_request': per_request,
                 'k3_expected': _k3_expected(se),
                 'wide_launches': dict(WF.launches_wide),
                 'capacity': counts, 'caps_hit': hits}
        if name == 'tail0':
            wide['forecast'] = {'launches_wide': dict(WF.launches_wide)}
        del model, out
        torch.cuda.empty_cache()
        if any(n != entry['k3_expected'] for n in per_request):
            raise AssertionError(f'sparse_options {name}: K3 launches '
                                 f'{per_request}, want '
                                 f'{entry["k3_expected"]} a request')
        # the encoder alone in fp32
        got, enc = _encoder_fp32(se, enc_state, pts)
        _, enc_hits = _capacity(enc)
        if enc_hits or ref_hits:
            entry['fp32_against'] = 'plain on the card (a cap is hit)'
            entry['fp32'] = _held(got, _encoder_fp32(
                se, enc_state, pts, plain=True)[0])
        else:
            entry['fp32_against'] = 'reference'
            entry['fp32'] = _held(got, ref)
        if name == 'sep':
            # 'banded' and 'conv' take the 'sep' route: every found tap, so
            # the same maps, and outputs within the card's run-to-run
            # spread of 'sep' (cuDNN's dense tail need not repeat its bits)
            entry['sep_run_to_run'] = _held(
                _encoder_fp32(se, enc_state, pts)[0], got)
            for form in ('banded', 'conv'):
                other = _sparse_cfg({'Z_FORMULATION': form})
                o_out, o_enc = _encoder_fp32(other.MODEL.SPARSE_ENCODER,
                                             enc_state, pts)
                same = {**_held(o_out, got),
                        'bits_equal': torch.equal(o_out, got),
                        'taps_equal': torch.equal(o_enc.taps, enc.taps)}
                entry[f'{form}_against_sep'] = same
                if not (same['ok'] and same['taps_equal']):
                    raise AssertionError(f'sparse_options: {form} differs '
                                         f'from sep: {same}')
        del got, enc
        torch.cuda.empty_cache()
        line['settings'][name] = entry
        if not entry['fp32']['ok']:
            raise AssertionError(f'sparse_options {name}: fp32 encoder '
                                 f'{entry["fp32"]} ({entry["fp32_against"]})')

    # DENSE_TAIL_FROM_STAGE 1: the stage-1 grid dense.  Reckoned peak: six
    # bf16 activations of 16 channels over the whole 1600 x 1600 x 41 grid
    # a cloud (the dense entry and its copy, a block's input, its conv's
    # output, two BN temporaries)
    se1 = _sparse_cfg({'DENSE_TAIL_FROM_STAGE': 1}).MODEL.SPARSE_ENCODER
    act = se1.BASE_CHANNELS * math.prod(se1.SPARSE_SHAPE) * 2
    free = torch.cuda.mem_get_info(dev)[0]
    clouds = max(1, min(pts.shape[1], int(0.8 * free // (6 * act))))
    enc1 = L.LidarBEVEncoder(se1).to(dev, bf16).eval()
    enc1.load_state_dict(enc_state)
    torch.cuda.reset_peak_memory_stats()
    WF.launches = 0
    lat = []
    for _ in range(n_requests + 1):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            out = enc1(pts[:, :clouds])
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t1)
        if not torch.isfinite(out).all():
            raise AssertionError('sparse_options tail1: not finite')
    k3 = WF.launches / (n_requests + 1)
    entry = {'changes': {'DENSE_TAIL_FROM_STAGE': 1},
             'cut': {'clouds': clouds, 'of': pts.shape[1],
                     'what': 'the bf16 LiDAR encoder alone (not a forecast)',
                     'reckoned_gib_a_cloud': 6 * act / 2 ** 30,
                     'free_gib': free / 2 ** 30},
             'latency_s': lat[1:], 'median_latency_s': statistics.median(
                 lat[1:]),
             'peak_mem_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
             'k3_launches_per_call': k3, 'k3_expected': _k3_expected(se1)}
    del enc1, out
    torch.cuda.empty_cache()
    if k3 != entry['k3_expected']:
        raise AssertionError(f'sparse_options tail1: K3 launches {k3}')
    got, enc = _encoder_fp32(se1, enc_state, pts[:, :1])
    ref1, ref1_enc = _encoder_fp32(ref_se, enc_state, pts[:, :1])
    hits = _capacity(enc)[1] + _capacity(ref1_enc)[1]
    entry['capacity'], entry['caps_hit'] = _capacity(enc)
    entry['fp32_clouds'] = 1
    entry['fp32_against'] = ('plain on the card (a cap is hit)' if hits
                             else 'reference')
    entry['fp32'] = _held(got, _encoder_fp32(se1, enc_state, pts[:, :1],
                                             plain=True)[0]
                          if hits else ref1)
    del got, enc, ref1, ref1_enc
    torch.cuda.empty_cache()
    line['settings']['tail1'] = entry
    if not entry['fp32']['ok']:
        raise AssertionError(f'sparse_options tail1: fp32 encoder '
                             f'{entry["fp32"]}')

    # one flagship step each: the site engine, and columns all the way (the
    # wide K3 forward, d feats and d weights)
    steps = {}
    for name, changes in (('gather', {'ENGINE': 'gather'}),
                          ('tail0', {'DENSE_TAIL_FROM_STAGE': 0})):
        steps[name] = _spconv_step(_sparse_cfg(changes), dev)
    wide['step'] = steps['tail0']['launches']
    if not all(wide['step'][f'launches_{k}_wide'] for k in ('dgrad',
                                                            'wgrad')):
        raise AssertionError(f'sparse_options tail0 step: wide launches '
                             f'{wide["step"]}')
    if steps['gather']['launches']['launches']:
        raise AssertionError('sparse_options gather step launched K3')
    emit({**line, 'steps': steps, 'seconds': time.perf_counter() - t0,
          'card': card})
    return wide


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


def _k3_bwd_ops(geo, zmask, nz, cin, cout):
    """The products K3's backward needs on these inputs: the cotangent is
    zero at inactive output sites (the masked BN after the conv), so each
    active output site (v, zo) times each found tap of v times each z tap
    whose input z is in range, times Cin x Cout, twice (multiply, add).
    d feats and d weights each need as many."""
    import torch
    valid = torch.full((nz,), 3, device=zmask.device)
    valid[0] = valid[-1] = 2
    per_col = (zmask.reshape(-1, nz) * valid).sum(-1)
    return 2 * cin * cout * int((per_col[None] * geo.grad_found).sum())


def _wgrad_gemm_alone(feats, geo, g, nz):
    """A floor for d weights' products alone, not a port of the function:
    ``torch.matmul`` of the 9 taps' compacted A_k^T (3*Cin x items) by B
    (items x Cout), the items being the cotangent's nonzero (column, z)
    rows and A_k[item, (tz, i)] = feats[src[k, v], zo + tz - 1, i] (zero
    where the tap is not found or z leaves the column), all gathered
    outside the timed call.  (ms, items)."""
    import torch
    from streamingflow_tpu_torch.ops import sparse_columns as SC
    rows, cout = geo.nbr.shape[1], g.shape[1] // nz
    cin = feats.shape[1] // nz
    act = g.reshape(rows * nz, cout).ne(0).any(-1).nonzero().squeeze(1)
    v, zo = act // nz, act % nz
    # (R + 1, nz + 2, Cin): zero z halo, row R zeros for a tap not found
    f = SC.padded_rows(feats, nz, 1, nz + 2)
    src = torch.where(geo.grad_found, geo.nbr, feats.shape[0]).long()
    # staged row zo + tz of the source column is input z zo + tz - 1
    z3 = zo[:, None] + torch.arange(3, device=g.device)
    a_t = torch.stack([f[src[k, v][:, None], z3].reshape(-1, 3 * cin).t()
                       for k in range(9)]).contiguous()
    b = g.reshape(rows * nz, cout)[act].contiguous()
    del f
    return cuda_ms(lambda: torch.matmul(a_t, b)), int(act.numel())


# ablations of the bf16 d weights (csrc/winfuse_wgrad.cu), timed beside it
WGRAD_PARTS = {'lists_only_ms': ('WINFUSE_WGRAD_PART=1',),
               'no_gather_ms': ('WINFUSE_WGRAD_PART=2',)}


def _wgrad_parts_ms(feats, geo, g, nz):
    """The bf16 d-weights kernel built as its ablations (WGRAD_PARTS: the
    cotangent rows and lists alone; the steps without their row gathers),
    each launched on the wrapper's prepared inputs: CUDA-event ms.  Their
    results are wrong by design and are not read."""
    import torch
    from streamingflow_tpu_torch.ops import cuda_lib
    from streamingflow_tpu_torch.ops import winfuse as WF
    rows_n, dev = geo.nbr.shape[1], feats.device
    cin, cout = feats.shape[1] // nz, g.shape[1] // nz
    rows, cp, g_rows, np_ = WF.wgrad_rows(feats, g, nz)
    src = torch.where(geo.grad_found, geo.nbr, -1).contiguous()
    parts = WF.WGRAD_BLOCKS_PER_SM * \
        torch.cuda.get_device_properties(dev).multi_processor_count
    scratch = torch.empty(parts, 27 * cin * cout, device=dev)
    out = torch.empty(27, cin, cout, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    times = {}
    for key, defines in WGRAD_PARTS.items():
        fn = cuda_lib.kernel('winfuse_wgrad', 'sf_winfuse_wgrad_bf16',
                             defines)
        times[key] = cuda_ms(lambda: cuda_lib.check('winfuse_wgrad', fn(
            rows.data_ptr(), src.data_ptr(), g_rows.data_ptr(),
            scratch.data_ptr(), parts, out.data_ptr(), rows_n, nz, cp, cin,
            np_, cout, stream)))
    return times


def _winfuse_bwd_case(name, feats, geo, w, nz, zmask, reps=5,
                      dgrad=True, ablations=True):
    """K3's backward on the card against the plain forward's autograd over
    the map's full found (the JAX ``_winfuse_bwd``): d feats through the
    forward's kernels over the reversed map (``subm_conv_dgrad``), d weights
    through csrc/winfuse_wgrad.cu (``subm_conv_wgrad``), both direct and
    through the autograd Function (forward over ``geo.found``, the kept
    taps), for a random cotangent zero at the inactive sites; d weights
    launched twice more, for equal bits.  ``dgrad=False`` (conv_input,
    whose voxel features take no gradient): d weights only.  Tolerances:
    d feats as the forward's (fp32 1e-5 of the scale; bf16 2^-7, the
    weights rounded to bf16 by the kernel and the result rounded once);
    d weights against the plain version's sums in fp64 (the exact value of
    the fp32 or bf16 inputs' products), 1e-4 of the scale: fp32 sums of
    ~10^6 products (the plain fp32 autograd's own distance from it is
    reported beside).  ``ablations=False`` (the wide cases): no
    gemm_alone_ms and no kernel_parts."""
    import torch
    from streamingflow_tpu_torch.ops import winfuse as WF
    dev = feats.device
    gen = torch.Generator(device=dev).manual_seed(7)
    rows, cin, cout = geo.nbr.shape[1], w.shape[1], w.shape[2]
    zm = zmask.reshape(rows, nz, 1)
    g = (torch.randn(rows, nz, cout, device=dev, generator=gen) * zm).to(
        feats.dtype).reshape(rows, nz * cout)
    full, src_t = geo.grad_found, geo.src_t
    x = feats.clone().requires_grad_(dgrad)
    wp = w.detach().clone().requires_grad_()
    WF.subm_conv_plain(x, geo.nbr, full, wp, nz).backward(g)
    want_df, want_dw = x.grad, wp.grad
    counts = (WF.launches_dgrad, WF.launches_wgrad)
    got_df = WF.subm_conv_dgrad(g, src_t, w, nz) if dgrad else None
    got_dw = WF.subm_conv_wgrad(feats, geo.nbr, full, g, nz)
    xf = feats.clone().requires_grad_(dgrad)
    wf = w.detach().clone().requires_grad_()
    WF.subm_conv_winfuse(xf, geo.nbr, geo.found, wf, nz, grad_found=full,
                         src_t=src_t).backward(g)
    # the same bits from run to run: one partial a block, added in order
    reruns = [WF.subm_conv_wgrad(feats, geo.nbr, full, g, nz)
              for _ in range(2)]
    torch.cuda.synchronize()
    if (WF.launches_dgrad - counts[0], WF.launches_wgrad - counts[1]) != \
            (2 if dgrad else 0, 4):
        raise AssertionError(f'winfuse backward {name}: dgrad / wgrad did '
                             f'not launch their kernels')
    # the Function runs the same kernels: the same bits (d weights in the
    # weights' type)
    if not ((not dgrad or torch.equal(xf.grad, got_df)) and
            torch.equal(wf.grad, got_dw.to(wf.dtype))):
        raise AssertionError(f'winfuse backward {name}: the autograd '
                             f'Function differs from its kernels')
    if not all(torch.equal(r, got_dw) for r in reruns):
        raise AssertionError(f'winfuse backward {name}: d weights differ '
                             f'from run to run')
    bf16 = feats.dtype == torch.bfloat16
    dw_scale = float(want_dw.abs().max())
    exact_dw = WF.subm_conv_wgrad_plain(feats.double(), geo.nbr, full,
                                        g.double(), nz)
    dw_tol = dict(rtol=1e-4, atol=1e-4 * dw_scale)
    if dgrad:
        df_scale = float(want_df.float().abs().max())
        df_tol = (dict(rtol=2 ** -7, atol=2 ** -7 * df_scale) if bf16 else
                  dict(rtol=1e-5, atol=1e-5 * df_scale))
        check_close(f'winfuse dgrad {name}', got_df, want_df, **df_tol)
    check_close(f'winfuse wgrad {name}', got_dw, exact_dw, **dw_tol)
    kept_dw = None
    if not torch.equal(geo.found, full):
        # the backward keeps the taps the forward's plan dropped: the
        # gradient over the kept taps alone is another one
        kept_dw = WF.subm_conv_wgrad_plain(feats, geo.nbr, geo.found, g, nz)
        if max_err(kept_dw, exact_dw)[0] <= 10 * dw_tol['atol']:
            raise AssertionError(f'winfuse backward {name}: the dropped '
                                 f'taps do not move the gradient')
    es = feats.element_size()
    ops = _k3_bwd_ops(geo, zmask, nz, cin, cout)
    peak = BF16_FLOPS if bf16 else FP32_FLOPS
    maps = geo.nbr.numel() * 5
    # d feats: the cotangent rows the reversed taps read, the whole output,
    # the weights, the reversed map
    n_rows_t = int(torch.unique(src_t[src_t >= 0]).numel())
    dgrad_bytes = (n_rows_t * g.shape[1] + feats.numel() + w.numel()) * es \
        + src_t.numel() * 4
    # d weights: the whole cotangent, the source rows the found taps read,
    # the map, the fp32 result
    n_rows = int(torch.unique(geo.nbr[full]).numel())
    wgrad_bytes = (g.numel() + n_rows * feats.shape[1]) * es + maps + \
        got_dw.numel() * 4

    def bound(n_bytes):
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / peak
        return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                           else 'operations')
    flipped = WF.flipped_weights(w)
    out = dict(case=name, dtype=str(feats.dtype).split('.')[-1], nz=nz,
               cin=cin, cout=cout, rows=rows,
               active_output_sites=int(zmask.sum()),
               dropped_taps_kept_in_backward=int((full & ~geo.found).sum()),
               ops=ops, tolerance={'dgrad': df_tol if dgrad else None,
                                   'wgrad': dw_tol})
    out['wgrad_plain_autograd_fp32_err'] = max_err(want_dw, exact_dw)[0]
    kinds = [('wgrad', wgrad_bytes, got_dw, exact_dw,
              lambda: WF.subm_conv_wgrad(feats, geo.nbr, full, g, nz),
              lambda: WF.subm_conv_wgrad_plain(feats, geo.nbr, full, g,
                                               nz))]
    if dgrad:
        kinds.insert(0, ('dgrad', dgrad_bytes, got_df, want_df,
                         lambda: WF.subm_conv_dgrad(g, src_t, w, nz),
                         lambda: WF.subm_conv_plain(
                             g, src_t.clamp(min=0), src_t >= 0, flipped,
                             nz)))
    for kind, n_bytes, got, want, fn, plain in kinds:
        bound_ms, bound_by = bound(n_bytes)
        out[kind] = dict(max_abs_err=max_err(got, want)[0],
                         max_abs_want=float(want.float().abs().max()),
                         ms=cuda_ms(fn, reps=reps),
                         plain_ms=cuda_ms(plain, reps=2, warmup=1),
                         bytes=n_bytes, bound_ms=bound_ms,
                         bound_by=bound_by)
    out['wgrad']['runs_equal'] = len(reruns) + 1
    out['wgrad']['route'] = WF.route(feats.dtype)
    if bf16 and ablations:
        out['wgrad']['gemm_alone_ms'], out['wgrad']['gemm_items'] = \
            _wgrad_gemm_alone(feats, geo, g, nz)
        out['wgrad']['kernel_parts'] = _wgrad_parts_ms(feats, geo, g, nz)
    if kept_dw is not None:
        out['wgrad']['kept_taps_only_max_abs_diff'] = \
            max_err(kept_dw, exact_dw)[0]
    return out


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
        weights=weights, path_like=path_like, down1=down1, pts=pts)


def k3_wide_inputs(dev, x):
    """K3's inputs at stage 3 (64 -> 64, nz 11) and stage 4 (128 -> 128,
    nz 5) of the same 5 clouds: the column geometry of
    DENSE_TAIL_FROM_STAGE 0 (the model's own strided column convs and
    caps), random features zeroed at the inactive sites: {name: (feats,
    geo, weights, nz, zmask)} in bf16."""
    import copy
    from streamingflow_tpu_torch.models import lidar_encoder as L
    from streamingflow_tpu_torch.ops import sparse_columns as SC
    se = copy.deepcopy(x.se)
    se.DENSE_TAIL_FROM_STAGE = 0
    geo = L.LidarBEVEncoder(se).to(dev).geometry(x.pts[None])
    cases = {}
    for s, c in ((3, 64), (4, 128)):
        zm = geo.zmasks[s - 1]
        n, v, nz = zm.shape
        feats = SC.mask_fused(x.rand(n, v, nz * c), zm).reshape(-1, nz * c)
        cases[f'stage{s}'] = (feats, geo.columns[s - 1], x.weights(c, c),
                              nz, zm)
    return cases


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
                           None, geo2.grad_found, geo2.src_t)
    cases.append(_winfuse_case('stage2_drop', rand(n * cap2, nz2 * 32),
                               geo_drop, weights(32, 32), nz2, reps=3))
    main = cases[2]
    ms = {c['case']: c['kernel_ms'] for c in cases}
    results['winfuse'] = dict(
        max_abs_err=main['max_abs_err'], ms=main['kernel_ms'],
        plain_ms=main['twin_ms'], library_ms=None,
        bound_ms=main['bound_us'] / 1e3, bound_by=main['bound_by'])

    # the backward (the training step's): d feats and d weights at the
    # main path's stage-1 and stage-2 shapes, bf16 as the step runs them
    # and fp32, and over the forced-drop plan (forward over the kept taps,
    # backward over all of them)
    f32 = torch.float32
    f_drop = x.path_like(cs2, nz2, 32)
    # conv_input's voxel features take no gradient: d weights only (Cin 5,
    # the kernel's 8-channel pitch)
    bwd = [_winfuse_bwd_case(nm, f, geo, w, nz, zm,
                             dgrad=nm != 'conv_input')
           for nm, (f, geo, w, nz, zm) in inputs.items()]
    bwd += [
        _winfuse_bwd_case('stage1_fp32', x.path_like(cs1, nz1, 16).float(),
                          geo1, weights(16, 16, f32), nz1, cs1.zmask, reps=2),
        _winfuse_bwd_case('stage2_fp32', x.path_like(cs2, nz2, 32).float(),
                          geo2, weights(32, 32, f32), nz2, cs2.zmask, reps=2),
        _winfuse_bwd_case('stage2_drop', f_drop, geo_drop, weights(32, 32),
                          nz2, cs2.zmask, reps=2),
    ]
    main_bwd = bwd[2]                         # stage 2, bf16
    for kind in ('dgrad', 'wgrad'):
        c = main_bwd[kind]
        results[f'winfuse_{kind}'] = dict(
            max_abs_err=c['max_abs_err'], ms=c['ms'], plain_ms=c['plain_ms'],
            library_ms=None, bound_ms=c['bound_ms'], bound_by=c['bound_by'])

    # the wide kernels (Cin, Cout past 32): stages 3 and 4 on columns
    # (DENSE_TAIL_FROM_STAGE 0), bf16 as the forecast and the step run them
    # and fp32, forward and backward, under the same bars
    wide_cases, wide_bwd = [], []
    for name, (f, geo, w, nz, zm) in k3_wide_inputs(dev, x).items():
        wide_cases += [
            _winfuse_case(name, f, geo, w, nz, zm, reps=5),
            _winfuse_case(f'{name}_fp32', f.float(), geo, w.float(), nz, zm,
                          reps=2)]
        wide_bwd += [
            _winfuse_bwd_case(name, f, geo, w, nz, zm, reps=3,
                              ablations=False),
            _winfuse_bwd_case(f'{name}_fp32', f.float(), geo, w.float(), nz,
                              zm, reps=2, ablations=False)]
        width = w.shape[2]
        c = wide_cases[-2]
        results[f'winfuse_wide{width}'] = dict(
            max_abs_err=c['max_abs_err'], ms=c['kernel_ms'],
            plain_ms=c['twin_ms'], library_ms=None,
            bound_ms=c['bound_us'] / 1e3, bound_by=c['bound_by'])
        for kind in ('dgrad', 'wgrad'):
            c = wide_bwd[-2][kind]
            results[f'winfuse_{kind}_wide{width}'] = dict(
                max_abs_err=c['max_abs_err'], ms=c['ms'],
                plain_ms=c['plain_ms'], library_ms=None,
                bound_ms=c['bound_ms'], bound_by=c['bound_by'])
    results['winfuse_wgrad']['gemm_alone_ms'] = \
        main_bwd['wgrad']['gemm_alone_ms']
    # the tensor-core d weights keeps its sums in registers: no spill
    wgrad_ptxas = _ptxas_report(cuda_lib.BUILD_LOG.get('winfuse_wgrad', ''))
    mma_ptxas = [r for r in wgrad_ptxas if 'wgrad_mma' in r['kernel']]
    if not mma_ptxas or any(r['spill_stores'] or r['spill_loads']
                            for r in mma_ptxas):
        raise AssertionError(f'winfuse wgrad: the bf16 kernel spills or is '
                             f'missing from the ptxas report: {mma_ptxas}')
    emit({'phase': 'winfuse', 'clouds': n,
          'active_columns': {'stage1': int(cs1.col_mask.sum()),
                             'stage2': int(cs2.col_mask.sum())},
          'active_sites': {'stage1': int(cs1.zmask.sum()),
                           'stage2': int(cs2.zmask.sum())},
          'column_slots': {'stage1': n * cap1, 'stage2': n * cap2},
          'n_dropped': {'stage1': geo1.n_dropped.tolist(),
                        'stage2': geo2.n_dropped.tolist(),
                        'forced': drops},
          'cases': cases, 'backward_cases': bwd,
          'wide_cases': wide_cases, 'wide_backward_cases': wide_bwd,
          'ptxas': _ptxas_report(cuda_lib.BUILD_LOG.get('winfuse', '')),
          'wgrad_ptxas': wgrad_ptxas,
          'down1_plain_ms_per_cloud': down1_ms,
          'conv_input_pitch_rows_ms': pitch_ms,
          'forecast_ms_est': ms['conv_input'] + 4 * ms['stage1']
          + 4 * ms['stage2'],
          'library_call': 'none: no one call computes this function',
          'gemm_alone': 'torch.matmul of the 9 taps\' compacted, '
                        'pre-gathered A_k^T B (gathered outside the timed '
                        'call): a floor for the products alone, not a port '
                        'of the function'})


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


def phase_train(cfg, dev, n_steps, card, n_points=80000, summary=None):
    """Flagship training steps (fp32 parameters, batch 1), every kernel
    count set to 0 before the steps and read after them.  ``summary``: a
    dict that receives the median step time and the peak memory."""
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
        if not torch.equal(v, start[k]) and (
                k in names or '.present_distribution.' not in k):
            moved['parameters' if k in names else 'bn_buffers'] += 1
    # the distribution head (PROBABILISTIC) is no part of the step's
    # forward: its batch norms never run
    n_buffers = sum(1 for k in state if k not in names
                    and 'num_batches' not in k
                    and '.present_distribution.' not in k)
    # a parameter that is 0 and gets an exactly zero gradient stays (Adam's
    # update of 0 is 0), so not every tensor need move; every BN of the
    # forward ran
    if moved['parameters'] < 0.9 * len(names) or \
            moved['bn_buffers'] != n_buffers:
        raise AssertionError(f'train: moved {moved} of {len(names)} '
                             f'parameters and {n_buffers} BN buffers')
    if summary is not None:
        summary.update(median_step_s=statistics.median(times),
                       peak_mem_gib=torch.cuda.max_memory_allocated()
                       / 2 ** 30)
    emit({'phase': 'train', 'steps': n_steps, 'remat': cfg.MODEL.REMAT,
          'step_s': times, 'median_step_s': statistics.median(times),
          'losses': losses, 'launches': counts(),
          'per_step_launches': per_step, 'patch_pool_drops': drops,
          'moved': {**moved, 'of_parameters': len(names),
                    'of_bn_buffers': n_buffers},
          'peak_mem_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
          'card': card})
    return counts()


def _no_dropout(trainer):
    from streamingflow_tpu_torch.layers.trainmode import Dropout
    for m in trainer.module.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return trainer


def phase_train_tiny_spconv(dev):
    """One tiny camera + spconv8x training step on the card (K2 forward and
    backward, K3 forward, d feats and d weights) against the same step on
    the CPU (plain versions), same initial weights and batch, dropout off.

    In fp32, since K3's kernels take fp32 and bf16.  The tiny step's
    gradient is ill-conditioned in fp32 (tests/test_torch_train_step.py
    measures it), so both fp32 steps are held against the CPU's step in
    fp64, and the card's at the bars the fp32 step is held to against the
    JAX package's (tests/test_torch_train_step.py): each loss 1e-3
    relative, the BN statistics 5e-3 of their scale, the gradient norm 10 %,
    and the whole gradient's cosine, here also the LiDAR encoder's (the
    gradient K3's backward carries), above 0.98.  The card's fp32 forward
    lands ~10x further from fp64 than the CPU's (cuDNN's fp32 convolution
    algorithms), so no bar is a multiple of the CPU's own distance; K3's
    backward is held tightly in phase winfuse.  The diagnostics are
    equal."""
    import torch
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch.data import make_batch
    from streamingflow_tpu_torch.ops import patch_pool as PP
    from streamingflow_tpu_torch.ops import winfuse as WF
    tol = {'loss_rel': 1e-3, 'bn_stats': 5e-3, 'grad_norm_rel': 0.1,
           'grad_cosine': 0.98, 'lidar_grad_cosine': 0.98}
    cfg, cfg64 = _tiny_spconv_config(), _tiny_spconv_config()
    cfg64.MODEL.SPARSE_ENCODER.COMPUTE_DTYPE = 'float64'
    cpu = _no_dropout(P.build_trainer(cfg, device='cpu', seed=0))
    cpu64 = _no_dropout(P.build_trainer(cfg64, device='cpu'))
    gpu = _no_dropout(P.build_trainer(cfg, device=dev))
    cpu64.module.load_state_dict(cpu.module.state_dict())
    cpu64.module.double()
    gpu.module.load_state_dict(cpu.module.state_dict())
    batch = make_batch(cfg, 1, seed=1, n_points=512)
    runs = {'cpu_fp32': P.train_step(cpu, batch),
            'cpu_fp64': P.train_step(cpu64, batch)}
    counters = {'patch_pool': (PP, 'launches'),
                'patch_pool_bwd': (PP, 'launches_bwd'),
                'winfuse': (WF, 'launches'),
                'winfuse_dgrad': (WF, 'launches_dgrad'),
                'winfuse_wgrad': (WF, 'launches_wgrad')}
    before = {k: getattr(m, a) for k, (m, a) in counters.items()}
    runs['card'] = P.train_step(gpu, batch)
    torch.cuda.synchronize()
    launches = {k: getattr(m, a) - before[k]
                for k, (m, a) in counters.items()}
    if min(launches.values()) < 1:
        raise AssertionError(f'tiny spconv8x train step: a kernel did not '
                             f'launch: {launches}')
    want = runs['cpu_fp64']
    failed = []
    for k, w in want.items():
        if k.startswith('diag/') and not \
                int(runs['card'][k]) == int(runs['cpu_fp32'][k]) == int(w):
            failed.append(f'{k} {int(runs["card"][k])}, CPU '
                          f'{int(runs["cpu_fp32"][k])}')
    for k, v in runs['card'].items():
        if not torch.isfinite(v).all():
            raise AssertionError(f'tiny spconv8x train step: {k} not finite')

    def grads(trainer, metrics):
        unclip = max(float(metrics['grad_norm']) / cfg.GRAD_NORM_CLIP, 1.0)
        return {k: p.grad.detach().cpu().double() * unclip
                for k, p in trainer.module.named_parameters()}

    def cosine(a, b, keys):
        dot = sum(float((a[k] * b[k]).sum()) for k in keys)
        return dot / (sum(float((a[k] ** 2).sum()) for k in keys)
                      * sum(float((b[k] ** 2).sum()) for k in keys)) ** 0.5

    g64 = grads(cpu64, want)
    names = list(g64)
    lidar = [k for k in names if k.startswith('model.lidar_encoder.')]
    s64 = cpu64.module.state_dict()
    report = {}
    for run, trainer in (('card', gpu), ('cpu_fp32', cpu)):
        got = runs[run]
        losses = {k: abs(float(got[k]) - float(w)) / max(abs(float(w)), 1e-6)
                  for k, w in want.items() if not k.startswith('diag/')
                  and k != 'grad_norm' and float(w) != 0.0}
        gr = grads(trainer, got)
        state = trainer.module.state_dict()
        stats = max(float((state[k].cpu().double() - w).abs().max())
                    / max(float(w.abs().max()), 1.0)
                    for k, w in s64.items()
                    if k not in g64 and 'num_batches' not in k)
        report[run] = {
            'loss_rel_worst': max(losses.values()),
            'grad_norm_rel': abs(float(got['grad_norm'])
                                 - float(want['grad_norm']))
            / float(want['grad_norm']),
            'bn_stats': stats,
            'grad_cosine': cosine(gr, g64, names),
            'lidar_grad_cosine': cosine(gr, g64, lidar)}
    card = report['card']
    for k in ('loss_rel', 'bn_stats', 'grad_norm_rel'):
        got = card['loss_rel_worst' if k == 'loss_rel' else k]
        if got > tol[k]:
            failed.append(f'{k} {got:.3g} > {tol[k]}')
    for k in ('grad_cosine', 'lidar_grad_cosine'):
        if card[k] < tol[k]:
            failed.append(f'{k} {card[k]:.6f} < {tol[k]}')
    emit({'phase': 'train_tiny_spconv', 'dtype': 'float32',
          'reference': 'the CPU step in float64', 'launches': launches,
          'against_fp64': report, 'grad_norm_fp64': float(want['grad_norm']),
          'diagnostics': {k: int(v) for k, v in runs['card'].items()
                          if k.startswith('diag/')},
          'tolerance': tol})
    if failed:
        raise AssertionError('tiny spconv8x train step: ' + '; '.join(failed))


def phase_train_spconv(dev, n_steps, card, n_points=80000):
    """Flagship spconv8x training steps (fp32 parameters, batch 1, the
    LiDAR branch in bf16, MODEL.REMAT and REMAT_LADDER as configured) after
    one warm-up, every kernel count set to 0 before the steps and read
    after them; the capacity diagnostics of each step."""
    import torch
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch.data import flagship_config, make_batch
    from streamingflow_tpu_torch.ops import patch_pool as PP
    from streamingflow_tpu_torch.ops import winfuse as WF
    cfg = flagship_config(backbone='spconv8x')
    se = cfg.MODEL.SPARSE_ENCODER
    trainer = P.build_trainer(cfg, device=dev, seed=0)
    counters = {'winfuse': (WF, 'launches'),
                'winfuse_dgrad': (WF, 'launches_dgrad'),
                'winfuse_wgrad': (WF, 'launches_wgrad'),
                'patch_pool': (PP, 'launches'),
                'patch_pool_bwd': (PP, 'launches_bwd')}
    # 9 submanifold convs (conv_input, two a block of stages 1 and 2), each
    # run again in the recompute under REMAT_LADDER; no d feats for
    # conv_input (its voxel features take no gradient)
    n_subm = 1 + 2 * sum(len(c) - 1 for c in se.ENCODER_CHANNELS[:2])
    remat = se.REMAT_LADDER or cfg.MODEL.REMAT
    expect = {'winfuse': n_subm * (2 if remat else 1),
              'winfuse_dgrad': n_subm - 1, 'winfuse_wgrad': n_subm,
              'patch_pool': 1, 'patch_pool_bwd': 1}

    def counts():
        return {k: getattr(m, a) for k, (m, a) in counters.items()}

    def step(seed):
        batch = make_batch(cfg, 1, seed=seed, n_points=n_points)
        gen = torch.Generator(device=dev).manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = P.train_step(trainer, batch, generator=gen)
        torch.cuda.synchronize()
        return metrics, time.perf_counter() - t0

    step(100)                                     # warm-up, not counted
    torch.cuda.reset_peak_memory_stats()
    for m, a in counters.values():
        setattr(m, a, 0)
    times, losses, per_step, diags = [], [], [], []
    for seed in range(1, n_steps + 1):
        before = counts()
        metrics, dt = step(seed)
        per_step.append({k: v - before[k] for k, v in counts().items()})
        times.append(dt)
        for k, v in metrics.items():
            if not torch.isfinite(v).all():
                raise AssertionError(f'spconv8x train step {seed}: {k} not '
                                     f'finite')
        diags.append({k[5:]: int(v) for k, v in metrics.items()
                      if k.startswith('diag/')})
        losses.append({k: float(v) for k, v in metrics.items()
                       if not k.startswith('diag/')})
    launches = counts()
    if min(launches.values()) < 1:
        raise AssertionError(f'spconv8x train: a kernel of the path did not '
                             f'launch: {launches}')
    if len(diags[0]) != 6:
        raise AssertionError(f'spconv8x train: diagnostics {diags[0]}')
    for k, v in trainer.module.state_dict().items():
        if not torch.isfinite(v).all():
            raise AssertionError(f'spconv8x train: {k} not finite')
    emit({'phase': 'train_spconv', 'steps': n_steps,
          'remat': cfg.MODEL.REMAT, 'remat_ladder': se.REMAT_LADDER,
          'step_s': times, 'median_step_s': statistics.median(times),
          'losses': losses, 'diagnostics': diags, 'launches': launches,
          'per_step_launches': per_step, 'expected_per_step': expect,
          'peak_mem_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
          'card': card})
    return launches


# ------------------------------------------------------------------ planning
# Bars of the planner on the card against the same module on the CPU, fp32,
# each of its scale (phase planning, leg 'module'): the candidates' costs
# (gathers and sums in another order) and the loss 1e-5; the planned
# trajectory 1e-4 (the GRU on the cuDNN-reduced camera feature); the
# gradients 1e-3 of each leaf's scale (floor: the median leaf's), through
# the bottlenecks' batch statistics.  The selected candidate and what follows
# from it are compared only where the best candidate's total cost leads the
# next distinct one by more than the costs' bar, and the cost volume's
# gradient only where the largest margin leads the next by more than it.
PLAN_BARS = {'costs': 1e-5, 'loss': 1e-5, 'traj': 1e-4, 'grads': 1e-3}


def planning_config():
    """data.flagship_config() with the planner on (the JAX package's
    default PLANNING: 600 candidates, GRU state 64; 200 x 200 BEV, 4
    futures, a 28 x 60 front-camera feature of 64 channels)."""
    from streamingflow_tpu_torch.data import flagship_config
    cfg = flagship_config()
    cfg.PLANNING.ENABLED = True
    return cfg


def planning_candidates(cfg, rng):
    """(N, T + 1, 3) candidates of the CAN-bus sampler (data/sampler.py) at
    a speed and steering drawn from ``rng``, as the nuScenes loader draws
    them, and a ground truth near one of them."""
    import numpy as np
    from streamingflow_tpu_torch.data import sampler
    f = cfg.N_FUTURE_FRAMES
    cand = sampler.sample(float(rng.uniform(2.0, 12.0)),
                          float(rng.uniform(-0.1, 0.1)),
                          cfg.PLANNING.SAMPLE_NUM, f * 0.5, f,
                          rng=rng).astype(np.float32)
    gt = cand[rng.randint(len(cand))] + 0.3 * rng.randn(f + 1, 3)
    gt[0] = 0.0
    return cand, gt.astype(np.float32)


def planning_batch(cfg, seed, n_points=80000):
    """make_batch with the sampler's candidates, a ground truth near one,
    a command per seed and no goal point (as the nuScenes loader gives)."""
    import numpy as np
    from streamingflow_tpu_torch.data import make_batch
    batch = make_batch(cfg, 1, seed=seed, n_points=n_points)
    cand, gt = planning_candidates(cfg, np.random.RandomState(1000 + seed))
    batch['sample_trajectory'] = cand[None]
    batch['gt_trajectory'] = gt[None]
    batch['command'] = np.array([seed % 3])
    batch['target_point'] = np.zeros((1, 2), np.float32)
    return batch


def planning_module_inputs(cfg, batch_size=3, seed=0):
    """The planner's inputs at flagship shapes from ``seed``: the
    front-camera feature (B, 28, 60, 64), the sampler's candidates without
    the origin (B, 600, 4, 3), ground truths, a cost volume, sparse
    occupancy, a map of lane lines and a drivable band (B, 2, 200, 200),
    one item per command code and a goal point on the second item."""
    import numpy as np
    from streamingflow_tpu_torch.models.planning import feature_size
    rng = np.random.RandomState(seed)
    b, t, h = batch_size, cfg.N_FUTURE_FRAMES, 200
    fh, fw = feature_size(cfg)
    cands, gts = zip(*[planning_candidates(cfg, rng) for _ in range(b)])
    hd = np.zeros((b, 2, h, h), np.float32)
    for i in range(b):
        for c in rng.randint(80, 120, 3):
            hd[i, 0, :, c] = 1.0                      # lane lines
        hd[i, 1, :, 70:130] = 1.0                     # the drivable band
    tp = np.zeros((b, 2), np.float32)
    tp[1] = [3.0, 12.0]
    return dict(
        cam_front=rng.rand(b, fh, fw, cfg.MODEL.ENCODER.OUT_CHANNELS)
        .astype(np.float32),
        trajs=np.stack(cands)[:, :, 1:], gt_trajs=np.stack(gts)[:, 1:],
        cost_volume=(rng.rand(b, t, h, h) * 1.2 - 0.1).astype(np.float32),
        semantic_pred=(rng.rand(b, t, h, h) > 0.97).astype(np.float32),
        hd_map=hd, commands=np.arange(b) % 3, target_points=tp)


def _lead(values):
    """Per row, how far the least value leads the next distinct one (inf
    where all are equal)."""
    import torch
    out = []
    for row in values:
        u = torch.unique(row.double())
        out.append(float(u[1] - u[0]) if len(u) > 1 else math.inf)
    return out


def phase_planning_module(dev):
    """The planner alone at flagship shapes in fp32 and train mode, card
    against CPU, the same weights (seed 0) and inputs: the candidates'
    costs, the loss, the planned trajectory, the gradients of the planning
    parameters and of the cost volume (PLAN_BARS); then, on the card in
    eval mode at batch 1 (CUDA events), its forward, the candidates' costs
    and the lane cost alone."""
    import copy
    import torch
    from streamingflow_tpu_torch.models.planning import (Planning,
                                                         select_command_trajs)
    from streamingflow_tpu_torch.ops.cost import lr_divider_cost
    cfg = planning_config()
    torch.manual_seed(0)
    cpu = Planning(cfg, cfg.MODEL.ENCODER.OUT_CHANNELS,
                   cfg.PLANNING.GRU_STATE_SIZE)
    gpu = copy.deepcopy(cpu).to(dev)
    inputs = planning_module_inputs(cfg)

    def run(module, device):
        x = {k: torch.from_numpy(v).to(device) for k, v in inputs.items()}
        x['cost_volume'].requires_grad_(True)
        module.train().zero_grad()
        cur = select_command_trajs(x['trajs'], x['commands'], module.num)
        maps = (x['cost_volume'], x['semantic_pred'], x['hd_map'][:, :1],
                x['hd_map'][:, 1:], x['target_points'])
        with torch.no_grad():
            fc, fo = module.costs(cur, *maps)
            gfc, gfo = module.costs(x['gt_trajs'][:, None], *maps)
            l2 = ((cur[..., :2] - x['gt_trajs'][:, None, :, :2]) ** 2
                  ).sum(-1).mean(-1)
            margin = torch.relu(torch.relu(gfo - fo).sum(-1) + gfc - fc + l2)
        loss, traj = module(**x)
        loss.backward()
        return dict(fc=fc.cpu(), fo=fo.cpu(), margin=margin.cpu(),
                    loss=loss.detach().cpu(), traj=traj.detach().cpu(),
                    cv=x['cost_volume'].grad.cpu(),
                    grads={n: p.grad.cpu() for n, p in
                           module.named_parameters()})

    want, got = run(cpu, 'cpu'), run(gpu, dev)
    total = want['fc'] + want['fo'].sum(-1)
    scale = float(total.abs().max())
    bar = PLAN_BARS['costs'] * scale
    lead = _lead(total)
    kept = [i for i, v in enumerate(lead) if v > bar]
    m_lead = _lead(-want['margin'])
    m_kept = [i for i, v in enumerate(m_lead) if v > bar]
    errs = {}

    def rel(name, g, w, tol, rows=None):
        if rows is not None:
            g, w = g[rows], w[rows]
        err = float((g - w).abs().max()) if g.numel() else 0.0
        errs[name] = err / max(float(w.abs().max()), 1e-30)
        if not torch.isfinite(g).all() or err > tol * max(
                float(w.abs().max()), 1e-30):
            raise AssertionError(
                f'planning module: {name} card vs CPU {err:.3g} of scale '
                f'{float(w.abs().max()):.3g} exceeds {tol:g}')

    rel('cost_fc', got['fc'], want['fc'], PLAN_BARS['costs'])
    rel('cost_fo', got['fo'], want['fo'], PLAN_BARS['costs'])
    rel('loss', got['loss'], want['loss'], PLAN_BARS['loss'])
    rel('output_traj', got['traj'], want['traj'], PLAN_BARS['traj'], kept)
    rel('cost_volume_grad', got['cv'], want['cv'], PLAN_BARS['grads'],
        m_kept)
    floor = statistics.median(float(g.abs().max())
                              for g in want['grads'].values())
    worst = 0.0
    for n, w in want['grads'].items():
        err = float((got['grads'][n] - w).abs().max())
        s = max(float(w.abs().max()), floor)
        worst = max(worst, err / s)
        if err > PLAN_BARS['grads'] * s:
            raise AssertionError(f'planning module: grad {n} card vs CPU '
                                 f'{err:.3g} of scale {s:.3g}')
    errs['param_grads'] = worst
    if not float(want['cv'].abs().max()) > 0:
        raise AssertionError('planning module: no gradient reached the '
                             'cost volume')
    # where the planner's time goes at a request's batch of 1 (eval mode):
    # all of it, the candidates' costs, and the lane cost alone
    gpu.eval()
    x = {k: torch.from_numpy(v[:1]).to(dev) for k, v in inputs.items()}
    lane = x['hd_map'][:, :1]
    with torch.no_grad():
        cur = select_command_trajs(x['trajs'], x['commands'], gpu.num)
        maps = (x['cost_volume'], x['semantic_pred'], lane,
                x['hd_map'][:, 1:], x['target_points'])
        flipped = cur[..., :2] * torch.tensor([-1.0, 1.0], device=dev)
        times = {
            'forward_ms': cuda_ms(lambda: gpu(**x), reps=5, warmup=2),
            'costs_ms': cuda_ms(lambda: gpu.costs(cur, *maps), reps=5,
                                warmup=2),
            'lr_divider_ms': cuda_ms(lambda: lr_divider_cost(
                gpu.grid, flipped, lane, cfg.COST_FUNCTION.LRDIVIDER),
                reps=5, warmup=2)}
    return {'errors_of_scale': errs, 'bars': PLAN_BARS,
            'selection_lead': lead, 'near_tie_items_excluded':
            len(lead) - len(kept), 'margin_lead': m_lead,
            'margin_near_tie_items_excluded': len(m_lead) - len(m_kept),
            'batch1': times}


def phase_planning_serve(cfg, dev, n_requests):
    """bf16 forecasts of the flagship with the planner, as evaluate runs it
    (evaluate.run_planner on the forecast's predicted occupancy, cost
    volume and front-camera feature, a zero map without the map head): the
    median latency with and without the planner, K1 and K2 once a
    request."""
    import torch
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch.evaluate import run_planner
    from streamingflow_tpu_torch.ops import bin_sum as B
    from streamingflow_tpu_torch.ops import patch_pool as PP
    model = P.build_model(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    f = cfg.N_FUTURE_FRAMES

    def counts():
        return {'bin_sum': B.launches, 'patch_pool': PP.launches}

    def request(seed):
        batch = planning_batch(cfg, seed)
        args = P.batch_to_model_args(batch, cfg, device=dev,
                                     image_dtype=torch.bfloat16)
        gen = torch.Generator(device=dev).manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model(**args, generator=gen)
        seg_pred = out['segmentation'].argmax(-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        traj = run_planner(model.planning, cfg, batch, out, seg_pred)
        torch.cuda.synchronize()
        return traj, t1 - t0, time.perf_counter() - t0

    request(100)                                  # warm-up, not counted
    B.launches = PP.launches = 0
    fwd, total, per = [], [], []
    for seed in range(1, n_requests + 1):
        before = counts()
        traj, a, b = request(seed)
        per.append({k: v - before[k] for k, v in counts().items()})
        fwd.append(a)
        total.append(b)
        if tuple(traj.shape) != (1, f, 3) or not torch.isfinite(traj).all():
            raise AssertionError(f'planning serve: trajectory {traj}')
    for i, got in enumerate(per):
        if got != {'bin_sum': 1, 'patch_pool': 1}:
            raise AssertionError(f'planning serve: request {i}: launches '
                                 f'{got}, want one K1 and one K2')
    del model
    torch.cuda.empty_cache()
    return {'requests': n_requests, 'forecast_s': fwd,
            'forecast_and_planner_s': total,
            'median_forecast_s': statistics.median(fwd),
            'median_forecast_and_planner_s': statistics.median(total),
            'median_planner_s': statistics.median(
                b - a for a, b in zip(fwd, total)),
            'per_request_launches': per}, counts()


def phase_planning_train(cfg, dev, n_steps):
    """Flagship training steps with the planner (fp32 parameters, batch 1,
    MODEL.REMAT as configured, TF32 off) after one warm-up: finite losses
    with 'planning' among them, nonzero gradients of the planner's
    parameters, and of the decoder's costvolume head in every step
    (warm-up included) where the loss's gradient reached the cost volume,
    at least one; step time and peak memory, K1, K2 (fp32 rows) and K2's
    backward once a step."""
    import torch
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch.ops import bin_sum as B
    from streamingflow_tpu_torch.ops import patch_pool as PP
    trainer = P.build_trainer(cfg, device=dev, seed=0)
    planning = trainer.module.model.planning
    plan_forward = planning.forward
    seen = []

    def read_cost_volume(*a, **kw):
        # the future cost volume the planner samples: the share of it inside
        # the volume cost's unclipped range (0, 1), and its gradient
        cv = kw['cost_volume']
        seen.append({'in_range': float(((cv > 0) & (cv < 1)).float()
                                       .mean())})
        cv.register_hook(lambda g: seen[-1].update(
            grad_cells=int((g != 0).sum())))
        return plan_forward(*a, **kw)

    planning.forward = read_cost_volume
    head = [p for n, p in trainer.module.named_parameters()
            if 'costvolume_head' in n]

    def counts():
        return {'bin_sum': B.launches, 'patch_pool': PP.launches,
                'patch_pool_fp32_rows': PP.launches_fp32,
                'patch_pool_bwd': PP.launches_bwd}

    def step(seed):
        batch = planning_batch(cfg, seed)
        gen = torch.Generator(device=dev).manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = P.train_step(trainer, batch, generator=gen)
        torch.cuda.synchronize()
        seen[-1]['head_grad_abs_max'] = max(float(p.grad.abs().max())
                                            for p in head)
        return metrics, time.perf_counter() - t0

    step(100)                                     # warm-up, not counted
    torch.cuda.reset_peak_memory_stats()
    B.launches = PP.launches = PP.launches_fp32 = PP.launches_bwd = 0
    times, losses, per = [], [], []
    for seed in range(1, n_steps + 1):
        before = counts()
        metrics, dt = step(seed)
        per.append({k: v - before[k] for k, v in counts().items()})
        times.append(dt)
        if 'planning' not in metrics:
            raise AssertionError('planning train: no planning loss')
        for k, v in metrics.items():
            if not torch.isfinite(v).all():
                raise AssertionError(f'planning train step {seed}: {k} not '
                                     f'finite')
        losses.append({k: float(v) for k, v in metrics.items()
                       if k in ('total_loss', 'planning',
                                'planning_uncertainty', 'grad_norm')})
    want = {'bin_sum': 1, 'patch_pool': 1, 'patch_pool_fp32_rows': 1,
            'patch_pool_bwd': 1}
    for i, got in enumerate(per):
        if got != want:
            raise AssertionError(f'planning train step {i}: launches {got}, '
                                 f'want {want}')
    planning.forward = plan_forward
    # the last step's gradients (clipped in place, not zeroed until the
    # next step)
    zero = [n for n, p in trainer.module.named_parameters()
            if '.planning.' in n and not float(p.grad.abs().max()) > 0]
    n_planning = sum(1 for n, _ in trainer.module.named_parameters()
                     if '.planning.' in n)
    if zero or not n_planning:
        raise AssertionError(f'planning train: zero gradients {zero}')
    # the cost volume takes a gradient only at the cells the loss samples
    # inside the volume cost's unclipped range (0, 1): where it did, the
    # costvolume head must have one too, and some step must have had one
    if any(s.get('grad_cells', 0) > 0 and not s['head_grad_abs_max'] > 0
           for s in seen) or not any(s.get('grad_cells', 0) > 0
                                     for s in seen):
        raise AssertionError(f'planning train: the planning loss does not '
                             f'reach the costvolume head: {seen}')
    line = {'steps': n_steps, 'step_s': times,
            'median_step_s': statistics.median(times), 'losses': losses,
            'per_step_launches': per, 'planning_parameters': n_planning,
            'cost_volume': seen,
            'peak_mem_gib': torch.cuda.max_memory_allocated() / 2 ** 30}
    del trainer
    torch.cuda.empty_cache()
    return line, counts()


def phase_planning(dev, n_requests, n_steps, card, train_line):
    """The planner on the flagship (PLANNING.ENABLED): serving, the module
    card against CPU, training; one JSON line.  ``train_line``: phase
    train's step time and peak memory, printed beside this phase's.
    Returns the kernels' launches of its serving and training runs."""
    cfg = planning_config()
    serve, serve_counts = phase_planning_serve(cfg, dev, n_requests)
    module = phase_planning_module(dev)
    train, train_counts = phase_planning_train(cfg, dev, n_steps)
    emit({'phase': 'planning', 'serve': serve, 'module': module,
          'train': train, 'train_without_planner': train_line,
          'card': card})
    return {k: serve_counts.get(k, 0) + train_counts.get(k, 0)
            for k in ('bin_sum', 'patch_pool', 'patch_pool_bwd')}


def phase_planning_cli(dev, card, tree, tmp):
    """``evaluate.main`` on phase cli's tree (which has a CAN bus) with the
    shipped config and PLANNING.ENABLED, no checkpoint (random weights of
    seed 0): it prints finite planning@1s and planning@2s values of
    obj_col, obj_box_col and L2, its candidates are not all zero, and K1
    and K2 run once a forecast."""
    import io
    import torch
    from streamingflow_tpu_torch import evaluate as E
    from streamingflow_tpu_torch.data.dataloader import stop_worker_server
    from streamingflow_tpu_torch.ops import bin_sum as B
    from streamingflow_tpu_torch.ops import patch_pool as PP
    cfg_file = os.path.join(ROOT, 'configs', 'prediction_lc_ode_variable.yml')
    opts = ['DATASET.DATAROOT', tree, 'DATASET.VERSION', 'mini',
            'MODEL.BEV_POOL_BACKEND', 'pallas_patch',
            'LOG_DIR', os.path.join(tmp, 'planning_log'),
            'PLANNING.ENABLED', 'True']
    seen = {'candidates_abs_max': [], 'forecasts': []}
    planner, fwd = E.run_planner, E.eval_forward

    def counts():
        return {'bin_sum': B.launches, 'patch_pool': PP.launches}

    def read_planner(planning, cfg, batch, *a, **kw):
        seen['candidates_abs_max'].append(
            float(batch['sample_trajectory'].abs().max()))
        return planner(planning, cfg, batch, *a, **kw)

    def read_forward(*a, **kw):
        before = counts()
        out = fwd(*a, **kw)
        seen['forecasts'].append({k: v - before[k]
                                  for k, v in counts().items()})
        return out

    E.run_planner, E.eval_forward = read_planner, read_forward
    B.launches = PP.launches = 0
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            results = E.main(['--config-file', cfg_file, '--device',
                              str(dev), *opts])
    finally:
        E.run_planner, E.eval_forward = planner, fwd
        stop_worker_server()
    print(text.getvalue(), end='', flush=True)
    printed = text.getvalue()
    for sec in (1, 2):
        for key in ('obj_col', 'obj_box_col', 'L2'):
            if f'planning@{sec}s {key}:' not in printed:
                raise AssertionError(f'planning cli: evaluate printed no '
                                     f'planning@{sec}s {key}')
    values = {f'{j + 1}s': {k: v.tolist() for k, v in m.items()}
              for j, m in enumerate(results['planning'])}
    if len(values) != 2 or not all(
            math.isfinite(x) for m in values.values() for v in m.values()
            for x in v):
        raise AssertionError(f'planning cli: planning metrics {values}')
    if not seen['candidates_abs_max'] or \
            min(seen['candidates_abs_max']) <= 0:
        raise AssertionError(f'planning cli: candidates '
                             f'{seen["candidates_abs_max"]}')
    for i, got in enumerate(seen['forecasts']):
        if got != {'bin_sum': 1, 'patch_pool': 1}:
            raise AssertionError(f'planning cli: forecast {i}: launches '
                                 f'{got}')
    emit({'phase': 'planning_cli', 'planning': values,
          'candidates_abs_max': seen['candidates_abs_max'],
          'forecast_s': results['forward_s'],
          'planner_s': results['planner_s'],
          'per_forecast_launches': seen['forecasts'],
          'states': {k: v for k, v in results['states'].items()
                     if k.startswith('planning')}, 'card': card})
    torch.cuda.empty_cache()
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


def phase_cli(dev, card, tmp):
    """The port's own entry points on the nuScenes data path: a
    flagship-size tree written from a seed (data/mini_nuscenes.py) into
    ``tmp`` (the caller removes it, after phase dp_cli has used it), the
    loader's host time a batch at 0 workers and at the config's N_WORKERS,
    then ``train.main`` (one epoch of the shipped flagship config with the
    'pallas_patch' pool: 3 steps, validation, a checkpoint) and
    ``evaluate.main`` on the checkpoint it wrote, every kernel count set to
    0 before the two and read after, and read around each step and each
    forecast."""
    import io
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
        return launches, tree
    finally:
        # the loaders closed their workers; stop the server they were
        # forked from
        stop_worker_server()


# ------------------------------------------------------------ data parallel
# Bars.  The JAX package holds its data-parallel step (tests/test_multichip
# .py) to: losses 1e-5 relative, gradients before clipping rtol 1e-4 / atol
# 1e-5, parameters after the step atol 2.1 LR, running statistics rtol 3e-3
# / atol 1e-5.  On the card the fp32 step does not repeat itself that
# closely: the same step run twice (the 'repeat' measures) differs by more
# than the gradient bar.  And the ranks' batch norms take E[x²] - E[x]² of
# the all-reduced fp32 sums (flax's rule), which cancels: the one-process
# step put through that same path over a group of one ('moments', equal to
# the one-process step within 1e-9 in fp64 on the CPU: tests/
# test_torch_parallel.py) lies as far from the one-process step as the
# ranks do (1 - cosine ~3e-3 on the flagship).  A planted fault, each
# rank's batch norms on its own rows ('fault'), lies at cosine below 0.1.
# So every two-rank phase prints each measure, the 'jax' bars it meets, the
# 'repeat', 'moments' and 'fault' legs, fails if the fault meets its bars,
# and holds the ranks to: 'card': the JAX package's
# bars for the running statistics and the parameters, losses 1e-4
# relative, the gradient norm 1e-2, the whole gradient's cosine above 0.99
# (1 - cosine 3x the sound legs', 1/90 of the fault's) and the LiDAR
# encoder's above 0.98 (the CPU's fp64 test holds the step to 1e-9);
# 'tiny': the bars this script and tests/test_torch_train_step.py hold the
# tiny fp32 step to (phase train_tiny_spconv: losses 1e-3, statistics 5e-3
# of max(scale, 1), the gradient norm 10 %, cosines above 0.98),
# parameters atol 2.1 LR.
DP_BARS = {
    'jax': {'loss_rel': 1e-5, 'grad_excess': 0.0, 'param_abs_lr': 2.1,
            'stats_excess': 0.0},
    'card': {'loss_rel': 1e-4, 'grad_norm_rel': 1e-2, 'grad_cosine': 0.99,
             'lidar_grad_cosine': 0.98, 'param_abs_lr': 2.1,
             'stats_excess': 0.0},
    'tiny': {'loss_rel': 1e-3, 'stats_rel': 5e-3, 'grad_norm_rel': 0.1,
             'grad_cosine': 0.98, 'lidar_grad_cosine': 0.98,
             'param_abs_lr': 2.1}}
# phase -> (configuration, points a cloud, timed steps after the first, bars)
DP_PHASES = {'dp_nccl1': ('flagship', 80000, 0, 'card'),
             'dp_gloo2': ('flagship', 80000, 3, 'card'),
             'dp_spconv': ('tiny_spconv', 512, 3, 'tiny')}


def _dp_cfg(name):
    """The flagship pillar8x training configuration (phase train's), or
    the tiny spconv8x one, each with PROBABILISTIC on (dropout and
    drop-connect are on in train mode)."""
    from streamingflow_tpu_torch.data import flagship_config
    cfg = flagship_config() if name == 'flagship' else _tiny_spconv_config()
    cfg.PROBABILISTIC.ENABLED = True
    return cfg


def _dp_counters(name):
    from streamingflow_tpu_torch.ops import bin_sum as B
    from streamingflow_tpu_torch.ops import patch_pool as PP
    from streamingflow_tpu_torch.ops import winfuse as WF
    counters = {'patch_pool': (PP, 'launches'),
                'patch_pool_bwd': (PP, 'launches_bwd')}
    if name == 'flagship':
        counters['bin_sum'] = (B, 'launches')
    else:
        counters.update(winfuse=(WF, 'launches'),
                        winfuse_dgrad=(WF, 'launches_dgrad'),
                        winfuse_wgrad=(WF, 'launches_wgrad'))
    return counters


def _dp_snapshot(trainer, metrics, cfg, out):
    """Into ``out``: the step's gradients before clipping, parameters and
    running statistics, on the CPU."""
    unclip = max(float(metrics['grad_norm']) / cfg.GRAD_NORM_CLIP, 1.0)
    names = {n for n, _ in trainer.module.named_parameters()}
    out['grads'] = {n: (p.grad * unclip).cpu()
                    for n, p in trainer.module.named_parameters()}
    out['state'] = {k: v.detach().to('cpu', copy=True) for k, v in
                    trainer.module.state_dict().items()}
    out['buffers'] = [k for k in out['state'] if k not in names
                      and 'num_batches' not in k]
    out['lr'] = cfg.OPTIMIZER.LR
    return out


@contextlib.contextmanager
def _local_moments():
    """A planted fault: every batch norm takes its statistics over the
    rank's own rows (the sums of global_moments left unreduced)."""
    from streamingflow_tpu_torch.layers import trainmode as TM
    from streamingflow_tpu_torch.models import lidar_encoder as LE
    real = TM.global_moments

    def local(s1, s2, n, pg):
        return s1, s2, n.to(s1.dtype)

    TM.global_moments = LE.global_moments = local
    try:
        yield
    finally:
        TM.global_moments = LE.global_moments = real


@contextlib.contextmanager
def _shard_path_of_one():
    """This process as a gloo group of one (a FileStore in a temporary
    directory), and train_step taking every coupling of samples through
    the data-parallel path over it: batch statistics from the all-reduced
    fp32 Σx and Σx² (E[x²] - E[x]², as the ranks take them), the loss
    denominators all-reduced.  The step is otherwise the one-process step
    on the whole batch (the draws, at the shard's shape, are the same)."""
    import datetime
    import torch.distributed as dist
    from streamingflow_tpu_torch.layers.trainmode import BatchShard
    from streamingflow_tpu_torch.training import trainer as T
    real = T.batch_shard
    with tempfile.TemporaryDirectory(prefix='sf_one_') as tmp:
        dist.init_process_group(
            'gloo', store=dist.FileStore(os.path.join(tmp, 'store'), 1),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=300))
        T.batch_shard = lambda tr, rows: BatchShard(0, rows, rows,
                                                    tr.group.pg)
        try:
            yield
        finally:
            T.batch_shard = real
            dist.destroy_process_group()


def dp_step_run(phase, world, timed=True, fault=False):
    """One training step of ``phase``'s configuration on the global batch
    of ``world`` samples (seed 7) from the weights of seed 0 and the
    generator of seed 11: the data-parallel step when this process is a
    rank of a launched group, else train_step on the whole batch.  Then
    the phase's timed steps (``timed``), and on ranks of a group of two or
    more the gradient all-reduce alone (5 times) and each rank's
    parameters against rank 0's.  Returns the step's losses, gradients
    before clipping, parameters and running statistics (on rank 0 or
    alone; on the CPU), the launch counts of the first step, the times and
    the peak memory.  ``fault``: then the same first step again from fresh
    weights with a planted fault (:func:`_local_moments`), its results on
    rank 0 under 'fault'."""
    import torch
    import torch.distributed as dist
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch.data import make_batch
    from streamingflow_tpu_torch.parallel import collect as C
    from streamingflow_tpu_torch.device import pin_tf32
    from streamingflow_tpu_torch.parallel import (make_data_parallel_step,
                                                  make_mesh)
    pin_tf32()
    name, n_points, n_timed, _ = DP_PHASES[phase]
    cfg = _dp_cfg(name)
    cfg.BATCHSIZE = world
    group = make_mesh(world) if dist.is_initialized() else None
    dev = group.device if group else torch.device('cuda', 0)

    def sync():
        torch.cuda.synchronize(dev)

    trainer = P.build_trainer(cfg, device=dev, seed=0, group=group)
    batch = make_batch(cfg, world, seed=7, n_points=n_points)
    step = (make_data_parallel_step(cfg, group) if group else
            lambda tr, b, g: P.train_step(tr, b, generator=g))
    counters = _dp_counters(name)

    def counts():
        return {k: getattr(m, a) for k, (m, a) in counters.items()}

    torch.cuda.reset_peak_memory_stats(dev)
    before, made = counts(), C.collectives
    metrics = step(trainer, batch, torch.Generator(dev).manual_seed(11))
    sync()
    launches = {k: v - before[k] for k, v in counts().items()}
    collectives = C.collectives - made
    main = group is None or group.rank == 0
    out = {'metrics': {k: float(v) for k, v in metrics.items()},
           'launches': launches, 'collectives': collectives,
           'device': str(dev), 'rank': 0 if group is None else group.rank}
    if main:
        _dp_snapshot(trainer, metrics, cfg, out)
    times = []
    for i in range(n_timed if timed else 0):
        sync()
        t0 = time.perf_counter()
        step(trainer, batch, torch.Generator(dev).manual_seed(12 + i))
        sync()
        times.append(time.perf_counter() - t0)
    out['step_s'] = times
    out['peak_mem_gib'] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if group is not None and group.world > 1:
        params = list(trainer.module.parameters())
        reduce_s = []
        for _ in range(5):
            dist.barrier(group=group.pg)
            sync()
            t0 = time.perf_counter()
            C.average_gradients(params, group)
            sync()
            reduce_s.append(time.perf_counter() - t0)
        out['allreduce_s'] = reduce_s
        out['allreduce_bytes'] = trainer.allreduce_bytes
        flat = torch.cat([p.detach().reshape(-1) for p in params])
        ref = flat.clone()
        dist.broadcast(ref, src=0, group=group.pg)
        out['max_diff_vs_rank0'] = float((flat - ref).abs().max())
        del params, flat, ref
    if fault:
        del trainer
        torch.cuda.empty_cache()
        with _local_moments():
            trainer = P.build_trainer(cfg, device=dev, seed=0, group=group)
            metrics = step(trainer, batch,
                           torch.Generator(dev).manual_seed(11))
        if main:
            out['fault'] = _dp_snapshot(
                trainer, metrics, cfg,
                {'metrics': {k: float(v) for k, v in metrics.items()}})
    return out


def _dp_measures(got, want):
    """How far ``got`` (a rank's step) lies from ``want`` (one process's
    step on the whole batch), by every measure a bar of DP_BARS reads."""
    import torch
    out = {}

    def worst(kind, value):
        out[kind] = max(out.get(kind, 0.0), value)

    for k, w in want['metrics'].items():
        g = got['metrics'][k]
        if k.startswith('diag/'):
            worst('diag_mismatch', float(int(g) != int(w)))
        elif k == 'grad_norm':
            worst('grad_norm_rel', abs(g - w) / w)
        else:
            worst('loss_rel', abs(g - w) / max(abs(w), 1e-12))
    grads = want['grads']
    floor = float(torch.stack([v.abs().max() for v in grads.values()])
                  .median())
    dots = {'grad_cosine': [0.0, 0.0, 0.0], 'lidar_grad_cosine': [0.0, 0.0,
                                                                 0.0]}
    for k, w in grads.items():
        g, w = got['grads'][k].double(), w.double()
        d = (g - w).abs()
        worst('grad_rel', float(d.max()) / max(float(w.abs().max()), floor))
        worst('grad_excess', float((d - 1e-5 - 1e-4 * w.abs()).max()))
        for key in (['grad_cosine', 'lidar_grad_cosine']
                    if k.startswith('model.lidar_encoder.')
                    else ['grad_cosine']):
            dots[key][0] += float((g * w).sum())
            dots[key][1] += float((g * g).sum())
            dots[key][2] += float((w * w).sum())
    for key, (gw, gg, ww) in dots.items():
        if gg and ww:
            out[key] = gw / (gg * ww) ** 0.5
    for k, w in want['state'].items():
        if 'num_batches' in k:
            continue
        g, w = got['state'][k].double(), w.double()
        d = (g - w).abs()
        if k in want['buffers']:
            worst('stats_excess', float((d - 1e-5 - 3e-3 * w.abs()).max()))
            worst('stats_rel', float(d.max()) / max(float(w.abs().max()),
                                                    1.0))
        else:
            worst('param_abs_lr', float(d.max()) / want['lr'])
            worst('param_rel', float(d.max()) / max(float(w.abs().max()),
                                                    floor))
    return out


def _dp_failures(measures, bars):
    """The bars of ``bars`` (a DP_BARS entry) that ``measures`` break:
    cosines must reach theirs, every other measure stay within its own."""
    failed = [k for k, bar in bars.items()
              if (measures.get(k, 1.0) < bar if k.endswith('cosine')
                  else not measures.get(k, 0.0) <= bar)]
    if measures.get('diag_mismatch'):
        failed.append('diag_mismatch')
    return failed


def _dp_reference(phase, world):
    """One process's step of ``phase`` on the whole batch (timed), and the
    same step run again: the second against the first is the step's own
    run-to-run spread on the card."""
    import torch
    want = dp_step_run(phase, world)
    again = dp_step_run(phase, world, timed=False)
    torch.cuda.empty_cache()
    return want, _dp_measures(again, want)


def _dp_report(measures, bars):
    """(failures against ``bars``, the 'jax' bars each measure meets)."""
    jax = {k: k not in _dp_failures(measures, {k: v})
           for k, v in DP_BARS['jax'].items()}
    return _dp_failures(measures, bars), jax


def phase_dp_nccl1(card):
    """The data-parallel step through an NCCL group of one rank (a spawned
    process on cuda:0) against train_step in this process: the flagship
    pillar8x training step at batch 1, same weights, batch and generator,
    PROBABILISTIC, dropout and drop-connect on, at the 'card' bars, beside
    train_step against itself run twice."""
    from streamingflow_tpu_torch.parallel.launch import spawn_ranks
    want, repeat = _dp_reference('dp_nccl1', 1)
    t0 = time.perf_counter()
    got, = spawn_ranks(dp_step_run, 1, 'dp_nccl1', 1, backend='nccl',
                       timeout_s=300.0)
    measures = _dp_measures(got, want)
    failed, jax = _dp_report(measures, DP_BARS['card'])
    if min(got['launches'].values()) < 1:
        failed.append(f"a kernel did not launch: {got['launches']}")
    emit({'phase': 'dp_nccl1', 'backend': 'nccl', 'world': 1,
          'device': got['device'], 'launches': got['launches'],
          'collectives': got['collectives'], 'measures': measures,
          'repeat_measures': repeat, 'bars': DP_BARS['card'],
          'jax_bars_met': jax, 'rank_s': time.perf_counter() - t0,
          'card': card})
    if failed:
        raise AssertionError('dp_nccl1: ' + '; '.join(failed[:20]))


def phase_dp_two_ranks(phase, card):
    """Two gloo ranks, both on cuda:0 (NCCL refuses two ranks on one
    card), one data-parallel step of global batch 2, against one
    process's batch-2 step on the card (fp32, TF32 off), at the phase's
    bars (DP_BARS: 'card' for the flagship, 'tiny' for the tiny spconv8x
    configuration), every measure printed beside the one-process step's
    run-to-run spread, the one-process step through the ranks'
    global-moments path (:func:`_shard_path_of_one`) and the ranks' step
    with local batch statistics (:func:`_local_moments`), which must break
    the bars; then the phase's timed steps in each (the first step their
    warm-up) and one process's, the gradient all-reduce's time and bytes,
    each rank's peak memory, launches and collectives a step, and the
    ranks' parameters equal."""
    import torch
    from streamingflow_tpu_torch.parallel.launch import spawn_ranks
    want, repeat = _dp_reference(phase, 2)
    with _shard_path_of_one():
        moments = dp_step_run(phase, 2, timed=False)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_ranks(dp_step_run, 2, phase, 2, True, True,
                        backend='gloo', timeout_s=600.0)
    wall = time.perf_counter() - t0
    bars = DP_BARS[DP_PHASES[phase][3]]
    measures = _dp_measures(ranks[0], want)
    failed, jax = _dp_report(measures, bars)
    witness = {'moments_vs_one': _dp_measures(moments, want),
               'ranks_vs_moments': _dp_measures(ranks[0], moments),
               'fault_vs_one': _dp_measures(ranks[0]['fault'], want)}
    if not _dp_failures(witness['fault_vs_one'], bars):
        failed.append('the planted fault (local batch statistics) meets '
                      'the bars')
    for r in ranks:
        if min(r['launches'].values()) < 1:
            failed.append(f"rank {r['rank']}: a kernel did not launch: "
                          f"{r['launches']}")
        if r['max_diff_vs_rank0'] != 0.0:
            failed.append(f"rank {r['rank']}: parameters differ from rank "
                          f"0's by {r['max_diff_vs_rank0']}")
        if r['metrics'] != ranks[0]['metrics']:
            failed.append(f"rank {r['rank']}: losses differ from rank 0's")
    emit({'phase': phase, 'config': DP_PHASES[phase][0], 'backend': 'gloo',
          'world': 2, 'global_batch': 2,
          'devices': [r['device'] for r in ranks],
          'measures': measures, 'repeat_measures': repeat, 'bars': bars,
          'jax_bars_met': jax, 'witness': witness,
          'fault_bars_broken': _dp_failures(witness['fault_vs_one'], bars),
          'losses': want['metrics'],
          'rank_step_s': [r['step_s'] for r in ranks],
          'median_rank_step_s': [statistics.median(r['step_s'])
                                 for r in ranks],
          'single_batch2_step_s': want['step_s'],
          'median_single_batch2_step_s': statistics.median(want['step_s']),
          'allreduce_s': [r['allreduce_s'] for r in ranks],
          'median_allreduce_s': statistics.median(
              t for r in ranks for t in r['allreduce_s']),
          'allreduce_bytes': ranks[0]['allreduce_bytes'],
          'collectives_a_step': [r['collectives'] for r in ranks],
          'peak_mem_gib': [r['peak_mem_gib'] for r in ranks],
          'single_batch2_peak_mem_gib': want['peak_mem_gib'],
          'launches': [r['launches'] for r in ranks],
          'single_launches': want['launches'], 'ranks_wall_s': wall,
          'card': card})
    if failed:
        raise AssertionError(f'{phase}: ' + '; '.join(failed[:20]))


def phase_dp_cli(dev, card, tree, tmp):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    streamingflow_tpu_torch.train --dist-backend gloo`` on phase cli's tree
    and yml with BATCHSIZE 2 and one epoch (two ranks on cuda:0); rank 0
    writes the checkpoint, and the validation, sharded over the ranks,
    equals evaluate.main of that checkpoint in this process at batch 2:
    the summed metric states (IoU's and PQ's counts, nonzero where the
    one-step model's scores are 0, so that a shard dropped or counted twice
    shows) within 1e-3 of each state's largest count, and vehicle IoU, PQ,
    SQ and RQ within 1e-3."""
    import io
    import numpy as np
    import re
    from streamingflow_tpu_torch import evaluate as E
    from streamingflow_tpu_torch.device import pin_tf32
    from streamingflow_tpu_torch.data.dataloader import stop_worker_server
    from streamingflow_tpu_torch.training.checkpoint import CheckpointManager
    cfg_file = os.path.join(ROOT, 'configs', 'prediction_lc_ode_variable.yml')
    log_dir = os.path.join(tmp, 'dp_log')
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           '--nproc_per_node', '2', '-m', 'streamingflow_tpu_torch.train',
           '--config-file', cfg_file, '--device', 'cuda',
           '--dist-backend', 'gloo', 'DATASET.DATAROOT', tree,
           'DATASET.VERSION', 'mini', 'MODEL.BEV_POOL_BACKEND',
           'pallas_patch', 'EPOCHS', '1', 'BATCHSIZE', '2',
           'LOGGING_INTERVAL', '1', 'LOG_DIR', log_dir]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    train_s = time.perf_counter() - t0
    if run.returncode != 0:
        print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f'dp_cli: the launcher exited '
                             f'{run.returncode}')
    val = re.findall(r'^val (.*)$', run.stdout, re.M)
    if len(val) != 1:
        raise AssertionError(f'dp_cli: {len(val)} validation lines')
    val = {k: float(v) for k, v in
           (kv.split('=') for kv in val[0].split())}
    states = re.findall(r'^val_states (.*)$', run.stdout, re.M)
    if len(states) != 1:
        raise AssertionError(f'dp_cli: {len(states)} validation state lines')
    states = json.loads(states[0])
    dirs = [os.path.join(log_dir, d, 'checkpoints')
            for d in os.listdir(log_dir)]
    if len(dirs) != 1 or CheckpointManager(dirs[0]).latest_step() != 1:
        raise AssertionError(f'dp_cli: checkpoints {dirs}')
    text = io.StringIO()
    # the ranks and evaluate both pin TF32 off (device.pin_tf32): one step
    # from random weights leaves a near-flat centre heatmap, and TF32's
    # rounding on one side only moved which of its maxima the panoptic
    # post-processing keeps
    ranks_tf32 = re.findall(r'^tf32 (.*)$', run.stdout, re.M)
    if len(ranks_tf32) != 2 or any(json.loads(t) != pin_tf32()
                                   for t in ranks_tf32):
        raise AssertionError(f'dp_cli: the ranks\' TF32 {ranks_tf32}')
    try:
        with contextlib.redirect_stdout(text):
            results = E.main(['--checkpoint', dirs[0], '--device', str(dev),
                              '--batch-size', '2'])
    finally:
        stop_worker_server()
    one = {'vehicle_iou': float(results['iou'][-1]),
           **{f'panoptic_{k}': float(v[-1])
              for k, v in results['pq'].items()}}
    diff = {k: abs(val[k] - v) for k, v in one.items()}
    state_diff = {}
    for k, want in results['states'].items():
        want = np.asarray(want, np.float64)
        got = np.asarray(states.get(k, np.zeros_like(want)), np.float64)
        state_diff[k] = (float(np.abs(got - want).max()) / want.max()
                         if got.shape == want.shape and want.max() > 0
                         else math.inf)
    steps = re.findall(r'^epoch 0 step (\d+) loss', run.stdout, re.M)
    emit({'phase': 'dp_cli', 'world': 2, 'backend': 'gloo',
          'train_s': train_s, 'steps': len(steps),
          'sharded_validation': val, 'evaluate_one_process': one,
          'abs_diff': diff, 'sharded_states': states,
          'evaluate_states': results['states'],
          'state_diff_of_largest': state_diff, 'bar': 1e-3, 'card': card})
    bad = {k: d for k, d in {**diff, **state_diff}.items()
           if not d <= 1e-3}
    if bad or not steps or set(states) != set(results['states']):
        raise AssertionError(f'dp_cli: validation vs evaluate {bad}, '
                             f'{len(steps)} steps, states {set(states)}')


# ------------------------------------------------------------- determinism
# ATen's warning under torch.use_deterministic_algorithms(True,
# warn_only=True) for an op with no deterministic route on the card
NONDETERMINISTIC_OP = r'^(.+?) does not have a deterministic implementation'


def _repeat_kernels(dev):
    """Each hand kernel of the step launched twice on one input at its
    flagship shapes: {kernel: equal bits}; then K1's and K2's
    deterministic routes (torch.use_deterministic_algorithms on): twice,
    equal bits, against the plain version (K2; K1's raw sums: its
    fp32 index_add_, itself in a varying order), and their times beside the
    atomic route's."""
    import torch
    from streamingflow_tpu_torch.data import flagship_config
    from streamingflow_tpu_torch.models.pillar_encoder import pillarize_batch
    from streamingflow_tpu_torch.ops import bin_sum as B
    from streamingflow_tpu_torch.ops import patch_pool as PP
    from streamingflow_tpu_torch.ops import winfuse as WF
    cfg = flagship_config()
    se = cfg.MODEL.SPARSE_ENCODER
    out, det = {}, {}

    def twice(name, fn):
        a = fn()
        b = fn()
        torch.cuda.synchronize()
        out[name] = torch.equal(a, b)
        return a

    pts, mask = flagship_clouds(cfg, dev)
    data, pid, n_bins, _ = flagship_cloud_rows(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x, coords, kept, nx, ny = flagship_pool_inputs(cfg, dev, gen)
    x32 = x.float()
    # name: (kernel, its reference, rtol, atol): the tolerances of phases
    # bin_sum (the bf16 epilogue against the atomic route; the raw sums
    # against the plain version) and patch_pool
    cases = {
        'bin_sum (5 clouds, pillar epilogue, bf16)':
            (lambda: pillarize_batch(pts, mask, se.POINT_CLOUD_RANGE,
                                     se.VOXEL_SIZE, out_dtype=torch.bfloat16,
                                     presorted=True), None, 2 ** -7, 1e-2),
        'bin_sum (raw fp32 sums)':
            (lambda: B.bin_sum(data, pid, n_bins, transposed_out=True),
             lambda: B.bin_sum_plain(data, pid, n_bins, transposed_out=True),
             1e-5, 1e-4),
        'patch_pool (bfloat16 rows)':
            (lambda: PP.patch_pool_frames(x, coords, kept, nx, ny)[0],
             lambda: PP.patch_pool_frames_plain(x, coords, kept, nx, ny)[0],
             1e-4, 1e-4),
        'patch_pool (float32 rows)':
            (lambda: PP.patch_pool_frames(x32, coords, kept, nx, ny)[0],
             lambda: PP.patch_pool_frames_plain(x32, coords, kept, nx,
                                                ny)[0], 1e-4, 1e-4)}
    atomic = {name: twice(name, case[0]) for name, case in cases.items()}
    times = {name: cuda_ms(case[0], reps=10) for name, case in cases.items()}
    torch.use_deterministic_algorithms(True)
    try:
        for name, (fn, plain, rtol, atol) in cases.items():
            a = fn()
            b = fn()
            torch.cuda.synchronize()
            want = atomic[name] if plain is None else plain()
            check_close(f'{name}, deterministic route', a, want, rtol, atol)
            det[name] = {
                'equal_bits': torch.equal(a, b),
                'max_abs_err_vs_atomic_route': max_err(a, atomic[name])[0],
                'max_abs_err_vs_plain': (None if plain is None
                                         else max_err(a, want)[0]),
                'ms': cuda_ms(fn, reps=10), 'atomic_route_ms': times[name]}
    finally:
        torch.use_deterministic_algorithms(False)
    dout = torch.randn(x.shape[0], nx, ny, 64, device=dev, generator=gen)
    twice('patch_pool_bwd', lambda: PP.patch_pool_grad(
        dout, coords, kept, nx, ny, torch.float32))
    k3, _ = k3_inputs(dev)
    for name, (feats, geo, w, nz, zmask) in k3.items():
        twice(f'winfuse ({name})', lambda: WF.subm_conv_winfuse(
            feats, geo.nbr, geo.found, w, nz))
        if name != 'conv_input':
            cout = w.shape[2]
            g = (torch.randn(geo.nbr.shape[1], nz, cout, device=dev,
                             generator=gen)
                 * zmask.reshape(-1, nz, 1)).to(feats.dtype).reshape(
                     -1, nz * cout)
            twice(f'winfuse_dgrad ({name})',
                  lambda: WF.subm_conv_dgrad(g, geo.src_t, w, nz))
    bad = [k for k, v in det.items() if not v['equal_bits']]
    if bad:
        raise AssertionError(f'determinism: the deterministic routes of '
                             f'{bad} changed bits between two launches')
    return out, det


DETERMINISM_LEGS = {
    'as_today': 'TF32 off, as every other phase runs the step',
    'deterministic': "cuBLAS's fixed workspace, cuDNN's deterministic "
                     "algorithms and ATen's deterministic mode (warn only), "
                     'set before CUDA starts; K1 and K2 take their '
                     'deterministic routes'}


def determinism_run(leg):
    """Two flagship pillar8x training steps in this (spawned) process from
    the same weights (seed 0), batch (seed 7) and generator (seed 11),
    PROBABILISTIC, dropout and drop-connect on, TF32 off, under the
    settings of ``leg`` (DETERMINISM_LEGS); in the deterministic leg the
    warnings of the ATen ops without a deterministic route are collected
    (a canary, torch.histc on the card, shows the collection works).
    Returns the second step against the first (_dp_measures), whether
    the losses, every gradient and the whole state have the same bits,
    the top-level modules whose gradients differ, and the warned ops."""
    import re
    import warnings
    deterministic = leg != 'as_today'
    if deterministic:
        os.environ['CUBLAS_WORKSPACE_CONFIG'] = ':4096:8'
    import torch
    if deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch.data import make_batch
    from streamingflow_tpu_torch.device import pin_tf32
    pin_tf32()
    cfg = _dp_cfg('flagship')
    dev = torch.device('cuda', 0)
    batch = make_batch(cfg, 1, seed=7, n_points=80000)
    runs = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        if deterministic:
            torch.histc(torch.rand(64, device=dev))
        for _ in range(2):
            trainer = P.build_trainer(cfg, device=dev, seed=0)
            metrics = P.train_step(trainer, batch,
                                   generator=torch.Generator(dev)
                                   .manual_seed(11))
            torch.cuda.synchronize()
            runs.append(_dp_snapshot(trainer, metrics, cfg, {
                'metrics': {k: float(v) for k, v in metrics.items()}}))
            del trainer
            torch.cuda.empty_cache()
    ops = sorted({m.group(1) for w in caught
                  for m in [re.match(NONDETERMINISTIC_OP, str(w.message))]
                  if m})
    canary = [op for op in ops if 'histc' in op]
    if deterministic and not canary:
        raise AssertionError(f'determinism {leg}: the canary warned nothing '
                             f'({[str(w.message)[:120] for w in caught]})')
    a, b = runs
    differ = sorted({k.split('.')[1] for k in a['grads']
                     if not torch.equal(a['grads'][k], b['grads'][k])})
    return {'leg': leg, 'settings': DETERMINISM_LEGS[leg],
            'measures': _dp_measures(b, a),
            'losses_equal': a['metrics'] == b['metrics'],
            'grads_equal': not differ,
            'state_equal': all(torch.equal(a['state'][k], b['state'][k])
                               for k in a['state']),
            'modules_with_differing_grads': differ,
            'nondeterministic_ops': [op for op in ops if op not in canary],
            'torch': torch.__version__}


def phase_determinism(dev, card):
    """Why the fp32 step does not repeat itself on the card: each hand
    kernel launched twice on one input (equal bits or not), then the
    flagship pillar8x step twice in a spawned process under each leg of
    DETERMINISM_LEGS, naming the ATen ops that have no deterministic
    route."""
    from streamingflow_tpu_torch.parallel.launch import spawn_ranks
    t0 = time.perf_counter()
    kernels, routes = _repeat_kernels(dev)
    legs = {}
    for leg in DETERMINISM_LEGS:
        legs[leg], = spawn_ranks(determinism_run, 1, leg, timeout_s=600.0)
    emit({'phase': 'determinism', 'kernels_equal_bits': kernels,
          'deterministic_routes': routes, 'step': legs,
          'seconds': time.perf_counter() - t0, 'card': card})
    det = legs['deterministic']
    if not (det['losses_equal'] and det['grads_equal'] and det['state_equal']
            and not det['nondeterministic_ops']):
        raise AssertionError(f'determinism: the step under the deterministic '
                             f"settings does not repeat itself: {det}")
    return kernels, legs


# --------------------------------------------------- flagship bf16 parity
@contextlib.contextmanager
def _plain_on_card():
    """Every hand kernel of the forward replaced by its plain version, on
    the card's tensors: the bf16 forward's rounding without the kernels."""
    from streamingflow_tpu_torch.ops import bin_sum as B
    from streamingflow_tpu_torch.ops import patch_pool as PP
    from streamingflow_tpu_torch.ops import winfuse as WF
    real = (B._bin_sum_cuda, PP._patch_pool_cuda, WF._conv)

    def bin_sum(data, ids, n_clouds, bins_per_cloud, n_store, pf, out_dtype,
                presorted, k_tiles):
        return B.bin_sum_clouds_plain(data, ids, n_clouds, bins_per_cloud,
                                      n_store, pf, out_dtype)

    B._bin_sum_cuda = bin_sum
    PP._patch_pool_cuda = PP.patch_pool_frames_plain
    WF._conv = WF.subm_conv_plain
    try:
        yield
    finally:
        B._bin_sum_cuda, PP._patch_pool_cuda, WF._conv = real


def phase_bf16_flagship(dev, card):
    """The flagship bf16 forecast against the card's own fp32 forecast,
    same weights (seed 0) and request (seed 1), output by output, on
    pillar8x and spconv8x; PROBABILISTIC off (the GRU-ODE's mean: the two
    precisions would draw different noise).  The bar is derived as
    tiny_bf16 derives its own: per output, max(2 x the error of the same
    bf16 forecast with every hand kernel replaced by its plain version on
    the card, 4 bf16 steps (4 x 2^-8) of the output's largest value)."""
    import torch
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch.data import flagship_config, make_batch
    from streamingflow_tpu_torch.ops import bin_sum as B
    from streamingflow_tpu_torch.ops import patch_pool as PP
    from streamingflow_tpu_torch.ops import winfuse as WF
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    line = {'phase': 'bf16_flagship'}
    for backbone in ('pillar8x', 'spconv8x'):
        cfg16 = flagship_config(backbone=backbone)
        cfg16.PROBABILISTIC.ENABLED = False
        cfg32 = flagship_config(backbone=backbone)
        cfg32.PROBABILISTIC.ENABLED = False
        cfg32.MODEL.SPARSE_ENCODER.COMPUTE_DTYPE = 'float32'
        batch = make_batch(cfg32, 1, seed=1, n_points=80000)
        m32 = P.build_model(cfg32, device=dev, seed=0)
        with torch.no_grad():
            ref = m32(**P.batch_to_model_args(batch, cfg32, device=dev))
        state = m32.state_dict()
        del m32
        m16 = P.build_model(cfg16, device=dev, dtype=bf16)
        m16.load_state_dict(state)
        args16 = P.batch_to_model_args(batch, cfg16, device=dev,
                                       image_dtype=bf16)
        counters = {'bin_sum': B, 'patch_pool': PP, 'winfuse': WF}
        before = {k: m.launches for k, m in counters.items()}
        with torch.no_grad():
            got = m16(**args16)
        torch.cuda.synchronize()
        launched = {k: m.launches - before[k] for k, m in counters.items()}
        with torch.no_grad(), _plain_on_card():
            plain = m16(**args16)
        torch.cuda.synchronize()
        if {k: m.launches - before[k] for k, m in counters.items()} != \
                launched:
            raise AssertionError('bf16_flagship: a kernel launched inside '
                                 'the plain forecast')
        need = ('patch_pool', 'winfuse' if backbone == 'spconv8x'
                else 'bin_sum')
        if not all(launched[k] for k in need):
            raise AssertionError(f'bf16_flagship {backbone}: launches '
                                 f'{launched}')
        outputs = {}
        for k, w in ref.items():
            if w is None:
                continue
            w = w.float()
            g = got[k]
            if g.dtype != bf16 or not torch.isfinite(g).all():
                raise AssertionError(f'bf16_flagship {backbone} {k}: '
                                     f'{g.dtype}, finite '
                                     f'{bool(torch.isfinite(g).all())}')
            card_err = float((g.float() - w).abs().max())
            plain_err = float((plain[k].float() - w).abs().max())
            scale = float(w.abs().max())
            bar = max(2 * plain_err, 4 * 2 ** -8 * scale)
            outputs[k] = {'card_err': card_err, 'plain_bf16_err': plain_err,
                          'scale': scale, 'bar': bar,
                          'card_err_rel': card_err / max(scale, 1e-30)}
            if card_err > bar:
                raise AssertionError(f'bf16_flagship {backbone} {k}: card '
                                     f'error {card_err:.3g} > bar {bar:.3g} '
                                     f'(plain bf16 error {plain_err:.3g})')
        line[backbone] = {'launches': launched, 'outputs': outputs}
        del m16, ref, got, plain
        torch.cuda.empty_cache()
    emit({**line, 'bar': 'max(2 x the plain-on-card bf16 error, 4 x 2^-8 x '
                         'max|fp32 output|) against the card fp32 forecast',
          'seconds': time.perf_counter() - t0, 'card': card})


# ----------------------------------------------------- reference import
def _import_cfg(tree):
    """The shipped yml on phase cli's tree with the reference's LiDAR
    channel flow: spconv8x with 'winfuse', no pre-reduce 1x1 conv."""
    from streamingflow_tpu_torch.config import get_cfg
    opts = ['DATASET.DATAROOT', tree, 'DATASET.VERSION', 'mini',
            'MODEL.BEV_POOL_BACKEND', 'pallas_patch',
            'MODEL.LIDAR.BACKBONE', 'spconv8x',
            'MODEL.LIDAR.PRE_REDUCE_TEMPORAL', 'False',
            'MODEL.SPARSE_ENCODER.ENGINE', 'column',
            'MODEL.SPARSE_ENCODER.Z_FORMULATION', 'winfuse']
    cfg_file = os.path.join(ROOT, 'configs', 'prediction_lc_ode_variable.yml')
    return cfg_file, opts, get_cfg(argparse.Namespace(config_file=cfg_file,
                                                      opts=opts))


def phase_reference_import(dev, card, tree, tmp):
    """A reference (Lightning) checkpoint into the port at flagship width on
    spconv8x: a seeded train module's weights written under the
    reference's names (tests/torch_reference_names.py, the inverse of the
    rule table) as a ``.ckpt``, imported by ``python -m
    streamingflow_tpu_torch.tools.convert_checkpoint``, held equal to the
    seeded weights bit for bit outside the distribution head; one bf16
    forecast with each set of weights, within the forecast's own
    run-to-run spread; ``evaluate.main`` on the imported checkpoint over
    phase cli's tree, K2 and K3 counted; ``distribution_forward`` of the
    three methods at the flagship present state, card against CPU (1e-5
    of the scale).  Returns the evaluation's launches."""
    import io
    import torch
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch import evaluate as E
    from streamingflow_tpu_torch.convert import HEAD, state_to_flax
    from streamingflow_tpu_torch.data import make_batch
    from streamingflow_tpu_torch.data.dataloader import stop_worker_server
    from streamingflow_tpu_torch.models import distributions as D
    from streamingflow_tpu_torch.ops import patch_pool as PP
    from streamingflow_tpu_torch.ops import winfuse as WF
    from streamingflow_tpu_torch.tools import convert_checkpoint as CC
    from streamingflow_tpu_torch.training.checkpoint import CheckpointManager
    from streamingflow_tpu_torch.training.trainer import (
        StreamingFlowTrainModule)
    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    from torch_reference_names import reference_state_dict
    t0 = time.perf_counter()
    cfg_file, opts, cfg = _import_cfg(tree)
    torch.manual_seed(0)
    module = StreamingFlowTrainModule(cfg)
    seeded = module.state_dict()
    tree_flat = state_to_flax(module)
    flat = {f'{c}/{p}': v for c in ('params', 'batch_stats')
            for p, v in tree_flat[c].items()}
    sd = reference_state_dict(flat, CC.load_rules(CC.DEFAULT_RULES).RULES)
    ckpt = os.path.join(tmp, 'reference.ckpt')
    torch.save({'epoch': 0, 'state_dict': {
        'model.' + k: torch.from_numpy(v.copy()) for k, v in sd.items()}},
        ckpt)
    out_dir = os.path.join(tmp, 'imported')
    run = subprocess.run(
        [sys.executable, '-m', 'streamingflow_tpu_torch.tools.'
         'convert_checkpoint', '--torch-ckpt', ckpt, '--config-file',
         cfg_file, '--out', out_dir, *opts], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    if run.returncode:
        raise AssertionError(f'convert_checkpoint failed:\n{run.stderr}')
    report = json.loads(run.stdout.splitlines()[0])
    if report['missing'] != report['ignored']['missing'] or \
            report['unused_torch'] != report['ignored']['unused_torch']:
        raise AssertionError(f'reference_import: unexpected report {report}'
                             f'\n{run.stdout}')
    imported = CheckpointManager(out_dir).restore_raw()['model']
    compared = 0
    for k, v in seeded.items():
        if HEAD in k.split('.') or k.endswith('num_batches_tracked'):
            continue
        if not torch.equal(imported[k], v):
            raise AssertionError(f'reference_import: {k} differs from the '
                                 f'seeded weights')
        compared += 1

    # one bf16 forecast a set of weights, beside the forecast's own spread
    bf16 = torch.bfloat16
    cfg16 = _import_cfg(tree)[2]
    cfg16.MODEL.SPARSE_ENCODER.COMPUTE_DTYPE = 'bfloat16'
    batch = make_batch(cfg16, 1, seed=1, n_points=80000)
    args = P.batch_to_model_args(batch, cfg16, device=dev, image_dtype=bf16)

    def forecast(state):
        model = P.build_model(cfg16, device=dev, dtype=bf16)
        model.load_state_dict({k[6:]: v for k, v in state.items()
                               if k.startswith('model.')})
        runs = []
        for _ in range(2 if state is seeded else 1):
            with torch.no_grad():
                out = model(**args, generator=torch.Generator(dev)
                            .manual_seed(3))
            runs.append({k: v.float() for k, v in out.items()
                         if v is not None})
        return runs

    mine = forecast(seeded)
    theirs = forecast(imported)[0]
    agree = {}
    for k, a in mine[0].items():
        spread = float((mine[1][k] - a).abs().max())
        err = min(float((theirs[k] - m[k]).abs().max()) for m in mine)
        agree[k] = {'imported_vs_seeded': err, 'spread': spread}
        if err > spread:
            raise AssertionError(f'reference_import {k}: the imported '
                                 f'weights\' forecast is {err:.3g} from the '
                                 f'seeded one, beyond the spread {spread:.3g}')
    del mine, theirs
    torch.cuda.empty_cache()

    # evaluate on the imported checkpoint, K2 and K3 counted around it
    PP.launches = WF.launches = 0
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            results = E.main(['--checkpoint', out_dir, '--device', str(dev)])
    finally:
        stop_worker_server()
    launches = {'patch_pool': PP.launches, 'winfuse': WF.launches}
    print(text.getvalue(), end='', flush=True)
    if not all(launches.values()):
        raise AssertionError(f'reference_import: evaluate launched '
                             f'{launches}')

    # the distribution head at the flagship present state (200 x 200),
    # card vs CPU.  The Gaussian heads' four stride-2 Bottlenecks need a
    # side divisible by 16 (at 200 the conv path gives 13 where the max
    # pool gives 12, and the JAX module refuses it the same way:
    # tests/test_torch_distributions.py), so they run at 192 x 192 and are
    # shown to refuse 200 x 200
    tm = cfg.MODEL.TEMPORAL_MODEL.START_OUT_CHANNELS
    latent = cfg.MODEL.DISTRIBUTION.LATENT_DIM
    heads = {}
    for method, side in (('GAUSSIAN', 192), ('MIXGAUSSIAN', 192),
                         ('BERNOULLI', 200)):
        torch.manual_seed(1)
        head = D.DistributionModule(tm, latent, method).eval().to(dev)
        if side != 200:
            try:
                with torch.no_grad():
                    head(torch.zeros(1, 1, 200, 200, tm, device=dev))
            except RuntimeError:
                pass
            else:
                raise AssertionError(f'reference_import: the {method} head '
                                     f'took a 200 x 200 state')
        x = torch.randn(1, 1, side, side, tm, generator=torch.Generator()
                        .manual_seed(5))
        with torch.no_grad():
            got = D.distribution_forward(head(x.to(dev)), latent, method,
                                         (side, side), None).cpu()
            head.cpu()
            want = D.distribution_forward(head(x), latent, method,
                                          (side, side), None)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        heads[method] = {'shape': list(got.shape), 'max_abs_err': err,
                         'scale': scale}
        if not torch.isfinite(got).all() or err > 1e-5 * max(scale, 1.0):
            raise AssertionError(f'reference_import: distribution_forward '
                                 f'{method}: {err:.3g} over {scale:.3g}')
    emit({'phase': 'reference_import', 'report': report,
          'tensors_equal': compared, 'forecast': agree,
          'eval': {'vehicle_iou': results['iou'].tolist(),
                   **{k: v.tolist() for k, v in results['pq'].items()}},
          'eval_launches': launches, 'distribution_forward': heads,
          'seconds': time.perf_counter() - t0, 'card': card})
    return launches


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
    from streamingflow_tpu_torch.device import pin_tf32
    tf32 = pin_tf32()

    dev = torch.device('cuda', 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({'phase': 'device', 'name': name, 'nvidia_smi': smi,
          'count': torch.cuda.device_count(), 'torch': torch.__version__,
          'cuda': torch.version.cuda, 'tf32': tf32})

    from concurrent.futures import ThreadPoolExecutor
    from streamingflow_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    # every source, the pool's loads-only variant (phase patch_pool) and the
    # d weights' ablations (phase winfuse), all nvcc processes started
    # together
    with ThreadPoolExecutor(4) as pool:
        jobs = [pool.submit(cuda_lib.build),
                pool.submit(cuda_lib.build, ['patch_pool'],
                            ('PATCH_POOL_LOADS_ONLY=1',))]
        jobs += [pool.submit(cuda_lib.build, ['winfuse_wgrad'], part)
                 for part in WGRAD_PARTS.values()]
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
    wide_launches = phase_sparse_options(dev, args.requests, smi)
    phase_bin_sum_grouped(cfg, dev, results)
    phase_patch_pool_bwd(cfg, dev, results)
    phase_train_tiny(dev)
    train_summary = {}
    train_launches = phase_train(cfg, dev, args.train_steps, smi,
                                 summary=train_summary)
    planning_launches = phase_planning(dev, args.requests, args.train_steps,
                                       smi, train_summary)
    phase_train_tiny_spconv(dev)
    spconv_launches = phase_train_spconv(dev, args.train_steps, smi)
    phase_bf16_flagship(dev, smi)
    phase_determinism(dev, smi)
    tmp = tempfile.mkdtemp(prefix='streamingflow_cli_')
    try:
        cli_launches, tree = phase_cli(dev, smi, tmp)
        import_launches = phase_reference_import(dev, smi, tree, tmp)
        for k, v in phase_planning_cli(dev, smi, tree, tmp).items():
            planning_launches[k] += v
        phase_dp_nccl1(smi)
        phase_dp_two_ranks('dp_gloo2', smi)
        phase_dp_two_ranks('dp_spconv', smi)
        phase_dp_cli(dev, smi, tree, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # launches: of the serving path's requests (bin_sum, patch_pool,
    # winfuse), of the training steps (patch_pool_bwd, and the spconv8x
    # steps' winfuse_dgrad and winfuse_wgrad; train_launches for the forward
    # kernels), of the experiment tool (bin_sum_grouped); import_launches:
    # of evaluate on the imported reference checkpoint (phase
    # reference_import); planning_launches: of phase planning's forecasts
    # and steps and phase planning_cli's forecasts
    kernels = [
        dict(name='bin_sum', route='cuda',
             source='streamingflow_tpu_torch/csrc/bin_sum.cu',
             replaces='streamingflow_tpu/ops/pallas_bin.py:63',
             launches=launches['bin_sum'],
             train_launches=train_launches['bin_sum'],
             cli_launches=cli_launches['bin_sum'],
             planning_launches=planning_launches['bin_sum'],
             **results['bin_sum']),
        dict(name='patch_pool', route='cuda',
             source='streamingflow_tpu_torch/csrc/patch_pool.cu',
             replaces='streamingflow_tpu/ops/pallas_patch_pool.py:49',
             launches=launches['patch_pool'],
             train_launches=train_launches['patch_pool'],
             cli_launches=cli_launches['patch_pool'],
             import_launches=import_launches['patch_pool'],
             planning_launches=planning_launches['patch_pool'],
             **results['patch_pool']),
        dict(name='winfuse', route='cuda',
             source='streamingflow_tpu_torch/csrc/winfuse.cu',
             replaces='streamingflow_tpu/ops/pallas_winfuse.py:153',
             launches=launches['winfuse'],
             train_launches=spconv_launches['winfuse'],
             import_launches=import_launches['winfuse'],
             **results['winfuse']),
        dict(name='winfuse_dgrad', route='cuda',
             source='streamingflow_tpu_torch/csrc/winfuse.cu',
             replaces='streamingflow_tpu/ops/pallas_winfuse.py:288',
             launches=spconv_launches['winfuse_dgrad'],
             **results['winfuse_dgrad']),
        dict(name='winfuse_wgrad', route='cuda',
             source='streamingflow_tpu_torch/csrc/winfuse_wgrad.cu',
             replaces='streamingflow_tpu/ops/pallas_winfuse.py:288',
             launches=spconv_launches['winfuse_wgrad'],
             **results['winfuse_wgrad']),
        *[dict(name=f'{kind}_wide{width}', route='cuda',
               source=f'streamingflow_tpu_torch/csrc/{src}.cu',
               replaces=f'streamingflow_tpu/ops/pallas_winfuse.py:{line}',
               launches=wide_launches[leg][f'launches{key}_wide'].get(
                   width, 0),
               **results[f'{kind}_wide{width}'])
          for kind, src, line, leg, key in (
              ('winfuse', 'winfuse', 153, 'forecast', ''),
              ('winfuse_dgrad', 'winfuse', 288, 'step', '_dgrad'),
              ('winfuse_wgrad', 'winfuse_wgrad', 288, 'step', '_wgrad'))
          for width in (64, 128)],
        dict(name='bin_sum_grouped', route='cuda',
             source='streamingflow_tpu_torch/csrc/bin_sum_grouped.cu',
             replaces='tools/exp_bin_variants.py:26',
             **results['bin_sum_grouped']),
        dict(name='patch_pool_bwd', route='cuda',
             source='streamingflow_tpu_torch/csrc/patch_pool.cu',
             replaces='streamingflow_tpu/ops/pallas_patch_pool.py:257',
             launches=train_launches['patch_pool_bwd'],
             cli_launches=cli_launches['patch_pool_bwd'],
             planning_launches=planning_launches['patch_pool_bwd'],
             **results['patch_pool_bwd']),
    ]
    for k in kernels:
        if k['launches'] < 1:
            raise AssertionError(f"{k['name']} was not launched on the main "
                                 f"path")
        if k.get('planning_launches', 1) < 1:
            raise AssertionError(f"{k['name']} was not launched on the "
                                 f"planning path")
    # every process a phase started (nvcc, loader workers, the workers'
    # fork server and resource tracker) has ended
    left = _descendants()
    if left:
        raise AssertionError(f'processes still running: {left}')
    line = {'kernels': kernels}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump({'card': smi, 'phases': EMITTED, **line}, f, indent=1)
    emit(line)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
