#!/usr/bin/env python3
"""Card gate of the PyTorch port: build its CUDA kernels, hold each against
its plain PyTorch version, and serve full-width forecasts on one GPU.

    python3 chip_smoke.py [--requests 3] [--out runs/chip_smoke.json]

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit.  Phases, each printing one JSON line:

  1. device      the card, and nvidia-smi's name and power limit
  2. build       nvcc of every csrc/*.cu, all at once, with its time
  3. bin_sum     kernel vs plain version at flagship shapes (one 80k-point
                 cloud, 1600^2 pillar grid, pillar epilogue, bf16 out,
                 presorted and unsorted; raw fp32 sums too)
  4. patch_pool  kernel vs plain version at flagship shapes (3 frames x 6
                 cameras x 48 depth bins x 28 x 60 x 64 from the synthetic
                 calibration) and a forced-overflow case
  5. tiny        a tiny camera+LiDAR forward on the card (kernels) vs the
                 same weights on the CPU (plain versions)
  6. forward     the flagship forward (bench.py's full_cfg: 6 cameras at
                 224x480 with EfficientNet-B4, 5 clouds of 80k points on the
                 pillar8x backbone, 200x200 BEV, variable-step GRU-ODE,
                 3 past frames -> 4 futures) in bf16, answering --requests
                 requests with kernel launch counts read around them
  7. kernels     every kernel of the port with its launches, error and times

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
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


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


def phase_bin_sum(cfg, dev, results):
    """K1 at one flagship cloud."""
    import torch
    from streamingflow_tpu_torch.data import make_batch
    from streamingflow_tpu_torch.models.pillar_encoder import (pillar_grid,
                                                               pillar_rows)
    from streamingflow_tpu_torch.ops import bin_sum as B
    se = cfg.MODEL.SPARSE_ENCODER
    pts = torch.from_numpy(make_batch(cfg, 1, seed=0, n_points=80000)
                           ['points'][0, 0]).to(dev)
    data, pid = pillar_rows(pts, (pts[:, :3] != 0).any(-1),
                            se.POINT_CLOUD_RANGE, se.VOXEL_SIZE)
    nx, ny = pillar_grid(se.POINT_CLOUD_RANGE, se.VOXEL_SIZE)
    n_bins, c = nx * ny + 1, data.shape[1]
    kw = dict(pillar_features=pts.shape[1], out_dtype=torch.bfloat16,
              transposed_out=True)
    want = B.bin_sum_plain(data, pid, n_bins, **kw)
    # bf16 outputs: fp32 sums in another order may round to the next bf16
    # value (rel 2^-8); rtol 2^-7 with atol 1e-2 for values near zero
    tol = dict(rtol=2 ** -7, atol=1e-2)
    errs = []
    for presorted in (True, False):
        got = B.bin_sum(data, pid, n_bins, presorted=presorted, **kw)
        torch.cuda.synchronize()
        check_close(f'bin_sum presorted={presorted}', got, want, **tol)
        errs.append(max_err(got, want))
    # raw fp32 sums (no epilogue), rows shuffled: fp32 reassociation only
    perm = torch.randperm(data.shape[0], device=dev)
    raw = B.bin_sum(data[perm], pid[perm], n_bins, transposed_out=True)
    raw_want = B.bin_sum_plain(data, pid, n_bins, transposed_out=True)
    torch.cuda.synchronize()
    check_close('bin_sum raw fp32', raw, raw_want, rtol=1e-5, atol=1e-4)

    sums = torch.zeros(n_bins, c, device=dev)
    ids64 = pid.long()
    ms = cuda_ms(lambda: B.bin_sum(data, pid, n_bins, presorted=True, **kw))
    plain_ms = cuda_ms(lambda: B.bin_sum_plain(data, pid, n_bins, **kw))
    library_ms = cuda_ms(lambda: sums.index_add_(0, ids64, data))
    n_in = data.numel() * 4 + pid.numel() * 4
    n_out = c * n_bins * 2
    flops = data.numel() + n_bins * c * 4      # adds + epilogue
    bound_ms = max((n_in + n_out) / HBM_BYTES_PER_S,
                   flops / FP32_FLOPS) * 1e3
    results['bin_sum'] = dict(
        max_abs_err=errs[0][0], ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=bound_ms, bound_by='bytes')
    emit({'phase': 'bin_sum', 'points': int(pts.shape[0]), 'n_bins': n_bins,
          'channels': c, 'max_abs_err_presorted': errs[0][0],
          'max_rel_err_presorted': errs[0][1],
          'max_abs_err_unsorted': errs[1][0], 'tolerance': tol,
          'kernel_ms': ms, 'twin_ms': plain_ms, 'library_ms': library_ms,
          'library_call': 'index_add_ of the raw sums (no epilogue)',
          'bound_us': bound_ms * 1e3, 'bytes': n_in + n_out})


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
    import torch
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch.data import make_batch
    from streamingflow_tpu_torch.ops import bin_sum as B
    from streamingflow_tpu_torch.ops import patch_pool as PP
    from streamingflow_tpu_torch.data.synthetic import n_lidar_sweeps
    model = P.build_model(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    n_clouds = n_lidar_sweeps(cfg)
    s = cfg.TIME_RECEPTIVE_FIELD
    t = s + cfg.N_FUTURE_FRAMES
    nx, ny = (int(v) for v in model.bev_dimension[:2])
    n = len(cfg.IMAGE.NAMES)
    d, fh, fw = model.frustum.shape[:3]

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
    B.launches = PP.launches = 0
    lat, drops, per_request = [], [], []
    for seed in range(1, n_requests + 1):
        k1, k2 = B.launches, PP.launches
        out, dt = request(seed)
        per_request.append((B.launches - k1, PP.launches - k2))
        lat.append(dt)
        drops.append(PP.last_drops.tolist())
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
    launches = {'bin_sum': B.launches, 'patch_pool': PP.launches}
    for i, (a, b) in enumerate(per_request):
        if a != n_clouds or b < 1:
            raise AssertionError(f'request {i}: bin_sum launched {a} times '
                                 f'(want {n_clouds}), patch_pool {b}')
    emit({'phase': 'forward', 'requests': n_requests,
          'latency_s': lat, 'median_latency_s': statistics.median(lat),
          'forecasts_per_s': 1.0 / statistics.median(lat),
          'launches': launches, 'per_request_launches': per_request,
          'patch_pool_drops': drops, 'peak_mem_gib':
          torch.cuda.max_memory_allocated() / 2 ** 30, 'card': card})
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--requests', type=int, default=3)
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
    phase_tiny(dev)
    launches = phase_forward(cfg, dev, args.requests, smi)

    kernels = [
        dict(name='bin_sum', route='cuda',
             source='streamingflow_tpu_torch/csrc/bin_sum.cu',
             replaces='streamingflow_tpu/ops/pallas_bin.py:63',
             launches=launches['bin_sum'], **results['bin_sum']),
        dict(name='patch_pool', route='cuda',
             source='streamingflow_tpu_torch/csrc/patch_pool.cu',
             replaces='streamingflow_tpu/ops/pallas_patch_pool.py:49',
             launches=launches['patch_pool'], **results['patch_pool']),
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
