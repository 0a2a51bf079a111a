"""A/B of two checkouts of the port, in turns on one card.

    python3 streamingflow_tpu_torch/tools/ab.py ROOT_A ROOT_B \
        [--backbone pillar8x|spconv8x] [--order ABBA] [--requests 10] \
        [--train-steps 3] [--out FILE]

Each ROOT is a directory holding a ``streamingflow_tpu_torch`` package (this
checkout, or an older one unpacked with ``git archive``).  For each letter
of ``--order`` a fresh process imports the package of that root and
measures, at flagship shapes (``data.flagship_config(backbone=...)``, seed
0).  On ``pillar8x`` (the default):

  - K1 on one 80k-point cloud (pillar epilogue, bf16 out, presorted): the
    wrapper ``bin_sum`` and the kernel alone on prepared inputs (tile bounds
    or offsets and the output made beforehand), CUDA events over 20 calls;
  - the pillar statistics of one request (5 clouds):
    ``PillarBEVEncoder.pillar_features``, CUDA events over 20 calls, with its
    K1 launches;
  - the bf16 forecast: median host-clock latency of ``--requests`` requests
    after one warm-up;
  - the fp32 train step (batch 1): median of ``--train-steps`` steps after
    one warm-up.

On ``spconv8x``:

  - K3 through its wrapper ``subm_conv_winfuse`` at the three bf16 shapes of
    one request (conv_input, stage 1, stage 2: ``chip_smoke.k3_inputs`` of
    the checkout holding this tool, on the package under test), CUDA events
    over 20 calls, and their forecast estimate conv_input + 4 x stage 1 +
    4 x stage 2;
  - the bf16 forecast, as above, with its K3 launches per request.

Run as a script, not as a module, so that each process imports the package
under test and nothing else.  Prints one JSON line per turn and a summary
line with the card's name and power limit; needs a CUDA card.
"""
import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

# the repository root of this tool's checkout (its chip_smoke.py)
_HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
KEYS = {'pillar8x': ('k1_wrapper_ms', 'k1_kernel_ms', 'pillar_features_ms',
                     'median_latency_s', 'median_step_s'),
        'spconv8x': ('k3_conv_input_ms', 'k3_stage1_ms', 'k3_stage2_ms',
                     'k3_forecast_ms_est', 'median_latency_s')}


def _event_ms(fn, reps=20, warmup=3):
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


def _kernel_alone(B, cuda_lib, data, pid, n_bins, n_feat):
    """A callable that launches K1 once on prepared inputs, for this
    checkout's interface or for the first one (offsets over n_tiles + 1)."""
    import torch
    if hasattr(B, 'launch'):
        bounds = B.tile_bounds(pid, n_bins)
        out = torch.empty(1, data.shape[1], B.padded_bins(n_bins),
                          dtype=torch.bfloat16, device=data.device)
        return lambda: B.launch(data, pid, bounds, out, n_bins, n_bins,
                                n_bins, n_feat)
    n_tiles = -(-n_bins // B.BINS_PER_TILE)
    starts = torch.arange(n_tiles + 1, dtype=torch.int32, device=data.device)
    offsets = torch.searchsorted(pid // B.BINS_PER_TILE, starts,
                                 out_int32=True)
    out = torch.empty(data.shape[1], n_bins, dtype=torch.bfloat16,
                      device=data.device)
    fn = cuda_lib.kernel('bin_sum')
    stream = torch.cuda.current_stream().cuda_stream

    def once():
        cuda_lib.check('bin_sum', fn(
            data.data_ptr(), pid.data_ptr(), offsets.data_ptr(),
            out.data_ptr(), n_tiles, n_bins, data.shape[1], n_feat, 1,
            stream))
    return once


def _latencies(P, model, cfg, dev, n_requests, counter=None):
    """Median host-clock latency of n_requests bf16 forecasts after one
    warm-up, with counter's launches per request."""
    import torch
    from streamingflow_tpu_torch.data import make_batch

    def request(seed):
        args = P.batch_to_model_args(make_batch(cfg, 1, seed=seed,
                                                n_points=80000),
                                     cfg, device=dev,
                                     image_dtype=torch.bfloat16)
        gen = torch.Generator(device=dev).manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            model(**args, generator=gen)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    request(100)
    if counter is not None:
        counter.launches = 0
    lat = [request(s) for s in range(1, n_requests + 1)]
    out = {'latency_s': lat, 'median_latency_s': statistics.median(lat)}
    if counter is not None:
        out['launches_per_request'] = counter.launches / n_requests
    return out


def measure_spconv(root, n_requests):
    """One spconv8x turn: the package under ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch.data import flagship_config
    from streamingflow_tpu_torch.ops import winfuse as WF
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(_HERE, 'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    result = {'root': root, 'package': os.path.dirname(P.__file__)}
    cases, _ = smoke.k3_inputs(dev)
    for name, (feats, geo, w, nz, _) in cases.items():
        result[f'k3_{name}_ms'] = _event_ms(
            lambda: WF.subm_conv_winfuse(feats, geo.nbr, geo.found, w, nz))
    result['k3_forecast_ms_est'] = result['k3_conv_input_ms'] + 4 * (
        result['k3_stage1_ms'] + result['k3_stage2_ms'])
    del cases
    cfg = flagship_config(backbone='spconv8x')
    model = P.build_model(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    result.update(_latencies(P, model, cfg, dev, n_requests, WF))
    return result


def measure(root, n_requests, n_train_steps):
    """One pillar8x turn: the package under ``root``, measured as the
    docstring says."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch.data import flagship_config, make_batch
    from streamingflow_tpu_torch.models.pillar_encoder import (pillar_grid,
                                                               pillar_rows)
    from streamingflow_tpu_torch.ops import bin_sum as B
    from streamingflow_tpu_torch.ops import cuda_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    cfg = flagship_config()
    se = cfg.MODEL.SPARSE_ENCODER
    result = {'root': root, 'package': os.path.dirname(P.__file__)}

    batch = make_batch(cfg, 1, seed=0, n_points=80000)
    pts = torch.from_numpy(batch['points']).to(dev)
    cloud = pts[0, 0]
    data, pid = pillar_rows(cloud, (cloud[:, :3] != 0).any(-1),
                            se.POINT_CLOUD_RANGE, se.VOXEL_SIZE)
    nx, ny = pillar_grid(se.POINT_CLOUD_RANGE, se.VOXEL_SIZE)
    n_bins, n_feat = nx * ny + 1, cloud.shape[1]
    result['k1_wrapper_ms'] = _event_ms(lambda: B.bin_sum(
        data, pid, n_bins, pillar_features=n_feat, out_dtype=torch.bfloat16,
        presorted=True, transposed_out=True))
    result['k1_kernel_ms'] = _event_ms(_kernel_alone(B, cuda_lib, data, pid,
                                                     n_bins, n_feat))

    model = P.build_model(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    enc = model.lidar_encoder
    B.launches = 0
    with torch.no_grad():
        enc.pillar_features(pts)
    result['pillar_features_launches'] = B.launches
    with torch.no_grad():
        result['pillar_features_ms'] = _event_ms(
            lambda: enc.pillar_features(pts))

    result.update(_latencies(P, model, cfg, dev, n_requests))
    del model

    trainer = P.build_trainer(cfg, device=dev, seed=0)

    def step(seed):
        b = make_batch(cfg, 1, seed=seed, n_points=80000)
        gen = torch.Generator(device=dev).manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        P.train_step(trainer, b, generator=gen)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    step(100)
    steps = [step(s) for s in range(1, n_train_steps + 1)]
    result.update(step_s=steps, median_step_s=statistics.median(steps))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('roots', nargs='*')
    ap.add_argument('--backbone', default='pillar8x', choices=sorted(KEYS))
    ap.add_argument('--order', default='ABBA')
    ap.add_argument('--requests', type=int, default=10)
    ap.add_argument('--train-steps', type=int, default=3)
    ap.add_argument('--out', default=None)
    ap.add_argument('--measure', default=None,
                    help='measure this root in this process (one turn)')
    args = ap.parse_args(argv)
    if args.measure is not None:
        result = (measure_spconv(args.measure, args.requests)
                  if args.backbone == 'spconv8x' else
                  measure(args.measure, args.requests, args.train_steps))
        print(json.dumps(result), flush=True)
        return 0
    if len(args.roots) != 2:
        ap.error('give two roots, A and B')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip()
    turns = []
    for letter in args.order:
        root = args.roots['AB'.index(letter)]
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), '--measure', root,
             '--backbone', args.backbone, '--requests', str(args.requests),
             '--train-steps', str(args.train_steps)], capture_output=True,
            text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise SystemExit(f'ab: the turn on {root} failed')
        turns.append({'turn': letter, **json.loads(
            proc.stdout.strip().splitlines()[-1])})
        print(json.dumps(turns[-1]), flush=True)
    summary = {'card': card, 'backbone': args.backbone, 'order': args.order,
               'roots': args.roots}
    for key in KEYS[args.backbone]:
        summary[key] = {letter: [t[key] for t in turns if t['turn'] == letter]
                        for letter in 'AB'}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump({'summary': summary, 'turns': turns}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
