"""A/B of two checkouts of the port, in turns on one card.

    python3 streamingflow_tpu_torch/tools/ab.py ROOT_A ROOT_B \
        [--backbone pillar8x|spconv8x|spconv8x_fp32|spconv8x_fp32_tail0] \
        [--order ABBA] [--requests 10] [--train-steps 3] [--out FILE]

Each ROOT is a directory holding a ``streamingflow_tpu_torch`` package (this
checkout, or an older one unpacked with ``git archive``).  For each letter
of ``--order`` a fresh process imports the package of that root and
measures, at flagship shapes (``data.flagship_config(backbone=...)``, seed
0).  On ``pillar8x`` (the default):

  - K1 on one 80k-point cloud (pillar epilogue, bf16 out, presorted): the
    wrapper ``bin_sum`` and the kernel alone on prepared inputs (tile bounds
    or offsets and the output made beforehand), CUDA events over 20 calls;
  - K2, the camera pool, through its wrapper ``patch_pool_frames`` at the
    flagship frame stack (``chip_smoke.flagship_pool_inputs`` of the
    checkout holding this tool), on bf16 rows and on fp32 rows (the
    training step's), CUDA events over 20 calls;
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
  - K3's backward on the same inputs, for a cotangent from seed 7 that is
    zero at the inactive sites (as the training step's): d weights
    (``subm_conv_wgrad`` over the full found) at all three shapes and d
    feats (``subm_conv_dgrad`` over the reversed map) at stages 1 and 2,
    CUDA events over 20 calls;
  - the same in fp32 (``fp32_cases()`` of ``k3_inputs``: conv_input on the
    clouds' fp32 voxel features, stages 1 and 2 on fp32 path-like rows), d
    feats at all three shapes (``k3_fp32_*``, ``k3_dgrad_fp32_*``,
    ``k3_wgrad_fp32_*``);
  - the bf16 forecast, as above, with its K3 launches per request.

On ``spconv8x_fp32`` (the fp32 path: fp32 points, COMPUTE_DTYPE 'auto'):

  - ``evaluate.main`` on the imported reference checkpoint over a
    flagship-size tree, as ``chip_smoke.py``'s ``reference_import`` runs it
    (``chip_smoke.imported_checkpoint`` on ``mini_nuscenes.flagship_tree``,
    both written once by the driving process, on the CPU): twice, the
    second run read: the median host-clock time of ``eval_forward`` (one
    forecast, synchronized) and K3's time a forecast through its wrapper
    (CUDA events around each launch) with its launches by route;
  - the flagship spconv8x training step with COMPUTE_DTYPE 'auto' (as the
    train CLI runs the shipped yml): median of ``--train-steps`` steps
    after one warm-up, peak memory, and K3's forward, d feats and d weights
    time and launches a step (CUDA events around each launch).

On ``spconv8x_fp32_tail0`` (the fp32 path at DENSE_TAIL_FROM_STAGE 0,
where stages 3 and 4 run on the wide K3 kernels):

  - the wide K3 rows through their wrappers at stage 3 (64 -> 64, nz 11)
    and stage 4 (128 -> 128, nz 5) of one request's 5 clouds
    (``chip_smoke.k3_wide_inputs``), in fp32 and in bf16: the forward, d
    feats and d weights for a cotangent from seed 7 zero at the inactive
    sites, CUDA events over 5 calls (``k3_wide_[dgrad_|wgrad_][fp32_]
    stage{3,4}_ms``);
  - ``evaluate`` and the training step as ``spconv8x_fp32`` runs them,
    both at DENSE_TAIL_FROM_STAGE 0.

Run as a script, not as a module, so that each process imports the package
under test and nothing else.  Prints one JSON line per turn and a summary
line with the card's name and power limit; needs a CUDA card.
"""
import argparse
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# the repository root of this tool's checkout (its chip_smoke.py)
_HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STAGES = ('conv_input', 'stage1', 'stage2')
KEYS = {'pillar8x': ('k1_wrapper_ms', 'k1_kernel_ms', 'k2_bf16_ms',
                     'k2_fp32_ms', 'pillar_features_ms', 'median_latency_s',
                     'median_step_s'),
        'spconv8x': ('k3_conv_input_ms', 'k3_stage1_ms', 'k3_stage2_ms',
                     'k3_forecast_ms_est', 'k3_wgrad_conv_input_ms',
                     'k3_wgrad_stage1_ms', 'k3_wgrad_stage2_ms',
                     'k3_dgrad_stage1_ms', 'k3_dgrad_stage2_ms',
                     *(f'k3_{kind}fp32_{name}_ms'
                       for kind in ('', 'dgrad_', 'wgrad_')
                       for name in STAGES),
                     'k3_fp32_forecast_ms_est', 'median_latency_s'),
        'spconv8x_fp32': ('eval_median_forecast_s', 'eval_k3_ms_per_forecast',
                          'median_step_s', 'peak_gib',
                          'step_k3_forward_ms', 'step_k3_dgrad_ms',
                          'step_k3_wgrad_ms')}
KEYS['spconv8x_fp32_tail0'] = (
    *(f'k3_wide_{kind}{leg}stage{s}_ms' for leg in ('fp32_', '')
      for kind in ('', 'dgrad_', 'wgrad_') for s in (3, 4)),
    *KEYS['spconv8x_fp32'])


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


def _pin_tf32():
    """This checkout's device.pin_tf32 (an older package under test may not
    have it): TF32 off for matmuls and cuDNN convolutions in both turns."""
    spec = importlib.util.spec_from_file_location(
        'ab_device', os.path.join(_HERE, 'streamingflow_tpu_torch',
                                  'device.py'))
    device = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(device)
    return device.pin_tf32()


def _smoke():
    """This checkout's chip_smoke.py, for the inputs it makes."""
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(_HERE, 'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


class K3Clock:
    """CUDA events around each K3 launch of the package ``WF``
    (ops/winfuse.py) through its wrapper: the forward, d feats (the
    forward's kernels under ``subm_conv_dgrad``) and d weights, with
    their launches by the rows' type.  Read with :meth:`take`; :meth:`close`
    puts the wrapper's functions back."""

    def __init__(self, WF):
        import torch
        self.torch = torch
        self.kind = 'forward'
        self.reset()
        fwd, dgrad, wgrad = WF._winfuse_cuda, WF.subm_conv_dgrad, \
            WF._wgrad_cuda
        self._wrapped = (WF, fwd, dgrad, wgrad)

        def timed(fn, kind=None):
            def run(*a, **kw):
                k = kind or self.kind
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **kw)
                e1.record()
                self.events[k].append((e0, e1))
                dt = str(a[0].dtype).split('.')[-1]
                self.launches[k][dt] = self.launches[k].get(dt, 0) + 1
                return out
            return run

        def in_dgrad(*a, **kw):
            self.kind = 'dgrad'
            try:
                return dgrad(*a, **kw)
            finally:
                self.kind = 'forward'
        WF._winfuse_cuda = timed(fwd)
        WF.subm_conv_dgrad = in_dgrad
        WF._wgrad_cuda = timed(wgrad, 'wgrad')

    def close(self):
        WF, fwd, dgrad, wgrad = self._wrapped
        WF._winfuse_cuda, WF.subm_conv_dgrad, WF._wgrad_cuda = \
            fwd, dgrad, wgrad

    def reset(self):
        self.events = {k: [] for k in ('forward', 'dgrad', 'wgrad')}
        self.launches = {k: {} for k in self.events}

    def take(self):
        """({kind: ms}, {kind: {dtype: launches}}) since the last take."""
        self.torch.cuda.synchronize()
        ms = {k: sum(a.elapsed_time(b) for a, b in v)
              for k, v in self.events.items()}
        launches = self.launches
        self.reset()
        return ms, launches


def evaluate_main(E, checkpoint, dev, tail=None, forward=None):
    """``E.main`` (the package's evaluate module) on ``checkpoint``, as the
    CLI runs it, at DENSE_TAIL_FROM_STAGE ``tail`` where given, each
    forecast through ``forward(eval_forward, *args, **kwargs)`` where
    given: (results, the printed text)."""
    import contextlib
    import io
    build, eval_forward = E.build_eval_state, E.eval_forward

    def set_tail(cfg):
        cfg.MODEL.SPARSE_ENCODER.DENSE_TAIL_FROM_STAGE = tail

    def build_at_tail(args, cfg_mutator=None):
        return build(args, cfg_mutator=cfg_mutator if tail is None
                     else set_tail)
    E.build_eval_state = build_at_tail
    if forward is not None:
        E.eval_forward = lambda *a, **kw: forward(eval_forward, *a, **kw)
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            results = E.main(['--checkpoint', checkpoint, '--device',
                              str(dev)])
    finally:
        E.build_eval_state, E.eval_forward = build, eval_forward
    return results, text.getvalue()


def _wide_rows(WF, dev):
    """The wide K3 rows at stages 3 and 4, fp32 and bf16, as the docstring
    says: {key: ms}."""
    import torch
    smoke = _smoke()
    _, x = smoke.k3_inputs(dev)
    result = {}
    for key, (f, geo, w, nz, zm) in smoke.k3_wide_inputs(dev, x).items():
        name, fp32 = key.split('_')[0], key.endswith('_fp32')
        leg = 'fp32_' if fp32 else ''
        rows, cout = geo.nbr.shape[1], w.shape[2]
        gen = torch.Generator(device=dev).manual_seed(7)
        g = (torch.randn(rows, nz, cout, device=dev, generator=gen) *
             zm.reshape(rows, nz, 1)).reshape(rows, -1).to(f.dtype)
        result[f'k3_wide_{leg}{name}_ms'] = _event_ms(
            lambda: WF.subm_conv_winfuse(f, geo.nbr, geo.found, w, nz),
            reps=5)
        result[f'k3_wide_dgrad_{leg}{name}_ms'] = _event_ms(
            lambda: WF.subm_conv_dgrad(g, geo.src_t, w, nz), reps=5)
        result[f'k3_wide_wgrad_{leg}{name}_ms'] = _event_ms(
            lambda: WF.subm_conv_wgrad(f, geo.nbr, geo.grad_found, g, nz),
            reps=5)
    return result


def measure_spconv_fp32(root, tree, ckpt, n_steps, tail=None):
    """One turn of the fp32 path: the package under ``root``, evaluate on
    the imported checkpoint ``ckpt`` over ``tree``, then the fp32 flagship
    step, as the docstring says; at DENSE_TAIL_FROM_STAGE ``tail`` where
    given, and then first the wide K3 rows."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch import evaluate as E
    from streamingflow_tpu_torch.data import flagship_config, make_batch
    from streamingflow_tpu_torch.data import dataloader
    from streamingflow_tpu_torch.ops import winfuse as WF
    _pin_tf32()
    dev = torch.device('cuda', 0)
    result = {'root': root, 'package': os.path.dirname(P.__file__)}
    if tail is not None:
        result.update(_wide_rows(WF, dev))
    clock = K3Clock(WF)
    times, k3 = [], []

    def timed_forward(forward, *a, **kw):
        clock.take()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = forward(*a, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        k3.append(clock.take())
        return out
    for _ in range(2):
        times.clear()
        k3.clear()
        evaluate_main(E, ckpt, dev, tail, timed_forward)
    if hasattr(dataloader, 'stop_worker_server'):
        dataloader.stop_worker_server()
    result.update(
        eval_forecast_s=list(times),
        eval_median_forecast_s=statistics.median(times),
        eval_k3_ms_per_forecast=statistics.median(
            sum(ms.values()) for ms, _ in k3),
        eval_k3_launches_per_forecast=k3[-1][1])

    cfg = flagship_config(backbone='spconv8x')
    cfg.MODEL.SPARSE_ENCODER.COMPUTE_DTYPE = 'auto'
    if tail is not None:
        cfg.MODEL.SPARSE_ENCODER.DENSE_TAIL_FROM_STAGE = tail
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
    torch.cuda.reset_peak_memory_stats()
    clock.take()
    steps, per_step = [], []
    for s in range(1, n_steps + 1):
        steps.append(step(s))
        per_step.append(clock.take())
    result.update(
        step_s=steps, median_step_s=statistics.median(steps),
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        step_k3_launches=per_step[-1][1],
        **{f'step_k3_{kind}_ms': statistics.median(ms[kind]
                                                   for ms, _ in per_step)
           for kind in ('forward', 'dgrad', 'wgrad')})
    return result


def measure_spconv(root, n_requests):
    """One spconv8x turn: the package under ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch.data import flagship_config
    from streamingflow_tpu_torch.ops import winfuse as WF
    _pin_tf32()
    dev = torch.device('cuda', 0)
    smoke = _smoke()
    result = {'root': root, 'package': os.path.dirname(P.__file__)}
    cases, x = smoke.k3_inputs(dev)
    for name, (feats, geo, w, nz, zmask) in cases.items():
        result[f'k3_{name}_ms'] = _event_ms(
            lambda: WF.subm_conv_winfuse(feats, geo.nbr, geo.found, w, nz))
        gen = torch.Generator(device=dev).manual_seed(7)
        rows, cout = geo.nbr.shape[1], w.shape[2]
        g = (torch.randn(rows, nz, cout, device=dev, generator=gen) *
             zmask.reshape(rows, nz, 1)).to(feats.dtype).reshape(rows, -1)
        result[f'k3_wgrad_{name}_ms'] = _event_ms(
            lambda: WF.subm_conv_wgrad(feats, geo.nbr, geo.grad_found, g,
                                       nz))
        if name != 'conv_input':
            result[f'k3_dgrad_{name}_ms'] = _event_ms(
                lambda: WF.subm_conv_dgrad(g, geo.src_t, w, nz))
    result['k3_forecast_ms_est'] = result['k3_conv_input_ms'] + 4 * (
        result['k3_stage1_ms'] + result['k3_stage2_ms'])
    del cases, feats, geo, w, zmask, g
    for name, (feats, geo, w, nz, zmask) in x.fp32_cases().items():
        result[f'k3_fp32_{name}_ms'] = _event_ms(
            lambda: WF.subm_conv_winfuse(feats, geo.nbr, geo.found, w, nz))
        gen = torch.Generator(device=dev).manual_seed(7)
        rows, cout = geo.nbr.shape[1], w.shape[2]
        g = (torch.randn(rows, nz, cout, device=dev, generator=gen) *
             zmask.reshape(rows, nz, 1)).reshape(rows, -1)
        result[f'k3_wgrad_fp32_{name}_ms'] = _event_ms(
            lambda: WF.subm_conv_wgrad(feats, geo.nbr, geo.grad_found, g,
                                       nz))
        result[f'k3_dgrad_fp32_{name}_ms'] = _event_ms(
            lambda: WF.subm_conv_dgrad(g, geo.src_t, w, nz))
    result['k3_fp32_forecast_ms_est'] = result['k3_fp32_conv_input_ms'] + \
        4 * (result['k3_fp32_stage1_ms'] + result['k3_fp32_stage2_ms'])
    del feats, geo, w, zmask, g
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
    from streamingflow_tpu_torch.ops import patch_pool as PP
    _pin_tf32()
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

    gen = torch.Generator(device=dev).manual_seed(0)
    x, coords, kept, bev_x, bev_y = _smoke().flagship_pool_inputs(cfg, dev,
                                                                  gen)
    for key, rows in (('k2_bf16_ms', x), ('k2_fp32_ms', x.float())):
        result[key] = _event_ms(
            lambda: PP.patch_pool_frames(rows, coords, kept, bev_x, bev_y))
    del x, rows

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
    ap.add_argument('--tree', default=None, help=argparse.SUPPRESS)
    ap.add_argument('--checkpoint', default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure is not None:
        if args.backbone.startswith('spconv8x_fp32'):
            result = measure_spconv_fp32(
                args.measure, args.tree, args.checkpoint, args.train_steps,
                0 if args.backbone.endswith('tail0') else None)
        elif args.backbone == 'spconv8x':
            result = measure_spconv(args.measure, args.requests)
        else:
            result = measure(args.measure, args.requests, args.train_steps)
        print(json.dumps(result), flush=True)
        return 0
    if len(args.roots) != 2:
        ap.error('give two roots, A and B')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip()
    extra, tmp = [], None
    if args.backbone.startswith('spconv8x_fp32'):
        # the tree and the imported checkpoint, once, on the CPU
        tmp = tempfile.mkdtemp(prefix='ab_fp32_')
        tree = os.path.join(tmp, 'nuscenes')
        sys.path.insert(0, _HERE)
        from streamingflow_tpu_torch.data import mini_nuscenes, raster
        mini_nuscenes.flagship_tree(
            tree, 'jpg' if raster.image_decoder() == 'PIL' else 'ppm')
        ckpt = _smoke().imported_checkpoint(tree, tmp)[2]
        extra = ['--tree', tree, '--checkpoint', ckpt]
    turns = []
    for letter in args.order:
        root = args.roots['AB'.index(letter)]
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), '--measure', root,
             '--backbone', args.backbone, '--requests', str(args.requests),
             '--train-steps', str(args.train_steps), *extra],
            capture_output=True, text=True)
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
    if tmp is not None:
        shutil.rmtree(tmp, ignore_errors=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump({'summary': summary, 'turns': turns}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
