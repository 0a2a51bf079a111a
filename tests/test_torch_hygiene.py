"""The PyTorch port stands alone: no file of streamingflow_tpu_torch/ nor
chip_smoke.py imports JAX, flax, orbax, OpenCV, matplotlib (absent on the
card's machine) or the JAX package, no file
of the port the repo's tools/ or tests/, chip_smoke.py of tests/ only the
numpy-only torch_reference_names.py, and PIL only inside the functions that
use it where it is installed; importing the port needs neither JAX nor
PyYAML; and its entry points and CLIs do not fall back to the CPU when CUDA
is absent."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'cv2', 'matplotlib',
             'streamingflow_tpu')


def _port_files():
    files = sorted((ROOT / 'streamingflow_tpu_torch').rglob('*.py'))
    return files + [ROOT / 'chip_smoke.py']


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ''


def test_no_port_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    names = {p.name for p in files}
    assert {'trainer.py', 'losses.py', 'trainmode.py',
            'exp_bin_variants.py', 'train.py', 'evaluate.py',
            'evaluate_streaming.py', 'evaluate_datastream.py',
            'checkpoint.py', 'logging.py', 'metrics.py', 'instance.py',
            'visualisation.py', 'nuscenes.py', 'nuscenes_sdk.py',
            'labels.py', 'lyft.py', 'sampler.py', 'dataloader.py',
            'raster.py', 'mini_nuscenes.py', 'mesh.py', 'collect.py',
            'launch.py', 'dryrun_multichip.py', 'torch_convert.py',
            'convert_checkpoint.py', 'rules_prediction_lc_ode_variable.py',
            'distributions.py', 'device.py', 'cost.py', 'planning.py',
            'srvp_vgg.py', 'tools.py', 'network.py', 'sparse.py',
            'sparse_tiled.py'} <= names
    bad = [(str(p.relative_to(ROOT)), name) for p in files
           for name in _imports(p)
           if name.split('.')[0] in FORBIDDEN]
    assert not bad, bad


def test_port_imports_neither_the_repos_tools_nor_its_tests():
    """The repo's tools/ and tests/ are no packages of the port: no port
    file imports one of their modules (its own streamingflow_tpu_torch.tools
    is relative or fully named); chip_smoke.py takes from tests/ only the
    reference-name inverse, which imports numpy and re alone."""
    repo_modules = {p.stem for d in ('tools', 'tests')
                    for p in (ROOT / d).glob('*.py')} | {'tools', 'tests'}
    files = sorted((ROOT / 'streamingflow_tpu_torch').rglob('*.py'))
    bad = [(str(p.relative_to(ROOT)), name) for p in files
           for name in _imports(p) if name.split('.')[0] in repo_modules]
    assert not bad, bad
    smoke = {n.split('.')[0] for n in _imports(ROOT / 'chip_smoke.py')}
    assert smoke & repo_modules == {'torch_reference_names'}
    inverse = {n.split('.')[0]
               for n in _imports(ROOT / 'tests' / 'torch_reference_names.py')}
    assert inverse <= {'re', 'numpy'}, inverse


def test_pil_is_imported_only_inside_functions():
    """PIL is optional on a card machine: no port file imports it at
    module level, so the port imports without it."""
    for path in _port_files():
        tree = ast.parse(path.read_text(), str(path))
        for node in tree.body:
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ''] if isinstance(node, ast.ImportFrom)
                     else [])
            assert not any(n.split('.')[0] == 'PIL' for n in names), path


def test_import_needs_neither_jax_nor_yaml():
    code = ('import sys, streamingflow_tpu_torch, '
            'streamingflow_tpu_torch.models, streamingflow_tpu_torch.data, '
            'streamingflow_tpu_torch.convert, '
            'streamingflow_tpu_torch.layers.trainmode, '
            'streamingflow_tpu_torch.training.losses, '
            'streamingflow_tpu_torch.training.trainer, '
            'streamingflow_tpu_torch.tools.exp_bin_variants, '
            'streamingflow_tpu_torch.train, streamingflow_tpu_torch.evaluate, '
            'streamingflow_tpu_torch.evaluate_streaming, '
            'streamingflow_tpu_torch.evaluate_datastream, '
            'streamingflow_tpu_torch.native, '
            'streamingflow_tpu_torch.data.nuscenes, '
            'streamingflow_tpu_torch.data.lyft, '
            'streamingflow_tpu_torch.data.dataloader, '
            'streamingflow_tpu_torch.data.mini_nuscenes, '
            'streamingflow_tpu_torch.training.checkpoint, '
            'streamingflow_tpu_torch.training.metrics, '
            'streamingflow_tpu_torch.training.logging, '
            'streamingflow_tpu_torch.utils.visualisation, '
            'streamingflow_tpu_torch.parallel, '
            'streamingflow_tpu_torch.parallel.launch, '
            'streamingflow_tpu_torch.tools.dryrun_multichip, '
            'streamingflow_tpu_torch.tools.convert_checkpoint, '
            'streamingflow_tpu_torch.utils.torch_convert, '
            'streamingflow_tpu_torch.models.distributions, '
            'streamingflow_tpu_torch.models.planning, '
            'streamingflow_tpu_torch.ops.cost, '
            'streamingflow_tpu_torch.layers.srvp_vgg, '
            'streamingflow_tpu_torch.utils.tools, '
            'streamingflow_tpu_torch.utils.network, '
            'streamingflow_tpu_torch.ops.sparse, '
            'streamingflow_tpu_torch.ops.sparse_tiled; '
            'print(sorted(m for m in ("jax", "flax", "orbax", "cv2", "PIL", '
            '"yaml", "matplotlib", "streamingflow_tpu") '
            'if m in sys.modules))')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, 'PYTHONPATH': str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'


def test_entry_points_raise_without_cuda(monkeypatch):
    """With CUDA absent and no device given, the entry points raise instead
    of running on the CPU; device='cpu' is the explicit way there."""
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch.data import make_batch, tiny_config
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = tiny_config()
    with pytest.raises(RuntimeError, match='CUDA'):
        P.build_model(cfg)
    with pytest.raises(RuntimeError, match='CUDA'):
        P.batch_to_model_args(make_batch(cfg, 1, n_points=16), cfg)
    with pytest.raises(RuntimeError, match='CUDA'):
        P.build_trainer(cfg)
    from streamingflow_tpu_torch.parallel import make_mesh
    with pytest.raises(RuntimeError, match='CUDA'):
        make_mesh(2)
    from streamingflow_tpu_torch.tools import dryrun_multichip
    with pytest.raises(RuntimeError, match='CUDA'):
        dryrun_multichip.main(['2'])
    from streamingflow_tpu_torch.tools import exp_bin_variants
    with pytest.raises(RuntimeError, match='CUDA'):
        exp_bin_variants.run((4,), n_clouds=1, n_points=16)
    assert next(P.build_model(cfg, device='cpu').parameters()).device.type \
        == 'cpu'
    assert P.build_trainer(cfg, device='cpu').device.type == 'cpu'


@pytest.mark.parametrize('engine', ['gather', 'tiled', 'sparse'])
def test_build_model_takes_the_documented_sparse_engines(engine):
    """build_model builds spconv8x on every documented SPARSE_ENCODER.ENGINE
    and refuses any other by name (the JAX encoder would run 'gather')."""
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch.data import tiny_config
    cfg = tiny_config()
    cfg.MODEL.MODALITY.USE_LIDAR = True
    cfg.MODEL.LIDAR.BACKBONE = 'spconv8x'
    cfg.MODEL.SPARSE_ENCODER.ENGINE = engine
    if engine == 'sparse':
        with pytest.raises(ValueError, match='ENGINE'):
            P.build_model(cfg, device='cpu')
        return
    model = P.build_model(cfg, device='cpu')
    assert model.lidar_encoder.cfg.ENGINE == engine
    assert not model.lidar_encoder.remat_ladder


def test_chip_smoke_needs_the_card(tmp_path):
    """chip_smoke.py prints no result and exits non-zero without CUDA, and
    in a directory that holds only the script."""
    alone = tmp_path / 'chip_smoke.py'
    alone.write_text((ROOT / 'chip_smoke.py').read_text())
    for script in (ROOT / 'chip_smoke.py', alone):
        out = subprocess.run([sys.executable, str(script)],
                             cwd=script.parent, capture_output=True,
                             text=True, timeout=120,
                             env={**os.environ, 'CUDA_VISIBLE_DEVICES': ''})
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


@pytest.mark.parametrize('cli', ['train', 'evaluate', 'evaluate_streaming',
                                 'evaluate_datastream'])
def test_cli_without_device_exits_naming_cuda(cli):
    """``python -m streamingflow_tpu_torch.<cli>`` with no --device on a
    machine without CUDA exits non-zero, naming CUDA, before any work."""
    args = (['--config-file', str(ROOT / 'configs' /
                                  'prediction_lc_ode_variable.yml')]
            if cli == 'train' else ['--checkpoint', 'no_such_dir'])
    out = subprocess.run([sys.executable, '-m', f'streamingflow_tpu_torch.{cli}',
                          *args], cwd=ROOT, capture_output=True, text=True,
                         timeout=120,
                         env={**os.environ, 'PYTHONPATH': str(ROOT),
                              'CUDA_VISIBLE_DEVICES': ''})
    assert out.returncode != 0
    assert 'CUDA' in out.stderr.splitlines()[-1], out.stderr[-2000:]
    assert not os.path.exists(ROOT / 'no_such_dir')
