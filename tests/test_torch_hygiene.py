"""The PyTorch port stands alone: no file of streamingflow_tpu_torch/ nor
chip_smoke.py imports JAX, flax or the JAX package; importing the port needs
neither JAX nor PyYAML; and its entry points do not fall back to the CPU
when CUDA is absent."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'streamingflow_tpu')


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
    bad = [(str(p.relative_to(ROOT)), name) for p in files
           for name in _imports(p)
           if name.split('.')[0] in FORBIDDEN]
    assert not bad, bad


def test_import_needs_neither_jax_nor_yaml():
    code = ('import sys, streamingflow_tpu_torch, '
            'streamingflow_tpu_torch.models, streamingflow_tpu_torch.data, '
            'streamingflow_tpu_torch.convert; '
            'print(sorted(m for m in ("jax", "flax", "yaml", '
            '"streamingflow_tpu") if m in sys.modules))')
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
    assert next(P.build_model(cfg, device='cpu').parameters()).device.type \
        == 'cpu'


def test_unported_backbone_names_the_roadmap():
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch.data import tiny_config
    cfg = tiny_config()
    cfg.MODEL.MODALITY.USE_LIDAR = True
    cfg.MODEL.LIDAR.BACKBONE = 'spconv8x'
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        P.build_model(cfg, device='cpu')


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
