"""Import guard of the port: ``src/repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the JAX package ``repro``, and importing the serving
and training paths leaves ``jax`` out of ``sys.modules``."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / 'src' / 'repro_torch').rglob('*.py')) + [
    ROOT / 'chip_smoke.py']
BANNED = ('jax', 'jaxlib', 'repro')


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


@pytest.mark.parametrize('path', FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_or_reference(path):
    bad = sorted({m for m in _imported_roots(path) if m in BANNED})
    assert not bad, f'{path.relative_to(ROOT)} imports {bad}'


def test_serving_path_import_leaves_jax_unloaded():
    code = ('import sys\n'
            'import repro_torch.launch.serve, repro_torch.convert\n'
            'import repro_torch.kernels.lstm_seq, repro_torch.kernels._build\n'
            'import repro_torch.core.quant, repro_torch.core.systolic\n'
            'import repro_torch.launch.train, repro_torch.kernels.lstm_gates\n'
            'import repro_torch.core.ctc, repro_torch.optim, repro_torch.tree\n'
            'import repro_torch.data, repro_torch.checkpoint\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "repro")]\n'
            'print(bad)\n'
            'assert not bad, bad\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT / 'src'))
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
