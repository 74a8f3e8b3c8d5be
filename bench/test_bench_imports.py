"""Nothing under bench/ imports JAX, the JAX package (``repro``) or its
benchmarks (top-level names compared whole: ``repro_torch`` is not
``repro``), and the references import nothing of the program."""
import ast
import pathlib
import subprocess
import sys

import pytest

from bench import harness

BENCH = pathlib.Path(__file__).resolve().parent
FILES = sorted(p for p in BENCH.rglob('*.py'))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, 'attr', '') == 'import_module'
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize('path', FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    tops = {m.split('.')[0] for m in _imports(path)}
    assert not tops & set(harness.FORBIDDEN), (path, tops)


# what a reference may import of the benchmark: the seed's weights and
# frames and the yardstick, which import nothing of the program either
BENCH_OK = {'bench', 'bench.weights', 'bench.yardstick', 'bench.gen'}


@pytest.mark.parametrize('path', sorted((BENCH / 'reference').glob('*.py')),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    mods = set(_imports(path))
    tops = {m.split('.')[0] for m in mods}
    assert tops <= {'__future__', 'math', 'typing', 'numpy', 'torch',
                    'bench'}, tops
    assert {m for m in mods if m.split('.')[0] == 'bench'} <= BENCH_OK
    for m in BENCH_OK - {'bench'}:
        src = BENCH / (m.split('.')[1] + '.py')
        assert {n.split('.')[0] for n in _imports(src)} <= {
            '__future__', 'math', 'typing', 'numpy', 'torch', 'json',
            'pathlib', 'statistics'}, src


@pytest.mark.parametrize('name', sorted(
    p.stem for p in (BENCH / 'reference').glob('*.py')
    if p.stem not in ('__init__',)))
def test_reference_loads_nothing_of_the_program(name):
    code = ('import sys; sys.path[:0] = ["src", "."]; '
            f'import bench.reference.{name}; '
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
            '("repro_torch", "repro", "jax", "benchmarks")); '
            'print(bad); sys.exit(1 if bad else 0)')
    proc = subprocess.run([sys.executable, '-c', code], cwd=BENCH.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_forbidden_names_compared_whole(monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, 'repro_torch_fake', types.ModuleType('x'))
    assert 'repro_torch_fake' not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'repro.fake', types.ModuleType('x'))
    assert 'repro.fake' in harness.forbidden_modules()
