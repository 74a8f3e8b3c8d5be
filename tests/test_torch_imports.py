"""Import guard of the port: ``src/repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the JAX package ``repro``, and importing the serving
and training paths, every kernel package, the tuner and the examples
leaves ``jax`` out of ``sys.modules``."""
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
            'import repro_torch.core.pipeline, repro_torch.launch.mesh\n'
            'import repro_torch.launch.train, repro_torch.kernels.lstm_gates\n'
            'import repro_torch.core.ctc, repro_torch.optim, repro_torch.tree\n'
            'import repro_torch.data, repro_torch.checkpoint\n'
            'import repro_torch.kernels.quant_matmul\n'
            'import repro_torch.kernels.flash_attention\n'
            'import repro_torch.tune, repro_torch.tune.__main__\n'
            'import repro_torch.examples.speech_ctc\n'
            'import repro_torch.examples.quickstart\n'
            'import repro_torch.examples.train_lm\n'
            'import repro_torch.kernels.flash_attention.backward\n'
            'import repro_torch.configs.mixtral_8x22b\n'
            'import repro_torch.configs.kimi_k2_1t_a32b\n'
            'import repro_torch.configs.whisper_base\n'
            'import repro_torch.configs.llama32_vision_90b\n'
            'import repro_torch.configs.xlstm_1_3b\n'
            'import repro_torch.configs.hymba_1_5b\n'
            'import repro_torch.models.recurrent\n'
            'import repro_torch.models.layers, repro_torch.models.registry\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "repro")]\n'
            'print(bad)\n'
            'assert not bad, bad\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT / 'src'))
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_die_mesh_and_staged_tuner_import_without_jax_and_default_to_cuda():
    """``DieMesh`` and its presets, the staged and geometry shmoo spaces and
    the staged tuners import without ``jax``; a die preset without
    ``devices`` puts every engine on ``cuda``, and the entry points'
    devices default to ``cuda``."""
    code = ('import sys, inspect\n'
            'from repro_torch.launch.mesh import (DieMesh, DIE_TOPOLOGIES,\n'
            '    make_die_topology, install_die_topology)\n'
            'from repro_torch.tune import (tune_staged_stack, tune_geometry,\n'
            '    enumerate_staged_candidates, enumerate_geometry_candidates)\n'
            'from repro_torch.tune.__main__ import main\n'
            'from repro_torch.launch.serve import build_parser\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "repro")]\n'
            'assert not bad, bad\n'
            'dm = make_die_topology("graves-3x25")\n'
            'assert {d.type for d in dm.devices} == {"cuda"}, dm.devices\n'
            'assert dm.n_engines == 75 and dm.submesh([0, 2]).stage == 2\n'
            'assert build_parser().parse_args([]).device == "cuda"\n'
            'src = inspect.getsource(main)\n'
            'assert "default=\'cuda\'" in src\n'
            'print("ok")\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT / 'src'))
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_lm_training_path_imports_without_jax_and_defaults_to_cuda():
    """The LM training slice (K8's backward and ``attention_train``, the
    optimizers, the LM data sources, ``lm_train_state_from_numpy``, the
    train CLI and ``examples.train_lm``) imports without ``jax``; both
    entry points run on ``cuda`` unless asked."""
    code = ('import sys, inspect\n'
            'from repro_torch.kernels.flash_attention import (\n'
            '    attention_train, flash_attention_bwd, attention_bwd_ref)\n'
            'from repro_torch.optim import (adafactor, sgd, wsd_schedule,\n'
            '    AdafactorState, SGDState, clip_by_global_norm_)\n'
            'from repro_torch.data import SyntheticLM, TokenFile\n'
            'from repro_torch.convert import lm_train_state_from_numpy\n'
            'from repro_torch.launch import train\n'
            'from repro_torch.examples import train_lm\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "repro")]\n'
            'assert not bad, bad\n'
            'for fn in (train.main, train_lm.main):\n'
            '    assert "\'--device\', default=\'cuda\'" in '
            'inspect.getsource(fn), fn\n'
            'print("ok")\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT / 'src'))
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_dense_lm_path_imports_without_jax_and_defaults_to_cuda():
    """The LM slices (every config module, ``models.layers`` with its
    cross attention, ``models.transformer`` with ``precompute_cross_kv``,
    ``models.registry``, the token path of ``launch.serve`` with its R4
    refusal, ``examples.serve_lm`` and the cross K/V's converter) import
    without ``jax``;
    its entry points put weights and caches on ``cuda`` unless asked."""
    code = ('import sys, inspect\n'
            'from repro_torch import configs\n'
            'for name in configs.ARCH_MODULES:\n'
            '    configs.get_config(name), configs.get_smoke_config(name)\n'
            'from repro_torch.models import layers, transformer, registry\n'
            'from repro_torch.launch.serve import (Request, SlotServer,\n'
            '    _run_token_serving, build_parser)\n'
            'from repro_torch.examples import serve_lm\n'
            'from repro_torch.convert import (lm_params_from_numpy,\n'
            '    lm_cross_kv_from_numpy)\n'
            'from repro_torch.models.transformer import (\n'
            '    precompute_cross_kv, n_self_layers)\n'
            'from repro_torch.models.layers import cross_attention_decode\n'
            'from repro_torch.launch.serve import refuse_cross\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "repro")]\n'
            'assert not bad, bad\n'
            'args = build_parser().parse_args(["--arch", "qwen3-14b"])\n'
            'assert args.device == "cuda" and not args.smoke\n'
            'for fn in (transformer.init_lm, transformer.init_cache,\n'
            '           lm_params_from_numpy, lm_cross_kv_from_numpy):\n'
            '    dev = inspect.signature(fn).parameters["device"].default\n'
            '    assert dev == "cuda", (fn, dev)\n'
            'assert "default=\'cuda\'" in inspect.getsource(serve_lm.main)\n'
            'print("ok")\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT / 'src'))
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_recurrent_path_imports_without_jax_and_defaults_to_cuda():
    """The recurrent slice (``models.recurrent``'s xLSTM and Hymba, their
    configs and bundles, the state and cache converters) imports without
    ``jax``; its inits, states, caches and converters default to ``cuda``,
    and ``serve --arch xlstm-1.3b`` / ``hymba-1.5b`` to the full config on
    the card."""
    code = ('import sys, inspect\n'
            'from repro_torch import configs\n'
            'from repro_torch.configs import xlstm_1_3b, hymba_1_5b\n'
            'from repro_torch.models import recurrent, get_bundle\n'
            'from repro_torch.models.recurrent import (init_xlstm,\n'
            '    forward_xlstm, init_xlstm_state, init_hymba, forward_hymba,\n'
            '    init_hymba_cache, hymba_decode_step, mlstm_chunkwise,\n'
            '    slstm_scan, mamba_mix, hymba_block)\n'
            'from repro_torch.convert import (xlstm_state_from_numpy,\n'
            '    hymba_cache_from_numpy)\n'
            'from repro_torch.launch.serve import build_parser\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "repro")]\n'
            'assert not bad, bad\n'
            'for name in ("xlstm-1.3b", "hymba-1.5b"):\n'
            '    args = build_parser().parse_args(["--arch", name])\n'
            '    assert args.device == "cuda" and not args.smoke\n'
            '    get_bundle(configs.get_config(name))\n'
            'for fn in (init_xlstm, init_xlstm_state, init_hymba,\n'
            '           init_hymba_cache, xlstm_state_from_numpy,\n'
            '           hymba_cache_from_numpy):\n'
            '    dev = inspect.signature(fn).parameters["device"].default\n'
            '    assert dev == "cuda", (fn, dev)\n'
            'print("ok")\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT / 'src'))
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
