"""The port's sharding rules (``repro_torch.sharding``) against the
reference's (``repro.sharding``).

Every parameter and cache leaf of all eleven configurations at full width,
under the train, serve and big-serve rules specialised by
``rules_for_arch``, on the single- and the multi-pod production mesh: the
port's ``ShardingRules.spec`` is the reference's ``PartitionSpec`` entry
for entry.  Shapes come without allocation on both sides: the reference's
``abstract_init`` (``jax.eval_shape``), the port's init under
``FakeTensorMode``.  Both ``spec``s read a mesh's axis names and sizes
alone, so a stand-in object carries them.  The port keeps two cache
layouts of its own (``kv_heads`` before ``kv_seq``, no ``pos``), so a
cache leaf is compared dimension by dimension under its logical name.
Also exact: ``resolve_rules``, ``optimizer_state_axes``, ``input_specs``
and ``batch_axes``, ``SHAPES`` / ``shapes_for`` and the 36 dry-run cells.
"""
import functools
import types

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro import sharding as jshd
from repro.launch import mesh as jmesh
from repro.launch.train import abstract_init as jabstract_init
from repro.models import batch_axes as jbatch_axes
from repro.models import get_bundle as jget_bundle
from repro.models import input_specs as jinput_specs
from repro.optim import optimizer_state_axes as joptimizer_state_axes

from repro_torch import configs, sharding as shd
from repro_torch.launch import mesh
from repro_torch.models import batch_axes, get_bundle, input_specs
from repro_torch.optim import optimizer_state_axes
from repro_torch.tree import flatten_with_paths

ARCHS = list(configs.ARCH_MODULES)
MESHES = {
    'sp': types.SimpleNamespace(axis_names=('data', 'model'),
                                devices=np.empty((16, 16))),
    'mp': types.SimpleNamespace(axis_names=('pod', 'data', 'model'),
                                devices=np.empty((2, 16, 16))),
}
RULESETS = ('train', 'serve', 'serve_big')


def _rules(kind, cfg):
    """(reference rules, port rules) of ``kind`` for ``cfg``."""
    base = {'train': 'TRAIN_RULES', 'serve': 'SERVE_RULES',
            'serve_big': 'SERVE_BIG_RULES'}[kind]
    return (jshd.rules_for_arch(getattr(jshd, base), cfg.n_kv_heads, 16,
                                cfg.family),
            shd.rules_for_arch(getattr(shd, base), cfg.n_kv_heads, 16,
                               cfg.family))


@functools.lru_cache(maxsize=None)
def _ref_tree(arch, what):
    """{path: (shape, axes)} of the reference's params or decode_32k
    cache at full width, from ``jax.eval_shape``."""
    jb = jget_bundle(jconfigs.get_config(arch))
    if what == 'params':
        sds, axes = jabstract_init(jb.init, jax.random.PRNGKey(0))
    else:
        s = jconfigs.SHAPES['decode_32k']
        sds, axes = jabstract_init(
            lambda: jb.init_cache(s.global_batch, s.seq_len))
    flat, _ = jax.tree_util.tree_flatten_with_path(sds)
    ax = jax.tree.leaves(axes, is_leaf=jshd._is_axes_leaf)
    assert len(ax) == len(flat)
    return {jax.tree_util.keystr(p): (tuple(l.shape), a)
            for (p, l), a in zip(flat, ax)}


@functools.lru_cache(maxsize=None)
def _port_tree(arch, what):
    """{path: (shape, axes)} of the port's params or decode_32k cache at
    full width, made under ``FakeTensorMode`` (no storage)."""
    cfg = configs.get_config(arch)
    b = get_bundle(cfg)
    with FakeTensorMode():
        if what == 'params':
            tree = b.init(torch.Generator().manual_seed(0), 'cpu')
            axes = b.param_axes(cfg)
        else:
            s = configs.SHAPES['decode_32k']
            tree = b.init_cache(s.global_batch, s.seq_len, 'cpu')
            axes = b.cache_axes(cfg)
    flat = flatten_with_paths(tree)
    ax = shd.axes_leaves(axes)
    assert [p for p, _ in flat] == [p for p, _ in ax]
    return {p: (tuple(l.shape), a) for (p, l), (_, a) in zip(flat, ax)}


def _per_axis(spec, axes):
    return {a: s for a, s in zip(axes, spec) if a is not None}


@pytest.mark.parametrize('arch', ARCHS)
def test_param_specs_equal_reference(arch):
    """Every parameter leaf: same path, shape, axes and spec, for each
    rule set on each mesh."""
    ref, port = _ref_tree(arch, 'params'), _port_tree(arch, 'params')
    assert list(ref) == list(port)
    cfg = configs.get_config(arch)
    for name, m in MESHES.items():
        for kind in RULESETS:
            jr, pr = _rules(kind, cfg)
            jrules = jshd.ShardingRules(m, jmesh.resolve_rules(jr, m))
            prules = shd.ShardingRules(m, mesh.resolve_rules(pr, m))
            for path, (shape, axes) in ref.items():
                assert port[path] == (shape, axes), path
                want = tuple(jrules.spec(axes, shape))
                assert prules.spec(axes, shape) == want, (name, kind, path)


@pytest.mark.parametrize('arch', ARCHS)
def test_cache_specs_equal_reference(arch):
    """Every cache leaf of the port at decode_32k: the mesh axes of each
    logical dimension equal the reference's, whose leaf holds the same
    dimensions in the reference's order (the port keeps no ``pos``)."""
    ref, port = _ref_tree(arch, 'cache'), _port_tree(arch, 'cache')
    assert set(port) <= set(ref)
    assert set(ref) - set(port) <= {p for p in ref if p.endswith("['pos']")}
    cfg = configs.get_config(arch)
    for name, m in MESHES.items():
        for kind in ('serve', 'serve_big'):
            jr, pr = _rules(kind, cfg)
            jrules = jshd.ShardingRules(m, jmesh.resolve_rules(jr, m))
            prules = shd.ShardingRules(m, mesh.resolve_rules(pr, m))
            for path, (shape, axes) in port.items():
                rshape, raxes = ref[path]
                assert sorted(axes, key=str) == sorted(raxes, key=str), path
                want = _per_axis(jrules.spec(raxes, rshape), raxes)
                got = _per_axis(prules.spec(axes, shape), axes)
                assert got == want, (name, kind, path)
                if axes == raxes:
                    assert shape == rshape, path


def test_rule_tables_equal_reference():
    assert shd.TRAIN_RULES == jshd.TRAIN_RULES
    assert shd.SERVE_RULES == jshd.SERVE_RULES
    assert shd.SERVE_BIG_RULES == jshd.SERVE_BIG_RULES
    for arch in ARCHS:
        cfg = configs.get_config(arch)
        for kind in RULESETS:
            jr, pr = _rules(kind, cfg)
            assert jr == pr
            for m in MESHES.values():
                assert mesh.resolve_rules(pr, m) == jmesh.resolve_rules(jr, m)


def test_spec_dedup_and_fallback():
    """The reference's four cases (``tests/test_substrate.py``) on the
    multi-pod mesh, for both packages: 40 heads fall back to head_dim, a
    divisible head count claims model, 8 experts take the pod prefix, and
    batch 1 replicates."""
    m = MESHES['mp']
    cases = ((('embed', 'heads', 'head_dim'), (5120, 40, 128),
              (('pod', 'data'), None, 'model')),
             (('embed', 'heads', 'head_dim'), (7168, 64, 112),
              (('pod', 'data'), 'model', None)),
             (('experts', 'embed', 'expert_mlp'), (8, 6144, 16384),
              ('pod', 'data', 'model')),
             (('batch', 'seq'), (1, 524288), (None, None)))
    port = shd.ShardingRules(m, mesh.resolve_rules(shd.TRAIN_RULES, m))
    ref = jshd.ShardingRules(m, jmesh.resolve_rules(jshd.TRAIN_RULES, m))
    for axes, shape, want in cases:
        assert port.spec(axes, shape) == want
        assert tuple(ref.spec(axes, shape)) == want


@pytest.mark.parametrize('name', ['adamw', 'adafactor', 'sgd'])
def test_optimizer_state_axes_equal_reference(name):
    for arch in ('qwen3-14b', 'chipmunk-ctc', 'mixtral-8x22b'):
        cfg = configs.get_config(arch)
        _, jaxes = jabstract_init(jget_bundle(jconfigs.get_config(arch)).init,
                                  jax.random.PRNGKey(0))
        want = jax.tree.leaves(joptimizer_state_axes(name, jaxes),
                               is_leaf=jshd._is_axes_leaf)
        got = [a for _, a in shd.axes_leaves(
            optimizer_state_axes(name, get_bundle(cfg).param_axes(cfg)))]
        assert got == want, arch


def test_input_specs_and_batch_axes_equal_reference():
    n = 0
    for arch in ARCHS:
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        for s in configs.shapes_for(cfg):
            js = jconfigs.SHAPES[s.name]
            want = jinput_specs(jcfg, js)
            got = input_specs(cfg, s)
            assert list(got) == list(want)
            for k in want:
                assert got[k].shape == tuple(want[k].shape)
                assert str(got[k].dtype).split('.')[-1] == str(
                    want[k].dtype)
            assert batch_axes(cfg, s) == jbatch_axes(jcfg, js)
            n += 1
    assert n == 36


def test_shapes_and_cells_equal_reference():
    assert {k: (v.kind, v.seq_len, v.global_batch)
            for k, v in configs.SHAPES.items()} == {
        k: (v.kind, v.seq_len, v.global_batch)
        for k, v in jconfigs.SHAPES.items()}
    assert configs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    cells = [(a, s.name) for a in ARCHS
             for s in configs.shapes_for(configs.get_config(a))]
    assert cells == [(a, s.name) for a in jconfigs.ARCH_MODULES
                     for s in jconfigs.shapes_for(jconfigs.get_config(a))]
    assert len(cells) == 36
    assert sum(a != 'chipmunk-ctc' for a, _ in cells) == 33
    assert sorted(a for a, s in cells if s == 'long_500k') == [
        'hymba-1.5b', 'mixtral-8x22b', 'xlstm-1.3b']
