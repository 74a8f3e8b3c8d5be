"""The port's training path for the MoE and VLM families (Mixtral 8x22B,
Kimi-K2 and Llama-3.2-Vision-90B) against the JAX reference on the CPU, at
their smoke sizes, and the optimizer's work a matrix at a time: each
bundle's ``loss_fn`` and every gradient leaf (the router's, through the
load-balance loss, included), ``remat`` (a layer, a VLM group of four self
blocks and a cross block) and the MoE routes read twice under it, the
attention calls under grad, Adafactor train steps against the reference's
jitted step, train states through checkpoints shared with the reference,
the train CLI, and the global norm, clip and updates over stacked leaves.

Weights come from the reference's own init through ``convert``; tokens,
image patches and gradients are numpy arrays from a seed.  The reference
runs as its own tests run it (``use_pallas`` off: ``chunked_attention``);
the port's attention is K8's plain version (CPU tensors).  Tolerances:
- ``loss_fn`` with f32 activations: loss rtol = atol = 2e-4, every
  gradient leaf at relative Frobenius error <= 1e-4 (as the dense and
  whole families' tests);
- three Adafactor train steps (f32 activations): loss and gradient norm
  rtol 1e-4, atol 1e-5 (``STEP_TOL``, the dense family's), every leaf of
  the state at relative Frobenius error <= 2.5e-4 (``STATE_REL``, the whole
  families');
- the sliced global norm and updates against the reference's: rtol 1e-5,
  atol 1e-7 (``OPT_TOL``, as ``tests/test_torch_lm_train.py``; the sums of
  squares run a matrix at a time here, over the leaf there).
Everything else is bit for bit: remat modes, routes in the recompute,
donating against functional steps and updates, checkpoints, the CLI's
resume.

The module runs PyTorch on one intra-op thread (restored after), as
``tests/test_torch_family_train.py`` does.
"""
import functools
import shutil

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import CheckpointManager as JCkptManager  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import get_bundle as jget_bundle  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 lm_train_state_from_numpy)
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels.flash_attention import attention_train  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import get_bundle, layers  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import (OPTIMIZERS, apply_updates,  # noqa: E402
                               clip_by_global_norm, clip_by_global_norm_,
                               cosine_schedule, global_norm, make_optimizer)
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.tree import (flatten_with_paths, leaves,  # noqa: E402
                              tree_map, unflatten_like)

FAMILIES = ['mixtral-8x22b', 'kimi-k2-1t-a32b', 'llama-3.2-vision-90b']
MOE = FAMILIES[:2]
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_REL = 1e-4
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
STATE_REL = 2.5e-4
OPT_TOL = dict(rtol=1e-5, atol=1e-7)
LR = (1e-2, 2, 6)           # peak, warmup, total of the schedules here
B, S = 2, 12
# stacked leaves of the optimizer tests, sliced at SLICE_ELEMS = SLICE:
# experts (layers, experts, rows, columns) down to a matrix, attention
# (layers, d, heads, head dim) down to a layer's (3, 4, 5), a stack of
# matrices (layers, rows, columns), a norm stack (layers, d), a vector
SLICE = 64
STACKED = {'experts': (3, 4, 6, 10), 'attention': (2, 3, 4, 5),
           'stack': (5, 8, 12), 'norms': (5, 8), 'bias': (7,)}


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    """The reference's weights of ``name``'s smoke config (key 0; jitted,
    drawn once a module)."""
    jcfg = jconfigs.get_smoke_config(name)
    return jax.jit(lambda k: jget_bundle(jcfg).init(k)[0])(
        jax.random.PRNGKey(0))


def _pair(name, **kw):
    """(JAX cfg, JAX params, port cfg, port params on the CPU) of ``name``'s
    smoke config at f32 activations, ``kw`` replaced."""
    kw = dict(activation_dtype='float32', **kw)
    jcfg = jconfigs.get_smoke_config(name).replace(**kw)
    cfg = configs.get_smoke_config(name).replace(**kw)
    jparams = _jax_params(name)
    return jcfg, jparams, cfg, lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), 'cpu')


def _batch(cfg, seed, b=B):
    """``SyntheticLM``'s batch of ``cfg``: tokens, labels and, for the
    VLM, its ``n_source_tokens`` image patches."""
    shape = configs.ShapeConfig('t', 'train', S, b)
    return SyntheticLM(cfg, shape, seed=seed).host_batch(0, 0, b)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads(cfg, params, batch, loss_fn=None):
    p = [t.detach().requires_grad_(True) for t in leaves(params)]
    fn = loss_fn or get_bundle(cfg).loss_fn
    loss = fn(unflatten_like(params, p), _torch(batch))
    return loss.detach(), torch.autograd.grad(loss, p,
                                              materialize_grads=True)


# ------------------------------------------------------ loss and gradients
@pytest.mark.parametrize('name', FAMILIES)
def test_loss_and_grads_match_reference(name):
    """Each bundle's ``loss_fn`` (cross entropy + 0.01 x the MoE blocks'
    load-balance loss) and every gradient leaf against
    ``jax.value_and_grad`` of the reference's, at f32 activations; the
    routers' gradients are not zero."""
    jcfg, jparams, cfg, params = _pair(name)
    batch = _batch(cfg, 1)
    jl, jg = jax.jit(jax.value_and_grad(jget_bundle(jcfg).loss_fn))(
        jparams, jax.tree.map(jnp.asarray, batch))
    loss, grads = _grads(cfg, params, batch)
    np.testing.assert_allclose(float(loss), float(jl), **LOSS_TOL)
    paths = [p for p, _ in flatten_with_paths(params)]
    for path, g, want in zip(paths, grads, jax.tree.leaves(jg)):
        assert g.shape == want.shape, path
        assert _rel(g, want) <= GRAD_REL, path
    routers = [g for p, g in zip(paths, grads) if 'router' in p]
    assert len(routers) == (name in MOE)
    assert all(float(g.abs().max()) > 0 for g in routers)


@pytest.mark.parametrize('name', MOE)
def test_aux_loss_gradient_reaches_router_through_probs(name):
    """The load-balance loss alone (``forward_lm``'s second output): its
    value and its gradient into every leaf against the reference's.  The
    gradient reaches each router through the mean routing probabilities
    (the integer expert counts carry none), so the last layer's expert
    weights, which no router reads, get none on either side."""
    jcfg, jparams, cfg, params = _pair(name)
    tokens = _batch(cfg, 2)['tokens']
    ja, jg = jax.jit(jax.value_and_grad(lambda p: jtransformer.forward_lm(
        jcfg, p, jnp.asarray(tokens))[1]))(jparams)
    aux, grads = _grads(cfg, params, {'tokens': tokens}, loss_fn=lambda p, b: (
        transformer.forward_lm(cfg, p, b['tokens'])[1]))
    np.testing.assert_allclose(float(aux), float(ja), **LOSS_TOL)
    for (path, _), g, want in zip(flatten_with_paths(params), grads,
                                  jax.tree.leaves(jg)):
        assert _rel(g, want) <= GRAD_REL, path
        if 'router' in path:
            assert float(g.abs().max()) > 0, path
        if path.startswith("['blocks']['moe']['w_"):
            assert float(g[-1].abs().max()) == 0.0 == float(
                np.abs(np.asarray(want)[-1]).max()), path


# ------------------------------------------------------------------- remat
def _wide(name, **kw):
    """``name``'s smoke config at f32 activations with ``kw`` replaced and
    the port's own weights drawn from seed 0 (the VLM at 10 layers: two
    groups of four self blocks and a cross block)."""
    cfg = configs.get_smoke_config(name).replace(
        activation_dtype='float32', **kw)
    if cfg.cross_attn_every:
        cfg = cfg.replace(n_layers=2 * cfg.cross_attn_every)
    params = get_bundle(cfg).init(torch.Generator().manual_seed(0), 'cpu')
    return cfg, params


@pytest.mark.parametrize('name', FAMILIES)
def test_remat_modes_give_equal_grads(name, monkeypatch):
    """``none``, ``full`` and ``dots`` give the same bits; under ``full``
    the recomputed unit is one layer (MoE) or one group of four self
    blocks and a cross block (VLM), one checkpoint a unit."""
    cfg, params = _wide(name)
    batch = _batch(cfg, 3)
    units = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(transformer.ckpt, 'checkpoint',
                        lambda fn, *a, **kw: units.append(a) or real(
                            fn, *a, **kw))
    out = {}
    for r in ('none', 'full', 'dots'):
        units.clear()
        out[r] = _grads(cfg.replace(remat=r), params, batch)
        n = cfg.n_layers // (cfg.cross_attn_every or 1)
        assert len(units) == (0 if r == 'none' else n), r
    for r in ('full', 'dots'):
        assert torch.equal(out[r][0], out['none'][0]), r
        assert all(torch.equal(a, b) for a, b in zip(out[r][1],
                                                     out['none'][1])), r


class _StackOutputs(TorchDispatchMode):
    """The shapes of every ``aten.stack`` output."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket is torch.ops.aten.stack:
            self.shapes.append(tuple(out.shape))
        return out


@pytest.mark.parametrize('name', ['mixtral-8x22b', 'llama-3.2-vision-90b'])
def test_stacked_gradients_are_written_a_layer_at_a_time(name):
    """Under remat ``full`` the backward never stacks the layers'
    gradients of a stacked leaf (``torch.unbind``'s backward would, with
    every layer's gradient alive beside the stack): ``transformer.unbind``
    writes each layer's gradient into the leaf's as that layer's backward
    ends, the same bits as ``torch.unbind``'s."""
    cfg, params = _wide(name, remat='full')
    batch = _batch(cfg, 5)
    stacked = {tuple(a.shape) for k in ('blocks', 'cross') if k in params
               for a in leaves(params[k])}
    p = [t.detach().requires_grad_(True) for t in leaves(params)]
    loss = get_bundle(cfg).loss_fn(unflatten_like(params, p),
                                   _torch(batch))
    with _StackOutputs() as seen:
        got = torch.autograd.grad(loss, p)
    assert not stacked & set(seen.shapes)
    real = transformer.unbind
    try:
        transformer.unbind = lambda st: [
            unflatten_like(st, list(c)) for c in zip(
                *[torch.unbind(a) for a in leaves(st)])]
        want = _grads(cfg, params, batch)[1]
    finally:
        transformer.unbind = real
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize('tie', [False, True], ids=['routed', 'all tied'])
@pytest.mark.parametrize('name', MOE)
def test_remat_recompute_reads_the_same_routes(name, tie, monkeypatch):
    """Under ``full`` each layer's live experts are read to the host twice,
    in the forward and in the backward's recompute (layers in reverse),
    and both reads give the same experts, also where every router logit
    ties (zero routers: ``topk``, the stable sort and ``searchsorted``
    decide alone); the gradients equal ``none``'s bit for bit."""
    cfg, params = _wide(name)
    if tie:
        for r in torch.unbind(params['blocks']['moe']['router']):
            r.zero_()
    batch = _batch(cfg, 4)
    reads = []
    real = layers._live_experts
    monkeypatch.setattr(layers, '_live_experts',
                        lambda counts: reads.append(real(counts))
                        or reads[-1])
    none = _grads(cfg, params, batch)
    assert len(reads) == cfg.n_layers
    reads.clear()
    full = _grads(cfg.replace(remat='full'), params, batch)
    n = cfg.n_layers
    assert len(reads) == 2 * n and reads[:n] == reads[n:][::-1]
    if tie:
        assert all(len(r) < cfg.moe.n_experts for r in reads)
    assert torch.equal(full[0], none[0])
    assert all(torch.equal(a, b) for a, b in zip(full[1], none[1]))


@pytest.mark.parametrize('name', ['mixtral-8x22b', 'llama-3.2-vision-90b'])
def test_attention_under_grad_takes_attention_train(name, monkeypatch):
    """Under grad every attention of the loss goes through
    ``attention_train``: Mixtral's self layers causal with the window
    itself (16 at smoke size, over 12 tokens: handed on, not dropped);
    the VLM's self blocks causal with no window and its cross blocks
    non-causal over the patches (Sq != Sk)."""
    _, _, cfg, params = _pair(name)
    calls = []

    def spy(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2], kw['causal'], kw['window']))
        return attention_train(q, k, v, **kw)

    monkeypatch.setattr(layers, 'attention_train', spy)
    _grads(cfg, params, _batch(cfg, 1))
    if name == 'mixtral-8x22b':
        assert calls == [(S, S, True, cfg.sliding_window)] * cfg.n_layers
    else:
        per = cfg.cross_attn_every
        group = [(S, S, True, None)] * (per - 1) + [
            (S, cfg.n_source_tokens, False, None)]
        assert calls == group * (cfg.n_layers // per)


# -------------------------------------------------------------- train step
@pytest.mark.parametrize('microbatches', [1, 2])
@pytest.mark.parametrize('name', FAMILIES)
def test_train_step_matches_reference(name, microbatches):
    """Three Adafactor steps of ``make_train_step`` (functional and
    donating, bit-equal to each other) against the reference's jitted one
    from the same weights and ``SyntheticLM`` batches (the VLM's with its
    patches), under ``lr_schedule_for``'s cosine."""
    jcfg, jparams, cfg, _ = _pair(name)
    assert cfg.optimizer == jcfg.optimizer == 'adafactor'
    jo = jopt.make_optimizer('adafactor', jtrain.lr_schedule_for(jcfg, *LR))
    jstate = {'params': jparams, 'opt': jo.init(jparams),
              'step': jnp.zeros((), jnp.int32)}
    jstep = jax.jit(jtrain.make_train_step(jget_bundle(jcfg), jo,
                                           microbatches=microbatches))
    opt = make_optimizer('adafactor', ttrain.lr_schedule_for(cfg, *LR))
    steps = {d: ttrain.make_train_step(ttrain.loss_fn_for(cfg), opt,
                                       microbatches=microbatches, donate=d)
             for d in (False, True)}
    states = {d: lm_train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                           'cpu') for d in steps}
    src = SyntheticLM(cfg, configs.ShapeConfig('t', 'train', S, 4), seed=0)
    for k in range(3):
        host = src.host_batch(k, 0, 4)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, host))
        ms = {}
        for d in steps:
            states[d], ms[d] = steps[d](states[d], _torch(host))
        for key in ('loss', 'grad_norm'):
            np.testing.assert_allclose(float(ms[False][key]),
                                       float(jm[key]), **STEP_TOL)
            assert torch.equal(ms[False][key], ms[True][key])
    assert int(states[True]['step']) == int(jstate['step']) == 3
    for (path, a), b, c in zip(flatten_with_paths(states[False]),
                               jax.tree.leaves(jstate), leaves(states[True])):
        assert _rel(a, b) <= STATE_REL, path
        assert torch.equal(a, c), path


# ------------------------------------------------------------- checkpoints
@pytest.mark.parametrize('name', FAMILIES)
def test_train_states_checkpoints_shared_with_reference(name, tmp_path):
    """A reference Adafactor train state of ``name`` (nonzero factored
    moments), written by the reference's manager, restores into the
    port's (``init_train_state``'s tree) leaf for leaf, equals
    ``lm_train_state_from_numpy``'s copy, and the port's checkpoint of it
    restores into the reference's."""
    jcfg = jconfigs.get_smoke_config(name)
    jo = jopt.make_optimizer('adafactor', jopt.cosine_schedule(*LR))
    jparams = _jax_params(name)
    fresh = jo.init(jparams)
    opt = fresh._replace(
        step=jnp.asarray(2, jnp.int32),
        vr=jax.tree.map(lambda v: v + 0.5, fresh.vr),
        vc=jax.tree.map(lambda v: v + 0.25, fresh.vc))
    jstate = {'params': jparams, 'opt': opt,
              'step': jnp.asarray(5, jnp.int32)}
    JCkptManager(tmp_path / 'ref').save(5, jstate, blocking=True)
    cfg = configs.get_smoke_config(name)
    like = ttrain.init_train_state(cfg, make_optimizer(
        cfg.optimizer, ttrain.lr_schedule_for(cfg, *LR)), 'cpu', seed=1)
    got = CheckpointManager(tmp_path / 'ref').restore(like)
    assert int(got['step']) == 5 and int(got['opt'].step) == 2
    conv = lm_train_state_from_numpy(jax.tree.map(np.asarray, jstate), 'cpu')
    for a, b, c in zip(leaves(got), jax.tree.leaves(jstate), leaves(conv)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.dtype == c.dtype and torch.equal(a, c)
    CheckpointManager(tmp_path / 'port').save(5, got, blocking=True)
    back = JCkptManager(tmp_path / 'port').restore(jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------------------------- CLI
def _cli_args(name, ckpt_dir, steps):
    return ['--arch', name, '--smoke', '--device', 'cpu', '--batch', '2',
            '--seq', '16', '--ckpt-every', '2', '--log-every', '1',
            '--ckpt-dir', str(ckpt_dir), '--steps', str(steps)]


@pytest.mark.parametrize('name', FAMILIES)
def test_train_cli_trains_and_resumes_bit_for_bit(name, tmp_path, capsys):
    """``launch.train --smoke --device cpu`` trains ``name`` for 6 steps
    on Adafactor with checkpoints at 2, 4 and 6, printing K8's launches;
    a run resumed from the step-4 checkpoint alone ends in the same
    state, every leaf ``torch.equal``."""
    ttrain.main(_cli_args(name, tmp_path / 'a', 6))
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith('step')]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert 'K8 launches' in out
    (tmp_path / 'b').mkdir()
    shutil.copytree(tmp_path / 'a' / 'step_00000004',
                    tmp_path / 'b' / 'step_00000004')
    ttrain.main(_cli_args(name, tmp_path / 'b', 6) + ['--resume'])
    out = capsys.readouterr().out
    assert 'resumed at step 4' in out
    assert len([ln for ln in out.splitlines() if ln.startswith('step')]) == 2
    cfg = configs.get_smoke_config(name)
    like = ttrain.init_train_state(cfg, make_optimizer(
        cfg.optimizer, ttrain.lr_schedule_for(cfg)), 'cpu')
    assert type(like['opt']).__name__ == 'AdafactorState'
    straight = CheckpointManager(tmp_path / 'a').restore(like, step=6)
    resumed = CheckpointManager(tmp_path / 'b').restore(like, step=6)
    for (path, a), b in zip(flatten_with_paths(straight), leaves(resumed)):
        assert torch.equal(a, b), path


# ------------------------------------------------- the optimizer, sliced
def _stacked(seed):
    """f32 leaves of ``STACKED``'s shapes from ``seed`` (numpy)."""
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(rng.randn(*s).astype(np.float32))
            for k, s in STACKED.items()}


@pytest.mark.parametrize('opt_name', sorted(OPTIMIZERS))
def test_sliced_clip_and_update_bit_equal_and_match_reference(
        opt_name, monkeypatch):
    """Over leaves of 4, 3, 2 and 1 dims, sliced at ``SLICE`` elements:
    ``global_norm`` and
    ``clip_by_global_norm`` (functional) equal ``clip_by_global_norm_``
    (in place) bit for bit, and three ``update_`` steps equal three
    ``update`` steps bit for bit; both match the reference's norm, clip
    and updates within ``OPT_TOL``."""
    monkeypatch.setattr(optimizers, 'SLICE_ELEMS', SLICE)
    params = _stacked(0)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    opt = make_optimizer(opt_name, cosine_schedule(*LR))
    jo = jopt.make_optimizer(opt_name, jopt.cosine_schedule(*LR))
    fp, fs = params, opt.init(params)
    dp = tree_map(torch.clone, params)
    ds, js, jp = opt.init(dp), jo.init(jparams), jparams
    jclip = jax.jit(jopt.clip_by_global_norm, static_argnums=1)
    jupdate = jax.jit(jo.update)
    for k in range(3):
        g = tree_map(lambda t: t * (3.0 + k), _stacked(k + 1))
        tg, tn = clip_by_global_norm(g, 1.0)
        assert torch.equal(tn, global_norm(g))
        dg = leaves(tree_map(torch.clone, g))
        assert torch.equal(clip_by_global_norm_(dg, 1.0), tn)
        assert all(torch.equal(a, b) for a, b in zip(dg, leaves(tg)))
        jg, jn = jclip({k2: jnp.asarray(v.numpy()) for k2, v in g.items()},
                       1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5)
        u, fs = opt.update(tg, fs, fp)
        fp = apply_updates(fp, u)
        ds = opt.update_(dg, ds, dp)
        assert dg == [None] * len(dg)
        ju, js = jupdate(jg, js, jp)
        jp = jopt.apply_updates(jp, ju)
    for a, b in zip(leaves(fs) + leaves(fp), leaves(ds) + leaves(dp)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(leaves(fs)[1:] + leaves(fp),
                    jax.tree.leaves(js)[1:] + jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **OPT_TOL)


class _LargestF32(TorchDispatchMode):
    """The most elements of an f32 tensor that an op made new (neither a
    view nor written in place)."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and not func._schema.is_mutable:
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                    self.most = max(self.most, t.numel())
        return out


@pytest.mark.parametrize('opt_name', sorted(OPTIMIZERS))
def test_largest_f32_temporary_is_one_slice(opt_name, monkeypatch):
    """The donating step's clip and update (``clip_by_global_norm_``, then
    ``update_``) over bf16 stacked leaves sliced at ``SLICE`` elements
    make no f32 tensor larger than one slice: an expert's (6, 10) matrix,
    a layer's (3, 4, 5) attention weight, a (8, 12) matrix of a stack: 96
    elements, where the (3, 4, 6, 10) leaf holds 720 and the (5, 8, 12)
    one 480."""
    monkeypatch.setattr(optimizers, 'SLICE_ELEMS', SLICE)
    params = tree_map(lambda t: t.to(torch.bfloat16), _stacked(0))
    opt = make_optimizer(opt_name, cosine_schedule(*LR))
    state = opt.init(params)
    for k in range(2):
        grads = leaves(tree_map(lambda t: (t * 3.0).to(torch.bfloat16),
                                _stacked(k + 1)))
        with _LargestF32() as seen:
            clip_by_global_norm_(grads, 1.0)
            state = opt.update_(grads, state, params)
        assert 0 < seen.most <= 96


def test_slices_of_the_configs_stacked_leaves():
    """At the real ``SLICE_ELEMS`` (2**26) on the full configs' leaves
    (shapes only: meta tensors): Mixtral 8x22B's expert stack at 6 layers
    is 48 expert matrices of (6144, 16384); its ``wq`` 6 layers of (6144,
    48, 128); Llama-3.2-Vision-90B's block MLP at 2 groups is 8 matrices
    of (8192, 28672), its 2-D embedding table stays whole; MiniCPM-2B's
    ``wq`` (40 layers) is 40 slices.  The Adafactor state of a slice is
    the slice's own factored moments."""
    cases = [((6, 8, 6144, 16384), 48, (6144, 16384)),
             ((6, 6144, 48, 128), 6, (6144, 48, 128)),
             ((2, 4, 8192, 28672), 8, (8192, 28672)),
             ((128256, 8192), 1, (128256, 8192)),
             ((40, 2304, 36, 64), 40, (2304, 36, 64)),
             ((6, 6144), 1, (6, 6144))]
    for shape, n, piece in cases:
        x = torch.empty(shape, device='meta', dtype=torch.bfloat16)
        got = optimizers._slices(x)
        assert len(got) == n and all(tuple(t.shape) == piece for t in got)
        assert max(t.numel() for t in got) <= max(
            optimizers.SLICE_ELEMS, piece[-2] * piece[-1])
    p = torch.empty((6, 8, 6144, 16384), device='meta')
    st = make_optimizer('adafactor', cosine_schedule(*LR)).init({'w': p})
    lead = optimizers._lead(p.shape)
    assert lead == (6, 8)
    assert {tuple(t.shape) for t in optimizers._slices(st.vr['w'], lead)} \
        == {(6144,)}
    assert {tuple(t.shape) for t in optimizers._slices(st.vc['w'], lead)} \
        == {(16384,)}
