"""The port's LM training path against the JAX reference on the CPU: K8's
autograd Function (its plain forward and backward on CPU tensors),
``transformer.loss_fn``'s gradients, ``remat``, the three optimizers and
the WSD schedule, the LM data sources, ``make_train_step`` (functional and
donating), LM train states through checkpoints shared with the reference,
and the train CLI and the ``train_lm`` example.

Weights come from the reference's own init through ``convert``; tokens and
cotangents are numpy arrays from a seed.  The JAX side runs as its own
tests run it (``use_pallas`` off: ``chunked_attention`` and its custom
VJP).  Tolerances:
- attention against ``chunked_attention``'s custom VJP: relative
  Frobenius error <= 1e-5 per input (f32; the port normalises p before
  P.V, the reference after, and the sums run in other orders);
- ``loss_fn`` with f32 activations: loss rtol = atol = 2e-4 (as
  ``tests/test_torch_lm.py``), every gradient leaf at relative Frobenius
  error <= 1e-4 (two layers of f32 products in other orders);
- optimizers over three updates: rtol 1e-5, atol 1e-7 (elementwise f32,
  as the AdamW test of ``tests/test_torch_train.py``); schedules rtol
  1e-6;
- three train steps (f32 activations; bf16 activations round at other
  places in the two frameworks): loss and gradient norm rtol 1e-4, atol
  1e-5; every leaf of the state at relative Frobenius error <= 1e-4.  Not
  elementwise: a few gradient elements are near 0 (5.4e-9 in minicpm's
  ``wk``) and differ by a few per cent between the frameworks, and AdamW
  divides each by its own magnitude plus eps = 1e-8, so such an element's
  step moves ~4e-5 apart (one element in 8,192) while the leaf agrees to
  ~1e-6.
Everything else is bit for bit: remat modes, donating against functional
steps, batches, checkpoints.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import CheckpointManager as JCkptManager  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.data.pipeline import TokenFile as JTokenFile  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import get_bundle as jget_bundle  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 lm_train_state_from_numpy)
from repro_torch.data import (SyntheticLM, TokenFile,  # noqa: E402
                              source_for)
from repro_torch.examples import train_lm  # noqa: E402
from repro_torch.kernels.flash_attention import attention_train  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import get_bundle, layers  # noqa: E402
from repro_torch.optim import (OPTIMIZERS, apply_updates,  # noqa: E402
                               clip_by_global_norm, make_optimizer,
                               wsd_schedule)
from repro_torch.tree import (flatten_with_paths, leaves,  # noqa: E402
                              tree_map, unflatten_like)

DENSE = ['qwen3-14b', 'qwen2.5-14b', 'codeqwen1.5-7b', 'minicpm-2b']
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_REL = 1e-4
ATTN_REL = 1e-5
OPT_TOL = dict(rtol=1e-5, atol=1e-7)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
LR = (1e-2, 2, 6)          # peak, warmup, total of every schedule here
B, S = 2, 12


def _rel(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _pair(name, **kw):
    """(JAX cfg, JAX params, port cfg, port params on the CPU) of
    ``name``'s smoke configuration, f32 activations, ``kw`` replaced."""
    kw = dict(activation_dtype='float32', **kw)
    jcfg = jconfigs.get_smoke_config(name).replace(**kw)
    jparams, _ = jget_bundle(jcfg).init(jax.random.PRNGKey(0))
    cfg = configs.get_smoke_config(name).replace(**kw)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), 'cpu')
    return jcfg, jparams, cfg, params


def _tokens(vocab, seed, shape=(B, S)):
    return np.random.RandomState(seed).randint(0, vocab, size=shape
                                               ).astype(np.int32)


def _batch(vocab, seed, shape=(B, S)):
    return {'tokens': _tokens(vocab, seed, shape),
            'labels': _tokens(vocab, seed + 100, shape)}


def _grads(cfg, params, batch):
    p = [t.detach().requires_grad_(True) for t in leaves(params)]
    loss = get_bundle(cfg).loss_fn(
        unflatten_like(params, p),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return loss.detach(), torch.autograd.grad(loss, p)


# ------------------------------------------------ attention under autograd
@pytest.mark.parametrize('case', [
    # (H, Hkv, S, D, window, chunk)
    (4, 4, 16, 8, None, 8),       # MHA, causal, two key chunks
    (6, 2, 16, 16, None, 16),     # GQA
    (4, 2, 24, 8, 5, 8),          # GQA, windowed
    (4, 4, 16, 32, 3, 4),         # MHA, windowed
])
def test_attention_function_matches_reference_custom_vjp(case):
    h, hkv, s, d, window, chunk = case
    rng = np.random.RandomState(sum(case[:4]))
    q = rng.randn(2, h, s, d).astype(np.float32)
    k, v = (rng.randn(2, hkv, s, d).astype(np.float32) for _ in range(2))
    ct = rng.randn(2, h, s, d).astype(np.float32)

    def jloss(q, k, v):
        o = jlayers.chunked_attention(q, k, v, causal=True, window=window,
                                      chunk=chunk)
        return jnp.sum(o * ct), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                     has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    o = attention_train(tq, tk, tv, causal=True, window=window)
    grads = torch.autograd.grad((o * torch.from_numpy(ct)).sum(),
                                (tq, tk, tv))
    assert _rel(o, jo) <= ATTN_REL
    for name, g, want in zip('qkv', grads, jg):
        assert _rel(g, want) <= ATTN_REL, name


def test_attention_under_grad_refuses_kv_len():
    q = torch.zeros(1, 2, 4, 8, requires_grad=True)
    k = v = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match='kv_len'):
        layers.attention('auto', q, k, v, kv_len=3)
    with torch.no_grad():      # inference keeps its kv_len
        assert layers.attention('auto', q, k, v, kv_len=3).shape == q.shape


# ------------------------------------------------------ loss and gradients
@pytest.mark.parametrize('name', DENSE)
def test_loss_and_grads_match_reference(name):
    jcfg, jparams, cfg, params = _pair(name)
    batch = _batch(cfg.vocab_size, 1)
    jl, jg = jax.value_and_grad(jget_bundle(jcfg).loss_fn)(
        jparams, jax.tree.map(jnp.asarray, batch))
    loss, grads = _grads(cfg, params, batch)
    np.testing.assert_allclose(float(loss), float(jl), **LOSS_TOL)
    for (path, _), g, want in zip(flatten_with_paths(params), grads,
                                  jax.tree.leaves(jg)):
        assert g.shape == want.shape, path
        assert _rel(g, want) <= GRAD_REL, path


@pytest.mark.parametrize('name', ['qwen3-14b', 'minicpm-2b'])
def test_remat_modes_give_equal_grads(name):
    """``none``, ``full`` (the layer recomputed in the backward) and
    ``dots`` (only the projections' products kept) give the same bits."""
    _, _, cfg, params = _pair(name)
    batch = _batch(cfg.vocab_size, 2)
    out = {r: _grads(cfg.replace(remat=r), params, batch)
           for r in ('none', 'full', 'dots')}
    for r in ('full', 'dots'):
        assert torch.equal(out[r][0], out['none'][0]), r
        assert all(torch.equal(a, b) for a, b in zip(out[r][1],
                                                     out['none'][1])), r
    with pytest.raises(ValueError, match='remat'):
        _grads(cfg.replace(remat='some'), params, batch)


# -------------------------------------------------------------- optimizers
def test_wsd_schedule_and_lr_schedule_for_match_reference():
    for args in (LR, (3e-4, 10, 100), (1.0, 0, 10)):
        for s in (0, 1, 2, 5, 9, 10, 50, 89, 90, 95, 100, 150):
            np.testing.assert_allclose(
                float(wsd_schedule(*args)(s)),
                float(jopt.wsd_schedule(*args)(s)), rtol=1e-6, atol=0)
    for name in DENSE + ['chipmunk-ctc']:
        lr = ttrain.lr_schedule_for(configs.get_smoke_config(name), *LR)
        jlr = jtrain.lr_schedule_for(jconfigs.get_smoke_config(name), *LR)
        for s in range(8):
            np.testing.assert_allclose(float(lr(s)), float(jlr(s)),
                                       rtol=1e-6, atol=0)


def _fake_grads(params, k):
    return tree_map(lambda a: torch.from_numpy((np.random.RandomState(
        40 + k + a.numel()).randn(*a.shape) * (3.0 if k == 0 else 0.01)
    ).astype(np.float32)), params)


@pytest.mark.parametrize('opt_name', sorted(OPTIMIZERS))
def test_optimizers_match_reference_over_three_updates(opt_name):
    """Every optimizer on the LM's leaves (0-d, 1-D norms, 2-D tables,
    3-D stacks: Adafactor factors the last two dims) under WSD."""
    _, jparams, _, params = _pair('qwen3-14b')
    jo = jopt.make_optimizer(opt_name, jopt.wsd_schedule(*LR))
    to = make_optimizer(opt_name, wsd_schedule(*LR))
    js, ts = jo.init(jparams), to.init(params)
    assert type(ts).__name__ == type(js).__name__
    for a, b in zip(leaves(ts), jax.tree.leaves(js)):
        assert tuple(a.shape) == b.shape
    jp, tp = jparams, params
    for k in range(3):
        g = _fake_grads(params, k)
        jg, jn = jopt.clip_by_global_norm(
            jax.tree.map(lambda t: jnp.asarray(t.numpy()), g), 1.0)
        tg, tn = clip_by_global_norm(g, 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5)
        ju, js = jo.update(jg, js, jp)
        tu, ts = to.update(tg, ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), apply_updates(tp, tu)
        assert int(ts.step) == int(js.step) == k + 1
        for a, b in zip(leaves(ts)[1:] + leaves(tp),
                        jax.tree.leaves(js)[1:] + jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **OPT_TOL)


@pytest.mark.parametrize('opt_name', sorted(OPTIMIZERS))
def test_donating_update_equals_functional(opt_name):
    _, _, _, params = _pair('minicpm-2b')
    opt = make_optimizer(opt_name, wsd_schedule(*LR))
    fp, fs = params, opt.init(params)
    dp = tree_map(torch.clone, params)
    ds = opt.init(dp)
    for k in range(3):
        g = _fake_grads(params, k)
        u, fs = opt.update(g, fs, fp)
        fp = apply_updates(fp, u)
        ds = opt.update_(leaves(tree_map(torch.clone, g)), ds, dp)
    for a, b in zip(leaves(fs) + leaves(fp), leaves(ds) + leaves(dp)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# -------------------------------------------------------------------- data
def test_lm_sources_are_bit_equal_to_reference(tmp_path):
    cfg = configs.get_smoke_config('minicpm-2b')
    jcfg = jconfigs.get_smoke_config('minicpm-2b')
    shape = configs.ShapeConfig('t', 'train', 24, 4)
    jshape = jconfigs.ShapeConfig('t', 'train', 24, 4)
    path = tmp_path / 'tokens.bin'
    np.random.RandomState(0).randint(0, 60000, size=5000).astype(
        np.uint16).tofile(path)
    src = source_for(cfg, shape, seed=3)
    fsrc = source_for(cfg, shape, seed=3, token_file=str(path))
    assert isinstance(src, SyntheticLM) and isinstance(fsrc, TokenFile)
    pairs = ((src, JSyntheticLM(jcfg, jshape, seed=3)),
             (fsrc, JTokenFile(str(path), jcfg, jshape, seed=3)))
    for got_src, want_src in pairs:
        for step in (0, 5):
            got = got_src.host_batch(step, 1, 3)
            want = want_src.host_batch(step, 1, 3)
            assert sorted(got) == sorted(want) == ['labels', 'tokens']
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    # every LM family has a source now, as in the reference
    # (tests/test_torch_family_train.py holds each one to it)
    assert isinstance(source_for(cfg.replace(family='moe'), shape),
                      SyntheticLM)


# -------------------------------------------------------------- train step
def _j_state(jcfg, jo, key=0):
    jparams, _ = jget_bundle(jcfg).init(jax.random.PRNGKey(key))
    return {'params': jparams, 'opt': jo.init(jparams),
            'step': jnp.zeros((), jnp.int32)}


@pytest.mark.parametrize('microbatches', [1, 2])
@pytest.mark.parametrize('name,opt_name', [('minicpm-2b', 'adamw'),
                                           ('qwen3-14b', 'adafactor')])
def test_train_step_matches_reference(name, opt_name, microbatches):
    """Three steps of ``make_train_step`` (the functional and the donating
    form, bit-equal to each other) against the reference's jitted one, from
    the same weights and ``SyntheticLM`` batches; minicpm under WSD from
    ``lr_schedule_for``."""
    kw = dict(activation_dtype='float32', optimizer=opt_name)
    jcfg = jconfigs.get_smoke_config(name).replace(**kw)
    cfg = configs.get_smoke_config(name).replace(**kw)
    jo = jopt.make_optimizer(opt_name, jtrain.lr_schedule_for(jcfg, *LR))
    jstate = _j_state(jcfg, jo)
    jstep = jax.jit(jtrain.make_train_step(jget_bundle(jcfg), jo,
                                           microbatches=microbatches))
    opt = make_optimizer(opt_name, ttrain.lr_schedule_for(cfg, *LR))
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
            states[d], ms[d] = steps[d](
                states[d], {n: torch.from_numpy(v) for n, v in host.items()})
        for key in ('loss', 'grad_norm'):
            np.testing.assert_allclose(float(ms[False][key]),
                                       float(jm[key]), **STEP_TOL)
            assert torch.equal(ms[False][key], ms[True][key])
    assert int(states[True]['step']) == int(jstate['step']) == 3
    for (path, a), b, c in zip(flatten_with_paths(states[False]),
                               jax.tree.leaves(jstate), leaves(states[True])):
        assert _rel(a, b) <= GRAD_REL, path
        assert torch.equal(a, c), path


def test_lm_resume_through_a_checkpoint_is_bit_equal(tmp_path):
    """``lm_tiny`` at batch 8 x 64 (enough rows that the CPU threads an
    indexing backward's accumulate): 2 + 2 donating steps through a
    checkpoint restored into a state from another seed equal 4 straight,
    every leaf ``torch.equal``."""
    cfg = train_lm.lm_tiny()
    shape = configs.ShapeConfig('lm', 'train', 64, 8)
    opt = make_optimizer(cfg.optimizer, wsd_schedule(*LR))
    step = ttrain.make_train_step(ttrain.loss_fn_for(cfg), opt, donate=True)

    def run(state, lo, hi):
        src = source_for(cfg, shape)
        for k in range(lo, hi):
            state, _ = step(state, {n: torch.from_numpy(v) for n, v in
                                    src.host_batch(k, 0, 8).items()})
        return state

    straight = run(ttrain.init_train_state(cfg, opt, 'cpu'), 0, 4)
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, run(ttrain.init_train_state(cfg, opt, 'cpu'), 0, 2),
             blocking=True)
    resumed = run(mgr.restore(ttrain.init_train_state(cfg, opt, 'cpu',
                                                      seed=1)), 2, 4)
    for (path, a), b in zip(flatten_with_paths(straight), leaves(resumed)):
        assert torch.equal(a, b), path


# ------------------------------------------------------------- checkpoints
@pytest.mark.parametrize('opt_name', sorted(OPTIMIZERS))
def test_lm_train_state_checkpoints_shared_with_reference(opt_name,
                                                          tmp_path):
    """A reference LM train state (nonzero moments) written by the
    reference's manager restores into the port's, leaf for leaf, equals
    ``lm_train_state_from_numpy``'s copy, and the port's checkpoint of it
    restores into the reference's."""
    jcfg = jconfigs.get_smoke_config('minicpm-2b')
    jo = jopt.make_optimizer(opt_name, jopt.wsd_schedule(*LR))
    jstate = _j_state(jcfg, jo, key=1)
    g = jax.tree.map(lambda p: p * 0.5 + 0.25, jstate['params'])
    _, opt = jo.update(g, jstate['opt'], jstate['params'])
    jstate = dict(jstate, opt=opt, step=jnp.asarray(7, jnp.int32))
    JCkptManager(tmp_path / 'ref').save(7, jstate, blocking=True)
    cfg = configs.get_smoke_config('minicpm-2b')
    like = ttrain.init_train_state(cfg, make_optimizer(
        opt_name, wsd_schedule(*LR)), 'cpu')
    got = CheckpointManager(tmp_path / 'ref').restore(like)
    assert int(got['step']) == 7 and int(got['opt'].step) == 1
    conv = lm_train_state_from_numpy(jax.tree.map(np.asarray, jstate), 'cpu')
    for a, b, c in zip(leaves(got), jax.tree.leaves(jstate), leaves(conv)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.dtype == c.dtype and torch.equal(a, c)
    CheckpointManager(tmp_path / 'port').save(7, got, blocking=True)
    back = JCkptManager(tmp_path / 'port').restore(jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------- CLI and the example
def test_train_cli_trains_minicpm_smoke_and_resumes(tmp_path, capsys):
    args = ['--arch', 'minicpm-2b', '--smoke', '--device', 'cpu', '--batch',
            '2', '--seq', '16', '--ckpt-every', '2', '--log-every', '1',
            '--ckpt-dir', str(tmp_path)]
    ttrain.main(args + ['--steps', '4'])
    first = capsys.readouterr().out
    ttrain.main(args + ['--steps', '6', '--resume'])
    second = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in (first + second).splitlines()
              if line.startswith('step')]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert 'resumed at step 4' in second
    assert CheckpointManager(tmp_path).latest_step() == 6


def test_train_lm_example_tiny(tmp_path, capsys):
    train_lm.main(['--tiny', '--device', 'cpu', '--steps', '2', '--batch',
                   '2', '--seq', '32', '--ckpt-dir', str(tmp_path)])
    out = capsys.readouterr().out
    assert 'qwen3-tiny: 1.2M params on cpu' in out
    assert 'finished; straggler/fault events: 0' in out
    assert CheckpointManager(tmp_path).latest_step() == 2
    assert train_lm.lm_100m().remat == 'none'
