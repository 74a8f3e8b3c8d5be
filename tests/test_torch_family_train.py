"""The port's training path for the LM families one card holds whole
(whisper-base's encoder-decoder, xLSTM-1.3B, Hymba-1.5B) against the JAX
reference on the CPU, at their smoke sizes: the data sources of every LM
family, K8's autograd Function at the non-causal Sq != Sk and windowed GQA
shapes, the mLSTM's maxima under a tie, each bundle's ``loss_fn`` and its
gradients, ``remat``, three train steps, train states through checkpoints
shared with the reference, and the train CLI.  The MoE and VLM families'
training is held in ``tests/test_torch_moe_train.py``.

Weights come from the reference's own init through ``convert``; tokens,
sources and cotangents are numpy arrays from a seed.  The reference runs
as its own tests run it (``use_pallas`` off: ``chunked_attention``).  Its
``attn_chunk`` is set to 16 (whisper) and 64 (Hymba), so that its keys
(37 source frames; 128 meta + 12 tokens) are not a whole number of
chunks: the reference pads them and masks the padding with ``kv_len``,
and ``jax.grad`` then differentiates the forward scan ``_attn_fwd_scan``
rather than the custom VJP ``_ca_bwd``.  Both compute the same function
and its exact gradient; the port has no padding and runs its own
backward.  Tolerances:
- attention against ``jax.grad`` of ``chunked_attention``: relative
  Frobenius error <= 1e-5 per input and for the output (f32; sums in
  other orders; as ``tests/test_torch_lm_train.py``);
- ``mlstm_chunkwise``'s gradient at ties: relative Frobenius error
  <= 1e-5 per input (f32; a few elements of ``log_f``'s gradient are
  cancellations near 0, so not elementwise);
- ``loss_fn`` with f32 activations: loss rtol = atol = 2e-4, every
  gradient leaf at relative Frobenius error <= 1e-4 (measured at most
  2.0e-6: Hymba's ``b_dt``);
- three train steps (AdamW under ``lr_schedule_for``'s cosine): loss and
  gradient norm rtol 1e-4, atol 1e-5 (as the dense family's test), every
  leaf of the state at relative Frobenius error <= 2.5e-4.  Measured:
  whisper 4.0e-5; Hymba 1.8e-5 after step 1 (``w_in``), 7.5e-5 after
  step 2 and 1.16e-4 after step 3 (the second moments of the Mamba's
  ``w_dt`` and ``b_dt``).  Those gradients are 1e-11 to 1e-9, below
  AdamW's eps, sums of cancelling terms taken in another order (the
  doubling scan against ``associative_scan``'s tree), and AdamW moves
  each parameter by ~lr whatever its gradient's size, so the two runs'
  relative differences grow step by step; 1e-4, the dense family's
  bound, is what three steps of Hymba just pass.
Everything else is bit for bit: batches, remat modes, donating against
functional steps, checkpoints, the CLI's resume.

The module runs PyTorch on one intra-op thread (restored after): its
tensors are small, and beside the suite's other workers a full thread
pool oversubscribes the cores (Hymba's remat test took 34 s instead of
0.5 s under seven busy cores, 2.8 s on one thread).
"""
import functools
import shutil

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
from repro.models import recurrent as jrec  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 lm_train_state_from_numpy)
from repro_torch.data import SyntheticLM, TokenFile, source_for  # noqa: E402
from repro_torch.kernels.flash_attention import attention_train  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import get_bundle, layers, recurrent  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.tree import (flatten_with_paths, leaves,  # noqa: E402
                              unflatten_like)

FAMILIES = ['whisper-base', 'xlstm-1.3b', 'hymba-1.5b']
LM_ARCHS = sorted(a for a in configs.ARCH_MODULES if a != 'chipmunk-ctc')
# the reference's key chunk: not a divisor of the keys (module docstring)
JAX_CHUNK = {'whisper-base': 16, 'hymba-1.5b': 64}
FRAMES = 37                 # source frames of the gradient checks
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_REL = 1e-4
ATTN_REL = 1e-5
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
STATE_REL = 2.5e-4
LR = (1e-2, 2, 6)           # peak, warmup, total of the schedules here
B, S = 2, 12


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
    drawn once a module: the activation dtype and ``attn_chunk`` do not
    enter them)."""
    jcfg = jconfigs.get_smoke_config(name)
    return jax.jit(lambda k: jget_bundle(jcfg).init(k)[0])(
        jax.random.PRNGKey(0))


def _pair(name, **kw):
    """(JAX cfg, JAX params, port cfg, port params on the CPU) of ``name``'s
    smoke config at f32 activations, ``kw`` replaced, the reference's
    ``attn_chunk`` at ``JAX_CHUNK``."""
    kw = dict(activation_dtype='float32', **kw)
    jcfg = jconfigs.get_smoke_config(name).replace(
        attn_chunk=JAX_CHUNK.get(name, 512), **kw)
    cfg = configs.get_smoke_config(name).replace(**kw)
    jparams = _jax_params(name)
    return jcfg, jparams, cfg, lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), 'cpu')


def _batch(cfg, seed, b=B, frames=FRAMES):
    """``SyntheticLM``'s batch of ``cfg`` (tokens, labels; whisper's
    source replaced by one of ``frames`` frames)."""
    shape = configs.ShapeConfig('t', 'train', S, b)
    batch = SyntheticLM(cfg, shape, seed=seed).host_batch(0, 0, b)
    if 'source' in batch:
        batch['source'] = np.random.RandomState(seed).randn(
            b, frames, cfg.d_model).astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads(cfg, params, batch):
    p = [t.detach().requires_grad_(True) for t in leaves(params)]
    loss = get_bundle(cfg).loss_fn(unflatten_like(params, p), _torch(batch))
    return loss.detach(), torch.autograd.grad(loss, p)


# -------------------------------------------------------------------- data
@pytest.mark.parametrize('name', LM_ARCHS)
def test_sources_are_bit_equal_to_reference(name, tmp_path):
    """``source_for`` gives every LM family a source, as the reference's
    does: ``SyntheticLM`` (with ``source`` frames or patches for audio and
    vlm, drawn after the tokens) and ``TokenFile``, rows 1 .. 3 of two
    steps bit for bit."""
    cfg, jcfg = configs.get_smoke_config(name), jconfigs.get_smoke_config(name)
    shape = configs.ShapeConfig('t', 'train', 24, 4)
    jshape = jconfigs.ShapeConfig('t', 'train', 24, 4)
    path = tmp_path / 'tokens.bin'
    np.random.RandomState(0).randint(0, 60000, size=5000).astype(
        np.uint16).tofile(path)
    src = source_for(cfg, shape, seed=3)
    fsrc = source_for(cfg, shape, seed=3, token_file=str(path))
    assert isinstance(src, SyntheticLM) and isinstance(fsrc, TokenFile)
    keys = ['labels', 'tokens'] + (['source'] if cfg.family in ('audio',
                                                                'vlm')
                                   else [])
    for got_src, want_src, want_keys in (
            (src, JSyntheticLM(jcfg, jshape, seed=3), keys),
            (fsrc, JTokenFile(str(path), jcfg, jshape, seed=3),
             ['labels', 'tokens'])):
        for step in (0, 5):
            got = got_src.host_batch(step, 1, 3)
            want = want_src.host_batch(step, 1, 3)
            assert sorted(got) == sorted(want) == sorted(want_keys)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    if 'source' in keys:
        assert src.host_batch(0, 0, 4)['source'].shape == (
            4, cfg.n_source_tokens, cfg.d_model)


# ------------------------------------------------ attention under autograd
@pytest.mark.parametrize('case', [
    # (label, H, Hkv, Sq, Sk, D, causal, window, the reference's chunk)
    ('cross: non-causal, Sq != Sk, padded keys', 4, 4, 8, 37, 16, False,
     None, 16),
    ('encoder: non-causal, Sq = Sk, padded keys', 4, 4, 37, 37, 16, False,
     None, 16),
    ('windowed GQA, padded keys', 6, 2, 40, 40, 16, True, 12, 16),
    ('windowed GQA, whole chunks', 6, 2, 32, 32, 16, True, 12, 16),
], ids=lambda c: c[0] if isinstance(c, tuple) else c)
def test_attention_function_matches_reference_grad(case):
    """``attention_train`` (plain forward and backward on CPU tensors)
    against ``jax.grad`` of ``chunked_attention``: the padded cases
    differentiate the reference's forward scan (its ``kv_len`` path), the
    last its custom VJP ``_ca_bwd``."""
    _, h, hkv, sq, sk, d, causal, window, chunk = case
    rng = np.random.RandomState(sq + sk + h)
    q, ct = (rng.randn(2, h, sq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(2, hkv, sk, d).astype(np.float32) for _ in range(2))

    def jloss(q, k, v):
        o = jlayers.chunked_attention(q, k, v, causal=causal, window=window,
                                      chunk=chunk)
        return jnp.sum(o * ct), o

    (_, jo), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                             has_aux=True))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    o = attention_train(tq, tk, tv, causal=causal, window=window)
    grads = torch.autograd.grad((o * torch.from_numpy(ct)).sum(),
                                (tq, tk, tv))
    assert _rel(o, jo) <= ATTN_REL
    for name, g, want in zip('qkv', grads, jg):
        assert _rel(g, want) <= ATTN_REL, name


@pytest.mark.parametrize('name', ['whisper-base', 'hymba-1.5b'])
def test_attention_under_grad_takes_attention_train(name, monkeypatch):
    """Under grad every attention of the loss goes through
    ``attention_train`` with no ``kv_len``: whisper's encoder (non-causal,
    Sq = Sk), its decoder's self blocks (causal) and cross blocks
    (non-causal, Sq != Sk, no window); Hymba's layers (causal, the window
    but on ``global_layer_ids``).  A forward without grad takes none."""
    _, _, cfg, params = _pair(name)
    calls = []

    def spy(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2], kw['causal'], kw['window'],
                      kw['offset']))
        return attention_train(q, k, v, **kw)

    monkeypatch.setattr(layers, 'attention_train', spy)
    batch = _batch(cfg, 1)
    with torch.no_grad():
        get_bundle(cfg).loss_fn(params, _torch(batch))
    assert calls == []
    _grads(cfg, params, batch)
    if name == 'whisper-base':
        enc = [(FRAMES, FRAMES, False, None, None)] * cfg.n_encoder_layers
        dec = [(S, S, True, None, None), (S, FRAMES, False, None, None)]
        assert calls == enc + dec * cfg.n_layers
    else:
        rows = recurrent.N_META + S
        assert calls == [(rows, rows, True, recurrent._window(cfg, i), None)
                         for i in range(cfg.n_layers)]
        assert {c[3] for c in calls} == {None, cfg.sliding_window}


# ------------------------------------------------------------- the mLSTM
def test_mlstm_gradients_split_ties_as_the_reference():
    """``mlstm_chunkwise``'s gradient against ``jax.grad`` of the
    reference's where every maximum ties: f = 1 and one input gate for all
    steps make each row of the decay matrix equal (``amax`` ties), and the
    second chunk's inter-chunk bound equal to its rows' maximum
    (``torch.maximum`` ties).  Both frameworks split a tied maximum's
    gradient evenly between its operands.  The loss also reads the final
    state: y's stabiliser cancels in y / denom, but the running max m
    does not, so a tie split otherwise (``max(dim).values``, a ``where``)
    moves the gates' gradients by 7-20 %."""
    a = torch.tensor([1.0, 2.0, 2.0], requires_grad=True)
    b = torch.tensor([2.0, 2.0, 1.0], requires_grad=True)
    ga, gb = torch.autograd.grad(torch.maximum(a, b).sum(), (a, b))
    ja, jb = jax.grad(lambda x, y: jnp.maximum(x, y).sum(), (0, 1))(
        a.detach().numpy(), b.detach().numpy())
    np.testing.assert_array_equal(ga.numpy(), ja)
    np.testing.assert_array_equal(gb.numpy(), jb)
    assert ga.tolist() == [0.0, 0.5, 1.0]
    (gm,) = torch.autograd.grad(b.amax(), (b,))
    np.testing.assert_array_equal(gm.numpy(), jax.grad(jnp.max)(
        b.detach().numpy()))
    assert gm.tolist() == [0.5, 0.5, 0.0]

    rng = np.random.RandomState(5)
    bh, h, s, dh, chunk = 2, 2, 16, 8, 8
    q, k, v, ct = (rng.randn(bh, h, s, dh).astype(np.float32)
                   for _ in range(4))
    log_f = np.zeros((bh, h, s), np.float32)
    log_i = np.full((bh, h, s), 0.3, np.float32)

    def jloss(*xs):
        y, (c, n, m) = jrec.mlstm_chunkwise(*xs, chunk)
        return jnp.sum(y * ct) + jnp.sum(c) + jnp.sum(n) + jnp.sum(m)

    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(q, k, v, log_f,
                                                           log_i)
    ts = [torch.from_numpy(x).requires_grad_(True)
          for x in (q, k, v, log_f, log_i)]
    y, (c, n, m) = recurrent.mlstm_chunkwise(*ts, chunk)
    loss = (y * torch.from_numpy(ct)).sum() + c.sum() + n.sum() + m.sum()
    for name, g, want in zip(('q', 'k', 'v', 'log_f', 'log_i'),
                             torch.autograd.grad(loss, ts), jg):
        assert _rel(g, want) <= ATTN_REL, name


# ------------------------------------------------------ loss and gradients
@pytest.mark.parametrize('name', FAMILIES)
def test_loss_and_grads_match_reference(name):
    """Each bundle's ``loss_fn`` and every gradient leaf (Hymba's meta
    tokens included) against ``jax.value_and_grad`` of the reference's, at
    f32 activations, xLSTM's and Hymba's losses taking no state stack."""
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
    if name == 'hymba-1.5b':
        assert "['meta']" in paths and float(grads[paths.index(
            "['meta']")].abs().max()) > 0


@pytest.mark.parametrize('name', FAMILIES)
def test_remat_modes_give_equal_grads(name):
    """``none``, ``full`` (an xLSTM group, a Hymba layer, a whisper layer
    recomputed in the backward) and ``dots`` give the same bits."""
    _, _, cfg, params = _pair(name)
    batch = _batch(cfg, 2)
    out = {r: _grads(cfg.replace(remat=r), params, batch)
           for r in ('none', 'full', 'dots')}
    for r in ('full', 'dots'):
        assert torch.equal(out[r][0], out['none'][0]), r
        assert all(torch.equal(a, b) for a, b in zip(out[r][1],
                                                     out['none'][1])), r


def test_xlstm_forward_without_states_equals_forward():
    """A forward without states (the loss's and the bundle's ``forward``)
    returns None for them, and its logits are the reference's forward's
    at f32 activations (rtol = atol = 2e-4, the loss's bound)."""
    jcfg, jparams, cfg, params = _pair('xlstm-1.3b')
    batch = _batch(cfg, 3)
    with torch.no_grad():
        got, none = recurrent.forward_xlstm(
            cfg, params, torch.from_numpy(batch['tokens']))
        fwd = get_bundle(cfg).forward(params, _torch(batch))
    want = jax.jit(jget_bundle(jcfg).forward)(
        jparams, jax.tree.map(jnp.asarray, batch))
    assert none is None and torch.equal(fwd, got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)


# -------------------------------------------------------------- train step
@pytest.mark.parametrize('microbatches', [1, 2])
@pytest.mark.parametrize('name', ['hymba-1.5b', 'whisper-base'])
def test_train_step_matches_reference(name, microbatches):
    """Three AdamW steps of ``make_train_step`` (functional and donating,
    bit-equal to each other) against the reference's jitted one from the
    same weights and ``SyntheticLM`` batches (whisper's with its
    ``source``), under ``lr_schedule_for``'s cosine."""
    jcfg, jparams, cfg, _ = _pair(name)
    jo = jopt.make_optimizer('adamw', jtrain.lr_schedule_for(jcfg, *LR))
    jstate = {'params': jparams, 'opt': jo.init(jparams),
              'step': jnp.zeros((), jnp.int32)}
    jstep = jax.jit(jtrain.make_train_step(jget_bundle(jcfg), jo,
                                           microbatches=microbatches))
    opt = make_optimizer('adamw', ttrain.lr_schedule_for(cfg, *LR))
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
    """A reference AdamW train state of ``name`` (nonzero moments), written
    by the reference's manager, restores into the port's
    (``init_train_state``'s tree) leaf for leaf, equals
    ``lm_train_state_from_numpy``'s copy, and the port's checkpoint of it
    restores into the reference's."""
    jcfg = jconfigs.get_smoke_config(name)
    jo = jopt.make_optimizer('adamw', jopt.cosine_schedule(*LR))
    jparams = _jax_params(name)
    m = jax.tree.map(lambda p: p * 0.5 + 0.25, jparams)
    opt = jo.init(jparams)._replace(step=jnp.asarray(1, jnp.int32), m=m,
                                    v=jax.tree.map(jnp.square, m))
    jstate = {'params': jparams, 'opt': opt,
              'step': jnp.asarray(7, jnp.int32)}
    JCkptManager(tmp_path / 'ref').save(7, jstate, blocking=True)
    cfg = configs.get_smoke_config(name)
    like = ttrain.init_train_state(cfg, make_optimizer(
        'adamw', ttrain.lr_schedule_for(cfg, *LR)), 'cpu', seed=1)
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


# --------------------------------------------------------------------- CLI
def _cli_args(name, ckpt_dir, steps):
    return ['--arch', name, '--smoke', '--device', 'cpu', '--batch', '2',
            '--seq', '16', '--ckpt-every', '2', '--log-every', '1',
            '--ckpt-dir', str(ckpt_dir), '--steps', str(steps)]


@pytest.mark.parametrize('name', FAMILIES)
def test_train_cli_trains_and_resumes_bit_for_bit(name, tmp_path, capsys):
    """``launch.train --smoke --device cpu`` trains ``name`` for 6 steps
    with checkpoints at 2, 4 and 6; a run resumed from the step-4
    checkpoint alone ends in the same state, every leaf ``torch.equal``.
    K8's launches are printed for the families with attention."""
    ttrain.main(_cli_args(name, tmp_path / 'a', 6))
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith('step')]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert ('K8 launches' in out) == (name != 'xlstm-1.3b')
    (tmp_path / 'b').mkdir()
    shutil.copytree(tmp_path / 'a' / 'step_00000004',
                    tmp_path / 'b' / 'step_00000004')
    ttrain.main(_cli_args(name, tmp_path / 'b', 6) + ['--resume'])
    out = capsys.readouterr().out
    assert 'resumed at step 4' in out
    assert len([ln for ln in out.splitlines() if ln.startswith('step')]) == 2
    cfg = configs.get_smoke_config(name)
    like = ttrain.init_train_state(cfg, make_optimizer(
        'adamw', ttrain.lr_schedule_for(cfg)), 'cpu')
    straight = CheckpointManager(tmp_path / 'a').restore(like, step=6)
    resumed = CheckpointManager(tmp_path / 'b').restore(like, step=6)
    for (path, a), b in zip(flatten_with_paths(straight), leaves(resumed)):
        assert torch.equal(a, b), path
