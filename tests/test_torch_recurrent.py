"""Parity of the port's recurrent families (``models.recurrent``: xLSTM's
mLSTM and sLSTM blocks, Hymba's attention beside Mamba heads), their
bundles, converters and token server with the JAX reference, on the CPU,
over the xLSTM and Hymba smoke configurations (4 layers, d_model 64).

Weights come from the reference's own init through
``convert.lm_params_from_numpy``; inputs are numpy arrays from a seed.
Tolerances:
- the functions on f32 inputs (``_causal_conv``, ``mlstm_chunkwise``,
  ``slstm_scan``, ``mamba_mix``, the blocks): rtol = atol = 2e-5 (f32
  throughout; PyTorch and XLA sum in other orders, and ``mamba_mix``'s
  doubling scan combines in another tree than ``associative_scan``);
- ``forward_xlstm`` / ``forward_hymba`` and ``loss_fn`` with f32
  activations: max |difference| within 1e-4 of the logit scale (max
  |logit|); measured 1.1e-6 (xLSTM) and 1.3e-6 (Hymba);
- bf16 activations: within 5e-2 of the scale (bf16 keeps 8 bits and the
  two frameworks round at other places; the port's Hymba decode also
  rounds q to the cache's bf16 before the attention);
- decode replays: against the reference's decode at the f32 bound above
  (logits and the carried states or caches), and xLSTM's decode against
  its own forward at the reference's own bound, rtol = atol = 2e-3
  (``tests/test_models.py``);
- the port's and the reference's ``SlotServer`` emit identical greedy
  tokens (f32 activations): symbols, no tolerance.
"""
import functools
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import get_bundle as jget_bundle  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (hymba_cache_from_numpy,  # noqa: E402
                                 lm_params_from_numpy,
                                 xlstm_state_from_numpy)
from repro_torch.core.lstm import BACKENDS  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_bundle, layers  # noqa: E402
from repro_torch.models import recurrent  # noqa: E402
from repro_torch.tree import flatten_with_paths, leaves, tree_map  # noqa: E402

RECURRENT = ['xlstm-1.3b', 'hymba-1.5b']
ADTYPES = ['float32', 'bfloat16']
IGNORED_FIELDS = ('use_pallas', 'scan_layers', 'attn_chunk',
                  'lstm_backend')
TOL = dict(rtol=2e-5, atol=2e-5)
F32_REL = 1e-4
BF16_REL = 5e-2
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
B, S = 2, 24                 # past Hymba's smoke window of 16
MAX_SEQ = 32


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    """The reference's weights of ``name``'s smoke config (key 0; jitted,
    drawn once a module)."""
    jcfg = jconfigs.get_smoke_config(name)
    return jax.jit(lambda k: jget_bundle(jcfg).init(k)[0])(
        jax.random.PRNGKey(0))


def _pair(name, **kw):
    """(JAX cfg, JAX params, port cfg, port params on the CPU)."""
    jcfg = jconfigs.get_smoke_config(name).replace(**kw)
    jparams = _jax_params(name)
    cfg = configs.get_smoke_config(name).replace(**kw)
    return jcfg, jparams, cfg, lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), 'cpu')


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel(got, want):
    """max |got - want| over the scale of ``want``."""
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _close(got, want, adtype):
    if adtype == 'float32':
        assert _rel(got, want) <= F32_REL
    else:
        assert _rel(got, want) <= BF16_REL


def _tokens(vocab, seed=1, shape=(B, S)):
    return np.random.RandomState(seed).randint(0, vocab, size=shape
                                               ).astype(np.int32)


def _randn(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize('name', RECURRENT)
def test_configs_match_reference(name):
    """CONFIG and SMOKE field for field but those the port leaves out;
    dtypes as torch dtypes."""
    for get, jget in ((configs.get_config, jconfigs.get_config),
                      (configs.get_smoke_config, jconfigs.get_smoke_config)):
        cfg, jcfg = get(name), jget(name)
        for f in jcfg.__dataclass_fields__:
            if f not in IGNORED_FIELDS:
                assert getattr(cfg, f) == getattr(jcfg, f), (name, f)
        assert cfg.lstm_backend in BACKENDS
        assert cfg.dtype() == getattr(torch, str(jcfg.dtype()))
        assert cfg.adtype() == getattr(torch, str(jcfg.adtype()))


@pytest.mark.parametrize('name', RECURRENT)
def test_init_tree_shapes_dtypes_and_fixed_leaves_match_reference(name):
    """The bundle's init: the reference's tree, shapes and dtypes (a_log
    f32), its parameter count; the leaves the reference does not draw
    from its key equal to the reference's: ``b_dt`` bit for bit (the same
    numpy draw in every layer), ``a_log``, ``b_if`` and the norms."""
    jcfg = jconfigs.get_smoke_config(name)
    want = jax.eval_shape(lambda k: jget_bundle(jcfg).init(k)[0],
                          jax.random.PRNGKey(0))
    cfg = configs.get_smoke_config(name)
    b = get_bundle(cfg)
    params = b.init(torch.Generator().manual_seed(0), 'cpu')
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    want = {''.join(f"['{k.key}']" for k in p): a for p, a in flat}
    got = dict(flatten_with_paths(params))
    assert got.keys() == want.keys()
    for path, a in want.items():
        assert tuple(got[path].shape) == a.shape, path
        assert got[path].dtype == getattr(torch, str(a.dtype)), path
    assert b.param_count(params) == sum(int(np.prod(a.shape))
                                        for a in want.values())
    jvals = dict((''.join(f"['{k.key}']" for k in p), np.asarray(a))
                 for p, a in jax.tree_util.tree_flatten_with_path(
                     _jax_params(name))[0])
    fixed = [p for p in got if p.endswith(("['b_dt']", "['a_log']",
                                           "['b_if']", "['scale']",
                                           "['ln']", "['out_norm']",
                                           "['d_skip']", "['b']"))]
    assert any(p.endswith("['b_dt']") or p.endswith("['b_if']")
               for p in fixed)
    for p in fixed:
        if p.endswith("['b_dt']"):
            np.testing.assert_array_equal(got[p].numpy().view(np.int32),
                                          jvals[p].view(np.int32))
        else:
            np.testing.assert_allclose(got[p].numpy(), jvals[p],
                                       rtol=1e-7, atol=0)


# ------------------------------------------------------------ the functions
@pytest.mark.parametrize('carry', [False, True], ids=['zeros', 'state'])
def test_causal_conv_matches_reference(carry):
    rng = np.random.RandomState(0)
    x, w = _randn(rng, 2, 7, 6), _randn(rng, 4, 6)
    st = _randn(rng, 2, 3, 6) if carry else None
    got, gst = recurrent._causal_conv(_t(x), _t(w),
                                      None if st is None else _t(st))
    want, wst = jrec._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                  None if st is None else jnp.asarray(st))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_array_equal(gst.numpy(), _np(wst))


def _mlstm_inputs(rng, b=2, h=2, s=32, dh=8):
    q, k, v = (_randn(rng, b, h, s, dh) for _ in range(3))
    k *= dh ** -0.5
    log_f = np.log(1 / (1 + np.exp(-_randn(rng, b, h, s, scale=2) - 2)))
    log_i = _randn(rng, b, h, s)
    return q, k, v, log_f.astype(np.float32), log_i


@pytest.mark.parametrize('chunk', [4, 8, 16, 32])
@pytest.mark.parametrize('carry', [False, True], ids=['fresh', 'state'])
def test_mlstm_chunkwise_matches_reference(chunk, carry):
    """Every chunk length over S = 32, from the fresh state (m = -1e30)
    and from a carried (C, n, m): y and the final state, no NaN."""
    rng = np.random.RandomState(1)
    q, k, v, lf, li = _mlstm_inputs(rng)
    st = None
    if carry:
        st = (_randn(rng, 2, 2, 8, 8), _randn(rng, 2, 2, 8), _randn(rng, 2, 2))
    y, (c, n, m) = recurrent.mlstm_chunkwise(
        *map(_t, (q, k, v, lf, li)), chunk,
        None if st is None else tuple(map(_t, st)))
    wy, (wc, wn, wm) = jrec.mlstm_chunkwise(
        *map(jnp.asarray, (q, k, v, lf, li)), chunk,
        None if st is None else tuple(map(jnp.asarray, st)))
    assert bool(torch.isfinite(y).all())
    for got, want in ((y, wy), (c, wc), (n, wn), (m, wm)):
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def _slstm_params(rng, h=2, d=16):
    return {'r': _randn(rng, 4, h, d // h, d // h, scale=0.5)}


@pytest.mark.parametrize('backend', BACKENDS)
def test_slstm_scan_is_the_reference_scan_on_every_backend(backend):
    """Every name in the port's ``BACKENDS`` runs the plain per-step scan
    (the reference's hook resolves every backend to its XLA scan): the
    same outputs and final state as the reference's, from the default
    state and from a carried one; an unknown name raises."""
    rng = np.random.RandomState(2)
    p = _slstm_params(rng)
    zx = _randn(rng, 2, 9, 4, 16)
    st = (_randn(rng, 2, 16), np.abs(_randn(rng, 2, 16)) + 0.5,
          _randn(rng, 2, 16), _randn(rng, 2, 16))
    for state in (None, st):
        y, got = recurrent.slstm_scan(
            {'r': _t(p['r'])}, _t(zx),
            None if state is None else tuple(map(_t, state)), 2, backend)
        wy, want = jax.jit(lambda p, zx, st: jrec.slstm_scan(
            p, zx, st, 2, 'auto'))(
            {'r': jnp.asarray(p['r'])}, jnp.asarray(zx),
            None if state is None else tuple(map(jnp.asarray, state)))
        np.testing.assert_allclose(y.numpy(), _np(wy), **TOL)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), _np(w), **TOL)
    with pytest.raises(ValueError, match='lstm_backend'):
        recurrent.slstm_scan({'r': _t(p['r'])}, _t(zx), None, 2,
                             'pallas_seq')


def _layer(params, key, *idx):
    return tree_map(lambda a: a[idx], params[key])


def _jlayer(jparams, key, *idx):
    return jax.tree.map(lambda a: a[idx], jparams[key])


@pytest.mark.parametrize('carry', [False, True], ids=['fresh', 'state'])
def test_mamba_mix_matches_reference(carry):
    """Hymba layer 1's Mamba heads on f32 inputs, from no state and from
    a carried (conv, ssm): the doubling scan against the reference's
    associative scan, the output and both new states."""
    jcfg, jparams, cfg, params = _pair('hymba-1.5b')
    rng = np.random.RandomState(3)
    x = _randn(rng, 2, 21, cfg.d_model)
    st = None
    if carry:
        st = (_randn(rng, 2, cfg.conv_kernel - 1, cfg.d_model),
              _randn(rng, 2, cfg.d_model, cfg.ssm_state))
    y, (cv, sm) = recurrent.mamba_mix(
        cfg, _layer(params, 'blocks', 1)['mamba'], _t(x),
        None if st is None else tuple(map(_t, st)))
    wy, (wcv, wsm) = jax.jit(lambda p, x, st: jrec.mamba_mix(jcfg, p, x, st))(
        _jlayer(jparams, 'blocks', 1)['mamba'], jnp.asarray(x),
        None if st is None else tuple(map(jnp.asarray, st)))
    for got, want in ((y, wy), (cv, wcv), (sm, wsm)):
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_linear_scan_is_the_recurrence():
    """The doubling scan equals h_t = a_t h_{t-1} + b_t step by step, at
    lengths on both sides of a power of two."""
    g = torch.Generator().manual_seed(0)
    for s in (1, 5, 8, 13):
        a = torch.rand(2, s, 3, generator=g, dtype=torch.float64)
        b = torch.randn(2, s, 3, generator=g, dtype=torch.float64)
        h, want = torch.zeros(2, 3, dtype=torch.float64), []
        for t in range(s):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        torch.testing.assert_close(recurrent._linear_scan(a, b),
                                   torch.stack(want, 1))


@pytest.mark.parametrize('block', ['mlstm', 'mlstm-chunk8', 'slstm',
                                   'hymba-global', 'hymba-window'])
def test_blocks_match_reference(block):
    """One block of each kind on f32 activations (S = 24 past the smoke
    window; the mLSTM also in chunks of 8), fresh and then continued from
    its own state for 3 more steps (Hymba's forward block carries only
    the Mamba state)."""
    name = 'hymba-1.5b' if block.startswith('hymba') else 'xlstm-1.3b'
    jcfg, jparams, cfg, params = _pair(name, activation_dtype='float32')
    rng = np.random.RandomState(4)
    x, x2 = _randn(rng, 2, S, cfg.d_model), _randn(rng, 2, 3, cfg.d_model)
    if block.startswith('mlstm'):
        chunk = 8 if block.endswith('8') else 256
        p, jp = _layer(params, 'mlstm', 1, 0), _jlayer(jparams, 'mlstm', 1, 0)
        run = lambda x, st: recurrent.mlstm_block(cfg, p, x, chunk=chunk,
                                                  state=st)
        jrun = lambda x, st: jrec.mlstm_block(jcfg, jp, x, chunk=chunk,
                                              state=st)
    elif block == 'slstm':
        p, jp = _layer(params, 'slstm', 1), _jlayer(jparams, 'slstm', 1)
        run = lambda x, st: recurrent.slstm_block(cfg, p, x, st)
        jrun = lambda x, st: jrec.slstm_block(jcfg, jp, x, st)
    else:
        i = 0 if block.endswith('global') else 1
        assert (i in cfg.global_layer_ids) == block.endswith('global')
        p, jp = _layer(params, 'blocks', i), _jlayer(jparams, 'blocks', i)

        def run(x, st):
            off = 0 if st is None else S
            cs = layers.rope_cos_sin(torch.arange(off, off + x.shape[1]),
                                     cfg.resolved_head_dim, cfg.rope_theta)
            return recurrent.hymba_block(cfg, p, x, cs,
                                         recurrent._window(cfg, i), st)

        def jrun(x, st):
            off = 0 if st is None else S
            out, st, _ = jrec.hymba_block(jcfg, jp, x,
                                          jnp.arange(off, off + x.shape[1]),
                                          i in jcfg.global_layer_ids, st)
            return out, st
    y, st = run(_t(x), None)
    wy, wst = jax.jit(lambda x: jrun(x, None))(jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), _np(wy), **TOL)
    if block.startswith('hymba'):
        return           # no attention cache in the forward block
    y2, st2 = run(_t(x2), st)
    wy2, wst2 = jax.jit(jrun)(jnp.asarray(x2), wst)
    np.testing.assert_allclose(y2.numpy(), _np(wy2), **TOL)
    for g, w in zip(leaves(st2), jax.tree.leaves(wst2)):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)


# ------------------------------------------------------------ model parity
@pytest.fixture(scope='module', params=[(n, a) for n in RECURRENT
                                        for a in ADTYPES],
                ids=lambda p: f'{p[0]}-{p[1]}')
def case(request):
    """Both packages on one smoke config and activation dtype: weights,
    tokens, and the reference's forward and loss (once a module)."""
    name, adtype = request.param
    jcfg, jparams, cfg, params = _pair(name, activation_dtype=adtype)
    tok = _tokens(cfg.vocab_size, shape=(B, S + 1))
    jb = jget_bundle(jcfg)
    batch = {'tokens': jnp.asarray(tok[:, :-1]),
             'labels': jnp.asarray(tok[:, 1:])}
    logits, loss = jax.jit(lambda p, b: (jb.forward(p, b), jb.loss_fn(
        p, b)))(jparams, batch)
    return dict(name=name, adtype=adtype, jcfg=jcfg, jparams=jparams,
                cfg=cfg, params=params, tokens=tok[:, :-1],
                labels=tok[:, 1:], logits=_np(logits), loss=float(loss))


def test_forward_and_loss_match_reference(case):
    cfg, params = case['cfg'], case['params']
    b = get_bundle(cfg)
    batch = {'tokens': _t(case['tokens']).long(),
             'labels': _t(case['labels']).long()}
    got = b.forward(params, batch)
    assert got.shape == (B, S, cfg.vocab_size)
    _close(got.float(), case['logits'], case['adtype'])
    np.testing.assert_allclose(
        float(b.loss_fn(params, batch)), case['loss'],
        rtol=F32_REL if case['adtype'] == 'float32' else BF16_REL)


def _jax_replay(jcfg, jparams, tokens, cache=None, start=0):
    """The reference's bundle ``decode_step`` over ``tokens`` (from an
    empty cache, or ``cache`` at position ``start``): (logits (B, T, V),
    the cache after each step)."""
    jb = jget_bundle(jcfg)
    step = jax.jit(jb.decode_step)
    if cache is None:
        cache, _ = jb.init_cache(tokens.shape[0], MAX_SEQ)
    outs, caches = [], []
    for t in range(tokens.shape[1]):
        logits, cache = step(jparams, cache, jnp.asarray(tokens[:, t:t + 1]),
                             jnp.int32(start + t))
        outs.append(_np(logits[:, 0]))
        caches.append(cache)
    return np.stack(outs, 1), caches


def _replay(cfg, params, tokens, cache=None, start=0):
    """The port's bundle ``decode_step`` over ``tokens``: (logits, the
    final cache)."""
    b = get_bundle(cfg)
    if cache is None:
        cache = b.init_cache(tokens.shape[0], MAX_SEQ, 'cpu')
    tok = _t(tokens).long()
    outs = []
    for t in range(tokens.shape[1]):
        logits, cache = b.decode_step(params, cache, tok[:, t:t + 1],
                                      start + t)
        outs.append(logits[:, 0].float().numpy())
    return np.stack(outs, 1), cache


@pytest.fixture(scope='module')
def replays(case):
    """Both packages' decode replays of the case's tokens (once a case)."""
    want, jcaches = _jax_replay(case['jcfg'], case['jparams'],
                                case['tokens'])
    got, cache = _replay(case['cfg'], case['params'], case['tokens'])
    return dict(want=want, jcaches=jcaches, got=got, cache=cache)


def _port_cache(case, jcache):
    """The reference's cache or state in the port's layout."""
    c = jax.tree.map(np.asarray, jcache)
    if case['name'] == 'xlstm-1.3b':
        return xlstm_state_from_numpy(c, 'cpu')
    return hymba_cache_from_numpy(c, case['cfg'], MAX_SEQ, 'cpu')


def test_decode_replay_matches_reference(case, replays):
    """The bundle's decode_step token by token against the reference's:
    every step's logits and the final state (xLSTM: conv, (C, n, m), the
    sLSTM's (c, n, m, h); Hymba: every layer's rings, rolled by
    ``hymba_cache_from_numpy``, past the window of 16, and conv and ssm),
    in the reference's dtypes (conv promoted to f32 after a step)."""
    _close(replays['got'], replays['want'], case['adtype'])
    want = _port_cache(case, replays['jcaches'][-1])
    got = replays['cache']
    assert [a.dtype for a in leaves(got)] == [a.dtype for a in leaves(want)]
    for g, w in zip(leaves(got), leaves(want)):
        assert g.shape == w.shape
        if case['adtype'] == 'float32':
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                       **DECODE_TOL)
        else:
            assert float((g.float() - w.float()).abs().max()) <= \
                BF16_REL * max(float(w.float().abs().max()), 1e-30)


def test_decode_continues_from_a_converted_cache(case, replays):
    """The reference's cache (or state) after 19 steps, converted (Hymba's
    windowed rings have wrapped), continued by the port's decode for the
    last 5 tokens: the reference's logits at those steps."""
    t0 = 19
    cache = _port_cache(case, replays['jcaches'][t0 - 1])
    got, _ = _replay(case['cfg'], case['params'], case['tokens'][:, t0:],
                     cache=cache, start=t0)
    _close(got, replays['want'][:, t0:], case['adtype'])


@pytest.mark.parametrize('name', RECURRENT)
def test_decode_against_own_forward_and_r5(name):
    """xLSTM: the reference's contract (``tests/test_models.py``) on the
    port, decode == ``forward_xlstm`` within 2e-3 at f32 activations.
    Hymba (R5): the reference's decode is not its forward (no meta token
    reaches its caches or Mamba state), and the port's is not either, by
    the same amount: the port computes what the reference computes."""
    jcfg, jparams, cfg, params = _pair(name, activation_dtype='float32')
    tokens = _tokens(cfg.vocab_size, seed=2)
    dec, _ = _replay(cfg, params, tokens)
    full = get_bundle(cfg).forward(params, {'tokens': _t(tokens).long()})
    if name == 'xlstm-1.3b':
        np.testing.assert_allclose(dec, full.numpy(), **DECODE_TOL)
        return
    jdec, _ = _jax_replay(jcfg, jparams, tokens)
    jfull = _np(jget_bundle(jcfg).forward(jparams,
                                          {'tokens': jnp.asarray(tokens)}))
    gap, jgap = _rel(dec, full.numpy()), _rel(jdec, jfull)
    assert jgap > 0.3, jgap
    assert abs(gap - jgap) <= 1e-3 * jgap
    agree = (jdec.argmax(-1) == jfull.argmax(-1)).mean()
    assert agree < 0.5, agree


# ----------------------------------------------------------- converters
def test_xlstm_state_carries_bit_for_bit():
    """The reference's fresh state (bf16 conv, f32 memories) and its tree
    move across unchanged."""
    jcfg = jconfigs.get_smoke_config('xlstm-1.3b')
    st, _ = jget_bundle(jcfg).init_cache(2, 8)
    st = jax.tree.map(lambda a: a + jnp.asarray(0.5, a.dtype), st)
    got = xlstm_state_from_numpy(jax.tree.map(np.asarray, st), 'cpu')
    own = recurrent.init_xlstm_state(configs.get_smoke_config('xlstm-1.3b'),
                                     2, 'cpu')
    assert [(a.shape, a.dtype) for a in leaves(got)] == [
        (a.shape, a.dtype) for a in leaves(own)]
    for g, w in zip(leaves(got), jax.tree.leaves(st)):
        np.testing.assert_array_equal(g.float().numpy(), _np(w))


def test_hymba_cache_converter_refuses_another_fill():
    """A ``pos`` row that is not the meta-offset ring filled in order (a
    meta slot marked filled) raises."""
    jcfg = jconfigs.get_smoke_config('hymba-1.5b')
    cache, _ = jget_bundle(jcfg).init_cache(1, 8)
    cache = jax.tree.map(np.asarray, cache)
    cache[0]['pos'] = cache[0]['pos'].copy()
    cache[0]['pos'][0] = 0
    with pytest.raises(ValueError, match='meta-offset ring'):
        hymba_cache_from_numpy(cache, configs.get_smoke_config('hymba-1.5b'),
                               8, 'cpu')


# ------------------------------------------------------------- bundles
@pytest.mark.parametrize('name', RECURRENT)
def test_bundle_serves_the_recurrent_families(name):
    """``get_bundle`` gives each family its bundle: ``init`` on the CPU in
    the parameter dtype, ``forward``/``loss_fn`` (the token-mean cross
    entropy of ``forward``), ``init_cache`` of the reference's sizes, and
    ``decode_step``."""
    cfg = configs.get_smoke_config(name)
    b = get_bundle(cfg)
    params = b.init(torch.Generator().manual_seed(0), 'cpu')
    assert all(a.device.type == 'cpu' for a in leaves(params))
    assert all(a.dtype == cfg.dtype() for a in leaves(params))
    tok = torch.from_numpy(_tokens(cfg.vocab_size, shape=(1, 6))).long()
    logits = b.forward(params, {'tokens': tok})
    loss = b.loss_fn(params, {'tokens': tok, 'labels': tok})
    assert float(loss) == pytest.approx(float(layers.softmax_xent(logits,
                                                                  tok)))
    cache = b.init_cache(1, MAX_SEQ, 'cpu')
    jcache, _ = jget_bundle(jconfigs.get_smoke_config(name)).init_cache(
        1, MAX_SEQ)
    nbytes = lambda t: sum(a.numel() * a.element_size() for a in t)
    jbytes = sum(a.size * a.dtype.itemsize for a in jax.tree.leaves(jcache))
    if name == 'xlstm-1.3b':
        assert nbytes(leaves(cache)) == jbytes
    else:      # no pos rows, no meta slots
        assert len(cache) == cfg.n_layers
        assert [c['k'].shape[2] for c in cache] == [
            MAX_SEQ if i in cfg.global_layer_ids else cfg.sliding_window
            for i in range(cfg.n_layers)]
    out, cache = b.decode_step(params, cache, tok[:, :1], 0)
    assert out.shape == (1, 1, cfg.vocab_size)
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize('name', RECURRENT)
def test_slot_server_emits_reference_tokens(name):
    jcfg, jparams, cfg, params = _pair(name, activation_dtype='float32')
    jsrv = jserve.SlotServer(jcfg, jparams, num_slots=2, max_seq=MAX_SEQ)
    srv = serve.SlotServer(cfg, params, num_slots=2, max_seq=MAX_SEQ)
    rng = np.random.RandomState(7)
    reqs = [(rng.randint(1, cfg.vocab_size, size=rng.randint(3, 8)).tolist(),
             int(rng.randint(2, 20))) for _ in range(4)]
    for r, (prompt, n) in enumerate(reqs):
        jsrv.submit(jserve.Request(rid=r, prompt=prompt, max_new=n))
        srv.submit(serve.Request(rid=r, prompt=list(prompt), max_new=n))
    jsrv.drain()
    srv.drain()
    assert {r.rid: r.out for r in srv.done} == {r.rid: r.out
                                                 for r in jsrv.done}
    assert all(len(r.out) == r.max_new for r in srv.done)


@pytest.mark.parametrize('name', RECURRENT)
def test_serve_cli_recurrent_token_path(name, capsys):
    stats = serve.main(['--arch', name, '--smoke', '--device', 'cpu',
                        '--requests', '3', '--slots', '2', '--max-new', '4'])
    out = capsys.readouterr().out
    assert re.search(r'^served 3 requests, 12 tokens in [0-9.]+s '
                     r'\([0-9.]+ tok/s\); p50 latency [0-9.]+s$', out,
                     re.M), out
    assert 'attention auto, K8 launches 0' in out
    assert stats['tokens'] == 12 and stats['k8_launches'] == 0


@pytest.mark.parametrize('shape,want', [
    # Hymba's decode row (B = 1, 25 heads on 5, D 64): a windowed layer's
    # full ring of 1,024 keys, and a global layer at 128 keys
    ((1, 25, 5, 1, 1024, None, 1024, 0), ('split', 80, 16, 64)),
    ((1, 25, 5, 1, 128, None, 128, 0), ('split', 10, 2, 64)),
    # its forward of 128 meta + 64 tokens, and of 128 + 2,048 tokens with
    # the window of 1,024 (f32: 64-row tiles only)
    ((1, 25, 5, 192, 192, None, None, 0), ('tiled', 75, 0, 0)),
    ((1, 25, 5, 2176, 2176, 1024, None, 0), ('tiled', 850, 0, 0)),
])
def test_attention_geometry_at_hymba_shapes(shape, want):
    """K8's launch rule at Hymba's shapes on a 132-SM card (decode: no
    causal mask, kv_len = the ring's filled keys; forward: causal, f32,
    so ``wide`` off): the schedule, CTAs, splits and keys a split; a
    split covers every live key."""
    from repro_torch.kernels.flash_attention import attention_geometry
    Bq, H, Hkv, Sq, Sk, window, kv_len, offset = shape
    causal = kv_len is None
    g = attention_geometry(Bq, H, Hkv, Sq, Sk, window, kv_len, offset, 64,
                           132, causal=causal, wide=False)
    assert (g.path, g.ctas, g.n_splits, g.split_keys) == want
    if g.path == 'split':
        assert (g.key_lo, g.key_hi) == (0, kv_len)
        assert g.n_splits * g.split_keys >= kv_len > (g.n_splits - 1) \
            * g.split_keys
