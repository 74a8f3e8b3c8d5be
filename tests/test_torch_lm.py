"""Parity of the port's dense LM (``models.layers``, ``models.transformer``,
``models.registry``) and its token server (``launch.serve.SlotServer``) with
the JAX reference, on the CPU, over the four dense smoke configurations
(two layers, d_model 64).

Weights come from the reference's own init through
``convert.lm_params_from_numpy``; tokens are numpy arrays from a seed.
Tolerances:
- ``forward_lm`` and ``loss_fn`` with f32 activations: rtol = atol = 2e-4
  (f32 throughout; the port's attention normalises before its P·V product,
  the reference's after, and XLA and PyTorch sum in other orders).
- decode replay: the reference's own decode-vs-forward bound, rtol = atol
  = 2e-3 (``tests/test_models.py``), against JAX's ``decode_step`` and
  against the port's ``forward_lm``.
- bf16 activations: 3e-2 of the logit scale (max |logit|): bf16 keeps 8
  bits, and the two frameworks round at other places (the port also rounds
  q to the cache's dtype before the decode attention).
- the port's and the reference's ``SlotServer`` emit identical greedy
  tokens (f32 activations): symbols, no tolerance.
"""
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import get_bundle as jget_bundle  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (lm_cache_from_numpy,  # noqa: E402
                                 lm_params_from_numpy)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_bundle, layers  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

DENSE = ['qwen3-14b', 'qwen2.5-14b', 'codeqwen1.5-7b', 'minicpm-2b']
IGNORED_FIELDS = ('use_pallas', 'scan_layers', 'attn_chunk',
                  'lstm_backend')
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
BF16_REL = 3e-2
B, S = 2, 12


def _pair(name, **kw):
    """(JAX cfg, JAX params, port cfg, port params on the CPU) of ``name``'s
    smoke configuration with ``kw`` replaced."""
    jcfg = jconfigs.get_smoke_config(name).replace(**kw)
    jparams, _ = jget_bundle(jcfg).init(jax.random.PRNGKey(0))
    cfg = configs.get_smoke_config(name).replace(**kw)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), 'cpu')
    return jcfg, jparams, cfg, params


@pytest.fixture(scope='module', params=DENSE)
def f32_pair(request):
    return _pair(request.param, activation_dtype='float32')


def _tokens(vocab, seed=1, shape=(B, S)):
    return np.random.RandomState(seed).randint(0, vocab, size=shape
                                               ).astype(np.int32)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _jax_replay(jcfg, jparams, tokens):
    """JAX's decode_step over ``tokens`` from an empty cache:
    (logits (B, T, V), final cache)."""
    step = jax.jit(jget_bundle(jcfg).decode_step)
    cache, _ = jget_bundle(jcfg).init_cache(tokens.shape[0], tokens.shape[1])
    outs = []
    for t in range(tokens.shape[1]):
        logits, cache = step(jparams, cache, jnp.asarray(tokens[:, t:t + 1]),
                             jnp.int32(t))
        outs.append(_np(logits[:, 0]))
    return np.stack(outs, 1), cache


def _replay(cfg, params, tokens):
    """The port's decode_step over ``tokens`` from an empty cache."""
    cache = transformer.init_cache(cfg, tokens.shape[0], tokens.shape[1],
                                   'cpu')
    tok = torch.from_numpy(tokens)
    outs = []
    for t in range(tokens.shape[1]):
        logits, cache = transformer.decode_step(cfg, params, cache,
                                                tok[:, t:t + 1], t)
        outs.append(logits[:, 0].float().numpy())
    return np.stack(outs, 1), cache


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize('name', DENSE + ['chipmunk-ctc'])
def test_configs_match_reference(name):
    """CONFIG and SMOKE copied across: every field the reference has
    equal, but those the port leaves out (``use_pallas``, whose place
    ``attn_backend`` takes, and ``scan_layers`` and ``attn_chunk``, which
    nothing of the port reads) and the backend names, which are the
    port's; dtypes as torch dtypes."""
    for get, jget in ((configs.get_config, jconfigs.get_config),
                      (configs.get_smoke_config, jconfigs.get_smoke_config)):
        cfg, jcfg = get(name), jget(name)
        for f in jcfg.__dataclass_fields__:
            if f not in IGNORED_FIELDS:
                assert getattr(cfg, f) == getattr(jcfg, f), (name, f)
        assert cfg.resolved_head_dim == jcfg.resolved_head_dim
        assert cfg.dtype() == getattr(torch, str(jcfg.dtype()))
        assert cfg.adtype() == getattr(torch, str(jcfg.adtype()))


# ------------------------------------------------------------ model parity
def test_forward_and_loss_match_reference(f32_pair):
    jcfg, jparams, cfg, params = f32_pair
    tokens, labels = _tokens(cfg.vocab_size), _tokens(cfg.vocab_size, 2)
    jb, b = jget_bundle(jcfg), get_bundle(cfg)
    want = _np(jb.forward(jparams, {'tokens': jnp.asarray(tokens)}))
    got = b.forward(params, {'tokens': torch.from_numpy(tokens)})
    assert got.shape == (B, S, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    jloss = float(jb.loss_fn(jparams, {'tokens': jnp.asarray(tokens),
                                       'labels': jnp.asarray(labels)}))
    loss = float(b.loss_fn(params, {'tokens': torch.from_numpy(tokens),
                                    'labels': torch.from_numpy(labels)}))
    np.testing.assert_allclose(loss, jloss, **FWD_TOL)


def test_decode_replay_matches_reference_and_forward(f32_pair):
    jcfg, jparams, cfg, params = f32_pair
    tokens = _tokens(cfg.vocab_size, 3)
    want, jcache = _jax_replay(jcfg, jparams, tokens)
    got, cache = _replay(cfg, params, tokens)
    np.testing.assert_allclose(got, want, **DECODE_TOL)
    full, _ = transformer.forward_lm(cfg, params, torch.from_numpy(tokens))
    np.testing.assert_allclose(got, full.numpy(), **DECODE_TOL)
    # the caches hold the same rows, in the port's layout
    jcache = lm_cache_from_numpy(jax.tree.map(np.asarray, jcache), 'cpu')
    for n in ('k', 'v'):
        assert cache[n].shape == (cfg.n_layers, B, cfg.n_kv_heads, S,
                                  cfg.resolved_head_dim)
        np.testing.assert_allclose(cache[n].numpy(), jcache[n].numpy(),
                                   **DECODE_TOL)


@pytest.mark.parametrize('name', ['qwen3-14b', 'minicpm-2b'])
def test_bf16_activations_match_reference(name):
    """The smoke configs' own activation dtype (bf16, f32 parameters):
    forward and decode within 3e-2 of the logit scale."""
    jcfg, jparams, cfg, params = _pair(name)
    assert cfg.adtype() == torch.bfloat16
    tokens = _tokens(cfg.vocab_size, 4)
    want = _np(jget_bundle(jcfg).forward(jparams,
                                         {'tokens': jnp.asarray(tokens)}))
    got, _ = transformer.forward_lm(cfg, params, torch.from_numpy(tokens))
    scale = np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= BF16_REL * scale
    jdec, _ = _jax_replay(jcfg, jparams, tokens)
    dec, cache = _replay(cfg, params, tokens)
    assert cache['k'].dtype == torch.bfloat16
    assert np.abs(dec - jdec).max() <= BF16_REL * scale


# ------------------------------------------------------------- attention
def test_attention_backends_on_cpu(f32_pair):
    """``torch`` and ``auto`` both run the plain version on CPU tensors
    (bit-equal), and an unknown name raises."""
    _, _, cfg, params = f32_pair
    tokens = torch.from_numpy(_tokens(cfg.vocab_size, 5))
    auto, _ = transformer.forward_lm(cfg, params, tokens)
    plain, _ = transformer.forward_lm(cfg.replace(attn_backend='torch'),
                                      params, tokens)
    assert torch.equal(auto, plain)
    with pytest.raises(ValueError):
        transformer.forward_lm(cfg.replace(attn_backend='pallas'), params,
                               tokens)


def test_ring_caches_and_other_families_raise():
    """A sliding window gives a ring of its width (``test_torch_moe.py``
    holds it to the reference); a ring wider than the window still raises,
    as does a cross-attention stack's decode without its cross K/V
    (``test_torch_cross.py`` holds those stacks to the reference)."""
    cfg = configs.get_smoke_config('qwen3-14b')
    ring = transformer.init_cache(cfg.replace(sliding_window=16), 1, 32,
                                  'cpu')
    assert ring['k'].shape[3] == 16
    wide = transformer.init_cache(cfg, 1, 32, 'cpu')
    with pytest.raises(ValueError, match='wider than the window'):
        layers.attention_decode(cfg, {}, None,
                                {'k': wide['k'][0], 'v': wide['v'][0]},
                                pos=0, cos_sin=None, window=16)
    for kw in (dict(cross_attn_every=2), dict(n_encoder_layers=2)):
        c = cfg.replace(**kw)
        params = transformer.init_lm(c, torch.Generator(), 'cpu')
        cache = transformer.init_cache(c, 1, 8, 'cpu')
        with pytest.raises(ValueError, match='needs cross_kv'):
            transformer.decode_step(c, params, cache,
                                    torch.zeros(1, 1, dtype=torch.long), 0)


def test_get_bundle_refuses_the_lstm():
    """The CTC LSTM's bundle is ``models.chipmunk_net``'s (the dry run
    takes every family through ``get_bundle``): its loss is
    ``chipmunk_net.loss_fn``, its cache the per-layer (h, c), and its
    axes tree matches its parameters leaf for leaf."""
    from repro_torch import sharding
    from repro_torch.models import chipmunk_net
    cfg = configs.get_smoke_config('chipmunk-ctc')
    b = get_bundle(cfg)
    params = b.init(torch.Generator().manual_seed(0), 'cpu')
    assert b.loss_fn.func is chipmunk_net.loss_fn
    assert len(b.init_cache(2, 8, 'cpu')) == cfg.n_layers
    assert len(sharding.axes_leaves(b.param_axes(cfg))) == len(
        leaves(params))
    assert b.param_count(params) == b.active_param_count(params)


def test_param_count_matches_reference():
    jcfg, jparams, cfg, params = _pair('qwen3-14b')
    jb, b = jget_bundle(jcfg), get_bundle(cfg)
    assert b.param_count(params) == jb.param_count(jparams)
    own = b.init(torch.Generator().manual_seed(0), 'cpu')
    assert b.param_count(own) == jb.param_count(jparams)
    assert all(a.dtype == torch.float32 for a in leaves(own))


def test_bf16_leaves_carry_bit_for_bit():
    jcfg = jconfigs.get_smoke_config('qwen3-14b').replace(
        param_dtype='bfloat16')
    jparams, _ = jget_bundle(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    params = lm_params_from_numpy(tree, 'cpu')
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert flat
    for path, a in flat:
        t = params
        for k in path:
            t = t[k.key]
        assert t.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))


def test_init_is_truncated_fan_in_and_stacked():
    cfg = configs.get_smoke_config('qwen3-14b')
    a = transformer.init_lm(cfg, torch.Generator().manual_seed(0), 'cpu')
    b = transformer.init_lm(cfg, torch.Generator().manual_seed(0), 'cpu')
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    wq = a['blocks']['attn']['wq']
    assert wq.shape == (cfg.n_layers, cfg.d_model, cfg.n_heads,
                        cfg.resolved_head_dim)
    assert float(wq.abs().max()) <= 2 * cfg.d_model ** -0.5 + 1e-7
    assert not torch.equal(wq[0], wq[1])
    with pytest.raises(ValueError):
        transformer.init_lm(cfg, torch.Generator(), 'meta')


# ---------------------------------------------------------------- serving
def _requests(req_cls, vocab, n=5):
    rng = np.random.RandomState(7)
    return [req_cls(rid=r, prompt=rng.randint(1, vocab, size=rng.randint(
        3, 8)).tolist(), max_new=int(rng.randint(2, 7))) for r in range(n)]


@pytest.mark.parametrize('name', ['qwen3-14b', 'qwen2.5-14b'])
def test_slot_server_emits_reference_tokens(name):
    jcfg, jparams, cfg, params = _pair(name, activation_dtype='float32')
    jsrv = jserve.SlotServer(jcfg, jparams, num_slots=2, max_seq=32)
    srv = serve.SlotServer(cfg, params, num_slots=2, max_seq=32)
    for r in _requests(jserve.Request, cfg.vocab_size):
        jsrv.submit(r)
    for r in _requests(serve.Request, cfg.vocab_size):
        srv.submit(r)
    jsrv.drain()
    srv.drain()
    want = {r.rid: r.out for r in jsrv.done}
    got = {r.rid: r.out for r in srv.done}
    assert got == want
    assert all(len(r.out) == r.max_new for r in srv.done)


def test_serve_cli_token_path(capsys):
    stats = serve.main(['--arch', 'qwen3-14b', '--smoke', '--device', 'cpu',
                        '--requests', '3', '--slots', '2', '--max-new', '4'])
    out = capsys.readouterr().out
    assert re.search(r'^served 3 requests, 12 tokens in [0-9.]+s '
                     r'\([0-9.]+ tok/s\); p50 latency [0-9.]+s$', out,
                     re.M), out
    assert 'attention auto, K8 launches 0' in out
    assert stats['tokens'] == 12 and stats['k8_launches'] == 0
    assert serve.build_parser().parse_args([]).max_new == 8
