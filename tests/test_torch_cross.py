"""Parity of the port's cross-attention families (``models.transformer``'s
encoder-decoder and VLM stacks, ``layers.attention_block(..., kv_src=)``,
``layers.cross_attention_decode``, ``convert.lm_cross_kv_from_numpy``) with
the JAX reference, on the CPU, over the whisper-base and
Llama-3.2-Vision-90B smoke configurations (2 + 2 + 2 and 4 + 1 layers,
d_model 64), each with f32 and with bf16 activations.

Weights come from the reference's own init through
``convert.lm_params_from_numpy``; tokens and sources are numpy arrays from
a seed.  Tolerances:
- f32 activations: ``forward_lm``, ``loss_fn`` and ``precompute_cross_kv``
  at rtol = atol = 2e-4 (f32 throughout, sums in other orders); the decode
  replay (logits and the caches) at the reference's own decode-vs-forward
  bound, rtol = atol = 2e-3 (``tests/test_models.py``), against JAX's
  ``decode_step(cross_kv=)`` and against the port's own ``forward_lm``.
- bf16 activations: 3e-2 of the scale (max |value|) of the reference's
  logits, cross K/V or caches: bf16 keeps 8 bits, and the two frameworks
  round at other places (the port's self decode also rounds q to the
  cache's bf16 before K8; whisper's reference scores its f32 q against the
  bf16 cache in f32).
- a source of F = 37 frames, which the reference pads to its
  ``attn_chunk`` (16 here) and masks, and the port does not pad: f32
  bounds as above.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import get_bundle as jget_bundle  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (lm_cache_from_numpy,  # noqa: E402
                                 lm_cross_kv_from_numpy,
                                 lm_params_from_numpy)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_bundle, layers  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.tree import flatten_with_paths, leaves, tree_map  # noqa: E402

CROSS = ['whisper-base', 'llama-3.2-vision-90b']
ADTYPES = ['float32', 'bfloat16']
IGNORED_FIELDS = ('use_pallas', 'scan_layers', 'attn_chunk',
                  'lstm_backend')
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
BF16_REL = 3e-2
B, S = 2, 8


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    """The reference's weights of ``name``'s smoke config (key 0; jitted,
    and drawn once a module: the activation dtype and ``attn_chunk`` do
    not enter them)."""
    jcfg = jconfigs.get_smoke_config(name)
    return jax.jit(lambda k: jget_bundle(jcfg).init(k)[0])(
        jax.random.PRNGKey(0))


def _pair(name, **kw):
    """(JAX cfg, JAX params, port cfg, port params on the CPU) of ``name``'s
    smoke configuration with ``kw`` replaced (``attn_chunk`` only on the
    reference's, which the port does not have)."""
    jcfg = jconfigs.get_smoke_config(name).replace(**kw)
    jparams = _jax_params(name)
    kw.pop('attn_chunk', None)
    cfg = configs.get_smoke_config(name).replace(**kw)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), 'cpu')
    return jcfg, jparams, cfg, params


def _inputs(cfg, seed, frames=None):
    """(tokens (B, S) int32, labels, source (B, F, d) f32) from a seed."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    src = rng.randn(B, frames or cfg.n_source_tokens,
                    cfg.d_model).astype(np.float32)
    return tok[:, :-1], tok[:, 1:], src


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _jax_replay(jcfg, jparams, tokens, source):
    """The reference's precompute_cross_kv and decode_step(cross_kv=) over
    ``tokens`` from an empty cache: (logits (B, T, V), final cache, the
    cross K/V)."""
    kv = jtransformer.precompute_cross_kv(jcfg, jparams, jnp.asarray(source))
    step = jax.jit(lambda p, c, t, pos, kv: jtransformer.decode_step(
        jcfg, p, c, t, pos, cross_kv=kv))
    cache, _ = jget_bundle(jcfg).init_cache(tokens.shape[0], tokens.shape[1])
    outs = []
    for t in range(tokens.shape[1]):
        logits, cache = step(jparams, cache, jnp.asarray(tokens[:, t:t + 1]),
                             jnp.int32(t), kv)
        outs.append(_np(logits[:, 0]))
    return np.stack(outs, 1), cache, kv


def _replay(cfg, params, tokens, source):
    """The port's precompute_cross_kv and decode_step(cross_kv=) over
    ``tokens`` from an empty cache: (logits, final cache, cross K/V)."""
    kv = transformer.precompute_cross_kv(cfg, params,
                                         torch.from_numpy(source))
    cache = transformer.init_cache(cfg, tokens.shape[0], tokens.shape[1],
                                   'cpu')
    tok = torch.from_numpy(tokens)
    outs = []
    for t in range(tokens.shape[1]):
        logits, cache = transformer.decode_step(cfg, params, cache,
                                                tok[:, t:t + 1], t,
                                                cross_kv=kv)
        outs.append(logits[:, 0].float().numpy())
    return np.stack(outs, 1), cache, kv


def _close(got, want, adtype, tol):
    """f32: ``tol``; bf16: within ``BF16_REL`` of the reference's scale."""
    got, want = _np(got), _np(want)
    if adtype == 'float32':
        np.testing.assert_allclose(got, want, **tol)
    else:
        assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


@pytest.fixture(scope='module', params=[(n, a) for n in CROSS
                                        for a in ADTYPES],
                ids=lambda p: f'{p[0]}-{p[1]}')
def case(request):
    """Both packages on one smoke config and activation dtype: weights,
    inputs, and the reference's forward, loss and decode replay (computed
    once a module)."""
    name, adtype = request.param
    jcfg, jparams, cfg, params = _pair(name, activation_dtype=adtype)
    tokens, labels, source = _inputs(cfg, 1)
    jb = jget_bundle(jcfg)
    batch = {'tokens': jnp.asarray(tokens), 'labels': jnp.asarray(labels),
             'source': jnp.asarray(source)}
    logits, loss = jax.jit(lambda p, b: (jb.forward(p, b), jb.loss_fn(
        p, b)))(jparams, batch)
    want = dict(logits=_np(logits), loss=float(loss))
    want['decode'], want['cache'], want['kv'] = _jax_replay(
        jcfg, jparams, tokens, source)
    return dict(adtype=adtype, cfg=cfg, params=params, tokens=tokens,
                labels=labels, source=source, want=want)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize('name', CROSS)
def test_configs_match_reference(name):
    """CONFIG and SMOKE copied across, field for field but those the port
    leaves out (``configs`` docstring); dtypes as torch dtypes."""
    for get, jget in ((configs.get_config, jconfigs.get_config),
                      (configs.get_smoke_config, jconfigs.get_smoke_config)):
        cfg, jcfg = get(name), jget(name)
        for f in jcfg.__dataclass_fields__:
            if f not in IGNORED_FIELDS:
                assert getattr(cfg, f) == getattr(jcfg, f), (name, f)
        assert cfg.resolved_head_dim == jcfg.resolved_head_dim
        assert cfg.dtype() == getattr(torch, str(jcfg.dtype()))
        assert cfg.adtype() == getattr(torch, str(jcfg.adtype()))


@pytest.mark.parametrize('name', CROSS)
def test_init_matches_reference_shapes_and_cross_blocks_are_bare(name):
    """``init_lm``'s tree, shapes and dtypes equal the reference's (the
    VLM's ``blocks`` over (groups, per - 1) and its ``cross``; whisper's
    ``enc_blocks``, ``enc_cross`` and ``enc_norm``), with qkv_bias and
    qk_norm switched on: the self blocks hold them, the cross blocks hold
    neither; and the bundle's parameter count is the reference's."""
    kw = dict(qkv_bias=True, qk_norm=True)
    jcfg = jconfigs.get_smoke_config(name).replace(**kw)
    want = jax.eval_shape(lambda k: jget_bundle(jcfg).init(k)[0],
                          jax.random.PRNGKey(0))
    cfg = configs.get_smoke_config(name).replace(**kw)
    params = get_bundle(cfg).init(torch.Generator().manual_seed(0), 'cpu')
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    want = {''.join(f"['{k.key}']" for k in path): a for path, a in flat}
    got = dict(flatten_with_paths(params))
    assert got.keys() == want.keys()
    for path, a in want.items():
        assert tuple(got[path].shape) == a.shape, path
        assert got[path].dtype == getattr(torch, str(a.dtype)), path
    cross = 'cross' if cfg.cross_attn_every else 'enc_cross'
    self_attn = [p for p in got if p.startswith("['blocks']['attn']")]
    cross_attn = [p for p in got if p.startswith(f"['{cross}']['attn']")]
    assert any(p.endswith("['bq']") for p in self_attn)
    assert any(p.endswith("['q_norm']") for p in self_attn)
    assert sorted(p.split("['attn']")[1] for p in cross_attn) == [
        "['wk']", "['wo']", "['wq']", "['wv']"]
    n = sum(int(np.prod(a.shape)) for a in want.values())
    assert get_bundle(cfg).param_count(params) == n


def test_stack_init_draws_one_layer_at_a_time_in_row_major_order():
    """A nested stack (2, 3) holds the six draws of ``init_fn`` in order,
    as six separate draws would; a one-draw stack is a view of its draw."""
    g = torch.Generator().manual_seed(0)
    draw = lambda: {'w': torch.randn(4, generator=g)}
    stack = transformer._stack_init(draw, (2, 3))
    g.manual_seed(0)
    want = torch.stack([draw()['w'] for _ in range(6)]).reshape(2, 3, 4)
    assert torch.equal(stack['w'], want)
    one = transformer._stack_init(draw, (1, 1))
    assert one['w'].shape == (1, 1, 4)


# ------------------------------------------------------------ model parity
def test_forward_and_loss_match_reference(case):
    cfg, params, want = case['cfg'], case['params'], case['want']
    b = get_bundle(cfg)
    batch = {'tokens': torch.from_numpy(case['tokens']),
             'labels': torch.from_numpy(case['labels']),
             'source': torch.from_numpy(case['source'])}
    got = b.forward(params, batch)
    assert got.shape == (B, S, cfg.vocab_size)
    _close(got.float(), want['logits'], case['adtype'], FWD_TOL)
    np.testing.assert_allclose(float(b.loss_fn(params, batch)), want['loss'],
                               **(FWD_TOL if case['adtype'] == 'float32'
                                  else dict(rtol=BF16_REL)))


def test_precompute_cross_kv_matches_reference(case):
    """The port's cross K/V: (cross layers, B, Hkv, F, hd), contiguous, in
    q's dtype (f32 here: the smoke configs' f32 parameters promote), equal
    to the reference's after ``lm_cross_kv_from_numpy``."""
    cfg, params = case['cfg'], case['params']
    kv = transformer.precompute_cross_kv(cfg, params,
                                         torch.from_numpy(case['source']))
    want = lm_cross_kv_from_numpy(jax.tree.map(np.asarray,
                                               case['want']['kv']), 'cpu')
    n = cfg.n_layers // cfg.cross_attn_every if cfg.cross_attn_every \
        else cfg.n_layers
    for name in ('k', 'v'):
        assert kv[name].shape == (n, B, cfg.n_kv_heads,
                                  case['source'].shape[1],
                                  cfg.resolved_head_dim)
        assert kv[name].is_contiguous() and kv[name][0].is_contiguous()
        assert kv[name].dtype == want[name].dtype == torch.float32
        _close(kv[name], want[name], case['adtype'], FWD_TOL)


def test_decode_replay_matches_reference(case):
    """``decode_step(cross_kv=)`` token by token against the reference's:
    every step's logits, and the self layers' caches after
    ``lm_cache_from_numpy`` (the VLM's cache holds its self layers
    only)."""
    cfg, params, want = case['cfg'], case['params'], case['want']
    got, cache, _ = _replay(cfg, params, case['tokens'], case['source'])
    _close(got, want['decode'], case['adtype'], DECODE_TOL)
    jcache = lm_cache_from_numpy(jax.tree.map(np.asarray, want['cache']),
                                 'cpu')
    for n in ('k', 'v'):
        assert cache[n].shape == (transformer.n_self_layers(cfg), B,
                                  cfg.n_kv_heads, S, cfg.resolved_head_dim)
        assert cache[n].dtype == cfg.adtype()
        _close(cache[n].float(), jcache[n].float(), case['adtype'],
               DECODE_TOL)


@pytest.mark.parametrize('name', CROSS)
def test_decode_matches_own_forward_at_f32(name):
    """The reference's contract (``tests/test_models.py``) on the port
    alone: decode through precompute_cross_kv + decode_step(cross_kv=)
    equals ``forward_lm(tokens, source)`` within 2e-3 at f32
    activations."""
    _, _, cfg, params = _pair(name, activation_dtype='float32')
    tokens, _, source = _inputs(cfg, 2)
    dec, _, _ = _replay(cfg, params, tokens, source)
    full, _ = transformer.forward_lm(cfg, params, torch.from_numpy(tokens),
                                     torch.from_numpy(source))
    np.testing.assert_allclose(dec, full.numpy(), **DECODE_TOL)


@pytest.mark.parametrize('name', CROSS)
def test_ragged_source_equals_reference_padded_path(name):
    """F = 37 frames: the reference (``attn_chunk`` 16) pads the keys of
    every cross attention (and whisper's encoder) to 48 and masks the
    padding with kv_len; the port attends to the 37 keys as they are.
    Forward and a 3-step decode replay agree at f32."""
    F = 37
    jcfg, jparams, cfg, params = _pair(name, activation_dtype='float32',
                                       attn_chunk=16)
    tokens, _, source = _inputs(cfg, 3, frames=F)
    tokens = tokens[:, :3]
    want = _np(jget_bundle(jcfg).forward(
        jparams, {'tokens': jnp.asarray(tokens),
                  'source': jnp.asarray(source)}))
    got, _ = transformer.forward_lm(cfg, params, torch.from_numpy(tokens),
                                    torch.from_numpy(source))
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    jdec, _, _ = _jax_replay(jcfg, jparams, tokens, source)
    dec, _, kv = _replay(cfg, params, tokens, source)
    assert kv['k'].shape[3] == F
    np.testing.assert_allclose(dec, jdec, **DECODE_TOL)


# ----------------------------------------------------------- cross details
def test_cross_kv_carries_bit_for_bit():
    """``lm_cross_kv_from_numpy`` moves the reference's (n, B, F, Hkv, hd)
    tuple into the port's (n, B, Hkv, F, hd), bf16 patterns unchanged."""
    rng = np.random.RandomState(0)
    k, v = (jnp.asarray(rng.randn(3, 2, 5, 4, 8), jnp.bfloat16)
            for _ in range(2))
    got = lm_cross_kv_from_numpy(jax.tree.map(np.asarray, (k, v)), 'cpu')
    for n, a in (('k', k), ('v', v)):
        assert got[n].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got[n].view(torch.int16).numpy(),
            np.swapaxes(np.asarray(a).view(np.int16), 2, 3))


def test_cross_layers_refuse_mismatched_dtypes_and_missing_inputs():
    """K8 takes one dtype: a cross decode whose q and cross K/V differ
    raises; a cross config's forward without a source and decode without
    cross_kv raise naming the config, and a dense config refuses a
    source."""
    _, _, cfg, params = _pair('whisper-base')
    xblk = tree_map(lambda a: a[0], params['enc_cross'])
    x = torch.zeros(1, 1, cfg.d_model)
    kv = {n: torch.zeros(1, cfg.n_kv_heads, 5, cfg.resolved_head_dim,
                         dtype=torch.bfloat16) for n in ('k', 'v')}
    with pytest.raises(ValueError, match='one dtype'):
        layers.cross_attention_decode(cfg, xblk['attn'], x, kv)
    tokens = torch.zeros(1, 2, dtype=torch.long)
    with pytest.raises(ValueError, match='whisper-smoke needs a source'):
        transformer.forward_lm(cfg, params, tokens)
    cache = transformer.init_cache(cfg, 1, 4, 'cpu')
    with pytest.raises(ValueError, match='whisper-smoke needs cross_kv'):
        transformer.decode_step(cfg, params, cache, tokens[:, :1], 0)
    dense = configs.get_smoke_config('qwen3-14b')
    with pytest.raises(NotImplementedError, match='no cross attention'):
        transformer.forward_lm(dense, None, tokens,
                               source=torch.zeros(1, 3, dense.d_model))
    assert transformer.precompute_cross_kv(dense, None, None) is None


@pytest.mark.parametrize('name', CROSS)
def test_slot_server_refuses_cross_configs_as_the_reference_fails(name):
    """R4: the reference's ``SlotServer`` calls ``decode_step`` without
    ``cross_kv`` and fails on the cross layers; the port's refuses such a
    config by name before it allocates anything."""
    jcfg, jparams, cfg, params = _pair(name, activation_dtype='float32')
    jsrv = jserve.SlotServer(jcfg, jparams, num_slots=1, max_seq=8)
    jsrv.submit(jserve.Request(rid=0, prompt=[1, 2], max_new=2))
    with pytest.raises(TypeError, match='not subscriptable'):
        jsrv.drain()
    with pytest.raises(NotImplementedError, match='R4'):
        serve.SlotServer(cfg, params, num_slots=1, max_seq=8)


def test_serve_cli_refuses_whisper_before_init(monkeypatch):
    """``serve --arch whisper-base --smoke --device cpu`` raises R4's error
    before any weight is drawn."""
    def no_init(*a, **kw):
        raise AssertionError('init_lm called')

    monkeypatch.setattr(transformer, 'init_lm', no_init)
    with pytest.raises(NotImplementedError, match='R4'):
        serve.main(['--arch', 'whisper-base', '--smoke', '--device', 'cpu'])


@pytest.mark.parametrize('name', CROSS)
def test_bundle_serves_cross_families(name):
    """``get_bundle`` gives the cross families the LM bundle; its
    ``decode_step`` takes ``cross_kv`` by keyword, and every leaf of its
    own init is on the CPU in the parameter dtype."""
    cfg = configs.get_smoke_config(name)
    b = get_bundle(cfg)
    params = b.init(torch.Generator().manual_seed(0), 'cpu')
    assert all(a.dtype == cfg.dtype() for a in leaves(params))
    src = torch.randn(1, 5, cfg.d_model, generator=torch.Generator())
    kv = transformer.precompute_cross_kv(cfg, params, src)
    logits, _ = b.decode_step(params, b.init_cache(1, 4, 'cpu'),
                              torch.ones(1, 1, dtype=torch.long), 0,
                              cross_kv=kv)
    assert logits.shape == (1, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize('shape,want', [
    # whisper's cross decode: 8 splits of 192 keys, the last 156 (a tail
    # of 28 past 23 tiles of 64)
    ((4, 8, 8, 1, 1500, 64), ('split', 256, 8, 192)),
    # whisper's encoder (1500 x 1500, not causal) and its cross prefill
    ((4, 8, 8, 1500, 1500, 64), ('tiled', 768, 0, 0)),
    ((4, 8, 8, 64, 1500, 64), ('tiled', 32, 0, 0)),
    # Llama-3.2-Vision's cross decode at the served B (B x H fills the
    # card: tiled) and at B = 1 (split), and its cross prefill
    ((4, 64, 8, 1, 1024, 128), ('tiled', 256, 0, 0)),
    ((1, 64, 8, 1, 1024, 128), ('split', 128, 16, 64)),
    ((4, 64, 8, 64, 1024, 128), ('tiled', 256, 0, 0)),
])
def test_attention_geometry_at_the_cross_shapes(shape, want):
    """K8's launch rule at the cross families' shapes on a 132-SM card
    (non-causal, no kv_len, offset 0): the schedule, CTAs, splits and
    keys a split; a split covers every key."""
    from repro_torch.kernels.flash_attention import attention_geometry
    B, H, Hkv, Sq, Sk, D = shape
    g = attention_geometry(B, H, Hkv, Sq, Sk, None, None, 0, D, 132,
                           causal=False, wide=D == 128)
    assert (g.path, g.ctas, g.n_splits, g.split_keys) == want
    if g.path == 'split':
        assert (g.key_lo, g.key_hi) == (0, Sk)
        assert g.n_splits * g.split_keys >= Sk > (g.n_splits - 1) \
            * g.split_keys
