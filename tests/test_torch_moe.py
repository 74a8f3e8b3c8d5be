"""Parity of the port's MoE family (``models.layers`` ``init_moe``,
``moe_route``/``moe_block``, ``moe_block_global``, ``_moe_group_count``;
the ring KV cache of ``transformer.init_cache`` and
``layers.attention_decode``; ``forward_lm``/``loss_fn`` with the aux loss,
``decode_step`` and ``launch.serve.SlotServer``) with the JAX reference,
on the CPU, over the two MoE smoke configurations (Mixtral 8x22B's and
Kimi-K2's: two layers, d_model 64, 4 or 8 experts, top-2).

Weights come from the reference's own init through
``convert.lm_params_from_numpy``; inputs are numpy arrays from a seed.
Tolerances:
- routes (top-k experts, keep masks, slots): equal, as symbols.
- ``moe_block`` and ``moe_block_global`` outputs and aux losses, f32
  parameters: rtol = atol = 1e-5 (f32 products summed in other orders);
  ``moe_block_global`` under bf16 activations scatters its pair outputs
  into bf16 before the gate sum (and XLA's fusion under ``jit`` moves
  that rounding), so there max |error| <= 2**-7 of the output's scale
  (max |output|): one bf16 rounding of the summed terms.
- ``forward_lm`` and ``loss_fn`` with f32 activations: rtol = atol = 2e-4,
  the dense family's (``tests/test_torch_lm.py``); decode replay and ring
  decode: rtol = atol = 2e-3, the reference's own decode bound
  (``tests/test_models.py``); bf16 activations: 3e-2 of the logit scale.
- ``SlotServer`` greedy tokens: identical (f32 activations).
"""
import dataclasses
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
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (lm_cache_from_numpy,  # noqa: E402
                                 lm_params_from_numpy, ring_fill)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_bundle, layers  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

MOE = ['mixtral-8x22b', 'kimi-k2-1t-a32b']
IGNORED_FIELDS = ('use_pallas', 'scan_layers', 'attn_chunk', 'lstm_backend',
                  'moe')
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ROUND_REL = 2.0 ** -7
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
BF16_REL = 3e-2
# name -> (B, S) of the moe_block cases: Kimi's smoke drops pairs at
# (2, 12), a decode row, two token groups at (2, 4096), and (2, 12) with
# router column 0 scaled up under positive inputs, so every token picks
# expert 0 and most of its pairs overflow
CASES = {'drop': (2, 12), 'decode': (1, 1), 'groups': (2, 4096),
         'overflow': (2, 12)}


@functools.lru_cache(maxsize=None)
def _pair(name, **kw):
    """(JAX cfg, JAX params, port cfg, port params on the CPU) of ``name``'s
    smoke configuration with ``kw`` replaced."""
    jcfg = jconfigs.get_smoke_config(name).replace(**kw)
    jparams, _ = jget_bundle(jcfg).init(jax.random.PRNGKey(0))
    cfg = configs.get_smoke_config(name).replace(**kw)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), 'cpu')
    return jcfg, jparams, cfg, params


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _tokens(vocab, seed=1, shape=(2, 12)):
    return np.random.RandomState(seed).randint(0, vocab, size=shape
                                               ).astype(np.int32)


def _moe_inputs(name, case, dtype):
    """Layer 0's MoE parameters (JAX's, the port's) and x (B, S, d) of
    ``case`` in ``dtype``, the same values on both sides."""
    jcfg, jparams, cfg, params = _pair(name)
    jp = jax.tree.map(lambda a: np.array(a[0]), jparams['blocks']['moe'])
    rng = np.random.RandomState(len(case) + 7)
    x = rng.randn(*CASES[case], cfg.d_model).astype(np.float32)
    if case == 'overflow':
        jp['router'][:, 0] = 30.0 * np.abs(jp['router'][:, 0])
        x = np.abs(x)
    p = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(_np(jx).copy()).to(getattr(torch,
                                                     jnp.dtype(dtype).name))
    return jcfg, jax.tree.map(jnp.asarray, jp), jx, cfg, p, tx


def _jax_route(jcfg, jp, jx):
    """The reference ``moe_block``'s routing, its own first lines: (top-k
    experts (G, Sg, k), keep (G, P) and slot (G, P) in sorted order)."""
    m = jcfg.moe
    b, s, d = jx.shape
    n = b * s
    g = jlayers._moe_group_count(n)
    sg, pairs = n // g, (n // g) * m.top_k
    cap = max(int(np.ceil(pairs / m.n_experts * m.capacity_factor / 8)) * 8,
              8)
    logits = jx.reshape(g, sg, d).astype(jnp.float32) @ jp['router']
    _, idx = jax.lax.top_k(logits, m.top_k)
    pair_expert = idx.reshape(g, pairs)
    order = jnp.argsort(pair_expert, axis=-1)
    sorted_expert = jnp.take_along_axis(pair_expert, order, axis=-1)
    starts = jax.vmap(lambda row: jnp.searchsorted(
        row, jnp.arange(m.n_experts), side='left'))(sorted_expert)
    pos = jnp.arange(pairs)[None, :] - jnp.take_along_axis(
        starts, sorted_expert, axis=-1)
    keep = pos < cap
    slot = jnp.where(keep, sorted_expert * cap + pos, m.n_experts * cap)
    return np.asarray(idx), np.asarray(keep), np.asarray(slot), cap


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize('name', MOE)
def test_moe_configs_match_reference(name):
    """CONFIG and SMOKE copied across: every field equal but those the
    port leaves out (as for the dense configs), ``moe`` field for field."""
    for get, jget in ((configs.get_config, jconfigs.get_config),
                      (configs.get_smoke_config, jconfigs.get_smoke_config)):
        cfg, jcfg = get(name), jget(name)
        for f in jcfg.__dataclass_fields__:
            if f not in IGNORED_FIELDS:
                assert getattr(cfg, f) == getattr(jcfg, f), (name, f)
        assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)
        assert cfg.family == 'moe'


@pytest.mark.parametrize('n', [1, 7, 4095, 4096, 8192, 12290, 3 * 4096 + 1])
def test_moe_group_count_matches_reference(n):
    assert layers._moe_group_count(n) == jlayers._moe_group_count(n)


# ------------------------------------------------------------- moe blocks
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('name', MOE)
def test_moe_block_matches_reference(name, case, dtype):
    """Routes, keep masks and slots equal; output (in the promoted dtype)
    and the GShard aux loss within ``MOE_TOL``."""
    jcfg, jp, jx, cfg, p, tx = _moe_inputs(name, case, dtype)
    idx, keep, slot, cap = _jax_route(jcfg, jp, jx)
    r = layers.moe_route(cfg, p, tx)
    assert r.cap == cap
    np.testing.assert_array_equal(r.idx.numpy(), idx)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    if case == 'overflow' or (case == 'drop' and name.startswith('kimi')):
        assert not keep.all()          # the case drops pairs
    if case == 'groups':
        assert keep.shape[0] == 2      # two token groups
    want, want_ce = jax.jit(functools.partial(jlayers.moe_block, jcfg))(
        jp, jx)
    got, ce = layers.moe_block(cfg, p, tx)
    assert got.dtype == getattr(torch, jnp.dtype(want.dtype).name)
    assert got.shape == tx.shape
    np.testing.assert_allclose(got.float().numpy(), _np(want), **MOE_TOL)
    np.testing.assert_allclose(float(ce), float(want_ce), **MOE_TOL)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('name', MOE)
def test_moe_block_global_matches_reference(name, case, dtype):
    """The ablation baseline: its output in x's dtype (the pair outputs are
    scattered into it) and its own aux loss."""
    jcfg, jp, jx, cfg, p, tx = _moe_inputs(name, case, dtype)
    want, want_ce = jax.jit(functools.partial(jlayers.moe_block_global,
                                              jcfg))(jp, jx)
    got, ce = layers.moe_block_global(cfg, p, tx)
    assert got.dtype == tx.dtype
    assert str(want.dtype) == dtype
    if dtype == 'float32':
        np.testing.assert_allclose(got.numpy(), _np(want), **MOE_TOL)
    else:
        scale = np.abs(_np(want)).max()
        assert np.abs(got.float().numpy() - _np(want)).max() <= \
            BF16_ROUND_REL * scale
    np.testing.assert_allclose(float(ce), float(want_ce), **MOE_TOL)


def test_moe_block_runs_only_live_experts(monkeypatch):
    """One token on top-2 of 8 experts: the products run for its two
    experts alone, and the output equals that of all 8."""
    jcfg, jp, jx, cfg, p, tx = _moe_inputs('kimi-k2-1t-a32b', 'decode',
                                           'float32')
    seen = []
    run = layers._expert_products

    def spy(p_, live, buf):
        seen.append(list(live))
        return run(p_, live, buf)

    monkeypatch.setattr(layers, '_expert_products', spy)
    got, _ = layers.moe_block(cfg, p, tx)
    r = layers.moe_route(cfg, p, tx)
    assert seen == [sorted(r.idx.flatten().tolist())]
    everyone = list(range(cfg.moe.n_experts))
    monkeypatch.setattr(layers, '_live_experts', lambda counts: everyone)
    full, _ = layers.moe_block(cfg, p, tx)
    assert seen[-1] == everyone
    assert torch.equal(got, full)


# ------------------------------------------------------------------ init
@pytest.mark.parametrize('param_dtype', ['float32', 'bfloat16'])
def test_init_moe_shapes_dtypes_and_fan_in(param_dtype):
    cfg = configs.get_smoke_config('kimi-k2-1t-a32b').replace(
        param_dtype=param_dtype)
    m, d, L = cfg.moe, cfg.d_model, cfg.n_layers
    params = transformer.init_lm(cfg, torch.Generator().manual_seed(0),
                                 'cpu')
    moe = params['blocks']['moe']
    assert 'mlp' not in params['blocks']
    assert moe['router'].shape == (L, d, m.n_experts)
    assert moe['router'].dtype == torch.float32
    for k, shape, fan_in in (('w_gate', (d, m.d_ff), d),
                             ('w_up', (d, m.d_ff), d),
                             ('w_down', (m.d_ff, d), m.d_ff)):
        w = moe[k]
        assert w.shape == (L, m.n_experts) + shape
        assert w.dtype == getattr(torch, param_dtype)
        assert float(w.float().abs().max()) <= 2 * fan_in ** -0.5 * (
            1 + 2 ** -7)
        assert 0.7 < float(w.float().std()) * fan_in ** 0.5 < 1.0
        assert not torch.equal(w[0, 0], w[0, 1])
    jcfg = jconfigs.get_smoke_config('kimi-k2-1t-a32b').replace(
        param_dtype=param_dtype)
    jparams, _ = jget_bundle(jcfg).init(jax.random.PRNGKey(0))
    assert get_bundle(cfg).param_count(params) == \
        jget_bundle(jcfg).param_count(jparams)


@pytest.mark.parametrize('name', MOE + ['qwen3-14b'])
def test_active_param_count_matches_reference(name):
    jcfg = jconfigs.get_smoke_config(name)
    jparams, _ = jget_bundle(jcfg).init(jax.random.PRNGKey(0))
    cfg = configs.get_smoke_config(name)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), 'cpu')
    b, jb = get_bundle(cfg), jget_bundle(jcfg)
    assert b.param_count(params) == jb.param_count(jparams)
    assert b.active_param_count(params) == jb.active_param_count(jparams)
    if cfg.moe is not None:
        assert b.active_param_count(params) < b.param_count(params)


def test_stack_init_holds_one_draw_beside_the_stack():
    """``_stack_init`` of n layers holds at most n + 1 layers' bytes at its
    peak (the running sum of the profiler's CPU allocation and free
    events, in time order), and a one-layer init one layer."""
    from torch.profiler import ProfilerActivity, profile
    layer_bytes = 1 << 20

    def draw():
        return {'w': torch.randn(layer_bytes // 8, dtype=torch.float32),
                'b': torch.ones(layer_bytes // 8, dtype=torch.float32)}

    def peak(n):
        with profile(activities=[ProfilerActivity.CPU],
                     profile_memory=True) as prof:
            stack = transformer._stack_init(draw, n)
        assert stack['w'].shape == (n, layer_bytes // 8)
        live = top = 0
        for ev in sorted(prof.events(), key=lambda e: e.time_range.start):
            live += ev.self_cpu_memory_usage
            top = max(top, live)
        return top

    for n in (1, 3, 6):
        assert layer_bytes * n <= peak(n) <= layer_bytes * (n + 1), n
    assert peak(1) == layer_bytes


# ------------------------------------------------------------- ring cache
def _decode_inputs(cfg, steps, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(steps, 2, 1, cfg.d_model).astype(np.float32)


@pytest.mark.parametrize('name,window,max_seq', [
    ('mixtral-8x22b', 16, 48),     # a sliding-window ring past its wrap
    ('qwen3-14b', None, 8)])       # a dense cache past max_seq
def test_ring_decode_matches_reference(name, window, max_seq):
    """Layer 0's ``attention_decode`` at positions 0 .. 40 against the
    reference's, on caches of ``init_cache``'s width: every output, and
    after each step the cache rows (the reference's ``pos`` array checked
    by ``lm_cache_from_numpy``)."""
    jcfg, jparams, cfg, params = _pair(name, activation_dtype='float32')
    assert cfg.sliding_window == window
    jattn = jax.tree.map(lambda a: a[0], jparams['blocks']['attn'])
    attn = transformer.layer(params, 0)['attn']
    jcache = jax.tree.map(lambda a: a[0],
                          jget_bundle(jcfg).init_cache(2, max_seq)[0])
    cache = {n: a[0] for n, a in
             transformer.init_cache(cfg, 2, max_seq, 'cpu').items()}
    w = min(window or max_seq, max_seq)
    assert cache['k'].shape == (2, cfg.n_kv_heads, w, cfg.resolved_head_dim)
    assert jcache['k'].shape[1] == w
    step = jax.jit(functools.partial(jlayers.attention_decode, jcfg),
                   static_argnames=('window',))
    for pos, x in enumerate(_decode_inputs(cfg, 41)):
        want, jcache = step(jattn, jnp.asarray(x), jcache, pos=pos,
                            window=window)
        cos_sin = layers.rope_cos_sin(torch.full((1,), pos),
                                      cfg.resolved_head_dim, cfg.rope_theta)
        got = layers.attention_decode(cfg, attn, torch.from_numpy(x), cache,
                                      pos=pos, cos_sin=cos_sin, window=window)
        np.testing.assert_allclose(got.numpy(), _np(want), **DECODE_TOL)
        np.testing.assert_array_equal(np.asarray(jcache['pos']),
                                      ring_fill(w, pos + 1))
        conv = lm_cache_from_numpy(jax.tree.map(
            lambda a: np.asarray(a)[None], jcache), 'cpu')
        for n in ('k', 'v'):
            np.testing.assert_allclose(cache[n].numpy(), conv[n][0].numpy(),
                                       **DECODE_TOL)


def test_cache_conversion_refuses_a_pos_out_of_order():
    cfg = configs.get_smoke_config('mixtral-8x22b')
    k = np.zeros((cfg.n_layers, 1, 4, cfg.n_kv_heads, 16), np.float32)
    good = np.stack([ring_fill(4, 6)] * cfg.n_layers)
    np.testing.assert_array_equal(good[0], [4, 5, 2, 3])
    assert lm_cache_from_numpy({'k': k, 'v': k, 'pos': good}, 'cpu'
                               )['k'].shape == (cfg.n_layers, 1,
                                                cfg.n_kv_heads, 4, 16)
    bad = good.copy()
    bad[:, 0] = 0
    with pytest.raises(ValueError, match='in order'):
        lm_cache_from_numpy({'k': k, 'v': k, 'pos': bad}, 'cpu')


def test_a_ring_wider_than_the_window_raises():
    cfg = configs.get_smoke_config('mixtral-8x22b')
    params = transformer.init_lm(cfg, torch.Generator().manual_seed(0),
                                 'cpu')
    cache = {n: a[0] for n, a in transformer.init_cache(
        cfg.replace(sliding_window=None), 1, 32, 'cpu').items()}
    x = torch.zeros(1, 1, cfg.d_model, dtype=cfg.adtype())
    with pytest.raises(ValueError, match='wider than the window'):
        layers.attention_decode(cfg, transformer.layer(params, 0)['attn'],
                                x, cache, pos=0, cos_sin=None, window=16)


# ------------------------------------------------------------ model parity
def _jax_replay(jcfg, jparams, tokens, max_seq):
    step = jax.jit(jget_bundle(jcfg).decode_step)
    cache, _ = jget_bundle(jcfg).init_cache(tokens.shape[0], max_seq)
    outs = []
    for t in range(tokens.shape[1]):
        logits, cache = step(jparams, cache, jnp.asarray(tokens[:, t:t + 1]),
                             jnp.int32(t))
        outs.append(_np(logits[:, 0]))
    return np.stack(outs, 1), cache


def _replay(cfg, params, tokens, max_seq):
    cache = transformer.init_cache(cfg, tokens.shape[0], max_seq, 'cpu')
    tok = torch.from_numpy(tokens)
    outs = []
    for t in range(tokens.shape[1]):
        logits, cache = transformer.decode_step(cfg, params, cache,
                                                tok[:, t:t + 1], t)
        outs.append(logits[:, 0].float().numpy())
    return np.stack(outs, 1), cache


@pytest.mark.parametrize('name', MOE)
def test_moe_forward_and_loss_match_reference(name):
    """f32 activations: logits, the aux loss summed over the layers and
    ``loss_fn`` (cross entropy + 0.01 aux) within ``FWD_TOL``."""
    jcfg, jparams, cfg, params = _pair(name, activation_dtype='float32')
    tokens, labels = _tokens(cfg.vocab_size), _tokens(cfg.vocab_size, 2)
    want, want_aux = jax.jit(functools.partial(jtransformer.forward_lm,
                                               jcfg))(jparams,
                                                      jnp.asarray(tokens))
    got, aux = transformer.forward_lm(cfg, params, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), _np(want), **FWD_TOL)
    assert torch.is_tensor(aux) and float(aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux), **FWD_TOL)
    batch = {'tokens': jnp.asarray(tokens), 'labels': jnp.asarray(labels)}
    jloss = float(jget_bundle(jcfg).loss_fn(jparams, batch))
    loss = float(get_bundle(cfg).loss_fn(
        params, {'tokens': torch.from_numpy(tokens),
                 'labels': torch.from_numpy(labels)}))
    np.testing.assert_allclose(loss, jloss, **FWD_TOL)


def _record_routes(monkeypatch, log):
    """Append each MoE call's top-k experts, (tokens, k) in token order, to
    ``log['port']`` (``layers.moe_route``) and ``log['ref']`` (the
    reference's ``moe_block``, through an ordered ``jax.debug.callback``,
    so also from inside its jitted layer scan)."""
    route = layers.moe_route
    jblock = jlayers.moe_block

    def port(cfg, p, x):
        r = route(cfg, p, x)
        log['port'].append(r.idx.reshape(-1, cfg.moe.top_k).numpy())
        return r

    def ref(cfg, p, x):
        _, idx = jax.lax.top_k(x.astype(jnp.float32) @ p['router'],
                               cfg.moe.top_k)
        jax.debug.callback(lambda i: log['ref'].append(np.asarray(i)),
                           idx.reshape(-1, cfg.moe.top_k), ordered=True)
        return jblock(cfg, p, x)

    monkeypatch.setattr(layers, 'moe_route', port)
    monkeypatch.setattr(jlayers, 'moe_block', ref)


def _flipped(a, b, n_layers, B, T, b_index):
    """(B, T) bool: token (b, t) took another set of experts in some layer
    of run ``a`` (decode: call t * L + l, row b) than of run ``b`` (call
    and row from ``b_index(l, b, t)``)."""
    out = np.zeros((B, T), bool)
    for t in range(T):
        for l in range(n_layers):
            for row in range(B):
                call, tok = b_index(l, row, t)
                out[row, t] |= (set(a[t * n_layers + l][row])
                                != set(b[call][tok]))
    return out


@pytest.mark.parametrize('adtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('name', MOE)
def test_moe_decode_replay_matches_reference(name, adtype, monkeypatch):
    """``decode_step`` over 24 tokens (Mixtral's ring of 16 wraps) against
    the reference's, every logit row; with a no-drop capacity factor (as
    the reference's ``test_decode_matches_forward``) also against the
    port's ``forward_lm``: the full sequence may drop pairs at capacity,
    one decoded token never does.  f32: every row within ``DECODE_TOL``
    and the routes equal.  bf16: a near-tie in the router can pick
    another expert in one run (a route flip, which moves that row's
    logits by ~0.14 of their scale); rows whose route flipped in some
    layer are counted apart (at most one in twelve), every other row
    within ``BF16_REL`` of the logit scale."""
    jcfg, jparams, cfg, params = _pair(name, activation_dtype=adtype)
    L, (B, T) = cfg.n_layers, (2, 24)
    tokens = _tokens(cfg.vocab_size, 3, (B, T))
    log = {'port': [], 'ref': []}
    _record_routes(monkeypatch, log)
    want, _ = _jax_replay(jcfg, jparams, tokens, T)
    jax.effects_barrier()
    got, cache = _replay(cfg, params, tokens, T)
    dec, ref = log['port'], log['ref']
    assert len(dec) == len(ref) == T * L
    assert cache['k'].shape[3] == min(cfg.sliding_window or T, T)
    nodrop = cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    full, _ = transformer.forward_lm(nodrop, params,
                                     torch.from_numpy(tokens))
    full, fwd = full.float().numpy(), log['port'][T * L:]
    flips = {'reference': (want, _flipped(dec, ref, L, B, T,
                                          lambda l, b, t: (t * L + l, b))),
             'forward': (full, _flipped(dec, fwd, L, B, T,
                                        lambda l, b, t: (l, b * T + t)))}
    scale = np.abs(want).max()
    for what, (other, flipped) in flips.items():
        if adtype == 'float32':
            assert not flipped.any(), what
            np.testing.assert_allclose(got, other, **DECODE_TOL)
        else:
            assert flipped.sum() <= B * T // 12, what
            err = np.abs(got - other).max(-1)[~flipped]
            assert err.max() <= BF16_REL * scale, what


# ---------------------------------------------------------------- serving
def _requests(req_cls, vocab, n=5):
    rng = np.random.RandomState(11)
    return [req_cls(rid=r, prompt=rng.randint(1, vocab, size=rng.randint(
        3, 8)).tolist(), max_new=int(rng.randint(10, 16)))
        for r in range(n)]


@pytest.mark.parametrize('name', MOE)
def test_moe_slot_server_emits_reference_tokens(name):
    """f32 activations, 2 slots of 32 positions: Mixtral's ring of 16
    slots wraps (prompts of 3-7 tokens, 10-15 new)."""
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
    if cfg.sliding_window:
        assert max(len(r.prompt) + len(r.out) for r in srv.done) > \
            cfg.sliding_window
        assert srv.caches[0]['k'].shape[3] == cfg.sliding_window


def test_serve_cli_moe_token_path(capsys):
    stats = serve.main(['--arch', 'mixtral-8x22b', '--smoke', '--device',
                        'cpu', '--requests', '3', '--slots', '2',
                        '--max-new', '16'])
    out = capsys.readouterr().out
    assert re.search(r'^served 3 requests, 48 tokens in [0-9.]+s '
                     r'\([0-9.]+ tok/s\); p50 latency [0-9.]+s$', out,
                     re.M), out
    cfg = configs.get_smoke_config('mixtral-8x22b')
    params = get_bundle(cfg).init(torch.Generator().manual_seed(0), 'cpu')
    total = sum(p.numel() for p in leaves(params))
    active = get_bundle(cfg).active_param_count(params)
    assert f'mixtral-smoke on cpu: {total} parameters ({active} active), ' \
           f'attention auto, K8 launches 0' in out
    assert stats['tokens'] == 48 and stats['k8_launches'] == 0
