"""Dense transformer layers of the port, as plain functions on tensors.

Counterpart of the dense part of ``repro.models.layers``: parameters are
nested dicts of tensors with the reference's names and layouts (``wq``
(d, H, hd), ``wo`` (H, hd, d), ...), so weights carry across leaf for leaf
(``convert.lm_params_from_numpy``).  The reference's ``logical(...)``
sharding constraints have no meaning on one card and are dropped.  dtypes
follow JAX's promotion: a bf16 activation times an f32 parameter is f32
(``_mm`` promotes both sides of a product, as ``jnp.einsum`` does), and the
callers cast residuals back.

Attention runs on K8 (``kernels.flash_attention``), chosen by
``cfg.attn_backend`` (``attention``): ``auto`` launches the kernel on CUDA
tensors and runs its plain version on CPU ones, ``torch`` runs the plain
version on any device.  A failure to build or launch the kernel is raised,
never caught.  K8 takes any sequence
length, so the reference's key padding to ``attn_chunk`` is gone.  Under
autograd (an input that requires grad) attention goes through
``attention_train``, the counterpart of the reference's custom VJP: K8's
forward keeps its log-sum-exp and K8's hand-written backward recomputes
p from it (``torch``: the plain forward and backward).

Init draws from one ``torch.Generator`` in order (the reference's
``keygen`` key splits have no counterpart); the numbers differ from
``jax.random``'s, so tests carry the reference's weights across instead.
The MoE blocks and cross attention come with their families (ROADMAP
queue 1, item 3).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..configs import ATTN_BACKENDS
from ..kernels.flash_attention import (attention_ref, attention_train,
                                       flash_attention)

f32 = torch.float32
Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------- param utils
def mk_param(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
             scale: Optional[float] = None,
             fan_in_dims: Tuple[int, ...] = (0,)) -> torch.Tensor:
    """Truncated-normal (on [-2, 2]) fan-in init on ``gen``'s device, drawn
    in f32 and cast to ``dtype``."""
    if scale is None:
        fan_in = 1
        for d in fan_in_dims:
            fan_in *= shape[d]
        scale = fan_in ** -0.5
    w = torch.empty(tuple(shape), dtype=f32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * scale).to(dtype)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) times w (d, ...) over d, both promoted to their common
    dtype (``jnp.einsum``'s rule): (..., *w.shape[1:])."""
    dt = torch.promote_types(x.dtype, w.dtype)
    out = x.to(dt) @ w.to(dt).reshape(x.shape[-1], -1)
    return out.reshape(x.shape[:-1] + w.shape[1:])


# --------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    x32 = x.to(f32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5):
    x32 = x.to(f32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


def apply_norm(cfg, p: Params, x: torch.Tensor, prefix: str = ''):
    if cfg.norm == 'layernorm':
        return layer_norm(x, p[prefix + 'scale'], p[prefix + 'bias'])
    return rms_norm(x, p[prefix + 'scale'])


def init_norm(cfg, dtype: torch.dtype, device) -> Params:
    p = {'scale': torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm == 'layernorm':
        p['bias'] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=f32,
                                         device=device) / head_dim))


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin), each (..., S, 1, head_dim / 2) in f32, for positions
    (S,) or (..., S): computed once per forward or decode step and shared
    by every layer."""
    ang = positions.to(f32)[..., None] * rope_freqs(head_dim, theta,
                                                    positions.device)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, cos_sin) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim) rotated by ``rope_cos_sin`` of its
    positions (the reference's ``apply_rope(x, positions, theta)``, with
    the angles computed once by the caller)."""
    d = x.shape[-1]
    cos, sin = cos_sin
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention
def attention(backend: str, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, *, causal: bool = True,
              window: Optional[int] = None, offset: Optional[int] = None,
              kv_len: Optional[int] = None) -> torch.Tensor:
    """The counterpart of the reference's ``chunked_attention`` (scale
    D ** -0.5): q (B, H, Sq, D); k, v (B, Hkv, Sk, D), contiguous and of
    one dtype.  ``offset`` is the position of query row 0 (default Sk - Sq
    when causal), keys j < ``kv_len`` only.  On K8 (``flash_attention``)
    or its plain version (``attention_ref``) by ``backend``
    (``cfg.attn_backend``); through ``attention_train`` when grad mode is
    on and an input requires grad (``kv_len`` is inference-only there, as
    in the reference, and raises)."""
    if backend not in ATTN_BACKENDS:
        raise ValueError(f'attn_backend {backend!r}, expected one of '
                         f'{ATTN_BACKENDS}')
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if kv_len is not None:
            raise ValueError('attention: kv_len is inference-only (no '
                             'backward)')
        return attention_train(q, k, v, causal=causal, window=window,
                               offset=offset, plain=backend == 'torch')
    kw = dict(causal=causal, window=window, offset=offset, kv_len=kv_len)
    if backend == 'torch':
        return attention_ref(q, k, v, **kw)
    return flash_attention(q, k, v, **kw)


def init_attention(cfg, gen: torch.Generator, dtype: torch.dtype) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hk = cfg.n_heads, cfg.n_kv_heads
    dev = gen.device
    p = {
        'wq': mk_param(gen, (d, h, hd), dtype),
        'wk': mk_param(gen, (d, hk, hd), dtype),
        'wv': mk_param(gen, (d, hk, hd), dtype),
        'wo': mk_param(gen, (h, hd, d), dtype, fan_in_dims=(0, 1)),
    }
    if cfg.qkv_bias:
        for n, sh in (('bq', (h, hd)), ('bk', (hk, hd)), ('bv', (hk, hd))):
            p[n] = torch.zeros(sh, dtype=dtype, device=dev)
    if cfg.qk_norm:
        p['q_norm'] = torch.ones((hd,), dtype=dtype, device=dev)
        p['k_norm'] = torch.ones((hd,), dtype=dtype, device=dev)
    return p


def _project_qkv(p: Params, x: torch.Tensor, cos_sin=None):
    """q (B, S, H, hd), k and v (B, S, Hkv, hd): the projections, bias,
    qk-norm and RoPE (``cos_sin`` from ``rope_cos_sin``; None: no RoPE)."""
    q, k, v = _mm(x, p['wq']), _mm(x, p['wk']), _mm(x, p['wv'])
    if 'bq' in p:
        q, k, v = q + p['bq'], k + p['bk'], v + p['bv']
    if 'q_norm' in p:
        q = rms_norm(q, p['q_norm'])
        k = rms_norm(k, p['k_norm'])
    if cos_sin is not None:
        q = apply_rope(q, cos_sin)
        k = apply_rope(k, cos_sin)
    return q, k, v


def _out_proj(p: Params, o: torch.Tensor) -> torch.Tensor:
    """o (B, S, H, hd) -> (B, S, d) through ``wo`` (H, hd, d)."""
    b, s, h, hd = o.shape
    return _mm(o.reshape(b, s, h * hd), p['wo'].reshape(h * hd, -1))


def attention_block(cfg, p: Params, x: torch.Tensor, *, cos_sin,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Self attention over full sequences (train / prefill): x (B, S, d),
    causal with offset 0."""
    q, k, v = _project_qkv(p, x, cos_sin)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    o = attention(cfg.attn_backend, qh, kh, vh, causal=causal,
                  window=window)
    return _out_proj(p, o.transpose(1, 2))


def attention_decode(cfg, p: Params, x: torch.Tensor, cache: Params, *,
                     pos: int, cos_sin,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token decode against a linear KV cache, written in place.

    x: (B, 1, d); cache: ``{'k', 'v'}`` each (B, Hkv, W, hd), the port's
    layout (``transformer.init_cache``), slot = position.  The new row goes
    to slot ``pos``; keys j <= pos are valid, which for a cache filled in
    order is the reference's ``pos_arr >= 0 & pos_arr <= pos``, so K8 runs
    with ``kv_len = pos + 1, offset = pos``.  q is cast to the cache's
    dtype (K8 takes one dtype; the reference's output has the cache's
    too).  A sliding-window ring cache cannot be written as kv_len and
    offset, so ``window`` raises until the MoE/hybrid slice."""
    if window is not None:
        raise NotImplementedError('attention_decode: ring caches (sliding '
                                  'window) are not ported yet (ROADMAP '
                                  'queue 1, item 3)')
    q, k_new, v_new = _project_qkv(p, x, cos_sin)
    k_cache, v_cache = cache['k'], cache['v']
    k_cache[:, :, pos].copy_(k_new[:, 0])
    v_cache[:, :, pos].copy_(v_new[:, 0])
    qh = q.transpose(1, 2).to(k_cache.dtype)            # (B, H, 1, hd)
    o = attention(cfg.attn_backend, qh, k_cache, v_cache, causal=True,
                  offset=pos, kv_len=pos + 1)
    return _out_proj(p, o.transpose(1, 2))


# ----------------------------------------------------------------------- MLP
def init_mlp(cfg, gen: torch.Generator, dtype: torch.dtype,
             d_ff: Optional[int] = None) -> Params:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == 'silu':   # SwiGLU
        return {'w_gate': mk_param(gen, (d, ff), dtype),
                'w_up': mk_param(gen, (d, ff), dtype),
                'w_down': mk_param(gen, (ff, d), dtype)}
    dev = gen.device
    return {'w_up': mk_param(gen, (d, ff), dtype),
            'b_up': torch.zeros((ff,), dtype=dtype, device=dev),
            'w_down': mk_param(gen, (ff, d), dtype),
            'b_down': torch.zeros((d,), dtype=dtype, device=dev)}


def mlp_block(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == 'silu':
        h = F.silu(_mm(x, p['w_gate'])) * _mm(x, p['w_up'])
        return _mm(h, p['w_down'])
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(_mm(x, p['w_up']) + p['b_up'], approximate='tanh')
    return _mm(h, p['w_down']) + p['b_down']


# ----------------------------------------------------------------- embedding
def init_embedding(cfg, gen: torch.Generator, dtype: torch.dtype) -> Params:
    p = {'table': mk_param(gen, (cfg.vocab_size, cfg.d_model), dtype,
                           scale=0.02)}
    if not cfg.tie_embeddings:
        p['unembed'] = mk_param(gen, (cfg.d_model, cfg.vocab_size), dtype)
    return p


def embed(cfg, p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The table's rows at ``tokens``.  Through ``F.embedding``, whose
    backward sums each row's gradients in a fixed order; indexing's
    (``index_put_`` with accumulate) adds them in thread order on the CPU,
    so two runs of a step would differ in their last bits."""
    return F.embedding(tokens, p['table']).to(cfg.adtype())


def unembed(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    w = p['table'].T if cfg.tie_embeddings else p['unembed']
    return x @ w.to(x.dtype)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy, f32 logsumexp over the vocabulary."""
    logits = logits.to(f32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()
