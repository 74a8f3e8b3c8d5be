"""Dense transformer layers of the port, as plain functions on tensors.

Counterpart of the dense part of ``repro.models.layers``: parameters are
nested dicts of tensors with the reference's names and layouts (``wq``
(d, H, hd), ``wo`` (H, hd, d), ...), so weights carry across leaf for leaf
(``convert.lm_params_from_numpy``).  The reference's ``logical(...)``
sharding sites are kept (``sharding.logical``): no-ops on plain tensors,
they place DTensor activations by the installed rules; on DTensors the
products run tensor-parallel on each rank's shards (``_mm_sharded``), K8
on each rank's heads or query rows (``_attention_sharded``), the
embedding and the cross entropy split over the vocabulary, and an MoE
block dispatches its own token groups (``_moe_block_sharded``).  dtypes
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

The MoE blocks (``moe_block``, ``moe_block_global``) are the reference's
functions step for step in plain PyTorch: the reference computes its
routing and its expert products outside any Pallas kernel, so no kernel
of the port replaces them.

Cross attention (the audio and VLM families): ``attention_block`` with a
``kv_src`` projects k and v from it and runs non-causal, with no RoPE;
``cross_attention_decode`` attends one query row to a layer's
precomputed cross K/V (``transformer.precompute_cross_kv``).  A cross
block holds no bias and no qk-norm (``init_attention(..., cross=True)``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..configs import ATTN_BACKENDS
from ..sharding import is_dtensor, logical, replicated, run_local
from ..kernels.flash_attention import (attention_ref, attention_train,
                                       flash_attention)

f32 = torch.float32
Params = Dict[str, torch.Tensor]


def is_fake_mode() -> bool:
    """True inside a ``FakeTensorMode`` (the dry run's tracing)."""
    from torch._guards import detect_fake_mode
    return detect_fake_mode() is not None


# ---------------------------------------------------------------- param utils
def mk_param(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
             scale: Optional[float] = None,
             fan_in_dims: Tuple[int, ...] = (0,)) -> torch.Tensor:
    """Truncated-normal (on [-2, 2]) fan-in init on ``gen``'s device, drawn
    in f32, scaled in place (one f32 copy of the matrix at a time: 0.94 GB
    for a Llama-3.2-Vision MLP matrix) and cast to ``dtype``.  Under fake
    tensors (``launch.train.abstract_init``) nothing is drawn (the draw
    reads its tensor on the host): the result has the shape and dtype
    alone."""
    if is_fake_mode():
        return torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    if scale is None:
        fan_in = 1
        for d in fan_in_dims:
            fan_in *= shape[d]
        scale = fan_in ** -0.5
    w = torch.empty(tuple(shape), dtype=f32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(scale).to(dtype)


def _mm(x: torch.Tensor, w: torch.Tensor, k: int = 1,
        shared: int = 0) -> torch.Tensor:
    """x (s..., ..., c_1..c_k) times w (s..., c_1..c_k, ...) over the k
    contracted dims, batched over ``shared`` leading dims of both (an MoE
    block's experts), both promoted to their common dtype
    (``jnp.einsum``'s rule): (s..., ..., *w.shape[shared + k:]).  On
    DTensors each rank multiplies its shards (``_mm_sharded``)."""
    if is_dtensor(x) or is_dtensor(w):
        return _mm_sharded(x, w, k, shared)
    dt = torch.promote_types(x.dtype, w.dtype)
    lead, nb = x.shape[:shared], x.shape[:x.ndim - k]
    c = math.prod(w.shape[shared:shared + k])
    out = x.to(dt).reshape(lead + (-1, c)) @ w.to(dt).reshape(lead + (c, -1))
    return out.reshape(nb + w.shape[shared + k:])


def _mm_sharded(x: torch.Tensor, w: torch.Tensor, k: int,
                shared: int) -> torch.Tensor:
    """``_mm`` on DTensors as a tensor-parallel product on each rank's
    shards, mesh dimension by mesh dimension: a shared dim sharded -> both
    sides and the output sharded on it; x's batch dims sharded -> the
    output's (w made whole there); w's output dims sharded (TP columns)
    -> the output's; both sharded on the same contracted dim -> a partial
    sum (TP rows); w alone sharded on a contracted dim (FSDP) -> w
    gathered; x alone -> x gathered.  No sharded dimension is reshaped,
    so no strided shards arise."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = (x if is_dtensor(x) else w).device_mesh
    nb = x.ndim - k                    # x's shared and batch dims
    wo = shared + k                    # w's first output dim
    whole = [Replicate()] * mesh.ndim
    xp = list(x.placements) if is_dtensor(x) else list(whole)
    wp = list(w.placements) if is_dtensor(w) else list(whole)
    out = []
    for m in range(mesh.ndim):
        xp[m] = Replicate() if isinstance(xp[m], Partial) else xp[m]
        wp[m] = Replicate() if isinstance(wp[m], Partial) else wp[m]
        a = xp[m].dim if isinstance(xp[m], Shard) else None
        b = wp[m].dim if isinstance(wp[m], Shard) else None
        if a is not None and a < shared:              # a shared dim
            wp[m] = Shard(a)
            out.append(Shard(a))
        elif b is not None and b < shared:
            xp[m] = Shard(b)
            out.append(Shard(b))
        elif a is not None and a < nb:                # batch-like dim of x
            wp[m] = Replicate()
            out.append(Shard(a))
        elif a is not None and b == a - nb + shared:  # one contracted dim
            out.append(Partial())
        elif a is not None:                           # contracted, x only
            xp[m] = Replicate()
            if b is not None and b < wo:
                wp[m] = Replicate()
            out.append(Shard(nb + b - wo) if b is not None and b >= wo
                       else Replicate())
        elif b is not None and b < wo:                # contracted, w only
            wp[m] = Replicate()
            out.append(Replicate())
        elif b is not None:                           # w's output dims
            out.append(Shard(nb + b - wo))
        else:
            out.append(Replicate())
    if is_dtensor(x) and list(x.placements) != xp:
        x = x.redistribute(mesh, xp)
    if is_dtensor(w) and list(w.placements) != wp:
        w = w.redistribute(mesh, wp)
    return run_local(lambda xl, wl: _mm(xl, wl, k, shared), [x, w],
                     tuple(out))


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


def norm_axes(cfg) -> dict:
    """The logical axes of ``init_norm``'s parameters."""
    ax = {'scale': ('embed',)}
    if cfg.norm == 'layernorm':
        ax['bias'] = ('embed',)
    return ax


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
    if is_dtensor(q):
        return _attention_sharded(backend, q, k, v, causal=causal,
                                  window=window, offset=offset,
                                  kv_len=kv_len)
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


# the logical axes of attention's operands in K8's layout: q and o (B, H,
# Sq, D), k and v (B, Hkv, Sk, D).  The reference groups q's heads (B, Hkv,
# G, Sq, D); the port tests q's head dim at Hkv's size (``_qg``), which
# places it as the reference's grouped dim.
_QG_AXES = ('batch', 'kv_heads', 'seq_q', 'head_dim_act')
_KV_AXES = ('batch', 'kv_heads', None, 'head_dim_act')


class _GradLogical(torch.autograd.Function):
    """The identity whose backward places the gradient by logical axes:
    the placement of a cotangent (the reference's ``logical`` calls inside
    its attention backward)."""

    @staticmethod
    def forward(ctx, x, axes, shape):
        ctx.axes, ctx.shape = axes, shape
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return logical(g, *ctx.axes, shape=ctx.shape), None, None


def _grad_logical(x: torch.Tensor, *axes, shape=None) -> torch.Tensor:
    if not (is_dtensor(x) and x.requires_grad and torch.is_grad_enabled()):
        return x
    return _GradLogical.apply(x, axes, shape)


def _qg(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """q (B, H, Sq, D) placed by ``_QG_AXES`` at Hkv heads' size."""
    b, _, sq, d = q.shape
    return logical(q, *_QG_AXES, shape=(b, n_kv, sq, d))


def _attention_sharded(backend: str, q, k, v, *, causal, window, offset,
                       kv_len):
    """``attention`` on DTensors: K8 on each rank's shards.  Both of the
    reference's policies are local per shard: heads over a mesh axis (k
    and v split by their kv heads alike, GQA groups intact), or query rows
    over it with k and v whole (context parallelism: each rank's rows
    start at their own position, so the causal offset moves with them).
    The cotangents are placed alike (``_grad_logical``)."""
    from torch.distributed.tensor import Replicate, Shard
    n_kv = k.shape[1]
    q = _qg(q, n_kv)
    k = logical(k, *_KV_AXES)
    v = logical(v, *_KV_AXES)
    qg_shape = (q.shape[0], n_kv) + tuple(q.shape[2:])
    q, k, v = (_grad_logical(q, *_QG_AXES, shape=qg_shape),
               _grad_logical(k, *_KV_AXES), _grad_logical(v, *_KV_AXES))
    mesh = q.device_mesh
    kv_pl = [p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate()
             for p in q.placements]
    q = q.redistribute(mesh, [p if isinstance(p, Shard) and p.dim < 3
                              else Replicate() for p in q.placements])
    k, v = (t.redistribute(mesh, kv_pl) if list(t.placements) != kv_pl
            else t for t in (k, v))
    sq, sk = q.shape[2], k.shape[2]
    off = offset if offset is not None else (sk - sq if causal else 0)
    # this rank's first query row (DTensor splits a dim in mesh order,
    # ceil-sized chunks)
    size, coord = sq, mesh.get_coordinate()
    for m, p in enumerate(q.placements):
        if isinstance(p, Shard) and p.dim == 2:
            chunk = -(-size // mesh.size(m))
            off += coord[m] * chunk
            size = max(0, min(chunk, size - coord[m] * chunk))

    def local(ql, kl, vl):
        return attention(backend, ql.contiguous(), kl.contiguous(),
                         vl.contiguous(), causal=causal, window=window,
                         offset=off, kv_len=kv_len)

    o = run_local(local, [q, k, v], q.placements)
    return _grad_logical(_qg(o, n_kv), *_QG_AXES, shape=qg_shape)


def init_attention(cfg, gen: torch.Generator, dtype: torch.dtype,
                   cross: bool = False) -> Params:
    """``wq`` (d, H, hd), ``wk``/``wv`` (d, Hkv, hd), ``wo`` (H, hd, d);
    ``cfg.qkv_bias``'s biases and ``cfg.qk_norm``'s scales on a self
    block only (a ``cross`` block has neither, as in the reference)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hk = cfg.n_heads, cfg.n_kv_heads
    dev = gen.device
    p = {
        'wq': mk_param(gen, (d, h, hd), dtype),
        'wk': mk_param(gen, (d, hk, hd), dtype),
        'wv': mk_param(gen, (d, hk, hd), dtype),
        'wo': mk_param(gen, (h, hd, d), dtype, fan_in_dims=(0, 1)),
    }
    if cfg.qkv_bias and not cross:
        for n, sh in (('bq', (h, hd)), ('bk', (hk, hd)), ('bv', (hk, hd))):
            p[n] = torch.zeros(sh, dtype=dtype, device=dev)
    if cfg.qk_norm and not cross:
        p['q_norm'] = torch.ones((hd,), dtype=dtype, device=dev)
        p['k_norm'] = torch.ones((hd,), dtype=dtype, device=dev)
    return p


def attention_axes(cfg, cross: bool = False) -> dict:
    """The logical axes of ``init_attention``'s parameters."""
    ax = {'wq': ('embed', 'heads', 'head_dim'),
          'wk': ('embed', 'kv_heads', 'head_dim'),
          'wv': ('embed', 'kv_heads', 'head_dim'),
          'wo': ('heads', 'head_dim', 'embed')}
    if cfg.qkv_bias and not cross:
        ax.update(bq=('heads', 'head_dim'), bk=('kv_heads', 'head_dim'),
                  bv=('kv_heads', 'head_dim'))
    if cfg.qk_norm and not cross:
        ax.update(q_norm=('head_dim',), k_norm=('head_dim',))
    return ax


def _project_q(p: Params, x: torch.Tensor) -> torch.Tensor:
    """q (B, S, H, hd) alone: the projection, bias and qk-norm."""
    q = _mm(x, p['wq'])
    if 'bq' in p:
        q = q + p['bq']
    if 'q_norm' in p:
        q = rms_norm(q, p['q_norm'])
    return q


def _project_qkv(p: Params, x: torch.Tensor, cos_sin=None, kv_src=None):
    """q (B, S, H, hd), k and v (B, F, Hkv, hd): the projections (k and v
    from ``kv_src`` (B, F, d) when given, else from x), bias, qk-norm and
    RoPE (``cos_sin`` from ``rope_cos_sin``; None: no RoPE)."""
    src = x if kv_src is None else kv_src
    q, k, v = _project_q(p, x), _mm(src, p['wk']), _mm(src, p['wv'])
    if 'bk' in p:
        k, v = k + p['bk'], v + p['bv']
    if 'k_norm' in p:
        k = rms_norm(k, p['k_norm'])
    if cos_sin is not None:
        q = apply_rope(q, cos_sin)
        k = apply_rope(k, cos_sin)
    # either kv_heads carries the TP axis or seq_q does (context
    # parallelism; sharding.rules_for_arch); head_dim_act is never sharded.
    # K and V stay whole on the seq dim: every query shard needs every key.
    q = logical(q, 'batch', 'seq_q', 'heads', 'head_dim_act')
    k = logical(k, 'batch', None, 'kv_heads', 'head_dim_act')
    v = logical(v, 'batch', None, 'kv_heads', 'head_dim_act')
    return q, k, v


def _out_proj(p: Params, o: torch.Tensor) -> torch.Tensor:
    """o (B, S, H, hd) -> (B, S, d) through ``wo`` (H, hd, d)."""
    return _mm(o, p['wo'], 2)


def attention_block(cfg, p: Params, x: torch.Tensor, *, cos_sin,
                    causal: bool = True, window: Optional[int] = None,
                    kv_src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over full sequences (train / prefill): x (B, S, d),
    with offset 0.  Self attention (causal or not) takes RoPE from
    ``cos_sin``; cross attention (``kv_src`` (B, F, d), the encoder's
    output or the image patches) projects k and v from ``kv_src`` and runs
    non-causal with no RoPE and no window, the reference's
    ``attention_block(..., kv_src=, cross=True)``.  The reference pads
    the F keys to ``attn_chunk`` and masks the padding (``kv_len``), which
    is the same function; K8 takes any F."""
    if kv_src is not None:
        cos_sin, causal, window = None, False, None
    q, k, v = _project_qkv(p, x, cos_sin, kv_src)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    o = attention(cfg.attn_backend, qh, kh, vh, causal=causal,
                  window=window)
    o = logical(o.transpose(1, 2), 'batch', 'seq_q', 'heads', 'head_dim_act')
    return logical(_out_proj(p, o), 'batch', 'seq', 'embed')


def cross_attention_decode(cfg, p: Params, x: torch.Tensor,
                           cross_kv: Params) -> torch.Tensor:
    """One decode row's cross attention, the ``cross_kv`` branch of the
    reference's ``attention_decode``: x (B, 1, d); ``cross_kv`` one
    layer's ``{'k', 'v'}``, each (B, Hkv, F, hd) (a slice of
    ``transformer.precompute_cross_kv``'s, contiguous).  Only q is
    projected (the reference also projects k and v from x and discards
    them); K8 attends the row to all F keys, non-causal, with no
    ``kv_len``.  q and the cross K/V share a dtype on every cross config
    (f32 for whisper, whose f32 layer-norm scales promote the bf16
    activations; bf16 for Llama-3.2-Vision), and a mismatch raises."""
    k, v = cross_kv['k'], cross_kv['v']
    qh = _project_q(p, x).transpose(1, 2).contiguous()   # (B, H, 1, hd)
    if qh.dtype != k.dtype:
        raise ValueError(f'cross_attention_decode: q is {qh.dtype}, the '
                         f'cross K/V {k.dtype}; K8 takes one dtype')
    o = attention(cfg.attn_backend, qh, k, v, causal=False)
    return _out_proj(p, o.transpose(1, 2))


def attention_decode(cfg, p: Params, x: torch.Tensor, cache: Params, *,
                     pos: int, cos_sin,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token decode against a ring KV cache, written in place.

    x: (B, 1, d); cache: ``{'k', 'v'}`` each (B, Hkv, W, hd), the port's
    layout (``transformer.init_cache``): W slots, position t in slot
    t % W (a dense cache has W = max_seq, a sliding window's W <=
    ``window``).  The new row goes to slot ``pos % W``, and every filled
    slot is valid: keys j < min(pos + 1, W), with no causal mask.  For a
    cache filled in order that is the reference's mask ``pos_arr >= 0 &
    pos_arr <= pos & pos - pos_arr < window``: the slots hold positions
    pos - W + 1 .. pos, all within the window, and softmax does not
    depend on the keys' order.  So the port keeps no ``pos`` array, and
    K8 runs with ``kv_len`` alone.  A cache wider than ``window`` would
    need the position mask and raises.  q is cast to the cache's dtype (K8
    takes one dtype; the reference's output has the cache's too).  Where q
    is f32 and the cache bf16 (whisper: its f32 layer-norm scales promote
    the bf16 activations) the reference scores the f32 q against the bf16
    cache in f32; rounding q to bf16 instead keeps the smoke config's
    decode within 1e-2 of the reference's logit scale (the tests hold it
    to 3e-2), so the port keeps this cast and does not widen the layer's
    ring slice to f32."""
    k_cache, v_cache = cache['k'], cache['v']
    w = k_cache.shape[2]
    if window is not None and w > window:
        raise ValueError(f'attention_decode: a cache of {w} slots is wider '
                         f'than the window {window}')
    q, k_new, v_new = _project_qkv(p, x, cos_sin)
    slot = pos % w
    k_cache[:, :, slot].copy_(k_new[:, 0])
    v_cache[:, :, slot].copy_(v_new[:, 0])
    qh = q.transpose(1, 2).to(k_cache.dtype)            # (B, H, 1, hd)
    o = attention(cfg.attn_backend, qh, k_cache, v_cache, causal=False,
                  kv_len=min(pos + 1, w))
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


def mlp_axes(cfg) -> dict:
    """The logical axes of ``init_mlp``'s parameters."""
    if cfg.act == 'silu':
        return {'w_gate': ('embed', 'mlp'), 'w_up': ('embed', 'mlp'),
                'w_down': ('mlp', 'embed')}
    return {'w_up': ('embed', 'mlp'), 'b_up': ('mlp',),
            'w_down': ('mlp', 'embed'), 'b_down': ('embed',)}


def mlp_block(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == 'silu':
        h = F.silu(_mm(x, p['w_gate'])) * _mm(x, p['w_up'])
        h = logical(h, 'batch', 'seq', 'mlp')
        out = _mm(h, p['w_down'])
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(_mm(x, p['w_up']) + p['b_up'], approximate='tanh')
        h = logical(h, 'batch', 'seq', 'mlp')
        out = _mm(h, p['w_down']) + p['b_down']
    return logical(out, 'batch', 'seq', 'embed')


# ----------------------------------------------------------------------- MoE
def init_moe(cfg, gen: torch.Generator, dtype: torch.dtype) -> Params:
    """The reference's MoE parameters: ``router`` (d, E) in f32, the
    experts' ``w_gate`` and ``w_up`` (E, d, ff) and ``w_down`` (E, ff, d)
    in ``dtype``, each with fan-in on dim 1.  The experts are drawn one at
    a time (f32, then cast into their slice), so no f32 tensor of all
    experts is held: at Kimi-K2's width one would be 22.5 GB."""
    d, m = cfg.d_model, cfg.moe

    def experts(shape):
        out = torch.empty((m.n_experts,) + shape, dtype=dtype,
                          device=gen.device)
        for e in range(m.n_experts):
            out[e].copy_(mk_param(gen, shape, dtype))
        return out

    return {'router': mk_param(gen, (d, m.n_experts), f32),
            'w_gate': experts((d, m.d_ff)),
            'w_up': experts((d, m.d_ff)),
            'w_down': experts((m.d_ff, d))}


def moe_axes(cfg) -> dict:
    """The logical axes of ``init_moe``'s parameters."""
    return {'router': ('embed', None),
            'w_gate': ('experts', 'embed', 'expert_mlp'),
            'w_up': ('experts', 'embed', 'expert_mlp'),
            'w_down': ('experts', 'expert_mlp', 'embed')}


def _moe_group_count(n: int, target_group: int = 4096) -> int:
    """Token groups of ``moe_block``: ``n // target_group``, at least one
    per data-parallel shard of the installed rules' mesh (dispatch stays
    shard-local), lowered until it divides ``n``."""
    from ..sharding import current_rules, mesh_sizes
    r = current_rules()
    dp = 1
    if r is not None and r.mesh is not None:
        sizes = mesh_sizes(r.mesh)
        dp = sizes.get('pod', 1) * sizes.get('data', 1)
    g = min(n, max(dp, n // target_group))
    while n % g:
        g -= 1
    return max(g, 1)


@dataclasses.dataclass(frozen=True)
class MoERoute:
    """``moe_block``'s routing of x (B, S, d) in G groups of Sg tokens,
    P = Sg * k (token, choice) pairs a group, pair t * k + j for token t's
    j-th choice.  ``logits`` (G, Sg, E) f32; ``idx`` (G, Sg, k) experts,
    best first, and ``gates`` (G, Sg, k) their f32 softmax; ``order``
    (G, P) the stable sort of the pairs by expert, and in that order
    ``expert``, ``pos`` (the rank within the expert), ``keep`` (pos <
    ``cap``) and ``slot`` (expert * cap + pos, E * cap when dropped);
    ``starts`` and ``counts`` (G, E) each expert's first sorted pair and
    its pairs."""
    logits: torch.Tensor
    idx: torch.Tensor
    gates: torch.Tensor
    order: torch.Tensor
    expert: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor
    cap: int


def moe_route(cfg, p: Params, x: torch.Tensor) -> MoERoute:
    """The routing half of ``moe_block`` (the reference's, step for step):
    f32 router logits, top-k, a softmax over the k logits, a stable sort
    of the pairs by expert (``jnp.argsort`` is stable, and which pairs a
    full expert drops depends on the order), each pair's rank within its
    expert and the capacity ``cap = max(ceil(P / E * cf / 8) * 8, 8)``."""
    b, s, d = x.shape
    g = _moe_group_count(b * s)
    return _route_groups(cfg, p['router'], x.reshape(g, (b * s) // g, d))


def _route_groups(cfg, router: torch.Tensor, xg: torch.Tensor) -> MoERoute:
    """``moe_route`` of tokens already in groups, ``xg`` (G, Sg, d)."""
    m = cfg.moe
    g, sg, _ = xg.shape
    k, e = m.top_k, m.n_experts
    pairs = sg * k
    cap = max(int(math.ceil(pairs / e * m.capacity_factor / 8)) * 8, 8)
    dev = xg.device
    logits = xg.to(f32) @ router
    top, idx = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(top, dim=-1)
    pair_expert = idx.reshape(g, pairs)
    order = torch.argsort(pair_expert, dim=-1, stable=True)
    expert = torch.gather(pair_expert, 1, order)
    starts = torch.searchsorted(
        expert, torch.arange(e, device=dev).expand(g, e).contiguous(),
        side='left')
    pos = (torch.arange(pairs, device=dev)[None, :]
           - torch.gather(starts, 1, expert))
    keep = pos < cap
    slot = torch.where(keep, expert * cap + pos, e * cap)
    counts = torch.cat([starts[:, 1:], torch.full(
        (g, 1), pairs, dtype=starts.dtype, device=dev)], dim=1) - starts
    return MoERoute(logits, idx, gates, order, expert, pos, keep, slot,
                    starts, counts, cap)


# the ``torch.profiler.record_function`` label of ``_live_experts``' host
# read: a trace reads its host time (and count) under it
LIVE_EXPERTS_LABEL = 'moe.live_experts'


def _live_experts(counts: torch.Tensor) -> List[int]:
    """The experts that hold at least one pair (``counts`` (..., E)), read
    to the host once: the expert products run over these alone.  Under
    remat the recompute reads them again from the same routes: ``topk``,
    the stable sort and ``searchsorted`` are deterministic on the same
    input, ties included, so both reads agree.  A DTensor step reads no
    count (``_moe_block_sharded``)."""
    with torch.profiler.record_function(LIVE_EXPERTS_LABEL):
        per = counts.reshape(-1, counts.shape[-1]).sum(0).tolist()
    return [e for e, c in enumerate(per) if c]


def _expert_products(p: Params, live: List[int],
                     buf: torch.Tensor) -> torch.Tensor:
    """SwiGLU of each live expert over its rows: ``buf`` (..., L, R, d)
    with L = len(live) -> (..., L, R, d), the reference's
    ``silu(buf @ w_gate) * (buf @ w_up) @ w_down`` with JAX's promotion
    (``_mm``).  Each expert stack is split by one ``torch.unbind``, whose
    backward writes the experts' gradients into one stacked tensor
    (indexing ``w[e]`` would make a zero tensor of all E experts for each
    live one: 1.6 GB a Mixtral 8x22B matrix)."""
    wg, wu, wd = (torch.unbind(p[k]) for k in ('w_gate', 'w_up', 'w_down'))
    outs = []
    for j, e in enumerate(live):
        xe = buf[..., j, :, :]
        h = logical(F.silu(_mm(xe, wg[e])) * _mm(xe, wu[e]),
                    *(None,) * (xe.ndim - 1) + ('expert_mlp',))
        outs.append(_mm(h, wd[e]))
    return torch.stack(outs, dim=-3)


def _all_expert_products(p: Params, buf: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its capacity rows, batched over the
    experts: ``buf`` (G, E, cap, d) -> (G, E, cap, d), placed as the
    reference's expert buffers (experts over the EP axes, the capacity
    over TP)."""
    buf_e = logical(buf.transpose(0, 1), 'experts', None, 'moe_cap', 'embed')
    h = F.silu(_mm(buf_e, p['w_gate'], shared=1)) * _mm(buf_e, p['w_up'],
                                                        shared=1)
    h = logical(h, 'experts', None, 'moe_cap', None)
    y_e = logical(_mm(h, p['w_down'], shared=1), 'experts', None, 'moe_cap',
                  'embed')
    return logical(y_e.transpose(0, 1), 'batch', None, None, None)


def _compact_slots(live: torch.Tensor, n_experts: int,
                   expert: torch.Tensor, pos: torch.Tensor,
                   keep: torch.Tensor, cap: int) -> torch.Tensor:
    """A kept pair's row in the live experts' buffer (its expert's index
    in ``live`` * cap + pos), 0 for a dropped one (its row is multiplied
    by ``keep``'s 0, as the reference's clamped slot is)."""
    lut = torch.zeros(n_experts, dtype=torch.long, device=expert.device)
    lut[live] = torch.arange(len(live), device=expert.device)
    return torch.where(keep, lut[expert] * cap + pos, 0)


def moe_block(cfg, p: Params, x: torch.Tensor):
    """Top-k MoE with per-group capacity dispatch (the reference's
    ``moe_block``, step for step): x (B, S, d) -> (out (B, S, d), the
    GShard load-balance loss).  ``moe_route`` routes; each expert's
    buffer row c of a group is the group's c-th pair sorted to that
    expert (zero past its count, the pairs past ``cap`` dropped); the
    expert products are SwiGLU with JAX's promotion; each kept pair's
    output comes back through the inverse sort, and a token's output is
    the sum over its k choices of output times gate (the gate in x's
    dtype).  The output's dtype is the promoted one (f32 for f32
    parameters under bf16 activations), as the reference's.

    Deviation in cost, not in function: the reference multiplies all E
    experts' (G, cap, d) buffers.  Here the per-expert pair counts are
    read to the host once a call (E ints) and the products run over the
    experts that hold a pair; an empty expert's rows are never read back,
    so the output is the same.  Over all E, Kimi-K2's decode would read
    33.8 GB of expert weights a token and layer instead of ~0.7 GB."""
    if is_dtensor(x):
        return _moe_block_sharded(cfg, p, x)
    b, s, d = x.shape
    k = cfg.moe.top_k
    r = moe_route(cfg, p, x)
    g, pairs = r.order.shape
    xg = logical(x.reshape(g, pairs // k, d), 'batch', None, None)
    live = _live_experts(r.counts)
    buf, rows, inv = _moe_pack(cfg, r, xg, live)
    y = _expert_products(p, live, buf)
    out = logical(_moe_unpack(cfg, y, rows, r.keep, inv, r.gates, x.dtype),
                  'batch', None, None)
    return (logical(out.reshape(b, s, d), 'batch', 'seq', 'embed'),
            _moe_aux(cfg, r.logits, r.counts))


def _moe_pack(cfg, r: MoERoute, xg: torch.Tensor,
              live: Optional[List[int]] = None):
    """The dispatch half of a rank's groups: xg (G, Sg, d) routed by ``r``
    -> (buf (G, L, cap, d): row c of expert e's buffer the group's c-th
    pair sorted to e, zero past its count; rows (G, P): a sorted pair's
    row in ``buf`` flattened (0 for a dropped pair); inv (G, P): the
    inverse of the sort).  The experts ``live`` (L of them), or every
    expert at capacity for None."""
    k, e = cfg.moe.top_k, cfg.moe.n_experts
    g, pairs = r.order.shape
    d, cap = xg.shape[-1], r.cap
    xk = torch.gather(xg, 1, (r.order // k)[..., None].expand(g, pairs, d))
    xk_pad = torch.cat([xk, xk.new_zeros((g, 1, d))], dim=1)
    if live is None:
        cnt, st = r.counts[..., None], r.starts[..., None]
        rows = torch.where(r.keep, r.slot, 0)
    else:
        lt = torch.tensor(live, device=xg.device)
        cnt, st = r.counts[:, lt, None], r.starts[:, lt, None]
        rows = _compact_slots(lt, e, r.expert, r.pos, r.keep, cap)
    cgrid = torch.arange(cap, device=xg.device)
    src = torch.where(cgrid < cnt, st + cgrid, pairs)       # (G, L, cap)
    buf = torch.gather(xk_pad, 1, src.reshape(g, -1, 1).expand(-1, -1, d))
    inv = torch.empty_like(r.order).scatter_(
        1, r.order, torch.arange(pairs, device=xg.device).expand(g, pairs))
    return buf.reshape(g, -1, cap, d), rows, inv


def _moe_unpack(cfg, y: torch.Tensor, rows: torch.Tensor,
                keep: torch.Tensor, inv: torch.Tensor, gates: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """The combine half: the expert outputs y (G, L, cap, d) back to the
    pairs through the inverse sort (a dropped pair's zeroed by ``keep``),
    a token's output the sum over its k choices of output times gate (the
    gate and ``keep`` in x's ``dtype``) -> (G, Sg, d)."""
    k = cfg.moe.top_k
    g, pairs = rows.shape
    d = y.shape[-1]
    ys = torch.gather(y.reshape(g, -1, d), 1,
                      rows[..., None].expand(g, pairs, d))
    ys = ys * keep[..., None].to(dtype)
    yp = torch.gather(ys, 1, inv[..., None].expand(g, pairs, d))
    return (yp.reshape(g, pairs // k, k, d)
            * gates[..., None].to(dtype)).sum(dim=2)


def _moe_aux(cfg, logits: torch.Tensor, counts: torch.Tensor):
    """GShard's load-balance loss from the groups' router logits (G, Sg,
    E) and expert loads ``counts`` (G, E)."""
    m = cfg.moe
    g, sg = logits.shape[:2]
    probs_mean = torch.softmax(logits, dim=-1).mean(dim=(0, 1))
    load = counts.sum(0).to(f32) / (g * sg) / m.top_k
    return (probs_mean * load).sum() * m.n_experts


def _moe_block_sharded(cfg, p: Params, x: torch.Tensor):
    """``moe_block`` on DTensors, the reference's hierarchical dispatch:
    the token groups split over the ranks that split the batch (whole
    groups a rank: ``_moe_group_count`` takes a group per data-parallel
    shard at least), each rank routes and packs its own groups' capacity
    buffers and unpacks their outputs (``_moe_pack`` and ``_moe_unpack``
    under ``run_local``: the sorts and gathers need nothing from another
    rank), and only the expert products move: the buffers to the experts'
    ranks (experts over the EP axes, the capacity over TP) and back.
    Every expert runs at capacity (no count is read to the host), as in
    the reference's own dry run."""
    from torch.distributed.tensor import Replicate, Shard
    b, s, d = x.shape
    g = _moe_group_count(b * s)
    sg = (b * s) // g
    x = logical(x, 'batch', 'seq', 'embed')
    pl = tuple(q if isinstance(q, Shard) and q.dim == 0 else Replicate()
               for q in x.placements)
    if tuple(x.placements) != pl:
        x = x.redistribute(x.device_mesh, pl)

    def dispatch(xl, router):
        if (xl.shape[0] * s) % sg:
            raise ValueError(f'moe_block: a rank\'s {xl.shape[0]} x {s} '
                             f'tokens are not whole groups of {sg}')
        xl = xl.reshape(-1, sg, d)
        r = _route_groups(cfg, router, xl)
        return (*_moe_pack(cfg, r, xl), r.keep, r.gates, r.logits, r.counts)

    buf, rows, inv, keep, gates, logits, counts = run_local(
        dispatch, [x, replicated(p['router'])], (pl,) * 7)
    y = _all_expert_products(p, buf)
    out = run_local(lambda *a: _moe_unpack(cfg, *a, x.dtype).reshape(
        -1, s, d), [y, rows, keep, inv, gates], pl)
    return logical(out, 'batch', 'seq', 'embed'), _moe_aux(cfg, logits,
                                                           counts)


def moe_block_global(cfg, p: Params, x: torch.Tensor):
    """The reference's ablation baseline ``moe_block_global``: one global
    stable sort of all N * k pairs, capacity ``ceil(N k / E * cf / 8) *
    8``, the buffer filled by a scatter in x's dtype, and the pairs'
    outputs scattered back into x's dtype (bf16 under bf16 activations,
    where ``moe_block`` keeps the promoted dtype) before the gate sum; its
    own aux loss, mean(load * mean prob) * E².  The expert products run
    over the experts that hold a pair, as in ``moe_block``."""
    m = cfg.moe
    b, s, d = x.shape
    n = b * s
    k, e = m.top_k, m.n_experts
    dev = x.device
    xf = logical(x.reshape(n, d), 'batch', None)
    logits = xf.to(f32) @ p['router']
    top, idx = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(top, dim=-1)
    pair_expert = idx.reshape(-1)
    perm = torch.argsort(pair_expert, stable=True)
    expert = pair_expert[perm]
    counts = torch.bincount(pair_expert, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n * k, device=dev) - starts[expert]
    cap = int(math.ceil(n * k / e * m.capacity_factor / 8)) * 8
    keep = pos < cap
    live = _live_experts(counts)
    rows = _compact_slots(torch.tensor(live, device=dev), e, expert, pos,
                          keep, cap)
    buf = x.new_zeros((len(live) * cap, d))
    buf[rows[keep]] = xf[(perm // k)[keep]]
    buf = logical(buf.reshape(len(live), cap, d), 'experts', None, 'embed')
    y = _expert_products(p, live, buf)
    y = logical(y, 'experts', None, 'embed').reshape(len(live) * cap, d)
    y_sorted = y[rows] * keep[:, None].to(x.dtype)
    y_pairs = x.new_zeros((n * k, d))
    y_pairs[perm] = y_sorted.to(x.dtype)
    out = (y_pairs.reshape(n, k, d) * gates[..., None].to(x.dtype)).sum(1)
    me = torch.softmax(logits, dim=-1).mean(dim=0)
    ce = ((counts.to(f32) / (n * k)) * me).mean() * e * e
    return logical(out.reshape(b, s, d), 'batch', 'seq', 'embed'), ce


# ----------------------------------------------------------------- embedding
def init_embedding(cfg, gen: torch.Generator, dtype: torch.dtype) -> Params:
    p = {'table': mk_param(gen, (cfg.vocab_size, cfg.d_model), dtype,
                           scale=0.02)}
    if not cfg.tie_embeddings:
        p['unembed'] = mk_param(gen, (cfg.d_model, cfg.vocab_size), dtype)
    return p


def embedding_axes(cfg) -> dict:
    """The logical axes of ``init_embedding``'s parameters."""
    ax = {'table': ('vocab', 'embed')}
    if not cfg.tie_embeddings:
        ax['unembed'] = ('embed', 'vocab')
    return ax


def embed(cfg, p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The table's rows at ``tokens``.  Through ``F.embedding``, whose
    backward sums each row's gradients in a fixed order; indexing's
    (``index_put_`` with accumulate) adds them in thread order on the CPU,
    so two runs of a step would differ in their last bits."""
    if is_dtensor(p['table']):
        x = _embed_sharded(tokens, p['table'])
    else:
        x = F.embedding(tokens, p['table'])
    return logical(x.to(cfg.adtype()), 'batch', 'seq', 'embed')


def _embed_sharded(tokens: torch.Tensor, table: torch.Tensor
                   ) -> torch.Tensor:
    """``F.embedding`` of a DTensor table: a vocabulary-parallel lookup
    where the table's rows are split (each rank looks up the tokens in its
    rows, zero elsewhere: a partial sum over that mesh dimension), the
    table gathered on any other mesh dimension that splits it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tab_pl, tok_pl, out_pl = [], [], []
    for m in range(mesh.ndim):
        vocab = isinstance(table.placements[m], Shard) and \
            table.placements[m].dim == 0
        tp = tokens.placements[m]
        tab_pl.append(Shard(0) if vocab else Replicate())
        tok_pl.append(tp if isinstance(tp, Shard) and not vocab
                      else Replicate())
        out_pl.append(Partial() if vocab else tok_pl[-1])
    if list(table.placements) != tab_pl:
        table = table.redistribute(mesh, tab_pl)
    if list(tokens.placements) != tok_pl:
        tokens = tokens.redistribute(mesh, tok_pl)
    rows = [m for m in range(mesh.ndim) if isinstance(tab_pl[m], Shard)]

    def local(tok, tab):
        if not rows:
            return F.embedding(tok, tab)
        v0 = mesh.get_coordinate()[rows[0]] * tab.shape[0]
        idx = tok.long() - v0
        hit = (idx >= 0) & (idx < tab.shape[0])
        out = F.embedding(idx.clamp(0, tab.shape[0] - 1), tab)
        return out * hit[..., None].to(out.dtype)

    return run_local(local, [tokens, table], tuple(out_pl))


def unembed(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    w = p['table'].T if cfg.tie_embeddings else p['unembed']
    if is_dtensor(x) or is_dtensor(w):
        logits = _mm(x, w.to(x.dtype))
    else:
        logits = x @ w.to(x.dtype)
    return logical(logits, 'batch', 'seq', 'vocab')


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy, f32 logsumexp over the vocabulary.  On
    DTensors each rank takes its tokens and its slice of the vocabulary
    (``_xent_sharded``)."""
    if is_dtensor(logits):
        return _xent_sharded(logits, labels)
    logits = logits.to(f32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


class _VocabParallelXent(torch.autograd.Function):
    """Per-token cross entropy of logits whose vocabulary is split over a
    mesh dimension: each rank holds (b, s, v) from vocabulary row ``v0``;
    the max, the sum of exponentials and the gold logit are all-reduced
    over ``group``.  The backward is local: softmax minus the one-hot."""

    @staticmethod
    def forward(ctx, logits, labels, v0: int, group):
        import torch.distributed._functional_collectives as funcol
        x = logits.to(f32)
        m = funcol.wait_tensor(funcol.all_reduce(
            x.amax(dim=-1), 'max', group))
        se = funcol.wait_tensor(funcol.all_reduce(
            torch.exp(x - m[..., None]).sum(-1), 'sum', group))
        lse = m + torch.log(se)
        local = labels.long() - v0
        hit = (local >= 0) & (local < x.shape[-1])
        gold = x.gather(-1, local.clamp(0, x.shape[-1] - 1)[..., None])[..., 0]
        gold = funcol.wait_tensor(funcol.all_reduce(
            torch.where(hit, gold, 0.0), 'sum', group))
        ctx.save_for_backward(x, lse, local, hit)
        ctx.dtype = logits.dtype
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        x, lse, local, hit = ctx.saved_tensors
        p = torch.exp(x - lse[..., None])
        onehot = torch.zeros_like(p).scatter_(
            -1, local.clamp(0, x.shape[-1] - 1)[..., None],
            hit[..., None].to(p.dtype))
        return ((p - onehot) * g[..., None]).to(ctx.dtype), None, None, None


def _xent_sharded(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """``softmax_xent`` of DTensor logits (B, S, V): the tokens stay on
    their ranks, the vocabulary's mesh dimension (if any) is reduced over
    by ``_VocabParallelXent``, and only the (B, S) per-token losses meet
    in the mean."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = logits.device_mesh
    pl = [p if isinstance(p, Shard) else Replicate()
          for p in logits.placements]
    vocab = [m for m, p in enumerate(pl)
             if isinstance(p, Shard) and p.dim == logits.ndim - 1]
    for m in vocab[1:]:
        pl[m] = Replicate()
    vocab = vocab[:1]
    if list(logits.placements) != pl:
        logits = logits.redistribute(mesh, pl)
    tok_pl = [Replicate() if m in vocab or not isinstance(p, Shard) else p
              for m, p in enumerate(pl)]
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    labels = labels.redistribute(mesh, tok_pl)

    def local(lg, lb):
        if not vocab:
            x = lg.to(f32)
            return torch.logsumexp(x, dim=-1) - x.gather(
                -1, lb.long()[..., None])[..., 0]
        m = vocab[0]
        v0 = mesh.get_coordinate()[m] * lg.shape[-1]
        return _VocabParallelXent.apply(lg, lb, v0, (mesh, m))

    return run_local(local, [logits, labels], tuple(tok_pl)).mean()
