"""Decoder-only LM of the port (the dense and the MoE families): init,
full-sequence forward, loss, KV cache and one-token decode.

Counterpart of the decoder-only part of ``repro.models.transformer``.
Block parameters are stacked over a leading layer axis, as the reference's
scanned stack is, so carrying weights across is a copy; the reference's
``lax.scan`` over layers is a Python loop over that axis here.
``forward_lm`` splits the stack once (``torch.unbind``, whose backward
stacks), so each layer's gradient is written once into the stacked
gradient; indexing ``a[i]`` per layer would materialise a zero tensor of
the whole stack per layer and leaf in the backward.  Under grad each
layer runs under ``cfg.remat`` (``_maybe_remat``, the reference's
counterpart: ``torch.utils.checkpoint``); a serving forward has no grad
and no remat.  An MoE config's blocks hold ``moe`` (``layers.moe_block``)
in place of ``mlp``, and ``forward_lm`` returns the sum of their
load-balance losses.  The encoder-decoder and cross-attention paths
(``_encoder``, ``_cross_block``, ``precompute_cross_kv``) come with their
families (ROADMAP queue 1, item 3).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List

import torch
from torch.utils import checkpoint as ckpt

from ..configs import ArchConfig
from ..tree import leaves, tree_map, unflatten_like
from . import layers as L

Params = Dict[str, Any]


def _self_attention_only(cfg: ArchConfig) -> None:
    if cfg.cross_attn_every or cfg.n_encoder_layers:
        raise NotImplementedError(
            f'{cfg.name}: cross-attention and encoder-decoder stacks are '
            f'not ported yet (ROADMAP queue 1, item 3)')


# ------------------------------------------------------------------ init
def _init_block(cfg: ArchConfig, gen: torch.Generator) -> Params:
    dtype = cfg.dtype()
    return {'ln1': L.init_norm(cfg, dtype, gen.device),
            'attn': L.init_attention(cfg, gen, dtype),
            'ln2': L.init_norm(cfg, dtype, gen.device),
            **({'moe': L.init_moe(cfg, gen, dtype)} if cfg.moe is not None
               else {'mlp': L.init_mlp(cfg, gen, dtype)})}


def _stack_init(init_fn: Callable[[], Params], n: int) -> Params:
    """``n`` draws of ``init_fn()`` stacked over a new leading axis,
    written slice by slice into tensors allocated once, so that the stack
    is never held twice (at Qwen3-14B's width one stacked ``w_gate`` is
    7.1 GB in bf16) and at most one draw is held beside it: n + 1 layers
    at the peak (one layer of Kimi-K2 is 34 GB).  One draw is its own
    stack (a view with a leading axis of 1), so a one-layer init holds
    one layer."""
    blk = init_fn()
    if n == 1:
        return tree_map(lambda a: a.unsqueeze(0), blk)
    stack = tree_map(lambda a: a.new_empty((n,) + a.shape), blk)
    for i in range(n):
        if i:
            blk = init_fn()
        tree_map(lambda s, a: s[i].copy_(a), stack, blk)
        del blk
    return stack


def init_lm(cfg: ArchConfig, generator: torch.Generator = None,
            device='cuda') -> Params:
    """Random weights for ``cfg`` drawn on ``device`` from ``generator``
    (which lives there; a fresh one seeded 0 when None): ``{'embed',
    'blocks', 'final_norm'}`` with the reference's names and layouts.
    (The reference also returns logical sharding axes; one card has
    none.)"""
    _self_attention_only(cfg)
    dev = torch.device(device)
    gen = (torch.Generator(dev).manual_seed(0) if generator is None
           else generator)
    if gen.device.type != dev.type:
        raise ValueError(f'init_lm: generator on {gen.device}, weights on '
                         f'{dev}')
    return {'embed': L.init_embedding(cfg, gen, cfg.dtype()),
            'blocks': _stack_init(lambda: _init_block(cfg, gen),
                                  cfg.n_layers),
            'final_norm': L.init_norm(cfg, cfg.dtype(), gen.device)}


def layer(params: Params, i: int) -> Params:
    """Layer ``i``'s block parameters: views into the stack."""
    return tree_map(lambda a: a[i], params['blocks'])


def unstack_layers(params: Params) -> List[Params]:
    """Every layer's block parameters, from one ``torch.unbind`` of each
    stacked leaf: views whose gradients the unbind's backward stacks into
    one tensor per leaf."""
    blocks = params['blocks']
    cols = [torch.unbind(a) for a in leaves(blocks)]
    return [unflatten_like(blocks, [c[i] for c in cols])
            for i in range(len(cols[0]))]


# ------------------------------------------------------------------ blocks
def _ffn(cfg: ArchConfig, p: Params, h: torch.Tensor):
    """The block's feed-forward half: (y, aux), aux the MoE block's
    load-balance loss (0.0 for the dense MLP)."""
    if cfg.moe is not None:
        return L.moe_block(cfg, p['moe'], h)
    return L.mlp_block(cfg, p['mlp'], h), 0.0


def _self_block(cfg: ArchConfig, p: Params, x: torch.Tensor, cos_sin,
                window):
    dt = x.dtype
    h = L.apply_norm(cfg, p['ln1'], x)
    x = (x + L.attention_block(cfg, p['attn'], h, cos_sin=cos_sin,
                               causal=True, window=window)).to(dt)
    y, aux = _ffn(cfg, p, L.apply_norm(cfg, p['ln2'], x))
    return (x + y).to(dt), aux


REMATS = ('none', 'full', 'dots')
# the products whose outputs ``remat='dots'`` keeps: matrix products with
# no batch dimension (the port's projections reach ``mm``; attention's
# batched products and everything elementwise are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(cfg: ArchConfig, fn: Callable) -> Callable:
    """``fn`` under ``cfg.remat`` when grad mode is on: ``full``
    recomputes the whole call in the backward, ``dots`` keeps only the
    outputs of products with no batch dimension (the reference's
    ``dots_with_no_batch_dims_saveable``), ``none`` keeps everything.
    Nothing in a layer draws random numbers, so no RNG state is kept."""
    if cfg.remat not in REMATS:
        raise ValueError(f'remat {cfg.remat!r}, expected one of {REMATS}')
    if cfg.remat == 'none' or not torch.is_grad_enabled():
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat == 'dots':
        kw['context_fn'] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return lambda *args: ckpt.checkpoint(fn, *args, **kw)


def forward_lm(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
               source=None):
    """Full-sequence forward (train / prefill): tokens (B, S) -> (logits
    (B, S, V), aux loss: the sum over layers of the MoE blocks' losses,
    0.0 for a dense config).  Attention runs causal with
    ``cfg.sliding_window`` on ``cfg.attn_backend`` (K8's prefill on CUDA
    tensors under ``auto``)."""
    _self_attention_only(cfg)
    if source is not None:
        raise NotImplementedError('forward_lm: a source (audio frames, '
                                  'image patches) needs the cross-attention '
                                  'families (ROADMAP queue 1, item 3)')
    x = L.embed(cfg, params['embed'], tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    cos_sin = L.rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    block = _maybe_remat(cfg, functools.partial(_self_block, cfg))
    aux_total = 0.0
    for blk in unstack_layers(params):
        x, aux = block(blk, x, cos_sin, cfg.sliding_window)
        aux_total = aux_total + aux
    x = L.apply_norm(cfg, params['final_norm'], x)
    return L.unembed(cfg, params['embed'], x), aux_total


def loss_fn(cfg: ArchConfig, params: Params, batch) -> torch.Tensor:
    logits, aux = forward_lm(cfg, params, batch['tokens'],
                             source=batch.get('source'))
    return L.softmax_xent(logits, batch['labels']) + 0.01 * aux


# ------------------------------------------------------------------ serving
def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device='cuda') -> Params:
    """The KV cache: ``{'k', 'v'}``, each (layers, B, Hkv, W, hd) in the
    activation dtype, zero, a ring of W = min(``cfg.sliding_window`` or
    max_seq, max_seq) slots (the reference's W).

    Layout deviation from the reference's (layers, B, W, Hkv, hd) plus its
    slot -> position array ``pos``: K8 reads (B, Hkv, Sk, hd) contiguous,
    so the port stores that layout and ``attention_decode`` writes each
    new row in place (a transpose of the reference's layout would copy the
    whole cache every layer and step).  Position t lives in slot t % W, as
    in the reference, and a cache filled in order holds positions
    pos - W + 1 .. pos, which is what the reference's ``pos`` array says;
    so the port keeps no ``pos`` (``attention_decode``)."""
    _self_attention_only(cfg)
    w = min(cfg.sliding_window or max_seq, max_seq)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, w,
             cfg.resolved_head_dim)
    return {'k': torch.zeros(shape, dtype=cfg.adtype(), device=device),
            'v': torch.zeros(shape, dtype=cfg.adtype(), device=device)}


def decode_step(cfg: ArchConfig, params: Params, cache: Params,
                tokens: torch.Tensor, pos: int):
    """One decode step: tokens (B, 1) at position ``pos`` (a Python int,
    the same for every row).  Writes the new K/V rows into ``cache`` in
    place (slot ``pos % W``) and returns (logits (B, 1, V), cache); an
    MoE block routes the B tokens as one group (the aux loss dropped, as
    the reference drops it)."""
    pos = int(pos)
    adt = cfg.adtype()
    x = L.embed(cfg, params['embed'], tokens)
    positions = torch.full((1,), pos, dtype=torch.float32,
                           device=tokens.device)
    cos_sin = L.rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    for i in range(cfg.n_layers):
        blk = layer(params, i)
        h = L.apply_norm(cfg, blk['ln1'], x)
        o = L.attention_decode(cfg, blk['attn'], h,
                               {'k': cache['k'][i], 'v': cache['v'][i]},
                               pos=pos, cos_sin=cos_sin,
                               window=cfg.sliding_window)
        x = (x + o).to(adt)
        y, _ = _ffn(cfg, blk, L.apply_norm(cfg, blk['ln2'], x))
        x = (x + y).to(adt)
    x = L.apply_norm(cfg, params['final_norm'], x)
    return L.unembed(cfg, params['embed'], x), cache
