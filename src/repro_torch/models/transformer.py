"""The LM of the port (the dense, MoE, VLM and encoder-decoder families):
init, full-sequence forward, loss, KV cache, cross K/V and one-token decode.

Counterpart of ``repro.models.transformer``.  Block parameters are stacked
over leading layer axes, as the reference's scanned stacks are, so carrying
weights across is a copy: ``blocks`` (layers, ...), and for the VLM (one
cross layer in ``cfg.cross_attn_every``) ``blocks`` (groups, per - 1, ...)
and ``cross`` (groups, ...); the encoder-decoder (audio) adds
``enc_blocks`` (encoder layers, ...), ``enc_cross`` (layers, ...) and
``enc_norm``.  The reference's ``lax.scan`` over layers is a Python loop
over those axes here.  ``forward_lm`` splits each stack once
(``unbind``), so each layer's gradient is written once into the stacked
gradient, as soon as that layer's backward is done; indexing ``a[i]`` per
layer would materialise a zero tensor of the whole stack per layer and
leaf in the backward.  Under grad each scan body (a layer; an audio
layer's self and cross block; a VLM group) runs under ``cfg.remat``
(``_maybe_remat``, the reference's counterpart:
``torch.utils.checkpoint``); a serving forward has no grad and no remat.
An MoE config's blocks hold ``moe`` (``layers.moe_block``) in place of
``mlp``, and ``forward_lm`` returns the sum of their load-balance losses.

The cross-attention families serve through ``precompute_cross_kv`` (once
per request: the encoder, or the image patches' projections) and
``decode_step(..., cross_kv=)``, as the reference's own test and dry run
do; the reference's ``SlotServer`` passes no source (ROADMAP R4).
"""
from __future__ import annotations

import functools
import itertools
import math
from typing import Any, Callable, Dict, Optional, Sequence, Union

import torch
from torch.utils import checkpoint as ckpt

from ..configs import ArchConfig
from ..sharding import is_dtensor
from ..tree import leaves, tree_map, unflatten_like
from . import layers as L

Params = Dict[str, Any]


def _has_cross(cfg: ArchConfig) -> bool:
    return bool(cfg.cross_attn_every or cfg.n_encoder_layers)


# ------------------------------------------------------------------ init
def _init_block(cfg: ArchConfig, gen: torch.Generator,
                cross: bool = False) -> Params:
    dtype = cfg.dtype()
    return {'ln1': L.init_norm(cfg, dtype, gen.device),
            'attn': L.init_attention(cfg, gen, dtype, cross=cross),
            'ln2': L.init_norm(cfg, dtype, gen.device),
            **({'moe': L.init_moe(cfg, gen, dtype)} if cfg.moe is not None
               else {'mlp': L.init_mlp(cfg, gen, dtype)})}


def _stack_init(init_fn: Callable[[], Params],
                shape: Union[int, Sequence[int]]) -> Params:
    """Draws of ``init_fn()`` stacked over new leading axes of ``shape``
    (an int, or a tuple such as the VLM's (groups, per - 1)), in
    row-major order, written slice by slice into tensors allocated once,
    so that the stack is never held twice (at Qwen3-14B's width one
    stacked ``w_gate`` is 7.1 GB in bf16) and at most one draw is held
    beside it: the stack plus one layer at the peak (one layer of Kimi-K2
    is 34 GB; of Llama-3.2-Vision 1.7 GB, whose 7-group cut would hold a
    6.8 GB group beside the stack if groups were stacked in turn).  One
    draw is its own stack (a view with leading axes of 1), so a one-layer
    init holds one layer."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    blk = init_fn()
    if L.is_fake_mode():       # shapes alone: nothing to draw or copy
        return tree_map(lambda a: a.new_empty(shape + a.shape), blk)
    if math.prod(shape) == 1:
        return tree_map(lambda a: a.reshape(shape + a.shape), blk)
    stack = tree_map(lambda a: a.new_empty(shape + a.shape), blk)
    for n, idx in enumerate(itertools.product(*map(range, shape))):
        if n:
            blk = init_fn()
        tree_map(lambda s, a: s[idx].copy_(a), stack, blk)
        del blk
    return stack


def init_lm(cfg: ArchConfig, generator: torch.Generator = None,
            device='cuda') -> Params:
    """Random weights for ``cfg`` drawn on ``device`` from ``generator``
    (which lives there; a fresh one seeded 0 when None), with the
    reference's names and layouts: ``{'embed', 'blocks', 'final_norm'}``,
    plus ``cross`` for the VLM and ``enc_blocks``, ``enc_cross`` and
    ``enc_norm`` for the encoder-decoder.  (The reference also returns
    logical sharding axes; one card has none.)"""
    dev = torch.device(device)
    gen = (torch.Generator(dev).manual_seed(0) if generator is None
           else generator)
    if gen.device.type != dev.type:
        raise ValueError(f'init_lm: generator on {gen.device}, weights on '
                         f'{dev}')
    block = lambda: _init_block(cfg, gen)
    cross = lambda: _init_block(cfg, gen, cross=True)
    params = {'embed': L.init_embedding(cfg, gen, cfg.dtype())}
    if cfg.cross_attn_every:          # vlm: groups of (per - 1 self + 1 cross)
        per = cfg.cross_attn_every
        n_groups = cfg.n_layers // per
        params['blocks'] = _stack_init(block, (n_groups, per - 1))
        params['cross'] = _stack_init(cross, n_groups)
    else:
        params['blocks'] = _stack_init(block, cfg.n_layers)
    if cfg.n_encoder_layers:          # audio encoder-decoder
        params['enc_blocks'] = _stack_init(block, cfg.n_encoder_layers)
        params['enc_cross'] = _stack_init(cross, cfg.n_layers)
        params['enc_norm'] = L.init_norm(cfg, cfg.dtype(), gen.device)
    params['final_norm'] = L.init_norm(cfg, cfg.dtype(), gen.device)
    return params


def _block_axes(cfg: ArchConfig, cross: bool = False) -> dict:
    return {'ln1': L.norm_axes(cfg),
            'attn': L.attention_axes(cfg, cross=cross),
            'ln2': L.norm_axes(cfg),
            **({'moe': L.moe_axes(cfg)} if cfg.moe is not None
               else {'mlp': L.mlp_axes(cfg)})}


def stacked_axes(axes, n_lead: int = 1):
    """``axes`` with ``n_lead`` leading ``'layers'`` axes on every leaf
    (the reference's ``_stack_init`` adds one a stacking)."""
    from ..sharding import map_axes
    return map_axes(lambda a: ('layers',) * n_lead + a, axes)


def lm_axes(cfg: ArchConfig) -> dict:
    """The logical axes of ``init_lm``'s parameters, leaf for leaf (the
    reference's ``init_lm`` returns them beside its parameters)."""
    ax = {'embed': L.embedding_axes(cfg)}
    if cfg.cross_attn_every:
        ax['blocks'] = stacked_axes(_block_axes(cfg), 2)
        ax['cross'] = stacked_axes(_block_axes(cfg, cross=True))
    else:
        ax['blocks'] = stacked_axes(_block_axes(cfg))
    if cfg.n_encoder_layers:
        ax['enc_blocks'] = stacked_axes(_block_axes(cfg))
        ax['enc_cross'] = stacked_axes(_block_axes(cfg, cross=True))
        ax['enc_norm'] = L.norm_axes(cfg)
    ax['final_norm'] = L.norm_axes(cfg)
    return ax


def layer(params: Params, i: int) -> Params:
    """Layer ``i``'s block parameters of a one-axis ``blocks`` stack (a
    VLM's group ``i``): views into the stack."""
    return tree_map(lambda a: a[i], params['blocks'])


class _StackGrad:
    """The gradient of one stacked leaf, written a slice at a time by
    ``_Sink`` and handed to autograd whole by ``_Unbind``.  Of a DTensor
    stack it is a DTensor placed as the stack is, each rank writing its
    shard of each slice."""

    def __init__(self, like: torch.Tensor):
        self.shape, self.dtype, self.device = like.shape, like.dtype, \
            like.device
        self.mesh = self.placements = None
        if is_dtensor(like):
            self.mesh, self.placements = like.device_mesh, like.placements
        self.buf: Optional[torch.Tensor] = None

    def write(self, i: int, g: torch.Tensor) -> None:
        """Slice i of the gradient is ``g``."""
        if self.mesh is None:
            if self.buf is None:
                self.buf = torch.zeros(self.shape, dtype=self.dtype,
                                       device=self.device)
            self.buf[i].copy_(g)
            return
        from torch.distributed.tensor import Shard, zeros
        if self.buf is None:
            self.buf = zeros(self.shape, dtype=self.dtype,
                             device_mesh=self.mesh,
                             placements=self.placements)
        row = [Shard(p.dim - 1) if isinstance(p, Shard) else p
               for p in self.placements]
        self.buf.to_local()[i].copy_(g.redistribute(self.mesh, row)
                                     .to_local())


class _Unbind(torch.autograd.Function):
    """``torch.unbind`` of a stack whose backward returns the gradient
    that its slices' ``_Sink`` nodes wrote, instead of stacking the
    slices' gradients (which would hold them and their stack at once:
    9.7 GB twice for a Mixtral 8x22B expert matrix at 6 layers)."""

    @staticmethod
    def forward(ctx, stack, grad: _StackGrad):
        ctx.set_materialize_grads(False)
        ctx.grad = grad
        return stack.unbind(0)

    @staticmethod
    def backward(ctx, *_):
        buf, ctx.grad.buf = ctx.grad.buf, None
        return buf, None


class _Sink(torch.autograd.Function):
    """Slice i of an ``_Unbind``: the identity, whose backward copies the
    slice's gradient into the stack's and passes on a zero of no memory.
    Made just before the layer that reads it, so autograd runs it as soon
    as that layer's backward is done and frees the slice's gradient."""

    @staticmethod
    def forward(ctx, view, grad: _StackGrad, i: int):
        ctx.grad, ctx.i = grad, i
        return view.view_as(view)

    @staticmethod
    def backward(ctx, g):
        ctx.grad.write(ctx.i, g)
        return g.new_zeros(()).expand(g.shape), None, None


class _Slices:
    """The slices of a stack (``unbind``), each made when first read."""

    def __init__(self, stack: Params):
        self.stack, self.cols, self.made = stack, [], {}
        for a in leaves(stack):
            if torch.is_grad_enabled() and a.requires_grad:
                acc = _StackGrad(a)
                self.cols.append((_Unbind.apply(a, acc), acc))
            else:
                self.cols.append((torch.unbind(a), None))

    def __len__(self) -> int:
        return len(self.cols[0][0])

    def __getitem__(self, i: int) -> Params:
        if i not in self.made:
            self.made[i] = unflatten_like(self.stack, [
                v[i] if acc is None else _Sink.apply(v[i], acc, i)
                for v, acc in self.cols])
        return self.made[i]

    def __iter__(self):
        return (self[i] for i in range(len(self)))


def unbind(stack: Params) -> Sequence[Params]:
    """The slices of a stack along its leading axis: views of each stacked
    leaf.  Under grad each leaf's gradient is written into one tensor
    slice by slice as the layers' backwards finish (``_Unbind``,
    ``_Sink``), the same bits as ``torch.unbind``'s backward, which
    stacks all the slices' gradients at the end."""
    return _Slices(stack)


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


def _cross_block(cfg: ArchConfig, p: Params, x: torch.Tensor,
                 source: torch.Tensor):
    """A cross block: attention from x to ``source`` (B, F, d), non-causal
    with no RoPE (``layers.attention_block(..., kv_src=)``), then the
    block's own feed-forward half."""
    dt = x.dtype
    h = L.apply_norm(cfg, p['ln1'], x)
    x = (x + L.attention_block(cfg, p['attn'], h, cos_sin=None,
                               kv_src=source)).to(dt)
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


def _encoder(cfg: ArchConfig, params: Params,
             frames: torch.Tensor) -> torch.Tensor:
    """The audio encoder over the stub frame embeddings (B, F, d):
    bidirectional self attention with RoPE over the frame positions (the
    reference's; the stub frontend has no position table), the GELU MLP,
    ``enc_norm`` at the end."""
    x = frames.to(cfg.adtype())
    cos_sin = L.rope_cos_sin(torch.arange(x.shape[1], device=x.device),
                             cfg.resolved_head_dim, cfg.rope_theta)

    def body(blk, x):
        dt = x.dtype
        h = L.apply_norm(cfg, blk['ln1'], x)
        x = (x + L.attention_block(cfg, blk['attn'], h, cos_sin=cos_sin,
                                   causal=False)).to(dt)
        h = L.apply_norm(cfg, blk['ln2'], x)
        return (x + L.mlp_block(cfg, blk['mlp'], h)).to(dt)

    body = _maybe_remat(cfg, body)
    for blk in unbind(params['enc_blocks']):
        x = body(blk, x)
    return L.apply_norm(cfg, params['enc_norm'], x)


def forward_lm(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
               source: Optional[torch.Tensor] = None):
    """Full-sequence forward (train / prefill): tokens (B, S) -> (logits
    (B, S, V), aux loss: the sum over layers of the MoE blocks' losses,
    0.0 for a dense config).  Self attention runs causal with
    ``cfg.sliding_window`` on ``cfg.attn_backend`` (K8's prefill on CUDA
    tensors under ``auto``).  ``source`` (B, F, d): the audio frames,
    which the encoder reads, or the image patches, cast to the activation
    dtype, which every cross layer attends to; required by the cross
    families, refused by the others."""
    if _has_cross(cfg) and source is None:
        raise ValueError(f'forward_lm: {cfg.name} needs a source (B, F, '
                         f'{cfg.d_model})')
    if not _has_cross(cfg) and source is not None:
        raise NotImplementedError(f'forward_lm: {cfg.name} has no cross '
                                  f'attention to read a source')
    x = L.embed(cfg, params['embed'], tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    cos_sin = L.rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    window = cfg.sliding_window
    aux_total = 0.0
    if cfg.n_encoder_layers:
        enc = _encoder(cfg, params, source)

        def body(blk, xblk, x):
            x, aux = _self_block(cfg, blk, x, cos_sin, window)
            x, aux2 = _cross_block(cfg, xblk, x, enc)
            return x, aux + aux2

        body = _maybe_remat(cfg, body)
        for blk, xblk in zip(unbind(params['blocks']),
                             unbind(params['enc_cross'])):
            x, aux = body(blk, xblk, x)
            aux_total = aux_total + aux
    elif cfg.cross_attn_every:
        src = source.to(cfg.adtype())

        def body(group, xblk, x):
            aux = 0.0
            for blk in unbind(group):
                x, a = _self_block(cfg, blk, x, cos_sin, window)
                aux = aux + a
            x, a = _cross_block(cfg, xblk, x, src)
            return x, aux + a

        body = _maybe_remat(cfg, body)
        for group, xblk in zip(unbind(params['blocks']),
                               unbind(params['cross'])):
            x, aux = body(group, xblk, x)
            aux_total = aux_total + aux
    else:
        block = _maybe_remat(cfg, functools.partial(_self_block, cfg))
        for blk in unbind(params['blocks']):
            x, aux = block(blk, x, cos_sin, window)
            aux_total = aux_total + aux
    x = L.apply_norm(cfg, params['final_norm'], x)
    return L.unembed(cfg, params['embed'], x), aux_total


def loss_fn(cfg: ArchConfig, params: Params, batch) -> torch.Tensor:
    logits, aux = forward_lm(cfg, params, batch['tokens'],
                             source=batch.get('source'))
    return L.softmax_xent(logits, batch['labels']) + 0.01 * aux


# ------------------------------------------------------------------ serving
def n_self_layers(cfg: ArchConfig) -> int:
    """The layers that hold a KV cache: all but a VLM's cross layers."""
    if cfg.cross_attn_every:
        return cfg.n_layers - cfg.n_layers // cfg.cross_attn_every
    return cfg.n_layers


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device='cuda') -> Params:
    """The KV cache of the self layers (``n_self_layers``): ``{'k', 'v'}``,
    each (layers, B, Hkv, W, hd) in the activation dtype, zero, a ring of
    W = min(``cfg.sliding_window`` or max_seq, max_seq) slots (the
    reference's W).

    Layout deviation from the reference's (layers, B, W, Hkv, hd) plus its
    slot -> position array ``pos``: K8 reads (B, Hkv, Sk, hd) contiguous,
    so the port stores that layout and ``attention_decode`` writes each
    new row in place (a transpose of the reference's layout would copy the
    whole cache every layer and step).  Position t lives in slot t % W, as
    in the reference, and a cache filled in order holds positions
    pos - W + 1 .. pos, which is what the reference's ``pos`` array says;
    so the port keeps no ``pos`` (``attention_decode``)."""
    w = min(cfg.sliding_window or max_seq, max_seq)
    shape = (n_self_layers(cfg), batch, cfg.n_kv_heads, w,
             cfg.resolved_head_dim)
    return {'k': torch.zeros(shape, dtype=cfg.adtype(), device=device),
            'v': torch.zeros(shape, dtype=cfg.adtype(), device=device)}


def cache_axes(cfg: ArchConfig) -> dict:
    """The logical axes of ``init_cache``'s tensors in the port's layout
    (the reference's ``k``/``v`` axes, with ``kv_heads`` before
    ``kv_seq``; the port keeps no ``pos``)."""
    kv = ('layers', 'batch', 'kv_heads', 'kv_seq', 'head_dim_act')
    return {'k': kv, 'v': kv}


def precompute_cross_kv(cfg: ArchConfig, params: Params,
                        source: torch.Tensor) -> Optional[Params]:
    """Every cross layer's K and V of ``source`` (B, F, d), computed once
    per request: the encoder's output (audio) or the image patches in the
    activation dtype (VLM) through each cross block's ``wk``/``wv``.
    Returns ``{'k', 'v'}``, each (cross layers, B, Hkv, F, hd) contiguous
    in the projections' dtype (JAX's promotion: f32 for whisper, bf16 for
    Llama-3.2-Vision), so each layer's slice is K8's (B, Hkv, Sk, D)
    without a copy; the reference's is a tuple of (cross layers, B, F,
    Hkv, hd) (``convert.lm_cross_kv_from_numpy``).  None for a config
    with no cross layer, as in the reference."""
    if cfg.n_encoder_layers:
        src, blocks = _encoder(cfg, params, source), params['enc_cross']
    elif cfg.cross_attn_every:
        src, blocks = source.to(cfg.adtype()), params['cross']
    else:
        return None
    out = {}
    for n, w in (('k', blocks['attn']['wk']), ('v', blocks['attn']['wv'])):
        for i, wi in enumerate(torch.unbind(w)):
            a = L._mm(src, wi).transpose(1, 2)          # (B, Hkv, F, hd)
            if not i:
                out[n] = a.new_empty((w.shape[0],) + a.shape)
            out[n][i].copy_(a)
    return out


def _self_decode(cfg: ArchConfig, blk: Params, x: torch.Tensor,
                 cache: Params, pos: int, cos_sin) -> torch.Tensor:
    """One self block of a decode step, its cache slices written in
    place."""
    adt = cfg.adtype()
    h = L.apply_norm(cfg, blk['ln1'], x)
    o = L.attention_decode(cfg, blk['attn'], h, cache, pos=pos,
                           cos_sin=cos_sin, window=cfg.sliding_window)
    x = (x + o).to(adt)
    y, _ = _ffn(cfg, blk, L.apply_norm(cfg, blk['ln2'], x))
    return (x + y).to(adt)


def _cross_decode(cfg: ArchConfig, blk: Params, x: torch.Tensor,
                  cross_kv: Params) -> torch.Tensor:
    """One cross block of a decode step, against its layer's cross K/V."""
    adt = cfg.adtype()
    h = L.apply_norm(cfg, blk['ln1'], x)
    x = (x + L.cross_attention_decode(cfg, blk['attn'], h, cross_kv)).to(adt)
    y, _ = _ffn(cfg, blk, L.apply_norm(cfg, blk['ln2'], x))
    return (x + y).to(adt)


def decode_step(cfg: ArchConfig, params: Params, cache: Params,
                tokens: torch.Tensor, pos: int,
                cross_kv: Optional[Params] = None):
    """One decode step: tokens (B, 1) at position ``pos`` (a Python int,
    the same for every row).  Writes the new K/V rows into ``cache`` in
    place (slot ``pos % W``) and returns (logits (B, 1, V), cache); an
    MoE block routes the B tokens as one group (the aux loss dropped, as
    the reference drops it).  A cross family needs ``cross_kv``
    (``precompute_cross_kv`` of the request's source): an audio layer is a
    self block, then a cross block; a VLM group is ``per - 1`` self blocks
    (cache layer g * (per - 1) + i), then a cross block."""
    if _has_cross(cfg) and cross_kv is None:
        raise ValueError(f'decode_step: {cfg.name} needs cross_kv '
                         f'(precompute_cross_kv of the source)')
    pos = int(pos)
    x = L.embed(cfg, params['embed'], tokens)
    positions = torch.full((1,), pos, dtype=torch.float32,
                           device=tokens.device)
    cos_sin = L.rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    cache_i = lambda j: {'k': cache['k'][j], 'v': cache['v'][j]}
    cross_i = lambda j: {'k': cross_kv['k'][j], 'v': cross_kv['v'][j]}
    blocks = params['blocks']
    if cfg.cross_attn_every:
        per = cfg.cross_attn_every - 1
        for g in range(cfg.n_layers // cfg.cross_attn_every):
            for i in range(per):
                blk = tree_map(lambda a: a[g, i], blocks)
                x = _self_decode(cfg, blk, x, cache_i(g * per + i), pos,
                                 cos_sin)
            xblk = tree_map(lambda a: a[g], params['cross'])
            x = _cross_decode(cfg, xblk, x, cross_i(g))
    else:
        for i in range(cfg.n_layers):
            x = _self_decode(cfg, tree_map(lambda a: a[i], blocks), x,
                             cache_i(i), pos, cos_sin)
            if cfg.n_encoder_layers:
                xblk = tree_map(lambda a: a[i], params['enc_cross'])
                x = _cross_decode(cfg, xblk, x, cross_i(i))
    x = L.apply_norm(cfg, params['final_norm'], x)
    return L.unembed(cfg, params['embed'], x), cache
