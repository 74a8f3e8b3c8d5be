"""SGD-momentum, AdamW and Adafactor, global-norm clipping and the cosine
and WSD schedules, in PyTorch: the port of ``repro.optim.optimizers``.

API as in the reference (optax's): ``opt.init(params) -> state``;
``opt.update(grads, state, params) -> (updates, state)``; apply with
``apply_updates``.  Trees are the port's containers (``tree``).  Scalars
(the step, the learning rate, the bias corrections) are 0-d float32
tensors on the CPU, so reading them never waits for the card; the
optimizer state lives beside the parameters.

Two forms of one arithmetic.  ``update`` is functional like the
reference's: every update returns new tensors.  ``update_`` is the
counterpart of the reference's donated train state (``donate_argnums`` in
``jax.jit``): it writes the parameters and the optimizer state in place,
and drops each gradient once used.  Both forms, the global norm and the
clip work a slice at a time (``_slices``): a leaf of more than two dims
and more than ``SLICE_ELEMS`` elements, a stack of layers or experts, is
taken as slices over its leading dims, down to one (rows, columns) matrix
at most, so the f32 temporaries of the norm and of a rule are one slice
and never the stack (a Mixtral 8x22B layer's expert ``w_up`` is 805 M
elements, 3.2 GB in f32, where one expert's matrix is 0.4 GB).  AdamW's
and SGD's rules are elementwise, so slicing them changes nothing;
Adafactor's factored moments are per matrix, and its update clip reads
the rms of the whole leaf's direction, which a first pass sums slice by
slice (in f32) before a second pass recomputes each slice's direction
and applies it.  Both forms run the same slices in the
same order, so their results are equal bit for bit; against the
reference (one sum over the leaf) they differ by f32 summation order.
``optimizer_state_axes`` gives the state's logical sharding axes from the
parameters' (the state inherits the parameter sharding, ZeRO-style).
"""
from __future__ import annotations

import itertools
import math
from typing import (Any, Callable, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch

from ..op_cost import steps
from ..tree import leaves, tree_map, unflatten_like

f32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]
    # (gradient leaves in flattening order, consumed; state; params) ->
    # state, with params and the state's tensors written in place
    update_: Callable[[List[torch.Tensor], Any, Any], Any]


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


# a stacked leaf is split over its leading dims until a slice holds at
# most this many elements or is one (rows, columns) matrix: a layer's
# attention weight (d, H, hd) stays whole (Mixtral 8x22B's wq is 37.7 M
# elements), an expert's matrix is the slice (Mixtral's (6144, 16384),
# 0.4 GB in f32)
SLICE_ELEMS = 1 << 26


def _lead(shape) -> tuple:
    """The leading dims a leaf of ``shape`` is split over (``_slices``)."""
    k = 0
    while len(shape) - k > 2 and math.prod(shape[k:]) > SLICE_ELEMS:
        k += 1
    return tuple(shape[:k])


class _Slices(Sequence):
    """Views of ``x``, one per index of its ``lead`` leading dims, each
    made when read."""

    def __init__(self, x: torch.Tensor, lead):
        self.x, self.index = x, list(itertools.product(*map(range, lead)))

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.x[self.index[i]]


def _slices(x: torch.Tensor, lead=None) -> Sequence[torch.Tensor]:
    """Views of ``x``, one per index of its ``lead`` leading dims (default
    ``_lead(x.shape)``), in order: x whole when it has at most two dims or
    ``SLICE_ELEMS`` elements, else its slices, none of more than two dims
    larger than that.  A state leaf is split by its parameter's lead.  A
    loop over them is an ``op_cost.steps`` loop: traced, one slice counts
    for all (they are alike)."""
    lead = _lead(x.shape) if lead is None else lead
    return _Slices(x, lead)


def _sq_sum(x: torch.Tensor) -> torch.Tensor:
    """The f32 sum of squares of ``x``, a slice at a time."""
    sl = _slices(x)
    return sum(torch.sum(torch.square(sl[i].to(f32)))
               for i in steps(range(len(sl)), x))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(_sq_sum(x) for x in leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to a global norm of at most ``max_norm``, its norm
    before scaling)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), norm


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float):
    """``clip_by_global_norm`` on a list of leaves, scaled in place;
    returns the norm before scaling."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


# ------------------------------------------------------------------ schedules
def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1):
    """Linear warmup to ``peak_lr``, then a cosine decay to
    ``final_frac * peak_lr`` at ``total``; evaluated in float32."""
    def lr(step):
        step = torch.as_tensor(step, dtype=f32)
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi
                                                                   * t))
        return torch.where(step < warmup, warm, peak_lr * cos)
    return lr


def wsd_schedule(peak_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.1, final_frac: float = 0.01):
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395): linear warmup, a
    flat ``peak_lr`` for most of training, then an exponential decay to
    ``final_frac * peak_lr`` over the last ``decay_frac``; float32."""
    decay_start = int(total * (1 - decay_frac))

    def lr(step):
        step = torch.as_tensor(step, dtype=f32)
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - decay_start) / max(total - decay_start, 1),
                        0.0, 1.0)
        decay = peak_lr * torch.exp(math.log(final_frac) * t)
        stable = torch.where(step >= decay_start, decay, peak_lr)
        return torch.where(step < warmup, warm, stable)
    return lr


# ----------------------------------------------------------------- optimizers
def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=f32, device=like.device)


class Rule(NamedTuple):
    """An optimizer's arithmetic on one slice of a leaf (``_slices``),
    g in f32: ``moments(g, p, *state, **sc) -> new state``, ``direction(g,
    p, *new state, **sc) -> u`` and ``step(u, p, clip, **sc) -> update``.
    ``leaf_clip`` (Adafactor's update clip) maps the rms of u over the
    whole leaf, summed in a first pass over its slices, to the divisor
    ``clip``; without it ``clip`` is 1.0 and one pass does."""
    moments: Callable
    direction: Callable
    step: Callable
    leaf_clip: Optional[Callable] = None


def _leaf_updates(rule: Rule, sc: dict, g, p, olds, outs):
    """One leaf's update, a slice at a time: yields (index of the slice in
    ``_slices(p)``, its f32 update), each made after the one before was
    used; the new state is written into ``outs`` (``olds`` itself under
    ``update_``: a slice's old state is read before it is written)."""
    lead = _lead(p.shape)
    gs, ps = _slices(g, lead), _slices(p, lead)
    old_ms = [_slices(t, lead) for t in olds]
    out_ms = [_slices(t, lead) for t in outs]

    def moments(i, gi):
        news = rule.moments(gi, ps[i], *(m[i] for m in old_ms), **sc)
        for o, n in zip(out_ms, news):
            o[i].copy_(n)
        return [o[i] for o in out_ms]

    clip = 1.0
    if rule.leaf_clip is not None:
        ss = 0.0
        for i in steps(range(len(gs)), p):
            gi = gs[i].to(f32)
            u = rule.direction(gi, ps[i], *moments(i, gi), **sc)
            ss = ss + torch.sum(torch.square(u))
            del gi, u
        clip = rule.leaf_clip(torch.sqrt(ss / p.numel() + 1e-12))
    for i in steps(range(len(gs)), p):
        gi = gs[i].to(f32)
        news = ([o[i] for o in out_ms] if rule.leaf_clip is not None
                else moments(i, gi))
        yield i, rule.step(rule.direction(gi, ps[i], *news, **sc), ps[i],
                           clip, **sc)
        del gi, news


def _optimizer(init: Callable, state_cls, scalars: Callable,
               rule: Rule) -> Optimizer:
    """An ``Optimizer`` from a ``Rule`` applied a slice at a time
    (``_slices``); ``state_cls(step, *state trees)`` is the state, each
    tree with its parameters' leading dims."""

    def update(grads, state, params):
        step = state.step + 1
        sc = scalars(step)
        trees = state[1:]
        upds, cols = [], [[] for _ in trees]
        for g, p, *olds in zip(leaves(grads), leaves(params),
                               *map(leaves, trees)):
            outs = [torch.empty_like(o) for o in olds]
            u = torch.empty(p.shape, dtype=f32, device=p.device)
            us = _slices(u)
            for i, ui in _leaf_updates(rule, sc, g, p, olds, outs):
                us[i].copy_(ui)
            upds.append(u)
            for c, o in zip(cols, outs):
                c.append(o)
        return (unflatten_like(params, upds),
                state_cls(step, *(unflatten_like(t, c)
                                  for t, c in zip(trees, cols))))

    def update_(grads: List[torch.Tensor], state, params):
        step = state.step + 1
        sc = scalars(step)
        cols = list(zip(*map(leaves, state[1:])))
        for i, (p, olds) in enumerate(zip(leaves(params), cols)):
            ps = _slices(p)
            for j, uj in _leaf_updates(rule, sc, grads[i], p, olds, olds):
                ps[j].add_(uj.to(p.dtype))
                del uj      # before the next slice's temporaries exist
            grads[i] = None
        return state._replace(step=step)

    return Optimizer(init, update, update_)


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32 on the CPU, counted from 1 in update
    m: Any
    v: Any


def adamw(lr: Callable, b1=0.9, b2=0.95, eps=1e-8,
          weight_decay=0.1) -> Optimizer:
    """AdamW with the reference's defaults: b2 = 0.95 and weight decay 0.1
    on every leaf; moments in float32."""
    def init(params):
        return AdamWState(torch.zeros((), dtype=torch.int32),
                          tree_map(lambda p: _zeros(p.shape, p), params),
                          tree_map(lambda p: _zeros(p.shape, p), params))

    def scalars(step):
        step_f = step.to(f32)
        return dict(bc1=1 - torch.tensor(b1, dtype=f32) ** step_f,
                    bc2=1 - torch.tensor(b2, dtype=f32) ** step_f,
                    lr_t=lr(step))

    def moments(g, p, mm, vv, **sc):
        return (b1 * mm + (1 - b1) * g,
                b2 * vv + (1 - b2) * torch.square(g))

    def direction(g, p, m, v, bc1, bc2, lr_t):
        return (m / bc1) / (torch.sqrt(v / bc2) + eps)

    def step(u, p, clip, lr_t, **sc):
        return -lr_t * (u + weight_decay * p.to(f32))

    return _optimizer(init, AdamWState, scalars,
                      Rule(moments, direction, step))


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Any       # row second moments (or the full v of a leaf under 2-D)
    vc: Any       # column second moments (a 0-d zero under 2-D)


def adafactor(lr: Callable, eps=1e-30, clip_threshold=1.0,
              decay_rate=0.8, weight_decay=0.0) -> Optimizer:
    """Factored Adam (Shazeer & Stern): O(n + m) state for an (n, m)
    matrix.  Factors the last two dims of every leaf of two or more dims
    (stacked layer weights keep their leading dims), as the reference's."""
    def init(params):
        def vrow(p):
            return _zeros(p.shape[:-1] if p.ndim >= 2 else p.shape, p)

        def vcol(p):
            return _zeros(p.shape[:-2] + p.shape[-1:] if p.ndim >= 2
                          else (), p)

        return AdafactorState(torch.zeros((), dtype=torch.int32),
                              tree_map(vrow, params), tree_map(vcol, params))

    def scalars(step):
        return dict(beta=1.0 - step.to(f32) ** -decay_rate, lr_t=lr(step))

    def moments(g, p, vr, vc, beta, lr_t):
        g2 = torch.square(g) + eps
        if p.ndim >= 2:
            return (beta * vr + (1 - beta) * g2.mean(dim=-1),
                    beta * vc + (1 - beta) * g2.mean(dim=-2))
        return beta * vr + (1 - beta) * g2, vc

    def direction(g, p, vr_n, vc_n, **sc):
        if p.ndim >= 2:
            denom = torch.clamp(vr_n.mean(dim=-1, keepdim=True), min=eps)
            return (g * torch.rsqrt(vr_n / denom)[..., None]
                    * torch.rsqrt(vc_n)[..., None, :])
        return g * torch.rsqrt(vr_n)

    def leaf_clip(rms):
        return torch.clamp(rms / clip_threshold, min=1.0)

    def step(u, p, clip, lr_t, **sc):
        upd = -lr_t * (u / clip)
        if weight_decay:
            upd = upd - lr_t * weight_decay * p.to(f32)
        return upd

    return _optimizer(init, AdafactorState, scalars,
                      Rule(moments, direction, step, leaf_clip))


class SGDState(NamedTuple):
    step: torch.Tensor
    mom: Any


def sgd(lr: Callable, momentum=0.9) -> Optimizer:
    """SGD with heavy-ball momentum in float32."""
    def init(params):
        return SGDState(torch.zeros((), dtype=torch.int32),
                        tree_map(lambda p: _zeros(p.shape, p), params))

    def moments(g, p, m, lr_t):
        return (momentum * m + g,)

    def direction(g, p, mom, lr_t):
        return mom

    def step(u, p, clip, lr_t):
        return -lr_t * u

    return _optimizer(init, SGDState, lambda step: dict(lr_t=lr(step)),
                      Rule(moments, direction, step))


OPTIMIZERS = {'adamw': adamw, 'adafactor': adafactor, 'sgd': sgd}


def make_optimizer(name: str, lr_fn: Callable) -> Optimizer:
    """The optimizer named by ``ArchConfig.optimizer``."""
    if name not in OPTIMIZERS:
        raise ValueError(f'optimizer {name!r}, expected one of '
                         f'{sorted(OPTIMIZERS)}')
    return OPTIMIZERS[name](lr_fn)


def optimizer_state_axes(name: str, param_axes):
    """Logical axes of ``name``'s state from the parameters' axes tree:
    the moments inherit each parameter's axes; Adafactor's row moment
    drops a leaf's last axis and its column moment the one before."""
    from ..sharding import map_axes
    scalar = ()
    if name == 'adamw':
        return AdamWState(scalar, param_axes, param_axes)
    if name == 'adafactor':
        return AdafactorState(
            scalar, map_axes(lambda a: a[:-1] if len(a) >= 2 else a, param_axes),
            map_axes(lambda a: a[:-2] + a[-1:] if len(a) >= 2 else (),
                 param_axes))
    if name == 'sgd':
        return SGDState(scalar, param_axes)
    raise ValueError(name)
