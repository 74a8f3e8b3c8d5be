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
leaf by leaf, and drops each gradient once used, so a leaf's temporaries
are freed before the next leaf's are made (MiniCPM-2B's f32 weights,
gradients and AdamW moments are 43.6 GB; the functional form would hold
twice that).  Both forms run the same per-leaf rule, so their results are
equal bit for bit.  ``optimizer_state_axes`` (sharding) is not ported:
one card has no mesh.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Tuple

import torch

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


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(f32)))
                          for x in leaves(tree)))


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


def _optimizer(init: Callable, state_cls, scalars: Callable,
               rule: Callable) -> Optimizer:
    """An ``Optimizer`` from a per-leaf ``rule(g, p, *state leaves,
    **scalars(step)) -> (update, *new state leaves)``; ``state_cls(step,
    *state trees)`` is the state, each tree shaped like the parameters."""

    def update(grads, state, params):
        step = state.step + 1
        sc = scalars(step)
        trees = state[1:]
        outs = [rule(g, p, *s, **sc) for g, p, *s in zip(
            leaves(grads), leaves(params), *map(leaves, trees))]
        cols = list(zip(*outs))
        return (unflatten_like(params, cols[0]),
                state_cls(step, *(unflatten_like(t, c)
                                  for t, c in zip(trees, cols[1:]))))

    def update_(grads: List[torch.Tensor], state, params):
        step = state.step + 1
        sc = scalars(step)
        cols = list(zip(*map(leaves, state[1:])))
        for i, (p, olds) in enumerate(zip(leaves(params), cols)):
            upd, *news = rule(grads[i], p, *olds, **sc)
            grads[i] = None
            p.add_(upd.to(p.dtype))
            for old, new in zip(olds, news):
                old.copy_(new)
            del upd, news      # before the next leaf's temporaries exist
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

    def rule(g, p, mm, vv, bc1, bc2, lr_t):
        m = b1 * mm + (1 - b1) * g.to(f32)
        v = b2 * vv + (1 - b2) * torch.square(g.to(f32))
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        return -lr_t * (u + weight_decay * p.to(f32)), m, v

    return _optimizer(init, AdamWState, scalars, rule)


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

    def rule(g, p, vr, vc, beta, lr_t):
        g = g.to(f32)
        g2 = torch.square(g) + eps
        if p.ndim >= 2:
            vr_n = beta * vr + (1 - beta) * g2.mean(dim=-1)
            vc_n = beta * vc + (1 - beta) * g2.mean(dim=-2)
            denom = torch.clamp(vr_n.mean(dim=-1, keepdim=True), min=eps)
            u = (g * torch.rsqrt(vr_n / denom)[..., None]
                 * torch.rsqrt(vc_n)[..., None, :])
        else:
            vr_n = beta * vr + (1 - beta) * g2
            vc_n = vc
            u = g * torch.rsqrt(vr_n)
        rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        upd = -lr_t * u
        if weight_decay:
            upd = upd - lr_t * weight_decay * p.to(f32)
        return upd, vr_n, vc_n

    return _optimizer(init, AdafactorState, scalars, rule)


class SGDState(NamedTuple):
    step: torch.Tensor
    mom: Any


def sgd(lr: Callable, momentum=0.9) -> Optimizer:
    """SGD with heavy-ball momentum in float32."""
    def init(params):
        return SGDState(torch.zeros((), dtype=torch.int32),
                        tree_map(lambda p: _zeros(p.shape, p), params))

    def rule(g, p, m, lr_t):
        mom = momentum * m + g.to(f32)
        return -lr_t * mom, mom

    return _optimizer(init, SGDState, lambda step: dict(lr_t=lr(step)),
                      rule)


OPTIMIZERS = {'adamw': adamw, 'adafactor': adafactor, 'sgd': sgd}


def make_optimizer(name: str, lr_fn: Callable) -> Optimizer:
    """The optimizer named by ``ArchConfig.optimizer``."""
    if name not in OPTIMIZERS:
        raise ValueError(f'optimizer {name!r}, expected one of '
                         f'{sorted(OPTIMIZERS)}')
    return OPTIMIZERS[name](lr_fn)
