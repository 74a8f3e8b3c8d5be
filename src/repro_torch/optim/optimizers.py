"""AdamW, global-norm clipping and the cosine schedule, in PyTorch: the
port of ``repro.optim.optimizers`` for the ``adamw`` optimizer.

API as in the reference (optax's): ``opt.init(params) -> state``;
``opt.update(grads, state, params) -> (updates, state)``; apply with
``apply_updates``.  Trees are the port's containers (``tree``).  Functional
like the reference: every update returns new tensors.  Scalars (the step,
the learning rate, the bias corrections) are 0-d float32 tensors on the CPU,
so reading them never waits for the card; the moments live beside the
parameters.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from ..tree import leaves, tree_map

f32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(f32)))
                          for x in leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to a global norm of at most ``max_norm``, its norm
    before scaling)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), norm


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


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32 on the CPU, counted from 1 in update
    m: Any
    v: Any


def adamw(lr: Callable, b1=0.9, b2=0.95, eps=1e-8,
          weight_decay=0.1) -> Optimizer:
    """AdamW with the reference's defaults: b2 = 0.95 and weight decay 0.1
    on every leaf; moments in float32."""
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=f32, device=p.device)
        return AdamWState(torch.zeros((), dtype=torch.int32),
                          tree_map(zeros, params), tree_map(zeros, params))

    def update(grads, state, params):
        step = state.step + 1
        m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g.to(f32),
                     state.m, grads)
        v = tree_map(lambda vv, g: b2 * vv + (1 - b2)
                     * torch.square(g.to(f32)), state.v, grads)
        step_f = step.to(f32)
        bc1 = 1 - torch.tensor(b1, dtype=f32) ** step_f
        bc2 = 1 - torch.tensor(b2, dtype=f32) ** step_f
        lr_t = lr(step)

        def upd(mm, vv, p):
            u = (mm / bc1) / (torch.sqrt(vv / bc2) + eps)
            return -lr_t * (u + weight_decay * p.to(f32))

        return tree_map(upd, m, v, params), AdamWState(step, m, v)

    return Optimizer(init, update)


def make_optimizer(name: str, lr_fn: Callable) -> Optimizer:
    """The optimizer named by ``ArchConfig.optimizer``.  Only ``adamw`` is
    ported; ``adafactor`` and ``sgd`` raise."""
    if name != 'adamw':
        raise ValueError(f'optimizer {name!r} is not ported (adamw only)')
    return adamw(lr_fn)
