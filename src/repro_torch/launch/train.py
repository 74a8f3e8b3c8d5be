"""Train step factory and the trainer CLI for the paper's CTC LSTM.

``make_train_step`` builds the update: loss -> gradients (with microbatch
accumulation) -> global-norm clip -> optimizer -> apply, as the reference's
``repro.launch.train.make_train_step`` does; the gradients come from the
hand-written gate-recompute backward of whichever LSTM backend the config
names.  ``main`` is the CLI: synthetic CTC data -> steps -> async
checkpoints, with ``--resume``.  It runs on the card unless ``--device cpu``
is given; the full ``chipmunk-ctc`` configuration is the default and
``--smoke`` selects the reduced one::

    python -m repro_torch.launch.train --steps 20 --lstm-backend cuda_step
    python -m repro_torch.launch.train --device cpu --smoke --steps 8 \\
        --batch 4 --seq 32

The reference's mesh and sharding have no counterpart here (one card), and
its ``FaultTolerantRunner`` waits for the port's fault runtime.
"""
from __future__ import annotations

import argparse
import functools
import pathlib
import time
from typing import Callable, Dict

import torch

from .. import configs
from ..checkpoint import CheckpointManager
from ..core.lstm import BACKENDS
from ..data import HostLoader, source_for
from ..models import chipmunk_net
from ..optim import (apply_updates, clip_by_global_norm, cosine_schedule,
                     make_optimizer)
from ..tree import leaves, tree_map, unflatten_like

DEFAULT_CKPT_DIR = (pathlib.Path(__file__).resolve().parents[3] / 'build'
                    / 'train_ckpt')


def lr_schedule_for(cfg, peak_lr=3e-4, warmup=100, total=10_000):
    """The learning-rate schedule of ``cfg``: cosine for every ported
    configuration (the reference's WSD schedule belongs to MiniCPM, not
    ported)."""
    return cosine_schedule(peak_lr, warmup, total)


# ``torch.profiler.record_function`` labels of a train step's phases: the
# loss (model forward and CTC), its backward, and clip + optimizer + apply.
# They cost nothing measurable with the profiler off; a trace reads each
# phase's host time under its label.
PHASES = ('train_step.loss', 'train_step.backward', 'train_step.update')


def _grads_of(loss_fn: Callable, params, batch):
    """(loss, gradient tree) of ``loss_fn(params, batch)``, with fresh
    leaves so the caller's parameters never carry a graph."""
    p = tree_map(lambda x: x.detach().requires_grad_(True), params)
    with torch.profiler.record_function(PHASES[0]):
        loss = loss_fn(p, batch)
    with torch.profiler.record_function(PHASES[1]):
        grads = torch.autograd.grad(loss, leaves(p))
    return loss.detach(), unflatten_like(params, grads)


def make_train_step(loss_fn: Callable, optimizer, *, microbatches: int = 1,
                    grad_clip: float = 1.0) -> Callable:
    """(state, batch) -> (state, metrics).  state = {'params', 'opt',
    'step'}; ``loss_fn(params, batch)`` is a scalar; metrics are the loss
    and the gradient's global norm before clipping, as 0-d device tensors
    (reading them waits for the card)."""

    def train_step(state, batch: Dict[str, torch.Tensor]):
        params = state['params']
        if microbatches == 1:
            loss, grads = _grads_of(loss_fn, params, batch)
        else:
            split = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            gsum = tree_map(torch.zeros_like, params)
            lsum = 0.0
            for i in range(microbatches):
                loss_i, g = _grads_of(loss_fn, params,
                                      {k: v[i] for k, v in split.items()})
                gsum = tree_map(lambda a, x: a + x.to(a.dtype), gsum, g)
                lsum = lsum + loss_i
            grads = tree_map(lambda g: g / microbatches, gsum)
            loss = lsum / microbatches
        with torch.no_grad(), torch.profiler.record_function(PHASES[2]):
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
            updates, opt_state = optimizer.update(grads, state['opt'],
                                                  params)
            params = apply_updates(params, updates)
        return ({'params': params, 'opt': opt_state,
                 'step': state['step'] + 1},
                {'loss': loss, 'grad_norm': gnorm})

    return train_step


def init_train_state(cfg, optimizer, device, seed: int = 0):
    """Random parameters of ``cfg`` from ``seed``, fresh optimizer state,
    step 0 (a 0-d int32 on the CPU)."""
    params = chipmunk_net.init(cfg, torch.Generator().manual_seed(seed),
                               device=device)
    return {'params': params, 'opt': optimizer.init(params),
            'step': torch.zeros((), dtype=torch.int32)}


def main(argv=None):
    """End-to-end training: data -> step -> checkpoint.

    python -m repro_torch.launch.train --arch chipmunk-ctc --steps 50
    """
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--arch', default='chipmunk-ctc',
                    choices=sorted(configs.ARCH_MODULES))
    ap.add_argument('--steps', type=int, default=20)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--seq', type=int, default=64)
    ap.add_argument('--lr', type=float, default=1e-3)
    ap.add_argument('--smoke', action='store_true',
                    help='use the reduced configuration instead of the full '
                         'one')
    ap.add_argument('--ckpt-dir', default=str(DEFAULT_CKPT_DIR))
    ap.add_argument('--ckpt-every', type=int, default=20)
    ap.add_argument('--resume', action='store_true')
    ap.add_argument('--microbatches', type=int, default=1)
    ap.add_argument('--log-every', type=int, default=5)
    ap.add_argument('--lstm-backend', default='auto', choices=BACKENDS)
    ap.add_argument('--device', default='cuda',
                    help='torch device of the weights and the batches '
                         '(cuda, cpu)')
    args = ap.parse_args(argv)

    get = configs.get_smoke_config if args.smoke else configs.get_config
    cfg = get(args.arch).replace(lstm_backend=args.lstm_backend)
    shape = configs.ShapeConfig('cli', 'train', args.seq, args.batch)
    optimizer = make_optimizer(
        cfg.optimizer, lr_schedule_for(cfg, args.lr, warmup=10,
                                       total=args.steps))
    step_fn = make_train_step(functools.partial(chipmunk_net.loss_fn, cfg),
                              optimizer, microbatches=args.microbatches)
    state = init_train_state(cfg, optimizer, args.device)

    ckpt = CheckpointManager(args.ckpt_dir)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        start = int(state['step'])
        print(f'resumed at step {start}')

    loader = HostLoader(source_for(cfg, shape), shape, args.device,
                        start_step=start)
    t0 = time.time()
    for i, (step, batch) in zip(range(start, args.steps), loader):
        state, metrics = step_fn(state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f'step {step:5d} loss {float(metrics["loss"]):8.4f} '
                  f'gnorm {float(metrics["grad_norm"]):8.3f} '
                  f'({(time.time() - t0) / (i - start + 1):.2f}s/step)')
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state)
    ckpt.save(args.steps, state, blocking=True)
    print('done')


if __name__ == '__main__':
    main()
