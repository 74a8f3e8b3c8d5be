"""Train step factory and the trainer CLI, for the paper's CTC LSTM and
every LM family: dense, moe (Mixtral, Kimi-K2), vlm (Llama-3.2-Vision's
cross layers over image patches), audio (whisper's encoder-decoder), ssm
(xLSTM) and hybrid (Hymba).

``make_train_step`` builds the update: loss -> gradients (with microbatch
accumulation) -> global-norm clip -> optimizer -> apply, as the reference's
``repro.launch.train.make_train_step`` does; the CTC LSTM's gradients come
from the hand-written gate-recompute backward of whichever LSTM backend
the config names, an LM's through K8's forward and backward kernels
(``models.layers.attention``; xLSTM has no attention) under the config's
``remat``.  With
``donate=True`` (the reference's ``donate_argnums=(0,)``) the step clips
the gradients and updates the parameters and the optimizer state in place,
a slice at a time (``Optimizer.update_``), equal bit for bit to the
functional step.  ``main`` is the CLI: synthetic data (CTC frames, or the
LM's token stream, with the VLM's patches and whisper's frames) ->
donating steps under the ``runtime.FaultTolerantRunner`` (retry, restore
from the latest checkpoint, and a heartbeat in
``<ckpt-dir>/heartbeat.json``) -> async checkpoints, with ``--resume``.
It runs on the card unless ``--device cpu`` is given; ``--arch`` takes
``chipmunk-ctc`` (the default) or any LM config, and ``--smoke`` selects
the reduced configuration.  Like the reference's trainer ("small configs
only"), it trains a full configuration as far as the card's memory goes:
the MoE and VLM configs do not fit one card at full depth (Mixtral's
bf16 weights alone are 281 GB, Kimi-K2's one layer 38.75 GB), so on one
card they train at their smoke configurations or, through the API, at
full width cut by depth (``chip_smoke.py``)::

    python -m repro_torch.launch.train --steps 20 --lstm-backend cuda_step
    python -m repro_torch.launch.train --device cpu --smoke --steps 8 \\
        --batch 4 --seq 32
    python -m repro_torch.launch.train --arch minicpm-2b --smoke --steps 8
    python -m repro_torch.launch.train --arch hymba-1.5b --smoke --steps 8
    python -m repro_torch.launch.train --arch mixtral-8x22b --smoke --steps 8

The reference's mesh and sharding (``abstract_train_state``,
``batch_shardings``, ``local_mesh``) have no counterpart here (one card).
"""
from __future__ import annotations

import argparse
import functools
import pathlib
import time
from typing import Callable, Dict, List

import torch

from .. import configs
from ..checkpoint import CheckpointManager
from ..core.lstm import BACKENDS
from ..data import HostLoader, source_for
from ..kernels.flash_attention import (flash_attention,
                                       flash_attention_bwd_kv,
                                       flash_attention_bwd_q)
from ..models import chipmunk_net, get_bundle
from ..optim import (apply_updates, clip_by_global_norm,
                     clip_by_global_norm_, cosine_schedule, make_optimizer,
                     wsd_schedule)
from ..runtime import FaultConfig, FaultTolerantRunner
from ..tree import leaves, tree_map, unflatten_like

DEFAULT_CKPT_DIR = (pathlib.Path(__file__).resolve().parents[3] / 'build'
                    / 'train_ckpt')


def lr_schedule_for(cfg, peak_lr=3e-4, warmup=100, total=10_000):
    """The learning-rate schedule of ``cfg``: WSD for MiniCPM (which
    trains with it), cosine for every other configuration."""
    if cfg.name.startswith('minicpm'):
        return wsd_schedule(peak_lr, warmup, total)
    return cosine_schedule(peak_lr, warmup, total)


# ``torch.profiler.record_function`` labels of a train step's phases: the
# loss (model forward and CTC), its backward, and clip + optimizer + apply.
# They cost nothing measurable with the profiler off; a trace reads each
# phase's host time under its label.
PHASES = ('train_step.loss', 'train_step.backward', 'train_step.update')


def _grad_leaves(loss_fn: Callable, params, batch):
    """(loss, gradient leaves in flattening order) of ``loss_fn(params,
    batch)``, with fresh leaves so the caller's parameters never carry a
    graph."""
    p = tree_map(lambda x: x.detach().requires_grad_(True), params)
    with torch.profiler.record_function(PHASES[0]):
        loss = loss_fn(p, batch)
    with torch.profiler.record_function(PHASES[1]):
        grads = list(torch.autograd.grad(loss, leaves(p)))
    return loss.detach(), grads


def _grads_of(loss_fn: Callable, params, batch):
    """(loss, gradient tree) of ``loss_fn(params, batch)``."""
    loss, grads = _grad_leaves(loss_fn, params, batch)
    return loss, unflatten_like(params, grads)


def make_train_step(loss_fn: Callable, optimizer, *, microbatches: int = 1,
                    grad_clip: float = 1.0, donate: bool = False) -> Callable:
    """(state, batch) -> (state, metrics).  state = {'params', 'opt',
    'step'}; ``loss_fn(params, batch)`` is a scalar; metrics are the loss
    and the gradient's global norm before clipping, as 0-d device tensors
    (reading them waits for the card).  ``donate``: the parameters and
    the optimizer state of the state passed in are updated in place (the
    returned state holds the same tensors; after a failed step only a
    restore gives a consistent state), each gradient freed once applied.
    Microbatch gradients sum in place into fresh buffers in either form."""

    def grads_and_loss(params, batch) -> tuple:
        if microbatches == 1:
            return _grad_leaves(loss_fn, params, batch)
        split = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                              + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        gsum: List[torch.Tensor] = [torch.zeros_like(p)
                                    for p in leaves(params)]
        lsum = 0.0
        for i in range(microbatches):
            loss_i, g = _grad_leaves(loss_fn, params,
                                     {k: v[i] for k, v in split.items()})
            for a, x in zip(gsum, g):
                a.add_(x.to(a.dtype))
            del g
            lsum = lsum + loss_i
        for a in gsum:
            a.div_(microbatches)
        return lsum / microbatches, gsum

    def train_step(state, batch: Dict[str, torch.Tensor]):
        params = state['params']
        loss, grads = grads_and_loss(params, batch)
        with torch.no_grad(), torch.profiler.record_function(PHASES[2]):
            if donate:
                gnorm = clip_by_global_norm_(grads, grad_clip)
                opt_state = optimizer.update_(grads, state['opt'], params)
            else:
                tree, gnorm = clip_by_global_norm(
                    unflatten_like(params, grads), grad_clip)
                updates, opt_state = optimizer.update(tree, state['opt'],
                                                      params)
                params = apply_updates(params, updates)
        return ({'params': params, 'opt': opt_state,
                 'step': state['step'] + 1},
                {'loss': loss, 'grad_norm': gnorm})

    return train_step


def attention_launches() -> str:
    """K8's forward and backward launch counts, as the LM's trainers
    print them."""
    return (f'K8 launches: forward {flash_attention.launches}, backward '
            f'dk/dv {flash_attention_bwd_kv.launches}, dq '
            f'{flash_attention_bwd_q.launches}')


def loss_fn_for(cfg) -> Callable:
    """``(params, batch) -> loss`` of ``cfg``'s family (the bundle's
    ``loss_fn`` for an LM)."""
    if cfg.family == 'lstm':
        return functools.partial(chipmunk_net.loss_fn, cfg)
    return get_bundle(cfg).loss_fn


def init_train_state(cfg, optimizer, device, seed: int = 0):
    """Random parameters of ``cfg`` from ``seed``, fresh optimizer state,
    step 0 (a 0-d int32 on the CPU).  The CTC LSTM draws on the CPU's
    generator and copies; an LM draws with its bundle's ``init``
    (``transformer.init_lm``, ``recurrent.init_xlstm`` or
    ``recurrent.init_hymba``) on a generator of ``device`` itself."""
    if cfg.family == 'lstm':
        params = chipmunk_net.init(cfg, torch.Generator().manual_seed(seed),
                                   device=device)
    else:
        dev = torch.device(device)
        params = get_bundle(cfg).init(torch.Generator(dev).manual_seed(seed),
                                      dev)
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
    ap.add_argument('--lstm-backend', default='auto', choices=BACKENDS,
                    help='the CTC LSTM\'s backend')
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
    step_fn = make_train_step(loss_fn_for(cfg), optimizer,
                              microbatches=args.microbatches, donate=True)
    state = init_train_state(cfg, optimizer, args.device)

    ckpt = CheckpointManager(args.ckpt_dir)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        start = int(state['step'])
        print(f'resumed at step {start}')

    loader = HostLoader(source_for(cfg, shape), shape, args.device,
                        start_step=start)
    runner = FaultTolerantRunner(
        step_fn, ckpt_manager=ckpt,
        cfg=FaultConfig(heartbeat_path=f'{args.ckpt_dir}/heartbeat.json'),
        restore_fn=lambda: ckpt.restore(state))
    t0 = time.time()
    for i, (step, batch) in zip(range(start, args.steps), loader):
        state, metrics = runner.run_step(step, state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f'step {step:5d} loss {float(metrics["loss"]):8.4f} '
                  f'gnorm {float(metrics["grad_norm"]):8.3f} '
                  f'({(time.time() - t0) / (i - start + 1):.2f}s/step)')
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state)
    ckpt.save(args.steps, state, blocking=True)
    if cfg.family not in ('lstm', 'ssm'):      # the families with attention
        print(attention_launches())
    print(f'done; events: {runner.events[:5]}')


if __name__ == '__main__':
    main()
