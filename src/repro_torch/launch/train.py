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

The sharded state (the reference's): ``abstract_init`` and
``abstract_train_state`` build the parameters and the optimizer state as
fake DTensors placed by ``sharding.param_sharding_tree`` (zero
allocation: the dry run's state at any size), ``batch_shardings`` the
batch's layouts, and ``local_mesh`` the largest (data, model) mesh over
the visible cards.  ``main`` run as one rank of several (``torchrun
--nproc-per-node N -m repro_torch.launch.train ...``, or in a process
group its caller made) places its state on ``local_mesh()`` under
``TRAIN_RULES``, feeds it from ``ShardedLoader`` and steps under those
rules.  Alone on one card, where that mesh would be (1, 1), it keeps the
plain tensors on the card: a one-device DTensor computes the same thing,
and every kernel launches as before.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import os
import pathlib
import time
from typing import Callable, Dict, List

import torch

from .. import configs
from .. import sharding as shd
from ..checkpoint import CheckpointManager
from ..core.lstm import BACKENDS
from ..data import HostLoader, ShardedLoader, source_for
from ..kernels.flash_attention import (flash_attention,
                                       flash_attention_bwd_kv,
                                       flash_attention_bwd_q)
from ..models import chipmunk_net, get_bundle
from ..op_cost import steps
from ..optim import (apply_updates, clip_by_global_norm,
                     clip_by_global_norm_, cosine_schedule, make_optimizer,
                     wsd_schedule)
from ..runtime import FaultConfig, FaultTolerantRunner
from ..tree import leaves, tree_map, unflatten_like
from .mesh import resolve_rules

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
        split = {k: _split_microbatches(v, microbatches)
                 for k, v in batch.items()}
        gsum: List[torch.Tensor] = [torch.zeros_like(p)
                                    for p in leaves(params)]
        lsum = 0.0
        for i in steps(range(microbatches), leaves(params)[0]):
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


def _split_microbatches(v: torch.Tensor, m: int) -> torch.Tensor:
    """``v`` (B, ...) as (m, B / m, ...).  A DTensor sharded on the batch
    splits each rank's rows in place (microbatch i takes rows i of every
    rank's share), so no microbatch moves between ranks."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(v, DTensor):
        return v.reshape((m, v.shape[0] // m) + tuple(v.shape[1:]))
    loc = v.to_local()
    loc = loc.reshape((m, loc.shape[0] // m) + tuple(loc.shape[1:]))
    pl = [Shard(p.dim + 1) if isinstance(p, Shard) else p
          for p in v.placements]
    return DTensor.from_local(loc, v.device_mesh, pl, run_check=False)


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


# ------------------------------------------------------- the sharded state
def abstract_init(bundle):
    """(parameters, their logical axes tree) of ``bundle`` with no
    storage: its ``init`` run under ``FakeTensorMode`` (the active one,
    else a new one) on the CPU; ``sharding.param_sharding_tree`` places
    them (the reference's ``abstract_init``, which ``eval_shape``s)."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    with detect_fake_mode() or FakeTensorMode():
        params = bundle.init(torch.Generator().manual_seed(0), 'cpu')
    return params, bundle.param_axes(bundle.cfg)


def abstract_train_state(bundle, mesh, rules_dict, lr_fn=None):
    """(state, layouts, optimizer) with zero allocation: the parameters
    and the optimizer state of ``bundle.cfg.optimizer`` as fake DTensors
    on ``mesh``, each placed by its logical axes under ``rules_dict``
    (the state inherits its parameter's, ``optimizer_state_axes``);
    0-d leaves (the steps) stay plain.  The reference's
    ``abstract_train_state``."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..optim import optimizer_state_axes
    cfg = bundle.cfg
    optimizer = make_optimizer(cfg.optimizer, lr_fn or lr_schedule_for(cfg))
    rules = resolve_rules(rules_dict, mesh)
    fake = detect_fake_mode() or FakeTensorMode()
    with fake:
        params = bundle.init(torch.Generator().manual_seed(0), 'cpu')
        opt = optimizer.init(params)
    axes = bundle.param_axes(cfg)
    p_lay = shd.param_sharding_tree(axes, params, mesh, rules)
    o_lay = shd.param_sharding_tree(
        optimizer_state_axes(cfg.optimizer, axes), opt, mesh, rules)
    with fake:
        state = {'params': shd.place(params, p_lay),
                 'opt': shd.place(opt, o_lay),
                 'step': torch.zeros((), dtype=torch.int32)}
    return state, {'params': p_lay, 'opt': o_lay, 'step': None}, optimizer


def batch_shardings(cfg, shape, mesh, rules_dict) -> Dict[str, object]:
    """{input name: ``sharding.Layout``} of ``input_specs(cfg, shape)``
    on ``mesh`` by ``batch_axes``."""
    from ..models import batch_axes, input_specs
    rules = shd.ShardingRules(mesh, resolve_rules(rules_dict, mesh))
    ax = batch_axes(cfg, shape)
    return {k: shd.Layout(mesh, rules.spec(ax[k], spec.shape))
            for k, spec in input_specs(cfg, shape).items()}


def local_mesh(device_type: str = 'cuda'):
    """The largest (data, model) ``DeviceMesh`` over the process group's
    ranks, one card each (the model axis the largest of 16, 8, 4, 2, 1
    that divides their count): (1, 1) on one card, where a one-rank
    ``gloo`` group on localhost is made when none exists."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size() if dist.is_initialized() else 1
    model = next(m for m in (16, 8, 4, 2, 1) if n % m == 0)
    if not dist.is_initialized():
        dist.init_process_group(
            'gloo', init_method=f'tcp://localhost:{_free_port()}', rank=0,
            world_size=1)
    if device_type == 'cuda' and torch.cuda.is_available():
        # a rank's card, set before the mesh is built
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=('data', 'model'))


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def state_layouts(state, mesh, cfg, rules_dict):
    """The layouts of a train state ({'params', 'opt', 'step'}) on
    ``mesh`` by its logical axes (``abstract_train_state``'s)."""
    from ..models import get_bundle
    from ..optim import optimizer_state_axes
    rules = resolve_rules(rules_dict, mesh)
    axes = get_bundle(cfg).param_axes(cfg)
    return {'params': shd.param_sharding_tree(axes, state['params'], mesh,
                                              rules),
            'opt': shd.param_sharding_tree(
                optimizer_state_axes(cfg.optimizer, axes), state['opt'],
                mesh, rules)}


def place_state(state, layouts):
    """``state`` placed by ``state_layouts``."""
    return {'params': shd.place(state['params'], layouts['params']),
            'opt': shd.place(state['opt'], layouts['opt']),
            'step': state['step']}


def _rank_mesh(device_type: str):
    """``local_mesh()`` when this process is one rank of a process group
    of several (made by the caller, or from torchrun's environment), else
    None: one process trains on its plain tensors."""
    import torch.distributed as dist
    if not dist.is_initialized() and int(os.environ.get('WORLD_SIZE',
                                                        '1')) > 1:
        dist.init_process_group('nccl' if device_type == 'cuda' else 'gloo')
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return local_mesh(device_type)


def _sharded_scope(mesh):
    """Where a sharded step runs: ``TRAIN_RULES`` on ``mesh`` installed
    (the models' ``logical`` sites and the MoE's groups read them) and
    DTensor's implicit replication of plain tensors (a scalar, a mask)
    on; nothing for None."""
    scope = contextlib.ExitStack()
    if mesh is not None:
        from torch.distributed.tensor.experimental import \
            implicit_replication
        scope.enter_context(shd.use_rules(shd.ShardingRules(
            mesh, resolve_rules(shd.TRAIN_RULES, mesh))))
        scope.enter_context(implicit_replication())
    return scope


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
    mesh = _rank_mesh(torch.device(args.device).type)
    state = init_train_state(cfg, optimizer, args.device)
    layouts = None
    if mesh is not None:
        layouts = state_layouts(state, mesh, cfg, shd.TRAIN_RULES)
        state = place_state(state, layouts)
        print(f'mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} of '
              f'{mesh.size()} ranks, TRAIN_RULES')

    ckpt = CheckpointManager(args.ckpt_dir)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state, shardings=layouts)
        start = int(state['step'])
        print(f'resumed at step {start}')

    if layouts is None:
        loader = HostLoader(source_for(cfg, shape), shape, args.device,
                            start_step=start)
    else:
        loader = ShardedLoader(
            source_for(cfg, shape), shape,
            batch_shardings(cfg, shape, mesh, shd.TRAIN_RULES),
            start_step=start, device=args.device)
    runner = FaultTolerantRunner(
        step_fn, ckpt_manager=ckpt,
        cfg=FaultConfig(heartbeat_path=f'{args.ckpt_dir}/heartbeat.json'),
        restore_fn=lambda: ckpt.restore(state, shardings=layouts))
    t0 = time.time()
    with _sharded_scope(mesh):
        for i, (step, batch) in zip(range(start, args.steps), loader):
            state, metrics = runner.run_step(step, state, batch)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f'step {step:5d} loss {float(metrics["loss"]):8.4f} '
                      f'gnorm {float(metrics["grad_norm"]):8.3f} '
                      f'({(time.time() - t0) / (i - start + 1):.2f}s/step)')
            if (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, state)
    ckpt.save(args.steps, state, blocking=True)
    if mesh is not None:
        loader.close()
    if cfg.family not in ('lstm', 'ssm'):      # the families with attention
        print(attention_launches())
    print(f'done; events: {runner.events[:5]}')


if __name__ == '__main__':
    main()
