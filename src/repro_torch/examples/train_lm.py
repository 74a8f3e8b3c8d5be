"""End to end: train a ~100M-parameter LM for a few hundred steps.

The port of the reference's ``examples/train_lm.py``: the qwen3 block
architecture scaled to ~100M parameters (``lm_100m``; ``--tiny`` for a
2-layer check), on the port's substrate: ``SyntheticLM`` batches through
``HostLoader``, AdamW + cosine, a donating ``make_train_step`` (K8's
forward and backward kernels in the attention) under
``FaultTolerantRunner`` (a retry restores the latest checkpoint), and
checkpoints with ``--resume``.  One card, no mesh; on the card unless
``--device cpu``::

    python -m repro_torch.examples.train_lm --steps 300
    python -m repro_torch.examples.train_lm --steps 20 --tiny --device cpu
"""
import argparse
import pathlib
import time

from ..checkpoint import CheckpointManager
from ..configs import ShapeConfig, get_config
from ..data import HostLoader, source_for
from ..launch.train import (attention_launches, init_train_state,
                            loss_fn_for, make_train_step)
from ..models import get_bundle
from ..optim import cosine_schedule, make_optimizer
from ..runtime import FaultConfig, FaultTolerantRunner

DEFAULT_CKPT_DIR = (pathlib.Path(__file__).resolve().parents[3] / 'build'
                    / 'train_lm_ckpt')


def lm_100m():
    """qwen3-family block at ~100M params."""
    return get_config('qwen3-14b').replace(
        name='qwen3-100m', n_layers=8, d_model=512, n_heads=8, n_kv_heads=4,
        head_dim=64, d_ff=1536, vocab_size=32768,
        param_dtype='float32', activation_dtype='float32', remat='none')


def lm_tiny():
    return lm_100m().replace(name='qwen3-tiny', n_layers=2, d_model=128,
                             d_ff=384, vocab_size=2048)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--steps', type=int, default=300)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--seq', type=int, default=256)
    ap.add_argument('--lr', type=float, default=3e-4)
    ap.add_argument('--tiny', action='store_true')
    ap.add_argument('--ckpt-dir', default=str(DEFAULT_CKPT_DIR))
    ap.add_argument('--resume', action='store_true')
    ap.add_argument('--device', default='cuda',
                    help='torch device of the weights and the batches '
                         '(cuda, cpu)')
    args = ap.parse_args(argv)

    cfg = lm_tiny() if args.tiny else lm_100m()
    shape = ShapeConfig('lm', 'train', args.seq, args.batch)
    optimizer = make_optimizer(
        cfg.optimizer, cosine_schedule(args.lr, warmup=20, total=args.steps))
    step_fn = make_train_step(loss_fn_for(cfg), optimizer, donate=True)
    state = init_train_state(cfg, optimizer, args.device)
    n = get_bundle(cfg).param_count(state['params'])
    print(f'{cfg.name}: {n / 1e6:.1f}M params on {args.device}')

    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        start = int(state['step'])
        print(f'resumed from step {start}')

    loader = HostLoader(source_for(cfg, shape), shape, args.device,
                        start_step=start)
    runner = FaultTolerantRunner(
        step_fn, cfg=FaultConfig(
            heartbeat_path=f'{args.ckpt_dir}/heartbeat.json'),
        restore_fn=lambda: ckpt.restore(state))

    t0 = time.time()
    tok_per_step = args.batch * args.seq
    for i, (step, batch) in zip(range(start, args.steps), loader):
        state, metrics = runner.run_step(step, state, batch)
        if step % 20 == 0 or step == args.steps - 1:
            dt = (time.time() - t0) / (i - start + 1)
            print(f'step {step:5d}  loss {float(metrics["loss"]):7.4f}  '
                  f'gnorm {float(metrics["grad_norm"]):6.2f}  '
                  f'{dt:.2f}s/step  {tok_per_step / dt:,.0f} tok/s')
        if (step + 1) % 100 == 0:
            ckpt.save(step + 1, state)
    ckpt.save(args.steps, state, blocking=True)
    print(attention_launches())
    print(f'finished; straggler/fault events: {len(runner.events)}')


if __name__ == '__main__':
    main()
