"""Time one config's donating train step on the card under two source
trees, in turns, each turn a process of its own::

    python scripts/train_step_ab.py --arch xlstm-1.3b --batch 2 --seq 1024 \\
        --turns A,B,B,A A=old/src B=src

Each turn builds the config's full-width train state on the card (seed
0), draws one batch from ``data.source_for`` and runs ``--steps`` steps
of ``launch.train.make_train_step(donate=True)``; it prints the step
times (ms, the first step included) as one JSON line.  The last line
gathers every turn's.  Needs one CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys

_TURN = '''
import json, sys, time
import torch
from repro_torch import configs
from repro_torch.data import source_for
from repro_torch.launch.train import (init_train_state, loss_fn_for,
                                      lr_schedule_for, make_train_step)
from repro_torch.optim import make_optimizer
arch, batch, seq, steps = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \\
    int(sys.argv[4])
cfg = configs.get_config(arch)
opt = make_optimizer(cfg.optimizer, lr_schedule_for(cfg))
state = init_train_state(cfg, opt, 'cuda', seed=0)
shape = configs.ShapeConfig('ab', 'train', seq, batch)
host = source_for(cfg, shape).host_batch(0, 0, batch)
data = {k: torch.as_tensor(v).cuda() for k, v in host.items()}
step = make_train_step(loss_fn_for(cfg), opt, donate=True)
ms = []
for _ in range(steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, data)
    float(m['loss'])
    ms.append((time.perf_counter() - t0) * 1e3)
print(json.dumps({'step_ms': ms}))
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--arch', required=True)
    ap.add_argument('--batch', type=int, required=True)
    ap.add_argument('--seq', type=int, required=True)
    ap.add_argument('--steps', type=int, default=3)
    ap.add_argument('--turns', required=True,
                    help='the trees\' labels in run order, e.g. A,B,B,A')
    ap.add_argument('trees', nargs='+', help='LABEL=SRC_DIR')
    args = ap.parse_args(argv)
    trees = dict(t.split('=', 1) for t in args.trees)
    out = []
    for label in args.turns.split(','):
        proc = subprocess.run(
            [sys.executable, '-c', _TURN, args.arch, str(args.batch),
             str(args.seq), str(args.steps)],
            env=dict(os.environ, PYTHONPATH=trees[label]),
            capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        rec = dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                   tree=label)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    print(json.dumps({'arch': args.arch, 'batch': args.batch,
                      'seq': args.seq, 'turns': out}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
