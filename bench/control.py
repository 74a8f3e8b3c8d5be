"""The readings that a cell's limits are set from: the program's numbers
on many seeds (the lower reading is their largest) and, on some of them,
the control's (the reference in the nearest lower precision in the
program's place; the upper reading is its smallest), all in one process,
each seed a whole run at the cell's size.  The benchmark's own runs never
run the control.

    python bench/control.py --workload ctc-f32.batch --seconds 20 \
        --seeds 101-112 --control-seeds 101-103
"""
import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _seeds(text: str):
    out = []
    for part in text.split(','):
        lo, _, hi = part.partition('-')
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--control-seeds', default='')
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / 'src'), str(ROOT)]
    import torch
    from bench import harness
    if not torch.cuda.is_available():
        print('the control needs a CUDA device', file=sys.stderr)
        return 2
    ctl = set(_seeds(args.control_seeds)) if args.control_seeds else set()
    lower, upper = {}, {}
    for seed in _seeds(args.seeds):
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               control=seed in ctl)
        got = {k: v['value'] for k, v in res['checks'].items()}
        for k, v in got.items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in res.get('control', {}).items():
            upper[k] = min(upper.get(k, v), v)
        print(json.dumps({'seed': seed, 'correct': res['correct'],
                          'program': got, 'control': res.get('control'),
                          'attempted': res['attempted'],
                          'metrics': {k: m['value'] for k, m in
                                      res['metrics'].items()}}), flush=True)
    print(json.dumps({'workload': args.workload, 'lower': lower,
                      'upper': upper}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
