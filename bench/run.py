"""Run one cell of the benchmark and print its result as the last line of
standard output:

    python bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, traffic and metrics are found by name from
``BENCHMARK.json``.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a traced part of the window.
The run needs the cards the cell asks for and fails without them; it
fails too, printing no result, when JAX or the JAX package was loaded.
The numbers compared to decide ``correct`` are printed last on standard
error, each beside its limit, and come last in the result line.
"""
import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the program inside the checkout
    os.environ['TORCH_EXTENSIONS_DIR'] = str(ROOT / 'build' / 'torch_ext')
    os.environ['TRITON_CACHE_DIR'] = str(ROOT / 'build' / 'triton')
    sys.path[:0] = [str(ROOT / 'src'), str(ROOT)]
    import torch
    marks = [('import torch', time.perf_counter())]
    from bench import harness

    chips = harness.load_cell(args.workload).chips
    enough = (torch.cuda.is_available()
              and torch.cuda.device_count() >= chips)
    marks.append(('CUDA found', time.perf_counter()))
    if not enough:
        print(f'{args.workload} needs {chips} CUDA device(s); found '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}'
              ': no result', file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_proc=T_PROC, marks=marks)
    found = harness.forbidden_modules()
    if found:
        print(f'JAX or the JAX package was loaded: {found}: no result',
              file=sys.stderr)
        return 3
    for k, v in result['checks'].items():
        print(f'check {k}: {v["value"]!r} (limit {v["limit"]!r})',
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
