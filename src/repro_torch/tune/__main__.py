"""Offline schedule tuner CLI, on one card.

``python -m repro_torch.tune`` decides the int8 stack backend (K4 against
the K3 chain) at one shape, checks the cache's replay and writes it::

    python -m repro_torch.tune --measure --n-x 123 --n-h 421 --layers 3 \
        --T 16 --B 8 --tile 96
    python -m repro_torch.tune --device cpu            # predicted only

Predicted-only by default (the cold rule, no clock: deterministic);
``--measure`` runs the interleaved timed trial.  An existing ``--out`` is
loaded first and refined, never forgotten.  The cache is written to
``tuned_schedules_torch.json`` unless ``--out`` says otherwise; the
reference's ``tuned_schedules.json`` is never written.  The staged,
geometry and placement flags of the reference's tuner wait for the port's
multi-device scale-out.
"""
import argparse
import pathlib
import sys

REFERENCE_CACHE = (pathlib.Path(__file__).resolve().parents[3]
                   / 'tuned_schedules.json')


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog='python -m repro_torch.tune',
                                 description=__doc__.splitlines()[0])
    ap.add_argument('--out', default='tuned_schedules_torch.json',
                    help='schedule-cache JSON to write')
    ap.add_argument('--csv', default=None,
                    help='also write the trial records (shared CSV format)')
    ap.add_argument('--measure', action='store_true',
                    help='run the interleaved timed trial (default: the '
                         'predicted answer only)')
    ap.add_argument('--n-x', type=int, default=48)
    ap.add_argument('--n-h', type=int, default=96)
    ap.add_argument('--layers', type=int, default=3)
    ap.add_argument('--T', type=int, default=32)
    ap.add_argument('--B', type=int, default=4)
    ap.add_argument('--iters', type=int, default=3)
    ap.add_argument('--tile', type=int, default=None,
                    help='systolic plan tile of the int8 trial (default '
                         'min(n_h, 128); the deploy runs at 96)')
    ap.add_argument('--device', default='cuda',
                    help='torch device of the trial (cuda, cpu)')
    args = ap.parse_args(argv)

    out = pathlib.Path(args.out)
    if out.resolve() == REFERENCE_CACHE:
        raise SystemExit(f'{out} is the reference package\'s cache; write '
                         f'the port\'s elsewhere')
    from .autotune import replay_check, tune_quantized_backend
    from .schedule import ScheduleCache
    from .shmoo import write_shmoo_csv

    cache = ScheduleCache.load(out) if out.exists() else ScheduleCache()
    tile = args.tile or min(args.n_h, 128)
    entry, records = tune_quantized_backend(
        args.n_x, args.n_h, args.layers, args.T, args.B, cache=cache,
        tile=tile, measure=args.measure, iters=args.iters,
        device=args.device)
    trial = ', '.join(f"{r.params['backend']} "
                      f"{r.metrics['measured_us']:.1f} us" for r in records)
    print(f'q_stack_backend -> {entry.backend} ({entry.source}'
          + (f'; medians at tile {tile}: {trial}' if trial else '') + ')')
    checked, unchecked = replay_check(cache, device=args.device, tile=tile)
    print(f'replay check: {checked} entries stable, {len(unchecked)} of '
          f'kinds not checkable yet '
          f'{sorted({e.kind for e in unchecked})}')
    cache.save(out)
    print(f'wrote {len(cache)} entries -> {out}')
    if args.csv and records:
        write_shmoo_csv(args.csv, records)
        print(f'wrote {len(records)} trial records -> {args.csv}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
