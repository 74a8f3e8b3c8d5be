"""Offline schedule tuner CLI.

``python -m repro_torch.tune`` decides the int8 stack backend (K4 against
the K3 chain) and K2's layer block ``lb`` at one shape, shmoos the staged
schedule of one ``--stages x (--rows x --cols)`` placement, checks the
cache's replay and writes it::

    python -m repro_torch.tune --measure --n-x 123 --n-h 421 --layers 3 \\
        --T 16 --B 8 --tile 96 --stages 3 --rows 5 --cols 5
    python -m repro_torch.tune --device cpu            # predicted only

Predicted-only by default (the cold rule and the model's ranking, no clock:
deterministic, byte for byte); ``--measure`` runs the int8 trial and the
layer-block trial (``tune_stack_lb``).
``--staged-devices N`` is an engine budget on ``--device``: the staged
chunk depth of the placement is then measured in process, every engine on
that device and one controller driving them (``tune_staged_stack``);
``--placements SxRxC,...`` measures several placements in one run.
``--geometry`` shmoos the placement itself inside the ``--devices``
budget (``tune_geometry``): every mesh shape and stage split, with the
fixed placement as the balanced reference; measured with
``--staged-devices``, inside the reference's arithmetic class unless
``--allow-reassoc``.  A single placement over the budget fails before any
tuning; inside ``--placements`` it is skipped with a warning.

An existing ``--out`` is loaded first and refined, never forgotten.  The
cache is written to ``tuned_schedules_torch.json`` unless ``--out`` says
otherwise; the reference's ``tuned_schedules.json`` is never written.
``--csv`` writes the staged or geometry shmoo in the shared format, and
the int8 trial's records beside it (``.q.csv``).
"""
import argparse
import pathlib
import sys

REFERENCE_CACHE = (pathlib.Path(__file__).resolve().parents[3]
                   / 'tuned_schedules.json')


def _device_budget_error(stages: int, rows: int, cols: int,
                         engines: int) -> str:
    """The message for a placement over the engine budget ('' when it
    fits), checked before any tuning starts."""
    need = stages * rows * cols
    if engines >= need:
        return ''
    return (f'mesh stage:{stages} x (row:{rows} x col:{cols}) needs {need} '
            f'engines but --staged-devices={engines}; pass '
            f'--staged-devices >= {need} or shrink --stages/--rows/--cols')


def _parse_placements(spec: str):
    out = []
    for part in spec.split(','):
        dims = part.lower().split('x')
        if len(dims) != 3 or not all(d.isdigit() and int(d) >= 1
                                     for d in dims):
            raise SystemExit(f'bad --placements entry {part!r}: expected '
                             f'SxRxC with positive integers, e.g. 2x5x5')
        out.append(tuple(int(d) for d in dims))
    return out


def _trial_stack(args):
    """The seeded stack and input of the staged and geometry trials."""
    import torch
    from ..core.lstm import init_lstm_stack, stack_params_to
    stack = stack_params_to(init_lstm_stack(
        args.n_x, args.n_h, args.layers, None,
        torch.Generator().manual_seed(42)), args.device)
    xs = torch.randn((args.T, args.B, args.n_x),
                     generator=torch.Generator().manual_seed(43)) * 0.5
    return stack, xs.to(args.device)


def _tune_geometry(args, cache, budget: int):
    """``--geometry``: the predicted winner, or the measured trial."""
    from .autotune import tune_geometry
    stack, xs = _trial_stack(args)
    ent, _, base = tune_geometry(
        stack, xs, devices=budget, ref=(args.stages, args.rows, args.cols),
        cache=cache, iters=args.iters, measure=bool(args.staged_devices),
        allow_reassoc=args.allow_reassoc, device=args.device)
    what = (f'geometry -> {ent.stages}x({ent.rows}x{ent.cols}) '
            f'blocks={ent.blocks} Tc={ent.tc} in_stage={ent.in_stage}')
    if ent.source == 'predicted':
        print(f'{what} (predicted)')
    else:
        print(f'{what} (measured, {ent.measured_us / 1e3:.3f} ms, '
              f'{base / ent.measured_us:.2f}x balanced ref '
              f'{args.stages}x({args.rows}x{args.cols}) '
              f'{base / 1e3:.3f} ms)')


def _tune_staged(args, cache, records):
    """The staged schedule: the predicted entry of the fixed placement, or
    measured trials on each placement within ``--staged-devices``."""
    from ..core.systolic import make_systolic_mesh
    from .autotune import tune_staged_stack
    from .schedule import ScheduleEntry
    if not args.staged_devices:
        if records:
            p = records[0].params
            cache.record(ScheduleEntry(
                kind='stack_f32', n_x=args.n_x, n_h=args.n_h,
                n_layers=args.layers, T=args.T, B=args.B,
                mesh=f'stage:{args.stages},row:{args.rows},col:{args.cols}',
                tc=int(p['tc']), in_stage=str(p['in_stage']),
                bn=int(p['bn']), bk=int(p['bk']), lb=int(p['lb']),
                predicted_us=records[0].metrics['predicted_us'],
                source='predicted'))
            print(f"staged schedule -> Tc={p['tc']} "
                  f"in_stage={p['in_stage']} (predicted)")
        return
    placements = (_parse_placements(args.placements) if args.placements
                  else [(args.stages, args.rows, args.cols)])
    batch = len(placements) > 1
    stack, xs = _trial_stack(args)
    for stages, rows, cols in placements:
        try:
            err = _device_budget_error(stages, rows, cols,
                                       args.staged_devices)
            if err:
                raise ValueError(err)
            ent, _ = tune_staged_stack(
                stack, make_systolic_mesh(rows, cols, stage=stages,
                                          devices=args.device),
                xs, cache=cache, iters=args.iters, device=args.device)
        except ValueError as e:
            if not batch:
                raise SystemExit(str(e))
            print(f'skipping {stages}x({rows}x{cols}): {e}', file=sys.stderr)
            continue
        print(f'staged schedule {stages}x({rows}x{cols}) -> Tc={ent.tc} '
              f'in_stage={ent.in_stage} (measured, '
              f'{ent.measured_us / 1e3:.3f} ms)')


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog='python -m repro_torch.tune',
                                 description=__doc__.splitlines()[0])
    ap.add_argument('--out', default='tuned_schedules_torch.json',
                    help='schedule-cache JSON to write')
    ap.add_argument('--csv', default=None,
                    help='also write the staged or geometry shmoo (shared '
                         'CSV format) and the int8 trial records (.q.csv)')
    ap.add_argument('--measure', action='store_true',
                    help='run the interleaved int8 and layer-block trials '
                         '(default: the predicted answers only)')
    ap.add_argument('--staged-devices', type=int, default=0,
                    help='engine budget on --device for measured staged / '
                         'geometry trials, one controller driving every '
                         'engine (0 = predicted-only)')
    ap.add_argument('--geometry', action='store_true',
                    help='tune the mesh geometry (stages x rows x cols and '
                         'the stage split) for the --devices budget instead '
                         'of the schedule of the fixed placement')
    ap.add_argument('--devices', type=int, default=0,
                    help='engine budget of --geometry (default: '
                         '--staged-devices, else stages*rows*cols)')
    ap.add_argument('--allow-reassoc', action='store_true',
                    help='let the measured geometry trial cross arithmetic '
                         'classes (allclose-gated; default: only the '
                         'bit-equal class of the reference placement)')
    ap.add_argument('--placements', default=None,
                    help='comma-separated SxRxC staged placements to '
                         'measure in one run (over-budget entries are '
                         'skipped with a warning)')
    ap.add_argument('--n-x', type=int, default=48)
    ap.add_argument('--n-h', type=int, default=96)
    ap.add_argument('--layers', type=int, default=3)
    ap.add_argument('--T', type=int, default=32)
    ap.add_argument('--B', type=int, default=4)
    ap.add_argument('--stages', type=int, default=2)
    ap.add_argument('--rows', type=int, default=2)
    ap.add_argument('--cols', type=int, default=2)
    ap.add_argument('--iters', type=int, default=3)
    ap.add_argument('--tile', type=int, default=None,
                    help='systolic plan tile of the int8 trial (default '
                         'min(n_h, 128); the deploy runs at 96)')
    ap.add_argument('--device', default='cuda',
                    help='torch device of the trials and of every engine '
                         '(cuda, cpu)')
    args = ap.parse_args(argv)

    out = pathlib.Path(args.out)
    if out.resolve() == REFERENCE_CACHE:
        raise SystemExit(f'{out} is the reference package\'s cache; write '
                         f'the port\'s elsewhere')
    budget = (args.devices or args.staged_devices
              or args.stages * args.rows * args.cols)
    # fail fast on an impossible request, before any tuning; --placements
    # entries are checked one by one (an over-budget one is skipped)
    if args.staged_devices:
        if args.geometry:
            if args.staged_devices < budget:
                raise SystemExit(f'--devices={budget} exceeds '
                                 f'--staged-devices={args.staged_devices}')
            err = _device_budget_error(args.stages, args.rows, args.cols,
                                       budget)
            if err:
                raise SystemExit(f'reference placement over budget: {err}')
        elif not args.placements:
            err = _device_budget_error(args.stages, args.rows, args.cols,
                                       args.staged_devices)
            if err:
                raise SystemExit(err)

    from .autotune import replay_check, tune_quantized_backend, tune_stack_lb
    from .schedule import ScheduleCache
    from .shmoo import (card_budget, geometry_shmoo_records,
                        staged_shmoo_records, write_shmoo_csv)

    cache = ScheduleCache.load(out) if out.exists() else ScheduleCache()
    tile = args.tile or min(args.n_h, 128)
    entry, q_records = tune_quantized_backend(
        args.n_x, args.n_h, args.layers, args.T, args.B, cache=cache,
        tile=tile, measure=args.measure, iters=args.iters,
        device=args.device)
    trial = ', '.join(f"{r.params['backend']} "
                      f"{r.metrics['measured_us']:.1f} us" for r in q_records)
    print(f'q_stack_backend -> {entry.backend} ({entry.source}'
          + (f'; medians at tile {tile}: {trial}' if trial else '') + ')')

    # K2's layer block at the same shape
    lb_ent, lb_records = tune_stack_lb(
        args.n_x, args.n_h, args.layers, args.T, args.B, cache=cache,
        measure=args.measure, iters=args.iters, device=args.device)
    if lb_ent is not None:
        trial = ', '.join(f"lb={r.params['lb']} "
                          f"{r.metrics['measured_us']:.1f} us"
                          for r in lb_records if r.metrics['measured_us'])
        print(f'stack_lb -> lb={lb_ent.lb} ({lb_ent.source}'
              + (f'; medians: {trial}' if trial else '') + ')')

    shape = (args.n_x, args.n_h, args.layers, args.T, args.B)
    if args.geometry:
        records = geometry_shmoo_records(*shape, devices=budget,
                                         budget=card_budget(args.device))
        _tune_geometry(args, cache, budget)
    else:
        records = staged_shmoo_records(*shape, stages=args.stages,
                                       rows=args.rows, cols=args.cols,
                                       budget=card_budget(args.device))
        _tune_staged(args, cache, records)

    checked, unchecked = replay_check(cache, device=args.device, tile=tile)
    print(f'replay check: {checked} entries stable, {len(unchecked)} of '
          f'kinds not checkable '
          f'{sorted({e.kind for e in unchecked})}')
    cache.save(out)
    print(f'wrote {len(cache)} entries -> {out}')
    if args.csv:
        if q_records:
            for r in q_records:
                r.metrics.setdefault('predicted_us', 0.0)
            write_shmoo_csv(pathlib.Path(args.csv).with_suffix('.q.csv'),
                            q_records)
        if records:
            write_shmoo_csv(args.csv, records)
            print(f'wrote {len(records)} shmoo points -> {args.csv}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
