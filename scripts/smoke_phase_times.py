"""Run a checkout's ``chip_smoke.py`` with the wall seconds of each of its
phases printed, as the current ``chip_smoke.py`` prints its own, so that
an older checkout's script can be compared with it phase by phase::

    python scripts/smoke_phase_times.py path/to/old/chip_smoke.py [ARGS]

The old script runs as it is (its own ``main``, its own ``src``); only
the functions named in the current script's ``PHASES`` are wrapped in
timers.  Needs what ``chip_smoke.py`` needs: one CUDA card.
"""
import importlib.util
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    current = load(ROOT / 'chip_smoke.py', '_current_chip_smoke')
    old = load(pathlib.Path(argv[0]).resolve(), 'chip_smoke')
    seconds = current.time_phases(vars(old))
    t0 = time.perf_counter()
    rc = old.main(argv[1:])
    seconds['total'] = time.perf_counter() - t0
    print('phase seconds: ' + json.dumps(
        {k: round(v, 1) for k, v in seconds.items()}), flush=True)
    return rc


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
