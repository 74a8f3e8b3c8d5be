"""The benchmark's harness: finds a cell's files by name, builds the system
under test through the configuration's entry, drives it with the cell's
loop and traffic, times the window, decides ``correct`` against the
configuration's plain reference, and reads the metrics that
``BENCHMARK.json`` assigns to the cell.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by its name in ``BENCHMARK.json``:
``bench/configs/<config>.json``, ``bench/traffic/<traffic>.json``,
``bench/workloads/<cell>.json`` and ``bench/metrics/<metric>.py``.  The
configuration names its entry (``bench/entries/<entry>.py``: the program's
front end) and its reference (``bench/reference/<reference>.py``: the
weights, the inputs, the operations a frame and the comparison); the cell
names its drive loop (``bench/loops/<loop>.py``).
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
import sys
import time
from typing import List, Optional, Tuple

import torch

from . import compare, gen
from .readers import Context
from .trace import Tracer

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / 'bench'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'repro', 'benchmarks')


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is JAX's, Flax's, the JAX package's or its benchmarks'."""
    return sorted({m for m in list(sys.modules)
                   if m.split('.')[0] in FORBIDDEN})


def load_benchmark() -> dict:
    return json.loads((ROOT / 'BENCHMARK.json').read_text())


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str):
    """The reader of metric ``name`` (``bench/metrics/<name>.py``)."""
    return load_module(BENCH / 'metrics' / f'{name}.py',
                       'bench.metrics.' + name.replace('.', '_'))


@dataclasses.dataclass
class Cell:
    """One cell's files, resolved by name."""
    name: str
    config: dict
    cell: dict
    traffic: dict
    chips: int
    end_to_end: List[str]
    per_layer: List[str]


def _reports(metric: dict, cell: str, e2e_of_cell: List[str]) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    list, else every cell (an end-to-end metric) or every cell that
    reports the end-to-end metric it moves (a per-layer one)."""
    if 'workloads' in metric:
        return cell in metric['workloads']
    return 'moves' not in metric or metric['moves'] in e2e_of_cell


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    """Resolve cell ``name`` of ``BENCHMARK.json`` to its files."""
    bench = bench or load_benchmark()
    wl = {w['name']: w for w in bench['workloads']}.get(name)
    if wl is None:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')
    cfg = {c['name']: c for c in bench['configs']}[wl['config']]
    e2e = [m['name'] for m in bench['end_to_end']
           if _reports(m, name, [])]
    per_layer = [m['name'] for m in bench['per_layer']
                 if _reports(m, name, e2e)]
    return Cell(name=name,
                config=json.loads((ROOT / cfg['file']).read_text()),
                cell=json.loads((BENCH / 'workloads' / f'{name}.json')
                                .read_text()),
                traffic=gen.load(wl['traffic']), chips=wl['chips'],
                end_to_end=e2e, per_layer=per_layer)


def _sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_proc: Optional[float] = None,
             marks: Optional[List[Tuple[str, float]]] = None, device='cuda',
             config_overrides: Optional[dict] = None,
             cell_overrides: Optional[dict] = None,
             traffic_overrides: Optional[dict] = None,
             fault: Optional[str] = None, control: bool = False) -> dict:
    """One run of cell ``name``: the result object that ``run.py`` prints.
    ``marks`` are the set-up's earlier phases, (name, end time).
    ``config_overrides``, ``cell_overrides`` and ``traffic_overrides``
    (tests at a small size), ``fault`` (a fault planted in the timed path)
    and ``control`` (add the control's readings) are for the tests and the
    tools, never for the benchmark's own runs."""
    t_proc = time.perf_counter() if t_proc is None else t_proc
    marks = list(marks or []) + [('harness', time.perf_counter())]
    bench = load_benchmark()
    c = load_cell(name, bench)
    cfg = dict(c.config, **(config_overrides or {}))
    cell = dict(c.cell, **(cell_overrides or {}))
    spec = dict(c.traffic, **(traffic_overrides or {}))
    dev = torch.device(device)
    ref = compare.reference(cfg)
    entry = importlib.import_module(f'bench.entries.{cfg["entry"]}')
    loop = importlib.import_module(f'bench.loops.{cell["loop"]}')
    weights = ref.make_weights(cfg, seed, dev)
    pool = ref.make_inputs(cfg, cell['pool_frames'], seed, dev)
    traffic = gen.Traffic(spec, seed, cell['pool_frames'], cell.get('batch'))
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(('weights and frames', time.perf_counter()))
    system = entry.System(cfg, cell, weights, dev)
    marks.append(('system', time.perf_counter()))
    system.warm(pool)
    marks.append(('kernels warmed', time.perf_counter()))
    if fault is not None:
        system.inject(fault)
    tracer = None
    if trace:
        tracer = Tracer(dev)
        tracer.prime()
        marks.append(('profiler primed', time.perf_counter()))
    print('set-up: ' + ', '.join(
        f'{k} {t - t0:.2f} s' for (k, t), (_, t0)
        in zip(marks, [('start', t_proc)] + marks[:-1])), file=sys.stderr)
    res = loop.drive(system, traffic, pool, cell, seconds, tracer, t_proc,
                     seed)
    _sync(dev)
    print(f'set-up: traffic warm-up '
          f'{res["setup_s"] - (marks[-1][1] - t_proc):.2f} s; '
          f'set-up {res["setup_s"]:.2f} s', file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda' else 0

    # the program's state freed before the reference runs
    sample = res.pop('sample')
    system.close()
    del system, pool
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    checks = compare.check(cfg, cell, weights, sample, dev)
    correct = (bool(sample) and res['attempted'] > 0
               and all(v['value'] <= v['limit'] for v in checks.values()))
    if control:
        checks_control = compare.control(cfg, weights, sample, dev)

    summary, traced = res['trace'] if res['trace'] else (None, None)
    ctx = Context(config=cfg, cell=cell, setup_s=res['setup_s'],
                  window_s=res['window_s'], frames=res['frames'],
                  ops_per_frame=2.0 * ref.macs_per_frame(cfg),
                  trace=summary, traced=traced, run=res)
    names = c.per_layer if trace else c.end_to_end
    units = {m['name']: m['unit'] for m in bench['end_to_end']
             + bench['per_layer']}
    metrics = {}
    for m in names:
        v = metric_module(m).read(ctx)
        if v is not None:
            metrics[m] = {'value': float(v), 'unit': units[m]}
    device_info = {'platform': 'gpu' if dev.type == 'cuda' else dev.type,
                   'kind': (torch.cuda.get_device_name(dev)
                            if dev.type == 'cuda' else 'cpu'),
                   'count': 1, 'memory_peak_bytes': int(peak)}
    if summary is not None:
        device_info['busy_s'] = summary.busy_s
        device_info['window_s'] = summary.window_s
    out = {'correct': bool(correct), 'attempted': int(res['attempted']),
           'failed': int(res['failed']), 'metrics': metrics,
           'device': device_info}
    if summary is not None:
        out['breakdown'] = summary.breakdown()
    if control:
        out['control'] = checks_control
    out['checks'] = checks
    return out
