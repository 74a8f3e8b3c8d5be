"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix and metric resolves to its file, and the entries keep to the
benchmark's contract."""
import importlib
import json
import pathlib
import re

import pytest

from bench import compare, gen, harness, yardstick

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
# what the harness needs of a configuration's reference module
REFERENCE_API = ('make_weights', 'make_inputs', 'macs_per_frame', 'readings')
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['bench']
    assert BENCH['command'][1] == 'bench/run.py'
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len((ROOT / 'BENCHMARK.json').read_bytes()) < 64 * 1024


@pytest.mark.parametrize('cfg', BENCH['configs'], ids=lambda c: c['name'])
def test_config_resolves(cfg):
    assert NAME.match(cfg['name'])
    path = ROOT / cfg['file']
    assert path.is_file() and cfg['file'].startswith('bench/configs/')
    data = json.loads(path.read_text())
    assert data['reduced'] == cfg['reduced'] == []
    assert (ROOT / 'bench' / 'entries' / f'{data["entry"]}.py').is_file()
    assert (ROOT / 'bench' / 'reference'
            / f'{data["reference"]}.py').is_file()
    ref = compare.reference(data)
    assert all(callable(getattr(ref, f, None)) for f in REFERENCE_API)
    assert data['dtype'] in yardstick.PEAK_OPS_PER_S
    assert any(w['config'] == cfg['name'] for w in BENCH['workloads'])


@pytest.mark.parametrize('wl', BENCH['workloads'], ids=lambda w: w['name'])
def test_workload_resolves(wl):
    assert NAME.match(wl['name']) and NAME.match(wl['traffic'])
    assert wl['chips'] == 1 and len(wl['why']) <= 200
    cell = harness.load_cell(wl['name'], BENCH)
    assert 'setup_s' in cell.end_to_end and len(cell.end_to_end) >= 2
    assert cell.per_layer
    assert set(cell.cell['limits']) >= {'logprob_gap', 'rows_missing'}
    assert (ROOT / 'bench' / 'loops' / f'{cell.cell["loop"]}.py').is_file()
    assert callable(importlib.import_module(
        f'bench.loops.{cell.cell["loop"]}').drive)
    gen.load(wl['traffic'])


def test_pairs_unique():
    pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
    assert len(pairs) == len(set(pairs))
    names = ([m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
             + [w['name'] for w in BENCH['workloads']])
    assert len(names) == len(set(names))


@pytest.mark.parametrize('m', BENCH['end_to_end'] + BENCH['per_layer'],
                         ids=lambda m: m['name'])
def test_metric_resolves(m):
    assert NAME.match(m['name']) and UNIT.match(m['unit'])
    mod = harness.metric_module(m['name'])
    assert (mod.UNIT, mod.SOURCE, mod.BETTER) == (m['unit'], m['source'],
                                                  m['better'])
    if m in BENCH['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    elif 'layer' in m:
        assert (mod.LAYER, mod.MOVES) == (m['layer'], m['moves'])
        e2e = {e['name']: e for e in BENCH['end_to_end']}
        for cell in m['workloads']:
            assert cell in e2e[m['moves']].get('workloads', [cell])
    if m['name'].endswith('_roofline') or '_roofline.' in m['name']:
        assert m['unit'] == '%'
