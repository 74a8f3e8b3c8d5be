"""The drive loops and the entries they drive, at a small size on the
CPU: each loop returns what the harness reads, and the streaming entry's
hook on the engine's chunk call fails loudly once the engine replaces the
call."""
import importlib

import pytest
import torch

from bench import gen, harness

SMALL = dict(n_x=13, n_h=32, n_layers=2, n_out=16)
SHORT = {'dist': 'lognormal', 'median': 12, 'sigma': 0.3, 'min': 6,
         'max': 20, 'block': 32}
CELLS = {
    'ctc-f32.batch': dict(slots=3, chunk=4, queue_depth=3, warmup_s=0.05,
                          sample={'share': 1.0, 'max': 1000}),
    'ctc-int8.batch': dict(batch=2, warmup_batches=1,
                           sample={'rows_per_batch': 1, 'max': 1000}),
}
KEYS = {'setup_s', 'window_s', 'frames', 'attempted', 'failed', 'trace',
        'sample'}


def _system(cell):
    c = harness.load_cell(cell)
    cfg = dict(c.config, **SMALL)
    spec = dict(c.traffic, lengths=SHORT, pool_batches=2)
    cc = dict(c.cell, **CELLS[cell], pool_frames=4096, trace_s=0.2)
    ref = importlib.import_module(f'bench.reference.{cfg["reference"]}')
    w = ref.make_weights(cfg, 21, 'cpu')
    pool = ref.make_inputs(cfg, cc['pool_frames'], 21, 'cpu')
    entry = importlib.import_module(f'bench.entries.{cfg["entry"]}')
    system = entry.System(cfg, cc, w, torch.device('cpu'))
    return system, gen.Traffic(spec, 21, 4096, cc.get('batch')), pool, cc


@pytest.mark.parametrize('cell', sorted(CELLS))
def test_loop_returns_what_the_harness_reads(cell):
    system, traffic, pool, cc = _system(cell)
    system.warm(pool)
    loop = importlib.import_module(f'bench.loops.{cc["loop"]}')
    res = loop.drive(system, traffic, pool, cc, 0.3, None, 0.0, 21)
    assert KEYS <= set(res)
    assert res['frames'] > 0 and res['attempted'] > 0
    assert res['window_s'] >= 0.3 and res['trace'] is None
    for s in res['sample']:
        assert len(s['frames']) == s['length'] == len(s['lp'])


def test_stream_hook_fails_loudly():
    system, traffic, pool, _ = _system('ctc-f32.batch')
    system.submit(pool[:10].numpy())
    assert system.step()
    system.engine._fwd = system.engine._make_fwd(system.engine.cfg)
    with pytest.raises(RuntimeError, match='hook'):
        system.step()
