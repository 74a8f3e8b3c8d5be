"""The comparison that decides ``correct``, driven through a whole run on
the CPU at a small size (the look for a card skipped): a sound run comes
out correct, and each fault planted in the timed path comes out not
correct, as does the control put in the program's place."""
import pytest

from bench import harness

SMALL = dict(n_x=13, n_h=32, n_layers=2, n_out=16)
SHORT = {'dist': 'lognormal', 'median': 12, 'sigma': 0.3, 'min': 6,
         'max': 20, 'block': 32}
CELLS = {
    'ctc-f32.batch': dict(slots=3, chunk=4, queue_depth=3, warmup_s=0.1,
                          sample={'share': 1.0, 'max': 1000}),
    'ctc-int8.batch': dict(batch=2, warmup_batches=1,
                           sample={'rows_per_batch': 1, 'max': 1000}),
}
FAULTS = ('state_unchanged', 'half_batch', 'answer_altered')


def _run(cell, fault=None, control=False):
    return harness.run_cell(
        cell, 2 ** 31 + 5, 0.4, False, device='cpu',
        config_overrides=SMALL,
        cell_overrides=dict(CELLS[cell], pool_frames=4096, trace_s=0.2),
        traffic_overrides=dict(lengths=SHORT, pool_batches=2),
        fault=fault, control=control)


@pytest.mark.parametrize('cell', sorted(CELLS))
def test_sound_run_is_correct_and_control_is_not(cell):
    res = _run(cell, control=True)
    assert res['correct'], res['checks']
    assert list(res)[-1] == 'checks'
    limits = {k: v['limit'] for k, v in res['checks'].items()}
    assert any(res['control'][k] > limits[k] for k in limits), res['control']


@pytest.mark.parametrize('cell', sorted(CELLS))
@pytest.mark.parametrize('fault', FAULTS)
def test_fault_is_not_correct(cell, fault):
    res = _run(cell, fault=fault)
    assert not res['correct'], (fault, res['checks'])
