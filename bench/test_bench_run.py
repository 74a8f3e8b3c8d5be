"""``bench/run.py`` fails without a card, printing no result and never
falling back to the CPU; on a card (``needs_cuda``) each cell runs a short
window and comes out correct."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from bench import harness

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_run_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    proc = subprocess.run(
        [sys.executable, 'bench/run.py', '--workload', 'ctc-f32.batch',
         '--seed', str(2 ** 31 + 3), '--seconds', '1', '--trace', '0'],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ''
    assert 'no result' in proc.stderr


@pytest.mark.needs_cuda
@pytest.mark.parametrize('cell', ['ctc-f32.batch', 'ctc-int8.batch'])
def test_cell_is_correct_on_the_card(cuda_device, cell):
    res = harness.run_cell(cell, 2 ** 31 + 9, 3.0, False)
    assert res['correct'], res['checks']
    assert res['device']['platform'] == 'gpu'
    assert res['metrics']['setup_s']['value'] > 0
    json.dumps(res)
