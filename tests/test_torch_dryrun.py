"""The port's production-mesh dry run (``repro_torch.launch.dryrun``) on
the CPU: real steps at full width, traced on fake DTensors over a fake
256- or 512-rank process group.

The cells run in a subprocess per mesh, both at once (a process holds one
process group).  CTC-3L-421H-UNI's train_4k cell: status ok on 256 ranks,
the reference's parameter count, and the ``lstm`` family rule (the batch
over the whole mesh) makes the useful-FLOP fraction at least 8x that
without it (the reference's comment: 0.062 without).  xLSTM-1.3B's
decode_32k on the multi-pod mesh: 512 ranks.  Mixtral 8x22B's decode_32k:
the MoE blocks run every expert at capacity, with no host read of the
expert counts (a read of a fake tensor raises).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import pytest

from repro import configs as jconfigs
from repro.launch.train import abstract_init as jabstract_init
from repro.models import get_bundle as jget_bundle

SRC = os.path.join(os.path.dirname(__file__), '..', 'src')


_SNIPPETS = {
    # the (16, 16) mesh: the CTC LSTM's train cell with and without the
    # lstm family rule, and Mixtral's decode cell
    'single_pod': '''
        import json
        from repro_torch import sharding as shd
        from repro_torch.models import layers
        from repro_torch.launch.dryrun import lower_cell
        print(json.dumps(['chipmunk', lower_cell('chipmunk-ctc', 'train_4k',
                                                 False)]))
        print(json.dumps(['chipmunk', lower_cell(
            'chipmunk-ctc', 'train_4k', False,
            override_rules=shd.TRAIN_RULES)]))
        reads, calls = [], []
        live, sharded = layers._live_experts, layers._moe_block_sharded
        layers._live_experts = lambda c: reads.append(live(c)) or reads[-1]
        layers._moe_block_sharded = (
            lambda *a: calls.append(1) or sharded(*a))
        rec = lower_cell('mixtral-8x22b', 'decode_32k', False)
        rec['live_reads'] = reads
        rec['moe_calls'] = len(calls)
        print(json.dumps(['moe', rec]))
    ''',
    'multi_pod': '''
        import json
        from repro_torch.launch.dryrun import lower_cell
        print(json.dumps(['multipod', lower_cell('xlstm-1.3b', 'decode_32k',
                                                 True)]))
    ''',
}


@pytest.fixture(scope='module')
def cells():
    """{cell: the records the snippets print under its name}, the
    snippets run at once, each in a process of its own."""
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen(
        [sys.executable, '-c', textwrap.dedent(code)], env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for code in _SNIPPETS.values()]
    out = {}
    for p in procs:
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr[-4000:]
        for line in stdout.splitlines():
            if line.startswith('["'):
                name, rec = json.loads(line)
                out.setdefault(name, []).append(rec)
    return out


def test_chipmunk_train_cell_and_the_lstm_rule(cells):
    with_rule, without = cells['chipmunk']
    jb = jget_bundle(jconfigs.get_config('chipmunk-ctc'))
    sds, _ = jabstract_init(jb.init, jax.random.PRNGKey(0))
    for rec in (with_rule, without):
        assert rec['status'] == 'ok' and rec['n_chips'] == 256
        assert rec['params'] == rec['active_params'] == jb.param_count(sds)
        assert rec['cost']['kernels']['lstm_stack_seq_kernel'][
            'launches'] == 1
        mem = rec['memory']
        assert all(mem[k] > 0 for k in ('argument_size_bytes',
                                        'output_size_bytes',
                                        'temp_size_bytes'))
    f_with = with_rule['roofline']['useful_flops_fraction']
    f_without = without['roofline']['useful_flops_fraction']
    assert f_with >= 8 * f_without, (f_with, f_without)
    # pure data parallelism: the gradients' all-reduce, nothing else
    assert set(with_rule['roofline']['per_collective']) == {'all-reduce'}


def test_multipod_decode_cell(cells):
    (rec,) = cells['multipod']
    assert rec['status'] == 'ok' and rec['n_chips'] == 512
    assert rec['mesh'] == 'multi_pod_2x16x16'
    assert rec['roofline']['bottleneck'] == 'memory'


def test_moe_cell_runs_every_expert_without_a_host_read(cells):
    (rec,) = cells['moe']
    assert rec['status'] == 'ok' and rec['n_chips'] == 256
    assert rec['moe_calls'] == 56 and rec['live_reads'] == []
    assert rec['cost']['kernels']['flash_attention']['launches'] == 56
    assert rec['active_params'] < rec['params']
