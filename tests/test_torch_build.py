"""The port's kernel build on the CPU (no ``nvcc`` needed): which sources
share the int8 and the f32 epilogue headers, that K5 and K6 share one
kernel body, what every source exports, and that a library's name follows
every header, so a change to a shared epilogue rebuilds every kernel that
includes it."""
import pathlib
import re

import pytest

from repro_torch.kernels import _build

INT8_SOURCES = ('lstm_seq_q', 'lstm_stack_seq_q')
HEADER = 'lstm_q_epilogue.cuh'


def test_int8_kernels_share_one_epilogue_header():
    assert (_build.CSRC / HEADER).exists()
    for name in INT8_SOURCES:
        src = (_build.CSRC / f'{name}.cu').read_text()
        assert f'#include "{HEADER}"' in src, name
        # the epilogue lives in the header only
        for fn in ('int gate_lut(', 'int rshift_round(', 'int sat16('):
            assert fn not in src, (name, fn)


@pytest.mark.parametrize('name', ['lstm_seq', 'lstm_stack_seq',
                                  'lstm_gates_rec'])
def test_f32_kernels_share_one_epilogue_header(name):
    """K1, K2 and K5 include the one f32 peephole epilogue and spell none
    of it out themselves."""
    assert (_build.CSRC / 'lstm_f32_epilogue.cuh').exists()
    src = (_build.CSRC / f'{name}.cu').read_text()
    assert '#include "lstm_f32_epilogue.cuh"' in src
    assert 'lstm_f32::cell_update(' in src
    for body in ('float sigmoid', 'expf(', 'tanhf('):
        assert body not in src, body


# source -> its exported launch functions (K1-K8 and K8's backward)
SOURCES = {'lstm_seq': ('lstm_seq_launch',),
           'lstm_stack_seq': ('lstm_stack_seq_launch',),
           'lstm_seq_q': ('lstm_seq_q_launch',),
           'lstm_stack_seq_q': ('lstm_stack_seq_q_launch',),
           'lstm_gates_rec': ('lstm_gates_rec_launch', 'lstm_gates_launch'),
           'quant_matmul': ('quant_matmul_launch',),
           'flash_attention': ('flash_attention_launch',),
           'flash_attention_bwd': ('flash_attention_bwd_kv_launch',
                                   'flash_attention_bwd_q_launch')}


def test_every_kernel_source_and_its_exports():
    """One source per kernel library; each exports its launch functions
    and ``kernel_error_string`` with C linkage, and none calls a library's
    kernels (cuBLAS, cuDNN, CUTLASS's device-level GEMMs)."""
    assert sorted(p.stem for p in _build.CSRC.glob('*.cu')) == sorted(SOURCES)
    for name, exports in SOURCES.items():
        src = (_build.CSRC / f'{name}.cu').read_text()
        c_api = src[src.index('extern "C" {'):]
        for fn in exports + ('kernel_error_string',):
            assert re.search(rf'\b{fn}\(', c_api), (name, fn)
        for banned in ('cublas', 'cudnn', 'cutlass/gemm'):
            assert banned not in src.lower(), (name, banned)


def test_k5_and_k6_share_one_kernel_body():
    """K5 (``pre`` + W_h h) and K6 (W [x; h] from zero) are the two
    instances of one template, so their dot order is one."""
    src = (_build.CSRC / 'lstm_gates_rec.cu').read_text()
    assert src.count('__global__') == 1
    assert 'launch<true>(' in src and 'launch<false>(' in src


def test_library_name_follows_source_and_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, 'CSRC', tmp_path)
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    src, hdr = tmp_path / 'k.cu', tmp_path / 'e.cuh'
    src.write_text('#include "e.cuh"\n')
    hdr.write_text('// v1\n')
    first = _build._target('k')
    assert first[0] == src and first[2].parent == tmp_path / 'build'
    assert _build._target('k') == first              # stable
    hdr.write_text('// v2\n')
    second = _build._target('k')
    assert second[1] != first[1] and second[2] != first[2]
    src.write_text('#include "e.cuh"\n// edited\n')
    assert _build._target('k')[1] not in (first[1], second[1])
    # build_all takes sources only, never a header on its own
    monkeypatch.setattr(_build, 'build', lambda names: None)
    assert list(_build.build_all()) == ['k']


def test_build_dir_is_in_the_checkout():
    root = pathlib.Path(__file__).resolve().parents[1]
    assert _build.BUILD_DIR == root / 'build' / 'kernels'


def test_debug_defines_build_a_library_of_their_own(tmp_path, monkeypatch):
    """A debug build (``DEFINES``, e.g. ``-DCLOCK_STAMPS``) hashes its flags
    into the library's name, so it never replaces the plain build."""
    monkeypatch.setattr(_build, 'CSRC', tmp_path)
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(_build, 'DEFINES', {})
    (tmp_path / 'k.cu').write_text('// kernel\n')
    plain = _build._target('k')
    _build.DEFINES['k'] = ('-DCLOCK_STAMPS',)
    stamped = _build._target('k')
    assert stamped[2] != plain[2] and stamped[0] == plain[0]
    del _build.DEFINES['k']
    assert _build._target('k') == plain


# sequence kernel -> the calls it makes into the shared headers: the step
# exchange (all four), then K1/K2's f32 operands and dot or K3/K4's int8
# tile MACs
EXCHANGE_CALLS = ('publish(', 'load_acquire(', 'finish(', 'bulk_load(',
                  'async_proxy_fence(')
SEQ_CALLS = {
    'lstm_seq': ('request_k_major(', 'family_sums(', 'gate_sum('),
    'lstm_stack_seq': ('request_k_major(', 'family_sums(', 'gate_sum('),
    'lstm_seq_q': ('lstm_q::stage_weights(', 'lstm_q::hop_tiles(',
                   'lstm_q::state_update('),
    'lstm_stack_seq_q': ('lstm_q::stage_weights(', 'lstm_q::hop_tiles(',
                         'lstm_q::state_update('),
}


@pytest.mark.parametrize('name', sorted(SEQ_CALLS))
def test_f32_sequence_kernels_share_one_exchange_header(name):
    """K1-K4 exchange their steps through ``lstm_exchange.cuh`` (counters
    published with release and awaited with acquire, planes staged by bulk
    copies) and spell out neither that protocol nor a grid barrier of their
    own; K1/K2 take their dot from it, K3/K4 their tile MACs from
    ``lstm_q_epilogue.cuh``."""
    header = (_build.CSRC / 'lstm_exchange.cuh').read_text()
    for op in ('red.release.gpu', 'ld.acquire.gpu', 'fence.proxy.async',
               'cp.async.bulk', 'atom.acq_rel.gpu'):
        assert op in header, op
    src = (_build.CSRC / f'{name}.cu').read_text()
    assert '#include "lstm_exchange.cuh"' in src
    for call in EXCHANGE_CALLS + SEQ_CALLS[name]:
        assert call in src, call
    for body in ('red.release', 'ld.acquire', 'atom.', 'fence.proxy',
                 'cp.async.bulk', 'mma.sync', 'ldmatrix',
                 'atomicAdd', 'this_grid', '.sync()', 'cooperative_groups'):
        assert body not in src, body


def test_int8_tile_macs_run_on_the_tensor_cores():
    """K3/K4's tile MACs are ``mma.sync`` s8 instructions with an exact
    int32 sum (no ``.satfinite``), written once in the int8 header; no
    ``__dp4a`` tile loop is left in either source."""
    header = (_build.CSRC / HEADER).read_text()
    assert 'mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32' in header
    assert 'col.satfinite' not in header and '__dp4a' not in header
    assert 'ldmatrix.sync.aligned.m8n8.x4.shared.b16' in header
    for name in INT8_SOURCES:
        src = (_build.CSRC / f'{name}.cu').read_text()
        assert '__dp4a' not in src and 'part_s' not in src, name


@pytest.mark.parametrize('name', ['flash_attention', 'quant_matmul',
                                  'lstm_gates_rec', 'lstm_seq',
                                  'lstm_stack_seq', 'lstm_seq_q',
                                  'lstm_stack_seq_q'])
def test_clock_stamps_only_in_debug_builds(name):
    """K1-K4, K5/K6, K7 and K8 time their phases with the shared
    ``clock_stamps.cuh``; its export exists only under ``CLOCK_STAMPS``."""
    src = (_build.CSRC / f'{name}.cu').read_text()
    assert '#include "clock_stamps.cuh"' in src
    # a phase that ends in a CTA barrier laps with `clk.sync_lap`
    assert re.search(r'clk\.(sync_)?lap\(0\)', src) and 'clk.lap(1)' in src
    export = src.index(f'int {name}_clock_stamps(')
    assert src.rfind('#ifdef CLOCK_STAMPS', 0, export) > src.rfind(
        '#endif', 0, export)
