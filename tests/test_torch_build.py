"""The port's kernel build on the CPU (no ``nvcc`` needed): which sources
share the int8 and the f32 epilogue headers, and that a library's name
follows every header, so a change to a shared epilogue rebuilds every
kernel that includes it."""
import pathlib

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
