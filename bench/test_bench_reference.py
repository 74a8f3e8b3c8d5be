"""The plain references against the program at a small size on the CPU:
the f32 stack allclose to ``chipmunk_net.forward`` and to the engine's
chunked K2 path, the int8 datapath's codes ``torch.equal`` to
``deploy_int8``'s, and each control away from its reference."""
import numpy as np
import pytest
import torch

from bench.entries.stream_server import arch_config, stack_params
from bench.reference import f32_stack, int8_datapath
from bench.weights import make_weights

SMALL = dict(arch='chipmunk-ctc', n_x=13, n_h=32, n_layers=2, n_out=16,
             program={'config': {'lstm_backend': 'torch_scan'}})
# two row tiles and two input tiles of 96: every hop of the chain
WIDE = dict(SMALL, n_x=123, n_h=100)
# float32 sums in another order (hoisted products, per-step products):
# a few ulps of values of order 1, grown over 24 steps
F32_ATOL = 2e-5


def _frames(cfg, lens, seed=3):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(L, cfg['n_x'], generator=g) for L in lens]


def _padded(frames):
    T = max(len(f) for f in frames)
    x = torch.zeros(len(frames), T, frames[0].shape[1])
    for j, f in enumerate(frames):
        x[j, :len(f)] = f
    return x


@pytest.mark.parametrize('backend', ['torch_scan', 'cuda_seq_fused'])
def test_f32_reference_matches_forward(backend):
    from repro_torch.models import chipmunk_net
    cfg = dict(SMALL, program={'config': {'lstm_backend': backend}})
    w = make_weights(cfg, 11, 'cpu')
    frames = _frames(cfg, [24, 9, 17])
    lp = chipmunk_net.forward(arch_config(cfg), stack_params(w),
                              _padded(frames))
    ref = f32_stack.log_probs(w, frames)
    for j, r in enumerate(ref):
        assert torch.allclose(lp[:len(r), j], r, atol=F32_ATOL, rtol=0)


def test_f32_reference_matches_engine_chunks():
    from repro_torch.serving import StreamingEngine
    cfg = dict(SMALL, program={'config': {'lstm_backend': 'cuda_seq_fused'}})
    w = make_weights(cfg, 12, 'cpu')
    frames = _frames(cfg, [21, 5, 30, 12])
    eng = StreamingEngine(arch_config(cfg), stack_params(w), max_streams=2,
                          chunk=4, async_dispatch=True)
    sessions = [eng.submit(f.numpy()) for f in frames]
    eng.run()
    for s, r in zip(sessions, f32_stack.log_probs(w, frames)):
        assert np.allclose(s.full_log_probs(), r.numpy(), atol=F32_ATOL,
                           rtol=0)


def test_tf32_control_rounds_and_departs():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -11), 3.0 + 2 ** -12])
    assert f32_stack.to_tf32(x).tolist() == [
        1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10), 3.0]
    from repro_torch.models import chipmunk_net
    cfg = dict(WIDE, program={'config': {'lstm_backend': 'cuda_seq_fused'}})
    w = make_weights(cfg, 13, 'cpu')
    frames = _frames(cfg, [40, 25])
    lp = chipmunk_net.forward(arch_config(cfg), stack_params(w),
                              _padded(frames))
    full = f32_stack.log_probs(w, frames)
    low = f32_stack.log_probs(w, frames, precision='tf32')
    program = max(float((lp[:len(r), j] - r).abs().max())
                  for j, r in enumerate(full))
    control = max(float((a - b).abs().max()) for a, b in zip(full, low))
    # the control reads far above the program: a limit fits between
    assert control > 20 * max(program, 1e-7)


@pytest.mark.parametrize('cfg', [SMALL, WIDE], ids=['small', 'wide'])
def test_int8_reference_equals_deploy(cfg):
    from repro_torch.examples.speech_ctc import deploy_int8, quantize_layers
    w = make_weights(cfg, 14, 'cpu')
    frames = _frames(cfg, [12, 7, 10])
    params = stack_params(w)
    codes, lp, _ = deploy_int8(params, _padded(frames),
                               quantize_layers(params), backend='fused')
    ref_codes, ref_lp = int8_datapath.run(w, frames)
    for j, (c, l) in enumerate(zip(ref_codes, ref_lp)):
        assert torch.equal(codes[:len(c), j], c)
        assert torch.allclose(lp[:len(c), j], l, atol=1e-6, rtol=0)
    c4, _ = int8_datapath.run(w, frames, weight_bits=4)
    assert sum(int((a != b).sum()) for a, b in zip(c4, ref_codes)) > 0


def test_int4_codes_are_coarse():
    q = int8_datapath._weight_codes(torch.tensor([0.3, -0.26, 0.74, 9.0]), 4)
    assert q.tolist() == [16, -16, 16, 112]


@pytest.mark.parametrize('name', ['f32_stack', 'int8_datapath'])
def test_readings_hold_the_reference_to_itself(name):
    # the reference's own outputs read nought, a shifted log-prob or code
    # reads its shift, and the control (got None) reads above nought
    from bench import compare
    ref = compare.reference({'reference': name})
    w = ref.make_weights(SMALL, 15, 'cpu')
    frames = _frames(SMALL, [9, 14])
    if name == 'f32_stack':
        got = [dict(lp=l.clone()) for l in f32_stack.log_probs(w, frames)]
    else:
        codes, lps = int8_datapath.run(w, frames)
        got = [dict(codes=c.clone(), lp=l.clone())
               for c, l in zip(codes, lps)]
    assert all(v == 0 for v in ref.readings(w, frames, got).values())
    got[1]['lp'][3, 2] += 0.25
    if 'codes' in got[0]:
        got[0]['codes'][2, 1] += 1
    read = ref.readings(w, frames, got)
    assert read['logprob_gap'] == pytest.approx(0.25, rel=1e-6)
    assert read.get('code_mismatches', 1) == 1
    assert all(v > 0 for v in ref.readings(w, frames, None).values())


def test_rows_missing_counts_short_outputs():
    from bench import compare
    w = make_weights(SMALL, 16, 'cpu')
    frames = _frames(SMALL, [6, 8])
    lp = f32_stack.log_probs(w, frames)
    sample = [dict(length=len(f), frames=f.numpy(), lp=l.numpy())
              for f, l in zip(frames, lp)]
    sample[1]['lp'] = sample[1]['lp'][:5]
    got = compare.readings(dict(SMALL, reference='f32_stack'), w, sample,
                           'cpu')
    assert got == {'logprob_gap': 0.0, 'rows_missing': 1}
