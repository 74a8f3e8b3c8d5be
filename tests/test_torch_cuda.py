"""The port's CUDA kernels on the card: each held against its plain PyTorch
version, the chunking contract bit for bit, and the engine's backends
against each other.  Marked ``needs_cuda``: without a CUDA device each test
skips (decided inside the fixture).  Run on a GPU machine with

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

Tolerance kernel vs plain version: atol=1e-4 on h and c (f32; the kernel
sums the 4*N_h-term dots in another order than cuBLAS, with fused
multiply-adds, over up to 16 recurrent steps).  TF32 is switched off for
every library product.  The int8 kernels (K3, K4) are bit-exact by contract:
``torch.equal`` on the h and c codes, no tolerance.  K5 (one recurrent
step) is held at the same atol 1e-4, and the training gradients of every
kernel backend against the ``torch_scan`` Function's at a relative
Frobenius error of at most 1e-4 per leaf.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import lstm as tlstm
from repro_torch.core import quant as tquant
from repro_torch.core import systolic as tsys
from repro_torch.kernels.lstm_seq import (lstm_seq, lstm_seq_quantized,
                                          lstm_seq_quantized_ref,
                                          lstm_seq_ref,
                                          lstm_stack_seq_kernel,
                                          lstm_stack_seq_kernel_q,
                                          lstm_stack_seq_quantized_auto,
                                          lstm_stack_seq_quantized_ref,
                                          lstm_stack_seq_ref,
                                          stack_kernel_weights,
                                          stack_kernel_weights_q)
from repro_torch.kernels.lstm_gates import lstm_gates_rec, lstm_gates_rec_ref
from repro_torch.kernels.lstm_seq.ops import _dense_from_tiles
from repro_torch.launch.train import _grads_of
from repro_torch.models import chipmunk_net
from repro_torch.tree import leaves
from repro_torch.serving import StreamingEngine

ATOL = 1e-4
pytestmark = pytest.mark.needs_cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda', 0)


def _params(cfg, dev):
    return chipmunk_net.init(cfg, torch.Generator().manual_seed(0), dev)


def _inputs(cfg, T, B, dev, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s: torch.from_numpy((rng.randn(*s) * 0.5).astype(
        np.float32)).to(dev)
    lens = torch.from_numpy(np.r_[T, 0, rng.randint(1, T, B - 2)]).to(dev)
    return f, f(T, B, cfg.lstm_inputs), tlstm.valid_len_mask(T, lens, B)


@pytest.mark.parametrize('arch', ['smoke', 'full'])
def test_kernels_match_plain_versions(dev, arch):
    cfg = (configs.get_smoke_config if arch == 'smoke'
           else configs.get_config)('chipmunk-ctc')
    params = _params(cfg, dev)
    T, B, N, L = 16, 5, cfg.lstm_hidden, cfg.n_layers
    f, xs, mask = _inputs(cfg, T, B, dev)
    pre = tlstm.hoisted_input(params.layers[0].w_x, xs)
    lp = params.layers[0]
    args = (pre, lp.w_h, lp.w_peep, lp.b, f(B, N), f(B, N), mask)
    n0 = lstm_seq.launches
    got, want = lstm_seq(*args), lstm_seq_ref(*args)
    assert lstm_seq.launches == n0 + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)
    wts = stack_kernel_weights(params)
    args = (pre, wts.w_in, wts.w_h, wts.peep, wts.b, f(L, B, N), f(L, B, N),
            mask)
    n0 = lstm_stack_seq_kernel.launches
    got, want = lstm_stack_seq_kernel(*args), lstm_stack_seq_ref(*args)
    assert lstm_stack_seq_kernel.launches == n0 + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)


@pytest.mark.parametrize('backend', ['cuda_seq', 'cuda_seq_fused'])
def test_chunked_equals_monolithic_on_card(dev, backend):
    cfg = configs.get_config('chipmunk-ctc')
    params = _params(cfg, dev)
    _, xs, _ = _inputs(cfg, 24, 4, dev, seed=1)
    lens = np.array([24, 0, 17, 9])
    mono, fin = tlstm.lstm_stack_chunk(
        params, xs, None, valid_len=torch.from_numpy(lens).to(dev),
        backend=backend)
    states, outs = None, []
    for lo in range(0, 24, 8):
        vl = torch.from_numpy(np.clip(lens - lo, 0, 8)).to(dev)
        o, states = tlstm.lstm_stack_chunk(params, xs[lo:lo + 8], states,
                                           valid_len=vl, backend=backend)
        outs.append(o)
    assert torch.equal(torch.cat(outs), mono)
    for (h, c), (hm, cm) in zip(states, fin):
        assert torch.equal(h, hm) and torch.equal(c, cm)


def test_engine_backends_agree_on_card(dev):
    cfg = configs.get_smoke_config('chipmunk-ctc')
    params = _params(cfg, dev)
    rng = np.random.RandomState(2)
    utts = [(rng.randn(L, cfg.lstm_inputs) * 0.5).astype(np.float32)
            for L in (13, 7, 19, 4, 11)]
    outs = {}
    for backend in ('torch_scan', 'cuda_seq', 'cuda_seq_fused'):
        eng = StreamingEngine(cfg.replace(lstm_backend=backend), params,
                              max_streams=3, chunk=4)
        sess = [eng.submit(u) for u in utts]
        eng.run()
        outs[backend] = [s.full_log_probs() for s in sess]
    for backend in ('cuda_seq', 'cuda_seq_fused'):
        for a, b in zip(outs[backend], outs['torch_scan']):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=ATOL)


def test_auto_picks_fused_on_card_and_explicit_inadmissible_raises(dev):
    cfg = configs.get_config('chipmunk-ctc')
    params = _params(cfg, dev)
    assert tlstm.resolve_serving_backend(params, 'auto', 16, 8, dev) == \
        'cuda_seq_fused'
    assert tlstm.resolve_serving_backend(params, 'auto', 16, 64, dev) == \
        'cuda_seq'
    with pytest.raises(ValueError):
        tlstm.resolve_serving_backend(params, 'cuda_seq_fused', 16, 64, dev)


# ------------------------------------------------------------ int8 (K3, K4)
def _quantized_stack(cfg, params):
    """Every layer of ``params`` quantized on its plan at tile 96."""
    return [tsys.quantize_packed(tsys.pack_lstm(lp, tsys.SystolicPlan(
        lp.n_x, lp.n_h, tsys.N_LSTM_SILICON))) for lp in params.layers]


@pytest.mark.parametrize('arch', ['smoke', 'full'])
def test_int8_kernels_equal_plain_versions(dev, arch):
    cfg = (configs.get_smoke_config if arch == 'smoke'
           else configs.get_config)('chipmunk-ctc')
    qps = _quantized_stack(cfg, _params(cfg, dev))
    T, B, L = 16, 5, len(qps)
    p0 = qps[0].plan
    f, xs, mask = _inputs(cfg, T, B, dev)
    xq = tquant.quantize(xs)
    rng = np.random.RandomState(3)
    code = lambda *s: torch.from_numpy(
        rng.randint(-64, 64, s).astype(np.int8)).to(dev)
    xs_pad = torch.zeros((T, B, p0.padded_x), dtype=torch.int8, device=dev)
    xs_pad[..., :p0.n_x] = xq
    w, peep, bias = _dense_from_tiles(qps[0])
    args = (xs_pad, w, peep, bias, qps[0].sig_lut, qps[0].tanh_lut,
            code(B, p0.padded_h), code(B, p0.padded_h), mask)
    n0 = lstm_seq_quantized.launches
    got = lstm_seq_quantized(*args, tile=p0.tile, cols_x=p0.cols_x)
    want = lstm_seq_quantized_ref(*args, tile=p0.tile, cols_x=p0.cols_x)
    assert lstm_seq_quantized.launches == n0 + 1
    for g, wnt in zip(got, want):
        assert g.dtype == torch.int8 and torch.equal(g, wnt)

    wts = stack_kernel_weights_q(qps)
    args = (tsys.quantized_x_prefix(qps[0], xq).contiguous(), wts.w_in,
            wts.w_h, wts.peep, wts.bias, wts.sig_lut, wts.tanh_lut,
            code(L, B, p0.padded_h), code(L, B, p0.padded_h), mask)
    n0 = lstm_stack_seq_kernel_q.launches
    got = lstm_stack_seq_kernel_q(*args, tile=p0.tile)
    want = lstm_stack_seq_quantized_ref(*args, tile=p0.tile)
    assert lstm_stack_seq_kernel_q.launches == n0 + 1
    for g, wnt in zip(got, want):
        assert g.dtype == torch.int8 and torch.equal(g, wnt)


@pytest.mark.parametrize('backend', ['fused', 'layerwise'])
def test_int8_chunked_equals_monolithic_on_card(dev, backend):
    cfg = configs.get_config('chipmunk-ctc')
    qps = _quantized_stack(cfg, _params(cfg, dev))
    T, B, chunk = 24, 4, 8
    _, xs, _ = _inputs(cfg, T, B, dev, seed=4)
    xq = tquant.quantize(xs)
    lens = np.array([T, 0, 11, 17])
    mono, fin = lstm_stack_seq_quantized_auto(
        qps, xq, valid_len=torch.from_numpy(lens).to(dev), return_state=True,
        backend=backend)
    state, outs = None, []
    for lo in range(0, T, chunk):
        vl = torch.from_numpy(np.clip(lens - lo, 0, chunk)).to(dev)
        o, state = lstm_stack_seq_quantized_auto(
            qps, xq[lo:lo + chunk], state=state, valid_len=vl,
            return_state=True, backend=backend)
        outs.append(o)
    assert torch.equal(torch.cat(outs), mono)
    assert torch.equal(state[0], fin[0]) and torch.equal(state[1], fin[1])
    chain = xq
    for qp in qps:
        chain = tsys.systolic_layer_quantized(qp, chain)
    for b, n in enumerate(lens):
        assert torch.equal(mono[:n, b], chain[:n, b])


def test_int8_auto_picks_fused_at_full_width(dev):
    assert tlstm.select_quantized_stack_backend(421, 3, 16, 8,
                                                device=dev) == 'fused'
    assert tlstm.select_quantized_stack_backend(421, 3, 4, 8,
                                                device=dev) == 'layerwise'


# ------------------------------------------------------- training path (K5)
@pytest.mark.parametrize('B', [5, 8, 11])
def test_gates_rec_kernel_matches_plain_version(dev, B):
    """K5 at full width; B = 11 takes two passes over the streams."""
    cfg = configs.get_config('chipmunk-ctc')
    lp = _params(cfg, dev).layers[1]
    N = lp.n_h
    rng = np.random.RandomState(B)
    f = lambda *s: torch.from_numpy((rng.randn(*s) * 0.5).astype(
        np.float32)).to(dev)
    args = (f(B, N), lp.w_h, f(B, 4, N), lp.w_peep, lp.b, f(B, N))
    n0 = lstm_gates_rec.launches
    got = lstm_gates_rec(*args)
    torch.cuda.synchronize()
    assert lstm_gates_rec.launches == n0 + 1
    for g, w in zip(got, lstm_gates_rec_ref(*args)):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)


def test_cuda_step_layer_launches_once_per_step(dev):
    cfg = configs.get_config('chipmunk-ctc')
    params = _params(cfg, dev)
    f, xs, _ = _inputs(cfg, 12, 4, dev)
    n0 = lstm_gates_rec.launches
    ys, fin = tlstm.lstm_stack_apply(params, xs, backend='cuda_step')
    assert lstm_gates_rec.launches == n0 + 12 * cfg.n_layers
    ref, ref_fin = tlstm.lstm_stack_apply(params, xs, backend='cuda_seq')
    torch.testing.assert_close(ys, ref, rtol=0, atol=ATOL)
    for (h, c), (rh, rc) in zip(fin, ref_fin):
        torch.testing.assert_close(h, rh, rtol=0, atol=ATOL)
        torch.testing.assert_close(c, rc, rtol=0, atol=ATOL)


def test_cuda_step_is_refused_for_serving_on_card(dev):
    """K5 has no masked form: the engine refuses ``cuda_step`` on the card,
    and a masked chunk on it raises rather than run the plain scan."""
    cfg = configs.get_smoke_config('chipmunk-ctc')
    params = _params(cfg, dev)
    with pytest.raises(ValueError, match='no masked form'):
        StreamingEngine(cfg.replace(lstm_backend='cuda_step'), params,
                        max_streams=3, chunk=4)
    lp = params.layers[0]
    xs = torch.zeros(4, 3, lp.n_x, device=dev)
    n0 = lstm_gates_rec.launches
    with pytest.raises(ValueError, match='no masked form'):
        tlstm.lstm_layer_chunk(lp, xs, valid_len=torch.tensor(
            [4, 2, 0], device=dev), backend='cuda_step')
    assert lstm_gates_rec.launches == n0


@pytest.mark.parametrize('backend', ['cuda_step', 'cuda_seq',
                                     'cuda_seq_fused'])
def test_loss_grads_match_torch_scan_on_card(dev, backend):
    cfg = configs.get_config('chipmunk-ctc')
    params = _params(cfg, dev)
    rng = np.random.RandomState(5)
    T, B = 8, 4
    batch = {'frames': torch.from_numpy(rng.randn(B, T, cfg.lstm_inputs)
                                        .astype(np.float32)).to(dev),
             'labels': torch.from_numpy(rng.randint(1, cfg.n_outputs, (B, 2))
                                        .astype(np.int32)).to(dev),
             'frame_len': torch.tensor([8, 6, 8, 5], dtype=torch.int32,
                                       device=dev),
             'label_len': torch.tensor([2, 1, 2, 2], dtype=torch.int32,
                                       device=dev)}
    grads = {}
    for b in ('torch_scan', backend):
        loss_fn = functools.partial(chipmunk_net.loss_fn,
                                    cfg.replace(lstm_backend=b))
        grads[b] = leaves(_grads_of(loss_fn, params, batch)[1])
    for g, r in zip(grads[backend], grads['torch_scan']):
        assert bool(torch.isfinite(g).all())
        rel = torch.linalg.vector_norm(g - r) / torch.linalg.vector_norm(r)
        assert float(rel) <= 1e-4
