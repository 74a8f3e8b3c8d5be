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
Frobenius error of at most 1e-4 per leaf.  K6 (the fused cell) at atol
1e-4; K7 (int8 matmul) ``torch.equal`` to its plain version in f32 and
bf16 (an exact int32 sum and the same epilogue order); K8 (attention) at
atol 1e-4 in f32, and in bf16 at one rounding of the output (rtol 2**-7)
with atol 1e-5: both compute in f32 and round the output to bf16.  K8's
log-sum-exp at atol 1e-5 (f32 logs of sums in another order), its output
``torch.equal`` to the launch without one; K8's backward (dq, dk, dv) at a
max-abs error of 1e-4 of the gradient's scale (max |want|) in f32 and
2**-7 in bf16 (one rounding of the output), each launch bit-equal to the
next on the same inputs.
"""
import functools
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import lstm as tlstm
from repro_torch.core import quant as tquant
from repro_torch.core import systolic as tsys
from repro_torch.kernels.lstm_seq import (lstm_seq, lstm_seq_quantized,
                                          lstm_seq_quantized_ref,
                                          lstm_seq_ref, seq_geometry,
                                          seq_q_geometry, stack_geometry,
                                          stack_q_geometry,
                                          lstm_stack_seq_kernel,
                                          lstm_stack_seq_kernel_q,
                                          lstm_stack_seq_quantized_auto,
                                          lstm_stack_seq_quantized_ref,
                                          lstm_stack_seq_ref,
                                          stack_kernel_weights,
                                          stack_kernel_weights_q)
from repro_torch.kernels.flash_attention import (attention_bwd_geometry,
                                                 attention_bwd_ref,
                                                 attention_delta,
                                                 attention_geometry,
                                                 attention_ref,
                                                 attention_train,
                                                 flash_attention,
                                                 flash_attention_bwd_kv,
                                                 flash_attention_bwd_q, mha)
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.lstm_gates import (gates_geometry, lstm_cell_fused,
                                            lstm_gates,
                                            lstm_gates_rec,
                                            lstm_gates_rec_ref,
                                            lstm_gates_ref)
from repro_torch.kernels.quant_matmul import (quant_matmul, quant_matmul_ref,
                                              quantize_weights,
                                              quantized_linear)
from repro_torch.kernels.lstm_seq.ops import _dense_from_tiles
from repro_torch.launch.train import _grads_of
from repro_torch.models import chipmunk_net
from repro_torch.tree import leaves, tree_map
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


@pytest.mark.parametrize('B', [5, 30])
def test_stack_layer_blocks_bit_equal_on_card(dev, B):
    """K2 in groups of lb layers: every lb the bits of lb = L (at B = 30
    in batch blocks of 24 and of 48), within atol of the plain version,
    (L / lb) launches a batch block; a 6-layer stack refused whole runs in
    groups."""
    cfg = configs.get_config('chipmunk-ctc')
    params = _params(cfg, dev)
    T, N, L = 16, cfg.lstm_hidden, cfg.n_layers
    f, xs, mask = _inputs(cfg, T, B, dev)
    pre = tlstm.hoisted_input(params.layers[0].w_x, xs)
    wts = stack_kernel_weights(params)
    args = (pre, wts.w_in, wts.w_h, wts.peep, wts.b, f(L, B, N), f(L, B, N),
            mask)
    want = lstm_stack_seq_ref(*args)
    got = {}
    for lb, launches in ((3, 1 if B <= 24 else 2), (1, 3)):
        n0 = lstm_stack_seq_kernel.launches
        got[lb] = lstm_stack_seq_kernel(*args, lb=lb)
        assert lstm_stack_seq_kernel.launches == n0 + launches
        for g, w in zip(got[lb], want):
            torch.testing.assert_close(g, w, rtol=0, atol=ATOL)
    assert all(torch.equal(a, b) for a, b in zip(got[1], got[3]))
    deep = tlstm.stack_params_to(tlstm.init_lstm_stack(
        cfg.lstm_inputs, N, 6, None, torch.Generator().manual_seed(1)), dev)
    dw = stack_kernel_weights(deep)
    args = (tlstm.hoisted_input(deep.layers[0].w_x, xs), dw.w_in, dw.w_h,
            dw.peep, dw.b, f(6, B, N), f(6, B, N), mask)
    with pytest.raises(RuntimeError, match='lstm_stack_seq_kernel: '):
        lstm_stack_seq_kernel(*args)
    outs = [lstm_stack_seq_kernel(*args, lb=lb) for lb in (1, 2, 3)]
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))
    for g, w in zip(outs[0], lstm_stack_seq_ref(*args)):
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
    """``auto`` picks K2 where one launch takes the batch, else K1; an
    explicit K2 past its single launch runs in batch blocks; only a
    geometry that fails for one stream (here a hidden width whose row
    slice overflows shared memory) raises."""
    cfg = configs.get_config('chipmunk-ctc')
    params = _params(cfg, dev)
    assert tlstm.resolve_serving_backend(params, 'auto', 16, 8, dev) == \
        'cuda_seq_fused'
    assert tlstm.resolve_serving_backend(params, 'auto', 16, 64, dev) == \
        'cuda_seq'
    assert tlstm.resolve_serving_backend(params, 'cuda_seq_fused', 16, 64,
                                         dev) == 'cuda_seq_fused'
    meta = lambda *s: torch.empty(s, device='meta')
    n = 4096
    wide = tlstm.LSTMStackParams(tuple(
        tlstm.LSTMParams(meta(4, n, n), meta(4, n, n), meta(3, n),
                         meta(4, n)) for _ in range(2)), None, None)
    with pytest.raises(ValueError):
        tlstm.resolve_serving_backend(wide, 'cuda_seq_fused', 16, 1, dev)


# ------------------------------------- K1 and K2 at full width: new hazards
SEQ_KERNELS = ('k1', 'k2')


def _seq_args(kernel, T, B, dev, seed=0, n_h=421, n_layers=3):
    """(fn, ref, args) of K1 (``kernel`` 'k1') or K2 ('k2', ``n_layers``
    layers) at full width on weights and inputs from numpy at ``seed``: a
    ragged mask (a full and an empty stream where B allows), nonzero
    h0/c0."""
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=0.5: torch.from_numpy(
        (rng.randn(*s) * scale).astype(np.float32)).to(dev)
    lens = rng.randint(1, T + 1, size=B)
    lens[0] = T
    if B > 1:
        lens[1] = 0
    mask = torch.from_numpy(np.arange(T)[:, None] < lens[None, :]).to(dev)
    pre_x, w = f(T, B, 4, n_h), 1 / np.sqrt(n_h)
    if kernel == 'k1':
        return lstm_seq, lstm_seq_ref, [
            pre_x, f(4, n_h, n_h, scale=w), f(3, n_h, scale=0.1),
            f(4, n_h, scale=0.1), f(B, n_h), f(B, n_h), mask]
    L = n_layers
    return lstm_stack_seq_kernel, lstm_stack_seq_ref, [
        pre_x, f(L - 1, 4, n_h, n_h, scale=w), f(L, 4, n_h, n_h, scale=w),
        f(L, 3, n_h, scale=0.1), f(L, 4, n_h, scale=0.1), f(L, B, n_h),
        f(L, B, n_h), mask]


def _max_batch(kernel, dev, n_h=421, n_layers=3):
    """The largest B the kernel's geometry admits on this card."""
    sms = _sms(dev)
    geom = ((lambda B: seq_geometry(n_h, B, sms)) if kernel == 'k1' else
            (lambda B: stack_geometry(n_h, n_layers, B, sms)))
    return max(B for B in range(1, 512) if geom(B).admissible(sms))


def _assert_matches_plain(fn, ref, args):
    n0 = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    for g, w in zip(got, ref(*args)):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)
    return got


@pytest.mark.parametrize('T', [1, 64])
@pytest.mark.parametrize('kernel', SEQ_KERNELS)
def test_seq_kernels_at_one_and_many_steps(dev, kernel, T):
    """One step (no exchange at all) and the training sequence's 64 (the
    counters pass 64 * CTAs) against the plain versions, atol 1e-4."""
    _assert_matches_plain(*_seq_args(kernel, T, 8, dev, seed=T))


@pytest.mark.parametrize('B', [1, 'max'])
@pytest.mark.parametrize('kernel', SEQ_KERNELS)
def test_seq_kernels_at_one_stream_and_the_largest_batch(dev, kernel, B):
    """B = 1 (a chunk of one stream, 7 empty slots in each k-major plane)
    and the largest B the geometry admits (several chunks), atol 1e-4."""
    B = _max_batch(kernel, dev) if B == 'max' else B
    _assert_matches_plain(*_seq_args(kernel, 16, B, dev, seed=B))


@pytest.mark.parametrize('kernel', SEQ_KERNELS)
def test_seq_kernels_take_state_views_at_offset_one(dev, kernel):
    """h0 and c0 as contiguous views at a storage offset of one float (not
    16-byte aligned): the same bits as aligned copies."""
    fn, ref, args = _seq_args(kernel, 16, 8, dev, seed=4)
    views = list(args)
    for i in (-3, -2):
        buf = torch.empty(args[i].numel() + 1, device=dev)
        v = buf[1:].view(args[i].shape)
        v.copy_(args[i])
        assert v.data_ptr() % 16 == 4
        views[i] = v
    for a, b in zip(fn(*args), fn(*views)):
        assert torch.equal(a, b)


@pytest.mark.parametrize('kernel', SEQ_KERNELS)
def test_seq_kernels_back_to_back_equal_synchronized_launches(dev, kernel):
    """32 launches on one stream without a host sync, each on other inputs,
    reusing the stream's step counters and the allocator's scratch: the
    bits of the same 32 launches with a synchronize around each."""
    fn, ref, args = _seq_args(kernel, 16, 8, dev, seed=5)
    inputs = [[args[0] * (1 + 0.01 * i)] + args[1:] for i in range(32)]
    torch.cuda.synchronize()
    n0 = fn.launches
    queued = [fn(*a) for a in inputs]
    torch.cuda.synchronize()
    assert fn.launches == n0 + 32
    for a, (hs, cs) in zip(inputs, queued):
        torch.cuda.synchronize()
        h1, c1 = fn(*a)
        torch.cuda.synchronize()
        assert torch.equal(hs, h1) and torch.equal(cs, c1)


@pytest.mark.parametrize('kernel', SEQ_KERNELS)
def test_seq_kernels_on_two_streams(dev, kernel):
    """Launches on two streams at once (each stream its own counters): each
    gives the bits of the same launch alone on the default stream."""
    fn, ref, args = _seq_args(kernel, 16, 8, dev, seed=6)
    other = [args[0] * 0.5] + args[1:]
    alone = [fn(*args), fn(*other)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    both = []
    for s, a in zip(streams, (args, other)):
        with torch.cuda.stream(s):
            both.append(fn(*a))
    torch.cuda.synchronize()
    for (h, c), (h1, c1) in zip(alone, both):
        assert torch.equal(h, h1) and torch.equal(c, c1)


@pytest.mark.parametrize('kernel', SEQ_KERNELS)
def test_seq_kernels_same_inputs_same_bits(dev, kernel):
    """No atomics in any sum: the same inputs twice give the same bits."""
    fn, _, args = _seq_args(kernel, 16, 8, dev, seed=7)
    for a, b in zip(fn(*args), fn(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize('kernel', SEQ_KERNELS)
def test_seq_kernels_see_a_weight_written_just_before(dev, kernel):
    """An in-place update of W_h (as the optimizer's ``add_``) on the stream
    just before a launch is seen by it."""
    fn, ref, args = _seq_args(kernel, 16, 8, dev, seed=8)
    w_h = args[1] if kernel == 'k1' else args[2]
    stale = fn(*args)
    w_h.add_(torch.from_numpy((np.random.RandomState(9).randn(*w_h.shape)
                               * 0.05).astype(np.float32)).to(dev))
    got = _assert_matches_plain(fn, ref, args)
    assert float((stale[0] - got[0]).abs().max()) > 100 * ATOL


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


# ----------------------------------- K3 and K4 at full width: new hazards
Q_KERNELS = ('k3', 'k4')


def _q_stack(n_x, n_h, tile, n_layers, dev, seed):
    """``n_layers`` quantized layers on ``SystolicPlan(., n_h, tile)`` from
    numpy weights drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    qps = []
    for l in range(n_layers):
        nx = n_x if l == 0 else n_h
        u = lambda *s: torch.from_numpy(
            rng.uniform(-1, 1, s).astype(np.float32)).to(dev)
        lp = tlstm.LSTMParams(w_x=u(4, n_h, nx), w_h=u(4, n_h, n_h),
                              w_peep=u(3, n_h) * 0.5, b=u(4, n_h) * 0.5)
        qps.append(tsys.quantize_packed(tsys.pack_lstm(
            lp, tsys.SystolicPlan(nx, n_h, tile))))
    return qps


def _q_args(kernel, T, B, dev, seed=0, n_x=123, n_h=421, tile=96,
            n_layers=3):
    """(fn, ref, args, kw) of K3 (``kernel`` 'k3', layer 0 of the stack)
    or K4 ('k4', ``n_layers`` layers) on weights quantized from numpy at
    ``seed``: random frame codes, a ragged mask (a full and an empty stream
    where B allows), carried codes over the whole int8 range."""
    qps = _q_stack(n_x, n_h, tile, n_layers, dev, seed)
    rng = np.random.RandomState(seed + 1)
    lens = rng.randint(1, T + 1, size=B)
    lens[0] = T
    if B > 1:
        lens[1] = 0
    mask = torch.from_numpy(np.arange(T)[:, None] < lens[None, :]).to(dev)
    code = lambda *s: torch.from_numpy(
        rng.randint(-128, 128, s).astype(np.int8)).to(dev)
    p0 = qps[0].plan
    xq = code(T, B, p0.n_x)
    if kernel == 'k3':
        xs_pad = torch.zeros((T, B, p0.padded_x), dtype=torch.int8,
                             device=dev)
        xs_pad[..., :p0.n_x] = xq
        return lstm_seq_quantized, lstm_seq_quantized_ref, [
            xs_pad, *_dense_from_tiles(qps[0]), qps[0].sig_lut,
            qps[0].tanh_lut, code(B, p0.padded_h), code(B, p0.padded_h),
            mask], dict(tile=tile, cols_x=p0.cols_x)
    wts = stack_kernel_weights_q(qps)
    L = n_layers
    return lstm_stack_seq_kernel_q, lstm_stack_seq_quantized_ref, [
        tsys.quantized_x_prefix(qps[0], xq).contiguous(), wts.w_in, wts.w_h,
        wts.peep, wts.bias, wts.sig_lut, wts.tanh_lut,
        code(L, B, p0.padded_h), code(L, B, p0.padded_h), mask], dict(
            tile=tile)


def _q_max_batch(kernel, dev, n_x=123, n_h=421, tile=96, n_layers=3):
    """The largest B the int8 kernel's geometry admits on this card."""
    sms = _sms(dev)
    plan = tsys.SystolicPlan(n_x, n_h, tile)
    geom = ((lambda B: seq_q_geometry(plan.padded_x, plan.padded_h, tile, B,
                                      sms)) if kernel == 'k3' else
            (lambda B: stack_q_geometry(plan.padded_h, tile, n_layers, B,
                                        sms)))
    return max(B for B in range(1, 1024) if geom(B).admissible(sms))


def _q_assert_equals_plain(fn, ref, args, kw):
    n0 = fn.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    for g, w in zip(got, ref(*args, **kw)):
        assert g.dtype == torch.int8 and torch.equal(g, w)
    return got


@pytest.mark.parametrize('T', [1, 16, 64])
@pytest.mark.parametrize('kernel', Q_KERNELS)
def test_int8_kernels_at_one_and_many_steps(dev, kernel, T):
    """One step (no exchange at all), the serving chunk and 64 steps (the
    counters pass 64 * CTAs): ``torch.equal`` on the h and c codes."""
    _q_assert_equals_plain(*_q_args(kernel, T, 8, dev, seed=T))


@pytest.mark.parametrize('B', [1, 5, 8, 11, 'max'])
@pytest.mark.parametrize('kernel', Q_KERNELS)
def test_int8_kernels_at_each_batch(dev, kernel, B):
    """B = 1 and 5 (one n8 chunk, zero streams padded), 8, 11 (two
    chunks) and the largest B the geometry admits (several chunks a dot
    warp)."""
    B = _q_max_batch(kernel, dev) if B == 'max' else B
    _q_assert_equals_plain(*_q_args(kernel, 16, B, dev, seed=B))


@pytest.mark.parametrize('tile', [16, 20, 36, 96])
@pytest.mark.parametrize('kernel', Q_KERNELS)
def test_int8_kernels_at_each_tile(dev, kernel, tile):
    """Tile 16 (the CPU tests' tile), 20 (x rows of 140 bytes: staged by
    4-byte copies, not bulk copies), 36 (not a multiple of 32: each column
    tile's k padded to 64 with zeros) and 96 (the silicon's)."""
    _q_assert_equals_plain(*_q_args(kernel, 16, 8, dev, seed=tile,
                                    tile=tile))


@pytest.mark.parametrize('kernel', Q_KERNELS)
def test_int8_kernels_at_the_smoke_width(dev, kernel):
    """The smoke config's widths (n_x 13, n_h 32 on one row tile of 96, so
    64 padded rows), two layers."""
    _q_assert_equals_plain(*_q_args(kernel, 16, 8, dev, seed=32, n_x=13,
                                    n_h=32, n_layers=2))


@pytest.mark.parametrize('kernel', Q_KERNELS)
def test_int8_kernels_take_state_views_at_offset_one(dev, kernel):
    """h0 and c0 as contiguous views at a storage offset of one byte: the
    same bits as aligned copies."""
    fn, ref, args, kw = _q_args(kernel, 16, 8, dev, seed=4)
    views = list(args)
    for i in (-3, -2):
        buf = torch.empty(args[i].numel() + 1, dtype=torch.int8, device=dev)
        v = buf[1:].view(args[i].shape)
        v.copy_(args[i])
        assert v.data_ptr() % 16 == 1
        views[i] = v
    for a, b in zip(fn(*args, **kw), fn(*views, **kw)):
        assert torch.equal(a, b)
    _q_assert_equals_plain(fn, ref, views, kw)


@pytest.mark.parametrize('kernel', Q_KERNELS)
def test_int8_kernels_back_to_back_equal_synchronized_launches(dev, kernel):
    """32 launches on one stream without a host sync, each on other carried
    codes, reusing the stream's step counters and the allocator's scratch:
    the bits of the same 32 launches with a synchronize around each."""
    fn, ref, args, kw = _q_args(kernel, 16, 8, dev, seed=5)
    inputs = [args[:-3] + [torch.roll(args[-3], i, -1)] + args[-2:]
              for i in range(32)]
    torch.cuda.synchronize()
    n0 = fn.launches
    queued = [fn(*a, **kw) for a in inputs]
    torch.cuda.synchronize()
    assert fn.launches == n0 + 32
    for a, (hs, cs) in zip(inputs, queued):
        torch.cuda.synchronize()
        h1, c1 = fn(*a, **kw)
        torch.cuda.synchronize()
        assert torch.equal(hs, h1) and torch.equal(cs, c1)


@pytest.mark.parametrize('kernel', Q_KERNELS)
def test_int8_kernels_on_two_streams(dev, kernel):
    """Launches on two streams at once (each stream its own counters): each
    gives the bits of the same launch alone on the default stream."""
    fn, ref, args, kw = _q_args(kernel, 16, 8, dev, seed=6)
    other = args[:-3] + [-args[-3]] + args[-2:]
    alone = [fn(*args, **kw), fn(*other, **kw)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    both = []
    for s, a in zip(streams, (args, other)):
        with torch.cuda.stream(s):
            both.append(fn(*a, **kw))
    torch.cuda.synchronize()
    for (h, c), (h1, c1) in zip(alone, both):
        assert torch.equal(h, h1) and torch.equal(c, c1)


@pytest.mark.parametrize('kernel', Q_KERNELS)
def test_int8_kernels_same_inputs_same_bits(dev, kernel):
    """The same inputs twice give the same bits."""
    fn, _, args, kw = _q_args(kernel, 16, 8, dev, seed=7)
    for a, b in zip(fn(*args, **kw), fn(*args, **kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize('kernel', Q_KERNELS)
def test_int8_kernels_see_a_weight_written_just_before(dev, kernel):
    """An in-place write of the own-h weights on the stream just before a
    launch is seen by it."""
    fn, ref, args, kw = _q_args(kernel, 16, 8, dev, seed=8)
    w = args[1] if kernel == 'k3' else args[2]
    stale = fn(*args, **kw)
    w.copy_(torch.from_numpy(np.random.RandomState(9).randint(
        -32, 32, w.shape).astype(np.int8)).to(dev))
    got = _q_assert_equals_plain(fn, ref, args, kw)
    assert not torch.equal(stale[0], got[0])


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


# ------------------------------------------------------ K6, K7, K8 on their ops
@pytest.mark.parametrize('layer,B', [(0, 8), (1, 8), (1, 11), (0, 1)])
def test_lstm_gates_kernel_matches_plain_version(dev, layer, B):
    """K6 at full width: layer 0 (N_in 544) and an inner layer (842)."""
    cfg = configs.get_config('chipmunk-ctc')
    lp = _params(cfg, dev).layers[layer]
    rng = np.random.RandomState(layer + B)
    f = lambda *s: torch.from_numpy((rng.randn(*s) * 0.5).astype(
        np.float32)).to(dev)
    x, h, c = f(B, lp.n_x), f(B, lp.n_h), f(B, lp.n_h)
    w = torch.cat([lp.w_x, lp.w_h], dim=-1)
    xh = torch.cat([x, h], dim=-1)
    want = lstm_gates_ref(xh, w, lp.w_peep, lp.b, c)
    n0 = lstm_gates.launches
    for got in (lstm_gates(xh, w, lp.w_peep, lp.b, c),
                lstm_cell_fused(lp, x, h, c)):
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, rtol=0, atol=ATOL)
    torch.cuda.synchronize()
    assert lstm_gates.launches == n0 + 2


# --------------------------------------------- K5 and K6 at every width
def _parent_max_batch(n_h, n_in, sms):
    """The largest B that one CTA's shared memory held under the earlier
    one-input-copy-per-CTA rule, 4 (B n_in + 4 R B) bytes at R = ceil(N_h /
    SMs): the redesigned kernel must take it too."""
    rows = max(1, -(-n_h // sms))
    return 232_448 // (4 * (n_in + 4 * rows))


def _gates_args(kernel, n_h, B, dev, seed=0, n_x=None):
    """(fn, ref, args) of K5 (``kernel`` 'k5') or K6 ('k6', rows of n_x +
    n_h) on weights and inputs from numpy at ``seed``."""
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=0.5: torch.from_numpy(
        (rng.randn(*s) * scale).astype(np.float32)).to(dev)
    K = n_h if kernel == 'k5' else n_x + n_h
    w = f(4, n_h, K, scale=1 / np.sqrt(K))
    peep, bias = f(3, n_h, scale=0.1), f(4, n_h, scale=0.1)
    if kernel == 'k5':
        return (lstm_gates_rec, lstm_gates_rec_ref,
                [f(B, n_h), w, f(B, 4, n_h), peep, bias, f(B, n_h)])
    return lstm_gates, lstm_gates_ref, [f(B, K), w, peep, bias, f(B, n_h)]


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


@pytest.mark.parametrize('B', [1, 5, 8, 11, 'max'])
@pytest.mark.parametrize('n_h', [3, 37, 421])
@pytest.mark.parametrize('kernel,n_x', [('k5', None), ('k6', 123),
                                        ('k6', 'n_h')])
def test_gates_kernels_match_plain_versions(dev, kernel, n_x, n_h, B):
    """K5 and K6 (layer 0's rows, 123 + N_h, and an inner layer's, 2 N_h)
    against their plain versions at atol 1e-4, up to the largest B the
    earlier rule admitted (several ring slots refilled at N_h = 421)."""
    n_x = n_h if n_x == 'n_h' else n_x
    K = n_h if kernel == 'k5' else n_x + n_h
    if B == 'max':
        B = _parent_max_batch(n_h, K, _sms(dev))
    fn, ref, args = _gates_args(kernel, n_h, B, dev, seed=n_h + B, n_x=n_x)
    n0 = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    for g, w in zip(got, ref(*args)):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)


@pytest.mark.parametrize('B', [1, 9])
def test_gates_kernel_without_room_for_its_slab(dev, B):
    """K6 on rows too long for a weight slab in shared memory (N_in 16,037,
    16,000 inputs): the unstaged form, no ring slots, reads global memory."""
    fn, ref, args = _gates_args('k6', 37, B, dev, seed=11, n_x=16000)
    geom = gates_geometry(37, 16037, B, _sms(dev))
    assert geom.stages == 0 and geom.admissible()
    for g, w in zip(fn(*args), ref(*args)):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)


@pytest.mark.parametrize('n_h,B', [(421, 8), (37, 11), (421, 67)])
@pytest.mark.parametrize('kernel', ['k5', 'k6'])
def test_gates_kernels_take_misaligned_views(dev, kernel, n_h, B):
    """Every input a contiguous view at a storage offset of one float (no
    16-byte alignment anywhere): the same bits as on aligned copies, and
    both launches deterministic."""
    fn, ref, args = _gates_args(kernel, n_h, B, dev, seed=3, n_x=123)
    views = []
    for a in args:
        buf = torch.empty(a.numel() + 1, device=dev)
        v = buf[1:].view(a.shape)
        v.copy_(a)
        assert v.is_contiguous() and v.data_ptr() % 16 == 4
        views.append(v)
    aligned, again, shifted = fn(*args), fn(*args), fn(*views)
    for a, b, c, w in zip(aligned, again, shifted, ref(*args)):
        assert torch.equal(a, b) and torch.equal(a, c)
        torch.testing.assert_close(c, w, rtol=0, atol=ATOL)


def test_k5_back_to_back_equals_synchronized_launches(dev):
    """T launches of the ``cuda_step`` chain (launches 2 .. T overlap the
    one before) give the bits of T stream-ordered launches with a
    synchronize between each."""
    from repro_torch.kernels.lstm_gates.ops import _step_forward
    T, B, N = 16, 8, 421
    _, _, (h, w_h, _, peep, bias, c) = _gates_args('k5', N, B, dev, seed=5)
    pre_x = torch.from_numpy((np.random.RandomState(6).randn(T, B, 4, N)
                              * 0.5).astype(np.float32)).to(dev)
    n0 = lstm_gates_rec.launches
    hs, cs = _step_forward(w_h, peep, bias, pre_x, h, c)
    assert lstm_gates_rec.launches == n0 + T
    hh, cc = h, c
    for t in range(T):
        torch.cuda.synchronize()
        hh, cc = lstm_gates_rec(hh, w_h, pre_x[t], peep, bias, cc)
        torch.cuda.synchronize()
        assert torch.equal(hs[t], hh) and torch.equal(cs[t], cc)


@pytest.mark.parametrize('B', [8, 132])
def test_weight_written_by_the_preceding_kernel_is_seen(dev, B):
    """An in-place update of W_h (as the optimizer's) just before a K5
    launch, and before the first launch of a ``cuda_step`` chain, is seen
    by it; so is K6's freshly ``cat``-ed W after an update of W_h."""
    from repro_torch.kernels.lstm_gates.ops import _step_forward
    N = 421
    _, _, (h, w_h, pre, peep, bias, c) = _gates_args('k5', N, B, dev, seed=7)
    delta = torch.from_numpy((np.random.RandomState(9).randn(4, N, N)
                              * 0.05).astype(np.float32)).to(dev)
    stale = lstm_gates_rec(h, w_h, pre, peep, bias, c)
    w_h.add_(delta)
    got = lstm_gates_rec(h, w_h, pre, peep, bias, c)
    want = lstm_gates_rec_ref(h, w_h, pre, peep, bias, c)
    assert float((stale[0] - want[0]).abs().max()) > 100 * ATOL
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)
    pre_x = pre[None].repeat(4, 1, 1, 1)
    _step_forward(w_h, peep, bias, pre_x, h, c)
    w_h.add_(delta)
    hs, cs = _step_forward(w_h, peep, bias, pre_x, h, c)
    hh, cc = h, c
    for t in range(4):
        hh, cc = lstm_gates_rec_ref(hh, w_h, pre_x[t], peep, bias, cc)
        torch.testing.assert_close(hs[t], hh, rtol=0, atol=ATOL)
        torch.testing.assert_close(cs[t], cc, rtol=0, atol=ATOL)
    w_x = torch.from_numpy((np.random.RandomState(8).randn(4, N, 123)
                            * 0.05).astype(np.float32)).to(dev)
    xh = torch.cat([torch.ones(B, 123, device=dev), h], dim=-1)
    lstm_gates(xh, torch.cat([w_x, w_h], dim=-1), peep, bias, c)
    w_h.add_(delta)
    w = torch.cat([w_x, w_h], dim=-1)
    got = lstm_gates(xh, w, peep, bias, c)
    for g, r in zip(got, lstm_gates_ref(xh, w, peep, bias, c)):
        torch.testing.assert_close(g, r, rtol=0, atol=ATOL)


@pytest.mark.parametrize('m,k,n', [(256, 512, 512), (15, 100, 75),
                                   (1, 7, 3), (130, 264, 136),
                                   (256, 6144 + 48, 384), (512, 1024, 2048),
                                   (256, 1024, 16384)])
@pytest.mark.parametrize('out_dtype', [torch.float32, torch.bfloat16])
def test_quant_matmul_kernel_equals_plain_version(dev, m, k, n, out_dtype):
    """K7, aligned and ragged (16-byte and byte staging, partial tiles),
    in 64-row tiles (256 x 512 x 512; 512 x 1024 x 2048), 256-row tiles
    (256 x 1024 x 16384, Mixtral's schedule) and with K over many ring
    stages and a ragged last one (256 x 6192 x 384)."""
    rng = np.random.RandomState(m + k + n)
    x_q = torch.from_numpy(rng.randint(-128, 128, (m, k)).astype(
        np.int8)).to(dev)
    w_q = torch.from_numpy(rng.randint(-128, 128, (k, n)).astype(
        np.int8)).to(dev)
    xs = torch.from_numpy(rng.rand(m, 1).astype(np.float32) + 0.1).to(dev)
    ws = torch.from_numpy(rng.rand(1, n).astype(np.float32) + 0.1).to(dev)
    n0 = quant_matmul.launches
    got = quant_matmul(x_q, w_q, xs, ws, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert quant_matmul.launches == n0 + 1 and got.dtype == out_dtype
    assert torch.equal(got, quant_matmul_ref(x_q, w_q, xs, ws, out_dtype))


def test_quant_matmul_wgmma_pipeline_is_not_serialized(dev, tmp_path):
    """K7's ``wgmma``s stay asynchronous: ptxas serializes them (its note
    C7514) when other instructions touch the accumulators inside the
    pipeline, as it did once the accumulators lost their fences."""
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, '-Xptxas', '-v', '-o',
         str(tmp_path / 'quant_matmul.so'),
         str(_build.CSRC / 'quant_matmul.cu')],
        capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log
    assert 'quant_matmul_kernel' in log and 'C7514' not in log, log


def test_quantized_linear_on_card(dev):
    """The reference's ragged case through the public op: one K7 launch,
    equal to the plain path on the same codes, within 3 % of f32."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(3, 5, 100).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.randn(100, 75).astype(np.float32)).to(dev)
    w_q, w_scale = quantize_weights(w)
    n0 = quant_matmul.launches
    got = quantized_linear(x, w_q, w_scale)
    assert quant_matmul.launches == n0 + 1 and got.shape == (3, 5, 75)
    assert torch.equal(got.cpu(), quantized_linear(x.cpu(), w_q.cpu(),
                                                   w_scale.cpu()))
    exact = x @ w
    assert float((got - exact).abs().max() / exact.abs().max()) < 0.03


# bf16 grids of at least two CTAs an SM take 128-row tiles: a ragged Sq
# tail, 16-byte and zero-filled (D 20) staging, kv_len with a negative
# offset, and a window without causality
WIDE_ATTN_CASES = (
    (4, 48, 8, 200, 200, 64, True, 64, None, None),
    (4, 48, 8, 200, 200, 20, True, 64, None, None),
    (4, 48, 8, 200, 260, 32, True, None, 150, -20),
    (4, 48, 8, 200, 200, 128, False, 48, None, 0),
)


@pytest.mark.parametrize('case', [
    # (B, H, Hkv, Sq, Sk, D, causal, window, kv_len, offset)
    (1, 8, 8, 1024, 1024, 64, True, None, None, None),
    (2, 6, 2, 200, 200, 128, True, 64, None, None),
    (1, 5, 1, 70, 70, 32, False, 16, None, 0),
    (2, 4, 2, 1, 300, 128, True, 128, None, None),      # decode
    (1, 2, 1, 96, 96, 20, True, None, 60, -16),         # D % 4 != 0, rows
    (1, 2, 2, 64, 64, 64, True, None, 0, None),         # all keys masked
    # the split schedule (flash-decoding), one CTA per kv head and range:
    (1, 48, 8, 1, 8192, 128, True, 4096, None, None),   # Mixtral decode
    (1, 48, 8, 4, 8192, 128, True, 4096, None, None),   # Sq 4 x group 6
    (1, 6, 1, 3, 2048, 64, True, None, 700, None),      # kv_len mid-tile
    (1, 6, 2, 3, 512, 64, True, None, 100, -50),        # every split empty
    (2, 4, 2, 1, 300, 20, True, 128, None, None),       # D % 8 != 0
] + list(WIDE_ATTN_CASES))
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain_version(dev, case, dtype):
    """K8 on both sides of ``attention_geometry``'s rule: tiled (bf16 on
    the tensor cores in 64- or 128-row tiles, f32 on the CUDA cores) and
    split."""
    b, h, hkv, sq, sk, d, causal, window, kv_len, offset = case
    if case in WIDE_ATTN_CASES and dtype == torch.bfloat16:
        geom = attention_geometry(
            b, h, hkv, sq, sk, window, kv_len,
            (sk - sq if causal else 0) if offset is None else offset, d,
            torch.cuda.get_device_properties(dev).multi_processor_count,
            causal=causal)
        assert (geom.path, geom.tile_rows) == ('tiled', 128)
    g = torch.Generator(device=dev).manual_seed(sq + sk + d)
    q, k, v = (torch.randn(b, n, s, d, generator=g, device=dev).to(dtype)
               for n, s in ((h, sq), (hkv, sk), (hkv, sk)))
    kw = dict(causal=causal, window=window, kv_len=kv_len, offset=offset)
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1 and got.dtype == dtype
    want = attention_ref(q, k, v, **kw)
    tol = dict(rtol=0, atol=1e-4) if dtype == torch.float32 else dict(
        rtol=2.0 ** -7, atol=1e-5)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    if kv_len == 0 or (offset or 0) + sq <= 0:
        assert not bool(got.any())
    # the split schedule's merging CTAs leave their tickets at 0
    assert not any(bool(t.any()) for t in fa_kernel._TICKETS.values())


def test_mha_on_card_launches_once(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(1, 4, 33, 64, generator=g, device=dev)
    k, v = (torch.randn(1, 2, 50, 64, generator=g, device=dev)
            for _ in range(2))
    n0 = flash_attention.launches
    got = mha(q, k, v, causal=True, window=16)
    assert flash_attention.launches == n0 + 1
    torch.testing.assert_close(
        got, attention_ref(q, k, v, causal=True, window=16), rtol=0,
        atol=1e-4)


# (B, H, Hkv, Sq, Sk, D, window, offset): causal training shapes of K8's
# forward with lse and its backward kernels; ragged tiles, GQA, D 20, a
# window, rows that see no key (negative offset), MiniCPM-2B's heads, and
# Qwen3-14B's (40 on 8 heads, D 128: the rule splits kv_kernel's group
# across CTAs) without and with a window
TRAIN_ATTN_CASES = (
    (2, 4, 2, 100, 100, 64, None, None),
    (1, 6, 2, 70, 130, 128, 48, None),
    (1, 2, 1, 96, 96, 20, None, -16),
    (1, 4, 4, 130, 130, 32, 5, None),
    (1, 36, 36, 512, 512, 64, None, None),
    (1, 40, 8, 256, 256, 128, None, None),
    (1, 40, 8, 200, 200, 128, 64, None),
    # the trained families' shapes at D 64 (a ninth field: causal): whisper's
    # cross (non-causal, Sq != Sk, 1500 keys: a ragged 28-key tile), its
    # encoder's ragged tiles on both grids (37 x 1500), Hymba's windowed
    # GQA 25/5 (the rule's group split)
    (1, 8, 8, 448, 1500, 64, None, None, False),
    (2, 8, 8, 37, 1500, 64, None, None, False),
    (1, 25, 5, 300, 300, 64, 100, None),
    # the MoE and VLM families' geometry at D 128 on ragged tiles:
    # Mixtral's GQA group 6 with its window as long as the sequence (4096
    # at 4096) and with a window that bites; Llama-3.2-Vision's group 8,
    # causal, and non-causal Sq != Sk (its cross layers over the patches)
    (1, 12, 2, 100, 100, 128, 100, None),
    (1, 12, 2, 100, 100, 128, 40, None),
    (1, 16, 2, 100, 100, 128, None, None),
    (1, 16, 2, 70, 100, 128, None, None, False),
)
BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


def _train_attn_inputs(case, dtype, dev):
    b, h, hkv, sq, sk, d, window, offset = case[:8]
    causal = case[8] if len(case) > 8 else True
    g = torch.Generator(device=dev).manual_seed(sq + sk + d)
    q, do = (torch.randn(b, h, sq, d, generator=g, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, hkv, sk, d, generator=g, device=dev).to(dtype)
            for _ in range(2))
    return q, k, v, do, dict(causal=causal, window=window, offset=offset)


@pytest.mark.parametrize('case', TRAIN_ATTN_CASES)
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_flash_attention_lse_matches_plain_version(dev, case, dtype):
    """Both tiled schedules write the log-sum-exp; the output is the
    launch's without it."""
    q, k, v, _, kw = _train_attn_inputs(case, dtype, dev)
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    o_r, lse_r = attention_ref(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, flash_attention(q, k, v, **kw))
    assert lse.shape == lse_r.shape and lse.dtype == torch.float32
    torch.testing.assert_close(lse, lse_r, rtol=0, atol=1e-5)


@pytest.mark.parametrize('case', TRAIN_ATTN_CASES)
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_matches_plain_version(dev, case, dtype):
    q, k, v, do, kw = _train_attn_inputs(case, dtype, dev)
    o, lse = attention_ref(q, k, v, return_lse=True, **kw)
    delta = attention_delta(o, do)
    n_kv = flash_attention_bwd_kv.launches
    n_q = flash_attention_bwd_q.launches
    got = (flash_attention_bwd_q(q, k, v, do, lse, delta, **kw),
           *flash_attention_bwd_kv(q, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    assert (flash_attention_bwd_kv.launches, flash_attention_bwd_q.launches
            ) == (n_kv + 1, n_q + 1)
    want = attention_bwd_ref(q, k, v, do, lse, delta, **kw)
    for name, a, b in zip(('dq', 'dk', 'dv'), got, want):
        assert a.dtype == b.dtype == dtype, name
        err = float((a.float() - b.float()).abs().max())
        assert err <= BWD_REL[dtype] * float(b.float().abs().max()), name
    again = (flash_attention_bwd_q(q, k, v, do, lse, delta, **kw),
             *flash_attention_bwd_kv(q, k, v, do, lse, delta, **kw))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize('case', [TRAIN_ATTN_CASES[i] for i in (0, 1, 5, 6)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kv_split_matches_unsplit(dev, case, dtype):
    """``kv_kernel`` with the GQA group across CTAs (partials summed in head
    order by the last CTA) and in one CTA, forced through the rule's
    ``split``: one launch each, within ``BWD_REL`` of each other, each
    bit-equal run to run; the split leaves its tickets at zero."""
    q, k, v, do, kw = _train_attn_inputs(case, dtype, dev)
    o, lse = attention_ref(q, k, v, return_lse=True, **kw)
    args = (q, k, v, do, lse, attention_delta(o, do))
    b, h, hkv, sq, sk, d = case[:6]
    offset = sk - sq if kw['offset'] is None else kw['offset']
    geoms = {split: attention_bwd_geometry(
        b, h, hkv, sq, sk, d, dtype, kw['window'], offset, 132,
        split=split) for split in (True, False)}
    assert (geoms[True].kv_split, geoms[False].kv_split) == (h // hkv, 1)
    got = {}
    for split in (True, False):
        n0 = flash_attention_bwd_kv.launches
        got[split] = flash_attention_bwd_kv(*args, split=split, **kw)
        again = flash_attention_bwd_kv(*args, split=split, **kw)
        torch.cuda.synchronize()
        assert flash_attention_bwd_kv.launches == n0 + 2
        assert all(torch.equal(a, x) for a, x in zip(got[split], again))
    for a, x in zip(got[True], got[False]):
        err = float((a.float() - x.float()).abs().max())
        assert err <= BWD_REL[dtype] * float(x.float().abs().max())
    stream = torch.cuda.current_stream(dev).cuda_stream
    assert int(fa_kernel._TICKETS[(dev.index, stream)].abs().sum()) == 0


def test_flash_attention_bwd_runs_on_tensor_cores(dev):
    """Every instance of both backward kernels, bf16 and f32, issues
    tensor-core instructions (``HMMA``) in the built library's SASS, and
    MiniCPM-2B's f32 instances (D 64, 16-byte staging) spill nothing.
    Prints each instance's registers and stack (``cuobjdump
    -res-usage``)."""
    lib = _build._target('flash_attention_bwd')[2]
    _build.build(['flash_attention_bwd'])
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    out = {}
    for flag in ('-sass', '-res-usage'):
        proc = subprocess.run([tool, flag, str(lib)], capture_output=True,
                              text=True)
        assert proc.returncode == 0, proc.stderr
        out[flag] = proc.stdout.splitlines()
    funcs, name = {}, None
    for line in out['-sass']:
        if 'Function :' in line:
            name = line.split('Function :')[1].strip()
            funcs[name] = 0
        elif name is not None and 'HMMA' in line:
            funcs[name] += 1
    kernels = {n: c for n, c in funcs.items()
               if 'kv_kernel' in n or 'q_kernel' in n}
    # 2 kernels x 2 dtypes x 3 widths x (vectorised or not)
    assert len(kernels) == 24, sorted(funcs)
    assert all(c > 0 for c in kernels.values()), kernels
    assert any('bfloat16' in n for n in kernels)
    usage, name = {}, None
    for line in out['-res-usage']:
        if 'Function' in line:
            name = line.split('Function')[1].strip(' :')
        elif name is not None and 'REG:' in line:
            usage[name] = dict(re.findall(r'(\w+):(\d+)', line))
    for n in sorted(usage):
        print(f"{n}: REG {usage[n]['REG']} STACK {usage[n]['STACK']}")
    main = [n for n in usage if 'ILi64ELi32ELb1EfE' in n]
    assert len(main) == 2 and all(usage[n]['STACK'] == '0' for n in main)


def test_attention_train_on_card_matches_plain(dev):
    """The autograd op on K8 (forward with lse, both backward kernels)
    against the same op on the plain versions."""
    q, k, v, do, kw = _train_attn_inputs(TRAIN_ATTN_CASES[1], torch.float32,
                                         dev)
    outs = {}
    for plain in (False, True):
        leaves_ = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = attention_train(*leaves_, plain=plain, **kw)
        outs[plain] = (o, torch.autograd.grad(o, leaves_, do))
    torch.testing.assert_close(outs[False][0], outs[True][0], rtol=0,
                               atol=1e-4)
    for a, b in zip(outs[False][1], outs[True][1]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


# --------------------------- F4: batch blocks past a kernel's single launch
def _single_launch_max(kernel, dev):
    return (_max_batch(kernel, dev) if kernel in SEQ_KERNELS
            else _q_max_batch(kernel, dev, n_x=421 if kernel == 'k3' else 123))


@pytest.mark.parametrize('kernel,B', [('k1', 105), ('k2', 25)])
def test_seq_kernels_in_batch_blocks(dev, kernel, B):
    """K1 at B = 105 and K2 at B = 25 (one stream past their largest single
    launch at N_h 421): two launches, allclose to the plain version (atol
    1e-4), and every row bit-equal to the same row of a B = 8 launch that
    holds it (rows never mix)."""
    assert _max_batch(kernel, dev) == B - 1
    fn, ref, args = _seq_args(kernel, 16, B, dev, seed=B)
    n0 = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 2
    for g, w in zip(got, ref(*args)):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)
    bdim = 0 if kernel == 'k1' else 1       # h0/c0's batch axis
    for lo in sorted({*range(0, B - 8, 8), B - 8}):
        part = list(args)
        part[0], part[-1] = args[0][:, lo:lo + 8], args[-1][:, lo:lo + 8]
        for i in (-3, -2):
            part[i] = args[i].narrow(bdim, lo, 8)
        part = [a.contiguous() for a in part]
        for g, w in zip(got, fn(*part)):
            assert torch.equal(g.narrow(bdim + 1, lo, 8), w)


@pytest.mark.parametrize('kernel,B', [('k3', 121), ('k4', 97)])
def test_int8_kernels_in_batch_blocks(dev, kernel, B):
    """K3 on the inner plan at B = 121 and K4 at B = 97 (one stream past
    their largest single launch): two launches, ``torch.equal`` to the
    plain version."""
    n_x = 421 if kernel == 'k3' else 123
    assert _q_max_batch(kernel, dev, n_x=n_x) == B - 1
    fn, ref, args, kw = _q_args(kernel, 16, B, dev, seed=B, n_x=n_x)
    n0 = fn.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 2
    for g, w in zip(got, ref(*args, **kw)):
        assert g.dtype == torch.int8 and torch.equal(g, w)


@pytest.mark.parametrize('kernel', SEQ_KERNELS + Q_KERNELS)
def test_blocked_launches_in_a_row_and_on_two_streams(dev, kernel):
    """Two blocked calls in a row on one stream share its step counters
    between every block (each launch leaves them zero), and two blocked
    calls on two streams each use their own: every result has the bits of
    the same call alone, and the counters are zero afterwards."""
    from repro_torch.kernels.lstm_seq.kernel import _COUNTERS
    B = _single_launch_max(kernel, dev) + 3
    if kernel in SEQ_KERNELS:
        fn, _, args = _seq_args(kernel, 16, B, dev, seed=11)
        kw = {}
        other = [args[0] * 0.5] + args[1:]
    else:
        fn, _, args, kw = _q_args(kernel, 16, B, dev, seed=11,
                                  n_x=421 if kernel == 'k3' else 123)
        other = args[:-3] + [-args[-3]] + args[-2:]
    alone = []
    for a in (args, other):
        alone.append(fn(*a, **kw))
        torch.cuda.synchronize()
    n0 = fn.launches
    in_a_row = [fn(*a, **kw) for a in (args, other)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    both = []
    for s, a in zip(streams, (args, other)):
        with torch.cuda.stream(s):
            both.append(fn(*a, **kw))
    torch.cuda.synchronize()
    assert fn.launches == n0 + 8
    for got in (in_a_row, both):
        for (h, c), (h1, c1) in zip(alone, got):
            assert torch.equal(h, h1) and torch.equal(c, c1)
    assert not any(bool(t.any()) for t in _COUNTERS.values())


def test_engine_past_every_single_launch_on_auto(dev):
    """``StreamingEngine(max_streams=105)`` on ``auto`` at full width builds
    (K1 in two blocks a layer) and drains, each stream allclose to the
    monolithic forward."""
    cfg = configs.get_config('chipmunk-ctc')
    params = _params(cfg, dev)
    eng = StreamingEngine(cfg, params, max_streams=105, chunk=16)
    assert eng.backend == 'cuda_seq'
    rng = np.random.RandomState(12)
    utts = [(rng.randn(rng.randint(8, 40), cfg.lstm_inputs) * 0.5).astype(
        np.float32) for _ in range(110)]
    sess = [eng.submit(u) for u in utts]
    n0 = lstm_seq.launches
    eng.run()
    assert lstm_seq.launches - n0 == 2 * cfg.n_layers * eng.stats()['steps']
    fwd = cfg.replace(lstm_backend='cuda_seq_fused')
    for s, u in zip(sess, utts):
        mono = chipmunk_net.forward(fwd, params, torch.from_numpy(u)[None]
                                    .to(dev))[:, 0].cpu().numpy()
        np.testing.assert_allclose(s.full_log_probs(), mono, rtol=1e-4,
                                   atol=ATOL)


# ------------------------------------------------ async dispatch on the card
def _serve(cfg, params, utts, backend, async_mode, policy=None, slots=8,
           chunk=16):
    from repro_torch.runtime import ChunkSizePolicy
    pol = (ChunkSizePolicy(chunk_max=chunk, slack=1e9, patience=2)
           if policy else None)
    eng = StreamingEngine(cfg.replace(lstm_backend=backend), params,
                          max_streams=slots, chunk=chunk,
                          async_dispatch=async_mode, chunk_policy=pol)
    sess = [eng.submit(u) for u in utts]
    eng.run()
    return [s.full_log_probs() for s in sess], eng


@pytest.mark.parametrize('policy', [False, True])
@pytest.mark.parametrize('backend', ['cuda_seq', 'cuda_seq_fused'])
def test_async_equals_sync_on_card(dev, backend, policy):
    """At full width, async == sync bit for bit, and with the chunk-size
    policy (boundaries at 16, 8, 4, ...) both equal the fixed-chunk sync
    run; no speculation squashed."""
    cfg = configs.get_config('chipmunk-ctc')
    params = _params(cfg, dev)
    rng = np.random.RandomState(13)
    utts = [(rng.randn(rng.randint(20, 120), cfg.lstm_inputs) * 0.5).astype(
        np.float32) for _ in range(12)]
    fixed, _ = _serve(cfg, params, utts, backend, False)
    for mode in (False, True):
        got, eng = _serve(cfg, params, utts, backend, mode, policy)
        assert eng.stats()['event_counts'].get('squash', 0) == 0
        if policy:
            assert len({c for c, _ in eng._policy.history}) > 2
        for a, b in zip(got, fixed):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('backend', ['cuda_seq', 'cuda_seq_fused'])
def test_async_host_buffers_never_rewritten_in_flight(dev, backend):
    """64 chunks and more back to back under async dispatch, the host
    packing and launching as fast as it can (chunks of 2 frames, full
    width): every stream's log-probs equal the sync run's, so no pinned
    upload or read-back buffer was rewritten while its copy was in
    flight."""
    cfg = configs.get_config('chipmunk-ctc')
    params = _params(cfg, dev)
    rng = np.random.RandomState(14)
    utts = [(rng.randn(rng.randint(100, 160), cfg.lstm_inputs) * 0.5)
            .astype(np.float32) for _ in range(6)]
    want, _ = _serve(cfg, params, utts, backend, False, slots=4, chunk=2)
    got, eng = _serve(cfg, params, utts, backend, True, slots=4, chunk=2)
    assert eng.stats()['steps'] >= 64
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------- fault runtime on the card
def _fault_engine(cfg, params, backend, faults, async_mode=False, slots=4,
                  chunk=8):
    """An engine whose chunk calls are logged: (backend, K1 launches, K2
    launches) per call, the canary's shadow included."""
    eng = StreamingEngine(cfg.replace(lstm_backend=backend), params,
                          max_streams=slots, chunk=chunk, faults=faults,
                          async_dispatch=async_mode)
    calls = []
    make = eng._make_fwd

    def traced(c, *placement):
        fwd = make(c, *placement)

        def call(*args):
            k1, k2 = lstm_seq.launches, lstm_stack_seq_kernel.launches
            out = fwd(*args)
            calls.append((c.lstm_backend, lstm_seq.launches - k1,
                          lstm_stack_seq_kernel.launches - k2))
            return out
        return call

    eng._make_fwd = traced
    eng._fwd = traced(eng.cfg)
    return eng, calls


def _fault_drain(eng, utts):
    sess = [eng.submit(u) for u in utts]
    eng.run()
    return [s.full_log_probs() for s in sess], sess


def _fault_utts(cfg, n=4, frames=140, seed=21):
    rng = np.random.RandomState(seed)
    return [(rng.randn(frames, cfg.lstm_inputs) * 0.5).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize('async_mode', [False, True])
def test_fault_ladder_on_card(dev, async_mode):
    """K2 -> K1 -> torch_scan and back (canary off, so both promotions
    land): every chunk call on the rung the schedule puts it, K2 once and
    K1 L times a call, neither on the scan; no stream lost, each allclose
    to a clean K2 engine; async == sync bit for bit."""
    from repro_torch.runtime import ServingFaultConfig
    cfg = configs.get_smoke_config('chipmunk-ctc')
    params = _params(cfg, dev)
    utts = _fault_utts(cfg)
    L = cfg.n_layers
    F, S, T = ('cuda_seq_fused', 0, 1), ('cuda_seq', L, 0), ('torch_scan',
                                                           0, 0)
    # chunks 0-1 on K2, chunk 2 launched on K2 then recomputed on K1, 3-4
    # on K1, chunk 5 launched on K1 then on the scan, 6-7 on the scan,
    # promotions at 8 (to K1) and 14 (to K2)
    want = [F] * 3 + [S] * 4 + [T] * 3 + [S] * 6 + [F] * 4
    clean, _ = _fault_drain(StreamingEngine(cfg, params, max_streams=4,
                                            chunk=8), utts)
    eng, calls = _fault_engine(cfg, params, 'cuda_seq_fused',
                               ServingFaultConfig(
                                   fail_at={2: 1, 5: 1},
                                   recover_at={8: 1, 14: 1},
                                   promote_hysteresis=2, canary=False,
                                   backoff_s=0.0), async_mode)
    got, sess = _fault_drain(eng, utts)
    assert calls == want
    st = eng.stats()
    assert st['backend'] == 'cuda_seq_fused' and st['steps'] == 18
    assert [e['kind'] for e in st['events'] if e['kind'] in (
        'degrade', 'heal', 'promote')] == ['degrade', 'degrade', 'heal',
                                           'promote', 'heal', 'promote']
    for a, b in zip(got, clean):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=ATOL)
    if async_mode:
        eng2, _ = _fault_engine(cfg, params, 'cuda_seq_fused',
                                ServingFaultConfig(
                                    fail_at={2: 1, 5: 1},
                                    recover_at={8: 1, 14: 1},
                                    promote_hysteresis=2, canary=False,
                                    backoff_s=0.0))
        sync, _ = _fault_drain(eng2, utts)
        for a, b in zip(got, sync):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('backend', ['cuda_seq_fused', 'cuda_seq'])
def test_fault_transient_retry_on_card(dev, backend):
    """A transient fault at chunk 3 is retried on the same kernel: one
    ``fault``, no ``degrade``, outputs equal to a clean run."""
    from repro_torch.runtime import ServingFaultConfig
    cfg = configs.get_smoke_config('chipmunk-ctc')
    params = _params(cfg, dev)
    utts = _fault_utts(cfg, frames=60)
    clean, _ = _fault_drain(StreamingEngine(
        cfg.replace(lstm_backend=backend), params, max_streams=4, chunk=8),
        utts)
    eng, calls = _fault_engine(cfg, params, backend, ServingFaultConfig(
        fail_at={3: {'transient': True}}, backoff_s=0.0))
    got, _ = _fault_drain(eng, utts)
    counts = eng.stats()['event_counts']
    assert counts['fault'] == 1 and 'degrade' not in counts
    assert {c[0] for c in calls} == {backend}
    assert len(calls) == eng.stats()['steps'] + 1
    for a, b in zip(got, clean):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('backend', ['cuda_seq_fused', 'cuda_seq'])
def test_fault_quarantine_on_card(dev, backend):
    """NaN poisoned into slot 1 before chunk 3: that stream ends with an
    error; every other stream equals a clean run bit for bit (the NaN row
    reaches no neighbour through the kernel's exchange)."""
    from repro_torch.runtime import ServingFaultConfig
    cfg = configs.get_smoke_config('chipmunk-ctc')
    params = _params(cfg, dev)
    utts = _fault_utts(cfg, frames=60)
    c = cfg.replace(lstm_backend=backend)
    clean, _ = _fault_drain(StreamingEngine(
        c, params, max_streams=4, chunk=8, faults=ServingFaultConfig()),
        utts)
    eng = StreamingEngine(c, params, max_streams=4, chunk=8,
                          faults=ServingFaultConfig(poison_at={3: 1}))
    got, sess = _fault_drain(eng, utts)
    assert [s.error is not None for s in sess] == [False, True, False,
                                                   False]
    for i in (0, 2, 3):
        np.testing.assert_array_equal(got[i], clean[i])
    for h, cc in eng.states:
        assert bool(torch.isfinite(h).all() and torch.isfinite(cc).all())


@pytest.mark.parametrize('backend', ['cuda_seq_fused', 'cuda_seq'])
def test_fault_checkpoint_resume_on_card(dev, backend, tmp_path):
    """A stream preempted to disk on one engine resumes in a second engine
    (``resume_from_checkpoint``): its suffix equals the uninterrupted
    run's bit for bit."""
    from repro_torch.runtime import ServingFaultConfig
    cfg = configs.get_smoke_config('chipmunk-ctc')
    params = _params(cfg, dev)
    c = cfg.replace(lstm_backend=backend)
    utts = _fault_utts(cfg, n=3, frames=60)
    clean, _ = _fault_drain(StreamingEngine(c, params, max_streams=4,
                                            chunk=8), utts)
    fc = ServingFaultConfig(checkpoint_dir=str(tmp_path))
    eng = StreamingEngine(c, params, max_streams=4, chunk=8, faults=fc)
    sess = [eng.submit(u) for u in utts]
    eng.step()
    eng.step()
    eng.preempt(sess[0].sid, requeue=False)
    eng.run()
    second = StreamingEngine(c, params, max_streams=4, chunk=8, faults=fc)
    resumed = second.resume_from_checkpoint(utts[0], sess[0].sid)
    assert resumed.cursor == 16
    second.run()
    np.testing.assert_array_equal(resumed.full_log_probs(), clean[0][16:])


def test_fault_int8_carries_through_checkpointer_on_card(dev, tmp_path):
    """K4's int8 carries between two chunks round-trip through the stream
    checkpointer with their dtype; the resumed chunk equals the
    uninterrupted launch."""
    from repro_torch.runtime import StreamStateCheckpointer
    qps = _q_stack(16, 48, 16, 2, dev, seed=5)
    xq = torch.from_numpy(np.random.RandomState(6).randint(
        -60, 60, (12, 3, 16)).astype(np.int8)).to(dev)
    want = lstm_stack_seq_quantized_auto(qps, xq, backend='fused')
    head, st = lstm_stack_seq_quantized_auto(qps, xq[:5], backend='fused',
                                             return_state=True)
    ckpt = StreamStateCheckpointer(str(tmp_path))
    ckpt.save(0, (tuple(st),), cursor=5)
    (restored,), cursor = ckpt.load(0, (tuple(torch.zeros_like(s)
                                              for s in st),))
    assert cursor == 5 and all(r.dtype == torch.int8 and r.is_cuda
                               for r in restored)
    tail = lstm_stack_seq_quantized_auto(qps, xq[5:], backend='fused',
                                         state=tuple(restored))
    assert torch.equal(torch.cat([head, tail]), want)


@pytest.mark.parametrize('backend', ['cuda_seq_fused', 'cuda_seq'])
def test_fault_guard_changes_no_bits_on_card(dev, backend):
    """The guard on (nothing injected) against ``faults=None``: the same
    bits, the same kernel launches per chunk."""
    from repro_torch.runtime import ServingFaultConfig
    cfg = configs.get_smoke_config('chipmunk-ctc')
    params = _params(cfg, dev)
    utts = _fault_utts(cfg, frames=60)
    outs = {}
    for name, faults in (('off', None), ('on', ServingFaultConfig())):
        eng, calls = _fault_engine(cfg, params, backend, faults)
        outs[name] = (_fault_drain(eng, utts)[0], calls)
    assert outs['on'][1] == outs['off'][1]
    for a, b in zip(outs['on'][0], outs['off'][0]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------- die fault domains, staged tuner
def test_die_rungs_of_graves_3x25_on_card(dev):
    """At 421 hidden with every engine on the card (budget L2 / engines):
    3d, 2d, the layerwise 1d rung, then K2, K1 and the scan."""
    from repro_torch.launch.mesh import make_die_topology
    from repro_torch.runtime import build_rungs
    dm = make_die_topology('graves-3x25', devices=dev)
    rungs = build_rungs('cuda_seq_fused_systolic', n_layers=3, n_h=421,
                        die_mesh=dm, n_x=123, T=16, batch=8)
    assert [(r.label(), r.need) for r in rungs] == [
        ('cuda_seq_fused_systolic@3d', 3), ('cuda_seq_fused_systolic@2d', 2),
        ('cuda_seq_systolic@1d', 1), ('cuda_seq_fused', 0), ('cuda_seq', 0),
        ('torch_scan', 0)]


@pytest.mark.parametrize('async_mode', [False, True])
def test_die_chaos_on_card(dev, async_mode):
    """die-3x1x1 on the card: die 2 lost at chunk 2 and healed at 5; the
    trail degrade, heal, promote_canary, promote, no K1-K4 launch, and
    every stream bit-equal to an unfaulted drain."""
    from repro_torch.launch.mesh import clear_die_mesh, install_die_topology
    from repro_torch.runtime import ServingFaultConfig
    cfg = configs.get_smoke_config('chipmunk-ctc').replace(
        n_layers=3, lstm_backend='auto')
    params = _params(cfg, dev)
    utts = _fault_utts(cfg, n=2, frames=88)

    def drain(faults):
        install_die_topology('die-3x1x1', devices=dev)
        eng = StreamingEngine(cfg, params, max_streams=2, chunk=8,
                              faults=faults, async_dispatch=async_mode)
        sess = [eng.submit(u) for u in utts]
        eng.run()
        return eng, [s.full_log_probs() for s in sess]

    try:
        _, clean = drain(None)
        kernels = (lstm_seq, lstm_stack_seq_kernel, lstm_seq_quantized,
                   lstm_stack_seq_kernel_q)
        before = [k.launches for k in kernels]
        eng, got = drain(ServingFaultConfig(
            fail_at={2: {'n_dead': 1, 'domain': 2}}, recover_at={5: 1},
            promote_hysteresis=2, backoff_s=0.0))
        assert [k.launches for k in kernels] == before
    finally:
        tsys.clear_mesh()
        clear_die_mesh()
    st = eng.stats()
    assert [e['kind'] for e in st['events'] if e['kind'] in (
        'degrade', 'heal', 'promote_canary', 'promote')] == [
        'degrade', 'heal', 'promote_canary', 'promote']
    assert st['rung'] == 'cuda_seq_fused_systolic@3d'
    for a, b in zip(got, clean):
        np.testing.assert_array_equal(a, b)


def test_staged_tuners_on_card(dev):
    """``tune_staged_stack`` and ``tune_geometry`` measured with every
    engine on the card (their candidates held ``torch.equal`` inside), and
    the geometry winner's split and Tc taken by ``place_stack`` and
    ``resolve_staged_chunk`` under the recorded cache."""
    from repro_torch.tune import (ScheduleCache, tune_geometry,
                                  tune_staged_stack, using_schedule_cache)
    stack = tlstm.stack_params_to(tlstm.init_lstm_stack(
        16, 40, 3, None, torch.Generator().manual_seed(7)), dev)
    xs = torch.randn((16, 4, 16), generator=torch.Generator().manual_seed(8)
                     ).to(dev) * 0.5
    mesh = tsys.make_systolic_mesh(2, 2, stage=3, devices=dev)
    ent, _ = tune_staged_stack(stack, mesh, xs, iters=2)
    assert ent.source == 'measured' and ent.host.split('/')[1].startswith(
        'cuda')
    cache = ScheduleCache()
    geo, _, base = tune_geometry(stack, xs, devices=12, ref=(3, 2, 2),
                                 cache=cache, iters=2)
    assert base > 0 and geo.source == 'measured'
    win = tsys.make_systolic_mesh(geo.rows, geo.cols, stage=geo.stages,
                                  devices=dev)
    with using_schedule_cache(cache):
        assert ','.join(map(str, tsys.place_stack(
            stack, win, staged=True, T=16, batch=4).split)) == geo.blocks
        assert tsys.resolve_staged_chunk(3, 16, geo.stages, n_h=40, n_x=16,
                                         batch=4, mesh=win) == geo.tc


# ------------------------------------------------- the dense LM on the card
@pytest.mark.parametrize('name', ['qwen3-14b', 'qwen2.5-14b', 'minicpm-2b'])
@pytest.mark.parametrize('adtype', ['float32', 'bfloat16'])
def test_lm_decode_on_k8_matches_plain_attention(dev, name, adtype,
                                                 monkeypatch):
    """``decode_step`` with K8 (``attn_backend='auto'``, the split schedule
    at these shapes) against the same weights with ``attention_ref``
    (``'torch'``) over 24 tokens, every logit row; and ``forward_lm``
    (K8's tiled prefill) the same way.  f32: atol 1e-4 (K8's own bound,
    through two layers); bf16: 3e-2 of the logit scale (K8 multiplies P
    in bf16 on the tensor cores)."""
    from repro_torch.models import transformer
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        'allow_bf16_reduced_precision_reduction', False)
    cfg = configs.get_smoke_config(name).replace(activation_dtype=adtype)
    params = transformer.init_lm(cfg, torch.Generator(dev).manual_seed(0),
                                 dev)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 24))).to(dev)

    def run(backend):
        c = cfg.replace(attn_backend=backend)
        cache = transformer.init_cache(c, 2, 32, dev)
        rows = [transformer.decode_step(c, params, cache, tokens[:, t:t + 1],
                                        t)[0] for t in range(24)]
        return (torch.cat(rows, 1).float(),
                transformer.forward_lm(c, params, tokens)[0].float())

    n0 = flash_attention.launches
    dec, full = run('auto')
    assert flash_attention.launches == n0 + 24 * cfg.n_layers + cfg.n_layers
    want_dec, want_full = run('torch')
    assert flash_attention.launches == n0 + 25 * cfg.n_layers
    scale = float(want_full.abs().max())
    tol = 1e-4 if adtype == 'float32' else 3e-2 * scale
    assert float((dec - want_dec).abs().max()) <= tol
    assert float((full - want_full).abs().max()) <= tol
    assert float((dec - full).abs().max()) <= (2e-3 if adtype == 'float32'
                                               else 3e-2 * scale)


# ------------------------------------------------- the MoE family on the card
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('pos', [15, 40])
def test_ring_decode_on_k8_matches_plain_and_linear(dev, dtype, pos):
    """K8 on a ring of W = 16 slots holding positions pos - 15 .. pos at
    slot t % 16 (``attention_decode``'s call: no causal mask, kv_len =
    min(pos + 1, 16)) against its plain version, and against K8 on the
    linear cache of pos + 1 keys with window 16 (the same key set): f32
    atol 1e-4, bf16 rtol 2**-7, atol 1e-5 (one output rounding)."""
    g = torch.Generator(dev).manual_seed(pos)
    dt = getattr(torch, dtype)
    W, H, Hkv, D = 16, 8, 2, 64
    q = torch.randn(2, H, 1, D, generator=g, device=dev).to(dt)
    k, v = (torch.randn(2, Hkv, pos + 1, D, generator=g, device=dev).to(dt)
            for _ in range(2))
    t = torch.arange(max(0, pos - W + 1), pos + 1, device=dev)
    ring_k, ring_v = (torch.zeros(2, Hkv, W, D, dtype=dt, device=dev)
                      for _ in range(2))
    ring_k[:, :, t % W], ring_v[:, :, t % W] = k[:, :, t], v[:, :, t]
    kw = dict(causal=False, kv_len=min(pos + 1, W))
    got = flash_attention(q, ring_k, ring_v, **kw).float()
    tol = (dict(rtol=0.0, atol=1e-4) if dtype == 'float32'
           else dict(rtol=2.0 ** -7, atol=1e-5))
    torch.testing.assert_close(
        got, attention_ref(q, ring_k, ring_v, **kw).float(), **tol)
    lin = flash_attention(q, k, v, causal=True, window=W, offset=pos)
    torch.testing.assert_close(got, lin.float(), **tol)


@pytest.mark.parametrize('name', ['mixtral-8x22b', 'kimi-k2-1t-a32b'])
def test_moe_block_routes_on_the_card_equal_the_cpu(dev, name):
    """``moe_route`` and ``moe_block`` on CUDA tensors against the same
    call on CPU copies (bf16 activations, f32 parameters, 2 x 64 tokens,
    smoke widths): top-k experts, keep masks and slots equal; outputs and
    the aux loss within 1e-5 (f32 products in other orders)."""
    from repro_torch.models import layers, transformer
    cfg = configs.get_smoke_config(name)
    params = transformer.init_lm(cfg, torch.Generator().manual_seed(0),
                                 'cpu')
    p = {k: v[0] for k, v in params['blocks']['moe'].items()}
    x = torch.randn(2, 64, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).bfloat16()
    pc = {k: v.to(dev) for k, v in p.items()}
    want, got = layers.moe_route(cfg, p, x), layers.moe_route(cfg, pc,
                                                              x.to(dev))
    for f in ('idx', 'keep', 'slot', 'counts'):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    out, ce = layers.moe_block(cfg, pc, x.to(dev))
    want_out, want_ce = layers.moe_block(cfg, p, x)
    torch.testing.assert_close(out.cpu(), want_out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ce.cpu(), want_ce, rtol=1e-5, atol=1e-5)


def test_mixtral_smoke_serves_on_k8_over_a_wrapped_ring(dev):
    """``SlotServer`` on Mixtral's smoke config (window 16, f32
    activations) on K8 and on 'torch': identical greedy tokens past the
    ring's wrap, K8 launched once a layer a decode call."""
    from repro_torch.launch.serve import Request, SlotServer
    from repro_torch.models import transformer
    cfg = configs.get_smoke_config('mixtral-8x22b').replace(
        activation_dtype='float32')
    params = transformer.init_lm(cfg, torch.Generator(dev).manual_seed(0),
                                 dev)
    outs = {}
    for backend in ('auto', 'torch'):
        srv = SlotServer(cfg.replace(attn_backend=backend), params,
                         num_slots=2, max_seq=48)
        for r in range(3):
            srv.submit(Request(rid=r, prompt=[1 + r, 5, 9], max_new=24))
        n0 = flash_attention.launches
        srv.drain()
        calls = 3 * (3 + 24 - 1)
        assert flash_attention.launches - n0 == (
            calls * cfg.n_layers if backend == 'auto' else 0)
        outs[backend] = {r.rid: r.out for r in srv.done}
    assert outs['auto'] == outs['torch']


# ---------------------------------------- the cross-attention families on the card
@pytest.mark.parametrize('shape', [
    ('whisper encoder', 4, 8, 8, 1500, 1500, 64, 'float32'),
    ('whisper cross prefill', 4, 8, 8, 64, 1500, 64, 'float32'),
    ('whisper cross decode', 4, 8, 8, 1, 1500, 64, 'float32'),
    ('llama-vision cross prefill', 4, 64, 8, 64, 1024, 128, 'bfloat16'),
    ('llama-vision cross decode', 4, 64, 8, 1, 1024, 128, 'bfloat16'),
    ('llama-vision cross decode B=1', 1, 64, 8, 1, 1024, 128, 'bfloat16'),
], ids=lambda s: s[0])
def test_cross_attention_on_k8_matches_plain(dev, shape):
    """K8 non-causal with Sq != Sk (whisper's 1,500 keys: a split whose
    last tile holds 28 keys; Llama-3.2-Vision's 1,024 with GQA 64/8)
    against its plain version: f32 atol 1e-4, bf16 rtol 2**-7, atol
    1e-5."""
    _, B, H, Hkv, Sq, Sk, D, dtype = shape
    g = torch.Generator(dev).manual_seed(Sk + Sq)
    dt = getattr(torch, dtype)
    q = torch.randn(B, H, Sq, D, generator=g, device=dev).to(dt)
    k, v = (torch.randn(B, Hkv, Sk, D, generator=g, device=dev).to(dt)
            for _ in range(2))
    got = flash_attention(q, k, v, causal=False).float()
    tol = (dict(rtol=0.0, atol=1e-4) if dtype == 'float32'
           else dict(rtol=2.0 ** -7, atol=1e-5))
    torch.testing.assert_close(
        got, attention_ref(q, k, v, causal=False).float(), **tol)


@pytest.mark.parametrize('name', ['whisper-base', 'llama-3.2-vision-90b'])
def test_cross_decode_on_k8_matches_plain_and_forward(dev, name):
    """The smoke configs at f32 activations on the card: precompute_cross_kv
    + decode_step(cross_kv=) over 12 tokens on K8 against 'torch' (atol
    1e-4) and against forward_lm (2e-3, the reference's bound); K8
    launched once a self and a cross layer a call, once an encoder layer
    a precompute."""
    from repro_torch.models import transformer
    cfg = configs.get_smoke_config(name).replace(activation_dtype='float32')
    params = transformer.init_lm(cfg, torch.Generator(dev).manual_seed(0),
                                 dev)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 12))).to(dev)
    source = torch.randn(2, 37, cfg.d_model, device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    n_cross = (cfg.n_layers // cfg.cross_attn_every if cfg.cross_attn_every
               else cfg.n_layers)
    a_call = transformer.n_self_layers(cfg) + n_cross

    def run(backend):
        c = cfg.replace(attn_backend=backend)
        kv = transformer.precompute_cross_kv(c, params, source)
        cache = transformer.init_cache(c, 2, 12, dev)
        rows = [transformer.decode_step(c, params, cache, tokens[:, t:t + 1],
                                        t, cross_kv=kv)[0]
                for t in range(12)]
        return torch.cat(rows, 1)

    n0 = flash_attention.launches
    dec = run('auto')
    assert flash_attention.launches - n0 == (12 * a_call
                                             + cfg.n_encoder_layers)
    want = run('torch')
    torch.testing.assert_close(dec, want, rtol=0.0, atol=1e-4)
    full, _ = transformer.forward_lm(cfg, params, tokens, source)
    torch.testing.assert_close(dec, full, rtol=2e-3, atol=2e-3)


# ----------------------------------------- the recurrent families on the card
@pytest.mark.parametrize('shape', [
    # Hymba (25 heads on 5, D 64): its f32 forward of 128 meta + 64 tokens
    # on a global layer, of 128 + 2,048 with the window of 1,024, and its
    # bf16 decode rows over a windowed layer's full ring and a global
    # layer's partly filled one
    ('hymba prefill', 1, 192, 192, None, None, True, 'float32'),
    ('hymba windowed forward', 1, 2176, 2176, 1024, None, True, 'float32'),
    ('hymba decode ring', 1, 1, 1024, None, 1024, False, 'bfloat16'),
    ('hymba decode global', 1, 1, 128, None, 100, False, 'bfloat16'),
], ids=lambda s: s[0])
def test_hymba_attention_on_k8_matches_plain(dev, shape):
    """K8 at Hymba's shapes (D 64, GQA 25/5, causal with and without its
    window; the decode row with kv_len and no causal mask, as
    ``attention_decode`` calls it) against its plain version: f32 atol
    1e-4, bf16 rtol 2**-7, atol 1e-5."""
    _, B, Sq, Sk, window, kv_len, causal, dtype = shape
    g = torch.Generator(dev).manual_seed(Sk + Sq)
    dt = getattr(torch, dtype)
    q = torch.randn(B, 25, Sq, 64, generator=g, device=dev).to(dt)
    k, v = (torch.randn(B, 5, Sk, 64, generator=g, device=dev).to(dt)
            for _ in range(2))
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    got = flash_attention(q, k, v, **kw).float()
    tol = (dict(rtol=0.0, atol=1e-4) if dtype == 'float32'
           else dict(rtol=2.0 ** -7, atol=1e-5))
    torch.testing.assert_close(got, attention_ref(q, k, v, **kw).float(),
                               **tol)


@pytest.mark.parametrize('name', ['xlstm-1.3b', 'hymba-1.5b'])
def test_recurrent_smoke_decode_on_the_card_equals_the_cpu(dev, name):
    """The smoke configs at f32 activations, the same weights on the card
    and on the CPU: the bundle's decode over 24 tokens (past Hymba's
    window of 16, so its rings wrap) and its forward, every logit within
    2e-4 (f32 products in other orders; K8 against the plain attention);
    K8 launched once a layer a Hymba decode call and a forward, never for
    xLSTM."""
    from repro_torch.models import get_bundle
    cfg = configs.get_smoke_config(name).replace(activation_dtype='float32')
    b = get_bundle(cfg)
    params = b.init(torch.Generator().manual_seed(0), 'cpu')
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 24)))

    def run(device):
        p = tree_map(lambda a: a.to(device), params)
        tok = tokens.to(device)
        cache = b.init_cache(2, 32, device)
        rows = [b.decode_step(p, cache, tok[:, t:t + 1], t)[0]
                for t in range(24)]
        return (torch.cat(rows, 1).cpu(),
                b.forward(p, {'tokens': tok}).cpu())

    n0 = flash_attention.launches
    dec, full = run(dev)
    hymba = cfg.family == 'hybrid'
    assert flash_attention.launches - n0 == (25 * cfg.n_layers if hymba
                                             else 0)
    want_dec, want_full = run('cpu')
    torch.testing.assert_close(dec, want_dec, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(full, want_full, rtol=2e-4, atol=2e-4)
