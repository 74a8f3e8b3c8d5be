"""Parity of the port's int8 silicon path (K3/K4 ops, dispatch, read-out)
with the JAX reference.

Weights are made with numpy from a seed and quantized by the reference; the
codes cross into the port through ``repro_torch.convert
.quantized_packed_from_numpy``.  The JAX Pallas kernels K3 and K4 run in
interpret mode on the CPU, as the reference's own tests run them; the port's
kernel wrappers run their plain PyTorch versions on CPU tensors.  Every int8
result is compared with ``np.array_equal`` (bit-exact by contract); only the
dequantized f32 read-out is held with rtol=1e-5, atol=1e-6.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from repro.core import lstm as jlstm  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core import systolic as jsys  # noqa: E402
from repro.kernels.lstm_seq import kernel as jkernel  # noqa: E402
from repro.kernels.lstm_seq import ops as jops  # noqa: E402
from repro.kernels.lstm_seq import stack_kernel as jstack_kernel  # noqa: E402
from repro.kernels.lstm_seq import stack_ops as jstack_ops  # noqa: E402
from repro_torch.convert import quantized_packed_from_numpy  # noqa: E402
from repro_torch.core import lstm as tlstm  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.core import systolic as tsys  # noqa: E402
from repro_torch.kernels.lstm_seq import (  # noqa: E402
    lstm_layer_seq_quantized, lstm_seq_quantized, lstm_stack_seq_kernel_q,
    lstm_stack_seq_quantized, lstm_stack_seq_quantized_auto,
    stack_kernel_weights_q)
from repro_torch.kernels.lstm_seq.ops import _dense_from_tiles  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
N_X, N_H, TILE, L = 24, 32, 16, 3


def _jstack(seed, n_x=N_X, n_h=N_H, n_layers=L, tile=TILE):
    """Reference quantized layers from numpy weights drawn from a seed."""
    rng = np.random.RandomState(seed)
    qps = []
    for l in range(n_layers):
        nx = n_x if l == 0 else n_h
        u = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)
        lp = jlstm.LSTMParams(w_x=jnp.asarray(u(4, n_h, nx)),
                              w_h=jnp.asarray(u(4, n_h, n_h)),
                              w_peep=jnp.asarray(u(3, n_h) * 0.5),
                              b=jnp.asarray(u(4, n_h) * 0.5))
        qps.append(jsys.quantize_packed(jsys.pack_lstm(
            lp, jsys.SystolicPlan(nx, n_h, tile))))
    return qps


def _port(jqps):
    return [quantized_packed_from_numpy(jax.tree.map(np.asarray, q), 'cpu')
            for q in jqps]


def _frames(seed, T, B, n_x=N_X):
    xs = np.random.RandomState(seed).randn(T, B, n_x).astype(np.float32)
    return np.array(jquant.quantize(jnp.asarray(xs)))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _chunks(total, n):
    step = -(-total // n)
    return [(lo, min(lo + step, total)) for lo in range(0, total, step)]


@pytest.fixture(scope='module')
def stack3():
    """A 3-layer stack (24 -> 32 x 3, tile 16), reference and port."""
    jqps = _jstack(0)
    return jqps, _port(jqps)


# ---------------------------------------------------------------- K3 / K4 ops
@pytest.mark.parametrize('n_x,n_h,T,B', [(24, 32, 6, 2), (23, 37, 5, 2)])
def test_layer_seq_quantized_matches_reference(n_x, n_h, T, B):
    jqp = _jstack(n_x + n_h, n_x, n_h, n_layers=1)[0]
    tqp = _port([jqp])[0]
    xq = _frames(1, T, B, n_x)
    want, (jh, jc) = jops.lstm_layer_seq_quantized(
        jqp, jnp.asarray(xq), return_state=True, interpret=True)
    got, (th, tc) = lstm_layer_seq_quantized(tqp, torch.from_numpy(xq),
                                             return_state=True)
    for g, w in ((got, want), (th, jh), (tc, jc)):
        _eq(g, w)
    _eq(got, jsys.systolic_layer_quantized(jqp, jnp.asarray(xq)))


def test_raw_kernels_match_reference_kernels(stack3):
    """The wrappers' plain versions against the reference kernels at the
    raw-kernel level, from nonzero carried codes under a ragged mask.  K4's
    layer-major output is compared with the reference's diagonal-major
    output re-indexed (layer l's step t is its diagonal l + t)."""
    jqps, tqps = stack3
    T, B = 5, 3
    p0 = tqps[0].plan
    rng = np.random.RandomState(2)
    xq = _frames(3, T, B)
    xs_pad = np.zeros((T, B, p0.padded_x), np.int8)
    xs_pad[..., :N_X] = xq
    h0 = rng.randint(-64, 64, (L, B, p0.padded_h)).astype(np.int8)
    c0 = rng.randint(-64, 64, (L, B, p0.padded_h)).astype(np.int8)
    mask = np.array([[1, 1, 1], [1, 0, 1], [1, 0, 0], [0, 0, 1], [1, 0, 1]],
                    np.int8)

    w, peep, bias = _dense_from_tiles(tqps[0])
    got = lstm_seq_quantized(
        torch.from_numpy(xs_pad), w, peep, bias, tqps[0].sig_lut,
        tqps[0].tanh_lut, torch.from_numpy(h0[0]), torch.from_numpy(c0[0]),
        torch.from_numpy(mask.astype(bool)), tile=TILE, cols_x=p0.cols_x)
    jw, jpeep, jbias = jops._dense_from_tiles(jqps[0])
    want = jkernel.lstm_seq_quantized(
        jnp.asarray(xs_pad), jw, jpeep, jbias,
        jqps[0].sig_lut.reshape(1, 256), jqps[0].tanh_lut.reshape(1, 256),
        jnp.asarray(h0[0]), jnp.asarray(c0[0]), jnp.asarray(mask),
        tile=TILE, cols_x=p0.cols_x, interpret=True)
    for g, wnt in zip(got, want):
        _eq(g, wnt)

    wts = stack_kernel_weights_q(tqps)
    acc_x = tsys.quantized_x_prefix(tqps[0], torch.from_numpy(xq))
    hs, cs = lstm_stack_seq_kernel_q(
        acc_x, wts.w_in, wts.w_h, wts.peep, wts.bias, wts.sig_lut,
        wts.tanh_lut, torch.from_numpy(h0), torch.from_numpy(c0),
        torch.from_numpy(mask.astype(bool)), tile=TILE)
    # the reference's own weight relayout, built as its stack op builds it:
    # (L, 2*padded_h, 4, padded_h) in (k, gate, n), layer 0's below-h block
    # zero.  The port keeps K3's (gate, n, k) rows and drops that block.
    jw_all = []
    for l, q in enumerate(jqps):
        dense, _, _ = jops._dense_from_tiles(q)
        _eq(wts.layers[l].w, dense)
        if l == 0:
            dense = jnp.zeros((4, p0.padded_h, 2 * p0.padded_h), jnp.int8
                              ).at[:, :, p0.padded_h:].set(
                                  dense[:, :, p0.padded_x:])
        jw_all.append(jnp.transpose(dense, (2, 0, 1)))
    jw = np.asarray(jnp.stack(jw_all))
    P_h = p0.padded_h
    assert not jw[0, :P_h].any()
    _eq(wts.w_h, jw[:, P_h:].transpose(0, 2, 3, 1))
    _eq(wts.w_in, jw[1:, :P_h].transpose(0, 2, 3, 1))
    hs_d, cs_d = jstack_kernel.lstm_stack_seq_kernel_q(
        jnp.asarray(acc_x.numpy()), jnp.asarray(jw),
        jnp.asarray(wts.peep.numpy()), jnp.asarray(wts.bias.numpy()),
        jqps[0].sig_lut.reshape(1, 256), jqps[0].tanh_lut.reshape(1, 256),
        jnp.asarray(h0), jnp.asarray(c0), jnp.asarray(mask), tile=TILE,
        cols_h=p0.cols_h, interpret=True)
    for got_l, want_d in ((hs, hs_d), (cs, cs_d)):
        _eq(got_l, np.stack([np.asarray(want_d)[l:l + T, l]
                             for l in range(L)]))


@pytest.fixture(scope='module')
def stack3_mono(stack3):
    """The reference's fused int8 stack over (T=9, B=3) from zero state
    with ragged lengths, and the reference chain of the silicon scan."""
    jqps, _ = stack3
    xq = _frames(4, 9, 3)
    lens = np.array([9, 4, 6])
    out, (jh, jc) = jstack_ops.lstm_stack_seq_quantized(
        jqps, jnp.asarray(xq), valid_len=jnp.asarray(lens, jnp.int32),
        return_state=True, interpret=True)
    h = jnp.asarray(xq)
    for q in jqps:
        h = jsys.systolic_layer_quantized(q, h)
    return xq, lens, np.asarray(out), np.asarray(jh), np.asarray(jc), \
        np.asarray(h)


@pytest.mark.parametrize('backend', ['fused', 'layerwise'])
def test_stack_seq_quantized_matches_reference(stack3, stack3_mono, backend):
    _, tqps = stack3
    xq, lens, want, jh, jc, chain = stack3_mono
    got, (th, tc) = lstm_stack_seq_quantized_auto(
        tqps, torch.from_numpy(xq), valid_len=torch.from_numpy(lens),
        return_state=True, backend=backend)
    for g, w in ((got, want), (th, jh), (tc, jc)):
        _eq(g, w)
    for b, n in enumerate(lens):            # the valid prefix is the chain's
        _eq(got[:n, b], chain[:n, b])
    # unmasked, the whole sequence is the reference chain
    _eq(lstm_stack_seq_quantized_auto(tqps, torch.from_numpy(xq),
                                      backend=backend), chain)


@pytest.mark.parametrize('backend', ['fused', 'layerwise'])
def test_chunked_carry_is_bit_identical_to_monolithic(stack3, stack3_mono,
                                                      backend):
    """3 ragged chunks with the opaque padded (h_q, c_q) carry == one
    monolithic call, and the carried codes == the reference's."""
    _, tqps = stack3
    xq, lens, want, jh, jc, _ = stack3_mono
    weights = stack_kernel_weights_q(tqps)
    state, outs = None, []
    for lo, hi in _chunks(9, 3):
        vl = torch.from_numpy(np.clip(lens - lo, 0, hi - lo))
        o, state = lstm_stack_seq_quantized_auto(
            tqps, torch.from_numpy(xq[lo:hi]), state=state, valid_len=vl,
            return_state=True, weights=weights, backend=backend)
        outs.append(o)
    _eq(torch.cat(outs), want)
    _eq(state[0], jh)
    _eq(state[1], jc)
    assert state[0].shape == (L, 3, tqps[0].plan.padded_h)


@pytest.mark.parametrize('backend', ['fused', 'layerwise'])
def test_chunks_reuse_prebuilt_weights(stack3, stack3_mono, backend,
                                       monkeypatch):
    """With ``weights`` given, no chunk relayouts a layer again: both
    backends read ``stack_kernel_weights_q``'s layouts."""
    from repro_torch.kernels.lstm_seq import ops as tops
    _, tqps = stack3
    xq, lens, want, _, _, _ = stack3_mono
    weights = stack_kernel_weights_q(tqps)
    built = []
    monkeypatch.setattr(tops, '_dense_from_tiles',
                        lambda qp: built.append(qp) or _dense_from_tiles(qp))
    state, outs = None, []
    for lo, hi in _chunks(9, 3):
        vl = torch.from_numpy(np.clip(lens - lo, 0, hi - lo))
        o, state = lstm_stack_seq_quantized_auto(
            tqps, torch.from_numpy(xq[lo:hi]), state=state, valid_len=vl,
            return_state=True, weights=weights, backend=backend)
        outs.append(o)
    _eq(torch.cat(outs), want)
    assert built == []
    # without weights the layerwise op builds its layer's layout itself
    xs = torch.from_numpy(xq)
    _eq(lstm_layer_seq_quantized(tqps[0], xs),
        lstm_layer_seq_quantized(tqps[0], xs, weights=weights.layers[0]))
    assert len(built) == 1


def test_backends_can_flip_between_chunks(stack3, stack3_mono):
    """Both backends speak the stack state layout: alternating them chunk
    by chunk gives the monolithic codes."""
    _, tqps = stack3
    xq, lens, want, jh, jc, _ = stack3_mono
    state, outs = None, []
    for k, (lo, hi) in enumerate(_chunks(9, 3)):
        vl = torch.from_numpy(np.clip(lens - lo, 0, hi - lo))
        o, state = lstm_stack_seq_quantized_auto(
            tqps, torch.from_numpy(xq[lo:hi]), state=state, valid_len=vl,
            return_state=True, backend=('fused', 'layerwise')[k % 2])
        outs.append(o)
    _eq(torch.cat(outs), want)
    _eq(state[1], jc)


def test_stack_op_direct_matches_auto_fused(stack3, stack3_mono):
    _, tqps = stack3
    xq, lens, want, _, _, _ = stack3_mono
    _eq(lstm_stack_seq_quantized(tqps, torch.from_numpy(xq),
                                 valid_len=torch.from_numpy(lens)), want)


# ------------------------------------------------------------- dispatch
def test_select_quantized_stack_backend_matches_reference_cold_cache():
    from repro.tune.schedule import current_schedule_cache
    assert current_schedule_cache() is None
    for n_h in (96, 255, 256, 421):
        for n_layers in (1, 2, 3):
            for T in (4, 7, 8, 16):
                for B in (1, 8):
                    assert tlstm.select_quantized_stack_backend(
                        n_h, n_layers, T, B, device='cpu') == \
                        jlstm.select_quantized_stack_backend(
                            n_h, n_layers, T, B), (n_h, n_layers, T, B)


def test_auto_on_cpu_runs_the_selected_shape(stack3):
    """At T >= 8, L = 3 but N_h = 32 < 256 ``auto`` is layerwise: three K3
    plain versions; the launch counters stay untouched on the CPU."""
    from repro_torch.kernels.lstm_seq import lstm_stack_seq_kernel_q as k4
    _, tqps = stack3
    xq = torch.from_numpy(_frames(5, 8, 2))
    n3, n4 = lstm_seq_quantized.launches, k4.launches
    out = lstm_stack_seq_quantized_auto(tqps, xq)
    _eq(out, lstm_stack_seq_quantized_auto(tqps, xq, backend='fused'))
    assert (lstm_seq_quantized.launches, k4.launches) == (n3, n4)


def test_bad_backends_and_stacks_raise(stack3):
    _, tqps = stack3
    xq = torch.from_numpy(_frames(6, 2, 2))
    with pytest.raises(ValueError):
        lstm_stack_seq_quantized_auto(tqps, xq, backend='pallas_seq_fused')
    mixed = _port(_jstack(7, n_layers=1) + _jstack(8, n_x=N_H, n_h=48,
                                                   n_layers=1))
    with pytest.raises(ValueError):
        lstm_stack_seq_quantized_auto(mixed, xq, backend='fused')
    bad = jax.tree.map(np.asarray, _jstack(9, n_layers=1)[0])
    with pytest.raises(ValueError):
        quantized_packed_from_numpy(
            bad._replace(bias_q=bad.bias_q.astype(np.int32)), 'cpu')
    with pytest.raises(ValueError):
        lstm_seq_quantized(torch.zeros((2, 1, 16), dtype=torch.int8),
                           torch.zeros((4, 16, 32), dtype=torch.int8),
                           None, None, None, None, tile=16, cols_x=2)


# ------------------------------------------------------ dequantized read-out
def test_dequantized_readout_matches_reference(stack3, stack3_mono):
    """The deployment tail of the int8 path (the reference's
    examples/speech_ctc.py): dequantize the top layer's codes, dense
    read-out, log_softmax."""
    _, tqps = stack3
    xq, lens, want, _, _, _ = stack3_mono
    rng = np.random.RandomState(13)
    w_out = rng.uniform(-1, 1, (7, N_H)).astype(np.float32)
    b_out = (rng.randn(7) * 0.1).astype(np.float32)
    codes = lstm_stack_seq_quantized_auto(tqps, torch.from_numpy(xq),
                                          valid_len=torch.from_numpy(lens))
    h = tquant.dequantize(codes, tquant.STATE_FMT)
    got = torch.log_softmax(tlstm.readout(torch.from_numpy(w_out),
                                          torch.from_numpy(b_out), h), dim=-1)
    h_j = jquant.dequantize(jnp.asarray(want), jquant.STATE_FMT)
    ref = jax.nn.log_softmax(jnp.einsum('oh,tbh->tbo', w_out, h_j) + b_out,
                             axis=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
