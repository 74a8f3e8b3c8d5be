"""Parity of the port's LSTM core and kernel ops with the JAX reference.

Inputs and weights are made with numpy from a seed; weights cross into the
port through ``repro_torch.convert``.  The JAX Pallas kernels run in
interpret mode on the CPU, as the reference's own tests run them; the port's
kernel wrappers run their plain PyTorch versions on CPU tensors.  Tolerance
of every f32 parity check: rtol=1e-5, atol=1e-6 (the two frameworks sum the
same products in other orders).  The port's own contracts (chunked ==
monolithic, masked steps are identities) hold bit for bit (``torch.equal``).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from repro.core import lstm as jlstm  # noqa: E402
from repro.kernels.lstm_seq import lstm_layer_seq as j_layer_seq  # noqa: E402
from repro.kernels.lstm_seq import lstm_stack_seq as j_stack_seq  # noqa: E402
from repro_torch.convert import stack_params_from_numpy  # noqa: E402
from repro_torch.core import lstm as tlstm  # noqa: E402
from repro_torch.kernels.lstm_seq import (lstm_layer_seq, lstm_seq,  # noqa: E402
                                          lstm_stack_seq,
                                          lstm_stack_seq_kernel,
                                          seq_geometry, stack_geometry,
                                          stack_kernel_weights)

RTOL, ATOL = 1e-5, 1e-6
N_X, N_H = 13, 32


def _np_stack(seed, n_x=N_X, n_h=N_H, n_layers=2, n_out=None):
    """A reference ``LSTMStackParams`` of numpy arrays, drawn from a seed."""
    rng = np.random.RandomState(seed)
    u = lambda *s: (rng.uniform(-1, 1, s) / np.sqrt(s[-1])).astype(np.float32)
    layers = tuple(jlstm.LSTMParams(
        w_x=u(4, n_h, n_x if l == 0 else n_h), w_h=u(4, n_h, n_h),
        w_peep=(rng.uniform(-1, 1, (3, n_h)) * 0.1).astype(np.float32),
        b=(rng.randn(4, n_h) * 0.1).astype(np.float32))
        for l in range(n_layers))
    w_out = None if n_out is None else u(n_out, n_h)
    b_out = None if n_out is None else (rng.randn(n_out) * 0.1).astype(
        np.float32)
    return jlstm.LSTMStackParams(layers, w_out, b_out)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _x(seed, *shape):
    return (np.random.RandomState(seed).randn(*shape) * 0.5).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _chunks(total, chunk):
    return [(lo, min(lo + chunk, total)) for lo in range(0, total, chunk)]


# ------------------------------------------------------------ (a) core math
def test_lstm_cell_and_layer_match_reference():
    ref = _np_stack(0, n_layers=1)
    port = stack_params_from_numpy(ref, 'cpu')
    xs, h0, c0 = _x(1, 7, 3, N_X), _x(2, 3, N_H), _x(3, 3, N_H)
    jp, tp = _jax(ref.layers[0]), port.layers[0]
    h, c = tlstm.lstm_cell(tp, torch.from_numpy(xs[0]), torch.from_numpy(h0),
                           torch.from_numpy(c0))
    jh, jc = jlstm.lstm_cell(jp, xs[0], h0, c0)
    _close(h, jh)
    _close(c, jc)
    hs, (hT, cT) = tlstm.lstm_layer(tp, torch.from_numpy(xs),
                                    torch.from_numpy(h0), torch.from_numpy(c0))
    jhs, (jhT, jcT) = jlstm.lstm_layer(jp, xs, h0, c0)
    for a, b in ((hs, jhs), (hT, jhT), (cT, jcT)):
        _close(a, b)


def test_masked_scan_matches_reference():
    ref = _np_stack(4, n_layers=1)
    port = stack_params_from_numpy(ref, 'cpu')
    xs, h0, c0 = _x(5, 9, 4, N_X), _x(6, 4, N_H), _x(7, 4, N_H)
    lens = np.array([9, 0, 4, 6])
    hs, (hT, cT) = tlstm.lstm_layer_chunk(
        port.layers[0], torch.from_numpy(xs), torch.from_numpy(h0),
        torch.from_numpy(c0), valid_len=torch.from_numpy(lens),
        backend='torch_scan')
    jhs, (jhT, jcT) = jlstm.lstm_layer_chunk(
        _jax(ref.layers[0]), jnp.asarray(xs), h0, c0,
        valid_len=jnp.asarray(lens), backend='xla_scan')
    for a, b in ((hs, jhs), (hT, jhT), (cT, jcT)):
        _close(a, b)
    # a stream with no live step keeps its carry exactly
    assert torch.equal(hT[1], torch.from_numpy(h0[1]))
    assert torch.equal(cT[1], torch.from_numpy(c0[1]))


# --------------------------------------------------- (b), (c) kernel ops
def test_lstm_layer_seq_matches_reference_kernel():
    ref = _np_stack(8, n_layers=1)
    port = stack_params_from_numpy(ref, 'cpu')
    xs, h0, c0 = _x(9, 8, 3, N_X), _x(10, 3, N_H), _x(11, 3, N_H)
    lens = np.array([8, 3, 5])
    hs, (hT, cT) = lstm_layer_seq(
        port.layers[0], torch.from_numpy(xs), torch.from_numpy(h0),
        torch.from_numpy(c0), valid_len=torch.from_numpy(lens))
    jhs, (jhT, jcT) = j_layer_seq(
        _jax(ref.layers[0]), jnp.asarray(xs), jnp.asarray(h0),
        jnp.asarray(c0), valid_len=jnp.asarray(lens), interpret=True)
    for a, b in ((hs, jhs), (hT, jhT), (cT, jcT)):
        _close(a, b)


@pytest.mark.parametrize('n_layers', [2, 3])
def test_lstm_stack_seq_matches_reference_kernel(n_layers):
    ref = _np_stack(12 + n_layers, n_layers=n_layers)
    port = stack_params_from_numpy(ref, 'cpu')
    xs = _x(13, 7, 3, N_X)
    states = [(_x(20 + l, 3, N_H), _x(30 + l, 3, N_H))
              for l in range(n_layers)]
    lens = np.array([7, 2, 5])
    ys, finals = lstm_stack_seq(
        port, torch.from_numpy(xs),
        [tuple(map(torch.from_numpy, s)) for s in states],
        valid_len=torch.from_numpy(lens))
    jys, jfinals = j_stack_seq(_jax(ref), jnp.asarray(xs), states,
                               valid_len=jnp.asarray(lens), interpret=True)
    _close(ys, jys)
    for (h, c), (jh, jc) in zip(finals, jfinals):
        _close(h, jh)
        _close(c, jc)


def test_stack_kernel_layer_major_matches_layerwise_plain_kernel():
    """K2's plain version gives every layer's trajectory layer-major, and
    each layer equals K1's plain version fed the layer below's output."""
    ref = _np_stack(40, n_layers=3)
    port = stack_params_from_numpy(ref, 'cpu')
    wts = stack_kernel_weights(port)
    T, B = 6, 2
    xs = torch.from_numpy(_x(41, T, B, N_X))
    h0 = torch.from_numpy(_x(42, 3, B, N_H))
    c0 = torch.from_numpy(_x(43, 3, B, N_H))
    mask = tlstm.valid_len_mask(T, torch.tensor([6, 4]), B)
    pre = tlstm.hoisted_input(port.layers[0].w_x, xs)
    hs, cs = lstm_stack_seq_kernel(pre, wts.w_in, wts.w_h, wts.peep, wts.b,
                                   h0, c0, mask)
    assert hs.shape == (3, T, B, N_H) and cs.shape == hs.shape
    below = None
    for l, lp in enumerate(port.layers):
        pre_l = pre if l == 0 else tlstm.hoisted_input(lp.w_x, below)
        hl, cl = lstm_seq(pre_l, lp.w_h, lp.w_peep, lp.b, h0[l], c0[l], mask)
        torch.testing.assert_close(hs[l], hl, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(cs[l], cl, rtol=RTOL, atol=ATOL)
        below = hl


# ------------------------------------------- chunked == monolithic (port)
@pytest.mark.parametrize('backend', ['torch_scan', 'cuda_seq',
                                     'cuda_seq_fused'])
def test_stack_chunked_equals_monolithic_bit_equal(backend):
    ref = _np_stack(50, n_layers=2, n_out=5)
    port = stack_params_from_numpy(ref, 'cpu')
    xs = torch.from_numpy(_x(51, 12, 3, N_X))
    lens = np.array([12, 7, 9])
    mono, fin_m = tlstm.lstm_stack_chunk(
        port, xs, None, valid_len=torch.from_numpy(lens), backend=backend)
    states, outs = None, []
    for lo, hi in _chunks(12, 4):
        vl = torch.from_numpy(np.clip(lens - lo, 0, hi - lo))
        o, states = tlstm.lstm_stack_chunk(port, xs[lo:hi], states,
                                           valid_len=vl, backend=backend)
        outs.append(o)
    assert torch.equal(torch.cat(outs), mono)
    for (h, c), (hm, cm) in zip(states, fin_m):
        assert torch.equal(h, hm) and torch.equal(c, cm)
    # allclose to the reference's unmasked stack on each valid prefix
    jys, _ = jlstm.lstm_stack_apply(_jax(ref), jnp.asarray(xs.numpy()),
                                    backend='xla_scan')
    for b, L in enumerate(lens):
        _close(mono[:L, b], jys[:L, b])


def test_backends_agree_on_cpu():
    port = stack_params_from_numpy(_np_stack(60, n_layers=3, n_out=4), 'cpu')
    xs = torch.from_numpy(_x(61, 6, 2, N_X))
    vl = torch.tensor([6, 3])
    outs = [tlstm.lstm_stack_chunk(port, xs, None, valid_len=vl, backend=b)[0]
            for b in ('torch_scan', 'cuda_seq', 'cuda_seq_fused')]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------- dispatch
def test_auto_on_cpu_is_torch_scan_and_fused_needs_homogeneous_stack():
    port = stack_params_from_numpy(_np_stack(70, n_layers=2), 'cpu')
    assert tlstm.resolve_serving_backend(port, 'auto', 4, 2, 'cpu') == \
        'torch_scan'
    assert tlstm.resolve_serving_backend(port, 'cuda_seq_fused', 4, 2,
                                         'cpu') == 'cuda_seq_fused'
    hetero = stack_params_from_numpy(_np_stack(71, n_layers=1), 'cpu')
    hetero = tlstm.LSTMStackParams(
        hetero.layers + stack_params_from_numpy(
            _np_stack(72, n_x=N_H, n_h=16, n_layers=1), 'cpu').layers,
        None, None)
    with pytest.raises(ValueError):
        tlstm.resolve_serving_backend(hetero, 'cuda_seq_fused', 4, 2, 'cpu')
    with pytest.raises(ValueError):
        tlstm.resolve_serving_backend(port, 'pallas_seq', 4, 2, 'cpu')


def test_launch_geometry_at_full_width():
    """Pure-shape admissibility on a 132-SM H100 at the serving shapes."""
    k1 = seq_geometry(421, 8, 132)
    assert (k1.rows, k1.ctas) == (4, 106) and k1.admissible(132)
    assert k1.smem_bytes == 4 * (4 * 4 * 421 + 8 * 421 + 5 * 4 * 8)
    k2 = stack_geometry(421, 3, 8, 132)
    assert (k2.rows, k2.ctas) == (10, 129) and k2.admissible(132)
    assert k2.smem_bytes < 232_448
    # too many streams: the h planes overflow one CTA's shared memory
    assert not stack_geometry(421, 3, 64, 132).admissible(132)
    # a grid larger than the co-resident CTAs is refused
    assert not k2.admissible(128)
