"""K6 (``lstm_gates``, the fused LSTM cell) and its public op
``lstm_cell_fused`` against the JAX reference on the CPU.

Weights and inputs are made with numpy from a seed and cross into the port
through ``repro_torch.convert``.  JAX's Pallas kernel runs in interpret
mode, as the reference's own tests run it; the port's K6 wrapper runs its
plain PyTorch version on CPU tensors.  Tolerance rtol 1e-5, atol 1e-6 (the
reference's own bound for ``lstm_cell_fused`` against ``lstm_cell``,
``tests/test_kernels.py``): one step, the gate sums in another order.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

from repro.core import lstm as jlstm  # noqa: E402
from repro.kernels import lstm_gates as jgates  # noqa: E402
from repro_torch.convert import stack_params_from_numpy  # noqa: E402
from repro_torch.kernels.lstm_gates import (gates_geometry,  # noqa: E402
                                            gates_rec_geometry, lstm_cell_fused,
                                            lstm_gates, lstm_gates_ref)

RTOL, ATOL = 1e-5, 1e-6


def _np_layer(seed, n_x, n_h):
    rng = np.random.RandomState(seed)
    u = lambda *s: (rng.uniform(-1, 1, s) / np.sqrt(s[-1])).astype(np.float32)
    return jlstm.LSTMParams(
        w_x=u(4, n_h, n_x), w_h=u(4, n_h, n_h),
        w_peep=(rng.uniform(-1, 1, (3, n_h)) * 0.1).astype(np.float32),
        b=(rng.randn(4, n_h) * 0.1).astype(np.float32))


def _x(seed, *shape):
    return (np.random.RandomState(seed).randn(*shape) * 0.5).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize('n_x,n_h,b', [(96, 421, 2), (100, 150, 4)])
def test_lstm_cell_fused_matches_reference(n_x, n_h, b):
    """The port's op against the reference's (Pallas, interpreted) and its
    paper-equation cell ``lstm_cell``; 421 is the paper's layer width."""
    ref = _np_layer(n_x + n_h, n_x, n_h)
    x, h0, c0 = _x(1, b, n_x), _x(2, b, n_h), _x(3, b, n_h)
    jp = jax.tree.map(np.asarray, ref)
    jh, jc = jgates.lstm_cell_fused(jp, x, h0, c0)
    eh, ec = jlstm.lstm_cell(jp, x, h0, c0)
    port = stack_params_from_numpy(
        {'layers': [ref], 'w_out': None, 'b_out': None}, 'cpu').layers[0]
    th, tc = lstm_cell_fused(port, _t(x), _t(h0), _t(c0))
    assert th.shape == tc.shape == (b, n_h)
    for got, want in ((th, jh), (tc, jc), (th, eh), (tc, ec)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_lstm_gates_plain_version_matches_interpreted_tpu_kernel():
    """The K6 wrapper on CPU tensors is its plain version, bit for bit,
    and agrees with the reference's kernel at a block-aligned shape."""
    p = _np_layer(7, 32, 32)
    w = np.concatenate([p.w_x, p.w_h], axis=-1)
    xh, c = _x(8, 3, 64), _x(9, 3, 32)
    jh, jc = jgates.lstm_gates(xh, w, p.w_peep, p.b, c, bn=16, bk=32,
                               interpret=True)
    args = tuple(map(_t, (xh, w, p.w_peep, p.b, c)))
    th, tc = lstm_gates(*args)
    rh, rc = lstm_gates_ref(*args)
    assert torch.equal(th, rh) and torch.equal(tc, rc)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL,
                               atol=ATOL)


def test_gates_geometry_of_k5_and_k6():
    """K6 at the paper's layer 0 (N_x 123 -> N_h 421, N_in 544) and an inner
    layer (N_in 842), B = 8, on 132 SMs; K5's geometry is K6's with rows of
    length N_h."""
    for n_in in (544, 842):
        geom = gates_geometry(421, n_in, 8, 132)
        assert (geom.rows, geom.ctas, geom.stages) == (4, 106, 1)
        # mbarriers, 4 weight spans of 4 rows, one 8-stream slot with its
        # pre and c_prev, 2 K splits' gate sums, peep and bias
        assert geom.smem_bytes == (16 + 4 * (16 * n_in + 16) + 32 * n_in
                                   + 16 + 640 + 1024 + 128)
        assert geom.admissible()
    assert gates_rec_geometry(421, 8, 132) == gates_geometry(421, 421, 8, 132)
    # B = 80 at the inner layer: 10 input chunks through 6 ring slots
    assert gates_geometry(421, 842, 80, 132).stages == 6
    assert gates_geometry(421, 842, 80, 132).admissible()


def test_lstm_gates_refuses_other_devices():
    t = lambda *s: torch.empty(*s, device='meta')
    with pytest.raises(ValueError):
        lstm_gates(t(2, 12), t(4, 8, 12), t(3, 8), t(4, 8), t(2, 8))
