"""K5 (``lstm_gates_rec``) and the ``cuda_step`` backend of the port against
the JAX reference on the CPU.

Inputs and weights are made with numpy from a seed; weights cross into the
port through ``repro_torch.convert``.  JAX's Pallas kernels run in interpret
mode, as the reference's own tests run them; the port's K5 wrapper runs its
plain PyTorch version on CPU tensors.  Tolerances: K5's plain version
against the interpreted TPU kernel atol 1e-6 (one step, sums in another
order); the ``cuda_step`` layer and its gradients against the reference's
``pallas_step`` rtol 1e-4, atol 1e-5 per leaf (the reference's own bound
for its kernel VJPs, ``tests/test_lstm_seq.py``).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from repro.core import lstm as jlstm  # noqa: E402
from repro.kernels import lstm_gates as jgates  # noqa: E402
from repro_torch.convert import stack_params_from_numpy  # noqa: E402
from repro_torch.core import lstm as tlstm  # noqa: E402
from repro_torch.kernels.lstm_gates import (gates_rec_geometry,  # noqa: E402
                                            lstm_gates_rec,
                                            lstm_gates_rec_ref,
                                            lstm_gates_ref,
                                            lstm_layer_fused)

RTOL, ATOL = 1e-4, 1e-5


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
    return torch.from_numpy(np.asarray(a))


def test_gates_rec_plain_version_matches_interpreted_tpu_kernel():
    p = _np_layer(0, 32, 32)
    B, N = 3, 32
    h, c, pre = _x(1, B, N), _x(2, B, N), _x(3, B, 4, N)
    jh, jc = jgates.lstm_gates_rec(h, p.w_h, pre, p.w_peep, p.b, c, bn=16,
                                   bk=16, interpret=True)
    args = tuple(map(_t, (h, p.w_h, pre, p.w_peep, p.b, c)))
    th, tc = lstm_gates_rec_ref(*args)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    # on CPU tensors the wrapper is the plain version
    got = lstm_gates_rec(*args)
    assert torch.equal(got[0], th) and torch.equal(got[1], tc)


def test_packed_cell_oracle_matches_reference():
    p = _np_layer(4, 13, 32)
    w = np.concatenate([p.w_x, p.w_h], axis=-1)
    xh, c = _x(5, 3, 45), _x(6, 3, 32)
    jh, jc = jgates.lstm_gates_ref(xh, w, p.w_peep, p.b, c)
    th, tc = lstm_gates_ref(*map(_t, (xh, w, p.w_peep, p.b, c)))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)


def test_cuda_step_layer_and_grads_match_reference_pallas_step():
    """The reference's kernel-VJP test (tests/test_lstm_seq.py) on both
    packages: outputs, final state and the gradients of
    sum(hs^2) + sum(h_T * c_T)."""
    ref = _np_layer(9, 32, 32)
    xs = _x(1, 5, 2, 32)

    def jloss(params):
        hs, (h_T, c_T) = jlstm.lstm_layer_fused(params, jnp.asarray(xs),
                                                backend='pallas_step')
        return jnp.sum(hs ** 2) + jnp.sum(h_T * c_T), (hs, h_T, c_T)

    (jl, jouts), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, ref))
    port = stack_params_from_numpy(
        {'layers': [ref], 'w_out': None, 'b_out': None}, 'cpu').layers[0]
    leaves = [t.requires_grad_(True) for t in
              (port.w_x, port.w_h, port.w_peep, port.b)]
    hs, (h_T, c_T) = tlstm.lstm_layer_fused(port, _t(xs), backend='cuda_step')
    loss = (hs ** 2).sum() + (h_T * c_T).sum()
    loss.backward()
    for got, want in zip((hs, h_T, c_T), jouts):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    for name, leaf, want in zip(ref._fields, leaves, jg):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_step_op_matches_scan():
    port = stack_params_from_numpy(
        {'layers': [_np_layer(11, 13, 32)], 'w_out': None, 'b_out': None},
        'cpu').layers[0]
    xs, h0, c0 = _t(_x(12, 6, 3, 13)), _t(_x(13, 3, 32)), _t(_x(14, 3, 32))
    hs, (h_T, c_T) = lstm_layer_fused(port, xs, h0, c0)
    ref_hs, (ref_h, ref_c) = tlstm.lstm_layer(port, xs, h0, c0)
    for a, b in ((hs, ref_hs), (h_T, ref_h), (c_T, ref_c)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_masked_chunk_on_cuda_step_is_the_masked_scan():
    """K5 has no masked form: with a ``valid_len`` on CPU tensors,
    ``cuda_step`` runs the masked torch scan (the reference's rule), bit for
    bit."""
    port = stack_params_from_numpy(
        {'layers': [_np_layer(15, 13, 32)], 'w_out': None, 'b_out': None},
        'cpu').layers[0]
    xs, h0, c0 = _t(_x(16, 7, 3, 13)), _t(_x(17, 3, 32)), _t(_x(18, 3, 32))
    vl = torch.tensor([7, 0, 4])
    n0 = lstm_gates_rec.launches
    got = tlstm.lstm_layer_chunk(port, xs, h0, c0, valid_len=vl,
                                 backend='cuda_step')
    want = tlstm.lstm_layer_chunk(port, xs, h0, c0, valid_len=vl,
                                  backend='torch_scan')
    assert lstm_gates_rec.launches == n0
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


def test_gates_rec_geometry_and_dispatch():
    geom = gates_rec_geometry(421, 8, 132)
    assert (geom.rows, geom.ctas) == (4, 106)
    assert geom.smem_bytes == 4 * (8 * 421 + 4 * 4 * 8)
    assert geom.admissible()
    # a plain launch: no co-residency bound, only shared memory
    assert not gates_rec_geometry(421, 200, 132).admissible()
    port = stack_params_from_numpy(
        {'layers': [_np_layer(19, 13, 32)], 'w_out': None, 'b_out': None},
        'cpu')
    assert tlstm.resolve_serving_backend(port, 'cuda_step', 4, 2,
                                         'cpu') == 'cuda_step'
    assert 'cuda_step' in tlstm.BACKENDS


def test_cuda_step_is_no_serving_backend_on_the_card():
    """Serving chunks are masked and K5 has no masked form, so the
    resolver refuses ``cuda_step`` on a CUDA device (before it asks the
    card anything); unmasked — the training path — it is admitted, and on
    the CPU it stays the masked scan's name."""
    port = stack_params_from_numpy(
        {'layers': [_np_layer(20, 13, 32)], 'w_out': None, 'b_out': None},
        'cpu')
    with pytest.raises(ValueError, match='no masked form'):
        tlstm.resolve_serving_backend(port, 'cuda_step', 4, 2, 'cuda')
    for masked in (True, False):
        assert tlstm.resolve_serving_backend(
            port, 'cuda_step', 4, 2, 'cpu', masked=masked) == 'cuda_step'


def test_gates_rec_refuses_other_devices():
    t = lambda *s: torch.empty(*s, device='meta')
    with pytest.raises(ValueError):
        lstm_gates_rec(t(2, 8), t(4, 8, 8), t(2, 4, 8), t(3, 8), t(4, 8),
                       t(2, 8))
