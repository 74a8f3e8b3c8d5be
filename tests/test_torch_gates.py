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
from repro_torch.kernels.lstm_gates import (gates_geometry,  # noqa: E402
                                            gates_rec_geometry,
                                            lstm_gates_rec,
                                            lstm_gates_rec_ref,
                                            lstm_gates_ref,
                                            lstm_layer_fused)
from repro_torch.kernels.lstm_gates.kernel import (  # noqa: E402
    gates_smem_bytes)

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


@pytest.mark.parametrize('return_state', [None, False, True])
def test_step_op_matches_scan(return_state):
    """The op's contract is the reference's
    (``repro.kernels.lstm_gates.ops.lstm_layer_fused``): ``hs`` alone by
    default and with ``return_state=False``, (hs, (h_T, c_T)) with
    ``return_state=True``."""
    port = stack_params_from_numpy(
        {'layers': [_np_layer(11, 13, 32)], 'w_out': None, 'b_out': None},
        'cpu').layers[0]
    xs, h0, c0 = _t(_x(12, 6, 3, 13)), _t(_x(13, 3, 32)), _t(_x(14, 3, 32))
    kw = {} if return_state is None else dict(return_state=return_state)
    out = lstm_layer_fused(port, xs, h0, c0, **kw)
    ref_hs, (ref_h, ref_c) = tlstm.lstm_layer(port, xs, h0, c0)
    if not return_state:
        assert isinstance(out, torch.Tensor)
        torch.testing.assert_close(out, ref_hs, rtol=1e-5, atol=1e-6)
        jout = jgates.lstm_layer_fused(
            jax.tree.map(jnp.asarray, _np_layer(11, 13, 32)),
            jnp.asarray(xs.numpy()), h0=jnp.asarray(h0.numpy()),
            c0=jnp.asarray(c0.numpy()), use_pallas=False, **kw)
        assert not isinstance(jout, tuple)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   rtol=RTOL, atol=ATOL)
        return
    hs, (h_T, c_T) = out
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
    assert (geom.rows, geom.ctas, geom.stages) == (4, 106, 1)
    # mbarriers | weight slab, 4 spans of 4 rows | one ring slot (8 streams'
    # h, then pre and c_prev) | gate sums of 2 K splits | peep, bias
    assert geom.smem_bytes == (16 + 4 * (4 * 4 * 421 + 16)
                               + (4 * 8 * 421 + 16) + 4 * 5 * 4 * 8
                               + 4 * 2 * 4 * 32 + 4 * 8 * 4)
    assert geom.admissible()
    # a plain launch: no co-residency bound, only shared memory; B = 200
    # streams its 25 input chunks through the ring slots that fit
    big = gates_rec_geometry(421, 200, 132)
    assert big.admissible() and 1 < big.stages < 25
    # rows too long for the weight slab: the unstaged form, no ring slots
    long_rows = gates_geometry(37, 16037, 9, 132)
    assert long_rows.stages == 0 and long_rows.admissible()
    assert not gates_rec_geometry(2000, 8, 1).admissible()
    port = stack_params_from_numpy(
        {'layers': [_np_layer(19, 13, 32)], 'w_out': None, 'b_out': None},
        'cpu')
    assert tlstm.resolve_serving_backend(port, 'cuda_step', 4, 2,
                                         'cpu') == 'cuda_step'
    assert 'cuda_step' in tlstm.BACKENDS


@pytest.mark.parametrize('sms', [1, 78, 132])
@pytest.mark.parametrize('n_h', [1, 3, 37, 131, 132, 133, 421, 1000])
def test_gates_geometry_covers_every_row_once(n_h, sms):
    """CTA i takes rows i R .. i R + R - 1 (the last one fewer): every
    hidden row once; 106 CTAs of 4 rows at N_h = 421 on 132 SMs."""
    geom = gates_geometry(n_h, n_h, 8, sms)
    rows = [r for cta in range(geom.ctas)
            for r in range(cta * geom.rows, min((cta + 1) * geom.rows, n_h))]
    assert rows == list(range(n_h))
    assert geom.rows == max(1, -(-n_h // sms))
    if (n_h, sms) == (421, 132):
        assert (geom.rows, geom.ctas) == (4, 106)


def test_gates_geometry_admits_every_shape_the_parent_did():
    """The one-input-copy-per-CTA schedule admitted 4 (B K + 4 R B) bytes of
    shared memory up to 232,448; the staged schedule refuses none of those
    shapes (a large B streams its input through fewer ring slots)."""
    for n_h in (3, 37, 421):
        for k in (n_h, 123 + n_h, 2 * n_h):
            rows = max(1, -(-n_h // 132))
            for b in range(1, 133):
                if 4 * (b * k + 4 * rows * b) <= 232_448:
                    geom = gates_geometry(n_h, k, b, 132)
                    assert geom.admissible(), (n_h, k, b, geom)
                    assert 1 <= geom.stages <= -(-b // 8)
                    assert geom.smem_bytes == gates_smem_bytes(
                        b, k, geom.rows, geom.stages)


def test_step_forward_overlaps_every_launch_but_the_first(monkeypatch):
    """``_step_forward`` flags launches 2 .. T as following the K5 launch
    that wrote their h and c (programmatic dependent launch on the card),
    never the first, whose predecessor is unknown; the public op takes no
    such flag, so its launches are always stream-ordered."""
    import inspect
    from repro_torch.kernels.lstm_gates import ops
    flags = []

    def spy(h, w_h, pre, peep, bias, c, *, early):
        flags.append(early)
        return lstm_gates_rec_ref(h, w_h, pre, peep, bias, c)

    monkeypatch.setattr(ops, '_gates_rec', spy)
    p = _np_layer(21, 5, 8)
    ops._step_forward(*map(_t, (p.w_h, p.w_peep, p.b, _x(22, 4, 2, 4, 8),
                                _x(23, 2, 8), _x(24, 2, 8))))
    assert flags == [False, True, True, True]
    assert list(inspect.signature(lstm_gates_rec).parameters) == [
        'h', 'w_h', 'pre', 'peep', 'bias', 'c_prev']


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
