"""Parity of the port's quantization-aware-training op and accumulator
requantization (``repro_torch.core.quant.fake_quant``, ``requantize``)
with the JAX reference.

Inputs are made with numpy from a seed and handed to both packages.  No
tolerance applies anywhere: ``fake_quant``'s forward is a round and a
scale (``torch.equal`` / ``np.array_equal``), its gradient is the upstream
gradient times a 0/1 mask (equal bit for bit), and ``requantize`` is
integer arithmetic.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from repro.core import quant as jquant  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.core import systolic as tsys  # noqa: E402

FORMATS = [tquant.STATE_FMT, tquant.GATE_FMT, tsys.ACC_FMT, tsys.CELL_FMT]


def _jfmt(fmt):
    return jquant.QFormat(fmt.int_bits, fmt.frac_bits)


def _inputs(fmt, seed):
    """Seeded values over twice the format's range, plus its two ends,
    one step past each end, zero and a half-step tie."""
    rng = np.random.RandomState(seed)
    lo, hi = fmt.min_val, fmt.max_val
    edges = [lo, hi, lo - fmt.scale, hi + fmt.scale, 0.0, 0.5 * fmt.scale,
             -2.5 * fmt.scale]
    x = rng.uniform(2 * lo, 2 * hi, 57).astype(np.float32)
    return np.concatenate([x, np.asarray(edges, np.float32)])


@pytest.mark.parametrize('fmt', FORMATS, ids=lambda f: f'Q{f.int_bits}.'
                         f'{f.frac_bits}')
@pytest.mark.parametrize('seed', [0, 1])
def test_fake_quant_forward_and_gradient_match_reference(fmt, seed):
    x = _inputs(fmt, seed)
    w = np.random.RandomState(seed + 100).randn(x.size).astype(np.float32)
    jf = _jfmt(fmt)
    want = np.asarray(jquant.fake_quant(jnp.asarray(x), jf))
    want_g = np.asarray(jax.grad(
        lambda v: (jquant.fake_quant(v, jf) * jnp.asarray(w)).sum())(
            jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tquant.fake_quant(xt, fmt)
    (got * torch.from_numpy(w)).sum().backward()
    assert torch.equal(got.detach(), torch.tensor(want))
    assert torch.equal(xt.grad, torch.tensor(want_g))
    # the clipped straight-through estimator: zero exactly outside the range
    inside = (x >= fmt.min_val) & (x <= fmt.max_val)
    assert inside.any() and (~inside).any()
    np.testing.assert_array_equal(want_g[~inside], 0.0)


def test_fake_quant_reference_case():
    """The reference's own case (``tests/test_quant.py``): -5 is outside
    Q2.5, so its gradient is masked."""
    x = torch.tensor([0.1, 3.0, -5.0], requires_grad=True)
    tquant.fake_quant(x, tquant.STATE_FMT).sum().backward()
    assert x.grad.tolist() == [1.0, 1.0, 0.0]


@pytest.mark.parametrize('acc_fmt,out_fmt', [
    (tsys.ACC_FMT, tquant.STATE_FMT),        # shift 5
    (tsys.CELL_FMT, tquant.STATE_FMT),       # shift 7
    (tsys.CELL_FMT, tquant.GATE_FMT),        # shift 5
    (tquant.STATE_FMT, tquant.STATE_FMT),    # shift 0
    (tquant.STATE_FMT, tsys.ACC_FMT),        # shift -5
    (tquant.GATE_FMT, tsys.CELL_FMT),        # shift -5
], ids=lambda f: f'Q{f.int_bits}.{f.frac_bits}')
@pytest.mark.parametrize('seed', [0, 1])
def test_requantize_matches_reference(acc_fmt, out_fmt, seed):
    """Positive, zero and negative shifts, with accumulators that saturate
    the output format at both ends and exact rounding ties."""
    rng = np.random.RandomState(seed)
    shift = acc_fmt.frac_bits - out_fmt.frac_bits
    span = 2 ** (acc_fmt.bits - 1)
    acc = rng.randint(-span, span, 200).astype(np.int32)
    ties = ((np.arange(-8, 8) * 2 + 1) << (shift - 1)).astype(np.int32) \
        if shift > 0 else np.arange(-8, 8, dtype=np.int32)
    acc = np.concatenate([acc, ties, np.int32([span - 1, -span, 0])])
    want = np.asarray(jquant.requantize(jnp.asarray(acc), _jfmt(acc_fmt),
                                        _jfmt(out_fmt)))
    got = tquant.requantize(torch.from_numpy(acc), acc_fmt, out_fmt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    lo, hi = -(2 ** (out_fmt.bits - 1)), 2 ** (out_fmt.bits - 1) - 1
    if shift >= 0:   # the random accumulators reach both clip bounds
        assert (want == lo).any() and (want == hi).any()
