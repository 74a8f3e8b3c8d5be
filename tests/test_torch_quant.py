"""Parity of the port's fixed-point core (``repro_torch.core.quant``,
``repro_torch.core.systolic``) with the JAX reference.

Inputs are made with numpy from a seed and handed to both packages.  Every
integer result is compared with ``np.array_equal``: the int8 path is
bit-exact by contract, so no tolerance applies.  The float tiled cell is
held at rtol=1e-5, atol=1e-6 (the two frameworks sum the same products in
other orders).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from repro.core import lstm as jlstm  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core import systolic as jsys  # noqa: E402
from repro_torch.convert import quantized_packed_from_numpy  # noqa: E402
from repro_torch.core import lstm as tlstm  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.core import systolic as tsys  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
FORMATS = [tquant.STATE_FMT, tquant.GATE_FMT, tsys.ACC_FMT, tsys.CELL_FMT]


def _jfmt(fmt):
    return jquant.QFormat(fmt.int_bits, fmt.frac_bits)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _layer(seed, n_x, n_h, scale=1.0, peak=None):
    """One layer's f32 weights as numpy, for both packages.  With ``peak``
    every weight and peephole has magnitude in [0.9, 1] * peak, random
    sign (the saturation-heavy case)."""
    rng = np.random.RandomState(seed)
    if peak is None:
        u = lambda *s: (rng.uniform(-1, 1, s) * scale).astype(np.float32)
    else:
        u = lambda *s: (rng.choice([-1, 1], s) * rng.uniform(0.9, 1, s)
                        * peak).astype(np.float32)
    return dict(w_x=u(4, n_h, n_x), w_h=u(4, n_h, n_h), w_peep=u(3, n_h),
                b=(rng.randn(4, n_h) * scale).astype(np.float32))


def _packs(layer, n_x, n_h, tile):
    """(JAX QuantizedPackedLSTM, port QuantizedPackedLSTM) of one layer,
    each quantized by its own package."""
    jq = jsys.quantize_packed(jsys.pack_lstm(
        jlstm.LSTMParams(**{k: jnp.asarray(v) for k, v in layer.items()}),
        jsys.SystolicPlan(n_x, n_h, tile)))
    tq = tsys.quantize_packed(tsys.pack_lstm(
        tlstm.LSTMParams(**{k: torch.from_numpy(v) for k, v in layer.items()}),
        tsys.SystolicPlan(n_x, n_h, tile)))
    return jq, tq


def _codes(seed, *shape, lo=-128, hi=128):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(np.int8)


# -------------------------------------------------------------- quant.py
def test_formats_match_reference():
    for name in ('WEIGHT_FMT', 'STATE_FMT', 'GATE_FMT'):
        t, j = getattr(tquant, name), getattr(jquant, name)
        assert (t.int_bits, t.frac_bits, t.bits, t.scale, t.max_val,
                t.min_val) == (j.int_bits, j.frac_bits, j.bits, j.scale,
                               j.max_val, j.min_val)
    for t, j in ((tsys.ACC_FMT, jsys.ACC_FMT), (tsys.CELL_FMT, jsys.CELL_FMT)):
        assert (t.int_bits, t.frac_bits) == (j.int_bits, j.frac_bits)


@pytest.mark.parametrize('fmt', FORMATS, ids=lambda f: f'Q{f.int_bits}.'
                         f'{f.frac_bits}')
def test_quantize_and_dequantize_match_reference(fmt):
    rng = np.random.RandomState(0)
    # every rounding midpoint of the code range and beyond it (odd
    # numerators over 2: negative and positive half-way values), plus
    # random values past both ends
    half = 2 ** (fmt.bits - 1)
    mids = (np.arange(-half - 3, half + 3) + 0.5) * fmt.scale
    x = np.concatenate([mids, rng.randn(500) * fmt.max_val * 1.5,
                        [0.0, -0.0, fmt.max_val, fmt.min_val]])
    x = x.astype(np.float32)
    q_t = tquant.quantize(torch.from_numpy(x), fmt)
    q_j = jquant.quantize(jnp.asarray(x), _jfmt(fmt))
    _eq(q_t, q_j)
    _eq(tquant.dequantize(q_t, fmt), jquant.dequantize(q_j, _jfmt(fmt)))


def test_rshift_round_matches_reference_at_negative_midpoints():
    # odd multiples of 2^(s-1) are the exact rounding midpoints
    x = np.concatenate([np.arange(-4100, 4100),
                        np.random.RandomState(1).randint(-2 ** 20, 2 ** 20,
                                                         4000)]).astype(np.int32)
    for s in (0, 1, 2, 5, 7, 9):
        _eq(tquant.rshift_round(torch.from_numpy(x), s),
            jquant.rshift_round(jnp.asarray(x), s))


def test_saturation_helpers_match_reference():
    a = np.random.RandomState(2).randint(-70000, 70000, 3000).astype(np.int32)
    b = np.random.RandomState(3).randint(-40000, 40000, 3000).astype(np.int32)
    _eq(tquant.saturate_int16(torch.from_numpy(a)),
        jquant.saturate_int16(jnp.asarray(a)))
    _eq(tquant.saturating_add_int16(torch.from_numpy(a), torch.from_numpy(b)),
        jquant.saturating_add_int16(jnp.asarray(a), jnp.asarray(b)))


def test_luts_and_apply_lut_match_reference():
    for fn_t, fn_j in ((tquant._SIGMOID, jquant._SIGMOID),
                       (tquant._TANH, jquant._TANH)):
        _eq(tquant.build_act_lut(fn_t, tquant.STATE_FMT),
            jquant.build_act_lut(fn_j, jquant.STATE_FMT))
    codes = np.arange(-128, 128).astype(np.int8)
    for lut_t, lut_j in zip(tquant.default_luts(device='cpu'),
                            jquant.default_luts()):
        _eq(lut_t, lut_j)
        _eq(tquant.apply_lut(lut_t, torch.from_numpy(codes), tquant.STATE_FMT),
            jquant.apply_lut(lut_j, jnp.asarray(codes), jquant.STATE_FMT))


# ------------------------------------------------------------ systolic.py
@pytest.mark.parametrize('n_x', [123, 421])
def test_quantize_packed_matches_reference_at_full_width(n_x):
    """The paper's layer plans, SystolicPlan(123|421, 421, 96): identical
    codes, with weights on exact rounding midpoints and past the Q2.5
    range, and biases past the Q5.10 range."""
    rng = np.random.RandomState(n_x)
    mid = lambda *s: (rng.randint(-270, 270, s) / 64).astype(np.float32)
    layer = dict(w_x=mid(4, 421, n_x), w_h=mid(4, 421, 421),
                 w_peep=mid(3, 421),
                 b=(rng.randint(-2 ** 17, 2 ** 17, (4, 421)) / 2048
                    ).astype(np.float32))
    jq, tq = _packs(layer, n_x, 421, tsys.N_LSTM_SILICON)
    plan = tq.plan
    assert (plan.rows, plan.cols_x, plan.cols_h, plan.padded_in) == (
        5, 2 if n_x == 123 else 5, 5, 672 if n_x == 123 else 960)
    assert tq.plan_shape == tuple(jq.plan_shape)
    for name in ('tiles_q', 'peep_q', 'bias_q', 'sig_lut', 'tanh_lut'):
        _eq(getattr(tq, name), getattr(jq, name))
    moved = quantized_packed_from_numpy(jax.tree.map(np.asarray, jq), 'cpu')
    for a, b in zip(moved[:5], tq[:5]):
        assert torch.equal(a, b)


@pytest.mark.parametrize('n_x,n_h,tile,T,B', [
    (24, 32, 16, 6, 3),
    (23, 37, 16, 5, 2),      # ragged against the tile
])
def test_systolic_layer_quantized_matches_reference(n_x, n_h, tile, T, B):
    jq, tq = _packs(_layer(n_x + n_h, n_x, n_h), n_x, n_h, tile)
    xs = (np.random.RandomState(1).randn(T, B, n_x)).astype(np.float32)
    xq_t = tquant.quantize(torch.from_numpy(xs))
    xq_j = jquant.quantize(jnp.asarray(xs))
    _eq(xq_t, xq_j)
    hs_t = tsys.systolic_layer_quantized(tq, xq_t)
    assert hs_t.dtype == torch.int8 and bool(hs_t.abs().sum() > 0)
    _eq(hs_t, jsys.systolic_layer_quantized(jq, xq_j))
    _eq(tsys.quantized_x_prefix(tq, xq_t), jsys.quantized_x_prefix(jq, xq_j))


def test_systolic_cell_quantized_from_nonzero_state_matches_reference():
    n_x, n_h, tile, B = 24, 32, 16, 3
    jq, tq = _packs(_layer(5, n_x, n_h), n_x, n_h, tile)
    x, h = _codes(6, B, n_x), _codes(7, B, n_h)
    c = _codes(8, B, tq.plan.rows, tile)
    got = tsys.systolic_cell_quantized(tq, *map(torch.from_numpy, (x, h, c)))
    want = jsys.systolic_cell_quantized(jq, *map(jnp.asarray, (x, h, c)))
    for g, w in zip(got, want):
        _eq(g, w)


def test_saturation_heavy_layer_matches_reference():
    """Weights and frames near +-3.9: the plain datapath saturates both a
    tile partial and a hop, and the port still equals the reference."""
    n_x, n_h, tile, T, B = 24, 32, 16, 4, 2
    jq, tq = _packs(_layer(9, n_x, n_h, peak=3.9), n_x, n_h, tile)
    rng = np.random.RandomState(10)
    xs = (rng.choice([-1, 1], (T, B, n_x)) * rng.uniform(3.6, 3.9, (T, B, n_x))
          ).astype(np.float32)
    xq_t = tquant.quantize(torch.from_numpy(xs))
    xh = tsys.pack_xh(xq_t[0], torch.zeros((B, n_h), dtype=torch.int8),
                      tq.plan)
    raw = tsys.tile_products(tq.tiles_q, xh)          # (B, R, C, 4, t)
    assert bool((raw.abs() > tquant.INT16_MAX).any()), 'no saturated partial'
    parts = tsys._sat16(raw)
    acc, hop_saturated = torch.zeros_like(parts[..., 0, :, :]), False
    for c in range(parts.shape[-3]):
        s = acc + parts[..., c, :, :]
        hop_saturated |= bool((s.abs() > tquant.INT16_MAX).any())
        acc = tsys._sat16(s)
    assert hop_saturated, 'no saturated hop'
    assert torch.equal(acc, tsys.saturating_hops(parts))
    _eq(tsys.systolic_layer_quantized(tq, xq_t),
        jsys.systolic_layer_quantized(jq, jquant.quantize(jnp.asarray(xs))))


def test_systolic_layer_tiled_matches_reference():
    n_x, n_h, tile, T, B = 23, 37, 16, 5, 2
    layer = _layer(11, n_x, n_h, scale=0.3)
    plan_t = tsys.SystolicPlan(n_x, n_h, tile)
    pk_t = tsys.pack_lstm(
        tlstm.LSTMParams(**{k: torch.from_numpy(v) for k, v in layer.items()}),
        plan_t)
    pk_j = jsys.pack_lstm(
        jlstm.LSTMParams(**{k: jnp.asarray(v) for k, v in layer.items()}),
        jsys.SystolicPlan(n_x, n_h, tile))
    _eq(pk_t.tiles, pk_j.tiles)
    xs = np.random.RandomState(12).randn(T, B, n_x).astype(np.float32)
    got = tsys.systolic_layer_tiled(pk_t, torch.from_numpy(xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jsys.systolic_layer_tiled(pk_j, jnp.asarray(xs))), rtol=RTOL,
        atol=ATOL)
    # and the tiled dataflow is the canonical layer on the unpacked weights
    want, _ = tlstm.lstm_layer(
        tlstm.LSTMParams(**{k: torch.from_numpy(v) for k, v in layer.items()}),
        torch.from_numpy(xs))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_tile_products_refuse_inexact_tiles():
    big = torch.zeros((1, 1, 4, 1032, 1032), dtype=torch.int8)
    with pytest.raises(ValueError):
        tsys.tile_products(big, torch.zeros((1, 1032), dtype=torch.int8))
