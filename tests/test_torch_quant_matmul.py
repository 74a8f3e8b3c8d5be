"""K7 (``quant_matmul``), its public ops and the port's arbitrary-scale
int8 helpers against the JAX reference on the CPU.

Inputs are made with numpy from a seed.  JAX's Pallas kernel runs in
interpret mode, as the reference's own tests run it; the port's K7 wrapper
runs its plain PyTorch version on CPU tensors.  Scales and int8 codes must
be ``torch.equal`` to JAX's (the same division, rounding half to even).
The plain product is exact (int32) and applies the epilogue in the TPU
kernel's order, so it equals the interpreted kernel bit for bit, in f32 and
in bf16; against the reference's oracle, which associates the epilogue the
other way, it agrees to rtol 1e-6 (one f32 rounding).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from repro.core import quant as jquant  # noqa: E402
from repro.kernels import quant_matmul as jqm  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.kernels.quant_matmul import (qmm_geometry,  # noqa: E402
                                              quant_matmul,
                                              quant_matmul_ref,
                                              quantize_weights,
                                              quantized_linear)
from repro_torch.kernels.quant_matmul.kernel import (  # noqa: E402
    TILE_MS, TILE_N)


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_int8_helpers_match_reference():
    x = _x(0, 16, 40)
    x[3] = 0.0                                   # a row at the eps floor
    for axis in (None, -1, 0):
        js = jquant.abs_max_scale(x, axis=axis)
        ts = tquant.abs_max_scale(_t(x), axis=axis)
        assert torch.equal(ts, _t(js)), axis
        jq = jquant.quantize_scaled(x, js)
        tq = tquant.quantize_scaled(_t(x), ts)
        assert tq.dtype == torch.int8 and torch.equal(tq, _t(jq)), axis
        assert torch.equal(tquant.dequantize_scaled(tq, ts),
                           _t(jquant.dequantize_scaled(jq, js)))
    # ties round half to even, like jnp.round
    ties = np.array([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]], np.float32)
    one = np.ones((1, 1), np.float32)
    assert torch.equal(tquant.quantize_scaled(_t(ties), _t(one)),
                       _t(jquant.quantize_scaled(ties, one)))
    w = _x(1, 40, 24)
    xs, ws = jquant.abs_max_scale(x, -1), jquant.abs_max_scale(w, 0)
    xq, wq = jquant.quantize_scaled(x, xs), jquant.quantize_scaled(w, ws)
    got = tquant.int8_matmul(_t(xq), _t(wq), _t(xs), _t(ws))
    assert torch.equal(got, _t(jquant.int8_matmul(xq, wq, xs, ws)))


@pytest.mark.parametrize('m,k,n,bm,bn,bk', [(64, 128, 64, 64, 64, 64),
                                            (8, 256, 128, 8, 128, 64)])
@pytest.mark.parametrize('out_dtype', ['float32', 'bfloat16'])
def test_plain_product_equals_interpreted_tpu_kernel(m, k, n, bm, bn, bk,
                                                     out_dtype):
    x, w = _x(m + n, m, k), _x(k, k, n)
    xs, ws = jquant.abs_max_scale(x, -1), jquant.abs_max_scale(w, 0)
    xq, wq = jquant.quantize_scaled(x, xs), jquant.quantize_scaled(w, ws)
    want = jqm.quant_matmul(xq, wq, xs, ws, bm=bm, bn=bn, bk=bk,
                            out_dtype=getattr(jnp, out_dtype),
                            interpret=True)
    args = tuple(map(_t, (xq, wq, xs, ws)))
    got = quant_matmul(*args, out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and got.shape == (m, n)
    assert torch.equal(got.float(), _t(want.astype(jnp.float32)))
    assert torch.equal(got, quant_matmul_ref(*args, getattr(torch, out_dtype)))
    if out_dtype == 'float32':
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jqm.quant_matmul_ref(xq, wq, xs, ws)),
            rtol=1e-6, atol=0)


def test_quantized_linear_ragged_and_batched_matches_reference():
    """The reference's ragged case: (3, 5, 100) activations against a
    (100, 75) weight, bit-equal to the reference's op (which pads to its
    blocks and runs the interpreted kernel), within 3 % of the f32
    product."""
    x, w = _x(0, 3, 5, 100), _x(1, 100, 75)
    jwq, jws = jqm.quantize_weights(w)
    twq, tws = quantize_weights(_t(w))
    assert twq.dtype == torch.int8 and torch.equal(twq, _t(jwq))
    assert torch.equal(tws, _t(jws)) and tws.shape == (75,)
    got = quantized_linear(_t(x), twq, tws)
    assert got.shape == (3, 5, 75) and got.dtype == torch.float32
    assert torch.equal(got, _t(jqm.quantized_linear(x, jwq, jws)))
    exact = _t(x) @ _t(w)
    assert float((got - exact).abs().max() / exact.abs().max()) < 0.03


def test_quant_matmul_refuses_other_devices():
    t = lambda *s: torch.empty(*s, dtype=torch.int8, device='meta')
    with pytest.raises(ValueError):
        quant_matmul(t(4, 8), t(8, 4), torch.ones(4, 1, device='meta'),
                     torch.ones(1, 4, device='meta'))


@pytest.mark.parametrize('m,n', [(256, 16384), (256, 512), (15, 75), (1, 3),
                                 (130, 136), (256, 384), (1000, 4096),
                                 (5, 8)])
def test_qmm_geometry_covers_outputs_once(m, n):
    """``qmm_geometry`` is a pure rule: its tiles cover M x N exactly once,
    they are the shortest that keep the CTAs within the card's SMs
    (Mixtral's up-projection: 128 CTAs of one 256-row tile each, so every
    weight byte is fetched by one CTA)."""
    g = qmm_geometry(m, n, 132)
    assert g == qmm_geometry(m, n, 132)
    assert g.bm in TILE_MS and g.tiles_m == -(-m // g.bm)
    rows = [r for i in range(g.tiles_m)
            for r in range(i * g.bm, min(m, (i + 1) * g.bm))]
    cols = [c for j in range(g.tiles_n)
            for c in range(j * TILE_N, min(n, (j + 1) * TILE_N))]
    assert rows == list(range(m)) and cols == list(range(n))
    assert g.ctas == g.tiles_m * g.tiles_n
    if g.bm > TILE_MS[-1]:     # a shorter tile would overfill the card
        assert -(-m // (g.bm // 2)) * g.tiles_n > 132
    if (m, n) == (256, 16384):
        assert (g.bm, g.tiles_m, g.ctas) == (256, 1, 128)
    if (m, n) == (256, 512):       # 64-row tiles: 16 CTAs
        assert (g.bm, g.ctas) == (64, 16)
