"""K8's backward pair on the CPU: its launch rule ``attention_bwd_geometry``
and the numerics of its tensor-core arithmetic.

The rule is pure Python, so it is held here at the card's shapes (132 SMs):
MiniCPM-2B's training attention takes no split, Qwen3-14B's the GQA group
split, and every grid walks each of its tiles once, heaviest first.

``attention_bwd_mixed_ref`` mirrors the kernels' arithmetic in plain
PyTorch (bf16: p and ds as hi + lo bf16 operands; f32: every product by
error-compensated 3xTF32 with ``cvt.rna``'s tf32 rounding).  It is held
against the plain backward ``attention_bwd_ref`` and against the
reference's ``chunked_attention`` custom VJP in JAX, on inputs made with
numpy from a seed.  Tolerances, max |error| over the gradient's scale
(max |want|): f32 1e-4 (``chip_smoke.py``'s ``BWD_TOL``: sums of up to S
terms in another order, and 3xTF32 keeps f32's order of error); bf16
against the plain backward 2**-7 (one rounding of each gradient to bf16,
with room for a tie); bf16 against JAX 2**-6 (the reference's residual
o is f32, the port's is o rounded to bf16, so delta differs by up to
2**-9 of |do . o| and ds with it, on top of the output rounding).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_bwd_geometry, attention_bwd_mixed_ref, attention_bwd_ref,
    attention_delta, attention_ref, tf32_round)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    BWD_ROWS, bwd_key_pairs, bwd_row_pairs)
from repro_torch.kernels.flash_attention.ref import _mask  # noqa: E402

SMS = 132                     # an H100 SXM
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
JAX_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
F32, BF16 = torch.float32, torch.bfloat16


def _err_over_scale(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# ----------------------------------------------------------- the launch rule
# (label, B, H, Hkv, S, D, dtype, window, offset, causal): the card's
# training shapes and the rule's corners
RULE_CASES = {
    'minicpm-2b': (2, 36, 36, 4096, 64, F32, None, 0, True),
    'qwen3-14b': (1, 40, 8, 1024, 128, BF16, None, 0, True),
    'qwen3-14b windowed': (1, 40, 8, 1024, 128, BF16, 256, 0, True),
    'D 20, GQA': (1, 6, 2, 300, 20, F32, None, 0, True),
    'large B x H': (8, 32, 8, 2048, 128, BF16, None, 0, True),
    'window without causality': (1, 8, 2, 700, 64, F32, 100, 0, False),
    'decode offset': (1, 4, 2, 130, 32, BF16, None, 70, True),
}


def _rule(case, **kw):
    b, h, hkv, s, d, dtype, window, offset, causal = case
    return attention_bwd_geometry(b, h, hkv, s, s, d, dtype, window, offset,
                                  SMS, causal=causal, **kw)


@pytest.mark.parametrize('label,want', [
    ('minicpm-2b', dict(d_tile=64, kv_rows=32, q_keys=32, kv_split=1,
                        kv_ctas=4608, q_ctas=4608, kv_reverse=False,
                        q_reverse=True)),
    ('qwen3-14b', dict(d_tile=128, kv_rows=32, q_keys=64, kv_split=5,
                       kv_ctas=640, q_ctas=640, kv_reverse=False,
                       q_reverse=True)),
    ('qwen3-14b windowed', dict(kv_split=5, kv_ctas=640, q_ctas=640)),
    ('D 20, GQA', dict(d_tile=32, kv_rows=32, q_keys=32, kv_split=3,
                       kv_ctas=30, q_ctas=30)),
    ('decode offset', dict(d_tile=32, kv_rows=64, q_keys=64)),
    ('large B x H', dict(kv_split=1, kv_ctas=2048, q_ctas=8192)),
    ('window without causality', dict(kv_split=4, kv_reverse=True,
                                      q_reverse=False)),
])
def test_attention_bwd_geometry_at_card_shapes(label, want):
    """The split where B * Hkv * key tiles gives under two CTAs an SM and
    the group is larger than 1; 64-key and 64-row CTAs of 4 warps; the
    streamed tiles 64 rows in bf16 (32 query rows at D 128) and 32 in
    f32."""
    geom = _rule(RULE_CASES[label])
    assert geom == _rule(RULE_CASES[label])          # pure
    got = {k: getattr(geom, k) for k in want}
    assert got == want
    assert (geom.warps, geom.kv_keys, geom.q_rows) == (4, BWD_ROWS,
                                                       BWD_ROWS)
    b, h, hkv = RULE_CASES[label][:3]
    assert geom.kv_ctas == b * hkv * geom.kv_split * geom.kv_tiles
    assert geom.q_ctas == b * h * geom.q_tiles


@pytest.mark.parametrize('split', [True, False])
def test_attention_bwd_geometry_forced_split(split):
    """``split`` overrides the rule both ways; an MHA group (1) never
    splits."""
    for label in ('minicpm-2b', 'qwen3-14b', 'large B x H'):
        geom = _rule(RULE_CASES[label], split=split)
        b, h, hkv = RULE_CASES[label][:3]
        assert geom.kv_split == (h // hkv if split else 1)
    assert _rule(RULE_CASES['minicpm-2b'], split=True).kv_split == 1


@pytest.mark.parametrize('label', sorted(RULE_CASES))
@pytest.mark.parametrize('kind', ['kv', 'q'])
def test_attention_bwd_geometry_order_heaviest_first(label, kind):
    """Each grid covers every row (key or query) once, in whole tiles, and
    launches first the tile with the most valid pairs (under a causal mask
    the first keys, which every query row sees, and the last query rows);
    under a causal mask alone the work only falls from there."""
    case = RULE_CASES[label]
    _, h, hkv, s, d, _, window, offset, causal = case
    geom = _rule(case)
    ranges = geom.kv_ranges(s) if kind == 'kv' else geom.q_ranges(s)
    tiles = geom.kv_tiles if kind == 'kv' else geom.q_tiles
    assert len(ranges) == tiles
    assert sorted(i for lo, hi in ranges for i in range(lo, hi)) == list(
        range(s))
    assert all(0 < hi - lo <= BWD_ROWS for lo, hi in ranges)
    pairs = bwd_key_pairs if kind == 'kv' else bwd_row_pairs
    work = [sum(pairs(i, s, offset, causal, window) for i in range(lo, hi))
            for lo, hi in ranges]
    assert work[0] == max(work)
    if causal and window is None:
        assert work == sorted(work, reverse=True)


@pytest.mark.parametrize('causal,window,offset', [
    (True, None, 0), (True, 5, 0), (False, 7, 0), (True, None, 9),
    (True, 4, -3), (False, None, 0)])
def test_bwd_pair_counts_match_the_mask(causal, window, offset):
    """The rule's pair counts are the mask's row and column sums."""
    sq, sk = 23, 31
    mask = _mask(0, sq, sk, offset, causal, window, None, 'cpu')
    assert [bwd_row_pairs(i, sk, offset, causal, window)
            for i in range(sq)] == mask.sum(1).tolist()
    assert [bwd_key_pairs(j, sq, offset, causal, window)
            for j in range(sk)] == mask.sum(0).tolist()


# ------------------------------------------------------------------ numerics
def test_tf32_round_is_cvt_rna():
    """Nearest with ties away from zero at 10 mantissa bits, low 13 bits
    clear, and big + small exact; one TF32 rounding loses ~2**-11."""
    one = 1.0 + 2.0 ** -11                     # a tie between 1 and 1 + 2**-10
    x = torch.tensor([one, -one, 1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -12,
                      3.0, 0.0])
    assert tf32_round(x).tolist() == [1.0 + 2.0 ** -10, -1.0 - 2.0 ** -10,
                                      1.0 + 2.0 ** -9, 1.0, 3.0, 0.0]
    y = torch.from_numpy((np.random.RandomState(0).randn(4096) * 10.0 **
                          np.random.RandomState(1).randint(-5, 5, 4096)
                          ).astype(np.float32))
    big = tf32_round(y)
    assert (big.view(torch.int32) & 0x1FFF).eq(0).all()
    small = tf32_round(y - big)
    assert torch.equal((big.double() + (y - big).double()).float(), y)
    assert float(((y - big).abs() / y.abs()).max()) <= 2.0 ** -11
    assert float(((y - big - small).abs() / y.abs()).max()) <= 2.0 ** -22


@pytest.mark.parametrize('n', [64, 1024])
def test_3xtf32_keeps_f32_error_and_one_tf32_product_does_not(n):
    """A 64 x n by n x 64 product of normal data against f64: 3xTF32
    within f32's order of error, a single TF32 product past BWD_TOL's
    1e-4 of the scale (why the f32 path takes three)."""
    rng = np.random.RandomState(n)
    a = rng.randn(64, n).astype(np.float32)
    b = rng.randn(n, 64).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    a_big, b_big = tf32_round(ta), tf32_round(tb)
    a_small, b_small = tf32_round(ta - a_big), tf32_round(tb - b_big)
    three = a_small @ b_big + a_big @ b_small + a_big @ b_big
    one = a_big @ b_big
    assert _err_over_scale(_np(three), exact) <= 2e-6
    assert _err_over_scale(_np(one), exact) > BWD_TOL[F32]


# (B, H, Hkv, S, D, window, offset): GQA, ragged tails, D 20, a window,
# rows that see no key (negative offset)
MIRROR_CASES = (
    (2, 4, 2, 100, 64, None, 0),
    (1, 6, 2, 70, 128, 48, 0),
    (1, 2, 1, 96, 20, None, -16),
    (1, 4, 4, 130, 32, 5, 0),
)


def _inputs(case, dtype):
    b, h, hkv, s, d = case[:5]
    rng = np.random.RandomState(s + d)
    q, do = (torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32)
                              ).to(dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(b, hkv, s, d).astype(np.float32)
                             ).to(dtype) for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize('case', MIRROR_CASES)
@pytest.mark.parametrize('dtype', [F32, BF16])
def test_mixed_mirror_matches_plain_backward(case, dtype):
    """The kernels' arithmetic (hi/lo bf16, 3xTF32) against the plain f32
    backward, within ``BWD_TOL`` of each gradient's scale."""
    q, k, v, do = _inputs(case, dtype)
    kw = dict(causal=True, window=case[5], offset=case[6])
    o, lse = attention_ref(q, k, v, return_lse=True, **kw)
    args = (q, k, v, do, lse, attention_delta(o, do))
    got = attention_bwd_mixed_ref(*args, **kw)
    want = attention_bwd_ref(*args, **kw)
    for name, a, w in zip(('dq', 'dk', 'dv'), got, want):
        assert a.shape == w.shape and a.dtype == w.dtype == dtype, name
        assert _err_over_scale(_np(a), _np(w)) <= BWD_TOL[dtype], name


@pytest.mark.parametrize('case', [
    # (H, Hkv, S, D, window, chunk): tests/test_torch_lm_train.py's cases
    (4, 4, 16, 8, None, 8),
    (6, 2, 16, 16, None, 16),
    (4, 2, 24, 8, 5, 8),
    (4, 4, 16, 32, 3, 4),
])
@pytest.mark.parametrize('dtype', [F32, BF16])
def test_mixed_mirror_matches_reference_custom_vjp(case, dtype):
    """The mirror, from the port's forward (lse, and delta from its o),
    against the gradients of the reference's ``chunked_attention`` custom
    VJP at the same inputs (bf16 ones in bf16)."""
    h, hkv, s, d, window, chunk = case
    rng = np.random.RandomState(sum(case[:4]))
    q = rng.randn(2, h, s, d).astype(np.float32)
    k, v = (rng.randn(2, hkv, s, d).astype(np.float32) for _ in range(2))
    ct = rng.randn(2, h, s, d).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    jq, jk, jv, jct = (jnp.asarray(a).astype(jdt) for a in (q, k, v, ct))

    def jloss(q, k, v):
        o = jlayers.chunked_attention(q, k, v, causal=True, window=window,
                                      chunk=chunk)
        return jnp.sum(o.astype(jnp.float32) * jct.astype(jnp.float32))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv, tct = (torch.from_numpy(a).to(dtype) for a in (q, k, v, ct))
    kw = dict(causal=True, window=window)
    o, lse = attention_ref(tq, tk, tv, return_lse=True, **kw)
    got = attention_bwd_mixed_ref(tq, tk, tv, tct, lse,
                                  attention_delta(o, tct), **kw)
    for name, a, w in zip(('dq', 'dk', 'dv'), got, jg):
        assert a.dtype == dtype, name
        err = _err_over_scale(_np(a), np.asarray(w.astype(jnp.float32)))
        assert err <= JAX_TOL[dtype], (name, err)
