"""K8 (``flash_attention``) and its public op ``mha`` against the JAX
reference on the CPU.

Inputs are made with numpy from a seed.  JAX's Pallas kernel runs in
interpret mode (32-row blocks, as the reference's own tests run it); the
port's K8 wrapper runs its plain PyTorch version on CPU tensors.
Tolerances: f32 rtol = atol = 1e-5 (the softmax sums run in another order:
the kernel's online softmax over blocks against one softmax per row); bf16
rtol = atol = 2e-2 (the reference's own ``test_flash_attention_dtypes``).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_geometry, attention_ref, attention_split_ref, flash_attention,
    live_key_range, mha)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    SPLIT_KEYS, SPLIT_MAX, SPLIT_ROWS, TILE_ROWS)

TOL = {'float32': 1e-5, 'bfloat16': 2e-2}


def _qkv(seed, b, h, hkv, sq, sk, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, sq, d).astype(np.float32),
            rng.randn(b, hkv, sk, d).astype(np.float32),
            rng.randn(b, hkv, sk, d).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, dtype='float32'):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize('causal,window,sq,sk', [
    (True, None, 64, 64),
    (False, None, 64, 64),
    (True, 16, 80, 80),      # ragged: the reference pads to its blocks
    (False, 16, 64, 64),     # a window without causal also bounds the past
    (True, None, 1, 96),     # decode: one query at absolute position 95
])
def test_mha_matches_reference(causal, window, sq, sk):
    q, k, v = _qkv(sq + sk, 2, 4, 2, sq, sk, 32)
    want = jfa.mha(q, k, v, causal=causal, window=window, bq=32, bk=32)
    got = mha(_t(q), _t(k), _t(v), causal=causal, window=window)
    assert got.shape == q.shape and got.dtype == torch.float32
    _close(got, want)


def test_mha_gqa_odd_group():
    """H = 5 query heads on one kv head (Hymba's 25/5 grouping)."""
    q, k, v = _qkv(3, 1, 5, 1, 48, 48, 16)
    want = jfa.mha(q, k, v, causal=True, bq=16, bk=16)
    _close(mha(_t(q), _t(k), _t(v), causal=True), want)


def test_mha_bf16():
    q, k, v = (a.astype(jnp.bfloat16) for a in _qkv(4, 1, 2, 2, 64, 64, 32))
    want = jfa.mha(q, k, v, bq=32, bk=32)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16) for a in (q, k, v))
    got = mha(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    _close(got, want, 'bfloat16')


@pytest.mark.parametrize('causal,window,kv_len,offset', [
    (True, None, 40, -16),   # rows 0-15 see no key: output 0
    (False, 24, 48, 0),
])
def test_flash_attention_kv_len_and_offset(causal, window, kv_len, offset):
    q, k, v = _qkv(5, 1, 2, 1, 64, 64, 32)
    want = np.asarray(jfa.flash_attention(
        q, k, v, causal=causal, window=window, kv_len=kv_len, offset=offset,
        bq=32, bk=32, interpret=True))
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                          kv_len=kv_len, offset=offset)
    _close(got, want)
    empty = [i for i in range(64) if causal and i + offset < 0]
    assert torch.equal(got[:, :, empty], torch.zeros_like(got[:, :, empty]))
    assert np.all(want[:, :, empty] == 0)


def test_attention_ref_query_blocks_are_exact(monkeypatch):
    """The plain version's query blocks (which bound its score tensor on
    the card) compute each row as the whole does."""
    from repro_torch.kernels.flash_attention import ref
    q, k, v = map(_t, _qkv(6, 1, 4, 2, 40, 40, 8))
    whole = attention_ref(q, k, v, window=8)
    monkeypatch.setattr(ref, 'SCORE_ELEMS', 4 * 40 * 7)    # 7 rows a block
    assert torch.equal(attention_ref(q, k, v, window=8), whole)


def test_flash_attention_refuses_bad_inputs():
    t = lambda *s: torch.empty(*s, device='meta')
    with pytest.raises(ValueError):
        flash_attention(t(1, 2, 4, 8), t(1, 1, 4, 8), t(1, 1, 4, 8))
    with pytest.raises(ValueError):    # 3 query heads on 2 kv heads
        flash_attention(*(torch.zeros(1, h, 4, 8) for h in (3, 2, 2)))


@pytest.mark.parametrize('h,hkv', [(3, 3), (6, 2), (6, 1)])   # group 1/3/6
@pytest.mark.parametrize('sq', [1, 3])
@pytest.mark.parametrize('causal,window,kv_len,offset', [
    (True, None, None, None),
    (True, 8, None, None),       # the window empties the early splits
    (True, None, 20, None),      # kv_len empties the late splits
    (False, 6, 30, 12),          # a window without causal
    (True, None, 0, None),       # no key at all: every row is 0
])
def test_split_schedule_mirror_equals_attention_ref(h, hkv, sq, causal,
                                                    window, kv_len, offset):
    """The plain mirror of the kernel's split schedule (partials per key
    range, merged with exp(m_s - m_safe) weights) computes what the plain
    version does, for every number of splits, within 1e-6 (f32 sums in
    another order)."""
    sk = 37
    q, k, v = map(_t, _qkv(h + sq, 2, h, hkv, sq, sk, 8))
    kw = dict(causal=causal, window=window, kv_len=kv_len, offset=offset)
    want = attention_ref(q, k, v, **kw)
    for n_splits in (1, 2, 5, sk):
        got = attention_split_ref(q, k, v, n_splits=n_splits, **kw)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    if kv_len == 0:
        assert not bool(want.any())


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_split_schedule_mirror_matches_reference(dtype):
    """A decode row against a windowed cache, three splits: the mirror
    against JAX's interpreted kernel, at the tolerance of its dtype."""
    q, k, v = _qkv(7, 1, 6, 2, 1, 96, 32)
    if dtype == 'bfloat16':
        q, k, v = (np.asarray(a.astype(jnp.bfloat16)) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = jfa.flash_attention(jq, jk, jv, causal=True, window=40, bq=1,
                               bk=32, interpret=True)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dtype)) for a in (q, k, v))
    got = attention_split_ref(tq, tk, tv, causal=True, window=40,
                              n_splits=3)
    _close(got, want, dtype)


@pytest.mark.parametrize('case', [
    # (B, H, Hkv, Sq, Sk, window, kv_len, offset, causal)
    (1, 48, 8, 1, 8192, 4096, None, 8191, True),     # Mixtral decode
    (1, 48, 8, 4, 8192, 4096, None, 8188, True),     # Sq 4 x group 6
    (2, 4, 2, 1, 300, 128, None, 299, True),
    (1, 6, 1, 1, 500, None, 70, 499, True),          # kv_len ends the range
    (1, 6, 1, 3, 200, 16, None, 0, False),
    (1, 2, 2, 1, 64, None, 0, 63, True),             # no key at all
    (1, 4, 1, 1, 16384, None, None, 16383, True),    # capped at SPLIT_MAX
])
def test_attention_geometry_splits_cover_live_keys_once(case):
    """The split rule is pure: its splits cover every key some row sees
    exactly once, in whole tiles, and fill the card where the keys allow
    (Mixtral's decode: at least 132 CTAs for 8 kv heads)."""
    b, h, hkv, sq, sk, window, kv_len, offset, causal = case
    g = attention_geometry(b, h, hkv, sq, sk, window, kv_len, offset, 128,
                           132, causal=causal)
    assert g == attention_geometry(b, h, hkv, sq, sk, window, kv_len, offset,
                                   128, 132, causal=causal)
    assert g.path == 'split' and g.ctas == g.n_splits * b * hkv
    lo, hi = live_key_range(sq, sk, causal=causal, window=window,
                            kv_len=kv_len, offset=offset)
    assert (g.key_lo, g.key_hi) == (lo, hi)
    # every (row, key) pair the mask passes, as the plain version sees it
    kv = sk if kv_len is None else kv_len
    live = {j for i in range(sq) for j in range(sk)
            if j < kv and (not causal or i + offset >= j)
            and (window is None or i + offset - j < window)}
    starts = [g.key_lo + s * g.split_keys for s in range(g.n_splits)]
    covered = [j for a in starts
               for j in range(a, min(g.key_hi, a + g.split_keys))]
    assert sorted(covered) == list(range(lo, hi))
    assert live <= set(covered)
    assert g.split_keys % SPLIT_KEYS == 0 and 1 <= g.n_splits <= SPLIT_MAX
    tiles = -(-(hi - lo) // SPLIT_KEYS)
    assert (g.ctas >= 132 or g.n_splits == max(1, tiles)
            or g.n_splits > SPLIT_MAX // 2)
    if case[:5] == (1, 48, 8, 1, 8192):
        assert g.ctas >= 132


def test_attention_geometry_rule():
    """Tiled when its grid fills the card or the packed rows (Sq x group)
    overflow one split CTA; split otherwise."""
    tiled = attention_geometry(1, 48, 8, 8192, 8192, 4096, None, 0, 128, 132)
    assert (tiled.path, tiled.tile_rows, tiled.ctas) == ('tiled', 128, 64 * 48)
    f32 = attention_geometry(1, 48, 8, 8192, 8192, 4096, None, 0, 128, 132,
                             wide=False)      # the f32 kernel's 64 rows
    assert (f32.path, f32.tile_rows, f32.ctas) == ('tiled', 64, 128 * 48)
    # 128 tiled CTAs would underfill 132 SMs, but 1024 rows overflow a split
    bench = attention_geometry(1, 8, 8, 1024, 1024, None, None, 0, 64, 132)
    assert (bench.path, bench.tile_rows, bench.ctas) == ('tiled', 64, 128)
    assert attention_geometry(4, 48, 8, 1, 64, None, None, 63, 128,
                              132).path == 'tiled'     # 192 CTAs >= 132
    rows = SPLIT_ROWS // 6
    assert attention_geometry(1, 48, 8, rows, 512, None, None, 0, 128,
                              132).path == 'split'
    assert attention_geometry(1, 48, 8, rows + 1, 512, None, None, 0, 128,
                              132).path == 'tiled'
    assert TILE_ROWS == 64
