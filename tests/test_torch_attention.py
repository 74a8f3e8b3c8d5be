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
from repro_torch.kernels.flash_attention import (attention_ref,  # noqa: E402
                                                 flash_attention, mha)

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
