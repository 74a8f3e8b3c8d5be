"""Plain PyTorch version of K8: attention with causal, sliding-window,
key-length and GQA masking, the counterpart of the reference's
``attention_ref`` with the kernel's ``offset`` as a parameter.

Scores and softmax in f32 from the inputs' values, masked scores
``NEG_INF`` = -1e30, rows with no valid key zeroed, the output in q's
dtype.  The query rows go in blocks of at most ``SCORE_ELEMS`` scores, so
that a long prefill (Mixtral's 48 heads x 8192 x 8192) never holds its
whole score tensor; each block is the same arithmetic as the whole.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30
SCORE_ELEMS = 1 << 27     # scores per query block (512 MB in f32)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  sm_scale: Optional[float] = None,
                  kv_len: Optional[int] = None,
                  offset: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D); GQA via H % Hkv == 0.

    ``window``: query position p attends keys j with p - j < window.
    ``kv_len``: keys j < kv_len only.  ``offset``: absolute position of
    query row 0 (default Sk - Sq when causal, else 0, the reference's).
    """
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    scale = d ** -0.5 if sm_scale is None else sm_scale
    if offset is None:
        offset = sk - sq if causal else 0
    qf = q.to(torch.float32).reshape(b, hkv, group, sq, d)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    k_pos = torch.arange(sk, device=q.device)[None, :]
    out = torch.empty((b, hkv, group, sq, d), dtype=q.dtype, device=q.device)
    step = max(1, SCORE_ELEMS // max(1, b * h * sk))
    for lo in range(0, sq, step):
        hi = min(sq, lo + step)
        s = torch.einsum('bkgqd,bksd->bkgqs', qf[:, :, :, lo:hi], kf) * scale
        q_pos = torch.arange(lo, hi, device=q.device)[:, None] + offset
        mask = torch.ones((hi - lo, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos >= k_pos
        if window is not None:
            mask &= (q_pos - k_pos) < window
        if kv_len is not None:
            mask &= k_pos < kv_len
        p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
        p = torch.where(mask.any(dim=-1, keepdim=True), p, 0.0)
        out[:, :, :, lo:hi] = torch.einsum('bkgqs,bksd->bkgqd', p, vf
                                           ).to(q.dtype)
    return out.reshape(b, h, sq, d)


def live_key_range(sq: int, sk: int, *, causal: bool, window: Optional[int],
                   kv_len: Optional[int], offset: int) -> Tuple[int, int]:
    """[lo, hi): the keys that some query row sees under the mask (lo ==
    hi when no row sees any).  The visible keys of each row form one range
    that moves forward with the row, so the union is one range."""
    kv = sk if kv_len is None else max(0, min(sk, kv_len))
    lo, hi = sk, 0
    for i in range(sq):
        pos = i + offset
        r_hi = min(kv, pos + 1) if causal else kv
        r_lo = 0 if window is None else max(0, pos - window + 1)
        if r_hi > r_lo:
            lo, hi = min(lo, r_lo), max(hi, r_hi)
    return (lo, hi) if hi > lo else (0, 0)


def attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        sm_scale: Optional[float] = None,
                        kv_len: Optional[int] = None,
                        offset: Optional[int] = None,
                        n_splits: int = 1) -> torch.Tensor:
    """Plain mirror of the kernel's split schedule (flash-decoding): the
    live key range (``live_key_range``) cut into ``n_splits`` ranges of
    ceil(span / n_splits) keys; each range's partial (m, l, acc) with
    m = NEG_INF and l = acc = 0 where it sees no key; merged with
    m = max m_s, weights exp(m_s - m_safe) (0 where m_s is NEG_INF) and
    ``l_safe``.  The same contract as ``attention_ref``; for the tests
    only (no CUDA path calls it)."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    scale = d ** -0.5 if sm_scale is None else sm_scale
    if offset is None:
        offset = sk - sq if causal else 0
    lo, hi = live_key_range(sq, sk, causal=causal, window=window,
                            kv_len=kv_len, offset=offset)
    chunk = max(1, -(-(hi - lo) // n_splits))
    qf = q.to(torch.float32).reshape(b, hkv, group, sq, d)
    q_pos = torch.arange(sq, device=q.device)[:, None] + offset
    ms, ls, accs = [], [], []
    for s in range(n_splits):
        a, e = lo + s * chunk, min(hi, lo + (s + 1) * chunk)
        e = max(a, e)
        kf = k[:, :, a:e].to(torch.float32)
        vf = v[:, :, a:e].to(torch.float32)
        k_pos = torch.arange(a, e, device=q.device)[None, :]
        mask = torch.ones((sq, e - a), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos >= k_pos
        if window is not None:
            mask &= (q_pos - k_pos) < window
        if kv_len is not None:
            mask &= k_pos < kv_len
        sc = torch.where(mask, torch.einsum('bkgqd,bksd->bkgqs', qf, kf)
                         * scale, NEG_INF)
        m = sc.amax(dim=-1) if e > a else torch.full(
            (b, hkv, group, sq), NEG_INF, device=q.device)
        m_safe = torch.where(m == NEG_INF, 0.0, m)
        p = torch.where(mask, torch.exp(sc - m_safe[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum('bkgqs,bksd->bkgqd', p, vf))
    m = torch.stack(ms)
    m_max = m.amax(dim=0)
    m_safe = torch.where(m_max == NEG_INF, 0.0, m_max)
    w = torch.where(m == NEG_INF, 0.0, torch.exp(m - m_safe))
    l_sum = (w * torch.stack(ls)).sum(dim=0)
    acc = (w[..., None] * torch.stack(accs)).sum(dim=0)
    l_safe = torch.where(l_sum == 0.0, 1.0, l_sum)
    return (acc / l_safe[..., None]).to(q.dtype).reshape(b, h, sq, d)
