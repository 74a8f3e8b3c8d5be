"""Plain PyTorch version of K8: attention with causal, sliding-window,
key-length and GQA masking, the counterpart of the reference's
``attention_ref`` with the kernel's ``offset`` as a parameter.

Scores and softmax in f32 from the inputs' values, masked scores
``NEG_INF`` = -1e30, rows with no valid key zeroed, the output in q's
dtype.  The query rows go in blocks of at most ``SCORE_ELEMS`` scores, so
that a long prefill (Mixtral's 48 heads x 8192 x 8192) never holds its
whole score tensor; each block is the same arithmetic as the whole.

For training, ``attention_ref(..., return_lse=True)`` also returns each
row's log-sum-exp and ``attention_bwd_ref`` is the plain mirror of the
reference's ``_ca_bwd`` (the custom VJP of ``chunked_attention``): p
recomputed from the log-sum-exp, blocked like the forward.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e30
SCORE_ELEMS = 1 << 27     # scores per query block (512 MB in f32)


def _mask(lo: int, hi: int, sk: int, offset: int, causal: bool,
          window: Optional[int], kv_len: Optional[int], device):
    """(hi - lo, sk) bool: which keys query rows lo .. hi - 1 see."""
    k_pos = torch.arange(sk, device=device)[None, :]
    q_pos = torch.arange(lo, hi, device=device)[:, None] + offset
    mask = torch.ones((hi - lo, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    if kv_len is not None:
        mask &= k_pos < kv_len
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  sm_scale: Optional[float] = None,
                  kv_len: Optional[int] = None,
                  offset: Optional[int] = None, return_lse: bool = False
                  ) -> Union[torch.Tensor, Tuple[torch.Tensor,
                                                 torch.Tensor]]:
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D); GQA via H % Hkv == 0.

    ``window``: query position p attends keys j with p - j < window.
    ``kv_len``: keys j < kv_len only.  ``offset``: absolute position of
    query row 0 (default Sk - Sq when causal, else 0, the reference's).
    ``return_lse``: also the rows' log-sum-exp of the scaled scores, f32
    (B, H, Sq), NEG_INF where a row sees no key (``_attn_fwd_scan``'s).
    """
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    scale = d ** -0.5 if sm_scale is None else sm_scale
    if offset is None:
        offset = sk - sq if causal else 0
    qf = q.to(torch.float32).reshape(b, hkv, group, sq, d)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    out = torch.empty((b, hkv, group, sq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hkv, group, sq), dtype=torch.float32,
                       device=q.device) if return_lse else None)
    step = max(1, SCORE_ELEMS // max(1, b * h * sk))
    for lo in range(0, sq, step):
        hi = min(sq, lo + step)
        s = torch.einsum('bkgqd,bksd->bkgqs', qf[:, :, :, lo:hi], kf) * scale
        mask = _mask(lo, hi, sk, offset, causal, window, kv_len, q.device)
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        seen = mask.any(dim=-1)
        p = torch.where(seen[:, None], p, 0.0)
        out[:, :, :, lo:hi] = torch.einsum('bkgqs,bksd->bkgqd', p, vf
                                           ).to(q.dtype)
        if return_lse:
            lse[:, :, :, lo:hi] = torch.where(seen, torch.logsumexp(s, -1),
                                              NEG_INF)
    out = out.reshape(b, h, sq, d)
    return (out, lse.reshape(b, h, sq)) if return_lse else out


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(do * o) in f32, (B, H, Sq): the backward's delta, as
    ``_ca_bwd`` computes it."""
    return (do.to(torch.float32) * o.to(torch.float32)).sum(dim=-1)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, *, causal: bool = True,
                      window: Optional[int] = None,
                      sm_scale: Optional[float] = None,
                      offset: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``attention_ref`` at cotangent ``do`` (B, H,
    Sq, D), from the forward's ``lse`` and ``delta`` (``attention_delta``):
    the reference's ``_ca_bwd`` with p = exp(s - lse_safe) under the mask,
    ds = p (dp - delta) scale; f32 arithmetic, each gradient in its
    input's dtype.  The query rows go in blocks of at most ``SCORE_ELEMS``
    scores; dk and dv sum over the blocks and the heads of each group.
    No ``kv_len``: the reference's training path has none."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    scale = d ** -0.5 if sm_scale is None else sm_scale
    if offset is None:
        offset = sk - sq if causal else 0
    f32 = torch.float32
    qf = q.to(f32).reshape(b, hkv, group, sq, d)
    dof = do.to(f32).reshape(b, hkv, group, sq, d)
    kf, vf = k.to(f32), v.to(f32)
    lse_safe = torch.where(lse == NEG_INF, 0.0, lse).reshape(b, hkv, group,
                                                             sq)
    delta = delta.reshape(b, hkv, group, sq)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    step = max(1, SCORE_ELEMS // max(1, b * h * sk))
    for lo in range(0, sq, step):
        hi = min(sq, lo + step)
        q_b, do_b = qf[:, :, :, lo:hi], dof[:, :, :, lo:hi]
        s = torch.einsum('bkgqd,bksd->bkgqs', q_b, kf) * scale
        mask = _mask(lo, hi, sk, offset, causal, window, None, q.device)
        p = torch.where(mask, torch.exp(s - lse_safe[:, :, :, lo:hi, None]),
                        0.0)
        dv += torch.einsum('bkgqs,bkgqd->bksd', p, do_b)
        dp = torch.einsum('bkgqd,bksd->bkgqs', do_b, vf)
        ds = p * (dp - delta[:, :, :, lo:hi, None]) * scale
        dq[:, :, :, lo:hi] = torch.einsum('bkgqs,bksd->bkgqd', ds, kf)
        dk += torch.einsum('bkgqs,bkgqd->bksd', ds, q_b)
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to tf32 as ``cvt.rna.tf32.f32`` rounds: 10
    mantissa bits kept, to nearest, ties away from zero; the low 13 bits
    cleared, so ``x - tf32_round(x)`` is exact in f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _pieces(x: torch.Tensor, bf16: bool) -> Tuple[torch.Tensor, ...]:
    """x (f32) as the kernels feed it to the tensor cores, small piece
    first: bf16 hi + lo for bf16 inputs, tf32 big + small for f32."""
    if bf16:
        hi = x.to(torch.bfloat16).to(torch.float32)
        return (x - hi).to(torch.bfloat16).to(torch.float32), hi
    big = tf32_round(x)
    return tf32_round(x - big), big


def _product(eq: str, a: torch.Tensor, b: torch.Tensor, bf16: bool,
             a_split: bool) -> torch.Tensor:
    """einsum ``eq`` of f32 a and b in the kernels' arithmetic.  bf16: b
    exact in bf16, a split into hi + lo where ``a_split`` (p, ds), else
    exact too (q, k, v, do); f32: error-compensated 3xTF32, a_small b_big +
    a_big b_small + a_big b_big."""
    if bf16:
        if not a_split:
            return torch.einsum(eq, a, b)
        lo, hi = _pieces(a, True)
        return torch.einsum(eq, lo, b) + torch.einsum(eq, hi, b)
    a_small, a_big = _pieces(a, False)
    b_small, b_big = _pieces(b, False)
    return (torch.einsum(eq, a_small, b_big) + torch.einsum(eq, a_big, b_small)
            + torch.einsum(eq, a_big, b_big))


def attention_bwd_mixed_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor, *,
                            causal: bool = True,
                            window: Optional[int] = None,
                            sm_scale: Optional[float] = None,
                            offset: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain mirror of the backward kernels' tensor-core arithmetic, the
    same contract as ``attention_bwd_ref``: in bf16, s and dp from the
    exact bf16 inputs, p and ds each fed as bf16 hi + lo into its product
    (dv = p^T do, dk = ds^T q, dq = ds k); in f32, every product by
    error-compensated 3xTF32 (``tf32_round``).  Sums in f32, each
    gradient rounded once to its input's dtype.  The tensor cores' own
    truncating accumulation is not modelled: the kernels sum each tile's
    product in zeroed registers and add it to the running sum rounded.
    For the tests only (no CUDA path calls it): it holds the design's
    numerics on the CPU."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    scale = d ** -0.5 if sm_scale is None else sm_scale
    if offset is None:
        offset = sk - sq if causal else 0
    bf16 = q.dtype == torch.bfloat16
    f32 = torch.float32
    qf = q.to(f32).reshape(b, hkv, group, sq, d)
    dof = do.to(f32).reshape(b, hkv, group, sq, d)
    kf, vf = k.to(f32), v.to(f32)
    lse_safe = torch.where(lse == NEG_INF, 0.0, lse).reshape(b, hkv, group,
                                                             sq)
    delta = delta.reshape(b, hkv, group, sq)
    mask = _mask(0, sq, sk, offset, causal, window, None, q.device)
    prod = lambda eq, a, x, split: _product(eq, a, x, bf16, split)
    s = prod('bkgqd,bksd->bkgqs', qf, kf, False) * scale
    p = torch.where(mask, torch.exp(s - lse_safe[..., None]), 0.0)
    dp = prod('bkgqd,bksd->bkgqs', dof, vf, False)
    ds = p * (dp - delta[..., None]) * scale
    dv = prod('bkgqs,bkgqd->bksd', p, dof, True)
    dk = prod('bkgqs,bkgqd->bksd', ds, qf, True)
    dq = prod('bkgqs,bksd->bkgqd', ds, kf, True)
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
