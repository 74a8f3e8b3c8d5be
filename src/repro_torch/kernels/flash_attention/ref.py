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

from typing import Optional

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
