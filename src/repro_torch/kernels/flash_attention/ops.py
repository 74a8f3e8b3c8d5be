"""Public op of K8: multi-head attention.

Counterpart of ``repro.kernels.flash_attention.ops.mha``.  The kernel takes
any sequence lengths, so there is no padding and no ``kv_len``: ``mha``
passes the offset the reference passes, Sk - Sq when causal (the last query
sees every key, as in decode) and 0 otherwise.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import flash_attention


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: Optional[int] = None,
        sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D).  Returns (B, H, Sq, D)."""
    sq, sk = q.shape[2], k.shape[2]
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window, sm_scale=sm_scale,
                           offset=(sk - sq) if causal else 0)
