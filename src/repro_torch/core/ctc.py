"""CTC best-path decoding (the forward/serving half of ``repro.core.ctc``).

Conventions as in the reference: ``log_probs`` is (T, B, K), blank index 0 by
default; the collapsed output is (B, T) padded with -1.
"""
from __future__ import annotations

from typing import Tuple

import torch


def ctc_greedy_decode(log_probs: torch.Tensor, blank: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-path decode: (T, B, K) -> (collapsed (B, T) padded with -1,
    lengths (B,)).  A frame's argmax symbol is kept when it is not blank and
    differs from the previous frame's argmax — the same rule as
    ``repro.core.ctc.ctc_greedy_decode``."""
    T, B, _ = log_probs.shape
    best = log_probs.argmax(dim=-1).T                       # (B, T)
    prev = torch.cat([torch.full((B, 1), -1, dtype=best.dtype,
                                 device=best.device), best[:, :-1]], dim=1)
    keep = (best != blank) & (best != prev)
    out = torch.full((B, T), -1, dtype=best.dtype, device=best.device)
    lens = keep.sum(dim=1)
    for b in range(B):
        row = best[b][keep[b]]
        out[b, :row.numel()] = row
    return out, lens
