"""Connectionist Temporal Classification: the loss (log-semiring forward
algorithm) and best-path decoding, the port of ``repro.core.ctc``.

Conventions as in the reference: ``log_probs`` is (T, B, K) log-softmax
output, ``labels`` is (B, L) (padded; entries past ``label_lengths`` are
ignored), blank index 0 by default; the collapsed decode output is (B, T)
padded with -1.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..op_cost import steps

NEG_INF = -1e30


def _logaddexp3(a, b, c):
    """log(e^a + e^b + e^c) with ``NEG_INF`` as the log of zero.  The double
    ``where`` keeps the sum strictly positive on a dead branch, so the log's
    gradient never forms inf * 0 = NaN under the outer select."""
    m = torch.maximum(torch.maximum(a, b), c)
    dead = m == NEG_INF
    m_safe = torch.where(dead, 0.0, m)
    s = (torch.exp(a - m_safe) + torch.exp(b - m_safe)
         + torch.exp(c - m_safe))
    s = torch.where(dead, 1.0, s)
    return torch.where(dead, NEG_INF, m_safe + torch.log(s))


def ctc_loss(log_probs: torch.Tensor, labels: torch.Tensor,
             input_lengths: torch.Tensor, label_lengths: torch.Tensor,
             blank: int = 0) -> torch.Tensor:
    """Negative log-likelihood per sequence, shape (B,); ``-NEG_INF`` for an
    infeasible sequence, with finite gradients.

    log_probs: (T, B, K) log-softmax over K classes (blank included);
    labels: (B, L) without blanks.  The emission of every extended symbol
    is picked by a one-hot product, whose backward is a product too: a
    gather's backward accumulates with atomics on the card, and the
    gradients would then differ from run to run.
    """
    T, B, K = log_probs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = log_probs.device
    labels, label_lengths = labels.long(), label_lengths.long()

    # extended label sequence: blank, l1, blank, l2, ..., lL, blank
    ext = torch.full((B, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels
    # skip alpha[s-2] -> alpha[s] iff ext[s] is a label unlike ext[s-2]
    ext_m2 = torch.cat([torch.full((B, 2), -1, dtype=torch.int64,
                                   device=dev), ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & (ext != ext_m2)
    ext_len = 2 * label_lengths + 1
    valid = torch.arange(S, device=dev)[None, :] < ext_len[:, None]
    one_hot = torch.nn.functional.one_hot(ext, K).to(log_probs.dtype)
    emit = torch.einsum('tbk,bsk->tbs', log_probs, one_hot)   # (T, B, S)

    neg = lambda n: log_probs.new_full((B, n), NEG_INF)
    first = torch.where(label_lengths > 0, emit[0, :, 1], NEG_INF)
    alpha = torch.cat([emit[0, :, :1], first[:, None], neg(S - 2)], dim=1)
    alpha = torch.where(valid, alpha, NEG_INF)
    for t in steps(range(1, T), log_probs):
        shift1 = torch.cat([neg(1), alpha[:, :-1]], dim=1)
        shift2 = torch.where(can_skip,
                             torch.cat([neg(2), alpha[:, :-2]], dim=1),
                             NEG_INF)
        new = _logaddexp3(alpha, shift1, shift2) + emit[t]
        new = torch.where(valid, new, NEG_INF)
        # freeze alpha for sequences already past their input length
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)

    # total probability ends at the last blank or the last label
    end_blank = alpha.gather(1, (ext_len - 1)[:, None])[:, 0]
    end_label = alpha.gather(1, (ext_len - 2).clamp(min=0)[:, None])[:, 0]
    end_label = torch.where(label_lengths > 0, end_label, NEG_INF)
    m = torch.maximum(end_blank, end_label)
    dead = m == NEG_INF
    m_safe = torch.where(dead, 0.0, m)
    s = torch.exp(end_blank - m_safe) + torch.exp(end_label - m_safe)
    s = torch.where(dead, 1.0, s)
    return -torch.where(dead, NEG_INF, m_safe + torch.log(s))


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
