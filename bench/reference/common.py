"""The two kinds of number a reference compares: the widest gap of a value
and the count of exact codes that differ."""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def max_gap(got: Sequence, want: Sequence[torch.Tensor]) -> float:
    """The largest absolute difference over every element of every pair
    whose lengths agree (a missing row is another number's to count)."""
    gaps = [float(np.abs(np.asarray(g, np.float64)
                         - w.double().cpu().numpy()).max())
            for g, w in zip(got, want) if len(g) == len(w) and len(g)]
    return max(gaps) if gaps else 0.0


def mismatches(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]
               ) -> int:
    """Codes that differ, every code of a pair whose shapes differ."""
    return sum(int((torch.as_tensor(g).to(torch.int16)
                    != w.cpu().to(torch.int16)).sum())
               if tuple(g.shape) == tuple(w.shape) else int(w.numel())
               for g, w in zip(got, want))
