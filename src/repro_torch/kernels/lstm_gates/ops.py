"""Public ops of K5: the per-step kernel scanned over time, with the
training backward — the ``cuda_step`` backend.

Counterpart of ``repro.kernels.lstm_gates.ops`` (``_step_forward``,
``lstm_step_fused``, ``lstm_layer_fused``).  The non-recurrent ``W_x @ x``
is hoisted out of the loop (``core.lstm.hoisted_input``), so each of the T
launches pays only the recurrent W_h h product.  No padding to the TPU's
blocks or to B = 8: the kernel takes any N_h and B with bounds checks.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.lstm import LSTMParams, hoisted_input, recompute_gates_layer
from .kernel import lstm_gates_rec


def _step_forward(w_h, w_peep, b, pre_x, h0, c0):
    """T launches of K5 over the hoisted ``pre_x`` (T, B, 4, N_h), each
    reading the state the previous one wrote.  Returns (hs, cs), each
    (T, B, N_h)."""
    h, c = h0, c0
    hs, cs = [], []
    for pre_t in pre_x:
        h, c = lstm_gates_rec(h, w_h, pre_t, w_peep, b, c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def lstm_step_fused(w_h, w_peep, b, pre_x, h0, c0):
    """The per-step kernel layer with the shared gate-recompute backward,
    so ``cuda_step`` is trainable just like ``cuda_seq``.  pre_x: (T, B, 4,
    N_h); h0, c0: (B, N_h) contiguous.  Returns (hs, (h_T, c_T))."""
    return recompute_gates_layer(_step_forward, w_h, w_peep, b, pre_x, h0,
                                 c0)


def lstm_layer_fused(params: LSTMParams, xs: torch.Tensor,
                     h0: Optional[torch.Tensor] = None,
                     c0: Optional[torch.Tensor] = None):
    """Scan K5 over time.  xs: (T, B, N_x) -> (hs (T, B, N_h), (h_T,
    c_T)).  Differentiable (gate recompute)."""
    B = xs.shape[1]
    zeros = xs.new_zeros((B, params.n_h))
    h0 = zeros if h0 is None else h0.contiguous()
    c0 = zeros if c0 is None else c0.contiguous()
    return lstm_step_fused(params.w_h, params.w_peep, params.b,
                           hoisted_input(params.w_x, xs), h0, c0)
