"""Public ops of K5 and K6: the fused cell (``lstm_cell_fused``, K6) and the
per-step kernel scanned over time with the training backward (K5, the
``cuda_step`` backend).

Counterpart of ``repro.kernels.lstm_gates.ops`` (``lstm_cell_fused``,
``_step_forward``, ``lstm_step_fused``, ``lstm_layer_fused``).  In the
layer, the non-recurrent ``W_x @ x`` is hoisted out of the loop
(``core.lstm.hoisted_input``), so each of the T launches pays only the
recurrent W_h h product.  No padding to the TPU's blocks or to B = 8: the
kernels take any N_in, N_h and B with bounds checks.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.lstm import LSTMParams, hoisted_input, recompute_gates_layer
from .kernel import _gates_rec, lstm_gates


def lstm_cell_fused(params: LSTMParams, x_t: torch.Tensor,
                    h_prev: torch.Tensor, c_prev: torch.Tensor):
    """Same contract as ``core.lstm.lstm_cell``, through K6: the packed
    weights [W_x | W_h] and inputs [x_t; h_prev], as the reference's op
    builds them on every call.  x_t: (B, N_x); h_prev, c_prev: (B, N_h).
    Returns (h, c), each (B, N_h).  Not differentiable (the reference's
    kernel has no VJP)."""
    w = torch.cat([params.w_x, params.w_h], dim=-1)
    xh = torch.cat([x_t, h_prev], dim=-1)
    return lstm_gates(xh, w, params.w_peep, params.b, c_prev.contiguous())


def _step_forward(w_h, w_peep, b, pre_x, h0, c0):
    """T launches of K5 over the hoisted ``pre_x`` (T, B, 4, N_h), each
    reading the state the previous one wrote.  No other kernel runs between
    two of them, so launches 2 .. T overlap the one before (``early``).
    Returns (hs, cs), each (T, B, N_h)."""
    h, c = h0, c0
    hs, cs = [], []
    for t, pre_t in enumerate(pre_x):
        h, c = _gates_rec(h, w_h, pre_t, w_peep, b, c, early=t > 0)
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
                     c0: Optional[torch.Tensor] = None, *,
                     return_state: bool = False):
    """Scan K5 over time.  xs: (T, B, N_x) -> hs (T, B, N_h), or (hs, (h_T,
    c_T)) with ``return_state``, the reference op's contract.
    Differentiable (gate recompute)."""
    B = xs.shape[1]
    zeros = xs.new_zeros((B, params.n_h))
    h0 = zeros if h0 is None else h0.contiguous()
    c0 = zeros if c0 is None else c0.contiguous()
    hs, state = lstm_step_fused(params.w_h, params.w_peep, params.b,
                                hoisted_input(params.w_x, xs), h0, c0)
    return (hs, state) if return_state else hs
