"""Plain PyTorch versions of the per-step f32 gate kernels.

``lstm_gates_rec_ref`` is K5's (``lstm_gates_rec``): the accumulator starts
at the hoisted ``pre`` = W_x x_t, adds W_h h, then the peephole epilogue —
``core.lstm._cell_body``, the one gate epilogue of every plain loop.
``lstm_gates_ref`` is the reference's oracle of the packed-cell kernel
(``repro.kernels.lstm_gates.ref.lstm_gates_ref``): the whole [x; h] product
from zero, then the same epilogue.  Gate order i, f, g, o.
"""
from __future__ import annotations

import torch

from ...core.lstm import _cell_body, _gate_phase


def lstm_gates_rec_ref(h, w_h, pre, peep, bias, c_prev):
    """K5's contract.  h: (B, N_h); w_h: (4, N_h, N_h); pre: (B, 4, N_h);
    peep: (3, N_h); bias: (4, N_h); c_prev: (B, N_h).  Returns (h, c), each
    (B, N_h)."""
    return _cell_body(w_h, peep, bias, pre, h, c_prev)


def lstm_gates_ref(xh, w, peep, bias, c_prev):
    """xh: (B, N_in); w: (4, N_h, N_in); peep: (3, N_h); bias: (4, N_h);
    c_prev: (B, N_h).  Returns (h, c), each (B, N_h)."""
    h, c, _ = _gate_phase(torch.einsum('ghk,bk->bgh', w, xh), peep, bias,
                          c_prev)
    return h, c
