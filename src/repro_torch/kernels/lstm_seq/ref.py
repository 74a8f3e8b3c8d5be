"""Plain PyTorch versions of the two persistent LSTM kernels.

Each is a Python loop over steps with its kernel's exact contract — hoisted
``pre_x`` (T, B, 4, N_h), per-layer h0/c0 in, a (T, B) bool mask whose
masked steps re-emit the carried h and keep c, and the full h/c
trajectories out — so the CPU path and the card's kernel are
interchangeable (allclose; the kernels sum in another order).  Each step's
gate math is ``core.lstm._cell_body``.  K1's plain version is also the
``torch_scan`` backend's masked scan.
"""
from __future__ import annotations

import torch

from ...core.lstm import _cell_body


def lstm_seq_ref(pre_x, w_h, peep, bias, h0, c0, mask):
    """K1's contract.  pre_x: (T, B, 4, N_h); w_h: (4, N_h, N_h); peep:
    (3, N_h); bias: (4, N_h); h0, c0: (B, N_h); mask: (T, B) bool.
    Returns (hs, cs), each (T, B, N_h)."""
    h, c = h0, c0
    hs, cs = [], []
    for t in range(pre_x.shape[0]):
        h_new, c_new = _cell_body(w_h, peep, bias, pre_x[t], h, c)
        m = mask[t][:, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def lstm_stack_seq_ref(pre_x, w_in, w_h, peep, bias, h0, c0, mask):
    """K2's contract, in its wavefront order.  pre_x: (T, B, 4, N_h) for
    layer 0; w_in: (L-1, 4, N_h, N_h) input weights of layers 1..L-1; w_h:
    (L, 4, N_h, N_h); peep: (L, 3, N_h); bias: (L, 4, N_h); h0, c0:
    (L, B, N_h); mask: (T, B) bool shared by every layer.  Diagonal ``d``
    runs layer ``l`` at step ``d - l``.  Returns (hs, cs), each layer-major
    (L, T, B, N_h)."""
    T = pre_x.shape[0]
    L = w_h.shape[0]
    hs = pre_x.new_zeros((L, T) + h0.shape[1:])
    cs = torch.zeros_like(hs)
    for d in range(T + L - 1):
        for l in range(L):
            t = d - l
            if not 0 <= t < T:
                continue                      # fill/drain bubble
            h = h0[l] if t == 0 else hs[l, t - 1]
            c = c0[l] if t == 0 else cs[l, t - 1]
            pre_in = (pre_x[t] if l == 0 else
                      torch.einsum('ghk,bk->bgh', w_in[l - 1], hs[l - 1, t]))
            h_new, c_new = _cell_body(w_h[l], peep[l], bias[l], pre_in, h, c)
            m = mask[t][:, None]
            hs[l, t] = torch.where(m, h_new, h)
            cs[l, t] = torch.where(m, c_new, c)
    return hs, cs
