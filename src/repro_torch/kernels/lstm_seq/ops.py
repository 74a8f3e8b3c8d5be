"""Public op of the persistent layer kernel (K1), forward only.

``lstm_layer_seq`` is the counterpart of ``repro.kernels.lstm_seq.ops
.lstm_layer_seq``: the hoisted ``W_x @ x`` product stays a plain
``torch.einsum`` (the reference leaves it to XLA outside the kernel), the
recurrence runs in one ``lstm_seq`` launch.  No padding: the kernel takes
any N_h and B with bounds checks.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.lstm import LSTMParams, hoisted_input, valid_len_mask
from .kernel import lstm_seq


def lstm_layer_seq(params: LSTMParams, xs: torch.Tensor,
                   h0: Optional[torch.Tensor] = None,
                   c0: Optional[torch.Tensor] = None, *,
                   valid_len: Optional[torch.Tensor] = None):
    """Drop-in for ``core.lstm.lstm_layer`` through the persistent kernel:
    allclose to the scan (same recurrence, sums in another order).

    xs: (T, B, N_x) -> (hs (T, B, N_h), (h_T, c_T)).  ``valid_len`` (B,)
    makes steps ``t >= valid_len[b]`` identity on the state, so (h_T, c_T)
    is the state after exactly ``valid_len[b]`` steps and chunked calls are
    bit-equal to one monolithic call.
    """
    T, B = xs.shape[0], xs.shape[1]
    zeros = xs.new_zeros((B, params.n_h))
    h0 = zeros if h0 is None else h0
    c0 = zeros if c0 is None else c0
    mask = None if valid_len is None else valid_len_mask(T, valid_len, B)
    pre_x = hoisted_input(params.w_x, xs)
    hs, cs = lstm_seq(pre_x, params.w_h, params.w_peep, params.b,
                      h0.contiguous(), c0.contiguous(), mask)
    return hs, (hs[-1], cs[-1])
