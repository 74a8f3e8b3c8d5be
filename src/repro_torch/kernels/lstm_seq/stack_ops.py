"""Public op of the fused whole-stack wavefront kernel (K2), forward only.

``lstm_stack_seq`` is the counterpart of ``repro.kernels.lstm_seq
.stack_ops.lstm_stack_seq``: one wavefront launch for every layer of a
homogeneous stack (the dense read-out stays at the call site).  Layer 0's
``W_x @ x`` is hoisted into a plain ``torch.einsum``; the inner layers'
input products run inside the kernel against their resident ``W_in`` rows.
The kernel's weight layout (``StackWeights``) is built by
``stack_kernel_weights`` once per parameter set; a server builds it when it
starts and passes it to every chunk.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ...core.lstm import (LSTMStackParams, hoisted_input, stack_carry_arrays,
                          valid_len_mask)
from .stack_kernel import lstm_stack_seq_kernel


def stack_fused_compatible(params: LSTMStackParams) -> bool:
    """Structural admission for the fused stack kernel (pure dispatch, no
    numerics): True iff every layer shares one hidden width and every inner
    layer's input width equals it."""
    layers = params.layers
    if not layers:
        return False
    n_h = layers[0].n_h
    return (all(l.n_h == n_h for l in layers)
            and all(l.n_x == n_h for l in layers[1:]))


@dataclasses.dataclass(frozen=True)
class StackWeights:
    """The fused kernel's weights, stacked over layers.  Layer 0's input
    weights are not here: they ride as the hoisted ``pre_x``."""
    w_in: torch.Tensor   # (L-1, 4, N_h, N_h) input weights of layers 1..L-1
    w_h: torch.Tensor    # (L, 4, N_h, N_h)
    peep: torch.Tensor   # (L, 3, N_h)
    b: torch.Tensor      # (L, 4, N_h)


def stack_kernel_weights(params: LSTMStackParams) -> StackWeights:
    """Copy a homogeneous stack's per-layer weights into the fused kernel's
    layout (``StackWeights``), on the params' device.  A copy: build it once
    per parameter set, not per chunk."""
    if not stack_fused_compatible(params):
        raise ValueError('the fused stack kernel needs homogeneous hidden '
                         'widths (stack_fused_compatible)')
    layers = params.layers
    w_h = torch.stack([l.w_h for l in layers])
    if len(layers) > 1:
        w_in = torch.stack([l.w_x for l in layers[1:]])
    else:
        w_in = w_h.new_zeros((0,) + tuple(w_h.shape[1:]))
    return StackWeights(w_in=w_in, w_h=w_h,
                        peep=torch.stack([l.w_peep for l in layers]),
                        b=torch.stack([l.b for l in layers]))


def lstm_stack_seq(params: LSTMStackParams, xs: torch.Tensor,
                   states: Optional[Sequence] = None, *,
                   valid_len: Optional[torch.Tensor] = None,
                   weights: Optional[StackWeights] = None):
    """Fused drop-in for the layer loop of ``core.lstm.lstm_stack_apply``
    / ``lstm_stack_chunk`` (everything but the read-out): ONE wavefront
    launch for all layers, allclose to the layerwise composition.

    xs: (T, B, N_x); states: optional per-layer ``((h, c), ...)`` carries;
    ``valid_len`` (B,) masks steps ``t >= valid_len[b]`` in every layer
    (identity on each layer's carried state); ``weights``: the stack's
    ``stack_kernel_weights``, built here when None.  Returns (hs_top
    (T, B, N_h), per-layer ((h_T, c_T), ...)).
    """
    if weights is None:
        weights = stack_kernel_weights(params)
    if xs.ndim != 3:
        raise ValueError('lstm_stack_seq expects (T, B, N_x) input')
    layers = params.layers
    L, n_h = len(layers), layers[0].n_h
    T, B = xs.shape[0], xs.shape[1]
    h0s, c0s = stack_carry_arrays(states, L, B, n_h, xs)
    mask = None if valid_len is None else valid_len_mask(T, valid_len, B)
    hs, cs = lstm_stack_seq_kernel(hoisted_input(layers[0].w_x, xs),
                                   weights.w_in, weights.w_h, weights.peep,
                                   weights.b, h0s, c0s, mask)
    return hs[-1], tuple((hs[l, -1], cs[l, -1]) for l in range(L))
