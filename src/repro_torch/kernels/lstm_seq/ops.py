"""Public ops of the persistent layer kernels (K1, K3), forward only.

``lstm_layer_seq`` is the counterpart of ``repro.kernels.lstm_seq.ops
.lstm_layer_seq``: the hoisted ``W_x @ x`` product stays a plain
``torch.einsum`` (the reference leaves it to XLA outside the kernel), the
recurrence runs in one ``lstm_seq`` launch.  No padding: the kernel takes
any N_h and B with bounds checks.

``lstm_layer_seq_quantized`` is the counterpart of ``.ops
.lstm_layer_seq_quantized``: the whole int8 layer in one
``lstm_seq_quantized`` launch, with the opaque padded-layout ``(h_q, c_q)``
chunk carry and the valid-length mask.  Its dense weight layout
(``QuantizedLayerWeights``, ``_dense_from_tiles``) is a copy: a caller that
runs many chunks builds it once per quantized layer and passes it in.  The
reference's ``bb`` batch block is a TPU grid knob and has no counterpart
here.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ...core.lstm import LSTMParams, hoisted_input, valid_len_mask
from ...core.systolic import QuantizedPackedLSTM
from .kernel import lstm_seq, lstm_seq_quantized


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


# ---------------------------------------------------------------------------
# int8 path — whole-sequence systolic datapath
# ---------------------------------------------------------------------------

class QuantizedLayerWeights(NamedTuple):
    """K3's weights for one quantized layer, in dense padded layout."""
    w: torch.Tensor      # (4, padded_h, padded_in) int8 [W_x | W_h] tiles
    peep: torch.Tensor   # (3, padded_h) int8
    bias: torch.Tensor   # (4, padded_h) int16


def _dense_from_tiles(qp: QuantizedPackedLSTM) -> QuantizedLayerWeights:
    """(R, C, 4, t, t) engine tiles -> dense (4, R*t, C*t) layout, with the
    peepholes (3, R*t) and biases (4, R*t).  A pure relayout of the
    quantized codes (no re-rounding), contiguous: a copy of the layer."""
    r, c, g, t, _ = qp.tiles_q.shape
    w = qp.tiles_q.permute(2, 0, 3, 1, 4).reshape(g, r * t, c * t)
    peep = qp.peep_q.permute(1, 0, 2).reshape(3, r * t)
    bias = qp.bias_q.permute(1, 0, 2).reshape(4, r * t)
    return QuantizedLayerWeights(w.contiguous(), peep.contiguous(),
                                 bias.contiguous())


def lstm_layer_seq_quantized(qp: QuantizedPackedLSTM, xs_q: torch.Tensor, *,
                             state: Optional[Tuple[torch.Tensor,
                                                   torch.Tensor]] = None,
                             valid_len: Optional[torch.Tensor] = None,
                             return_state: bool = False,
                             weights: Optional[QuantizedLayerWeights] = None):
    """Whole-sequence form of ``core.systolic.systolic_layer_quantized``:
    bit-identical int8 hidden codes, one kernel launch instead of T.

    xs_q: (T, ..., n_x) int8 codes -> (T, ..., n_h) int8 hidden codes.
    ``state``: opaque carry of ``(h_q, c_q)`` padded-layout int8 codes, each
    (..., padded_h), as returned by a previous call with
    ``return_state=True`` (None = zero state); ``valid_len`` (B,) masks the
    ragged tail steps per stream (identity on the carried codes), so feeding
    a sequence chunk by chunk is bit-identical to the monolithic call;
    ``weights``: ``_dense_from_tiles(qp)``, built here when None.  With
    ``return_state=True`` returns ``(hs, (h_q, c_q))``.
    """
    plan = qp.plan
    batch_shape = tuple(xs_q.shape[1:-1])
    T = xs_q.shape[0]
    b = math.prod(batch_shape)
    xs_pad = xs_q.new_zeros((T, b, plan.padded_x))
    xs_pad[..., :plan.n_x] = xs_q.reshape(T, b, plan.n_x)
    h0_q = c0_q = mask = None
    if state is not None:
        h0_q = state[0].reshape(b, plan.padded_h).contiguous()
        c0_q = state[1].reshape(b, plan.padded_h).contiguous()
    if valid_len is not None:
        mask = valid_len_mask(T, valid_len, b)
    if weights is None:
        weights = _dense_from_tiles(qp)
    hs, cs = lstm_seq_quantized(xs_pad, *weights, qp.sig_lut,
                                qp.tanh_lut, h0_q, c0_q, mask,
                                tile=plan.tile, cols_x=plan.cols_x)
    out = hs[..., :plan.n_h].reshape((T,) + batch_shape + (plan.n_h,))
    if not return_state:
        return out
    return out, (hs[-1].reshape(batch_shape + (plan.padded_h,)),
                 cs[-1].reshape(batch_shape + (plan.padded_h,)))
