"""Public ops of the fused whole-stack wavefront kernels (K2, K4).

``lstm_stack_seq`` is the counterpart of ``repro.kernels.lstm_seq
.stack_ops.lstm_stack_seq``: one wavefront launch for every layer of a
homogeneous stack (the dense read-out stays at the call site).  Layer 0's
``W_x @ x`` is hoisted into a plain ``torch.einsum``; the inner layers'
input products run inside the kernel against their resident ``W_in`` rows.
The kernel's weight layout (``StackWeights``) is built by
``stack_kernel_weights`` once per parameter set; a server builds it when it
starts and passes it to every chunk.  Unmasked, ``lstm_stack_seq`` is
differentiable (``lstm_stack_seq_fused``: forward K2, backward the
cross-layer gate recompute); built per call, the stacked weights pass
their gradients back to the per-layer parameters.

``lstm_stack_seq_quantized`` is the int8 counterpart (K4): bit-identical to
chaining ``lstm_layer_seq_quantized`` layer by layer, one launch instead of
L, with the opaque per-layer ``(h_q, c_q)`` carry and the valid-length mask.
Layer 0's x-region hop prefix is hoisted (``core.systolic
.quantized_x_prefix``).  ``stack_kernel_weights_q`` builds the weights of
both launch shapes from one relayout per layer (``QuantizedStackWeights``:
K3's dense layers and K4's stacked below-h and own-h weights), once per set
of quantized layers.  ``lstm_stack_seq_quantized_auto`` picks the fused or
the layerwise launch shape; both speak the STACK state layout.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ...core.lstm import (LSTMStackParams, hoisted_input,
                          lstm_stack_bwd_recompute_gates,
                          quantized_fused_admissible,
                          select_quantized_stack_backend, stack_carry_arrays,
                          valid_len_mask)
from ...core.systolic import (QuantizedPackedLSTM, SystolicPlan,
                              quantized_x_prefix)
from .ops import (QuantizedLayerWeights, _dense_from_tiles,
                  lstm_layer_seq_quantized)
from .stack_kernel import lstm_stack_seq_kernel, lstm_stack_seq_kernel_q


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
    per parameter set, not per chunk (training builds it per step, and its
    gradient flows back to the layers)."""
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


class _StackSeqFused(torch.autograd.Function):
    """K2 over the whole stack, unmasked; backward
    ``core.lstm.lstm_stack_bwd_recompute_gates`` from the saved layer-major
    trajectories.  Returns (ys = top layer's hs, h_T, c_T), the finals
    (L, B, N_h)."""

    @staticmethod
    def forward(ctx, w_in, w_h, peep, b, pre_x, h0s, c0s):
        hs, cs = lstm_stack_seq_kernel(pre_x, w_in, w_h, peep, b, h0s, c0s)
        ctx.save_for_backward(w_in, w_h, peep, b, pre_x, hs, cs, h0s, c0s)
        return hs[-1], hs[:, -1].clone(), cs[:, -1].clone()

    @staticmethod
    def backward(ctx, d_ys, d_hT, d_cT):
        return lstm_stack_bwd_recompute_gates(*ctx.saved_tensors,
                                              (d_ys, (d_hT, d_cT)))


def lstm_stack_seq_fused(w_in, w_h, peep, b, pre_x, h0s, c0s):
    """The fused stack with the cross-layer gate-recompute backward: the
    counterpart of the reference's ``lstm_stack_seq_fused`` custom VJP, in
    the port's layout (``w_in`` (L-1, 4, N_h, N_h)).  Returns (ys (T, B,
    N_h), (h_T, c_T) each (L, B, N_h))."""
    ys, h_T, c_T = _StackSeqFused.apply(w_in, w_h, peep, b, pre_x, h0s, c0s)
    return ys, (h_T, c_T)


def lstm_stack_seq(params: LSTMStackParams, xs: torch.Tensor,
                   states: Optional[Sequence] = None, *,
                   valid_len: Optional[torch.Tensor] = None,
                   weights: Optional[StackWeights] = None):
    """Fused drop-in for the layer loop of ``core.lstm.lstm_stack_apply``
    / ``lstm_stack_chunk`` (everything but the read-out): ONE wavefront
    launch for all layers, allclose to the layerwise composition.

    xs: (T, B, N_x); states: optional per-layer ``((h, c), ...)`` carries;
    ``valid_len`` (B,) masks steps ``t >= valid_len[b]`` in every layer
    (identity on each layer's carried state; inference-only, as in the
    reference); ``weights``: the stack's ``stack_kernel_weights``, built
    here when None (and then differentiable back to ``params``).  Returns
    (hs_top (T, B, N_h), per-layer ((h_T, c_T), ...)).
    """
    if weights is None:
        weights = stack_kernel_weights(params)
    if xs.ndim != 3:
        raise ValueError('lstm_stack_seq expects (T, B, N_x) input')
    layers = params.layers
    L, n_h = len(layers), layers[0].n_h
    T, B = xs.shape[0], xs.shape[1]
    h0s, c0s = stack_carry_arrays(states, L, B, n_h, xs)
    pre_x = hoisted_input(layers[0].w_x, xs)
    if valid_len is None:
        ys, (h_T, c_T) = lstm_stack_seq_fused(
            weights.w_in, weights.w_h, weights.peep, weights.b, pre_x, h0s,
            c0s)
        return ys, tuple((h_T[l], c_T[l]) for l in range(L))
    hs, cs = lstm_stack_seq_kernel(pre_x, weights.w_in, weights.w_h,
                                   weights.peep, weights.b, h0s, c0s,
                                   valid_len_mask(T, valid_len, B))
    return hs[-1], tuple((hs[l, -1], cs[l, -1]) for l in range(L))


# ---------------------------------------------------------------------------
# int8 path — whole-stack silicon datapath
# ---------------------------------------------------------------------------

def quantized_stack_plan(qps: Sequence[QuantizedPackedLSTM]) -> SystolicPlan:
    """Layer 0's plan, after checking that the quantized layers form a stack
    the fused kernel takes: one tile and one hidden width, and every inner
    layer consuming that width.  Raises ``ValueError`` otherwise."""
    plans = [qp.plan for qp in qps]
    if not plans:
        raise ValueError('an int8 stack needs at least one layer')
    p0 = plans[0]
    if not (all(p.tile == p0.tile and p.n_h == p0.n_h for p in plans)
            and all(p.n_x == p0.n_h for p in plans[1:])):
        raise ValueError('the fused int8 stack needs one tile and one hidden '
                         'width, inner layers consuming it')
    return p0


@dataclasses.dataclass(frozen=True)
class QuantizedStackWeights:
    """The int8 stack's kernel weights for both launch shapes.  ``layers``
    are K3's dense layouts, one per layer; the rest is K4's, stacked over
    layers, each row (gate, n) contiguous over its inputs.  Layer 0 has no
    below-h weights: its x-region prefix is hoisted."""
    layers: Tuple[QuantizedLayerWeights, ...]
    w_in: torch.Tensor       # (L-1, 4, padded_h, padded_h) int8, below-h
    w_h: torch.Tensor        # (L, 4, padded_h, padded_h) int8, own-h
    peep: torch.Tensor       # (L, 3, padded_h) int8
    bias: torch.Tensor       # (L, 4, padded_h) int16
    sig_lut: torch.Tensor    # (256,) int8
    tanh_lut: torch.Tensor   # (256,) int8


def stack_kernel_weights_q(qps: Sequence[QuantizedPackedLSTM]
                           ) -> QuantizedStackWeights:
    """Copy the quantized layers into the layouts of K3 and K4, on their
    device (5.0 and 4.6 MB at CTC-3L-421H-UNI width).  A copy: build it
    once per set of quantized layers, not per chunk."""
    p0 = quantized_stack_plan(qps)
    layers = tuple(_dense_from_tiles(qp) for qp in qps)
    p_h, p_x = p0.padded_h, p0.padded_x
    w_h = torch.stack([layers[0].w[:, :, p_x:]]
                      + [lw.w[:, :, p_h:] for lw in layers[1:]])
    if len(layers) > 1:
        w_in = torch.stack([lw.w[:, :, :p_h] for lw in layers[1:]])
    else:
        w_in = w_h.new_zeros((0,) + tuple(w_h.shape[1:]))
    return QuantizedStackWeights(
        layers=layers, w_in=w_in, w_h=w_h,
        peep=torch.stack([lw.peep for lw in layers]),
        bias=torch.stack([lw.bias for lw in layers]),
        sig_lut=qps[0].sig_lut.contiguous(),
        tanh_lut=qps[0].tanh_lut.contiguous())


def lstm_stack_seq_quantized(qps: Sequence[QuantizedPackedLSTM],
                             xs_q: torch.Tensor, *,
                             state: Optional[Tuple[torch.Tensor,
                                                   torch.Tensor]] = None,
                             valid_len: Optional[torch.Tensor] = None,
                             return_state: bool = False,
                             weights: Optional[QuantizedStackWeights] = None):
    """Whole-stack int8 wavefront execution: bit-identical to chaining
    ``lstm_layer_seq_quantized`` (and so the silicon reference scan) layer
    by layer, one K4 launch instead of L.

    xs_q: (T, B, n_x) int8 codes.  ``state``: opaque per-layer carry
    ``(h_q, c_q)``, each (L, B, padded_h) int8 as returned with
    ``return_state=True`` (None = zero state); ``valid_len``: (B,) ragged
    mask shared by every layer; ``weights``: ``stack_kernel_weights_q(qps)``,
    built here when None.  Returns the top layer's (T, B, n_h) int8 hidden
    codes, plus the state tuple when ``return_state``.
    """
    p0 = quantized_stack_plan(qps)
    if xs_q.ndim != 3:
        raise ValueError('lstm_stack_seq_quantized expects (T, B, n_x)')
    if weights is None:
        weights = stack_kernel_weights_q(qps)
    L, T, B = len(qps), xs_q.shape[0], xs_q.shape[1]
    acc_x = quantized_x_prefix(qps[0], xs_q).contiguous()
    if state is None:
        h0 = c0 = xs_q.new_zeros((L, B, p0.padded_h))
    else:
        h0, c0 = state[0].contiguous(), state[1].contiguous()
    mask = None if valid_len is None else valid_len_mask(T, valid_len, B)
    hs, cs = lstm_stack_seq_kernel_q(
        acc_x, weights.w_in, weights.w_h, weights.peep, weights.bias,
        weights.sig_lut, weights.tanh_lut, h0, c0, mask, tile=p0.tile)
    out = hs[-1, ..., :p0.n_h]
    if not return_state:
        return out
    return out, (hs[:, -1], cs[:, -1])


def lstm_stack_seq_quantized_auto(qps: Sequence[QuantizedPackedLSTM],
                                  xs_q: torch.Tensor, *,
                                  state: Optional[Tuple[torch.Tensor,
                                                        torch.Tensor]] = None,
                                  valid_len: Optional[torch.Tensor] = None,
                                  return_state: bool = False,
                                  weights: Optional[
                                      QuantizedStackWeights] = None,
                                  backend: str = 'auto'):
    """Shape-dispatched whole-stack int8 execution: the fused wavefront
    (``lstm_stack_seq_quantized``, K4) or the layerwise chain of
    ``lstm_layer_seq_quantized`` (K3) calls.  ``auto`` asks
    ``core.lstm.select_quantized_stack_backend``; an explicit ``'fused'``
    that K4 cannot take on this device raises ``ValueError``, never
    replaced.  Bit-identical either way, and both speak the STACK state
    layout (``(h_q, c_q)``, each (L, B, padded_h) int8), so a chunked caller
    can carry state across chunks whichever shape each chunk ran.
    ``weights``: ``stack_kernel_weights_q(qps)``, which both shapes read
    (built per call when None)."""
    if xs_q.ndim != 3:
        raise ValueError('lstm_stack_seq_quantized_auto expects (T, B, n_x)')
    T, B = xs_q.shape[0], xs_q.shape[1]
    p0 = qps[0].plan
    if backend == 'auto':
        backend = select_quantized_stack_backend(
            p0.n_h, len(qps), T, B, device=xs_q.device, tile=p0.tile)
    if backend not in ('fused', 'layerwise'):
        raise ValueError(f"backend must be auto|fused|layerwise, got "
                         f"{backend!r}")
    if backend == 'fused':
        if (xs_q.device.type == 'cuda' and not quantized_fused_admissible(
                p0.n_h, len(qps), B, xs_q.device, p0.tile)):
            raise ValueError(f'the fused int8 stack is not admissible on '
                             f'{xs_q.device}: N_h={p0.n_h}, L={len(qps)}, '
                             f'B={B}, tile={p0.tile}')
        return lstm_stack_seq_quantized(
            qps, xs_q, state=state, valid_len=valid_len,
            return_state=return_state, weights=weights)
    out = xs_q
    h_fin, c_fin = [], []
    for l, qp in enumerate(qps):
        st_l = None if state is None else (state[0][l], state[1][l])
        out, (h_l, c_l) = lstm_layer_seq_quantized(
            qp, out, state=st_l, valid_len=valid_len, return_state=True,
            weights=None if weights is None else weights.layers[l])
        h_fin.append(h_l)
        c_fin.append(c_l)
    if not return_state:
        return out
    return out, (torch.stack(h_fin), torch.stack(c_fin))
