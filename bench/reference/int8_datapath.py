"""A frozen plain copy of the Chipmunk silicon's saturating int8 datapath
(the paper's Sec. 3: weight-stationary engines of ``TILE`` x ``TILE``,
8-bit codes, 16-bit saturating partial-sum hops, LUT activations), which
quantizes the benchmark's float32 weights itself.

Formats: weights, peepholes, inputs and states in Q2.5 (int8); biases and
the accumulator in Q5.10 (int16 range); gates in Q0.7 from 256-entry LUTs;
the cell update in Q3.12.  A layer is tiled on R x C engines (R = ceil(N /
TILE) rows of hidden units, C = ceil(n_in / TILE) + R columns: the input's
column tiles, then the hidden state's).  Each engine's tile product is
exact, saturated to int16, and the row's accumulator takes the columns in
order, saturating after each hop.  Rounding: ``round`` half to even when
float values are quantized; a rounding right shift (add half, shift
arithmetically) inside the datapath.  The read-out is float32 on the
dequantized top-layer codes, then ``log_softmax``.

``weight_bits=4`` is the control: the same datapath with weights and
peepholes rounded to 4-bit codes (Q2.1, scaled into the Q2.5 datapath).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .common import max_gap, mismatches
# the float32 configuration's weights and frames, quantized here
from .f32_stack import macs_per_frame, make_inputs, make_weights  # noqa: F401

TILE = 96
STATE_FRAC, ACC_FRAC, CELL_FRAC, GATE_FRAC = 5, 10, 12, 7
INT16_MIN, INT16_MAX = -(2 ** 15), 2 ** 15 - 1
GATES = 4
I, F, G, O = 0, 1, 2, 3
PEEP_I, PEEP_F, PEEP_O = 0, 1, 2
TIME_BLOCK = 256     # steps of the input-region products computed at once


def _sat16(x):
    return torch.clamp(x, INT16_MIN, INT16_MAX)


def _rshift_round(x, shift: int):
    return (x + (1 << (shift - 1))) >> shift


def quantize(x: torch.Tensor, frac: int = STATE_FRAC, bits: int = 8
             ) -> torch.Tensor:
    """Float -> int32 codes of a signed ``bits``-bit format with ``frac``
    fraction bits, rounding half to even."""
    lim = 2 ** (bits - 1)
    return torch.clamp(torch.round(x / 2.0 ** -frac), -lim, lim - 1
                       ).to(torch.int32)


def luts(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sigmoid, tanh) tables: Q2.5 input code + 128 -> Q0.7 code."""
    codes = np.arange(-128, 128) * 2.0 ** -STATE_FRAC
    out = []
    for vals in (1.0 / (1.0 + np.exp(-codes)), np.tanh(codes)):
        q = np.clip(np.round(vals / 2.0 ** -GATE_FRAC), -128, 127)
        out.append(torch.from_numpy(q.astype(np.int64)).to(device))
    return tuple(out)


def _weight_codes(w: torch.Tensor, weight_bits: int) -> torch.Tensor:
    if weight_bits == 8:
        return quantize(w, STATE_FRAC, 8)
    frac = STATE_FRAC - (8 - weight_bits)
    return quantize(w, frac, weight_bits) << (8 - weight_bits)


def quantize_layer(layer: dict, weight_bits: int = 8) -> dict:
    """One float32 layer's engine tiles in codes: ``tiles`` (R, C, 4, t, t)
    float64 holding integer codes (exact products), ``peep`` (R, 3, t) and
    ``bias`` (R, 4, t) int32, with the plan's sizes."""
    w_x, w_h, peep, b = (layer[k] for k in ('w_x', 'w_h', 'w_peep', 'b'))
    N, n_in = w_h.shape[1], w_x.shape[2]
    R, cx = math.ceil(N / TILE), math.ceil(n_in / TILE)
    C = cx + R
    pad_h, pad_x = R * TILE, cx * TILE
    w = w_h.new_zeros((GATES, pad_h, C * TILE))
    w[:, :N, :n_in] = w_x
    w[:, :N, pad_x:pad_x + N] = w_h
    tiles = w.reshape(GATES, R, TILE, C, TILE).permute(1, 3, 0, 2, 4)
    p = w_h.new_zeros((3, pad_h))
    p[:, :N] = peep
    bias = w_h.new_zeros((GATES, pad_h))
    bias[:, :N] = b
    return dict(
        tiles=_weight_codes(tiles, weight_bits).to(torch.float64),
        peep=_weight_codes(p, weight_bits).view(3, R, TILE).permute(1, 0, 2),
        bias=_sat16(torch.round(bias / 2.0 ** -ACC_FRAC)).to(torch.int32)
        .view(GATES, R, TILE).permute(1, 0, 2),
        N=N, n_in=n_in, R=R, cx=cx)


def _hops(partials: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """acc = sat16(acc + sat16(p_c)) over the column axis (-3) in order."""
    for c in range(partials.shape[-3]):
        acc = _sat16(acc + _sat16(partials[..., c, :, :]))
    return acc


def _products(tiles: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Exact tile products: tiles (R, C', 4, t, t) float64 codes, cols
    (..., C', t) int32 -> (..., R, C', 4, t) int32."""
    p = torch.einsum('rcgij,...cj->...rcgi', tiles, cols.to(torch.float64))
    return p.to(torch.int32)


def _epilogue(pre, c_prev, peep, bias, sig, tanh):
    """Gates -> LUTs -> c_t -> h_t in integers; pre (n, R, 4, t) Q5.10,
    c_prev (n, R, t) Q2.5 codes -> (h (n, R, t), c (n, R, t)) codes."""
    def gate(idx, p_idx, c_term, lut):
        a = pre[:, :, idx] + bias[:, idx]
        if p_idx is not None:
            a = a + peep[:, p_idx] * c_term
        a8 = torch.clamp(_rshift_round(_sat16(a), ACC_FRAC - STATE_FRAC),
                         -128, 127)
        return lut[a8 + 128]
    i = gate(I, PEEP_I, c_prev, sig)
    f = gate(F, PEEP_F, c_prev, sig)
    g = gate(G, None, None, tanh)
    c_new = _sat16(f * c_prev + _rshift_round(i * g, 2))
    c8 = torch.clamp(_rshift_round(c_new, CELL_FRAC - STATE_FRAC), -128, 127)
    o = gate(O, PEEP_O, c8, sig)
    h = torch.clamp(_rshift_round(o * tanh[c8 + 128], 14 - STATE_FRAC),
                    -128, 127)
    return h, c8


def _layer(q: dict, xs: torch.Tensor, sig, tanh) -> torch.Tensor:
    """One quantized layer over (T, n, n_in) int32 codes from zero state ->
    (T, n, N) int32 hidden codes."""
    T, n = xs.shape[:2]
    N, R, cx = q['N'], q['R'], q['cx']
    xpad = xs.new_zeros((T, n, cx * TILE))
    xpad[..., :q['n_in']] = xs
    xcols = xpad.view(T, n, cx, TILE)
    tiles_x, tiles_h = q['tiles'][:, :cx], q['tiles'][:, cx:]
    acc_x = torch.cat([
        _hops(_products(tiles_x, xcols[lo:lo + TIME_BLOCK]),
              xs.new_zeros((min(TIME_BLOCK, T - lo), n, R, GATES, TILE)))
        for lo in range(0, T, TIME_BLOCK)])
    h = xs.new_zeros((n, R * TILE))
    c = xs.new_zeros((n, R, TILE))
    hs = []
    for t in range(T):
        pre = _hops(_products(tiles_h, h.view(n, R, TILE)), acc_x[t])
        hb, c = _epilogue(pre, c, q['peep'], q['bias'], sig, tanh)
        h = hb.reshape(n, R * TILE)
        h[:, N:] = 0
        hs.append(h[:, :N])
    return torch.stack(hs)


def run(weights: dict, frames: Sequence[torch.Tensor], weight_bits: int = 8,
        block: int = 64) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Top-layer hidden codes (L_i, N) int8 and log-probs (L_i, n_out)
    float32 of each (L_i, n_x) float32 sequence in ``frames``, on the
    weights' device; sequences ``block`` at a time, zero-padded."""
    dev = weights['w_out'].device
    qs = [quantize_layer(l, weight_bits) for l in weights['layers']]
    sig, tanh = luts(dev)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    codes: List[torch.Tensor] = []
    lps: List[torch.Tensor] = []
    try:
        for lo in range(0, len(frames), block):
            seqs = frames[lo:lo + block]
            T = max(len(s) for s in seqs)
            xs = torch.zeros((T, len(seqs), seqs[0].shape[1]),
                             dtype=torch.int32, device=dev)
            for j, s in enumerate(seqs):
                xs[:len(s), j] = quantize(s)
            with torch.no_grad():
                h = xs
                for q in qs:
                    h = _layer(q, h, sig, tanh)
                hf = h.to(torch.float32) * 2.0 ** -STATE_FRAC
                logits = hf @ weights['w_out'].T + weights['b_out']
                lp = torch.log_softmax(logits, dim=-1)
            codes += [h[:len(s), j].to(torch.int8) for j, s in enumerate(seqs)]
            lps += [lp[:len(s), j] for j, s in enumerate(seqs)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return codes, lps


def readings(weights: dict, frames: Sequence[torch.Tensor],
             got: Optional[List[dict]]) -> dict:
    """``code_mismatches``: top-layer codes that differ from the datapath's
    (``got``'s ``codes``, or the 4-bit control's); ``logprob_gap``: the
    largest |log-prob - reference| (``got``'s ``lp``)."""
    codes, want = run(weights, frames)
    if got is None:
        got_codes, got_lp = run(weights, frames, weight_bits=4)
    else:
        got_codes = [s['codes'] for s in got]
        got_lp = [s['lp'] for s in got]
    return {'code_mismatches': mismatches(got_codes, codes),
            'logprob_gap': max_gap([g.cpu() if torch.is_tensor(g) else g
                                    for g in got_lp], want)}
