"""The plain float32 peephole LSTM stack with its read-out and
``log_softmax``: CTC-3L-421H-UNI as Graves et al. (ICASSP 2013) write it,

    i = sigma(W_xi x + W_hi h + p_i * c + b_i)
    f = sigma(W_xf x + W_hf h + p_f * c + b_f)
    g = tanh(W_xg x + W_hg h + b_g)
    c' = f * c + i * g
    o = sigma(W_xo x + W_ho h + p_o * c' + b_o)
    h' = o * tanh(c')

layer after layer from zero state, then log_softmax(W_out h + b_out).
Matrix products run in float32 with TF32 off.  ``precision='tf32'`` is the
control: every product's operands rounded to TF32 (10 mantissa bits, to
nearest, ties away from zero, as the tensor cores' ``cvt.rna`` does), the
sums in float32, so it reads the same on any device.

The weights and frames are the benchmark's own (``bench/weights.py``),
made from the seed; the program gets the same.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from bench import weights as _weights
from bench import yardstick

from .common import max_gap

GATES = 4
I, F, G, O = 0, 1, 2, 3


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == 'tf32':
        a, b = to_tf32(a), to_tf32(b)
    elif precision != 'float32':
        raise ValueError(f'precision float32 or tf32, not {precision!r}')
    return a @ b


def _layer(layer: dict, xs: torch.Tensor, precision: str) -> torch.Tensor:
    """One layer over (T, n, n_in) from zero state -> hs (T, n, N)."""
    w_x, w_h, peep, b = (layer[k] for k in ('w_x', 'w_h', 'w_peep', 'b'))
    N = w_h.shape[1]
    T, n = xs.shape[:2]
    pre_x = _mm(xs.reshape(T * n, -1), w_x.reshape(GATES * N, -1).T,
                precision).view(T, n, GATES, N)
    w_hT = w_h.reshape(GATES * N, N).T
    h = xs.new_zeros((n, N))
    c = xs.new_zeros((n, N))
    hs = []
    for t in range(T):
        pre = pre_x[t] + _mm(h, w_hT, precision).view(n, GATES, N)
        i = torch.sigmoid(pre[:, I] + peep[0] * c + b[I])
        f = torch.sigmoid(pre[:, F] + peep[1] * c + b[F])
        g = torch.tanh(pre[:, G] + b[G])
        c = f * c + i * g
        o = torch.sigmoid(pre[:, O] + peep[2] * c + b[O])
        h = o * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs)


def log_probs(weights: dict, frames: Sequence[torch.Tensor],
              precision: str = 'float32', block: int = 64
              ) -> List[torch.Tensor]:
    """Per-frame log-probs of each (L_i, n_x) float32 sequence in
    ``frames`` (on the weights' device), as (L_i, n_out) tensors on that
    device.  Sequences run ``block`` at a time, zero-padded to the longest
    of their block (a later frame never changes an earlier output)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out: List[torch.Tensor] = []
        for lo in range(0, len(frames), block):
            seqs = frames[lo:lo + block]
            T = max(len(s) for s in seqs)
            xs = seqs[0].new_zeros((T, len(seqs), seqs[0].shape[1]))
            for j, s in enumerate(seqs):
                xs[:len(s), j] = s
            with torch.no_grad():
                h = xs
                for layer in weights['layers']:
                    h = _layer(layer, h, precision)
                logits = (_mm(h.reshape(T * len(seqs), -1),
                              weights['w_out'].T, precision)
                          + weights['b_out']).view(T, len(seqs), -1)
                lp = torch.log_softmax(logits, dim=-1)
            out += [lp[:len(s), j] for j, s in enumerate(seqs)]
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


make_weights = _weights.make_weights


def make_inputs(cfg: dict, n_frames: int, seed: int, device) -> torch.Tensor:
    return _weights.make_frame_pool(n_frames, cfg['n_x'], seed, device)


def macs_per_frame(cfg: dict) -> int:
    return yardstick.macs_per_frame(cfg['n_x'], cfg['n_h'], cfg['n_layers'],
                                    cfg['n_out'])


def readings(weights: dict, frames: Sequence[torch.Tensor],
             got: Optional[List[dict]]) -> dict:
    """``logprob_gap``: the largest |log-prob - reference| over every frame
    and class of the requests; the program's log-probs are ``got``'s
    ``lp``, the control's the TF32 reference's."""
    want = log_probs(weights, frames)
    lp = ([g.cpu() for g in log_probs(weights, frames, precision='tf32')]
          if got is None else [s['lp'] for s in got])
    return {'logprob_gap': max_gap(lp, want)}
