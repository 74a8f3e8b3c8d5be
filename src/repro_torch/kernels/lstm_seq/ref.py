"""Plain PyTorch versions of the four persistent LSTM kernels.

Each is a Python loop over steps with its kernel's exact contract — per-layer
h0/c0 in, a (T, B) bool mask whose masked steps re-emit the carried h and
keep c, and the full h/c trajectories out — so the CPU path and the card's
kernel are interchangeable.

* f32 (K1, K2): hoisted ``pre_x`` (T, B, 4, N_h) in; allclose to the kernels,
  which sum in another order.  Each step's gate math is
  ``core.lstm._cell_body``.  K1's plain version is also the ``torch_scan``
  backend's masked scan.
* int8 (K3, K4): the silicon datapath, bit-identical to the kernels.  Each
  step is ``core.systolic.tile_products`` (exact per-tile MACs), a sat16 per
  tile partial, the serial ``saturating_hops`` chain, and the integer
  epilogue ``core.systolic._quantized_state_update`` — the same functions
  ``systolic_cell_quantized`` runs, so the integer tail has one source.
"""
from __future__ import annotations

import torch

from ...core.lstm import _cell_body
from ...core.systolic import (_quantized_state_update, _sat16,
                              saturating_hops, tile_products)


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


def _engine_tiles(w, tile):
    """(4, P_h, K) dense weights -> (R, C, 4, tile, tile) engine tiles."""
    _, p_h, k = w.shape
    return w.reshape(4, p_h // tile, tile, k // tile, tile).permute(
        1, 3, 0, 2, 4)


def _row_blocks(a, tile):
    """(k, P_h) per-row constants -> (R, k, tile) engine-row blocks, int32."""
    k, p_h = a.shape
    return a.reshape(k, p_h // tile, tile).permute(1, 0, 2).to(torch.int32)


def _select_step(m, h_new, c_new, h, c):
    """Masked step = identity on the carried codes (pure select)."""
    m = m[:, None]
    return torch.where(m, h_new, h), torch.where(m, c_new, c)


def lstm_seq_quantized_ref(xs_q, w_q, peep_q, bias_q, sig_lut, tanh_lut, h0,
                           c0, mask, *, tile: int, cols_x: int):
    """K3's contract.  xs_q: (T, B, padded_x) int8 frame codes; w_q: (4,
    padded_h, padded_in) int8 dense ``[W_x | W_h]`` tiles; peep_q: (3,
    padded_h) int8; bias_q: (4, padded_h) int16; sig_lut, tanh_lut: (256,)
    int8; h0, c0: (B, padded_h) int8; mask: (T, B) bool.  Per step, for each
    row tile: the x-region column tiles then the h-region ones, each an
    exact tile MAC saturated to int16 and hopped serially.  Returns (hs, cs),
    each (T, B, padded_h) int8."""
    _, p_h, p_in = w_q.shape
    R, C = p_h // tile, p_in // tile
    tiles = _engine_tiles(w_q, tile)
    peep32, bias32 = _row_blocks(peep_q, tile), _row_blocks(bias_q, tile)
    B = h0.shape[0]
    h, c = h0, c0
    hs, cs = [], []
    for t in range(xs_q.shape[0]):
        cols = torch.cat([xs_q[t], h], dim=-1).reshape(B, C, tile)
        acc = saturating_hops(_sat16(tile_products(tiles, cols)))
        h_new, c_new = _quantized_state_update(
            acc, c.reshape(B, R, tile).to(torch.int32), peep32, bias32,
            sig_lut, tanh_lut)
        h, c = _select_step(mask[t], h_new.reshape(B, p_h),
                            c_new.reshape(B, p_h), h, c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def lstm_stack_seq_quantized_ref(acc_x, w_in, w_h, peep, bias, sig_lut,
                                 tanh_lut, h0, c0, mask, *, tile: int):
    """K4's contract, in its wavefront order.  acc_x: (T, B, R, 4, tile)
    int32 layer-0 x-region hop prefix; w_in: (L-1, 4, padded_h, padded_h)
    int8 below-h weights of layers 1..L-1; w_h: (L, 4, padded_h, padded_h)
    int8 own-h weights; peep: (L, 3, padded_h) int8; bias: (L, 4, padded_h)
    int16; LUTs (256,) int8; h0, c0: (L, B, padded_h) int8; mask: (T, B)
    bool shared by every layer.  Diagonal ``d`` runs layer ``l`` at step
    ``d - l``: an inner layer hops over the layer below's h_t codes, then
    its own h_{t-1}; layer 0 resumes from ``acc_x`` with its own-h hops.
    Returns (hs, cs), each layer-major (L, T, B, padded_h) int8."""
    T, L = acc_x.shape[0], w_h.shape[0]
    B, p_h = h0.shape[1], h0.shape[2]
    R = p_h // tile
    hs = h0.new_zeros((L, T, B, p_h))
    cs = torch.zeros_like(hs)
    for d in range(T + L - 1):
        for l in range(L):
            t = d - l
            if not 0 <= t < T:
                continue                      # fill/drain bubble
            h = h0[l] if t == 0 else hs[l, t - 1]
            c = c0[l] if t == 0 else cs[l, t - 1]
            if l == 0:
                tiles, cols, prefix = _engine_tiles(w_h[0], tile), h, acc_x[t]
            else:
                tiles = _engine_tiles(torch.cat([w_in[l - 1], w_h[l]], -1),
                                      tile)
                cols, prefix = torch.cat([hs[l - 1, t], h], -1), None
            parts = _sat16(tile_products(tiles, cols.reshape(B, -1, tile)))
            acc = saturating_hops(parts, prefix)
            h_new, c_new = _quantized_state_update(
                acc, c.reshape(B, R, tile).to(torch.int32),
                _row_blocks(peep[l], tile), _row_blocks(bias[l], tile),
                sig_lut, tanh_lut)
            hs[l, t], cs[l, t] = _select_step(
                mask[t], h_new.reshape(B, p_h), c_new.reshape(B, p_h), h, c)
    return hs, cs
