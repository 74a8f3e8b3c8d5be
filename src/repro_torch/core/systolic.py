"""Systolic LSTM execution on one device — contributions C1 and C2, in PyTorch.

Port of the single-device part of ``repro.core.systolic``.  The paper runs
one LSTM on an R x C grid of engines; each engine holds a ``tile x tile``
block of the packed 4-gate weight matrix ``W = [W_x | W_h]``.  Per timestep
the packed input ``[x_t | h_{t-1}]`` is cut into C column slices, every
engine MACs its tile against its slice, the partial sums hop across each row
of engines in 16-bit saturating arithmetic, and the last column applies the
LUT nonlinearities and the state update for its row chunk of ``h_t``/``c_t``.

  * ``systolic_cell_tiled`` / ``systolic_layer_tiled`` — float arithmetic,
    allclose to ``core.lstm.lstm_cell`` / ``lstm_layer``.
  * ``systolic_cell_quantized`` / ``systolic_layer_quantized`` — the
    bit-exactness reference of the int8 path: int8 storage, per-tile int32
    MACs saturated to int16, a serial saturating hop over the column tiles,
    and the integer epilogue ``_quantized_state_update``.  The kernels K3
    and K4 (``kernels.lstm_seq``) and their plain versions are bit-identical
    to scanning it.

The integer tile products run as float32 products: every term is at most
128 * 128 and one tile sums ``tile`` of them, so every partial sum is an
integer below 2**24 and float32 holds it exactly (``tile <= 1024``).  That
keeps one code path for CPU and CUDA tensors (PyTorch has no integer matmul
on CUDA).  The mesh registry and the distributed forms are not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import quant
from .lstm import GATES, I, F, G, O, PEEP_I, PEEP_F, PEEP_O, LSTMParams

N_LSTM_SILICON = 96  # rows per engine in the fabricated chip
MAX_EXACT_TILE = 1024  # tile * 128 * 128 <= 2**24: float32 tile sums are exact


# ---------------------------------------------------------------------------
# Tiling plan + weight packing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SystolicPlan:
    """Block layout of one LSTM layer on an R x C engine grid.

    The x-region of the packed input is padded to a whole number of tiles so
    the h-region starts tile-aligned: column c < cols_x consumes input-state
    slices, column c >= cols_x consumes hidden-state slices.
    """

    n_x: int
    n_h: int
    tile: int = N_LSTM_SILICON

    @property
    def rows(self) -> int:  # R: output (hidden) chunks
        return math.ceil(self.n_h / self.tile)

    @property
    def cols_x(self) -> int:
        return math.ceil(self.n_x / self.tile)

    @property
    def cols_h(self) -> int:
        return math.ceil(self.n_h / self.tile)

    @property
    def cols(self) -> int:  # C: input chunks
        return self.cols_x + self.cols_h

    @property
    def padded_h(self) -> int:
        return self.rows * self.tile

    @property
    def padded_x(self) -> int:
        return self.cols_x * self.tile

    @property
    def padded_in(self) -> int:
        return self.cols * self.tile


class PackedLSTM(NamedTuple):
    """Weight tiles in engine layout (a lossless relayout of LSTMParams)."""

    tiles: torch.Tensor   # (R, C, 4, tile, tile)
    peep: torch.Tensor    # (R, 3, tile)
    bias: torch.Tensor    # (R, 4, tile)
    plan_shape: Tuple[int, int, int, int]  # (n_x, n_h, tile, cols_x)

    @property
    def plan(self) -> SystolicPlan:
        n_x, n_h, tile, _ = self.plan_shape
        return SystolicPlan(n_x, n_h, tile)


def pack_lstm(params: LSTMParams, plan: SystolicPlan) -> PackedLSTM:
    """Block [W_x | W_h] into (R, C, 4, t, t) engine tiles (zero padding),
    on the params' device.  Layout only, lossless."""
    t = plan.tile
    w = params.w_x.new_zeros((GATES, plan.padded_h, plan.padded_in))
    w[:, :params.w_x.shape[1], :plan.n_x] = params.w_x
    w[:, :params.w_h.shape[1],
      plan.padded_x:plan.padded_x + plan.n_h] = params.w_h
    tiles = w.reshape(GATES, plan.rows, t, plan.cols, t).permute(1, 3, 0, 2, 4)
    peep = params.w_peep.new_zeros((3, plan.padded_h))
    peep[:, :plan.n_h] = params.w_peep
    bias = params.b.new_zeros((GATES, plan.padded_h))
    bias[:, :plan.n_h] = params.b
    return PackedLSTM(
        tiles=tiles.contiguous(),
        peep=peep.reshape(3, plan.rows, t).permute(1, 0, 2).contiguous(),
        bias=bias.reshape(GATES, plan.rows, t).permute(1, 0, 2).contiguous(),
        plan_shape=(plan.n_x, plan.n_h, plan.tile, plan.cols_x))


def pack_xh(x: torch.Tensor, h: torch.Tensor, plan: SystolicPlan
            ) -> torch.Tensor:
    """(..., n_x), (..., n_h) -> column blocks (..., C, tile): a zero-padded
    relayout with no arithmetic."""
    batch = x.shape[:-1]
    xh = x.new_zeros(batch + (plan.padded_in,))
    xh[..., :plan.n_x] = x
    xh[..., plan.padded_x:plan.padded_x + plan.n_h] = h
    return xh.reshape(batch + (plan.cols, plan.tile))


def unpack_h(h_blocks: torch.Tensor, plan: SystolicPlan) -> torch.Tensor:
    """(..., R, tile) -> (..., n_h): drops the zero padding, no arithmetic."""
    return h_blocks.reshape(h_blocks.shape[:-2]
                            + (plan.padded_h,))[..., :plan.n_h]


# ---------------------------------------------------------------------------
# Float tiled execution (paper dataflow, fp arithmetic)
# ---------------------------------------------------------------------------

def systolic_cell_tiled(packed: PackedLSTM, x_t: torch.Tensor,
                        h_prev: torch.Tensor, c_prev_blocks: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One timestep in the systolic dataflow, float arithmetic: allclose to
    ``core.lstm.lstm_cell`` on the unpacked parameters.  c_prev_blocks:
    (..., R, tile).  Returns (h_full (..., n_h), h_blocks, c_blocks)."""
    plan = packed.plan
    xh = pack_xh(x_t, h_prev, plan)
    pre = torch.einsum('rcgij,...cj->...rgi', packed.tiles, xh)
    peep, b = packed.peep, packed.bias
    i = torch.sigmoid(pre[..., I, :] + peep[:, PEEP_I] * c_prev_blocks
                      + b[:, I])
    f = torch.sigmoid(pre[..., F, :] + peep[:, PEEP_F] * c_prev_blocks
                      + b[:, F])
    g = torch.tanh(pre[..., G, :] + b[:, G])
    c_t = f * c_prev_blocks + i * g
    o = torch.sigmoid(pre[..., O, :] + peep[:, PEEP_O] * c_t + b[:, O])
    h_blocks = o * torch.tanh(c_t)
    return unpack_h(h_blocks, plan), h_blocks, c_t


def systolic_layer_tiled(packed: PackedLSTM, xs: torch.Tensor
                         ) -> torch.Tensor:
    """Step the tiled cell over time from zero state.  xs: (T, ..., n_x) ->
    (T, ..., n_h); allclose to ``core.lstm.lstm_layer``."""
    plan = packed.plan
    batch = xs.shape[1:-1]
    h = xs.new_zeros(batch + (plan.n_h,))
    c = xs.new_zeros(batch + (plan.rows, plan.tile))
    hs = []
    for x_t in xs:
        h, _, c = systolic_cell_tiled(packed, x_t, h, c)
        hs.append(h)
    return torch.stack(hs)


# ---------------------------------------------------------------------------
# Bit-accurate quantized execution (contribution C2)
# ---------------------------------------------------------------------------

# Fixed-point layout (see quant.py): weights/states Q2.5 (int8), gates Q0.7
# (int8), accumulator Q5.10 (int16, saturating at every inter-engine hop).
ACC_FMT = quant.QFormat(int_bits=5, frac_bits=10)
CELL_FMT = quant.QFormat(int_bits=3, frac_bits=12)  # f*c / i*g alignment


class QuantizedPackedLSTM(NamedTuple):
    """Engine tiles in the silicon's fixed-point formats (quantize_packed)."""

    tiles_q: torch.Tensor   # int8 (R, C, 4, t, t)
    peep_q: torch.Tensor    # int8 (R, 3, t)
    bias_q: torch.Tensor    # int16 (R, 4, t) in ACC_FMT
    sig_lut: torch.Tensor   # int8 (256,)
    tanh_lut: torch.Tensor  # int8 (256,)
    plan_shape: Tuple[int, int, int, int]

    @property
    def plan(self) -> SystolicPlan:
        n_x, n_h, tile, _ = self.plan_shape
        return SystolicPlan(n_x, n_h, tile)


def quantize_packed(packed: PackedLSTM) -> QuantizedPackedLSTM:
    """Quantize engine tiles to the silicon formats (weights/peep Q2.5 int8,
    biases Q5.10 int16, LUT tables for the activations), on the tiles'
    device.  Deterministic round half to even, as in the reference."""
    wf, sf = quant.WEIGHT_FMT, quant.STATE_FMT
    bias_codes = torch.clamp(torch.round(packed.bias / ACC_FMT.scale),
                             quant.INT16_MIN, quant.INT16_MAX).to(torch.int16)
    sig, tanh = quant.default_luts(sf, packed.tiles.device)
    return QuantizedPackedLSTM(
        tiles_q=quant.quantize(packed.tiles, wf),
        peep_q=quant.quantize(packed.peep, wf),
        bias_q=bias_codes, sig_lut=sig, tanh_lut=tanh,
        plan_shape=packed.plan_shape)


_sat16 = quant.saturate_int16
_rshift_round = quant.rshift_round


def tile_products(tiles_q: torch.Tensor, cols_q: torch.Tensor
                  ) -> torch.Tensor:
    """Exact per-engine tile MACs, before saturation.  tiles_q: (R, C, 4, t,
    t) int8; cols_q: (..., C, t) int8 -> (..., R, C, 4, t) int32, each the
    full-precision sum of one tile's ``t`` products (in float32, exact for
    ``t <= MAX_EXACT_TILE``)."""
    tile = tiles_q.shape[-1]
    if tile > MAX_EXACT_TILE:
        raise ValueError(f'tile {tile} > {MAX_EXACT_TILE}: float32 tile sums '
                         f'would not be exact')
    p = torch.einsum('rcgij,...cj->...rcgi', tiles_q.to(torch.float32),
                     cols_q.to(torch.float32))
    return p.to(torch.int32)


def saturating_hops(partials: torch.Tensor,
                    acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The silicon's row accumulation: ``acc = sat16(acc + p_c)`` serially
    over the column axis (-3) of partials (..., C, 4, t) int32, from ``acc``
    (..., 4, t) (None = zero).  Hop order matters for saturation."""
    if acc is None:
        acc = torch.zeros_like(partials[..., 0, :, :])
    for c in range(partials.shape[-3]):
        acc = _sat16(acc + partials[..., c, :, :])
    return acc


def _quantized_state_update(pre_acc, c_prev32, peep32, bias32, sig_lut,
                            tanh_lut):
    """Silicon elementwise epilogue: gates -> LUTs -> c_t -> h_t, int only.

    The one source of the bit-exact datapath tail: ``systolic_cell_quantized``
    and the plain versions of K3 and K4 call it, and the CUDA kernels repeat
    it operation for operation from one header (``csrc/lstm_q_epilogue.cuh``).  pre_acc: (..., R, 4, t) int32 in ACC_FMT;
    c_prev32: (..., R, t) int32 codes; peep32: (R, 3, t); bias32: (R, 4, t).
    Returns (h_blocks8, c_new8), both int8 codes in STATE_FMT.
    """
    sf = quant.STATE_FMT

    def gate(idx, peep_idx, c_term, lut):
        a = pre_acc[..., idx, :] + bias32[..., idx, :]
        if peep_idx is not None:
            a = a + peep32[..., peep_idx, :] * c_term  # Q2.5 * Q2.5, aligned
        a = _sat16(a)
        a8 = torch.clamp(_rshift_round(a, ACC_FMT.frac_bits - sf.frac_bits),
                         -128, 127)
        return quant.apply_lut(lut, a8, sf).to(torch.int32)

    i = gate(I, PEEP_I, c_prev32, sig_lut)
    f = gate(F, PEEP_F, c_prev32, sig_lut)
    g = gate(G, None, None, tanh_lut)

    # c_t = f.c + i.g : align Q0.7*Q2.5 (frac 12) with Q0.7*Q0.7 (frac 14) >> 2.
    fc = f * c_prev32                       # frac 12
    ig = _rshift_round(i * g, 2)            # frac 14 -> 12
    c_new = _sat16(fc + ig)                 # Q3.12
    c_new8 = torch.clamp(_rshift_round(c_new, CELL_FMT.frac_bits
                                       - sf.frac_bits), -128, 127)

    o = gate(O, PEEP_O, c_new8, sig_lut)
    tanh_c = quant.apply_lut(tanh_lut, c_new8, sf).to(torch.int32)
    h_new = _rshift_round(o * tanh_c, 14 - sf.frac_bits)
    h_blocks8 = torch.clamp(h_new, -128, 127).to(torch.int8)
    return h_blocks8, c_new8.to(torch.int8)


def systolic_cell_quantized(qp: QuantizedPackedLSTM, x_q: torch.Tensor,
                            h_q: torch.Tensor, c_q_blocks: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One timestep in integer arithmetic, per the silicon datapath — the
    bit-exactness reference of the int8 path.  x_q: (..., n_x) int8 codes
    (Q2.5); h_q: (..., n_h) int8; c_q_blocks: (..., R, t) int8.  Returns
    (h_q_new (..., n_h), c_q_blocks_new (..., R, t))."""
    plan = qp.plan
    xh_q = pack_xh(x_q, h_q, plan)                        # (..., C, t) int8
    # Per-engine tile MAC in wide arithmetic, saturated to the 16-bit value
    # an engine hands to its row neighbour, then the serial hop.
    partials = _sat16(tile_products(qp.tiles_q, xh_q))    # (..., R, C, 4, t)
    pre_acc = saturating_hops(partials)                   # (..., R, 4, t)
    h_blocks8, c_new8 = _quantized_state_update(
        pre_acc, c_q_blocks.to(torch.int32), qp.peep_q.to(torch.int32),
        qp.bias_q.to(torch.int32), qp.sig_lut, qp.tanh_lut)
    return unpack_h(h_blocks8, plan), c_new8


def systolic_layer_quantized(qp: QuantizedPackedLSTM, xs_q: torch.Tensor
                             ) -> torch.Tensor:
    """Step the integer cell over time from zero state.  xs_q: (T, ..., n_x)
    int8 -> (T, ..., n_h) int8 hidden codes; the whole-sequence int8 forms
    are tested against this function."""
    plan = qp.plan
    batch = xs_q.shape[1:-1]
    h = xs_q.new_zeros(batch + (plan.n_h,))
    c = xs_q.new_zeros(batch + (plan.rows, plan.tile))
    hs = []
    for x_t in xs_q:
        h, c = systolic_cell_quantized(qp, x_t, h, c)
        hs.append(h)
    return torch.stack(hs)


def _x_prefix_fold(tiles_x: torch.Tensor, xcols: torch.Tensor
                   ) -> torch.Tensor:
    """Core of ``quantized_x_prefix``: per-tile int32 MACs saturated to
    int16, then the serial hop over the x-region columns.  tiles_x:
    (R, C_x, 4, t, t) int8; xcols: (T, B, C_x, t) int8 -> (T, B, R, 4, t)
    int32 in ACC_FMT."""
    return saturating_hops(_sat16(tile_products(tiles_x, xcols)))


def quantized_x_prefix(qp: QuantizedPackedLSTM, xs_q: torch.Tensor
                       ) -> torch.Tensor:
    """The x-region prefix of the saturating hop chain — the first
    ``cols_x`` hops, which depend only on the frame codes — for the whole
    sequence.  Bit-identical to folding those columns inside the step loop,
    so K4's layer 0 resumes the chain from exactly the state the silicon
    would hold.  xs_q: (T, B, n_x) int8 -> (T, B, R, 4, tile) int32."""
    plan = qp.plan
    T, B = xs_q.shape[0], xs_q.shape[1]
    if not plan.cols_x:
        return torch.zeros((T, B, plan.rows, GATES, plan.tile),
                           dtype=torch.int32, device=xs_q.device)
    xs_pad = xs_q.new_zeros((T, B, plan.padded_x))
    xs_pad[..., :plan.n_x] = xs_q
    xcols = xs_pad.reshape(T, B, plan.cols_x, plan.tile)
    return _x_prefix_fold(qp.tiles_q[:, :plan.cols_x], xcols)
