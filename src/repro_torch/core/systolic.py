"""Systolic LSTM execution — contributions C1, C2 and C3, in PyTorch.

Port of ``repro.core.systolic``.  The paper runs one LSTM on an R x C grid
of engines; each engine holds a ``tile x tile`` block of the packed 4-gate
weight matrix ``W = [W_x | W_h]``.  Per timestep the packed input
``[x_t | h_{t-1}]`` is cut into C column slices, every engine MACs its tile
against its slice, the partial sums hop across each row of engines in
16-bit saturating arithmetic, and the last column applies the LUT
nonlinearities and the state update for its row chunk of ``h_t``/``c_t``.

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
on CUDA).

Multi-engine scale-out (contribution C3, DESIGN.md §6 and §9).  Several
engines cooperate as one systolic array: a ``SystolicMesh`` is a frozen
(stage, row, col) grid of ``torch.device``s, driven by one process, as the
reference's single-controller ``Mesh`` is.  Each engine's weight block
lives on its engine's device, and each collective of the reference is an
explicit op in engine order (``_psum``, ``_all_gather``, ``_ppermute``): a
copy between devices, none between engines that share one.  Engines on one
device run one after another.  The scale-outs:

  * ``systolic_lstm_shard_map`` — the per-step baseline (one engine per
    plan tile, the x-region re-MACed every step); ``core.pipeline`` stacks
    it over a stage axis.
  * ``systolic_lstm_seq`` / ``systolic_lstm_seq_quantized`` — the layerwise
    scale-out of the persistent sequence kernel: ``W_x @ x`` (the int8
    x-region hop prefix) hoisted, each engine's block stationary for the
    whole sequence, per step a ``psum`` over ``col`` (the int8 form gathers
    the column partials and replays the saturating hop in engine order) and
    an ``all_gather`` of the ``h_t`` chunks over ``row``.
  * ``systolic_lstm_stack_seq`` / ``systolic_lstm_stack_seq_quantized`` —
    the staged scale-out of the fused stack: contiguous layer blocks pinned
    to the ``stage`` axis, the layerwise dataflow inside each stage, chunks
    of the hidden sequence handed stage to stage (``ppermute``): the paper's
    3x(5x5) ``graves-75``.

A ``None`` or all-1 mesh degenerates to the single-engine kernels (K1, K3,
K2, K4).  No scale-out function reaches a CUDA kernel of its own: an
engine's block product is a ``torch`` product, as the reference's is an
``einsum`` outside any Pallas kernel.  Every product of a block runs at one
shape per (engine, step) — ``B`` rows — whatever the chunking or the
in-stage order, so both in-stage orders and chunked serving give the same
bits on the card as on the CPU.  The reference's per-stage slot arrays
(``_stage_stack``, ``_stage_live``) are a relayout for ``shard_map``; one
controller walks the layers directly and has no counterpart of them.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import math
from typing import ClassVar, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..op_cost import collective
from . import quant
from .lstm import (GATES, I, F, G, O, PEEP_I, PEEP_F, PEEP_O, LSTMParams,
                   _gate_phase, hoisted_input, recompute_gates_layer,
                   recompute_stack_gates, stack_carry_arrays, valid_len_mask)

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


# ---------------------------------------------------------------------------
# The engine mesh and its registry (DESIGN.md §6)
# ---------------------------------------------------------------------------

AXES = ('stage', 'row', 'col')


def _device(d) -> torch.device:
    """``d`` as a ``torch.device``; a bare ``'cuda'`` is pinned to the
    current card, so that engines on it compare equal and a copy between
    them moves nothing."""
    d = torch.device(d)
    if d.type == 'cuda' and d.index is None and torch.cuda.is_available():
        d = torch.device('cuda', torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True)
class SystolicMesh:
    """A (stage, row, col) grid of engines, each a ``torch.device``, driven
    by one process.  ``devices`` is row-major, stage first: engine
    (s, r, c) is ``devices[(s * rows + r) * cols + c]``.  Several engines
    may share a device.  Within stage s, the engine (s, r, cols - 1)
    finishes row r (its partial sums, gate epilogue and ``c`` state), and
    (s, 0, 0) holds the stage's gathered ``h``."""
    stage: int
    rows: int
    cols: int
    devices: Tuple[torch.device, ...]

    axis_names: ClassVar[Tuple[str, ...]] = AXES

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes in axis order, like the reference mesh's ``shape``."""
        return {'stage': self.stage, 'row': self.rows, 'col': self.cols}

    def engine(self, s: int, r: int, c: int) -> torch.device:
        """The device of engine (s, r, c)."""
        return self.devices[(s * self.rows + r) * self.cols + c]

    def finish(self, s: int, r: int) -> torch.device:
        """The device that finishes row r of stage s."""
        return self.engine(s, r, self.cols - 1)

    def lead(self, s: int) -> torch.device:
        """The device that holds stage s's gathered hidden state."""
        return self.engine(s, 0, 0)


def make_systolic_mesh(rows: int, cols: int, stage: int = 1,
                       devices=None) -> SystolicMesh:
    """A (stage, row, col) engine grid.  ``devices``: None puts every
    engine on ``torch.device('cuda')``; one device (or its name) puts every
    engine there; a sequence places the first ``stage * rows * cols`` in
    row-major order, stage first (the reference's order, which makes the
    gathers' chunk order the engine-tile order)."""
    if min(stage, rows, cols) < 1:
        raise ValueError(f'mesh axes must be >= 1, got stage={stage}, '
                         f'rows={rows}, cols={cols}')
    need = stage * rows * cols
    if devices is None or isinstance(devices, (str, torch.device)):
        devs = (_device('cuda' if devices is None else devices),) * need
    else:
        devs = tuple(_device(d) for d in devices)
        if len(devs) < need:
            raise ValueError(f'need {need} devices, have {len(devs)}')
    return SystolicMesh(stage, rows, cols, devs[:need])


_INSTALLED_MESH: Optional[SystolicMesh] = None


def install_mesh(mesh: SystolicMesh) -> SystolicMesh:
    """Register ``mesh`` as the process-wide systolic mesh and return it.
    ``core.lstm``'s ``auto`` dispatch consults it: a mesh that admits the
    stack (``seq_scaleout_admissible``) makes ``auto`` a scale-out.  Only
    dispatch changes."""
    global _INSTALLED_MESH
    _INSTALLED_MESH = mesh
    return mesh


def current_mesh() -> Optional[SystolicMesh]:
    """The installed systolic mesh, or None (dispatch never scales out)."""
    return _INSTALLED_MESH


def clear_mesh() -> None:
    """Uninstall the systolic mesh."""
    global _INSTALLED_MESH
    _INSTALLED_MESH = None


def _require_systolic_axes(mesh) -> Tuple[int, int]:
    """(rows, cols) of a mesh with ``row`` and ``col`` axes and no other
    live axis; ``ValueError`` otherwise (a live ``stage`` axis belongs to
    the staged scale-out)."""
    names = mesh.axis_names
    if 'row' not in names or 'col' not in names:
        raise ValueError(f"mesh axes {names} lack ('row', 'col')")
    if any(mesh.shape[a] > 1 for a in names if a not in ('row', 'col')):
        raise ValueError('use the staged scale-out (or systolic_pipeline) '
                         'for meshes with a live stage axis')
    return mesh.shape['row'], mesh.shape['col']


def _require_staged_axes(mesh) -> Tuple[int, int, int]:
    """(stages, rows, cols) of a mesh with the three axes and no other
    live axis; ``ValueError`` otherwise."""
    names = mesh.axis_names
    for a in AXES:
        if a not in names:
            raise ValueError(f'mesh axes {names} lack {a!r}')
    if any(mesh.shape[a] > 1 for a in names if a not in AXES):
        raise ValueError('staged scale-out uses only (stage, row, col) axes')
    return mesh.shape['stage'], mesh.shape['row'], mesh.shape['col']


def _scaleout_blocks(n_h: int, mr: int, mc: int) -> Tuple[int, int, int]:
    """Pad N_h so both the row (output) and col (reduction) axes divide
    it: (n_h_p, bn, bk)."""
    n_h_p = -(-n_h // math.lcm(mr, mc)) * math.lcm(mr, mc)
    return n_h_p, n_h_p // mr, n_h_p // mc


def _degenerate(mesh) -> bool:
    """A ``None`` or all-1 mesh: the single-engine kernels run."""
    return mesh is None or all(s == 1 for s in mesh.shape.values())


def engine_budget(mesh) -> Optional[int]:
    """Bytes one engine's resident block may take (rule 3 of DESIGN.md
    §6.2, the port's own): a block re-read every step stays on chip only
    while every block on the card fits its L2, so on a CUDA device the L2
    divided by the engines placed there (the least over the mesh's cards).
    Reads the ``devices`` of a ``SystolicMesh`` or of any view of engines
    (the die mesh's 4-axis view); None (unbounded) when no engine is on a
    card or the mesh names no devices."""
    devices = getattr(mesh, 'devices', None)
    if not devices:
        return None
    budgets = [torch.cuda.get_device_properties(d).L2_cache_size // n
               for d, n in collections.Counter(devices).items()
               if torch.device(d).type == 'cuda']
    return min(budgets) if budgets else None


def seq_scaleout_admissible(n_h: int, mesh, *,
                            n_layers: Optional[int] = None,
                            n_x: int = 0, T: int = 0, batch: int = 0,
                            budget: Optional[int] = None) -> bool:
    """Tile admission for the systolic scale-outs (DESIGN.md §6.2, §9).
    Reads only ``mesh.axis_names`` and ``mesh.shape`` (and, for the
    default budget, the mesh's ``devices``).

    Single-layer form (``n_layers=None``, ``systolic_lstm_seq``): True iff
    the mesh has the ``row`` and ``col`` axes and no other live axis (rule
    1), at least one of them is > 1 (rule 2: an all-1 mesh is the
    single-engine kernel's), and one engine's resident block — 4 gate
    ``bn x bk`` tiles plus the row slice of peepholes and biases, with
    ``bn = n_h_p / rows``, ``bk = n_h_p / cols`` — fits ``budget`` (rule 3;
    None: ``engine_budget(mesh)``).  Rule 4 (the int8 forms' divisibility)
    is checked where they run.

    Stage-aware form (``n_layers`` given, ``systolic_lstm_stack_seq``):
    True iff the mesh has the three axes, no other live one but ``die``
    (folded into the pipeline depth), at least 2 and at most ``n_layers``
    stages, and one engine's block of ``ceil(n_layers / stages)`` layers —
    both weight families plus peepholes and biases — fits the budget.  With
    shape context (``n_x``, ``T``, ``batch``) a tuned uneven split from the
    schedule cache (``resolve_staged_blocks``) sizes the bottleneck stage,
    which can only be stricter.  Admission never changes numerics."""
    if mesh is None:
        return False
    names = mesh.axis_names
    if budget is None:
        budget = engine_budget(mesh)

    def fits(nbytes: int) -> bool:
        return budget is None or nbytes <= budget

    if n_layers is not None:
        if any(a not in names for a in AXES):
            return False
        if any(mesh.shape[a] > 1 for a in names if a not in AXES + ('die',)):
            return False
        stages = mesh.shape['stage']
        if 'die' in names:
            stages *= mesh.shape['die']
        if stages < 2 or stages > n_layers:
            return False
        _, bn, bk = _scaleout_blocks(n_h, mesh.shape['row'],
                                     mesh.shape['col'])
        lb = -(-n_layers // stages)
        tuned = resolve_staged_blocks(n_layers, T, stages, n_h=n_h, n_x=n_x,
                                      batch=batch, mesh=mesh)
        if tuned is not None:
            lb = max(max(tuned), lb)
        return fits(lb * (2 * GATES * bn * bk * 4 + (3 + GATES) * bn * 4))
    try:
        mr, mc = _require_systolic_axes(mesh)
    except ValueError:
        return False
    if mr == 1 and mc == 1:
        return False
    _, bn, bk = _scaleout_blocks(n_h, mr, mc)
    return fits(GATES * bn * bk * 4 + (3 + GATES) * bn * 4)


# ---------------------------------------------------------------------------
# Placement and collectives (one controller, engines in engine order)
# ---------------------------------------------------------------------------

def _psum(parts: Sequence[torch.Tensor], dst: torch.device) -> torch.Tensor:
    """``psum`` over ``col``: a row's partials summed in column order onto
    the device that finishes the row."""
    collective('all-reduce', parts)
    acc = parts[0].to(dst)
    for p in parts[1:]:
        acc = acc + p.to(dst)
    return acc


def _all_gather(chunks: Sequence[torch.Tensor], dst: torch.device,
                dim: int = -1) -> torch.Tensor:
    """Tiled ``all_gather``: the chunks concatenated in engine order onto
    ``dst``."""
    collective('all-gather', chunks)
    return torch.cat([x.to(dst) for x in chunks], dim)


def _ppermute(x: torch.Tensor, dst: torch.device) -> torch.Tensor:
    """``ppermute`` stage s -> s + 1: a copy, none on a shared device."""
    collective('collective-permute', [x])
    return x.to(dst)


class _Replicas:
    """A tensor and its copies on the devices that ask for it, each made
    once (the mask and look-up tables every row engine reads)."""

    def __init__(self, x: torch.Tensor):
        self._on = {x.device: x}
        self._src = x

    def on(self, dev: torch.device) -> torch.Tensor:
        if dev not in self._on:
            self._on[dev] = self._src.to(dev)
        return self._on[dev]


def _keep_fn(mask: Optional[torch.Tensor]):
    """Step t's validity mask as a (B, 1) bool on a given device, or None
    (unmasked: no select at all, so an all-ones mask gives the same bits)."""
    if mask is None:
        return None
    reps = _Replicas(mask[..., None])
    return lambda t: (lambda dev: reps.on(dev)[t])


def _pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad the last axis of ``x`` to ``n``."""
    return torch.nn.functional.pad(x, (0, n - x.shape[-1]))


def _row_split(mesh: SystolicMesh, s: int, x: torch.Tensor, bn: int
               ) -> List[torch.Tensor]:
    """(..., n_h_p) -> row r's (..., bn) slice on the device finishing row
    r of stage s."""
    return [x[..., r * bn:(r + 1) * bn].to(mesh.finish(s, r))
            for r in range(mesh.rows)]


class _Blocks(NamedTuple):
    """One f32 layer placed on the engines of its stage: ``w[r][c]`` the
    (bk, 4*bn) W_h block of engine (s, r, c) (rows r*bn.., inputs c*bk..),
    ``w_in[r][c]`` likewise for an inner layer's input weights (None for a
    layer fed by the hoisted ``pre_x``), ``peep[r]`` (3, bn) and
    ``bias[r]`` (4, bn) on the engine finishing row r."""
    w: tuple
    w_in: Optional[tuple]
    peep: tuple
    bias: tuple


def _engine_blocks(mesh: SystolicMesh, s: int, w: torch.Tensor, n_h_p: int,
                   bn: int, bk: int) -> tuple:
    """W (4, N_h, N_in<=n_h_p), zero-padded to (4, n_h_p, n_h_p), cut into
    engine (s, r, c)'s contiguous (bk, 4*bn) block on its device."""
    w_p = torch.nn.functional.pad(
        w, (0, n_h_p - w.shape[-1], 0, n_h_p - w.shape[-2]))
    return tuple(tuple(
        w_p[:, r * bn:(r + 1) * bn, c * bk:(c + 1) * bk].permute(2, 0, 1)
        .reshape(bk, GATES * bn).to(mesh.engine(s, r, c))
        for c in range(mesh.cols)) for r in range(mesh.rows))


def _place_layer(mesh: SystolicMesh, s: int, w_h, w_peep, b, w_in,
                 n_h_p: int, bn: int, bk: int) -> _Blocks:
    """Place one f32 layer's weights on stage s's engines (weight
    stationary for every step of the call)."""
    return _Blocks(
        w=_engine_blocks(mesh, s, w_h, n_h_p, bn, bk),
        w_in=(None if w_in is None
              else _engine_blocks(mesh, s, w_in, n_h_p, bn, bk)),
        peep=tuple(_row_split(mesh, s, _pad_last(w_peep, n_h_p), bn)),
        bias=tuple(_row_split(mesh, s, _pad_last(b, n_h_p), bn)))


def _block_products(mesh: SystolicMesh, s: int, r: int, blocks: tuple,
                    h_full: torch.Tensor) -> torch.Tensor:
    """Fig. 3a-b for row r: every engine (s, r, c) MACs its block against
    its column slice of ``h_full`` (B, n_h_p) — one (B, bk) x (bk, 4*bn)
    product each, at that shape whatever the schedule — and the partials
    meet in the ``psum`` over ``col``.  Returns (B, 4, bn)."""
    bk = blocks[r][0].shape[0]
    parts = [h_full[:, c * bk:(c + 1) * bk].to(mesh.engine(s, r, c))
             @ blocks[r][c] for c in range(mesh.cols)]
    return _psum(parts, mesh.finish(s, r)).unflatten(-1, (GATES, -1))


def _below_stream(mesh: SystolicMesh, s: int, blk: _Blocks,
                  h_below: torch.Tensor) -> List[torch.Tensor]:
    """An inner layer's input stream at one step: ``psum`` over ``col`` of
    its W_in blocks against the layer below's h, per row."""
    return [_block_products(mesh, s, r, blk.w_in, h_below)
            for r in range(mesh.rows)]


def _f32_step(mesh: SystolicMesh, s: int, blk: _Blocks, h_full, c_rows,
              stream, keep):
    """One timestep of one layer on stage s's engines (Fig. 3): the
    partial sums of the resident W_h blocks meet per row, ``pre =
    psum(own) + stream`` (the hoisted ``W_x x`` or the below stream), the
    row's finishing engine runs the gate epilogue on its chunk, and the
    new ``h`` chunks are gathered over ``row``.  ``keep`` (None: unmasked)
    gives the step's (B, 1) mask on a device; a masked step is identity on
    the carried state (a select, no arithmetic).  Returns (h_full, c_rows)
    with h_full (B, n_h_p) on the stage's lead device."""
    h_rows, c_new = [], []
    for r in range(mesh.rows):
        pre = _block_products(mesh, s, r, blk.w, h_full) + stream[r]
        h_r, c_r, _ = _gate_phase(pre, blk.peep[r], blk.bias[r], c_rows[r])
        h_rows.append(h_r)
        c_new.append(c_r)
    h_next = _all_gather(h_rows, mesh.lead(s))
    if keep is not None:
        h_next = torch.where(keep(mesh.lead(s)), h_next, h_full)
        c_new = [torch.where(keep(mesh.finish(s, r)), c_new[r], c_rows[r])
                 for r in range(mesh.rows)]
    return h_next, c_new


class _Trajectory:
    """One layer's h and c over the call: h_full per step (on the stage's
    lead device) and c per row and step (on the finishing devices)."""

    def __init__(self, rows: int):
        self.hs: List[torch.Tensor] = []
        self.cs: List[List[torch.Tensor]] = [[] for _ in range(rows)]

    def add(self, h, c_rows) -> None:
        self.hs.append(h)
        for r, c in enumerate(c_rows):
            self.cs[r].append(c)

    def arrays(self, dev: torch.device, n: int):
        """(hs, cs), each (T, B, n) on ``dev``: un-padded to ``n``."""
        hs = torch.stack(self.hs).to(dev)[..., :n]
        cs = _all_gather([torch.stack(c) for c in self.cs], dev)[..., :n]
        return hs, cs


# ---------------------------------------------------------------------------
# Per-step baseline over an explicit (row, col) mesh, one engine per tile
# ---------------------------------------------------------------------------

class ShardedPackedLSTM(NamedTuple):
    """A ``PackedLSTM`` placed on a mesh: ``tiles[r][c]`` (4, t, t) on
    engine (0, r, c) and ``peep[r]`` (3, t), ``bias[r]`` (4, t) on the
    engine finishing row r (``core.pipeline.shard_pipeline`` adds a stage
    index in front of each)."""
    tiles: tuple
    peep: tuple
    bias: tuple
    plan_shape: Tuple[int, int, int, int]

    @property
    def plan(self) -> SystolicPlan:
        n_x, n_h, tile, _ = self.plan_shape
        return SystolicPlan(n_x, n_h, tile)


def _shard_stage(packed, mesh: SystolicMesh, s: int, tiles, peep, bias):
    """Engine (s, r, c)'s tile and row r's peepholes and biases, placed."""
    return (tuple(tuple(tiles[r, c].to(mesh.engine(s, r, c))
                        for c in range(mesh.cols)) for r in range(mesh.rows)),
            tuple(peep[r].to(mesh.finish(s, r)) for r in range(mesh.rows)),
            tuple(bias[r].to(mesh.finish(s, r)) for r in range(mesh.rows)))


def shard_packed_lstm(packed: PackedLSTM, mesh: SystolicMesh
                      ) -> ShardedPackedLSTM:
    """Place weight tiles so engine (r, c) owns tile (r, c) — weight
    stationary.  Placement only; the mesh must match the plan's grid."""
    plan = packed.plan
    if (mesh.rows, mesh.cols) != (plan.rows, plan.cols):
        raise ValueError(f'mesh {mesh.rows}x{mesh.cols} is not the plan '
                         f'grid {plan.rows}x{plan.cols}')
    return ShardedPackedLSTM(*_shard_stage(packed, mesh, 0, packed.tiles,
                                           packed.peep, packed.bias),
                             packed.plan_shape)


def _tile_step(mesh: SystolicMesh, s: int, tiles, peep, bias, col_in,
               c_rows):
    """One per-step baseline step on stage s: engine (s, r, c) MACs tile
    (r, c) against column input ``col_in(c)`` (B, t), the partials meet per
    row, the epilogue runs on the finishing engine and the h chunks are
    gathered.  Returns (h_full (B, padded_h), c_rows)."""
    h_rows, c_new = [], []
    for r in range(mesh.rows):
        parts = [torch.einsum('gij,bj->bgi', tiles[r][c],
                              col_in(c).to(mesh.engine(s, r, c)))
                 for c in range(mesh.cols)]
        h_r, c_r, _ = _gate_phase(_psum(parts, mesh.finish(s, r)), peep[r],
                                  bias[r], c_rows[r])
        h_rows.append(h_r)
        c_new.append(c_r)
    return _all_gather(h_rows, mesh.lead(s)), c_new


def systolic_lstm_shard_map(packed, mesh: SystolicMesh, xs: torch.Tensor
                            ) -> torch.Tensor:
    """The PER-STEP baseline with the paper's communication pattern:
    allclose to scanning ``systolic_cell_tiled``.  Every step re-assembles
    the packed ``[x | h]`` column and re-MACs the x-region, the cost the
    persistent ``systolic_lstm_seq`` removes by hoisting ``W_x @ x``.

    packed: a ``PackedLSTM`` (placed here) or ``ShardedPackedLSTM``; xs:
    (T, B, padded_in), the x-region columns holding data.  The mesh must be
    (1, plan.rows, plan.cols).  Returns (T, B, n_h) on xs's device."""
    _require_systolic_axes(mesh)
    if isinstance(packed, PackedLSTM):
        packed = shard_packed_lstm(packed, mesh)
    plan = packed.plan
    t = plan.tile
    if xs.shape[2] != plan.padded_in:
        raise ValueError(f'xs is (T, B, {xs.shape[2]}), the plan takes '
                         f'padded_in = {plan.padded_in}')
    if (mesh.rows, mesh.cols) != (plan.rows, plan.cols):
        raise ValueError('the mesh must be the plan grid')
    B = xs.shape[1]
    h = xs.new_zeros((B, plan.padded_h)).to(mesh.lead(0))
    c = [xs.new_zeros((B, t)).to(mesh.finish(0, r))
         for r in range(mesh.rows)]
    hs = []
    for x_t in xs:
        def col_in(ci, x_t=x_t, h=h):
            if ci < plan.cols_x:
                return x_t[:, ci * t:(ci + 1) * t]
            return h[:, (ci - plan.cols_x) * t:(ci - plan.cols_x + 1) * t]
        h, c = _tile_step(mesh, 0, packed.tiles, packed.peep, packed.bias,
                          col_in, c)
        hs.append(h)
    return torch.stack(hs).to(xs.device)[..., :plan.n_h]


# ---------------------------------------------------------------------------
# Layerwise scale-out of the persistent sequence kernel (DESIGN.md §6)
# ---------------------------------------------------------------------------

def _scaleout_forward(mesh: SystolicMesh, w_h, w_peep, b, pre_x, h0, c0,
                      mask=None, blk: Optional[_Blocks] = None):
    """The distributed whole-sequence forward: padded in, un-padded out.

    Allclose to scanning ``systolic_cell_tiled`` and to ``core.lstm
    .lstm_layer``: the same per-block partial sums, the ``col`` reduction
    a ``psum`` in column order.  pre_x: (T, B, 4, N_h) hoisted ``W_x x``;
    ``mask`` (T, B) or None; a masked step is identity on the carried
    state (a select), so None and an all-ones mask give the same bits.
    ``blk``: the layer already placed (``place_stack``), else the weights
    are placed for this call.  Returns (hs, cs, h_T, c_T) on pre_x's
    device."""
    T, B, _, n_h = pre_x.shape
    mr, mc = _require_systolic_axes(mesh)
    n_h_p, bn, bk = _scaleout_blocks(n_h, mr, mc)
    if blk is None:
        blk = _place_layer(mesh, 0, w_h, w_peep, b, None, n_h_p, bn, bk)
    stream = _row_split(mesh, 0, _pad_last(pre_x, n_h_p), bn)
    h = _pad_last(h0, n_h_p).to(mesh.lead(0))
    c = _row_split(mesh, 0, _pad_last(c0, n_h_p), bn)
    keep = _keep_fn(mask)
    traj = _Trajectory(mr)
    for t in range(T):
        h, c = _f32_step(mesh, 0, blk, h, c, [st[t] for st in stream],
                         None if keep is None else keep(t))
        traj.add(h, c)
    hs, cs = traj.arrays(pre_x.device, n_h)
    return hs, cs, hs[-1], cs[-1]


def systolic_seq_fused(static, w_h, w_peep, b, pre_x, h0, c0):
    """The layerwise scale-out with the training backward: a
    ``torch.autograd.Function`` (``core.lstm.recompute_gates_layer``) whose
    forward runs ``_scaleout_forward`` on ``static = (mesh, blk)`` (``blk``
    the placed layer or None) and whose backward recomputes the gates from
    the saved h/c trajectories (``lstm_bwd_recompute_gates``), as K1's
    does.  Returns (hs, (h_T, c_T))."""
    mesh, blk = static

    def forward(w_h, w_peep, b, pre_x, h0, c0):
        hs, cs, _, _ = _scaleout_forward(mesh, w_h, w_peep, b, pre_x, h0,
                                         c0, blk=blk)
        return hs, cs
    return recompute_gates_layer(forward, w_h, w_peep, b, pre_x, h0, c0)


def systolic_lstm_seq(params: LSTMParams, mesh: Optional[SystolicMesh],
                      xs: torch.Tensor, h0: Optional[torch.Tensor] = None,
                      c0: Optional[torch.Tensor] = None, *,
                      valid_len: Optional[torch.Tensor] = None,
                      placed: Optional[_Blocks] = None):
    """Whole-sequence LSTM scaled out over a systolic mesh — the
    ``cuda_seq_systolic`` backend.  Drop-in for ``core.lstm.lstm_layer``:
    xs (T, B, N_x) -> (hs (T, B, N_h), (h_T, c_T)) on xs's device, allclose
    to it.  ``W_x @ x`` is hoisted (``hoisted_input``); in the loop each
    engine MACs only its resident ``bn x bk`` block, row partials meet in a
    per-step ``psum`` over ``col`` and the ``h_t`` chunks are gathered over
    ``row``.  Differentiable without ``valid_len`` (``systolic_seq_fused``).
    ``valid_len`` (B,) makes steps ``t >= valid_len[b]`` identity on the
    state (inference only), so chunked calls are bit-equal to one call.
    ``placed``: this layer's blocks from a ``place_stack`` of ``mesh``
    (weight stationary across calls; the weights must not have changed
    since), else the weights are placed for this call.  A ``None`` or
    all-1 mesh runs K1 (``kernels.lstm_seq.lstm_layer_seq``)."""
    if xs.ndim != 3:
        raise ValueError('systolic_lstm_seq expects (T, B, N_x) input')
    if _degenerate(mesh):
        from ..kernels.lstm_seq import lstm_layer_seq
        return lstm_layer_seq(params, xs, h0, c0, valid_len=valid_len)
    _require_systolic_axes(mesh)
    T, B = xs.shape[0], xs.shape[1]
    zeros = xs.new_zeros((B, params.n_h))
    h0 = zeros if h0 is None else h0
    c0 = zeros if c0 is None else c0
    pre_x = hoisted_input(params.w_x, xs)
    if valid_len is not None:
        hs, _, h_T, c_T = _scaleout_forward(
            mesh, params.w_h, params.w_peep, params.b, pre_x, h0, c0,
            valid_len_mask(T, valid_len, B), placed)
        return hs, (h_T, c_T)
    return systolic_seq_fused((mesh, placed), params.w_h, params.w_peep,
                              params.b, pre_x, h0, c0)


class _QBlocks(NamedTuple):
    """One int8 layer placed on the engines of its stage: ``own[r][c]``
    the (r_l, c_l, 4, t, t) own-h tiles of engine (s, r, c) (as float32,
    exact: ``tile_products``), ``below[r]`` the (r_l, c_h, 4, t, t)
    below-h tiles of row r on its finishing engine (None for a layer fed
    by the hoisted x prefix), ``peep[r]`` (r_l, 3, t) and ``bias[r]``
    (r_l, 4, t) as int32, and ``luts[r]`` (sig, tanh) there too."""
    own: tuple
    below: Optional[tuple]
    peep: tuple
    bias: tuple
    luts: tuple


def _place_quantized(mesh: SystolicMesh, s: int, qp: QuantizedPackedLSTM,
                     inner: bool, luts) -> _QBlocks:
    """Place one quantized layer on stage s's engines: rule 4 of DESIGN.md
    §6.2 (``plan.rows % rows == 0``, ``plan.cols_h % cols == 0``) is
    checked here."""
    plan = qp.plan
    R, c_h = plan.rows, plan.cols_h
    if R % mesh.rows or c_h % mesh.cols:
        raise ValueError(f'engine grid {R}x{c_h} (h-region) does not divide '
                         f'mesh {mesh.rows}x{mesh.cols}')
    r_l, c_l = R // mesh.rows, c_h // mesh.cols
    tiles = qp.tiles_q.to(torch.float32)
    own = tiles[:, plan.cols_x:]
    rows = range(mesh.rows)
    fin = [mesh.finish(s, r) for r in rows]
    return _QBlocks(
        own=tuple(tuple(own[r * r_l:(r + 1) * r_l, c * c_l:(c + 1) * c_l]
                        .contiguous().to(mesh.engine(s, r, c))
                        for c in range(mesh.cols)) for r in rows),
        below=(tuple(tiles[r * r_l:(r + 1) * r_l, :plan.cols_x].to(fin[r])
                     for r in rows) if inner else None),
        peep=tuple(qp.peep_q[r * r_l:(r + 1) * r_l].to(torch.int32)
                   .to(fin[r]) for r in rows),
        bias=tuple(qp.bias_q[r * r_l:(r + 1) * r_l].to(torch.int32)
                   .to(fin[r]) for r in rows),
        luts=tuple((luts[0].on(fin[r]), luts[1].on(fin[r])) for r in rows))


def _q_step(mesh: SystolicMesh, s: int, blk: _QBlocks, h_full, c_rows,
            acc, keep):
    """One int8 timestep of one layer on stage s's engines: each engine's
    own-h tile partials (int32 MACs saturated to 16 bits), gathered over
    ``col`` in column order onto the row's finishing engine, which replays
    the saturating hop in engine order from ``acc[r]`` (the x-region or
    below-region prefix, (B, r_l, 4, t)) and runs the integer epilogue;
    the h chunks are gathered over ``row``.  h_full: (B, padded_h) int8;
    c_rows[r]: (B, r_l, t) int8.  A masked step is a select."""
    B = h_full.shape[0]
    width = blk.own[0][0].shape[1] * blk.own[0][0].shape[-1]   # c_l * t
    h_rows, c_new = [], []
    for r in range(mesh.rows):
        fin = mesh.finish(s, r)
        parts = [_sat16(tile_products(
            blk.own[r][c], h_full[:, c * width:(c + 1) * width]
            .to(mesh.engine(s, r, c)).unflatten(-1, (-1, blk.own[r][c]
                                                     .shape[-1]))))
            for c in range(mesh.cols)]
        pre_acc = saturating_hops(_all_gather(parts, fin, dim=-3), acc[r])
        h8, c8 = _quantized_state_update(pre_acc, c_rows[r].to(torch.int32),
                                         blk.peep[r], blk.bias[r],
                                         *blk.luts[r])
        h_rows.append(h8.reshape(B, -1))
        c_new.append(c8)
    h_next = _all_gather(h_rows, mesh.lead(s))
    if keep is not None:
        h_next = torch.where(keep(mesh.lead(s)), h_next, h_full)
        c_new = [torch.where(keep(mesh.finish(s, r))[..., None], c_new[r],
                             c_rows[r]) for r in range(mesh.rows)]
    return h_next, c_new


def _q_below_prefix(mesh: SystolicMesh, s: int, blk: _QBlocks, h_below,
                    tile: int) -> List[torch.Tensor]:
    """An inner int8 layer's below-region prefix at one step, per row, on
    the row's finishing engine: the shared ``_x_prefix_fold`` of its below
    tiles against the layer below's h codes (B, padded_h)."""
    cols = h_below.unflatten(-1, (-1, tile))
    return [_x_prefix_fold(blk.below[r], cols.to(mesh.finish(s, r)))
            for r in range(mesh.rows)]


def _q_state(mesh: SystolicMesh, s: int, h0, c0, r_l: int, tile: int):
    """Padded-layout carried codes (B, padded_h) -> h on the stage's lead
    device and c per row (B, r_l, t) on the finishing devices."""
    c = c0.unflatten(-1, (-1, tile))
    return h0.to(mesh.lead(s)), [c[:, r * r_l:(r + 1) * r_l]
                                 .to(mesh.finish(s, r))
                                 for r in range(mesh.rows)]


def _q_rows_of(acc: torch.Tensor, mesh: SystolicMesh, s: int, r_l: int
               ) -> List[torch.Tensor]:
    """(T, B, R, 4, t) prefixes -> row r's (T, B, r_l, 4, t) on its
    finishing engine."""
    return [acc[:, :, r * r_l:(r + 1) * r_l].to(mesh.finish(s, r))
            for r in range(mesh.rows)]


def systolic_lstm_seq_quantized(qp: QuantizedPackedLSTM,
                                mesh: Optional[SystolicMesh],
                                xs_q: torch.Tensor, *,
                                state: Optional[Tuple[torch.Tensor,
                                                      torch.Tensor]] = None,
                                valid_len: Optional[torch.Tensor] = None,
                                return_state: bool = False):
    """Distributed whole-sequence int8 LSTM, bit-identical to scanning
    ``systolic_cell_quantized`` (and so to K3).  The 16-bit saturating row
    accumulation is order-sensitive, so no plain ``psum``: the x-region
    prefix of the hop chain is computed once for the sequence
    (``quantized_x_prefix``), and per step each engine's h-region tile
    partials are gathered over ``col`` and hopped in engine order.  Needs
    ``plan.rows % rows == 0`` and ``plan.cols_h % cols == 0`` (rule 4).

    xs_q: (T, B, n_x) int8 -> (T, B, n_h) int8 codes on xs_q's device.
    ``state``: opaque ``(h_q, c_q)`` padded-layout codes, each (B,
    padded_h), from a call with ``return_state=True`` (None = zero);
    ``valid_len`` (B,) masks ragged tails (a select on the carried codes),
    so chunked calls are bit-identical to one.  A ``None`` or all-1 mesh
    runs K3 (``kernels.lstm_seq.lstm_layer_seq_quantized``)."""
    if _degenerate(mesh):
        from ..kernels.lstm_seq import lstm_layer_seq_quantized
        return lstm_layer_seq_quantized(qp, xs_q, state=state,
                                        valid_len=valid_len,
                                        return_state=return_state)
    _require_systolic_axes(mesh)
    if xs_q.ndim != 3:
        raise ValueError('systolic_lstm_seq_quantized expects (T, B, n_x)')
    plan = qp.plan
    T, B = xs_q.shape[0], xs_q.shape[1]
    luts = (_Replicas(qp.sig_lut), _Replicas(qp.tanh_lut))
    blk = _place_quantized(mesh, 0, qp, False, luts)
    r_l = plan.rows // mesh.rows
    if state is None:
        state = (xs_q.new_zeros((B, plan.padded_h)),) * 2
    h, c = _q_state(mesh, 0, state[0].reshape(B, plan.padded_h),
                    state[1].reshape(B, plan.padded_h), r_l, plan.tile)
    acc = _q_rows_of(quantized_x_prefix(qp, xs_q), mesh, 0, r_l)
    keep = _keep_fn(None if valid_len is None
                    else valid_len_mask(T, valid_len, B))
    hs, cs = [], []
    for t in range(T):
        h, c = _q_step(mesh, 0, blk, h, c, [a[t] for a in acc],
                       None if keep is None else keep(t))
        hs.append(h)
        cs.append(c)
    out = torch.stack(hs).to(xs_q.device)
    if not return_state:
        return out[..., :plan.n_h]
    c_T = _all_gather([x.reshape(B, -1) for x in cs[-1]], xs_q.device)
    return out[..., :plan.n_h], (out[-1], c_T)


# ---------------------------------------------------------------------------
# Staged scale-out of the fused stack (DESIGN.md §9): contiguous layer
# blocks on the ``stage`` axis, chunks of the hidden sequence handed stage
# to stage — the paper's 3x(5x5) as one dispatch path.
# ---------------------------------------------------------------------------

def stage_layer_blocks(n_layers: int, n_stages: int,
                       blocks: Optional[Sequence[int]] = None
                       ) -> Tuple[Tuple[int, int], ...]:
    """Contiguous layer placement on the stage axis: stage ``s`` owns
    layers ``[lo, hi)``.  ``blocks=None`` is the balanced split (sizes
    differ by at most one, ceil-sized blocks first; trailing stages past
    the stack get empty passthrough blocks, which add pipeline delay and no
    arithmetic); ``blocks`` gives explicit per-stage layer COUNTS (the
    uneven splits the tuner tries): ``n_stages`` non-negative entries
    summing to ``n_layers``.  Any valid split is schedule-only.  Raises
    ``ValueError`` on non-positive sizes or an inconsistent override."""
    if n_layers < 1 or n_stages < 1:
        raise ValueError(
            f'stage_layer_blocks needs n_layers >= 1 and n_stages >= 1, '
            f'got n_layers={n_layers}, n_stages={n_stages}')
    if blocks is None:
        base, rem = divmod(n_layers, n_stages)
        sizes = [base + (1 if s_i < rem else 0) for s_i in range(n_stages)]
    else:
        sizes = [int(s) for s in blocks]
        if len(sizes) != n_stages:
            raise ValueError(f'blocks override has {len(sizes)} entries '
                             f'for {n_stages} stages')
        if any(s < 0 for s in sizes):
            raise ValueError(f'blocks override has negative entries: {sizes}')
        if sum(sizes) != n_layers:
            raise ValueError(f'blocks override {sizes} places {sum(sizes)} '
                             f'layers, stack has {n_layers}')
    out, lo = [], 0
    for size in sizes:
        out.append((lo, lo + size))
        lo += size
    return tuple(out)


def _stage_of(blocks, layer: int) -> Tuple[int, int]:
    """(stage index, slot index) of a global layer under ``blocks``."""
    for s_i, (lo, hi) in enumerate(blocks):
        if lo <= layer < hi:
            return s_i, layer - lo
    raise ValueError(f'layer {layer} outside {blocks}')


def _staged_schedule(n_layers: int, T: int, n_stages: int,
                     chunk: Optional[int],
                     blocks: Optional[Sequence[int]] = None):
    """The one source of the staged pipeline geometry, shared by the f32
    and int8 forms: chunk default ``ceil(T / (4 * stages))`` (fill and
    drain under ~1/4 of the macro-steps; chunk 1 is the paper's
    frame-by-frame handover), ``K`` chunks padding T to ``T_p``, ``M = K +
    S - 1`` macro-steps, the layer blocks and the largest block.  Returns
    (Tc, K, T_p, M, blocks, Lb)."""
    if chunk is None:
        chunk = max(1, -(-T // (4 * n_stages)))
    Tc = min(int(chunk), T)
    K = -(-T // Tc)
    blocks = stage_layer_blocks(n_layers, n_stages, blocks)
    Lb = max(1, max(hi - lo for lo, hi in blocks))
    return Tc, K, K * Tc, K + n_stages - 1, blocks, Lb


def _cached_entry(kind: str, n_layers: int, T: int, n_h: int, n_x: int,
                  batch: int, mesh):
    """The installed schedule cache's entry for this staged shape and mesh
    (``mesh_signature``), or None."""
    from ..tune.schedule import current_schedule_cache, mesh_signature
    cache = current_schedule_cache()
    if cache is None:
        return None
    return cache.lookup(kind, n_x=n_x, n_h=n_h, n_layers=n_layers, T=T,
                        B=batch, mesh=mesh_signature(mesh))


def resolve_staged_chunk(n_layers: int, T: int, n_stages: int, *,
                         n_h: int = 0, n_x: int = 0, batch: int = 0,
                         mesh=None, kind: str = 'stack_f32') -> int:
    """Chunk depth ``Tc`` for ``chunk=None``: a measured winner from the
    installed schedule cache for this (shape, mesh), else the
    ``_staged_schedule`` default.  Schedule only (chunked and monolithic
    trajectories are bit-equal)."""
    ent = _cached_entry(kind, n_layers, T, n_h, n_x, batch, mesh)
    if ent is not None and ent.tc:
        return min(int(ent.tc), T)
    return _staged_schedule(n_layers, T, n_stages, None)[0]


def resolve_staged_blocks(n_layers: int, T: int, n_stages: int, *,
                          n_h: int = 0, n_x: int = 0, batch: int = 0,
                          mesh=None, kind: str = 'stack_f32'
                          ) -> Optional[Tuple[int, ...]]:
    """Per-stage layer counts for ``blocks=None``: the cache's tuned uneven
    split for this (shape, mesh) (``blocks='2,1'``), else None (balanced).
    A cached split that does not fit this call (stage count, layer total,
    negative entries) is ignored."""
    ent = _cached_entry(kind, n_layers, T, n_h, n_x, batch, mesh)
    if ent is None or not getattr(ent, 'blocks', ''):
        return None
    try:
        counts = tuple(int(p) for p in str(ent.blocks).split(','))
    except ValueError:
        return None
    if (len(counts) != n_stages or any(c < 0 for c in counts)
            or sum(counts) != n_layers):
        return None
    return counts


def _pipeline(mesh: SystolicMesh, schedule, T: int, step) -> None:
    """The staged macro-step loop.  At macro-step m, stage s runs chunk
    ``m - s`` on what stage s - 1 handed over (``_ppermute``) at macro-step
    m - 1; a stage whose chunk is out of range sits in the fill/drain
    bubble, an empty stage hands its input on.  Inside a stage the layer
    block runs slot by slot, each slot over the chunk's steps: ``step(l,
    t, s, h_below)`` is global layer l's step t on stage s, fed the layer
    below's h at step t (None for the first slot of stage 0), returning
    the layer's new h.  Steps past T are not run.  Stages run one after
    another here, each on the previous macro-step's handovers, as they
    would run at once.  The order of the host's issue changes no product:
    every (engine, step) runs the same products at the same shapes."""
    Tc, K, _, M, blocks, _ = schedule

    def stage_chunk(s, k, handed):
        lo, hi = blocks[s]
        below = (None if handed is None
                 else [_ppermute(x, mesh.lead(s)) for x in handed])
        if hi == lo:
            return below
        steps = range(k * Tc, min((k + 1) * Tc, T))
        for l in range(lo, hi):
            below = [step(l, t, s, None if below is None else below[j])
                     for j, t in enumerate(steps)]
        return below

    handed: List[Optional[list]] = [None] * mesh.stage
    for m in range(M):
        nxt = list(handed)
        for s in range(mesh.stage):
            if 0 <= m - s < K:
                nxt[s] = stage_chunk(s, m - s,
                                     None if s == 0 else handed[s - 1])
        handed = nxt


class StackPlacement(NamedTuple):
    """A stack's f32 weights placed on a mesh once, for every call that
    serves it — weight stationary across calls, as the silicon holds its
    tiles: ``layers[l]`` is layer l's ``_Blocks`` on its stage's engines,
    ``split`` the per-stage layer counts of a staged placement (None: every
    layer on stage 0, the layerwise scale-out).  ``layers`` is None on a
    ``None`` or all-1 mesh, where the systolic backends run K1/K2.  The
    weights must not change while the placement serves them."""
    mesh: Optional[SystolicMesh]
    split: Optional[Tuple[int, ...]]
    layers: Optional[tuple]


def place_stack(params, mesh: Optional[SystolicMesh], *, staged: bool,
                T: int = 0, batch: int = 0,
                blocks: Optional[Sequence[int]] = None) -> StackPlacement:
    """Place ``params``' layers on ``mesh`` for the staged scale-out
    (``staged``: layer blocks on the stage axis — ``blocks``, the per-stage
    layer counts, when given, else the split the schedule cache records
    for a (T, batch) call, else the balanced one) or the layerwise one
    (every layer on the (row, col) grid).  Placement only: the calls that
    take it give the same bits as calls that place per call."""
    layers = params.layers
    if _degenerate(mesh):
        return StackPlacement(mesh, None, None)
    L = len(layers)
    if staged:
        S, _, _ = _require_staged_axes(mesh)
        l0 = layers[0]
        if blocks is None:
            blocks = resolve_staged_blocks(L, T, S, n_h=l0.n_h, n_x=l0.n_x,
                                           batch=batch, mesh=mesh)
        ranges = stage_layer_blocks(L, S, blocks)
        split = tuple(hi - lo for lo, hi in ranges)
        stage = [_stage_of(ranges, l)[0] for l in range(L)]
    else:
        _require_systolic_axes(mesh)
        split, stage = None, [0] * L
    with torch.no_grad():
        blk = tuple(_place_layer(
            mesh, stage[l], lp.w_h, lp.w_peep, lp.b,
            lp.w_x if staged and l else None,
            *_scaleout_blocks(lp.n_h, mesh.rows, mesh.cols))
            for l, lp in enumerate(layers))
    return StackPlacement(mesh, split, blk)


def _staged_forward(static, w_in, w_h, peep, b, pre_x, h0s, c0s,
                    mask=None):
    """Staged distributed whole-stack forward: padded in, un-padded out.

    Allclose to the layerwise composition: inside a stage each layer of its
    block runs the layerwise dataflow (``_f32_step``) over one chunk at a
    time, an inner layer's input stream being the ``psum`` of its resident
    W_in blocks against the layer below's h; chunks move stage to stage by
    ``_ppermute``.  ``static = (mesh, chunk, blocks, placed)``, ``placed``
    the layers' ``_Blocks`` from a ``place_stack`` (then the weights are
    not read) or None (placed here).  w_in: (L-1, 4, N_h, N_h) (layers
    1..L-1); pre_x: (T, B, 4, N_h) layer 0's hoisted input; h0s, c0s (L,
    B, N_h); ``mask`` (T, B) or None.  Steps past T are not run (a masked
    step is identity), so the last chunk may be short.  Returns (hs, cs),
    each (L, T, B, N_h) on pre_x's device."""
    mesh, chunk, split, blk = static
    T, _, _, n_h = pre_x.shape
    L = h0s.shape[0]
    S, mr, mc = _require_staged_axes(mesh)
    n_h_p, bn, bk = _scaleout_blocks(n_h, mr, mc)
    schedule = _staged_schedule(L, T, S, chunk, split)
    stage = [_stage_of(schedule[4], l)[0] for l in range(L)]
    if blk is None:
        blk = [_place_layer(mesh, stage[l], w_h[l], peep[l], b[l],
                            w_in[l - 1] if l else None, n_h_p, bn, bk)
               for l in range(L)]
    stream0 = _row_split(mesh, stage[0], _pad_last(pre_x, n_h_p), bn)
    h = [_pad_last(h0s[l], n_h_p).to(mesh.lead(stage[l])) for l in range(L)]
    c = [_row_split(mesh, stage[l], _pad_last(c0s[l], n_h_p), bn)
         for l in range(L)]
    keep = _keep_fn(mask)
    traj = [_Trajectory(mr) for _ in range(L)]

    def step(l, t, s, h_below):
        stream = ([st[t] for st in stream0] if l == 0
                  else _below_stream(mesh, s, blk[l], h_below))
        h[l], c[l] = _f32_step(mesh, s, blk[l], h[l], c[l], stream,
                               None if keep is None else keep(t))
        traj[l].add(h[l], c[l])
        return h[l]

    _pipeline(mesh, schedule, T, step)
    arrays = [tr.arrays(pre_x.device, n_h) for tr in traj]
    return (torch.stack([a[0] for a in arrays]),
            torch.stack([a[1] for a in arrays]))


def systolic_stack_seq_fused(static, w_in, w_h, peep, b, pre_x, h0s, c0s):
    """The staged scale-out with the training backward: a
    ``torch.autograd.Function`` (``core.lstm.recompute_stack_gates``)
    whose forward runs ``_staged_forward`` on ``static = (mesh, chunk,
    blocks, placed)`` and whose backward is the cross-layer gate
    recompute ``lstm_stack_bwd_recompute_gates`` from the saved
    trajectories, K2's backward.  Schedules change neither trajectories nor
    gradients.  Returns (ys (T, B, N_h), (h_T, c_T) each (L, B, N_h))."""
    return recompute_stack_gates(functools.partial(_staged_forward, static),
                                 w_in, w_h, peep, b, pre_x, h0s, c0s)


def systolic_lstm_stack_seq(params, mesh: Optional[SystolicMesh],
                            xs: torch.Tensor, states=None, *,
                            valid_len: Optional[torch.Tensor] = None,
                            chunk: Optional[int] = None,
                            blocks: Optional[Sequence[int]] = None,
                            placement: Optional[StackPlacement] = None,
                            weights=None):
    """Staged scale-out of the fused stack — the
    ``cuda_seq_fused_systolic`` backend.  Drop-in for the layer loop of
    ``core.lstm.lstm_stack_apply`` / ``lstm_stack_chunk`` (same family as
    ``kernels.lstm_seq.lstm_stack_seq``): each stage of the (stage, row,
    col) mesh holds one contiguous layer block weight-stationary and runs
    the layerwise dataflow over it, while the hidden sequence pipelines
    across stages in ``chunk``-step slices — a T-step call costs
    ``ceil(T / chunk) + S - 1`` macro-steps.

    xs: (T, B, N_x); ``states`` per-layer ``((h, c), ...)`` carries;
    returns (ys (T, B, N_h), per-layer ((h_T, c_T), ...)) on xs's device,
    allclose to the layerwise composition.  Differentiable without
    ``valid_len`` (``systolic_stack_seq_fused``); ``valid_len`` masks every
    layer (inference only).  ``chunk`` and ``blocks`` (per-stage layer
    counts) default to the schedule cache's winners for this (shape,
    mesh), else ``ceil(T / (4 * stages))`` and the balanced split; both
    are schedule-only.  ``placement``: a staged ``place_stack`` of
    ``params`` on ``mesh``, whose blocks (and split) serve the call, else
    the weights are placed for this call.  A ``None`` or all-1 mesh runs
    K2 (``kernels.lstm_seq.lstm_stack_seq``, on ``weights`` when given)."""
    from ..kernels.lstm_seq import lstm_stack_seq, stack_fused_compatible
    if not stack_fused_compatible(params):
        raise ValueError('the staged scale-out needs homogeneous hidden '
                         'widths (stack_fused_compatible)')
    if xs.ndim != 3:
        raise ValueError('systolic_lstm_stack_seq expects (T, B, N_x) input')
    if placement is not None and (placement.mesh is not mesh or (
            placement.layers is not None and placement.split is None)):
        raise ValueError('placement is not a staged placement on this mesh')
    if _degenerate(mesh):
        return lstm_stack_seq(params, xs, states, valid_len=valid_len,
                              weights=weights)
    S, _, _ = _require_staged_axes(mesh)
    layers = params.layers
    L, n_h, n_x = len(layers), layers[0].n_h, layers[0].n_x
    T, B = xs.shape[0], xs.shape[1]
    shape = dict(n_h=n_h, n_x=n_x, batch=B, mesh=mesh)
    if chunk is None:
        chunk = resolve_staged_chunk(L, T, S, **shape)
    if placement is not None:
        blocks = placement.split
    elif blocks is None:
        blocks = resolve_staged_blocks(L, T, S, **shape)
    split = None if blocks is None else tuple(int(s) for s in blocks)
    static = (mesh, _staged_schedule(L, T, S, chunk, split)[0], split,
              None if placement is None else placement.layers)
    pre_x = hoisted_input(layers[0].w_x, xs)
    h0s, c0s = stack_carry_arrays(states, L, B, n_h, xs)
    if valid_len is not None and placement is not None:
        hs, cs = _staged_forward(static, None, None, None, None, pre_x, h0s,
                                 c0s, valid_len_mask(T, valid_len, B))
        return hs[-1], tuple((hs[l, -1], cs[l, -1]) for l in range(L))
    w_h = torch.stack([l.w_h for l in layers])
    w_in = (torch.stack([l.w_x for l in layers[1:]]) if L > 1
            else w_h.new_zeros((0,) + tuple(w_h.shape[1:])))
    peep = torch.stack([l.w_peep for l in layers])
    b = torch.stack([l.b for l in layers])
    if valid_len is not None:
        hs, cs = _staged_forward(static, w_in, w_h, peep, b, pre_x, h0s, c0s,
                                 valid_len_mask(T, valid_len, B))
        return hs[-1], tuple((hs[l, -1], cs[l, -1]) for l in range(L))
    ys, (h_T, c_T) = systolic_stack_seq_fused(static, w_in, w_h, peep, b,
                                              pre_x, h0s, c0s)
    return ys, tuple((h_T[l], c_T[l]) for l in range(L))


def systolic_lstm_stack_seq_quantized(qps, mesh: Optional[SystolicMesh],
                                      xs_q: torch.Tensor, *, state=None,
                                      valid_len: Optional[torch.Tensor] = None,
                                      return_state: bool = False,
                                      chunk: Optional[int] = None,
                                      blocks: Optional[Sequence[int]] = None):
    """Staged distributed int8 stack, bit-identical to chaining the silicon
    scan (and so to K4).  The layer placement (made per call) and pipeline
    of ``systolic_lstm_stack_seq``; every step replays the engine-order
    saturating datapath: layer 0's x-region prefix is hoisted
    (``quantized_x_prefix``), an inner layer's below-region prefix folds
    through the shared ``_x_prefix_fold`` on each row's finishing engine,
    the own-h partials are gathered over ``col`` and hopped in engine
    order, and the tail is ``_quantized_state_update``.

    qps: per-layer quantized packs (one tile, one hidden width, inner
    ``n_x == n_h``); xs_q: (T, B, n_x) int8.  ``state`` / ``valid_len`` /
    ``return_state`` are ``lstm_stack_seq_quantized``'s chunk-carry
    contract (opaque ``(h_q, c_q)``, each (L, B, padded_h)), so the staged
    mesh, K4 and the serving engine can hand state to each other
    mid-sequence.  ``chunk`` / ``blocks`` as in the f32 form
    (cache kind ``'stack_int8'``).  Needs ``plan.rows % rows == 0`` and
    ``plan.cols_h % cols == 0``.  A ``None`` or all-1 mesh runs K4."""
    from ..kernels.lstm_seq import lstm_stack_seq_quantized
    from ..kernels.lstm_seq.stack_ops import quantized_stack_plan
    if _degenerate(mesh):
        return lstm_stack_seq_quantized(qps, xs_q, state=state,
                                        valid_len=valid_len,
                                        return_state=return_state)
    p0 = quantized_stack_plan(qps)
    if xs_q.ndim != 3:
        raise ValueError('systolic_lstm_stack_seq_quantized expects '
                         '(T, B, n_x)')
    S, mr, _ = _require_staged_axes(mesh)
    L, T, B = len(qps), xs_q.shape[0], xs_q.shape[1]
    tile, r_l = p0.tile, p0.rows // mr
    shape = dict(n_h=p0.n_h, n_x=p0.n_x, batch=B, mesh=mesh,
                 kind='stack_int8')
    if chunk is None:
        chunk = resolve_staged_chunk(L, T, S, **shape)
    if blocks is None:
        blocks = resolve_staged_blocks(L, T, S, **shape)
    schedule = _staged_schedule(L, T, S, chunk, blocks)
    stage = [_stage_of(schedule[4], l)[0] for l in range(L)]
    luts = (_Replicas(qps[0].sig_lut), _Replicas(qps[0].tanh_lut))
    blk = [_place_quantized(mesh, stage[l], qps[l], l > 0, luts)
           for l in range(L)]
    acc0 = _q_rows_of(quantized_x_prefix(qps[0], xs_q), mesh, stage[0], r_l)
    if state is None:
        state = (xs_q.new_zeros((L, B, p0.padded_h)),) * 2
    h, c = zip(*(_q_state(mesh, stage[l],
                          state[0][l].reshape(B, p0.padded_h),
                          state[1][l].reshape(B, p0.padded_h), r_l, tile)
                 for l in range(L)))
    h, c = list(h), list(c)
    keep = _keep_fn(None if valid_len is None
                    else valid_len_mask(T, valid_len, B))
    hs: List[torch.Tensor] = []

    def step(l, t, s, h_below):
        acc = ([a[t] for a in acc0] if l == 0
               else _q_below_prefix(mesh, s, blk[l], h_below, tile))
        h[l], c[l] = _q_step(mesh, s, blk[l], h[l], c[l], acc,
                             None if keep is None else keep(t))
        if l == L - 1:
            hs.append(h[l])
        return h[l]

    _pipeline(mesh, schedule, T, step)
    out = torch.stack(hs).to(xs_q.device)[..., :p0.n_h]
    if not return_state:
        return out
    h_q = torch.stack([x.to(xs_q.device) for x in h])
    c_q = torch.stack([_all_gather([x.reshape(B, -1) for x in c[l]],
                                   xs_q.device) for l in range(L)])
    return out, (h_q, c_q)
