"""K2 and K4 wrappers: the fused whole-stack LSTM wavefront kernels.

``lstm_stack_seq_kernel`` (f32, ``csrc/lstm_stack_seq.cu``) and
``lstm_stack_seq_kernel_q`` (the int8 silicon datapath,
``csrc/lstm_stack_seq_q.cu``) launch their kernels on CUDA tensors (one
cooperative launch for every layer of a chunk, on PyTorch's current stream)
and run their plain versions (``ref``) on CPU tensors.  K2 also runs a
stack in groups of ``lb`` layers (the reference's layer-block factor), one
launch a group, bit-equal to one launch over the stack: a group takes
fewer rows a CTA, so larger batch blocks, and stacks whose whole geometry
the card refuses.  ``stack_geometry`` and ``stack_q_geometry`` are the
launch geometries as pure functions of shapes.  Outputs are layer-major
(L, T, B, ·): the TPU kernels' diagonal-major layout and its re-index
existed for Pallas output blocks only.  A batch larger than the geometry
admits runs in blocks (``kernel.run_in_blocks``), as K1's and K3's does.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from .. import _build
from .kernel import (Q_GROUP, LaunchGeometry, check_inputs, check_tile,
                     coresident_ctas, exchange_planes, largest_batch,
                     q_exchange_planes, q_smem_bytes, run_in_blocks,
                     seq_launch_cost, seq_smem_bytes, seq_splits,
                     step_counters, word_aligned)
from .ref import lstm_stack_seq_quantized_ref, lstm_stack_seq_ref


def _stack_rows(n_h: int, layers: int, sm_count: int) -> int:
    """The smallest row count R that fits ``layers * ceil(N_h / R)`` CTAs
    on the SMs (at least one slice a layer)."""
    rows = max(1, -(-n_h * layers // sm_count))
    while rows < n_h and layers * -(-n_h // rows) > sm_count:
        rows += 1
    return rows


def stack_splits(n_h: int, n_layers: int, sm_count: int) -> int:
    """K splits a row of every K2 launch of an L-layer stack: those of the
    whole-stack geometry's rows (``seq_splits``), whatever the layer
    group, so that every ``lb`` sums in one order."""
    return seq_splits(_stack_rows(n_h, n_layers, sm_count))


def stack_geometry(n_h: int, n_layers: int, batch: int, sm_count: int,
                   lb: Optional[int] = None) -> LaunchGeometry:
    """K2's geometry for a launch over ``lb`` layers of an L-layer stack
    (default: all of them): CTAs own (layer, row-slice) pairs of the
    group, with R the smallest row count such that ``lb * ceil(N_h / R)``
    CTAs fit on the SMs (at least one slice per layer); shared memory
    holds the CTA's W_h and W_in rows and both h planes it reads
    (``seq_smem_bytes`` with two families, at ``stack_splits``)."""
    lb = n_layers if lb is None else lb
    rows = _stack_rows(n_h, lb, sm_count)
    return LaunchGeometry(rows, lb * -(-n_h // rows), seq_smem_bytes(
        batch, n_h, rows, 2, stack_splits(n_h, n_layers, sm_count)))


def check_layer_block(n_layers: int, lb: Optional[int]) -> int:
    """``lb`` (``n_layers`` when None), after checking that it is a layer
    block of the stack: ``1 <= lb <= L`` and ``L % lb == 0``."""
    lb = n_layers if lb is None else int(lb)
    if not 1 <= lb <= n_layers or n_layers % lb:
        raise ValueError(f'lb={lb} is not a layer block of a {n_layers}-'
                         f'layer stack (1 <= lb <= L, L % lb == 0)')
    return lb


def stack_launch_costs(T: int, B: int, N: int, n_layers: int,
                       lb: int) -> List[Tuple[float, float]]:
    """(FLOPs, bytes) of each of the L / lb unmasked f32 K2 launches of a
    stack in ``lb``-layer groups (``seq_launch_cost``: each reads its
    group's weights, the first ``pre_x``, a later one the layer below's
    h_t)."""
    return [seq_launch_cost(T, B, N, lb,
                            (2 * lb - (l0 == 0)) * 4 * N * N, l0 == 0)[:2]
            for l0 in range(0, n_layers, lb)]


_P, _I = _build.P, _build.I
_SIGNATURES = {
    'lstm_stack_seq_occupancy': [_I] * 5 + [ctypes.POINTER(ctypes.c_int)],
    'lstm_stack_seq_launch': [_I] + [_P] * 12 + [_I] * 7 + [_P],
}


@torch.library.custom_op('repro_torch::lstm_stack_seq_kernel',
                         mutates_args=())
def lstm_stack_seq_plain(pre_x: torch.Tensor, w_in: torch.Tensor,
                         w_h: torch.Tensor, peep: torch.Tensor,
                         bias: torch.Tensor, h0: torch.Tensor,
                         c0: torch.Tensor, mask: torch.Tensor, lb: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lstm_stack_seq_kernel`` on CPU tensors, the op
    ``repro_torch::lstm_stack_seq_kernel``: the plain version (the same
    for every layer block ``lb``), and under fake tensors outputs of its
    shapes (a cost model charges the op by its launches in ``lb``-layer
    groups, ``stack_launch_costs``)."""
    return lstm_stack_seq_ref(pre_x, w_in, w_h, peep, bias, h0, c0, mask)


@lstm_stack_seq_plain.register_fake
def _(pre_x, w_in, w_h, peep, bias, h0, c0, mask, lb):
    (T, B, _, N), L = pre_x.shape, w_h.shape[0]
    return (pre_x.new_empty((L, T, B, N)), pre_x.new_empty((L, T, B, N)))


def lstm_stack_seq_kernel(pre_x: torch.Tensor, w_in: torch.Tensor,
                          w_h: torch.Tensor, peep: torch.Tensor,
                          bias: torch.Tensor, h0: torch.Tensor,
                          c0: torch.Tensor, mask: torch.Tensor = None,
                          lb: Optional[int] = None):
    """Whole-stack masked peephole LSTM wavefront over one chunk.

    pre_x: (T, B, 4, N_h) hoisted layer-0 ``W_x @ x_t``; w_in: (L-1, 4,
    N_h, N_h) input weights of layers 1..L-1; w_h: (L, 4, N_h, N_h); peep:
    (L, 3, N_h); bias: (L, 4, N_h); h0, c0: (L, B, N_h); mask: (T, B) bool
    shared by every layer (None = every step live); ``lb``: the layer
    block, a divisor of L (None = L): one launch a group of ``lb`` layers,
    L / lb launches a batch block, the same bits for every ``lb``.
    Returns (hs, cs), each layer-major (L, T, B, N_h).  CPU tensors run
    the plain version; CUDA tensors launch the kernel and count each
    launch in ``lstm_stack_seq_kernel.launches``.  Raises
    ``RuntimeError`` when an ``lb``-layer group does not fit the card even
    for one stream.
    """
    T, B, _, N = pre_x.shape
    L = w_h.shape[0]
    lb = check_layer_block(L, lb)
    if mask is None:
        mask = torch.ones((T, B), dtype=torch.bool, device=pre_x.device)
    if pre_x.device.type == 'cpu':
        return lstm_stack_seq_plain(pre_x, w_in, w_h, peep, bias, h0, c0,
                                    mask, lb)
    if pre_x.device.type != 'cuda':
        raise ValueError(f'lstm_stack_seq_kernel runs on cuda or cpu, not '
                         f'{pre_x.device}')
    device = pre_x.device
    check_inputs(dict(pre_x=pre_x, w_in=w_in, w_h=w_h, peep=peep, bias=bias,
                      h0=h0, c0=c0, mask=mask),
                 dict(pre_x=(T, B, 4, N), w_in=(L - 1, 4, N, N),
                      w_h=(L, 4, N, N), peep=(L, 3, N), bias=(L, 4, N),
                      h0=(L, B, N), c0=(L, B, N), mask=(T, B)),
                 device)
    hs = torch.empty((L, T, B, N), dtype=torch.float32, device=device)
    cs = torch.empty_like(hs)
    lib = _build.load('lstm_stack_seq', _SIGNATURES)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = stack_splits(N, L, sms)
    block = largest_batch(lambda b: stack_geometry(N, L, b, sms, lb), B, sms)
    geom = stack_geometry(N, L, max(block, 1), sms, lb)
    if not block or not geom.admissible(coresident_ctas(
            lib, 'lstm_stack_seq_occupancy', device, geom, block, N,
            splits)):
        raise RuntimeError(f'lstm_stack_seq_kernel: launch geometry {geom} '
                           f'does not fit the card (N_h={N}, L={L}, lb={lb}, '
                           f'B={B})')
    stream = torch.cuda.current_stream(device).cuda_stream
    counters = step_counters(device, stream, lb)

    def launch(ins, outs):
        pre_b, h0_b, c0_b, mask_b = ins
        b = mask_b.shape[1]
        # every layer's planes, which a group's launch stages from the one
        # before it; held until the last launch is queued: freed earlier,
        # its block could become the stream's new counters
        xs = exchange_planes(L, T, b, N, device)
        for l0 in range(0, L, lb):
            err = lib.lstm_stack_seq_launch(
                device.index, pre_b.data_ptr(), w_in.data_ptr(),
                w_h.data_ptr(), peep.data_ptr(), bias.data_ptr(),
                h0_b.data_ptr(), c0_b.data_ptr(), mask_b.data_ptr(),
                outs[0].data_ptr(), outs[1].data_ptr(), xs.data_ptr(),
                counters.data_ptr(), T, b, N, l0, lb, geom.rows, splits,
                stream)
            _build.check(lib, err, 'lstm_stack_seq_kernel launch')
            lstm_stack_seq_kernel.launches += 1

    run_in_blocks(launch, block, (pre_x, h0, c0, mask), (1, 1, 1, 1),
                  (hs, cs), (2, 2))
    return hs, cs


lstm_stack_seq_kernel.launches = 0


# ---------------------------------------------------------------------------
# K4: the int8 silicon datapath across the stack
# ---------------------------------------------------------------------------

def stack_q_geometry(padded_h: int, tile: int, n_layers: int, batch: int,
                     sm_count: int) -> LaunchGeometry:
    """K4's geometry: CTAs own (layer, row-slice) pairs of whole row groups
    of 8, with R the smallest such row count that fits ``L *
    ceil(padded_h / R)`` CTAs on the SMs (R = 16, 90 CTAs at full width);
    shared memory as ``q_smem_bytes`` with two families (own-h and below-h
    weights, cols_h column tiles each), two h planes and layer 0's acc_x
    prefix."""
    groups = -(-padded_h // Q_GROUP)
    per = max(1, -(-groups * n_layers // sm_count))
    while per < groups and n_layers * -(-groups // per) > sm_count:
        per += 1
    rows = Q_GROUP * per
    ctas = n_layers * -(-padded_h // rows)
    return LaunchGeometry(rows, ctas, q_smem_bytes(
        batch, padded_h, tile, rows, padded_h // tile, 2, 2, prefix=True))


_SIGNATURES_Q = {
    'lstm_stack_seq_q_occupancy': [_I] * 6 + [ctypes.POINTER(ctypes.c_int)],
    'lstm_stack_seq_q_launch': [_I] + [_P] * 14 + [_I] * 6 + [_P],
}


def lstm_stack_seq_kernel_q(acc_x: torch.Tensor, w_in: torch.Tensor,
                            w_h: torch.Tensor, peep: torch.Tensor,
                            bias: torch.Tensor, sig_lut: torch.Tensor,
                            tanh_lut: torch.Tensor, h0: torch.Tensor,
                            c0: torch.Tensor, mask: torch.Tensor = None, *,
                            tile: int):
    """Whole-stack bit-accurate int8 wavefront LSTM over one chunk.

    acc_x: (T, B, padded_h/tile, 4, tile) int32 hoisted layer-0 x-region hop
    prefix (``core.systolic.quantized_x_prefix``); w_in: (L-1, 4, padded_h,
    padded_h) int8 below-h weights of layers 1..L-1 (layer 0 has none: its
    x-region rides in ``acc_x``); w_h: (L, 4, padded_h, padded_h) int8
    own-h weights, both in K3's dense (gate, row, column) layout; peep:
    (L, 3, padded_h) int8; bias: (L, 4, padded_h) int16 in ACC_FMT; LUTs
    (256,) int8; h0, c0: (L, B, padded_h) int8 carried codes; mask: (T, B)
    bool shared by every layer (None = every step live).  Returns (hs, cs),
    each layer-major (L, T, B, padded_h) int8, bit-identical layer by layer
    to chaining ``lstm_seq_quantized``.  CPU tensors run the plain version;
    CUDA tensors launch the kernel and count it in
    ``lstm_stack_seq_kernel_q.launches``.
    """
    T, B = acc_x.shape[0], acc_x.shape[1]
    L, _, p_h, _ = w_h.shape
    if p_h % tile:
        raise ValueError(f'lstm_stack_seq_kernel_q: padded_h={p_h} is not a '
                         f'multiple of tile={tile}')
    dev = acc_x.device
    if mask is None:
        mask = torch.ones((T, B), dtype=torch.bool, device=dev)
    args = (acc_x, w_in, w_h, peep, bias, sig_lut, tanh_lut, h0, c0, mask)
    if dev.type == 'cpu':
        return lstm_stack_seq_quantized_ref(*args, tile=tile)
    if dev.type != 'cuda':
        raise ValueError(f'lstm_stack_seq_kernel_q runs on cuda or cpu, not '
                         f'{dev}')
    check_tile(tile)
    i8 = torch.int8
    check_inputs(dict(acc_x=acc_x, w_in=w_in, w_h=w_h, peep=peep, bias=bias,
                      sig_lut=sig_lut, tanh_lut=tanh_lut, h0=h0, c0=c0,
                      mask=mask),
                 dict(acc_x=(T, B, p_h // tile, 4, tile),
                      w_in=(L - 1, 4, p_h, p_h), w_h=(L, 4, p_h, p_h),
                      peep=(L, 3, p_h), bias=(L, 4, p_h), sig_lut=(256,),
                      tanh_lut=(256,), h0=(L, B, p_h), c0=(L, B, p_h),
                      mask=(T, B)),
                 dev, dict(acc_x=torch.int32, w_in=i8, w_h=i8, peep=i8,
                           bias=torch.int16, sig_lut=i8, tanh_lut=i8, h0=i8,
                           c0=i8))
    hs = torch.empty((L, T, B, p_h), dtype=torch.int8, device=dev)
    cs = torch.empty_like(hs)
    lib = _build.load('lstm_stack_seq_q', _SIGNATURES_Q)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    block = largest_batch(
        lambda b: stack_q_geometry(p_h, tile, L, b, sms), B, sms)
    geom = stack_q_geometry(p_h, tile, L, max(block, 1), sms)
    if not block or not geom.admissible(coresident_ctas(
            lib, 'lstm_stack_seq_q_occupancy', dev, geom, block, p_h, tile,
            L)):
        raise RuntimeError(f'lstm_stack_seq_kernel_q: launch geometry {geom} '
                           f'does not fit the card (padded_h={p_h}, L={L}, '
                           f'B={B})')
    stream = torch.cuda.current_stream(dev).cuda_stream
    counters = step_counters(dev, stream, L)
    w_in_w, w_h_w = word_aligned(w_in), word_aligned(w_h)

    def launch(ins, outs):
        acc_b, h0_b, c0_b, mask_b = ins
        b = mask_b.shape[1]
        # held until the launch is queued: freed earlier, a block could
        # become the stream's new counters; acc_x is staged by bulk
        # copies: a 16-byte aligned copy where it is not
        acc_w = acc_b if acc_b.data_ptr() % 16 == 0 else acc_b.clone()
        xch = q_exchange_planes(L, T, b, p_h, dev)
        err = lib.lstm_stack_seq_q_launch(
            dev.index, acc_w.data_ptr(), w_in_w.data_ptr(), w_h_w.data_ptr(),
            peep.data_ptr(), bias.data_ptr(), sig_lut.data_ptr(),
            tanh_lut.data_ptr(), h0_b.data_ptr(), c0_b.data_ptr(),
            mask_b.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
            xch.data_ptr(), counters.data_ptr(), T, b, p_h, tile, L,
            geom.rows, stream)
        _build.check(lib, err, 'lstm_stack_seq_kernel_q launch')
        lstm_stack_seq_kernel_q.launches += 1

    run_in_blocks(launch, block, (acc_x, h0, c0, mask), (1, 1, 1, 1),
                  (hs, cs), (2, 2))
    return hs, cs


lstm_stack_seq_kernel_q.launches = 0
