"""K2 and K4 wrappers: the fused whole-stack LSTM wavefront kernels.

``lstm_stack_seq_kernel`` (f32, ``csrc/lstm_stack_seq.cu``) and
``lstm_stack_seq_kernel_q`` (the int8 silicon datapath,
``csrc/lstm_stack_seq_q.cu``) launch their kernels on CUDA tensors (one
cooperative launch for every layer of a chunk, on PyTorch's current stream)
and run their plain versions (``ref``) on CPU tensors.  ``stack_geometry``
and ``stack_q_geometry`` are the launch geometries as pure functions of
shapes.  Outputs are layer-major (L, T, B, ·): the TPU kernels'
diagonal-major layout and its re-index existed for Pallas output blocks
only.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .kernel import LaunchGeometry, check_inputs, check_tile, coresident_ctas
from .ref import lstm_stack_seq_quantized_ref, lstm_stack_seq_ref


def stack_geometry(n_h: int, n_layers: int, batch: int,
                   sm_count: int) -> LaunchGeometry:
    """K2's geometry: CTAs own (layer, row-slice) pairs, with R the smallest
    row count such that ``L * ceil(N_h / R)`` CTAs fit on the SMs (at least
    one slice per layer); shared memory holds the CTA's W_h and W_in rows,
    both h planes it reads, the gate sums and c (same formula as
    ``smem_bytes`` in the source)."""
    rows = max(1, -(-n_h * n_layers // sm_count))
    while rows < n_h and n_layers * -(-n_h // rows) > sm_count:
        rows += 1
    ctas = n_layers * -(-n_h // rows)
    smem = 4 * (8 * rows * n_h + 2 * batch * n_h + 5 * rows * batch)
    return LaunchGeometry(rows, ctas, smem)


_P, _I = _build.P, _build.I
_SIGNATURES = {
    'lstm_stack_seq_occupancy': [_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)],
    'lstm_stack_seq_launch': [_I] + [_P] * 10 + [_I] * 5 + [_P],
}


def lstm_stack_seq_kernel(pre_x: torch.Tensor, w_in: torch.Tensor,
                          w_h: torch.Tensor, peep: torch.Tensor,
                          bias: torch.Tensor, h0: torch.Tensor,
                          c0: torch.Tensor, mask: torch.Tensor = None):
    """Whole-stack masked peephole LSTM wavefront over one chunk.

    pre_x: (T, B, 4, N_h) hoisted layer-0 ``W_x @ x_t``; w_in: (L-1, 4,
    N_h, N_h) input weights of layers 1..L-1; w_h: (L, 4, N_h, N_h); peep:
    (L, 3, N_h); bias: (L, 4, N_h); h0, c0: (L, B, N_h); mask: (T, B) bool
    shared by every layer (None = every step live).  Returns (hs, cs), each
    layer-major (L, T, B, N_h).  CPU tensors run the plain version; CUDA
    tensors launch the kernel and count it in
    ``lstm_stack_seq_kernel.launches``.
    """
    T, B, _, N = pre_x.shape
    L = w_h.shape[0]
    if mask is None:
        mask = torch.ones((T, B), dtype=torch.bool, device=pre_x.device)
    if pre_x.device.type == 'cpu':
        return lstm_stack_seq_ref(pre_x, w_in, w_h, peep, bias, h0, c0, mask)
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
    geom = stack_geometry(N, L, B, sms)
    if not geom.admissible(coresident_ctas(lib, 'lstm_stack_seq_occupancy',
                                           device, geom, B, N)):
        raise RuntimeError(f'lstm_stack_seq_kernel: launch geometry {geom} '
                           f'does not fit the card (N_h={N}, L={L}, B={B})')
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.lstm_stack_seq_launch(
        device.index, pre_x.data_ptr(), w_in.data_ptr(), w_h.data_ptr(),
        peep.data_ptr(), bias.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        mask.data_ptr(), hs.data_ptr(), cs.data_ptr(), T, B, N, L,
        geom.rows, stream)
    _build.check(lib, err, 'lstm_stack_seq_kernel launch')
    lstm_stack_seq_kernel.launches += 1
    return hs, cs


lstm_stack_seq_kernel.launches = 0


# ---------------------------------------------------------------------------
# K4: the int8 silicon datapath across the stack
# ---------------------------------------------------------------------------

def stack_q_geometry(padded_h: int, tile: int, n_layers: int, batch: int,
                     sm_count: int) -> LaunchGeometry:
    """K4's geometry: CTAs own (layer, row-slice) pairs, with R the smallest
    row count such that ``L * ceil(padded_h / R)`` CTAs fit on the SMs;
    shared memory holds the CTA's tile partials (int32, 4*R*B*2*cols_h), its
    4*R int8 weight rows over both regions (below-h, own-h), the two h
    planes it reads, both LUTs and the c codes (same formula as
    ``smem_bytes`` in the source)."""
    rows = max(1, -(-padded_h * n_layers // sm_count))
    while rows < padded_h and n_layers * -(-padded_h // rows) > sm_count:
        rows += 1
    ctas = n_layers * -(-padded_h // rows)
    k2 = 2 * padded_h
    smem = (16 * rows * batch * (k2 // tile) + 4 * rows * k2 + batch * k2
            + 512 + rows * batch)
    return LaunchGeometry(rows, ctas, smem)


_SIGNATURES_Q = {
    'lstm_stack_seq_q_occupancy': [_I] * 6 + [ctypes.POINTER(ctypes.c_int)],
    'lstm_stack_seq_q_launch': [_I] + [_P] * 12 + [_I] * 6 + [_P],
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
    geom = stack_q_geometry(p_h, tile, L, B, sms)
    if not geom.admissible(coresident_ctas(lib, 'lstm_stack_seq_q_occupancy',
                                           dev, geom, B, p_h, tile, L)):
        raise RuntimeError(f'lstm_stack_seq_kernel_q: launch geometry {geom} '
                           f'does not fit the card (padded_h={p_h}, L={L}, '
                           f'B={B})')
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.lstm_stack_seq_q_launch(
        dev.index, acc_x.data_ptr(), w_in.data_ptr(), w_h.data_ptr(),
        peep.data_ptr(), bias.data_ptr(), sig_lut.data_ptr(),
        tanh_lut.data_ptr(), h0.data_ptr(), c0.data_ptr(), mask.data_ptr(),
        hs.data_ptr(), cs.data_ptr(), T, B, p_h, tile, L, geom.rows, stream)
    _build.check(lib, err, 'lstm_stack_seq_kernel_q launch')
    lstm_stack_seq_kernel_q.launches += 1
    return hs, cs


lstm_stack_seq_kernel_q.launches = 0
