"""K2 wrapper: the fused whole-stack f32 LSTM wavefront kernel.

``lstm_stack_seq_kernel`` launches ``csrc/lstm_stack_seq.cu`` on CUDA
tensors (one cooperative launch for every layer of a chunk, on PyTorch's
current stream) and runs ``ref.lstm_stack_seq_ref`` on CPU tensors.
``stack_geometry`` is the launch geometry as a pure function of shapes.
Outputs are layer-major (L, T, B, N_h): the TPU kernel's diagonal-major
layout and its re-index existed for Pallas output blocks only.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .kernel import LaunchGeometry, check_inputs, coresident_ctas
from .ref import lstm_stack_seq_ref


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
