"""K1 wrapper: the persistent whole-chunk f32 LSTM layer kernel.

``lstm_seq`` launches ``csrc/lstm_seq.cu`` on CUDA tensors (a cooperative
launch on PyTorch's current stream) and runs ``ref.lstm_seq_ref`` on CPU
tensors; there is no fallback between the two.  ``seq_geometry`` is the
kernel's launch geometry as a pure function of shapes, which backend
selection reads to decide admissibility without touching the card.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import _build
from .ref import lstm_seq_ref

SMEM_PER_CTA_MAX = 232_448      # 227 KB: the opt-in limit of one H100 CTA


@dataclasses.dataclass(frozen=True)
class LaunchGeometry:
    """Launch shape of a persistent kernel: ``rows`` hidden rows per CTA,
    ``ctas`` CTAs, ``smem_bytes`` dynamic shared memory per CTA."""
    rows: int
    ctas: int
    smem_bytes: int

    def admissible(self, max_coresident: int) -> bool:
        """True iff one CTA's shared memory fits the card's limit and all
        CTAs can be resident at once (the grid barrier needs both).
        Selection passes the SM count (one CTA per SM); the launch passes
        the occupancy the driver reports."""
        return (self.smem_bytes <= SMEM_PER_CTA_MAX
                and self.ctas <= max_coresident)


def seq_geometry(n_h: int, batch: int, sm_count: int) -> LaunchGeometry:
    """K1's geometry: R = ceil(N_h / SMs) rows per CTA, one CTA per row
    slice; shared memory holds the CTA's 4*R weight rows, h_{t-1} for every
    stream, the gate sums and c (same formula as ``smem_bytes`` in the
    source)."""
    rows = max(1, -(-n_h // sm_count))
    ctas = -(-n_h // rows)
    smem = 4 * (4 * rows * n_h + batch * n_h + 5 * rows * batch)
    return LaunchGeometry(rows, ctas, smem)


_P, _I = _build.P, _build.I
_SIGNATURES = {
    'lstm_seq_occupancy': [_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)],
    'lstm_seq_launch': [_I] + [_P] * 9 + [_I] * 4 + [_P],
}


def check_inputs(named, shapes, device) -> None:
    """Raise ``ValueError`` unless every tensor has its expected shape, lies
    on ``device``, is contiguous and has its dtype (f32, the mask bool)."""
    for name, x in named.items():
        want_dtype = torch.bool if name == 'mask' else torch.float32
        if tuple(x.shape) != tuple(shapes[name]):
            raise ValueError(f'{name}: shape {tuple(x.shape)}, expected '
                             f'{tuple(shapes[name])}')
        if x.device != device:
            raise ValueError(f'{name} is on {x.device}, expected {device}')
        if x.dtype != want_dtype:
            raise ValueError(f'{name}: dtype {x.dtype}, expected {want_dtype}')
        if not x.is_contiguous():
            raise ValueError(f'{name} must be contiguous')


# (occupancy function, device index, B, N, rows) -> co-resident CTAs; a
# property of the card and the compiled kernel, asked once per shape
_CORESIDENT = {}


def coresident_ctas(lib, occupancy_fn: str, device: torch.device,
                    geom: LaunchGeometry, B: int, N: int) -> int:
    """CTAs the card can hold at once for ``geom`` (blocks per SM from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` times the SMs)."""
    key = (occupancy_fn, device.index, B, N, geom.rows)
    if key not in _CORESIDENT:
        blocks = ctypes.c_int(0)
        _build.check(lib, getattr(lib, occupancy_fn)(
            device.index, B, N, geom.rows, ctypes.byref(blocks)),
            occupancy_fn)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _CORESIDENT[key] = blocks.value * sms
    return _CORESIDENT[key]


def lstm_seq(pre_x: torch.Tensor, w_h: torch.Tensor, peep: torch.Tensor,
             bias: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
             mask: torch.Tensor = None):
    """Whole-chunk masked peephole LSTM layer.

    pre_x: (T, B, 4, N_h) hoisted ``W_x @ x_t``; w_h: (4, N_h, N_h); peep:
    (3, N_h); bias: (4, N_h); h0, c0: (B, N_h); mask: (T, B) bool (None =
    every step live).  A masked step re-emits the carried h and keeps c.
    Returns (hs, cs), each (T, B, N_h).  CPU tensors run the plain version;
    CUDA tensors launch the kernel and count it in ``lstm_seq.launches``.
    """
    T, B, _, N = pre_x.shape
    if mask is None:
        mask = torch.ones((T, B), dtype=torch.bool, device=pre_x.device)
    if pre_x.device.type == 'cpu':
        return lstm_seq_ref(pre_x, w_h, peep, bias, h0, c0, mask)
    if pre_x.device.type != 'cuda':
        raise ValueError(f'lstm_seq runs on cuda or cpu, not {pre_x.device}')
    device = pre_x.device
    check_inputs(dict(pre_x=pre_x, w_h=w_h, peep=peep, bias=bias, h0=h0,
                      c0=c0, mask=mask),
                 dict(pre_x=(T, B, 4, N), w_h=(4, N, N), peep=(3, N),
                      bias=(4, N), h0=(B, N), c0=(B, N), mask=(T, B)),
                 device)
    hs = torch.empty((T, B, N), dtype=torch.float32, device=device)
    cs = torch.empty_like(hs)
    lib = _build.load('lstm_seq', _SIGNATURES)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    geom = seq_geometry(N, B, sms)
    if not geom.admissible(coresident_ctas(lib, 'lstm_seq_occupancy',
                                           device, geom, B, N)):
        raise RuntimeError(f'lstm_seq: launch geometry {geom} does not fit '
                           f'the card (N_h={N}, B={B})')
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.lstm_seq_launch(
        device.index, pre_x.data_ptr(), w_h.data_ptr(), peep.data_ptr(),
        bias.data_ptr(), h0.data_ptr(), c0.data_ptr(), mask.data_ptr(),
        hs.data_ptr(), cs.data_ptr(), T, B, N, geom.rows, stream)
    _build.check(lib, err, 'lstm_seq launch')
    lstm_seq.launches += 1
    return hs, cs


lstm_seq.launches = 0
