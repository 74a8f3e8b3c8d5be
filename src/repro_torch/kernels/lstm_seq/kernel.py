"""K1 and K3 wrappers: the persistent whole-chunk LSTM layer kernels.

``lstm_seq`` (f32, ``csrc/lstm_seq.cu``) and ``lstm_seq_quantized`` (the
int8 silicon datapath, ``csrc/lstm_seq_q.cu``) launch their kernels on CUDA
tensors (a cooperative launch on PyTorch's current stream) and run their
plain versions (``ref``) on CPU tensors; there is no fallback between the
two.  ``seq_geometry`` and ``seq_q_geometry`` are the launch geometries as
pure functions of shapes, which backend selection reads to decide
admissibility without touching the card.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import _build
from .ref import lstm_seq_quantized_ref, lstm_seq_ref

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


def check_inputs(named, shapes, device, dtypes=None) -> None:
    """Raise ``ValueError`` unless every tensor has its expected shape, lies
    on ``device``, is contiguous and has its dtype (``dtypes[name]``, else
    f32, the mask bool)."""
    for name, x in named.items():
        want_dtype = (dtypes[name] if dtypes and name in dtypes else
                      torch.bool if name == 'mask' else torch.float32)
        if tuple(x.shape) != tuple(shapes[name]):
            raise ValueError(f'{name}: shape {tuple(x.shape)}, expected '
                             f'{tuple(shapes[name])}')
        if x.device != device:
            raise ValueError(f'{name} is on {x.device}, expected {device}')
        if x.dtype != want_dtype:
            raise ValueError(f'{name}: dtype {x.dtype}, expected {want_dtype}')
        if not x.is_contiguous():
            raise ValueError(f'{name} must be contiguous')


# (occupancy function, device index, shape ints, rows) -> co-resident CTAs;
# a property of the card and the compiled kernel, asked once per shape
_CORESIDENT = {}


def coresident_ctas(lib, occupancy_fn: str, device: torch.device,
                    geom: LaunchGeometry, *shape: int) -> int:
    """CTAs the card can hold at once for ``geom`` (blocks per SM from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` times the SMs).  The
    occupancy function takes ``(device, *shape, rows, &blocks)``."""
    key = (occupancy_fn, device.index, shape, geom.rows)
    if key not in _CORESIDENT:
        blocks = ctypes.c_int(0)
        _build.check(lib, getattr(lib, occupancy_fn)(
            device.index, *shape, geom.rows, ctypes.byref(blocks)),
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


# ---------------------------------------------------------------------------
# K3: the int8 silicon datapath, one layer
# ---------------------------------------------------------------------------

def check_tile(tile: int) -> None:
    """The int8 kernels read a tile as whole ``char4`` words (``__dp4a``)."""
    if tile % 4:
        raise ValueError(f'the int8 kernels need a tile that is a multiple '
                         f'of 4, got {tile}')


def seq_q_geometry(padded_x: int, padded_h: int, tile: int, batch: int,
                   sm_count: int) -> LaunchGeometry:
    """K3's geometry: R = ceil(padded_h / SMs) output rows per CTA; shared
    memory holds the CTA's tile partials (int32, 4*R*B*C), its 4*R int8
    weight rows over every column tile, the packed ``[x_t | h_{t-1}]``
    codes of every stream, both LUTs and the c codes (same formula as
    ``smem_bytes`` in the source)."""
    p_in = padded_x + padded_h
    rows = max(1, -(-padded_h // sm_count))
    ctas = -(-padded_h // rows)
    smem = (16 * rows * batch * (p_in // tile) + 4 * rows * p_in
            + batch * p_in + 512 + rows * batch)
    return LaunchGeometry(rows, ctas, smem)


_SIGNATURES_Q = {
    'lstm_seq_q_occupancy': [_I] * 6 + [ctypes.POINTER(ctypes.c_int)],
    'lstm_seq_q_launch': [_I] + [_P] * 11 + [_I] * 6 + [_P],
}


def lstm_seq_quantized(xs_q: torch.Tensor, w_q: torch.Tensor,
                       peep_q: torch.Tensor, bias_q: torch.Tensor,
                       sig_lut: torch.Tensor, tanh_lut: torch.Tensor,
                       h0_q: torch.Tensor = None, c0_q: torch.Tensor = None,
                       mask: torch.Tensor = None, *, tile: int, cols_x: int):
    """Whole-chunk bit-accurate int8 LSTM layer (the silicon datapath).

    xs_q: (T, B, padded_x) int8 frame codes; w_q: (4, padded_h, padded_in)
    int8 dense engine-tile layout (``[W_x | W_h]``, the x-region padded to
    whole tiles); peep_q: (3, padded_h) int8; bias_q: (4, padded_h) int16 in
    ACC_FMT; sig_lut, tanh_lut: (256,) int8; h0_q, c0_q: (B, padded_h) int8
    carried codes (None = zero); mask: (T, B) bool (None = every step live;
    a masked step re-emits the carried h codes and keeps c).  Returns (hs,
    cs), each (T, B, padded_h) int8, bit-identical to scanning
    ``core.systolic.systolic_cell_quantized``.  CPU tensors run the plain
    version; CUDA tensors launch the kernel and count it in
    ``lstm_seq_quantized.launches``.
    """
    T, B, p_x = xs_q.shape
    _, p_h, p_in = w_q.shape
    if p_x != cols_x * tile or p_in != p_x + p_h or p_h % tile:
        raise ValueError(f'lstm_seq_quantized: padded_x={p_x}, '
                         f'w_q {tuple(w_q.shape)} do not fit tile={tile}, '
                         f'cols_x={cols_x}')
    dev = xs_q.device
    zeros = lambda: torch.zeros((B, p_h), dtype=torch.int8, device=dev)
    h0_q = zeros() if h0_q is None else h0_q
    c0_q = zeros() if c0_q is None else c0_q
    if mask is None:
        mask = torch.ones((T, B), dtype=torch.bool, device=dev)
    args = (xs_q, w_q, peep_q, bias_q, sig_lut, tanh_lut, h0_q, c0_q, mask)
    if dev.type == 'cpu':
        return lstm_seq_quantized_ref(*args, tile=tile, cols_x=cols_x)
    if dev.type != 'cuda':
        raise ValueError(f'lstm_seq_quantized runs on cuda or cpu, not {dev}')
    check_tile(tile)
    i8, i16 = torch.int8, torch.int16
    check_inputs(dict(xs_q=xs_q, w_q=w_q, peep_q=peep_q, bias_q=bias_q,
                      sig_lut=sig_lut, tanh_lut=tanh_lut, h0_q=h0_q,
                      c0_q=c0_q, mask=mask),
                 dict(xs_q=(T, B, p_x), w_q=(4, p_h, p_in), peep_q=(3, p_h),
                      bias_q=(4, p_h), sig_lut=(256,), tanh_lut=(256,),
                      h0_q=(B, p_h), c0_q=(B, p_h), mask=(T, B)),
                 dev, dict(xs_q=i8, w_q=i8, peep_q=i8, bias_q=i16,
                           sig_lut=i8, tanh_lut=i8, h0_q=i8, c0_q=i8))
    hs = torch.empty((T, B, p_h), dtype=torch.int8, device=dev)
    cs = torch.empty_like(hs)
    lib = _build.load('lstm_seq_q', _SIGNATURES_Q)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    geom = seq_q_geometry(p_x, p_h, tile, B, sms)
    if not geom.admissible(coresident_ctas(lib, 'lstm_seq_q_occupancy', dev,
                                           geom, B, p_x, p_h, tile)):
        raise RuntimeError(f'lstm_seq_quantized: launch geometry {geom} does '
                           f'not fit the card (padded_h={p_h}, B={B})')
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.lstm_seq_q_launch(
        dev.index, xs_q.data_ptr(), w_q.data_ptr(), peep_q.data_ptr(),
        bias_q.data_ptr(), sig_lut.data_ptr(), tanh_lut.data_ptr(),
        h0_q.data_ptr(), c0_q.data_ptr(), mask.data_ptr(), hs.data_ptr(),
        cs.data_ptr(), T, B, p_x, p_h, tile, geom.rows, stream)
    _build.check(lib, err, 'lstm_seq_quantized launch')
    lstm_seq_quantized.launches += 1
    return hs, cs


lstm_seq_quantized.launches = 0
