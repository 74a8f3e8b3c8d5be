"""K5 and K6 wrappers: one f32 peephole LSTM step on the card.

``lstm_gates_rec`` (K5, from the hoisted ``pre``) and ``lstm_gates`` (K6,
the whole cell from the packed [x; h]) launch the one templated kernel body
of ``csrc/lstm_gates_rec.cu`` on CUDA tensors (programmatic dependent
launches on PyTorch's current stream, no grid barrier) and run their plain
versions (``ref``) on CPU tensors; there is no fallback between the two.
The public ops read nothing before the kernel ahead of them has finished;
only ``_gates_rec(..., early=True)``, which the ``cuda_step`` chain uses,
stages its weights while the K5 launch before it finishes.  Each wrapper
keeps the geometry and ``early`` flag of its last launch in
``last_launch``.  ``gates_geometry`` is the launch geometry as a pure
function of shapes, which backend selection reads.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from .. import _build
from ..lstm_seq.kernel import SMEM_PER_CTA_MAX, LaunchGeometry, check_inputs
from .ref import lstm_gates_rec_ref, lstm_gates_ref

CHUNK = 8    # streams per staged input chunk (``kChunk`` in the source)
WARPS = 8    # warps per CTA (``kThreads / 32``)


@dataclasses.dataclass(frozen=True)
class GatesGeometry(LaunchGeometry):
    """``LaunchGeometry`` plus ``stages``: the ring slots of 8-stream input
    chunks in shared memory (0: the kernel reads its operands from global
    memory; ``ceil(B / 8)``: every chunk in flight at the start)."""
    stages: int


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _span(n_floats: int) -> int:
    """Shared bytes of a staged span of ``n_floats`` (``span_bytes``)."""
    return _round16(4 * n_floats) + 16


def gates_smem_bytes(batch: int, n_in: int, rows: int, stages: int) -> int:
    """Shared memory of one CTA (the formula of ``layout`` in the source):
    the mbarriers, the weight slab (4 spans of ``rows`` rows), ``stages``
    ring slots (an input chunk, its ``pre`` and ``c_prev`` rows), the gate
    sums of one chunk for every K split, and ``peep`` and ``bias``."""
    cap = min(batch, CHUNK)
    splits = max(1, WARPS // rows)
    fixed = 4 * (splits * rows * 4 * CHUNK + 8 * rows)
    if stages == 0:
        return 16 + fixed
    slot = _span(cap * n_in) + 4 * 5 * rows * CHUNK
    return (_round16(8 * (1 + stages)) + 4 * _span(rows * n_in)
            + stages * slot + fixed)


@functools.lru_cache(maxsize=None)
def gates_geometry(n_h: int, n_in: int, batch: int, sm_count: int
                   ) -> GatesGeometry:
    """The geometry of K5 (``n_in`` = N_h) and K6 (``n_in`` = N_x + N_h):
    R = ceil(N_h / SMs) rows per CTA (all four gates), one CTA per row
    slice; as many ring slots as fit beside the weight slab, up to one per
    chunk of 8 streams; none when the slab and one slot do not fit.  No
    grid barrier: only the shared memory bounds it
    (``LaunchGeometry.admissible()``), and the unstaged form (no slots)
    needs little of it, so any B is admitted wherever one stream is."""
    rows = max(1, -(-n_h // sm_count))
    ctas = -(-n_h // rows)
    stages = -(-batch // CHUNK)
    while stages > 0 and gates_smem_bytes(batch, n_in, rows,
                                          stages) > SMEM_PER_CTA_MAX:
        stages -= 1
    return GatesGeometry(rows, ctas,
                         gates_smem_bytes(batch, n_in, rows, stages), stages)


def gates_rec_geometry(n_h: int, batch: int, sm_count: int) -> GatesGeometry:
    """K5's geometry (``gates_geometry`` with rows of length N_h)."""
    return gates_geometry(n_h, n_h, batch, sm_count)


_P, _I = _build.P, _build.I
_SIGNATURES = {'lstm_gates_rec_launch': [_I] + [_P] * 8 + [_I] * 5 + [_P],
               'lstm_gates_launch': [_I] + [_P] * 7 + [_I] * 5 + [_P]}
_SMS = {}   # device index -> SM count


def _launch_setup(name: str, dev: torch.device, n_h: int, n_in: int, B: int):
    """The loaded library and an admissible geometry for one launch."""
    lib = _build.load('lstm_gates_rec', _SIGNATURES)
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    geom = gates_geometry(n_h, n_in, B, _SMS[dev.index])
    if not geom.admissible():
        raise ValueError(f'{name}: launch geometry {geom} does not fit one '
                         f'CTA (N_h={n_h}, row length {n_in}, B={B})')
    return lib, geom


def lstm_gates_rec(h: torch.Tensor, w_h: torch.Tensor, pre: torch.Tensor,
                   peep: torch.Tensor, bias: torch.Tensor,
                   c_prev: torch.Tensor):
    """One recurrent step with the hoisted input contribution.

    h: (B, N_h); w_h: (4, N_h, N_h); pre: (B, 4, N_h) = W_x x_t; peep:
    (3, N_h); bias: (4, N_h); c_prev: (B, N_h).  Returns (h, c), each
    (B, N_h).  CPU tensors run the plain version; CUDA tensors launch the
    kernel and count it in ``lstm_gates_rec.launches``.  The launch reads
    nothing before the kernel ahead of it on the stream has finished.
    """
    return _gates_rec(h, w_h, pre, peep, bias, c_prev, early=False)


def _gates_rec(h, w_h, pre, peep, bias, c_prev, *, early: bool):
    """``lstm_gates_rec``; ``early``: the kernel just before this launch on
    the current stream is the K5 launch that wrote ``h`` and ``c_prev``,
    and nothing since has written ``w_h``, ``pre``, ``peep`` or ``bias``.
    The launch then stages those four while that launch finishes, and reads
    ``h`` and ``c_prev`` once it has.  Only ``_step_forward`` knows that."""
    B, N = h.shape
    dev = h.device
    if dev.type == 'cpu':
        return lstm_gates_rec_ref(h, w_h, pre, peep, bias, c_prev)
    if dev.type != 'cuda':
        raise ValueError(f'lstm_gates_rec runs on cuda or cpu, not {dev}')
    check_inputs(dict(h=h, w_h=w_h, pre=pre, peep=peep, bias=bias,
                      c_prev=c_prev),
                 dict(h=(B, N), w_h=(4, N, N), pre=(B, 4, N), peep=(3, N),
                      bias=(4, N), c_prev=(B, N)), dev)
    lib, geom = _launch_setup('lstm_gates_rec', dev, N, N, B)
    h_out = torch.empty((B, N), dtype=torch.float32, device=dev)
    c_out = torch.empty_like(h_out)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.lstm_gates_rec_launch(
        dev.index, h.data_ptr(), w_h.data_ptr(), pre.data_ptr(),
        peep.data_ptr(), bias.data_ptr(), c_prev.data_ptr(),
        h_out.data_ptr(), c_out.data_ptr(), B, N, geom.rows, geom.stages,
        int(early), stream)
    _build.check(lib, err, 'lstm_gates_rec launch')
    lstm_gates_rec.launches += 1
    lstm_gates_rec.last_launch = (geom, early)
    return h_out, c_out


lstm_gates_rec.launches = 0
lstm_gates_rec.last_launch = None


def lstm_gates(xh: torch.Tensor, w: torch.Tensor, peep: torch.Tensor,
               bias: torch.Tensor, c_prev: torch.Tensor):
    """The fused LSTM cell from the packed inputs (the reference's
    ``lstm_gates`` contract, any N_in and N_h: no padding to blocks).

    xh: (B, N_in) = [x_t; h_{t-1}]; w: (4, N_h, N_in) = [W_x | W_h]; peep:
    (3, N_h); bias: (4, N_h); c_prev: (B, N_h).  Returns (h, c), each
    (B, N_h).  CPU tensors run the plain version; CUDA tensors launch the
    kernel and count it in ``lstm_gates.launches``.
    """
    B, K = xh.shape
    N = c_prev.shape[-1]
    dev = xh.device
    if dev.type == 'cpu':
        return lstm_gates_ref(xh, w, peep, bias, c_prev)
    if dev.type != 'cuda':
        raise ValueError(f'lstm_gates runs on cuda or cpu, not {dev}')
    check_inputs(dict(xh=xh, w=w, peep=peep, bias=bias, c_prev=c_prev),
                 dict(xh=(B, K), w=(4, N, K), peep=(3, N), bias=(4, N),
                      c_prev=(B, N)), dev)
    lib, geom = _launch_setup('lstm_gates', dev, N, K, B)
    h_out = torch.empty((B, N), dtype=torch.float32, device=dev)
    c_out = torch.empty_like(h_out)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.lstm_gates_launch(
        dev.index, xh.data_ptr(), w.data_ptr(), peep.data_ptr(),
        bias.data_ptr(), c_prev.data_ptr(), h_out.data_ptr(),
        c_out.data_ptr(), B, N, K, geom.rows, geom.stages, stream)
    _build.check(lib, err, 'lstm_gates launch')
    lstm_gates.launches += 1
    lstm_gates.last_launch = (geom, False)
    return h_out, c_out


lstm_gates.launches = 0
lstm_gates.last_launch = None
