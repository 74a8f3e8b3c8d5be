"""K5 wrapper: one recurrent f32 peephole LSTM step on the card.

``lstm_gates_rec`` launches ``csrc/lstm_gates_rec.cu`` on CUDA tensors (a
plain launch on PyTorch's current stream, no grid barrier) and runs its
plain version (``ref.lstm_gates_rec_ref``) on CPU tensors; there is no
fallback between the two.  ``gates_rec_geometry`` is the launch geometry as
a pure function of shapes, which backend selection reads.
"""
from __future__ import annotations

import torch

from .. import _build
from ..lstm_seq.kernel import LaunchGeometry, check_inputs
from .ref import lstm_gates_rec_ref


def gates_rec_geometry(n_h: int, batch: int, sm_count: int) -> LaunchGeometry:
    """K5's geometry: R = ceil(N_h / SMs) rows per CTA, one CTA per row
    slice; shared memory holds h of every stream and the CTA's gate sums
    (same formula as ``smem_bytes`` in the source).  A plain launch: only
    the shared memory bounds it (``LaunchGeometry.admissible()``)."""
    rows = max(1, -(-n_h // sm_count))
    ctas = -(-n_h // rows)
    return LaunchGeometry(rows, ctas, 4 * (batch * n_h + 4 * rows * batch))


_SIGNATURES = {'lstm_gates_rec_launch': [_build.I] + [_build.P] * 8
               + [_build.I] * 3 + [_build.P]}
_SMS = {}   # device index -> SM count


def lstm_gates_rec(h: torch.Tensor, w_h: torch.Tensor, pre: torch.Tensor,
                   peep: torch.Tensor, bias: torch.Tensor,
                   c_prev: torch.Tensor):
    """One recurrent step with the hoisted input contribution.

    h: (B, N_h); w_h: (4, N_h, N_h); pre: (B, 4, N_h) = W_x x_t; peep:
    (3, N_h); bias: (4, N_h); c_prev: (B, N_h).  Returns (h, c), each
    (B, N_h).  CPU tensors run the plain version; CUDA tensors launch the
    kernel and count it in ``lstm_gates_rec.launches``.
    """
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
    lib = _build.load('lstm_gates_rec', _SIGNATURES)
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    geom = gates_rec_geometry(N, B, _SMS[dev.index])
    if not geom.admissible():
        raise ValueError(f'lstm_gates_rec: launch geometry {geom} does not '
                         f'fit one CTA (N_h={N}, B={B})')
    h_out = torch.empty((B, N), dtype=torch.float32, device=dev)
    c_out = torch.empty_like(h_out)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.lstm_gates_rec_launch(
        dev.index, h.data_ptr(), w_h.data_ptr(), pre.data_ptr(),
        peep.data_ptr(), bias.data_ptr(), c_prev.data_ptr(),
        h_out.data_ptr(), c_out.data_ptr(), B, N, geom.rows, stream)
    _build.check(lib, err, 'lstm_gates_rec launch')
    lstm_gates_rec.launches += 1
    return h_out, c_out


lstm_gates_rec.launches = 0
