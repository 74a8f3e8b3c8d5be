"""K7 wrapper: the int8 x int8 -> int32 matmul with the per-row x
per-column dequant epilogue on the card.

``quant_matmul`` launches ``csrc/quant_matmul.cu`` on CUDA tensors (a plain
launch on PyTorch's current stream) and runs its plain version
(``ref.quant_matmul_ref``) on CPU tensors; there is no fallback between the
two.  Any M, K and N: no padding to the TPU's 128-blocks.
"""
from __future__ import annotations

import torch

from .. import _build
from ..lstm_seq.kernel import check_inputs
from .ref import quant_matmul_ref

K_MAX = 1 << 17   # the int32 sum of K int8 products is exact below this

_P, _I = _build.P, _build.I
_SIGNATURES = {'quant_matmul_launch': [_I] + [_P] * 5 + [_I] * 5 + [_P]}
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def quant_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale, w_scale,
                 out_dtype=torch.float32) -> torch.Tensor:
    """x_q: (M, K) int8; w_q: (K, N) int8; x_scale: (M, 1) f32 and w_scale:
    (1, N) f32, or anything that broadcasts to them (a scalar, (N,)).
    Returns (M, N) in ``out_dtype`` (f32 or bf16): ``(float(x_q @ w_q) *
    x_scale) * w_scale`` with the product exact in int32.  CPU tensors run
    the plain version; CUDA tensors launch the kernel and count it in
    ``quant_matmul.launches``.
    """
    M, K = x_q.shape
    N = w_q.shape[-1]
    dev = x_q.device
    xs = torch.as_tensor(x_scale, dtype=torch.float32,
                         device=dev).broadcast_to((M, 1)).contiguous()
    ws = torch.as_tensor(w_scale, dtype=torch.float32,
                         device=dev).broadcast_to((1, N)).contiguous()
    if dev.type == 'cpu':
        return quant_matmul_ref(x_q, w_q, xs, ws, out_dtype)
    if dev.type != 'cuda':
        raise ValueError(f'quant_matmul runs on cuda or cpu, not {dev}')
    check_inputs(dict(x_q=x_q, w_q=w_q, xs=xs, ws=ws),
                 dict(x_q=(M, K), w_q=(K, N), xs=(M, 1), ws=(1, N)), dev,
                 dict(x_q=torch.int8, w_q=torch.int8))
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f'quant_matmul: out_dtype {out_dtype}, expected '
                         f'one of {_OUT_DTYPES}')
    if K >= K_MAX or -(-M // 128) > 65535:
        raise ValueError(f'quant_matmul: K={K} must be below {K_MAX} (exact '
                         f'int32 sums) and M={M} at most 65535 * 128')
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    vec = (K % 4 == 0 and N % 4 == 0 and x_q.data_ptr() % 4 == 0
           and w_q.data_ptr() % 4 == 0)
    lib = _build.load('quant_matmul', _SIGNATURES)
    err = lib.quant_matmul_launch(
        dev.index, x_q.data_ptr(), w_q.data_ptr(), xs.data_ptr(),
        ws.data_ptr(), out.data_ptr(), M, N, K,
        int(out_dtype == torch.bfloat16), int(vec),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, 'quant_matmul launch')
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
