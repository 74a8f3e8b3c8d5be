"""K7 wrapper: the int8 x int8 -> int32 matmul with the per-row x
per-column dequant epilogue on the card.

``quant_matmul`` launches ``csrc/quant_matmul.cu`` on CUDA tensors (a plain
launch on PyTorch's current stream) and runs its plain version
(``ref.quant_matmul_ref``) on CPU tensors; there is no fallback between the
two.  Any M, K and N: no padding to the TPU's 128-blocks.

``qmm_geometry`` picks the launch: output tiles of BM x 128 (BM 256, 128 or
64), each CTA over all of K.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import _build
from ..lstm_seq.kernel import check_inputs
from .ref import quant_matmul_ref

K_MAX = 1 << 17   # the int32 sum of K int8 products is exact below this

_P, _I = _build.P, _build.I
_SIGNATURES = {'quant_matmul_launch': [_I] + [_P] * 5 + [_I] * 6 + [_P]}
_OUT_DTYPES = (torch.float32, torch.bfloat16)

TILE_N = 128          # output columns of one CTA
TILE_MS = (256, 128, 64)


@dataclasses.dataclass(frozen=True)
class QmmGeometry:
    """One K7 launch: grid (tiles_n, tiles_m) of BM x 128 output tiles."""
    bm: int
    tiles_m: int
    tiles_n: int

    @property
    def ctas(self) -> int:
        return self.tiles_m * self.tiles_n


def qmm_geometry(M: int, N: int, sms: int) -> QmmGeometry:
    """Pure rule.  BM: the smallest of 256, 128, 64 that holds M (256 for
    larger M), halved while the tiles then still number at most ``sms`` (so
    one tile holds all of M for each column block when that fills the
    card, as at Mixtral's 256 x 6144 x 16384: 128 CTAs, every weight byte
    fetched once).  K is not split: every CTA runs all of it."""
    bm = next((b for b in reversed(TILE_MS) if M <= b), TILE_MS[0])
    tiles_n = -(-N // TILE_N)
    tiles = lambda b: -(-M // b) * tiles_n
    while bm > TILE_MS[-1] and tiles(bm // 2) <= sms:
        bm //= 2
    return QmmGeometry(bm, -(-M // bm), tiles_n)


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
    geom = qmm_geometry(
        M, N, torch.cuda.get_device_properties(dev).multi_processor_count)
    if K >= K_MAX or geom.tiles_m > 65535:
        raise ValueError(f'quant_matmul: K={K} must be below {K_MAX} (exact '
                         f'int32 sums) and M={M} at most 65535 * {geom.bm}')
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    vec = (K > 0 and K % 16 == 0 and N % 16 == 0
           and x_q.data_ptr() % 16 == 0 and w_q.data_ptr() % 16 == 0)
    lib = _build.load('quant_matmul', _SIGNATURES)
    err = lib.quant_matmul_launch(
        dev.index, x_q.data_ptr(), w_q.data_ptr(), xs.data_ptr(),
        ws.data_ptr(), out.data_ptr(), M, N, K,
        int(out_dtype == torch.bfloat16), int(vec), geom.bm,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, 'quant_matmul launch')
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
