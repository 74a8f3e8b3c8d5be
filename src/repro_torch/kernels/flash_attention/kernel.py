"""K8 wrapper: blockwise online-softmax attention on the card.

``flash_attention`` launches ``csrc/flash_attention.cu`` on CUDA tensors (a
plain launch on PyTorch's current stream) and runs its plain version
(``ref.attention_ref``) on CPU tensors; there is no fallback between the
two.  Any Sq and Sk (no padding to blocks), D <= 128, f32 or bf16.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from ..lstm_seq.kernel import check_inputs
from .ref import attention_ref

D_MAX = 128
POS_MAX = 1 << 28     # |positions| stay below 2 POS_MAX: int32 never wraps

_P, _I = _build.P, _build.I
_SIGNATURES = {'flash_attention_launch': [_I] + [_P] * 4 + [_I] * 6
               + [ctypes.c_float] + [_I] * 7 + [_P]}
_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    sm_scale: Optional[float] = None,
                    kv_len: Optional[int] = None,
                    offset: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D) with H % Hkv == 0, all f32 or
    all bf16.  Returns (B, H, Sq, D) in q's dtype.

    ``offset``: absolute position of query row 0 minus that of key row 0
    (default Sk - Sq when causal, else 0).  ``kv_len``: keys j < kv_len
    only.  ``window``: query position p attends keys j with p - j < window
    (also without ``causal``).  ``sm_scale`` defaults to D ** -0.5.  CPU
    tensors run the plain version; CUDA tensors launch the kernel and count
    it in ``flash_attention.launches``.
    """
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if hkv < 1 or h % hkv:
        raise ValueError(f'flash_attention: H={h} is not a multiple of '
                         f'Hkv={hkv}')
    scale = d ** -0.5 if sm_scale is None else sm_scale
    if offset is None:
        offset = sk - sq if causal else 0
    dev = q.device
    if dev.type == 'cpu':
        return attention_ref(q, k, v, causal=causal, window=window,
                             sm_scale=scale, kv_len=kv_len, offset=offset)
    if dev.type != 'cuda':
        raise ValueError(f'flash_attention runs on cuda or cpu, not {dev}')
    if q.dtype not in _DTYPES:
        raise ValueError(f'flash_attention: dtype {q.dtype}, expected one '
                         f'of {_DTYPES}')
    check_inputs(dict(q=q, k=k, v=v),
                 dict(q=(b, h, sq, d), k=(b, hkv, sk, d), v=(b, hkv, sk, d)),
                 dev, dict(q=q.dtype, k=q.dtype, v=q.dtype))
    if d > D_MAX or b * h > 65535 or max(sq, sk, abs(offset)) >= POS_MAX:
        raise ValueError(f'flash_attention: D={d} must be at most {D_MAX}, '
                         f'B*H={b * h} at most 65535, and Sq={sq}, Sk={sk}, '
                         f'|offset|={abs(offset)} below {POS_MAX}')
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    # a window beyond +-2 POS_MAX passes or masks every pair alike
    win = 0 if window is None else max(-2 * POS_MAX, min(2 * POS_MAX, window))
    kv = sk if kv_len is None else max(-1, min(sk, kv_len))
    vec = d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (q, k, v, out))
    lib = _build.load('flash_attention', _SIGNATURES)
    err = lib.flash_attention_launch(
        dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, hkv, sq, sk, d, float(scale), int(causal),
        int(window is not None), win, kv, offset,
        int(q.dtype == torch.bfloat16), int(vec),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, 'flash_attention launch')
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
