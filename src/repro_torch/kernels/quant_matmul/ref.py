"""Plain PyTorch version of K7 (``quant_matmul``).

The exact int32 product (``core.quant.int8_matmul_int32``) and the
epilogue in the TPU kernel's order, ``(float(acc) * x_scale) * w_scale``
(``repro/kernels/quant_matmul/kernel.py:35``), so that the kernel's output
equals it bit for bit.  The reference's oracle (its ``ref.py``) associates
the epilogue as ``acc * (x_scale * w_scale)`` (``core.quant.int8_matmul``
here), which can differ in the last bit.
"""
from __future__ import annotations

import torch

from ...core.quant import int8_matmul_int32


def quant_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                     x_scale: torch.Tensor, w_scale: torch.Tensor,
                     out_dtype=torch.float32) -> torch.Tensor:
    """x_q: (M, K) int8; w_q: (K, N) int8; x_scale: (M, 1) f32; w_scale:
    (1, N) f32 (or anything that broadcasts so).  Returns (M, N) in
    ``out_dtype``."""
    acc = int8_matmul_int32(x_q, w_q).to(torch.float32)
    return (acc * x_scale * w_scale).to(out_dtype)
