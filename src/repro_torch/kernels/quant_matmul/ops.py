"""Public ops of K7: the int8 linear layer and its weight quantizer.

Counterpart of ``repro.kernels.quant_matmul.ops``.  No padding: the kernel
takes any M, K and N, so ``quantized_linear`` only flattens the leading
dims, quantizes the activations per row and calls it.
"""
from __future__ import annotations

import torch

from ...core import quant
from .kernel import quant_matmul


def quantized_linear(x: torch.Tensor, w_q: torch.Tensor,
                     w_scale) -> torch.Tensor:
    """f32 (or bf16) activations x pre-quantized int8 weights -> f32.

    The activations are quantized dynamically per row (``abs_max_scale``,
    ``quantize_scaled``).  x: (..., K); w_q: (K, N) int8; w_scale: (N,) or
    a scalar.  Returns (..., N).
    """
    lead = x.shape[:-1]
    k, n = w_q.shape
    x2 = x.reshape(-1, k)
    xs = quant.abs_max_scale(x2, axis=-1)            # (M, 1) per row
    x_q = quant.quantize_scaled(x2, xs)
    return quant_matmul(x_q, w_q, xs, w_scale).reshape(lead + (n,))


def quantize_weights(w: torch.Tensor):
    """Per-output-channel symmetric int8 weights.  w: (K, N) -> (w_q (K, N)
    int8, scale (N,))."""
    scale = quant.abs_max_scale(w, axis=0)           # (1, N)
    return quant.quantize_scaled(w, scale), scale[0]
