"""Fixed-point quantization of the silicon datapath (contribution C2), in PyTorch.

Port of the parts of ``repro.core.quant`` that the int8 forward path uses:
symmetric signed Q-formats, float <-> code conversion, the 16-bit saturating
partial-sum semantics of the systolic hop, the silicon's rounding right
shift, and the 256-entry activation LUTs.  Three details keep it bit-equal to
the reference: ``torch.round`` rounds half to even as ``jnp.round`` does,
``>>`` on a signed integer tensor is an arithmetic shift, and a LUT is
indexed with ``code + 128``.  The arbitrary-scale symmetric int8 helpers
(``abs_max_scale``, ``quantize_scaled``, ``int8_matmul``) serve the int8
linear op of K7 (``kernels.quant_matmul``); ``quantize_scaled`` divides by
the scale, as the reference does, so its codes are the reference's bit for
bit.  ``fake_quant`` is the quantization-aware-training op (a clipped
straight-through gradient) and ``requantize`` the accumulator-to-code
shift of the paper's datapath, both as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

INT8_MIN, INT8_MAX = -128, 127
INT16_MIN, INT16_MAX = -(2 ** 15), 2 ** 15 - 1


@dataclasses.dataclass(frozen=True)
class QFormat:
    """Signed fixed-point format Q<int_bits>.<frac_bits> (sign bit implicit)."""

    int_bits: int
    frac_bits: int

    @property
    def bits(self) -> int:
        return 1 + self.int_bits + self.frac_bits

    @property
    def scale(self) -> float:
        return 2.0 ** (-self.frac_bits)

    @property
    def max_val(self) -> float:
        return (2 ** (self.bits - 1) - 1) * self.scale

    @property
    def min_val(self) -> float:
        return -(2 ** (self.bits - 1)) * self.scale


# The formats of the Chipmunk datapath (8-bit storage, 16-bit accumulation).
# Weights/states live in Q2.5: range [-4, 3.97], resolution 2^-5.
WEIGHT_FMT = QFormat(int_bits=2, frac_bits=5)
STATE_FMT = QFormat(int_bits=2, frac_bits=5)
GATE_FMT = QFormat(int_bits=0, frac_bits=7)  # gates are in (-1, 1)


def quantize(x: torch.Tensor, fmt: QFormat = STATE_FMT) -> torch.Tensor:
    """Float -> integer code (int8 for 8-bit formats, else int16), rounding
    half to even."""
    q = torch.round(x / fmt.scale)
    q = torch.clamp(q, -(2 ** (fmt.bits - 1)), 2 ** (fmt.bits - 1) - 1)
    return q.to(torch.int8 if fmt.bits <= 8 else torch.int16)


def dequantize(q: torch.Tensor, fmt: QFormat = STATE_FMT) -> torch.Tensor:
    return q.to(torch.float32) * fmt.scale


class _FakeQuant(torch.autograd.Function):
    """``dequantize(quantize(x, fmt))`` forward; the clipped
    straight-through estimator backward: the gradient passes where
    ``fmt.min_val <= x <= fmt.max_val`` and is 0 elsewhere."""

    @staticmethod
    def forward(ctx, x, fmt):
        ctx.save_for_backward(x)
        ctx.fmt = fmt
        return dequantize(quantize(x, fmt), fmt)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        fmt = ctx.fmt
        mask = (x >= fmt.min_val) & (x <= fmt.max_val)
        return g * mask.to(g.dtype), None


def fake_quant(x: torch.Tensor, fmt: QFormat = STATE_FMT) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient (for QAT)."""
    return _FakeQuant.apply(x, fmt)


def saturating_add_int16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Saturating 16-bit add — the semantics of Chipmunk's partial-sum hops.
    Returns int32 values in the int16 range."""
    s = a.to(torch.int32) + b.to(torch.int32)
    return torch.clamp(s, INT16_MIN, INT16_MAX)


def saturate_int16(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, INT16_MIN, INT16_MAX)


def rshift_round(x, shift: int):
    """Arithmetic right shift with round-to-nearest — the silicon's alignment
    step (on a signed int32 tensor or a Python int)."""
    return (x + (1 << (shift - 1))) >> shift if shift > 0 else x


# ---------------------------------------------------------------------------
# LUT activations — the hardware's sigmoid/tanh
# ---------------------------------------------------------------------------

def build_act_lut(fn, in_fmt: QFormat, out_fmt: QFormat = GATE_FMT
                  ) -> np.ndarray:
    """256-entry table: input code (int8, offset by +128) -> output code (int8).

    Exactly what the silicon's activation LUT contains (numpy, as in the
    reference).
    """
    codes = np.arange(-(2 ** (in_fmt.bits - 1)), 2 ** (in_fmt.bits - 1))
    vals = fn(codes * in_fmt.scale)
    out = np.clip(np.round(vals / out_fmt.scale),
                  -(2 ** (out_fmt.bits - 1)), 2 ** (out_fmt.bits - 1) - 1)
    return out.astype(np.int8)


def apply_lut(lut: torch.Tensor, q: torch.Tensor, in_fmt: QFormat
              ) -> torch.Tensor:
    """Apply a 2**bits entry LUT to integer codes ``q``."""
    idx = q.to(torch.int64) + 2 ** (in_fmt.bits - 1)
    return lut[idx]


def requantize(acc: torch.Tensor, acc_fmt: QFormat, out_fmt: QFormat
               ) -> torch.Tensor:
    """Shift an integer accumulator (``acc_fmt``) into ``out_fmt`` codes:
    a rounding right shift (half up, arithmetic on a signed tensor) when
    ``acc_fmt`` has more fraction bits, a left shift when it has fewer,
    then a clip to ``out_fmt``'s range; the dtype of ``acc`` is kept."""
    shift = acc_fmt.frac_bits - out_fmt.frac_bits
    if shift >= 0:
        rounded = (acc + (1 << shift >> 1)) >> shift if shift > 0 else acc
    else:
        rounded = acc << (-shift)
    return torch.clamp(rounded, -(2 ** (out_fmt.bits - 1)),
                       2 ** (out_fmt.bits - 1) - 1)


_SIGMOID = lambda z: 1.0 / (1.0 + np.exp(-z))
_TANH = np.tanh


def default_luts(pre_fmt: QFormat = STATE_FMT, device='cuda'):
    """(sigmoid_lut, tanh_lut), each (256,) int8 on ``device``, for gate
    computation at the given pre-activation format."""
    return tuple(torch.from_numpy(build_act_lut(fn, pre_fmt, GATE_FMT)
                                  ).to(device)
                 for fn in (_SIGMOID, _TANH))


# ---------------------------------------------------------------------------
# Arbitrary-scale symmetric int8 (the int8 linear op, K7)
# ---------------------------------------------------------------------------

def abs_max_scale(x: torch.Tensor, axis: Optional[int] = None,
                  eps: float = 1e-8) -> torch.Tensor:
    """Symmetric per-tensor (``axis=None``) or per-channel scale
    ``max(amax, eps) / 127``, so ``x / scale`` fits int8 (the channel axis
    kept with size 1)."""
    a = x.abs()
    amax = torch.clamp_min(
        a.amax() if axis is None else a.amax(dim=axis, keepdim=True), eps)
    # a tensor divisor: on the card PyTorch divides by a Python scalar as a
    # product with its reciprocal, which can differ from the reference's
    # quotient in the last bit
    return amax / torch.full_like(amax, INT8_MAX)


def quantize_scaled(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale))`` as int8, rounding half to even."""
    return torch.clamp(torch.round(x / scale), INT8_MIN, INT8_MAX
                       ).to(torch.int8)


def dequantize_scaled(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def int8_matmul_int32(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 codes, x_q (..., K) @ w_q (K, N).
    Computed in float64, where every partial sum of int8 products is an
    integer below 2**53 and so exact in any order (PyTorch has no int32
    product on the card); exact in int32 while K < 2**17 (K * 128**2 <
    2**31), as the int32 accumulators of the reference and of K7 are."""
    return torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64)
                        ).to(torch.int32)


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> int32 accumulate -> f32 rescale, in the reference's
    order ``acc * (x_scale * w_scale)``; ``w_scale`` may be per channel of
    the output dim."""
    return (int8_matmul_int32(x_q, w_q).to(torch.float32)
            * (x_scale * w_scale))
