"""Fixed-point quantization of the silicon datapath (contribution C2), in PyTorch.

Port of the parts of ``repro.core.quant`` that the int8 forward path uses:
symmetric signed Q-formats, float <-> code conversion, the 16-bit saturating
partial-sum semantics of the systolic hop, the silicon's rounding right
shift, and the 256-entry activation LUTs.  Three details keep it bit-equal to
the reference: ``torch.round`` rounds half to even as ``jnp.round`` does,
``>>`` on a signed integer tensor is an arithmetic shift, and a LUT is
indexed with ``code + 128``.  Quantization-aware training (``fake_quant``)
and the arbitrary-scale int8 matmul path are not ported here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

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


_SIGMOID = lambda z: 1.0 / (1.0 + np.exp(-z))
_TANH = np.tanh


def default_luts(pre_fmt: QFormat = STATE_FMT, device='cuda'):
    """(sigmoid_lut, tanh_lut), each (256,) int8 on ``device``, for gate
    computation at the given pre-activation format."""
    return tuple(torch.from_numpy(build_act_lut(fn, pre_fmt, GATE_FMT)
                                  ).to(device)
                 for fn in (_SIGMOID, _TANH))
