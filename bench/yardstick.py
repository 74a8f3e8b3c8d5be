"""The yardstick: the card's published peaks and the operations and bytes
that a call's shapes need, frozen here so that a change to the program
cannot move them.

Peaks are NVIDIA's data sheet for one H100 SXM (dense rates, 700 W): HBM
3.35 TB/s, 67 TFLOP/s in float32 outside the tensor cores, 989 TFLOP/s in
bfloat16 and float16, 1,979 TOP/s in int8 and fp8.  A kernel's bound counts each input read once and each output
written once, whatever the kernel reads again, and the operations of the
live (unmasked) steps only; the bound is the larger of operations over the
peak of their type and bytes over the HBM rate.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
# the peak of a configuration's ``dtype``
PEAK_OPS_PER_S = {'float32': F32_FLOPS_PER_S, 'bfloat16': BF16_FLOPS_PER_S,
                  'float16': BF16_FLOPS_PER_S, 'int8': INT8_OPS_PER_S,
                  'float8': INT8_OPS_PER_S}

GATES = 4
EPILOGUE_OPS = 30      # elementwise operations a hidden unit a step


def macs_per_frame(n_x: int, n_h: int, n_layers: int, n_out: int) -> int:
    """Multiply-accumulates of one frame through the whole network: every
    layer's four gates over its input and its own hidden state, and the
    read-out (3,778,054 at 123 -> 3x421 -> 62)."""
    first = GATES * n_h * (n_x + n_h)
    inner = GATES * n_h * (2 * n_h)
    return first + (n_layers - 1) * inner + n_out * n_h


def bound_s(ops: float, nbytes: float, ops_per_s: float) -> float:
    """The least time the card could take: the larger of the two."""
    return max(ops / ops_per_s, nbytes / HBM_BYTES_PER_S)


def k2_call(T: int, B: int, live: int, n_h: int, n_layers: int):
    """(FLOPs, bytes) of one masked f32 K2 call over a (T, B) chunk with
    ``live`` unmasked (step, stream) pairs.  Read: the hoisted layer-0
    input product ``pre_x`` (T, B, 4, N), the inner layers' input weights
    and every layer's recurrent weights ((2L - 1) of 4 N x N), each
    layer's peepholes (3 N), biases (4 N), h0 and c0 (B, N), and the
    (T, B) mask bytes; written: every layer's hs and cs (T, B, N).
    Operations: (2L - 1) gate products and the epilogue a live step."""
    N, L = n_h, n_layers
    families = 2 * L - 1
    flops = live * (families * 2 * GATES * N * N + L * EPILOGUE_OPS * N)
    nbytes = (4 * (T * B * GATES * N + families * GATES * N * N
                   + L * (7 * N + 2 * B * N + 2 * T * B * N)) + T * B)
    return float(flops), float(nbytes)


def k4_call(T: int, B: int, live: int, n_h: int, n_layers: int):
    """(operations, bytes) of one int8 K4 call over a (T, B) chunk with
    ``live`` unmasked pairs.  Read: layer 0's int32 x-region prefix
    (T, B, 4 N), the int8 below-h and own-h weights ((2L - 1) of 4 N x N),
    int8 peepholes (3 N), int16 biases (4 N), the two 256-entry LUTs, the
    h and c codes (B, N) and the (T, B) mask; written: every layer's h and
    c codes (T, B, N).  Operations: as K2's, at the int8 peak."""
    N, L = n_h, n_layers
    families = 2 * L - 1
    ops = live * (families * 2 * GATES * N * N + L * EPILOGUE_OPS * N)
    nbytes = (4 * T * B * GATES * N + families * GATES * N * N + 3 * L * N
              + 8 * L * N + 512 + 2 * L * B * N + T * B + 2 * L * T * B * N)
    return float(ops), float(nbytes)

