// The integer tail of the Chipmunk int8 LSTM cell, shared by K3
// (`lstm_seq_q.cu`) and K4 (`lstm_stack_seq_q.cu`): the serial saturating
// hop chain over a row's column-tile partials, then the epilogue of
// `core.systolic._quantized_state_update`, operation for operation, and the
// mask select.  `>>` on a signed int is an arithmetic shift.
#pragma once

#include <stdint.h>

namespace lstm_q {

__device__ __forceinline__ int sat16(int x) {
  return min(max(x, -32768), 32767);
}
__device__ __forceinline__ int clip8(int x) { return min(max(x, -128), 127); }
__device__ __forceinline__ int rshift_round(int x, int s) {
  return (x + (1 << (s - 1))) >> s;
}

// One gate: sat16 -> >>5 rounded -> clip -> LUT.
__device__ __forceinline__ int gate_lut(int a, const int8_t* lut) {
  return lut[clip8(rshift_round(sat16(a), 5)) + 128];
}

// The engines' serial hop: `acc` plus each of the `n` tile partials in
// order, with a saturation after every add.
__device__ __forceinline__ int saturating_hops(int acc, const int* part,
                                               int n) {
  for (int c = 0; c < n; ++c) acc = sat16(acc + part[c]);
  return acc;
}

struct Codes {
  int8_t h, c;
};

// One (row n, stream) update from the four hop-chain accumulators (gate
// order i, f, g, o): gate = LUT(clip(sat16(acc + bias (+ peep * c)) >> 5));
// c = clip(sat16(f*c + (i*g >> 2)) >> 7); the o gate's peephole reads the
// clipped c; h = clip((o * tanh_lut(c)) >> 9).  A masked step (`live`
// false) re-emits the carried `h_prev` and keeps `c_prev`.  `bias` is
// (4, P_h), `peep` (3, P_h); `luts` holds the sigmoid LUT at [0, 256) and
// the tanh LUT at [256, 512).
__device__ __forceinline__ Codes state_update(const int acc[4], int c_prev,
                                              int8_t h_prev, bool live,
                                              const int16_t* bias,
                                              const int8_t* peep, int P_h,
                                              int n, const int8_t* luts) {
  const int ig = gate_lut(acc[0] + bias[0 * P_h + n] +
                              peep[0 * P_h + n] * c_prev, luts);
  const int fg = gate_lut(acc[1] + bias[1 * P_h + n] +
                              peep[1 * P_h + n] * c_prev, luts);
  const int gg = gate_lut(acc[2] + bias[2 * P_h + n], luts + 256);
  const int c_new = sat16(fg * c_prev + rshift_round(ig * gg, 2));
  const int c8 = clip8(rshift_round(c_new, 7));
  const int og = gate_lut(acc[3] + bias[3 * P_h + n] +
                              peep[2 * P_h + n] * c8, luts);
  const int h8 = clip8(rshift_round(og * luts[256 + c8 + 128], 9));
  if (!live) return Codes{h_prev, (int8_t)c_prev};
  return Codes{(int8_t)h8, (int8_t)c8};
}

}  // namespace lstm_q
