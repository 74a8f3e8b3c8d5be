// The f32 peephole gate epilogue of the Chipmunk LSTM cell, shared by K1
// (`lstm_seq.cu`), K2 (`lstm_stack_seq.cu`) and K5 (`lstm_gates_rec.cu`):
// the card-side counterpart of `_gate_phase` in the reference's
// src/repro/kernels/lstm_gates/kernel.py and of `core.lstm._gate_phase` in
// the port, operation for operation in the reference's order.
#pragma once

namespace lstm_f32 {

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

struct State {
  float h, c;
};

// One (row n, stream) update from the four gate sums `a` (gate order i, f,
// g, o: W_x x_t + W_h h_{t-1}, bias not yet added).  `peep` is (3, N),
// `bias` (4, N).  The o gate's peephole reads the new c.
__device__ __forceinline__ State cell_update(const float a[4], float c_prev,
                                             const float* peep,
                                             const float* bias, int N,
                                             int n) {
  const float ig = sigmoid(a[0] + peep[0 * N + n] * c_prev + bias[0 * N + n]);
  const float fg = sigmoid(a[1] + peep[1 * N + n] * c_prev + bias[1 * N + n]);
  const float gg = tanhf(a[2] + bias[2 * N + n]);
  const float c_new = fg * c_prev + ig * gg;
  const float og = sigmoid(a[3] + peep[2 * N + n] * c_new + bias[3 * N + n]);
  return {og * tanhf(c_new), c_new};
}

}  // namespace lstm_f32
