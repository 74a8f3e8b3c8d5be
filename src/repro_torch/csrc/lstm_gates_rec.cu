// K5: one recurrent f32 peephole LSTM step, for sm_90a.
//
// Replaces the TPU kernel `lstm_gates_rec` of
// src/repro/kernels/lstm_gates/kernel.py (body `_kernel_rec`): the gate
// accumulator starts at the hoisted pre-activations `pre` = W_x x_t, adds
// W_h h_{t-1}, and the peephole epilogue gives (h_t, c_t).  The `cuda_step`
// backend launches it once per step and layer, T launches per layer call.
//
// What bounds it on an H100: bytes.  At the training shape (N_h = 421, B = 8)
// one launch must read W_h (2.84 MB) and write 27 KB, 0.88 us at 3.35 TB/s,
// against 11.4 MFLOP (0.17 us at 67 TFLOP/s).  W_h stays in the 50 MB L2
// from step to step, so in practice the launch latency and the h staging set
// the pace, not HBM.
//
// Design: a plain launch on the caller's stream, CTAs split the N_h hidden
// rows, R rows each (R = ceil(N_h / SMs)).  A CTA stages h (B x N_h, 13.5 KB
// at the training shape) in shared memory once; one warp per (gate, row)
// reads that W_h row coalesced from global memory (lanes stride k) and
// accumulates it against every stream's h, eight streams per pass, then a
// fixed butterfly reduction per stream (no atomics: the same inputs give the
// same bits).  One thread per (row, stream) then adds `pre` and runs the
// epilogue of `lstm_f32_epilogue.cuh` (shared with K1 and K2).
#include <cuda_runtime.h>

#include "lstm_f32_epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStreamsPerPass = 8;   // per-lane accumulators of one W_h row

// Shared memory: h_s [B][N] | acc_s [4*R][B]
size_t smem_bytes(int B, int N, int R) {
  return sizeof(float) * ((size_t)B * N + (size_t)4 * R * B);
}

__global__ void __launch_bounds__(kThreads)
lstm_gates_rec_kernel(const float* __restrict__ h,       // (B, N)
                      const float* __restrict__ w_h,     // (4, N, N)
                      const float* __restrict__ pre,     // (B, 4, N)
                      const float* __restrict__ peep,    // (3, N)
                      const float* __restrict__ bias,    // (4, N)
                      const float* __restrict__ c_prev,  // (B, N)
                      float* __restrict__ h_out,         // (B, N)
                      float* __restrict__ c_out,         // (B, N)
                      int B, int N, int R) {
  extern __shared__ float smem[];
  float* h_s = smem;
  float* acc_s = h_s + (size_t)B * N;

  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int i = tid; i < B * N; i += blockDim.x) h_s[i] = h[i];
  __syncthreads();

  for (int q = warp; q < 4 * R; q += n_warps) {   // q = g * R + r
    const int g = q / R, n = row0 + q % R;
    if (n >= N) continue;                         // uniform over the warp
    const float* w = w_h + ((size_t)g * N + n) * N;
    for (int b0 = 0; b0 < B; b0 += kStreamsPerPass) {
      const int nb = min(kStreamsPerPass, B - b0);
      float s[kStreamsPerPass];
#pragma unroll
      for (int j = 0; j < kStreamsPerPass; ++j) s[j] = 0.0f;
      for (int k = lane; k < N; k += 32) {
        const float wk = __ldg(w + k);
#pragma unroll
        for (int j = 0; j < kStreamsPerPass; ++j)
          if (j < nb) s[j] = fmaf(wk, h_s[(size_t)(b0 + j) * N + k], s[j]);
      }
#pragma unroll
      for (int j = 0; j < kStreamsPerPass; ++j) {
        float v = s[j];
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0 && j < nb) acc_s[(size_t)q * B + b0 + j] = v;
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < R * B; i += blockDim.x) {
    const int r = i / B, b = i % B, n = row0 + r;
    if (n >= N) continue;
    const float* p = pre + (size_t)b * 4 * N;
    float a[4];
    for (int g = 0; g < 4; ++g)
      a[g] = p[g * N + n] + acc_s[((size_t)g * R + r) * B + b];
    const lstm_f32::State st =
        lstm_f32::cell_update(a, c_prev[(size_t)b * N + n], peep, bias, N, n);
    h_out[(size_t)b * N + n] = st.h;
    c_out[(size_t)b * N + n] = st.c;
  }
}

}  // namespace

extern "C" {

int lstm_gates_rec_launch(int device, const float* h, const float* w_h,
                          const float* pre, const float* peep,
                          const float* bias, const float* c_prev,
                          float* h_out, float* c_out, int B, int N, int R,
                          void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes(B, N, R);
  if (smem > 48 * 1024) {   // above the default only by opting in
    e = cudaFuncSetAttribute(lstm_gates_rec_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int grid = (N + R - 1) / R;
  lstm_gates_rec_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      h, w_h, pre, peep, bias, c_prev, h_out, c_out, B, N, R);
  return cudaGetLastError();
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
