// K5 and K6: one f32 peephole LSTM step, for sm_90a.  One kernel body,
// templated on whether the gate accumulator starts at a hoisted `pre`.
//
// K5 replaces the TPU kernel `lstm_gates_rec` of
// src/repro/kernels/lstm_gates/kernel.py (body `_kernel_rec`): the gate
// accumulator starts at the hoisted pre-activations `pre` = W_x x_t, adds
// W_h h_{t-1}, and the peephole epilogue gives (h_t, c_t).  The `cuda_step`
// backend launches it once per step and layer, T launches per layer call.
//
// K6 replaces `lstm_gates` of the same file (body `_kernel`): the whole cell
// from the packed [x_t; h_{t-1}] (B, N_in) against W = [W_x | W_h]
// (4, N_h, N_in), the accumulator starting at zero, then the same epilogue.
// Its public op is `lstm_cell_fused`.
//
// What bounds them on an H100: bytes.  At the training shape (N_h = 421,
// B = 8) one K5 launch must read W_h (2.84 MB) and write 27 KB, 0.88 us at
// 3.35 TB/s, against 11.4 MFLOP (0.17 us at 67 TFLOP/s); K6 reads W (3.66 MB
// for layer 0, N_in = 544; 5.67 MB for an inner layer, N_in = 842).  W stays
// in the 50 MB L2 from launch to launch, so in practice the launch latency
// and the staging of the row inputs set the pace, not HBM.
//
// Design: a plain launch on the caller's stream, CTAs split the N_h hidden
// rows, R rows each (R = ceil(N_h / SMs)).  A CTA stages the row inputs
// (h for K5, [x; h] for K6: B x K, K the row length) in shared memory once;
// one warp per (gate, row) reads that weight row coalesced from global
// memory (lanes stride k) and accumulates it against every stream's inputs,
// eight streams per pass, then a fixed butterfly reduction per stream (no
// atomics: the same inputs give the same bits).  One thread per (row,
// stream) then adds `pre` (K5 only) and runs the epilogue of
// `lstm_f32_epilogue.cuh` (shared with K1 and K2).  The dot order is the
// same in both kernels, so K5's bits do not depend on K6 sharing its body.
#include <cuda_runtime.h>

#include "lstm_f32_epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStreamsPerPass = 8;   // per-lane accumulators of one W row

// Shared memory: in_s [B][K] | acc_s [4*R][B]
size_t smem_bytes(int B, int K, int R) {
  return sizeof(float) * ((size_t)B * K + (size_t)4 * R * B);
}

// in: (B, K) row inputs; w: (4, N, K); pre: (B, 4, N), read only when
// kHasPre; out h, c: (B, N).
template <bool kHasPre>
__global__ void __launch_bounds__(kThreads)
gates_step_kernel(const float* __restrict__ in,
                  const float* __restrict__ w,
                  const float* __restrict__ pre,
                  const float* __restrict__ peep,    // (3, N)
                  const float* __restrict__ bias,    // (4, N)
                  const float* __restrict__ c_prev,  // (B, N)
                  float* __restrict__ h_out,
                  float* __restrict__ c_out,
                  int B, int N, int row_len, int R) {
  // K5's rows are N long: the constant lets the compiler see it
  const int K = kHasPre ? N : row_len;
  extern __shared__ float smem[];
  float* in_s = smem;
  float* acc_s = in_s + (size_t)B * K;

  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int i = tid; i < B * K; i += blockDim.x) in_s[i] = in[i];
  __syncthreads();

  for (int q = warp; q < 4 * R; q += n_warps) {   // q = g * R + r
    const int g = q / R, n = row0 + q % R;
    if (n >= N) continue;                         // uniform over the warp
    const float* wr = w + ((size_t)g * N + n) * K;
    for (int b0 = 0; b0 < B; b0 += kStreamsPerPass) {
      const int nb = min(kStreamsPerPass, B - b0);
      float s[kStreamsPerPass];
#pragma unroll
      for (int j = 0; j < kStreamsPerPass; ++j) s[j] = 0.0f;
      for (int k = lane; k < K; k += 32) {
        const float wk = __ldg(wr + k);
#pragma unroll
        for (int j = 0; j < kStreamsPerPass; ++j)
          if (j < nb) s[j] = fmaf(wk, in_s[(size_t)(b0 + j) * K + k], s[j]);
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
    float a[4];
    for (int g = 0; g < 4; ++g) {
      a[g] = acc_s[((size_t)g * R + r) * B + b];
      if (kHasPre) a[g] = pre[((size_t)b * 4 + g) * N + n] + a[g];
    }
    const lstm_f32::State st =
        lstm_f32::cell_update(a, c_prev[(size_t)b * N + n], peep, bias, N, n);
    h_out[(size_t)b * N + n] = st.h;
    c_out[(size_t)b * N + n] = st.c;
  }
}

template <bool kHasPre>
int launch(int device, const float* in, const float* w, const float* pre,
           const float* peep, const float* bias, const float* c_prev,
           float* h_out, float* c_out, int B, int N, int K, int R,
           void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes(B, K, R);
  if (smem > 48 * 1024) {   // above the default only by opting in
    e = cudaFuncSetAttribute(gates_step_kernel<kHasPre>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int grid = (N + R - 1) / R;
  gates_step_kernel<kHasPre><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      in, w, pre, peep, bias, c_prev, h_out, c_out, B, N, K, R);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K5: h (B, N), w_h (4, N, N), pre (B, 4, N).
int lstm_gates_rec_launch(int device, const float* h, const float* w_h,
                          const float* pre, const float* peep,
                          const float* bias, const float* c_prev,
                          float* h_out, float* c_out, int B, int N, int R,
                          void* stream) {
  return launch<true>(device, h, w_h, pre, peep, bias, c_prev, h_out, c_out,
                      B, N, N, R, stream);
}

// K6: xh (B, K), w (4, N, K), K = N_x + N_h.
int lstm_gates_launch(int device, const float* xh, const float* w,
                      const float* peep, const float* bias,
                      const float* c_prev, float* h_out, float* c_out, int B,
                      int N, int K, int R, void* stream) {
  return launch<false>(device, xh, w, nullptr, peep, bias, c_prev, h_out,
                       c_out, B, N, K, R, stream);
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
