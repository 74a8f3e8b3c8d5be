// K1: persistent whole-chunk f32 peephole LSTM layer, masked, for sm_90a.
//
// Replaces the TPU kernel `lstm_seq` of src/repro/kernels/lstm_seq/kernel.py
// (body `_seq_kernel`): one launch covers T steps of one layer for B streams,
// the recurrent weights stay on chip for the whole chunk, and a masked step
// re-emits the carried h and keeps c.
//
// What bounds it on an H100: not bytes and not FLOPs.  At the serving shape
// (N_h = 421, B = 8, T = 16) one step is 4*421*421*8 multiply-adds (11 MFLOP)
// spread over ~106 SMs, and the weights (2.8 MB) are read once per launch.
// The step-to-step dependency is what costs: each step needs every row of
// h_{t-1}, so every CTA waits at a grid-wide barrier once per step.
//
// Design: CTAs split the N_h hidden rows, R rows each (R = ceil(N_h / SMs)),
// and each CTA owns all four gates of its rows, so the peephole epilogue is
// local.  The CTA's 4*R weight rows are loaded into shared memory once and
// stay there for the chunk (weight-stationary, as on the Chipmunk engines);
// its c rows stay in shared memory too.  Per step: stage h_{t-1} (B x N_h)
// from global memory into shared memory (L1 bypassed, since other CTAs
// wrote it), one warp per (gate, row, stream) dot with lanes striding k and a
// fixed butterfly reduction (no atomics, so the same inputs give the same
// bits whatever the chunking), the epilogue in the reference's
// `_cell_body` order, the mask select, h_t and c_t written to the outputs,
// then `this_grid().sync()`.  h_t written to `hs[t]` is what step t+1 reads,
// so no separate h buffer is needed.  The launch is cooperative, and the
// wrapper refuses a grid that cannot be co-resident.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Shared memory: w_s [4*R][N] | h_s [B][N] | acc_s [4*R][B] | c_s [R][B]
size_t smem_bytes(int B, int N, int R) {
  return sizeof(float) * ((size_t)4 * R * N + (size_t)B * N +
                          (size_t)5 * R * B);
}

__global__ void __launch_bounds__(kThreads)
lstm_seq_kernel(const float* __restrict__ pre_x,   // (T, B, 4, N)
                const float* __restrict__ w_h,     // (4, N, N)
                const float* __restrict__ peep,    // (3, N)
                const float* __restrict__ bias,    // (4, N)
                const float* __restrict__ h0,      // (B, N)
                const float* __restrict__ c0,      // (B, N)
                const unsigned char* __restrict__ mask,  // (T, B)
                float* hs,                         // (T, B, N)
                float* cs,                         // (T, B, N)
                int T, int B, int N, int R) {
  extern __shared__ float smem[];
  float* w_s = smem;
  float* h_s = w_s + (size_t)4 * R * N;
  float* acc_s = h_s + (size_t)B * N;
  float* c_s = acc_s + (size_t)4 * R * B;

  cg::grid_group grid = cg::this_grid();
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int i = tid; i < 4 * R * N; i += blockDim.x) {
    const int k = i % N, gr = i / N, g = gr / R, r = gr % R, n = row0 + r;
    w_s[i] = n < N ? w_h[((size_t)g * N + n) * N + k] : 0.0f;
  }
  for (int i = tid; i < R * B; i += blockDim.x) {
    const int r = i / B, b = i % B, n = row0 + r;
    c_s[i] = n < N ? c0[(size_t)b * N + n] : 0.0f;
  }

  for (int t = 0; t < T; ++t) {
    const float* h_prev = t == 0 ? h0 : hs + (size_t)(t - 1) * B * N;
    for (int i = tid; i < B * N; i += blockDim.x) h_s[i] = __ldcg(h_prev + i);
    __syncthreads();

    for (int q = warp; q < 4 * R * B; q += n_warps) {
      const int gr = q / B, b = q % B;
      const float* w = w_s + (size_t)gr * N;
      const float* h = h_s + (size_t)b * N;
      float s = 0.0f;
      for (int k = lane; k < N; k += 32) s = fmaf(w[k], h[k], s);
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) acc_s[q] = s;
    }
    __syncthreads();

    for (int i = tid; i < R * B; i += blockDim.x) {
      const int r = i / B, b = i % B, n = row0 + r;
      if (n >= N) continue;
      const float* px = pre_x + ((size_t)t * B + b) * 4 * N;
      const float c_prev = c_s[i];
      const float a_i = px[0 * N + n] + acc_s[(0 * R + r) * B + b];
      const float a_f = px[1 * N + n] + acc_s[(1 * R + r) * B + b];
      const float a_g = px[2 * N + n] + acc_s[(2 * R + r) * B + b];
      const float a_o = px[3 * N + n] + acc_s[(3 * R + r) * B + b];
      const float ig = sigmoid_f(a_i + peep[0 * N + n] * c_prev + bias[0 * N + n]);
      const float fg = sigmoid_f(a_f + peep[1 * N + n] * c_prev + bias[1 * N + n]);
      const float gg = tanhf(a_g + bias[2 * N + n]);
      const float c_new = fg * c_prev + ig * gg;
      const float og = sigmoid_f(a_o + peep[2 * N + n] * c_new + bias[3 * N + n]);
      const float h_new = og * tanhf(c_new);
      const bool live = mask[(size_t)t * B + b] != 0;
      const float h_out = live ? h_new : h_s[(size_t)b * N + n];
      const float c_out = live ? c_new : c_prev;
      c_s[i] = c_out;
      hs[((size_t)t * B + b) * N + n] = h_out;
      cs[((size_t)t * B + b) * N + n] = c_out;
    }
    if (t + 1 < T) grid.sync();
  }
}

}  // namespace

extern "C" {

// Resident blocks per SM for this geometry (after raising the dynamic
// shared-memory limit); the wrapper multiplies by the SM count.
int lstm_seq_occupancy(int device, int B, int N, int R, int* blocks_per_sm) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes(B, N, R);
  e = cudaFuncSetAttribute(lstm_seq_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, lstm_seq_kernel, kThreads, smem);
}

int lstm_seq_launch(int device, const float* pre_x, const float* w_h,
                    const float* peep, const float* bias, const float* h0,
                    const float* c0, const unsigned char* mask, float* hs,
                    float* cs, int T, int B, int N, int R, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes(B, N, R);
  e = cudaFuncSetAttribute(lstm_seq_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  const int grid = (N + R - 1) / R;
  void* args[] = {&pre_x, &w_h, &peep, &bias, &h0, &c0, &mask,
                  &hs, &cs, &T, &B, &N, &R};
  e = cudaLaunchCooperativeKernel((const void*)lstm_seq_kernel, dim3(grid),
                                  dim3(kThreads), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
