// K2: fused whole-stack f32 peephole LSTM wavefront, masked, for sm_90a.
//
// Replaces the TPU kernel `lstm_stack_seq_kernel` of
// src/repro/kernels/lstm_seq/stack_kernel.py (body `_stack_kernel`): one
// launch runs every layer of a homogeneous stack over a chunk of T steps.
// Diagonal d = 0 .. T+L-2 runs layer l at step t = d - l, so each layer
// needs only what the previous diagonal wrote (its own h_{t-1} and the layer
// below's h_t), and the hidden sequences never leave the kernel between
// layers.
//
// What bounds it on an H100: the grid barrier once per diagonal.  The whole
// stack's weights (W_h of every layer, W_in of the inner ones: 4*421^2*5*4 B
// = 14.2 MB at full width) are read once per launch, 4.2 us of HBM time; the
// arithmetic (about 36 MFLOP per diagonal at B = 8) is spread over all SMs.
//
// Design: CTAs own (layer, row-slice) pairs, R rows each, with R the smallest
// row count that fits L * ceil(N_h / R) CTAs on the SMs (R = 10 at full
// width, 129 CTAs).  A CTA's W_h rows and, for an inner layer, its W_in rows
// (4*R rows each) are loaded into shared memory once, ~135 KB, and stay for
// the chunk: the paper's weight-stationary engine grid with SMs as engines.
// Per diagonal an active CTA stages its layer's h_{t-1} and the layer
// below's h_t from global memory (L1 bypassed), computes one warp per
// (gate, row, stream) dot over both weight families with a fixed butterfly
// reduction (no atomics: the same inputs give the same bits), runs the
// peephole epilogue in the reference's order with the mask select, and
// writes h_t and c_t layer-major into (L, T, B, N_h).  Every CTA, active or
// in a fill/drain bubble, then meets at `this_grid().sync()`.  A bubble
// writes nothing, and every (layer, step) writes its own output slot, so no
// parity buffer can be clobbered.  Layer 0 adds the hoisted W_x x_t
// (`pre_x`) and has no below-layer product.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Shared memory: wh_s [4*R][N] | wi_s [4*R][N] | ho_s [B][N] | hb_s [B][N]
//                | acc_s [4*R][B] | c_s [R][B]
size_t smem_bytes(int B, int N, int R) {
  return sizeof(float) * ((size_t)8 * R * N + (size_t)2 * B * N +
                          (size_t)5 * R * B);
}

__global__ void __launch_bounds__(kThreads)
lstm_stack_seq_kernel(const float* __restrict__ pre_x,  // (T, B, 4, N)
                      const float* __restrict__ w_in,   // (L-1, 4, N, N)
                      const float* __restrict__ w_h,    // (L, 4, N, N)
                      const float* __restrict__ peep,   // (L, 3, N)
                      const float* __restrict__ bias,   // (L, 4, N)
                      const float* __restrict__ h0,     // (L, B, N)
                      const float* __restrict__ c0,     // (L, B, N)
                      const unsigned char* __restrict__ mask,  // (T, B)
                      float* hs,                        // (L, T, B, N)
                      float* cs,                        // (L, T, B, N)
                      int T, int B, int N, int L, int R, int cpl) {
  extern __shared__ float smem[];
  float* wh_s = smem;
  float* wi_s = wh_s + (size_t)4 * R * N;
  float* ho_s = wi_s + (size_t)4 * R * N;
  float* hb_s = ho_s + (size_t)B * N;
  float* acc_s = hb_s + (size_t)B * N;
  float* c_s = acc_s + (size_t)4 * R * B;

  cg::grid_group grid = cg::this_grid();
  const int l = blockIdx.x / cpl;
  const int row0 = (blockIdx.x % cpl) * R;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const size_t layer_w = (size_t)4 * N * N;
  const float* wh_l = w_h + (size_t)l * layer_w;
  const float* wi_l = l > 0 ? w_in + (size_t)(l - 1) * layer_w : nullptr;
  const float* peep_l = peep + (size_t)l * 3 * N;
  const float* bias_l = bias + (size_t)l * 4 * N;
  const size_t step = (size_t)B * N;      // one (B, N) plane

  for (int i = tid; i < 4 * R * N; i += blockDim.x) {
    const int k = i % N, gr = i / N, g = gr / R, r = gr % R, n = row0 + r;
    const size_t src = ((size_t)g * N + n) * N + k;
    wh_s[i] = n < N ? wh_l[src] : 0.0f;
    wi_s[i] = (n < N && l > 0) ? wi_l[src] : 0.0f;
  }
  for (int i = tid; i < R * B; i += blockDim.x) {
    const int r = i / B, b = i % B, n = row0 + r;
    c_s[i] = n < N ? c0[l * step + (size_t)b * N + n] : 0.0f;
  }

  const int D = T + L - 1;
  for (int d = 0; d < D; ++d) {
    const int t = d - l;
    if (t >= 0 && t < T) {                 // uniform over the CTA
      const float* h_own = t == 0 ? h0 + l * step
                                  : hs + ((size_t)l * T + (t - 1)) * step;
      for (int i = tid; i < B * N; i += blockDim.x)
        ho_s[i] = __ldcg(h_own + i);
      if (l > 0) {
        const float* h_below = hs + ((size_t)(l - 1) * T + t) * step;
        for (int i = tid; i < B * N; i += blockDim.x)
          hb_s[i] = __ldcg(h_below + i);
      }
      __syncthreads();

      for (int q = warp; q < 4 * R * B; q += n_warps) {
        const int gr = q / B, b = q % B;
        const float* wo = wh_s + (size_t)gr * N;
        const float* ho = ho_s + (size_t)b * N;
        float s = 0.0f;
        if (l > 0) {
          const float* wi = wi_s + (size_t)gr * N;
          const float* hb = hb_s + (size_t)b * N;
          for (int k = lane; k < N; k += 32)
            s = fmaf(wi[k], hb[k], fmaf(wo[k], ho[k], s));
        } else {
          for (int k = lane; k < N; k += 32) s = fmaf(wo[k], ho[k], s);
        }
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) acc_s[q] = s;
      }
      __syncthreads();

      for (int i = tid; i < R * B; i += blockDim.x) {
        const int r = i / B, b = i % B, n = row0 + r;
        if (n >= N) continue;
        float a_i = acc_s[(0 * R + r) * B + b];
        float a_f = acc_s[(1 * R + r) * B + b];
        float a_g = acc_s[(2 * R + r) * B + b];
        float a_o = acc_s[(3 * R + r) * B + b];
        if (l == 0) {
          const float* px = pre_x + ((size_t)t * B + b) * 4 * N;
          a_i = px[0 * N + n] + a_i;
          a_f = px[1 * N + n] + a_f;
          a_g = px[2 * N + n] + a_g;
          a_o = px[3 * N + n] + a_o;
        }
        const float c_prev = c_s[i];
        const float ig = sigmoid_f(a_i + peep_l[0 * N + n] * c_prev + bias_l[0 * N + n]);
        const float fg = sigmoid_f(a_f + peep_l[1 * N + n] * c_prev + bias_l[1 * N + n]);
        const float gg = tanhf(a_g + bias_l[2 * N + n]);
        const float c_new = fg * c_prev + ig * gg;
        const float og = sigmoid_f(a_o + peep_l[2 * N + n] * c_new + bias_l[3 * N + n]);
        const float h_new = og * tanhf(c_new);
        const bool live = mask[(size_t)t * B + b] != 0;
        const float h_out = live ? h_new : ho_s[(size_t)b * N + n];
        const float c_out = live ? c_new : c_prev;
        c_s[i] = c_out;
        const size_t o = ((size_t)l * T + t) * step + (size_t)b * N + n;
        hs[o] = h_out;
        cs[o] = c_out;
      }
    }
    if (d + 1 < D) grid.sync();
  }
}

}  // namespace

extern "C" {

int lstm_stack_seq_occupancy(int device, int B, int N, int R,
                             int* blocks_per_sm) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes(B, N, R);
  e = cudaFuncSetAttribute(lstm_stack_seq_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, lstm_stack_seq_kernel, kThreads, smem);
}

int lstm_stack_seq_launch(int device, const float* pre_x, const float* w_in,
                          const float* w_h, const float* peep,
                          const float* bias, const float* h0,
                          const float* c0, const unsigned char* mask,
                          float* hs, float* cs, int T, int B, int N, int L,
                          int R, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes(B, N, R);
  e = cudaFuncSetAttribute(lstm_stack_seq_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  int cpl = (N + R - 1) / R;               // CTAs per layer
  void* args[] = {&pre_x, &w_in, &w_h, &peep, &bias, &h0, &c0, &mask,
                  &hs, &cs, &T, &B, &N, &L, &R, &cpl};
  e = cudaLaunchCooperativeKernel((const void*)lstm_stack_seq_kernel,
                                  dim3(L * cpl), dim3(kThreads), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
