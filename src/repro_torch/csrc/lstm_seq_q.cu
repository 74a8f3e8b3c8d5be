// K3: persistent whole-chunk int8 LSTM layer — the Chipmunk silicon datapath,
// masked, for sm_90a.
//
// Replaces the TPU kernel `lstm_seq_quantized` of
// src/repro/kernels/lstm_seq/kernel.py (body `_seq_kernel_q`): one launch
// runs T recurrent steps of one layer in integer arithmetic, bit-identical to
// scanning `systolic_cell_quantized` (src/repro_torch/core/systolic.py).
//
// The silicon's order, which every result depends on: for each output row n,
// gate g and stream b, column tile c gives an exact int32 tile MAC
// (`__dp4a` over char4 words), saturated to int16; the partials are added to
// the accumulator serially over c (x-region tiles first, then h-region
// tiles) with a saturation after every add.  Then the integer epilogue of
// `_quantized_state_update`, operation for operation
// (`lstm_q_epilogue.cuh`).
//
// What bounds it on an H100: the grid barrier once per step.  The bytes
// the function needs (0.92 MB of unpadded int8 weights for layer 0 at
// CTC-3L-421H-UNI width, read once per launch, plus 0.13 MB of codes) take
// 0.31 us of HBM time, and the integer MACs are ~1 us of work spread over
// 120 SMs.
//
// Design: CTAs split the padded_h output rows, R rows each (R = 4 at full
// width, 120 CTAs).  Splitting rows is free: each row owns its own hop
// chain.  A CTA's 4*R weight rows over all column tiles (15 KB at R = 4) are
// loaded into shared memory once and stay for the chunk.  Per step a CTA
// stages the packed [x_t | h_{t-1}] codes of every stream (h_{t-1} read
// from the previous step's output slot with L1 bypassed), computes one
// thread per (gate, row, stream, column tile) partial, then one thread per
// (row, stream) runs the four hop chains and the epilogue with both LUTs in
// shared memory, applies the mask select, writes h_t and c_t, and every CTA
// meets at `this_grid().sync()`.  The hop chain and the epilogue come from
// `lstm_q_epilogue.cuh`, which K4 shares.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_q_epilogue.cuh"

namespace cg = cooperative_groups;
using lstm_q::sat16;

namespace {

constexpr int kThreads = 256;

// Shared memory: part_s int32 [4*R][B][C] | w_s int8 [4*R][P_in]
//                | in_s int8 [B][P_in] | lut_s int8 [2][256] | c_s int8 [R][B]
size_t smem_bytes(int B, int P_x, int P_h, int tile, int R) {
  const size_t P_in = (size_t)P_x + P_h, C = P_in / tile;
  return 16 * (size_t)R * B * C + 4 * (size_t)R * P_in + (size_t)B * P_in +
         512 + (size_t)R * B;
}

__global__ void __launch_bounds__(kThreads)
lstm_seq_q_kernel(const int8_t* __restrict__ xs,      // (T, B, P_x)
                  const int8_t* __restrict__ w,       // (4, P_h, P_in)
                  const int8_t* __restrict__ peep,    // (3, P_h)
                  const int16_t* __restrict__ bias,   // (4, P_h)
                  const int8_t* __restrict__ sig_lut,   // (256,)
                  const int8_t* __restrict__ tanh_lut,  // (256,)
                  const int8_t* __restrict__ h0,      // (B, P_h)
                  const int8_t* __restrict__ c0,      // (B, P_h)
                  const unsigned char* __restrict__ mask,  // (T, B)
                  int8_t* hs,                          // (T, B, P_h)
                  int8_t* cs,                          // (T, B, P_h)
                  int T, int B, int P_x, int P_h, int tile, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P_in = P_x + P_h;
  const int C = P_in / tile;
  const int words = tile / 4;               // char4 words per tile segment
  int* part_s = reinterpret_cast<int*>(smem);
  int8_t* w_s = reinterpret_cast<int8_t*>(part_s + (size_t)4 * R * B * C);
  int8_t* in_s = w_s + (size_t)4 * R * P_in;
  int8_t* lut_s = in_s + (size_t)B * P_in;  // [0, 256) sigmoid, [256, 512) tanh
  int8_t* c_s = lut_s + 512;

  cg::grid_group grid = cg::this_grid();
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x;

  // Resident weight rows, as char4 words: w_s[(g*R + r)*P_in + k].
  const int row_words = P_in / 4;
  for (int i = tid; i < 4 * R * row_words; i += blockDim.x) {
    const int k4 = i % row_words, gr = i / row_words;
    const int g = gr / R, r = gr % R, n = row0 + r;
    reinterpret_cast<int*>(w_s)[i] =
        n < P_h ? reinterpret_cast<const int*>(
                      w + ((size_t)g * P_h + n) * P_in)[k4]
                : 0;
  }
  for (int i = tid; i < 256; i += blockDim.x) {
    lut_s[i] = sig_lut[i];
    lut_s[256 + i] = tanh_lut[i];
  }
  for (int i = tid; i < R * B; i += blockDim.x) {
    const int r = i / B, b = i % B, n = row0 + r;
    c_s[i] = n < P_h ? c0[(size_t)b * P_h + n] : 0;
  }

  const int x_words = P_x / 4, h_words = P_h / 4, in_words = P_in / 4;
  int* in_w = reinterpret_cast<int*>(in_s);
  for (int t = 0; t < T; ++t) {
    // Stage [x_t | h_{t-1}] for every stream; h_{t-1} is the previous
    // step's output slot, written by other CTAs (read past L1).
    const int* x_t = reinterpret_cast<const int*>(xs + (size_t)t * B * P_x);
    const int* h_prev = reinterpret_cast<const int*>(
        t == 0 ? h0 : hs + (size_t)(t - 1) * B * P_h);
    for (int i = tid; i < B * in_words; i += blockDim.x) {
      const int b = i / in_words, k4 = i % in_words;
      in_w[i] = k4 < x_words ? x_t[b * x_words + k4]
                             : __ldcg(h_prev + b * h_words + (k4 - x_words));
    }
    __syncthreads();

    // Exact tile MACs, each saturated to the int16 an engine hands on.
    for (int q = tid; q < 4 * R * B * C; q += blockDim.x) {
      const int c = q % C, rest = q / C, b = rest % B, gr = rest / B;
      const int* wp = reinterpret_cast<const int*>(w_s + (size_t)gr * P_in +
                                                   c * tile);
      const int* xp = reinterpret_cast<const int*>(in_s + (size_t)b * P_in +
                                                   c * tile);
      int s = 0;
      for (int j = 0; j < words; ++j) s = __dp4a(wp[j], xp[j], s);
      part_s[q] = sat16(s);
    }
    __syncthreads();

    // Serial saturating hops over the column tiles, then the epilogue.
    for (int i = tid; i < R * B; i += blockDim.x) {
      const int r = i / B, b = i % B, n = row0 + r;
      if (n >= P_h) continue;
      int acc[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        acc[g] = lstm_q::saturating_hops(
            0, part_s + ((size_t)(g * R + r) * B + b) * C, C);
      const lstm_q::Codes q = lstm_q::state_update(
          acc, c_s[i], in_s[(size_t)b * P_in + P_x + n],
          mask[(size_t)t * B + b] != 0, bias, peep, P_h, n, lut_s);
      c_s[i] = q.c;
      const size_t o = ((size_t)t * B + b) * P_h + n;
      hs[o] = q.h;
      cs[o] = q.c;
    }
    if (t + 1 < T) grid.sync();
  }
}

}  // namespace

extern "C" {

int lstm_seq_q_occupancy(int device, int B, int P_x, int P_h, int tile, int R,
                         int* blocks_per_sm) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes(B, P_x, P_h, tile, R);
  e = cudaFuncSetAttribute(lstm_seq_q_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, lstm_seq_q_kernel, kThreads, smem);
}

int lstm_seq_q_launch(int device, const int8_t* xs, const int8_t* w,
                      const int8_t* peep, const int16_t* bias,
                      const int8_t* sig_lut, const int8_t* tanh_lut,
                      const int8_t* h0, const int8_t* c0,
                      const unsigned char* mask, int8_t* hs, int8_t* cs,
                      int T, int B, int P_x, int P_h, int tile, int R,
                      void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes(B, P_x, P_h, tile, R);
  e = cudaFuncSetAttribute(lstm_seq_q_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  const int ctas = (P_h + R - 1) / R;
  void* args[] = {&xs, &w, &peep, &bias, &sig_lut, &tanh_lut, &h0, &c0,
                  &mask, &hs, &cs, &T, &B, &P_x, &P_h, &tile, &R};
  e = cudaLaunchCooperativeKernel((const void*)lstm_seq_q_kernel, dim3(ctas),
                                  dim3(kThreads), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
