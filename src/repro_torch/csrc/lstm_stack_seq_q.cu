// K4: fused whole-stack int8 LSTM wavefront — the Chipmunk silicon datapath
// across every layer of a chunk, masked, for sm_90a.
//
// Replaces the TPU kernel `lstm_stack_seq_kernel_q` of
// src/repro/kernels/lstm_seq/stack_kernel.py (body `_stack_kernel_q`): one
// launch runs every layer of a homogeneous int8 stack over a chunk of T
// steps, bit-identical layer by layer to chaining K3 (`lstm_seq_q.cu`).
// Diagonal d = 0 .. T+L-2 runs layer l at step t = d - l, so each layer needs
// only what the previous diagonal wrote: the layer below's h_t codes and its
// own h_{t-1} codes.
//
// The silicon's order: for each (layer, row, gate, stream), the column tiles
// — an inner layer's below-h region, then its own-h region — each give an
// exact int32 tile MAC (`__dp4a`), saturated to int16 and added serially
// with a saturation after every add.  Layer 0 has no below region: it
// resumes the chain at hop cols_h from `acc_x`, the hoisted prefix of its
// x-region hops (`core.systolic.quantized_x_prefix`, computed outside the
// kernel as the reference does).  The hop chain and the epilogue are K3's
// (`lstm_q_epilogue.cuh`).
//
// What bounds it on an H100: the grid barrier once per diagonal.  The bytes
// the function needs at CTC-3L-421H-UNI width (3.54 MB of unpadded int8
// weights, 0.86 MB of acc_x, 0.32 MB of outputs) take 1.4 us of HBM time;
// the integer MACs are spread over all SMs.
//
// Design: CTAs own (layer, row-slice) pairs, R rows each, with R the
// smallest row count that fits L * ceil(padded_h / R) CTAs on the SMs (R =
// 11 at full width, 132 CTAs).  Weights come as K2's do: `w_in` holds the
// inner layers' below-h weights and `w_h` every layer's own-h weights, each
// row (gate, n) contiguous over its inputs.  A CTA copies its 4*R rows of
// both regions (one for layer 0) into shared memory once; they stay for the
// chunk.  Per diagonal an active CTA stages the below and own h codes of
// every stream from the output slots (L1 bypassed), computes one thread per
// (gate, row, stream, column tile) partial, runs the hop chains and the
// epilogue one thread per (row, stream), and writes h_t and c_t layer-major
// into (L, T, B, padded_h).  Every CTA, active or in a fill/drain bubble,
// then meets at `this_grid().sync()`.  A bubble writes nothing, and every
// (layer, step) writes its own output slot, so no live slot can be
// clobbered.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_q_epilogue.cuh"

namespace cg = cooperative_groups;
using lstm_q::sat16;

namespace {

constexpr int kThreads = 256;

// Shared memory: part_s int32 [4*R][B][C2] | w_s int8 [4*R][K2]
//                | in_s int8 [B][K2] | lut_s int8 [2][256] | c_s int8 [R][B]
// with K2 = 2 * P_h (below-h region, then own-h region) and C2 = K2 / tile.
// Layer 0's CTAs leave the below halves of w_s and in_s unused.
size_t smem_bytes(int B, int P_h, int tile, int R) {
  const size_t K2 = 2 * (size_t)P_h, C2 = K2 / tile;
  return 16 * (size_t)R * B * C2 + 4 * (size_t)R * K2 + (size_t)B * K2 +
         512 + (size_t)R * B;
}

__global__ void __launch_bounds__(kThreads)
lstm_stack_seq_q_kernel(const int* __restrict__ acc_x,   // (T, B, P_h/t, 4, t)
                        const int8_t* __restrict__ w_in,  // (L-1, 4, P_h, P_h)
                        const int8_t* __restrict__ w_h,   // (L, 4, P_h, P_h)
                        const int8_t* __restrict__ peep,  // (L, 3, P_h)
                        const int16_t* __restrict__ bias,  // (L, 4, P_h)
                        const int8_t* __restrict__ sig_lut,   // (256,)
                        const int8_t* __restrict__ tanh_lut,  // (256,)
                        const int8_t* __restrict__ h0,   // (L, B, P_h)
                        const int8_t* __restrict__ c0,   // (L, B, P_h)
                        const unsigned char* __restrict__ mask,  // (T, B)
                        int8_t* hs,                       // (L, T, B, P_h)
                        int8_t* cs,                       // (L, T, B, P_h)
                        int T, int B, int P_h, int tile, int L, int R,
                        int cpl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K2 = 2 * P_h;
  const int C2 = K2 / tile;
  const int cols_h = C2 / 2;
  const int words = tile / 4;
  int* part_s = reinterpret_cast<int*>(smem);
  int8_t* w_s = reinterpret_cast<int8_t*>(part_s + (size_t)4 * R * B * C2);
  int8_t* in_s = w_s + (size_t)4 * R * K2;
  int8_t* lut_s = in_s + (size_t)B * K2;  // [0, 256) sigmoid, [256, 512) tanh
  int8_t* c_s = lut_s + 512;

  cg::grid_group grid = cg::this_grid();
  const int l = blockIdx.x / cpl;
  const int row0 = (blockIdx.x % cpl) * R;
  const int tid = threadIdx.x;
  const size_t mat = (size_t)4 * P_h * P_h;   // one layer's (4, P_h, P_h)
  const int8_t* peep_l = peep + (size_t)l * 3 * P_h;
  const int16_t* bias_l = bias + (size_t)l * 4 * P_h;
  const size_t plane = (size_t)B * P_h;   // one (B, P_h) code plane

  // Resident weight rows, as char4 words: w_s[(g*R + r)*K2 + k], k in the
  // below region [0, P_h) (inner layers only) or the own region [P_h, K2).
  const int h_words = P_h / 4, k2_words = K2 / 4;
  const int k4_lo = l == 0 ? h_words : 0;
  for (int i = tid; i < 4 * R * k2_words; i += blockDim.x) {
    const int k4 = i % k2_words, gr = i / k2_words;
    if (k4 < k4_lo) continue;
    const int g = gr / R, r = gr % R, n = row0 + r;
    const int8_t* row = k4 < h_words
        ? w_in + (l - 1) * mat + ((size_t)g * P_h + n) * P_h
        : w_h + l * mat + ((size_t)g * P_h + n) * P_h;
    reinterpret_cast<int*>(w_s)[i] =
        n < P_h ? reinterpret_cast<const int*>(row)[k4 % h_words] : 0;
  }
  for (int i = tid; i < 256; i += blockDim.x) {
    lut_s[i] = sig_lut[i];
    lut_s[256 + i] = tanh_lut[i];
  }
  for (int i = tid; i < R * B; i += blockDim.x) {
    const int r = i / B, b = i % B, n = row0 + r;
    c_s[i] = n < P_h ? c0[l * plane + (size_t)b * P_h + n] : 0;
  }

  const int c_lo = l == 0 ? cols_h : 0;   // layer 0: own-h hops only
  const int nc = C2 - c_lo;
  int* in_w = reinterpret_cast<int*>(in_s);
  const int D = T + L - 1;
  for (int d = 0; d < D; ++d) {
    const int t = d - l;
    if (t >= 0 && t < T) {                 // uniform over the CTA
      const int* h_own = reinterpret_cast<const int*>(
          t == 0 ? h0 + l * plane : hs + ((size_t)l * T + (t - 1)) * plane);
      const int* h_below = l > 0 ? reinterpret_cast<const int*>(
          hs + ((size_t)(l - 1) * T + t) * plane) : nullptr;
      for (int i = tid; i < B * k2_words; i += blockDim.x) {
        const int b = i / k2_words, k4 = i % k2_words;
        if (k4 >= h_words)
          in_w[i] = __ldcg(h_own + b * h_words + (k4 - h_words));
        else if (l > 0)
          in_w[i] = __ldcg(h_below + b * h_words + k4);
      }
      __syncthreads();

      for (int q = tid; q < 4 * R * B * nc; q += blockDim.x) {
        const int cc = q % nc, rest = q / nc, b = rest % B, gr = rest / B;
        const int c = c_lo + cc;
        const int* wp = reinterpret_cast<const int*>(w_s + (size_t)gr * K2 +
                                                     c * tile);
        const int* xp = reinterpret_cast<const int*>(in_s + (size_t)b * K2 +
                                                     c * tile);
        int s = 0;
        for (int j = 0; j < words; ++j) s = __dp4a(wp[j], xp[j], s);
        part_s[q] = sat16(s);
      }
      __syncthreads();

      for (int i = tid; i < R * B; i += blockDim.x) {
        const int r = i / B, b = i % B, n = row0 + r;
        if (n >= P_h) continue;
        int acc[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int a0 = l == 0
              ? acc_x[((((size_t)t * B + b) * (P_h / tile) + n / tile) * 4 +
                       g) * tile + n % tile]
              : 0;
          acc[g] = lstm_q::saturating_hops(
              a0, part_s + ((size_t)(g * R + r) * B + b) * nc, nc);
        }
        const lstm_q::Codes q = lstm_q::state_update(
            acc, c_s[i], in_s[(size_t)b * K2 + P_h + n],
            mask[(size_t)t * B + b] != 0, bias_l, peep_l, P_h, n, lut_s);
        c_s[i] = q.c;
        const size_t o = ((size_t)l * T + t) * plane + (size_t)b * P_h + n;
        hs[o] = q.h;
        cs[o] = q.c;
      }
    }
    if (d + 1 < D) grid.sync();
  }
}

}  // namespace

extern "C" {

int lstm_stack_seq_q_occupancy(int device, int B, int P_h, int tile, int L,
                               int R, int* blocks_per_sm) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  (void)L;
  const size_t smem = smem_bytes(B, P_h, tile, R);
  e = cudaFuncSetAttribute(lstm_stack_seq_q_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, lstm_stack_seq_q_kernel, kThreads, smem);
}

int lstm_stack_seq_q_launch(int device, const int* acc_x,
                            const int8_t* w_in, const int8_t* w_h,
                            const int8_t* peep, const int16_t* bias,
                            const int8_t* sig_lut, const int8_t* tanh_lut,
                            const int8_t* h0, const int8_t* c0,
                            const unsigned char* mask, int8_t* hs,
                            int8_t* cs, int T, int B, int P_h, int tile,
                            int L, int R, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes(B, P_h, tile, R);
  e = cudaFuncSetAttribute(lstm_stack_seq_q_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  int cpl = (P_h + R - 1) / R;             // CTAs per layer
  void* args[] = {&acc_x, &w_in, &w_h, &peep, &bias, &sig_lut, &tanh_lut,
                  &h0, &c0, &mask, &hs, &cs, &T, &B, &P_h, &tile, &L, &R,
                  &cpl};
  e = cudaLaunchCooperativeKernel((const void*)lstm_stack_seq_q_kernel,
                                  dim3(L * cpl), dim3(kThreads), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
