// K1: persistent whole-chunk f32 peephole LSTM layer, masked, for sm_90a.
//
// Replaces the TPU kernel `lstm_seq` of src/repro/kernels/lstm_seq/kernel.py
// (body `_seq_kernel`): one launch covers T steps of one layer for B streams,
// the recurrent weights stay on chip for the whole chunk, and a masked step
// re-emits the carried h and keeps c.
//
// What bounds it on an H100: neither bytes nor FLOPs (bound 1.5 us at the
// serving shape, N_h = 421, B = 8, T = 16) but the chain of T step
// latencies: each step needs every row of h_{t-1}.  Measured (clock
// stamps, ~7k cycles a step): the exchange (the release, the slowest CTA,
// the acquire) ~2.6k, staging ~1.0k, the dot ~2.0k, the epilogue ~1.4k.
//
// Design (`lstm_exchange.cuh`): CTAs split the N_h hidden rows, R rows each
// (R = ceil(N_h / SMs): 106 CTAs of 4 rows), all four gates of a row in one
// CTA, so the peephole epilogue is local.  Warp 0 is the producer, warps
// 1.. the dot warps (R * splits, 8 here).  The prologue requests the CTA's
// weight rows k-major ([R][N][4]), h0 k-major, peep, bias and c0; they stay
// on chip for the chunk.  Per step t:
//   - the step's pre_x rows and mask row are requested first (the kernel
//     never writes them);
//   - the producer waits until every CTA has counted step t - 1 on the
//     layer's counter and stages h_{t-1} (`xs[t-1]`, k-major) with one bulk
//     copy: no grid barrier;
//   - the dot warps' register-blocked dot (4 gates x 8 streams a lane) and,
//     after one barrier, the epilogue (`lstm_f32_epilogue.cuh`, shared with
//     K2 and K5, in the reference's `_cell_body` order) read only shared
//     memory and registers; the mask select re-emits the staged h;
//   - h_t and c_t go to `hs[t]`, `cs[t]` and h_t to `xs[t]`, then, after a
//     barrier, the CTA counts the step.
// Clock stamps (-DCLOCK_STAMPS) time, for the producer, the prologue, the
// wait, the staging, the dot and the epilogue.
#include <cuda_runtime.h>

#include "clock_stamps.cuh"
#include "lstm_exchange.cuh"
#include "lstm_f32_epilogue.cuh"

namespace {

using namespace lstm_exchange;

// xs: h_t k-major, (T, chunks, N, 8), what the next step stages;
// counters: the layer's progress counter, then `done`
__global__ void __launch_bounds__(32 * (kMaxDotWarps + 1))
lstm_seq_kernel(const float* __restrict__ pre_x,   // (T, B, 4, N)
                const float* __restrict__ w_h,     // (4, N, N)
                const float* __restrict__ peep,    // (3, N)
                const float* __restrict__ bias,    // (4, N)
                const float* __restrict__ h0,      // (B, N)
                const float* __restrict__ c0,      // (B, N)
                const unsigned char* __restrict__ mask,  // (T, B)
                float* hs,                         // (T, B, N)
                float* cs,                         // (T, B, N)
                float* xs, unsigned* counters, int T, int B, int N, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(B, N, R, 1);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // the h plane
  float* w_s = reinterpret_cast<float*>(smem + L.w);         // [R][N][4]
  float* plane = reinterpret_cast<float*>(smem + L.planes);  // [c][N][8]
  float* sums = reinterpret_cast<float*>(smem + L.part);
  float* const_s = reinterpret_cast<float*>(smem + L.consts);  // [R][8]
  float* c_s = reinterpret_cast<float*>(smem + L.c);           // [R][B]
  float* pre_s = reinterpret_cast<float*>(smem + L.pre);       // [R][4][B]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, N - row0);
  const size_t xs_n = L.plane / 4;   // floats of one xs plane
  Clock clk;

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  // the weights (row r, gate g = q / 4, q % 4) and h0, k-major; peep,
  // bias and c0
  request_k_major(
      [&](int q) { return w_h + ((size_t)(q & 3) * N + row0 + (q >> 2)) * N; },
      [&](int q) { return w_s + (size_t)(q >> 2) * N * 4 + (q & 3); },
      4 * rows, N, 4, warp, nwarps, lane);
  request_k_major([&](int b) { return h0 + (size_t)b * N; },
                  [&](int b) { return plane + plane_at(N, b, 0); }, B, N,
                  kChunk, warp, nwarps, lane);
#pragma unroll 1
  for (int i = tid; i < rows * 8; i += nthreads) {
    const int r = i >> 3, g = i & 7;
    if (g < 7)
      cp_async_4(const_s + i, g < 3 ? peep + (size_t)g * N + row0 + r
                                    : bias + (size_t)(g - 3) * N + row0 + r);
  }
#pragma unroll 1
  for (int i = tid; i < rows * B; i += nthreads)
    cp_async_4(c_s + i, c0 + (size_t)(i % B) * N + row0 + i / B);
  cp_async_wait_all();
  clk.sync_lap(0);   // a barrier: the prologue's requests are in

#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    // what the kernel never writes, requested before the wait
#pragma unroll 1
    for (int i = tid; i < rows * 4 * B; i += nthreads) {
      const int r = i / (4 * B), gb = i % (4 * B), g = gb / B, b = gb % B;
      cp_async_4(pre_s + i, pre_x + (((size_t)t * B + b) * 4 + g) * N +
                                row0 + r);
    }
    const unsigned char* mask_s = request_bytes(
        smem + L.mask, mask + (size_t)t * B, B, tid, nthreads);
    if (warp == 0) {   // the producer: h_{t-1} once every CTA counted it
      if (lane == 0 && t > 0) {
        const long long since = clock64();
        while (load_acquire(counters) < (unsigned)(t * gridDim.x))
          spin_guard(since);
        async_proxy_fence();
        clk.lap(1);
        bulk_load(plane, xs + (t - 1) * xs_n, (uint32_t)L.plane, bar);
      }
      if (t > 0) mbar_wait(bar, (t - 1) & 1);
      clk.lap(2);
    } else {
      if (t > 0) mbar_wait(bar, (t - 1) & 1);
      family_sums(sums, w_s, plane, N, B, R, rows, L, warp - 1, lane);
    }
    cp_async_wait_all();
    clk.sync_lap(3);   // a barrier: the sums, pre_x rows and mask are in

#pragma unroll 1
    for (int i = tid; i < rows * B; i += nthreads) {
      const int r = i / B, b = i % B, n = row0 + r;
      float a[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        a[g] = pre_s[(r * 4 + g) * B + b] + gate_sum(sums, L, R, r, b, g);
      const float c_prev = c_s[i];
      const float* cr = const_s + r * 8;
      const lstm_f32::State st =
          lstm_f32::cell_update(a, c_prev, cr, cr + 3, 1, 0);
      const bool live = mask_s[b] != 0;
      const float h_out = live ? st.h : plane[plane_at(N, b, n)];
      const float c_out = live ? st.c : c_prev;
      c_s[i] = c_out;
      const size_t o = ((size_t)t * B + b) * N + n;
      hs[o] = h_out;
      cs[o] = c_out;
      xs[t * xs_n + plane_at(N, b, n)] = h_out;
    }
    // a barrier: every h_t row of this CTA is written; the sums and the
    // staged plane are free
    clk.sync_lap(4);
    if (tid == 0 && t + 1 < T) publish(counters);
  }
  if (tid == 0) finish(counters, 1, gridDim.x);
  clk.save(T);
}

int set_smem(size_t smem) {
  return cudaFuncSetAttribute(lstm_seq_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" {

// Resident blocks per SM for this geometry (after raising the dynamic
// shared-memory limit); the wrapper multiplies by the SM count.
int lstm_seq_occupancy(int device, int B, int N, int R, int* blocks_per_sm) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const Layout L = layout(B, N, R, 1);
  e = (cudaError_t)set_smem(L.total);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, lstm_seq_kernel, 32 * (L.dot_warps + 1), L.total);
}

// counters: zero, (1 + 1) * kCounterStride words, used by no concurrent
// launch (the wrapper keeps one buffer per device and stream).
// xs: scratch of T * ceil(B / 8) * N * 8 floats, 16-byte aligned.
int lstm_seq_launch(int device, const float* pre_x, const float* w_h,
                    const float* peep, const float* bias, const float* h0,
                    const float* c0, const unsigned char* mask, float* hs,
                    float* cs, float* xs, unsigned* counters, int T, int B,
                    int N, int R, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const Layout L = layout(B, N, R, 1);
  e = (cudaError_t)set_smem(L.total);
  if (e != cudaSuccess) return e;
  const int grid = (N + R - 1) / R;
  void* args[] = {&pre_x, &w_h, &peep, &bias, &h0, &c0, &mask,
                  &hs, &cs, &xs, &counters, &T, &B, &N, &R};
  e = cudaLaunchCooperativeKernel((const void*)lstm_seq_kernel, dim3(grid),
                                  dim3(32 * (L.dot_warps + 1)), args,
                                  L.total,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

#ifdef CLOCK_STAMPS
int lstm_seq_clock_stamps(void* host, int n_ctas) {
  return copy_stamps(host, n_ctas);
}
#endif

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
