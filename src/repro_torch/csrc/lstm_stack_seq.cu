// K2: fused whole-stack f32 peephole LSTM wavefront, masked, for sm_90a.
//
// Replaces the TPU kernel `lstm_stack_seq_kernel` of
// src/repro/kernels/lstm_seq/stack_kernel.py (body `_stack_kernel`): one
// launch runs every layer of a homogeneous stack over a chunk of T steps.
// Layer l at step t needs only its own h_{t-1} and the layer below's h_t, so
// the hidden sequences never leave the kernel between layers.
//
// What bounds it on an H100: neither bytes nor FLOPs (bound 7.5 us at the
// serving shape, N_h = 421, B = 8, T = 16, L = 3: 14.2 MB of weights, 36
// MFLOP a step of all layers) but the chain of step latencies, T + L - 1
// at most.  Measured (clock stamps, ~11k cycles a step of an inner layer):
// the dot over both weight families ~5k (the part not hidden under the
// wait), the exchange ~3.7k, the epilogue ~1.4k, staging ~0.5k.
//
// Design (`lstm_exchange.cuh`): CTAs own (layer, row-slice) pairs, R rows
// each, with R the smallest row count that fits L * ceil(N_h / R) CTAs on
// the SMs (R = 10 at full width, 129 CTAs: the paper's weight-stationary
// engine grid with SMs as engines).  Warp 0 is the producer, warps 1.. the
// dot warps (10 here).  The prologue requests a CTA's W_h rows and, for an
// inner layer, its W_in rows k-major (~135 KB), h0, peep, bias and c0; they
// stay for the chunk.  Layers run as a dataflow pipeline, with no grid
// barrier: at step t the producer waits only for its own layer's counter
// to show step t - 1 done by every CTA of the layer, and for the layer
// below's to show step t, staging each plane (`xs[l][t-1]`; `xs[l-1][t]`)
// by one bulk copy as soon as it is ready.  The dot warps sum W_in h_below
// as soon as that plane lands, while h_{t-1} may still be on its way, then
// W_h h_own; layer 0 adds the hoisted W_x x_t (`pre_x`) instead.  A CTA
// runs its layer's T steps and leaves: none waits in a fill or drain
// bubble.  The epilogue (`lstm_f32_epilogue.cuh`, shared with K1 and K5,
// with the mask select) reads only shared memory and registers; h_t and c_t
// go layer-major into (L, T, B, N_h), h_t also k-major into `xs[l][t]`.
// Every (layer, step) writes its own slots, so a layer running ahead
// clobbers nothing.  Clock stamps (-DCLOCK_STAMPS) time, for the producer,
// the prologue, the waits, the staging, the dot and the epilogue.
//
// Layer groups (the reference's layer-block factor `lb`): a launch runs
// layers l0 .. l0 + lb - 1 only, its CTAs the (layer, row-slice) pairs of
// those layers, R rows each from the lb-layer geometry; L / lb launches on
// one stream run the stack.  The exchange planes `xs` span every layer
// and outlive the launches of a chunk: a group's bottom layer l0 > 0
// stages the planes of layer l0 - 1, which an earlier launch finished, as
// soon as it reaches each step (no counter to wait on), and sums W_in
// h_below as any inner layer does; only layer 0 reads `pre_x`.  Every
// group sums with its stack's K splits (`S`, not its own rows'), so each
// lb gives the bits of one launch over the stack.  Fewer layers a launch
// take fewer rows a CTA: less shared memory, larger batch blocks, and
// stacks that do not fit whole.
#include <cuda_runtime.h>

#include "clock_stamps.cuh"
#include "lstm_exchange.cuh"
#include "lstm_f32_epilogue.cuh"

namespace {

using namespace lstm_exchange;

// xs: h_t k-major, (L, T, chunks, N, 8), what the next steps stage;
// counters: one progress counter per layer of the group, then `done`
__global__ void __launch_bounds__(32 * (kMaxDotWarps + 1))
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
                      float* xs, unsigned* counters, int T, int B, int N,
                      int l0, int R, int S, int cpl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout Ly = layout(B, N, R, 2, S);
  // [0] own plane, [1] below plane
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* w_s = reinterpret_cast<float*>(smem + Ly.w);  // [W_h, W_in][R][N][4]
  float* own = reinterpret_cast<float*>(smem + Ly.planes);   // [c][N][8]
  float* below =
      reinterpret_cast<float*>(smem + Ly.planes + Ly.plane_stride);
  float* sums_h = reinterpret_cast<float*>(smem + Ly.part);
  float* sums_in = reinterpret_cast<float*>(smem + Ly.part + Ly.sums);
  float* const_s = reinterpret_cast<float*>(smem + Ly.consts);  // [R][8]
  float* c_s = reinterpret_cast<float*>(smem + Ly.c);           // [R][B]
  float* pre_s = reinterpret_cast<float*>(smem + Ly.pre);       // [R][4][B]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int lb = gridDim.x / cpl, ll = blockIdx.x / cpl;  // layer in group
  const int l = l0 + ll;
  const int row0 = (blockIdx.x % cpl) * R;
  const int rows = min(R, N - row0);
  const bool inner = l > 0;
  // the group's bottom layer reads planes an earlier launch finished
  const bool below_done = inner && ll == 0;
  const size_t plane_n = (size_t)B * N, layer_w = (size_t)4 * N * N;
  const size_t xs_n = Ly.plane / 4;   // floats of one xs plane
  const float* xs_own = xs + (size_t)l * T * xs_n;
  // layer 0 reads no plane below (its pointers are never dereferenced)
  const float* xs_below = inner ? xs_own - (size_t)T * xs_n : xs;
  unsigned* p_own = counters + (size_t)ll * kCounterStride;
  const unsigned* p_below = ll > 0 ? p_own - kCounterStride : p_own;
  Clock clk;

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    mbar_init_fence();
  }
  // the weights (family f = q / (4 rows): W_h, W_in; row r, gate g of
  // q % (4 rows) = 4 r + g) and h0, k-major; peep, bias and c0
  auto w_base = [&](int f) {
    return f == 0 ? w_h + (size_t)l * layer_w
                  : w_in + (size_t)(l - 1) * layer_w;
  };
  request_k_major(
      [&](int q) {
        const int f = q / (4 * rows), rg = q % (4 * rows);
        return w_base(f) + ((size_t)(rg & 3) * N + row0 + (rg >> 2)) * N;
      },
      [&](int q) {
        const int f = q / (4 * rows), rg = q % (4 * rows);
        return w_s + ((size_t)f * R + (rg >> 2)) * N * 4 + (rg & 3);
      },
      (inner ? 8 : 4) * rows, N, 4, warp, nwarps, lane);
  request_k_major([&](int b) { return h0 + l * plane_n + (size_t)b * N; },
                  [&](int b) { return own + plane_at(N, b, 0); }, B, N,
                  kChunk, warp, nwarps, lane);
  const float* peep_l = peep + (size_t)l * 3 * N;
  const float* bias_l = bias + (size_t)l * 4 * N;
#pragma unroll 1
  for (int i = tid; i < rows * 8; i += nthreads) {
    const int r = i >> 3, g = i & 7;
    if (g < 7)
      cp_async_4(const_s + i, g < 3 ? peep_l + (size_t)g * N + row0 + r
                                    : bias_l + (size_t)(g - 3) * N + row0 + r);
  }
#pragma unroll 1
  for (int i = tid; i < rows * B; i += nthreads)
    cp_async_4(c_s + i,
               c0 + l * plane_n + (size_t)(i % B) * N + row0 + i / B);
  cp_async_wait_all();
  clk.sync_lap(0);   // a barrier: the prologue's requests are in

#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    // what the kernel never writes, requested before the waits
    if (!inner) {
#pragma unroll 1
      for (int i = tid; i < rows * 4 * B; i += nthreads) {
        const int r = i / (4 * B), gb = i % (4 * B), g = gb / B, b = gb % B;
        cp_async_4(pre_s + i, pre_x + (((size_t)t * B + b) * 4 + g) * N +
                                  row0 + r);
      }
    }
    const unsigned char* mask_s = request_bytes(
        smem + Ly.mask, mask + (size_t)t * B, B, tid, nthreads);
    if (warp == 0) {
      // the producer stages each plane as soon as its producers counted it
      if (lane == 0) {
        bool own_ready = t == 0, below_ready = !inner;
        const long long since = clock64();
        while (!own_ready || !below_ready) {
          spin_guard(since);
          if (!below_ready &&
              (below_done ||
               load_acquire(p_below) >= (unsigned)((t + 1) * cpl))) {
            below_ready = true;
            async_proxy_fence();
            bulk_load(below, xs_below + t * xs_n, (uint32_t)Ly.plane,
                      bar + 1);
          }
          if (!own_ready && load_acquire(p_own) >= (unsigned)(t * cpl)) {
            own_ready = true;
            async_proxy_fence();
            bulk_load(own, xs_own + (t - 1) * xs_n, (uint32_t)Ly.plane,
                      bar);
          }
        }
        clk.lap(1);
      }
      if (t > 0) mbar_wait(bar, (t - 1) & 1);
      if (inner) mbar_wait(bar + 1, t & 1);
      clk.lap(2);
    } else {
      // W_in h_below while h_{t-1} may still be on its way, then W_h h_own
      if (inner) {
        mbar_wait(bar + 1, t & 1);
        family_sums(sums_in, w_s + (size_t)R * N * 4, below, N, B, R, rows,
                    Ly, warp - 1, lane);
      }
      if (t > 0) mbar_wait(bar, (t - 1) & 1);
      family_sums(sums_h, w_s, own, N, B, R, rows, Ly, warp - 1, lane);
    }
    cp_async_wait_all();
    clk.sync_lap(3);   // a barrier: the sums, pre_x rows and mask are in

#pragma unroll 1
    for (int i = tid; i < rows * B; i += nthreads) {
      const int r = i / B, b = i % B, n = row0 + r;
      float a[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float sum_h = gate_sum(sums_h, Ly, R, r, b, g);
        a[g] = inner ? gate_sum(sums_in, Ly, R, r, b, g) + sum_h
                     : pre_s[(r * 4 + g) * B + b] + sum_h;
      }
      const float c_prev = c_s[i];
      const float* cr = const_s + r * 8;
      const lstm_f32::State st =
          lstm_f32::cell_update(a, c_prev, cr, cr + 3, 1, 0);
      const bool live = mask_s[b] != 0;
      const float h_out = live ? st.h : own[plane_at(N, b, n)];
      const float c_out = live ? st.c : c_prev;
      c_s[i] = c_out;
      const size_t o = ((size_t)l * T + t) * plane_n + (size_t)b * N + n;
      hs[o] = h_out;
      cs[o] = c_out;
      xs[((size_t)l * T + t) * xs_n + plane_at(N, b, n)] = h_out;
    }
    // a barrier: every h_t row of this CTA is written; the sums and both
    // staged planes are free
    clk.sync_lap(4);
    // the group's top layer's last step feeds no one in this launch
    if (tid == 0 && (t + 1 < T || ll + 1 < lb)) publish(p_own);
  }
  if (tid == 0) finish(counters, lb, gridDim.x);
  clk.save(T);
}

int set_smem(size_t smem) {
  return cudaFuncSetAttribute(lstm_stack_seq_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" {

int lstm_stack_seq_occupancy(int device, int B, int N, int S, int R,
                             int* blocks_per_sm) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const Layout Ly = layout(B, N, R, 2, S);
  e = (cudaError_t)set_smem(Ly.total);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, lstm_stack_seq_kernel, 32 * (Ly.dot_warps + 1),
      Ly.total);
}

// Layers l0 .. l0 + lb - 1 of the stack (pointers to the whole stack's
// tensors), R rows and S K splits a CTA; the layers below l0 are done.
// counters: zero, (lb + 1) * kCounterStride words, used by no concurrent
// launch (the wrapper keeps one buffer per device and stream).
// xs: scratch of L * T * ceil(B / 8) * N * 8 floats, 16-byte aligned,
// holding layer l0 - 1's planes.
int lstm_stack_seq_launch(int device, const float* pre_x, const float* w_in,
                          const float* w_h, const float* peep,
                          const float* bias, const float* h0,
                          const float* c0, const unsigned char* mask,
                          float* hs, float* cs, float* xs,
                          unsigned* counters, int T, int B, int N, int l0,
                          int lb, int R, int S, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const Layout Ly = layout(B, N, R, 2, S);
  e = (cudaError_t)set_smem(Ly.total);
  if (e != cudaSuccess) return e;
  int cpl = (N + R - 1) / R;               // CTAs per layer
  void* args[] = {&pre_x, &w_in, &w_h, &peep, &bias, &h0, &c0, &mask,
                  &hs, &cs, &xs, &counters, &T, &B, &N, &l0, &R, &S, &cpl};
  e = cudaLaunchCooperativeKernel(
      (const void*)lstm_stack_seq_kernel, dim3(lb * cpl),
      dim3(32 * (Ly.dot_warps + 1)), args, Ly.total, (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

#ifdef CLOCK_STAMPS
int lstm_stack_seq_clock_stamps(void* host, int n_ctas) {
  return copy_stamps(host, n_ctas);
}
#endif

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
