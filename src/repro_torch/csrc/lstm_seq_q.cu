// K3: persistent whole-chunk int8 LSTM layer — the Chipmunk silicon datapath,
// masked, for sm_90a.
//
// Replaces the TPU kernel `lstm_seq_quantized` of
// src/repro/kernels/lstm_seq/kernel.py (body `_seq_kernel_q`): one launch
// runs T recurrent steps of one layer in integer arithmetic, bit-identical to
// scanning `systolic_cell_quantized` (src/repro_torch/core/systolic.py).
// The silicon's order, which every result depends on: for each output row,
// gate and stream, each column tile (x-region tiles first, then h-region
// tiles) gives an exact int32 tile MAC, saturated to int16 and added to the
// accumulator serially with a saturation after every add; then the integer
// epilogue of `_quantized_state_update` (`lstm_q_epilogue.cuh`).
//
// What bounds it on an H100: neither bytes (1.05 MB at CTC-3L-421H-UNI
// width, 0.31 us of HBM time) nor operations, but the chain of T step
// latencies: each step needs every row of h_{t-1}.  The first K3's clock
// stamps (PERF.md) put a 17k-cycle step half into its tile MACs (4-byte dot
// loops, one thread per tile partial), a fifth into staging the codes, a
// sixth into the serial hop tail on 32 of 256 threads and an eighth into
// the grid barrier.  This design's stamps put a ~4k-cycle step into the
// exchange of h_{t-1} (release, slowest CTA, acquire, bulk copy), with the
// x-region tiles under it, then the h-region tiles (~1k) and the epilogue.
//
// Design: the tile MACs run on the int8 tensor cores with the hop chain and
// the epilogue in registers (`lstm_q_epilogue.cuh`), and the steps are
// exchanged point to point (`lstm_exchange.cuh`), with no grid barrier.
// CTAs split the padded_h rows into row groups of 8 (R = 8 * ceil(groups /
// SMs): 60 CTAs of one row group at full width); a pair of dot warps owns a
// (row group, 8-stream chunk) task, one m-tile (two gates) each.  The
// prologue requests the CTA's 4 * R weight rows, each column tile padded to
// a multiple of 32 k; they stay on chip for the chunk.  Per step t:
//   - the producer warp (the last) waits until every CTA has counted step
//     t - 1 and stages h_{t-1} (`xch[t - 1]`, the (B, sp) plane the CTAs
//     wrote) with one bulk copy, then step t + 1's x codes (a bulk copy a
//     stream) and mask row (the kernel never writes them), so no request
//     delays its wait;
//   - meanwhile the dot warps sum the x-region tiles, staged a step ahead;
//   - the dot warps sum the h-region tiles, trade one stream's sums within
//     the pair and run the epilogue; h_t and c_t go to `hs[t]`, `cs[t]` and
//     h_t to `xch[t]`; after a barrier the CTA counts the step.
// Clock stamps (-DCLOCK_STAMPS) time, for the first dot warp's lane 0, the
// prologue, the x-region tiles, the wait for h_{t-1}, the h-region tiles
// and the epilogue with the step's barrier.
#include <cuda_runtime.h>

#include "clock_stamps.cuh"
#include "lstm_exchange.cuh"
#include "lstm_q_epilogue.cuh"

namespace {

using namespace lstm_exchange;
using QLayout = lstm_q::Layout;

__host__ __device__ QLayout q_layout(int B, int P_x, int P_h, int tile,
                                      int R) {
  return lstm_q::layout(B, P_h, P_x, tile, R, (P_x + P_h) / tile, 1, 1,
                        false);
}

// xch: h_t, (T, B, sp), what the next step stages; counters: the layer's
// progress counter, then `done`
__global__ void __launch_bounds__(32 * (lstm_q::kMaxDotWarps + 1))
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
                  int8_t* xch, unsigned* counters, int T, int B, int P_x,
                  int P_h, int tile, int R) {
  extern __shared__ __align__(128) unsigned char smem[];
  const QLayout Q = q_layout(B, P_x, P_h, tile, R);
  const int P_in = P_x + P_h, cols_x = P_x / tile, cols_h = P_h / tile;
  const int B8 = lstm_q::kChunk * Q.chunks;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int8_t* plane = reinterpret_cast<int8_t*>(smem + Q.planes);  // [B8][sp]
  // [task][m-tile][32]; [pair][2 rounds][m-tile][32]
  uint2* spill = reinterpret_cast<uint2*>(smem + Q.spill);
  int2* slots = reinterpret_cast<int2*>(smem + Q.trade);
  int8_t* c_s = reinterpret_cast<int8_t*>(smem + Q.c);         // [R][B8]
  const int16_t* bias_s = reinterpret_cast<int16_t*>(smem + Q.consts);
  const int8_t* peep_s =
      reinterpret_cast<int8_t*>(smem + Q.consts + 8 * R);
  const int8_t* lut_s = reinterpret_cast<int8_t*>(smem + Q.lut);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const bool producer = warp == Q.dot_warps;
  const int row0 = blockIdx.x * R;
  const int g = lane >> 2, t4 = lane & 3;
  // dot warps: pair `pair` of `pairs` takes tasks pair, pair + pairs, ...;
  // warp `half` of it m-tile `half`
  const int pair = warp >> 1, half = warp & 1, pairs = Q.dot_warps / 2;
  const size_t xch_n = (size_t)B * Q.sp;   // bytes of one xch plane
  Clock clk;

  if (tid == 0) {
    mbar_init(bar, 1);       // h_{t-1}
    mbar_init(bar + 1, 1);   // x_t, staged by bulk copies
    mbar_init_fence();
  }
  // x_t by bulk copies where its rows allow, else by the dot warps'
  // `cp.async`s
  const bool x_bulk = ((uintptr_t)xs | P_x) % 16 == 0;
  const bool vec16 = ((uintptr_t)w | P_in | tile) % 16 == 0;
  lstm_q::stage_weights(
      smem + Q.w,
      [&](int gate, int r) {
        const int n = row0 + r;
        return n < P_h ? w + ((size_t)gate * P_h + n) * P_in : nullptr;
      },
      Q, cols_x + cols_h, tile, vec16, tid, nthreads);
  lstm_q::stage_state(smem, Q, h0, c0, bias, peep, mask, sig_lut, tanh_lut,
                      B, P_h, R, row0, tid, nthreads);
  lstm_q::stage_rows(smem + Q.x, xs, B, P_x, Q.sx, tid, nthreads);
  cp_async_wait_all();
  clk.sync_lap(0);   // a barrier: the prologue's requests are in

#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    if (producer) {
      if (lane == 0 && t > 0) {
        const long long since = clock64();
        while (load_acquire(counters) < (unsigned)(t * gridDim.x))
          spin_guard(since);
        async_proxy_fence();
        bulk_load(plane, xch + (t - 1) * xch_n, (uint32_t)xch_n, bar);
      }
      // what the kernel never writes, a step ahead: x_{t+1} and the mask
      // row, read after the step's barrier
      if (t + 1 < T) {
        if (lane == 0 && x_bulk)
          lstm_q::bulk_rows(smem + Q.x + ((t + 1) & 1) * Q.xplane,
                            xs + (size_t)(t + 1) * B * P_x, B, P_x, Q.sx,
                            bar + 1);
        lstm_q::load_mask(smem, Q, mask, t + 1, B, lane, 32);
      }
    } else {
      if (t + 1 < T && !x_bulk)
        lstm_q::stage_rows(smem + Q.x + ((t + 1) & 1) * Q.xplane,
                           xs + (size_t)(t + 1) * B * P_x, B, P_x, Q.sx, tid,
                           32 * Q.dot_warps);
      if (t > 0 && x_bulk) mbar_wait(bar + 1, (t - 1) & 1);
      const int8_t* x_s = reinterpret_cast<const int8_t*>(
          smem + Q.x + (t & 1) * Q.xplane);
      // the x-region tiles, before h_{t-1} lands
#pragma unroll 1
      for (int task = pair; task < Q.tasks; task += pairs) {
        const int grp = task % Q.groups, s0 = (task / Q.groups) * 8;
        const int8_t* xb = x_s + (size_t)(s0 + g) * Q.sx + 4 * t4;
        int chain[4] = {0, 0, 0, 0};
        lstm_q::hop_tiles(
            chain, lstm_q::a_lane(smem + Q.w + (grp * 32 + half * 16) * Q.sw,
                                  Q.sw, lane),
            Q.kp, cols_x, [&](int c, int k, unsigned b[2]) {
              const int8_t* p = xb + c * tile + k;
              b[0] = *reinterpret_cast<const unsigned*>(p);
              b[1] = *reinterpret_cast<const unsigned*>(p + 16);
            });
        spill[(task * 2 + half) * 32 + lane] = lstm_q::pack_chain(chain);
      }
      clk.lap(1);
      if (t > 0) mbar_wait(bar, (t - 1) & 1);
      clk.lap(2);
      // the h-region tiles, then the epilogue, task by task
      const unsigned char* mask_s = lstm_q::mask_row(smem, Q, t);
      int round = 0;
#pragma unroll 1
      for (int task = pair; task < Q.tasks; task += pairs, ++round) {
        const int grp = task % Q.groups, s0 = (task / Q.groups) * 8;
        const int8_t* hb = plane + (size_t)(s0 + g) * Q.sp + 4 * t4;
        int chain[4];
        lstm_q::unpack_chain(spill[(task * 2 + half) * 32 + lane], chain);
        lstm_q::hop_tiles(
            chain, lstm_q::a_lane(smem + Q.w + (grp * 32 + half * 16) * Q.sw +
                                      cols_x * Q.kp, Q.sw, lane),
            Q.kp, cols_h, [&](int c, int k, unsigned b[2]) {
              const int8_t* p = hb + c * tile + k;
              b[0] = *reinterpret_cast<const unsigned*>(p);
              b[1] = *reinterpret_cast<const unsigned*>(p + 16);
            });
        clk.lap(3);
        int acc[4];
        lstm_q::trade(slots, pair, half, round, lane, chain, acc);
        const int r = grp * 8 + g, n = row0 + r, b = s0 + 2 * t4 + half;
        if (n < P_h && b < B) {
          const lstm_q::Codes q = lstm_q::state_update(
              acc, c_s[r * B8 + b], plane[(size_t)b * Q.sp + n],
              mask_s[b] != 0, bias_s, peep_s, R, r, lut_s);
          c_s[r * B8 + b] = q.c;
          const size_t o = ((size_t)t * B + b) * P_h + n;
          hs[o] = q.h;
          cs[o] = q.c;
          xch[t * xch_n + (size_t)b * Q.sp + n] = q.h;
        }
      }
      cp_async_wait_all();
    }
    // a barrier: every h_t row of this CTA is written; the plane is free
    clk.sync_lap(4);
    if (producer && lane == 0 && t + 1 < T) publish(counters);
  }
  if (producer && lane == 0) finish(counters, 1, gridDim.x);
  clk.save(T);
}

int set_smem(size_t smem) {
  return cudaFuncSetAttribute(lstm_seq_q_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" {

// Resident blocks per SM for this geometry (after raising the dynamic
// shared-memory limit); the wrapper multiplies by the SM count.
int lstm_seq_q_occupancy(int device, int B, int P_x, int P_h, int tile, int R,
                         int* blocks_per_sm) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const QLayout Q = q_layout(B, P_x, P_h, tile, R);
  e = (cudaError_t)set_smem(Q.total);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, lstm_seq_q_kernel, lstm_q::threads(Q), Q.total);
}

// counters: zero, (1 + 1) * kCounterStride words, used by no concurrent
// launch (the wrapper keeps one buffer per device and stream).
// xch: scratch of T * B * sp bytes, 16-byte aligned; xs and w 4-byte
// aligned.
int lstm_seq_q_launch(int device, const int8_t* xs, const int8_t* w,
                      const int8_t* peep, const int16_t* bias,
                      const int8_t* sig_lut, const int8_t* tanh_lut,
                      const int8_t* h0, const int8_t* c0,
                      const unsigned char* mask, int8_t* hs, int8_t* cs,
                      int8_t* xch, unsigned* counters, int T, int B, int P_x,
                      int P_h, int tile, int R, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const QLayout Q = q_layout(B, P_x, P_h, tile, R);
  e = (cudaError_t)set_smem(Q.total);
  if (e != cudaSuccess) return e;
  const int ctas = (P_h + R - 1) / R;
  void* args[] = {&xs, &w, &peep, &bias, &sig_lut, &tanh_lut, &h0, &c0,
                  &mask, &hs, &cs, &xch, &counters, &T, &B, &P_x, &P_h,
                  &tile, &R};
  e = cudaLaunchCooperativeKernel((const void*)lstm_seq_q_kernel, dim3(ctas),
                                  dim3(lstm_q::threads(Q)), args, Q.total,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

#ifdef CLOCK_STAMPS
int lstm_seq_q_clock_stamps(void* host, int n_ctas) {
  return copy_stamps(host, n_ctas);
}
#endif

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
