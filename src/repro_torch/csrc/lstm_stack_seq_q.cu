// K4: fused whole-stack int8 LSTM wavefront — the Chipmunk silicon datapath
// across every layer of a chunk, masked, for sm_90a.
//
// Replaces the TPU kernel `lstm_stack_seq_kernel_q` of
// src/repro/kernels/lstm_seq/stack_kernel.py (body `_stack_kernel_q`): one
// launch runs every layer of a homogeneous int8 stack over a chunk of T
// steps, bit-identical layer by layer to chaining K3 (`lstm_seq_q.cu`).
// Layer l at step t needs only the layer below's h_t codes and its own
// h_{t-1} codes.  The silicon's order: for each (layer, row, gate, stream),
// the column tiles (an inner layer's below-h region, then its own-h region)
// each give an exact int32 tile MAC, saturated to int16 and added serially
// with a saturation after every add.  Layer 0 has no below region: it
// resumes the chain at hop cols_h from `acc_x`, the hoisted prefix of its
// x-region hops (`core.systolic.quantized_x_prefix`, computed outside the
// kernel as the reference does).
//
// What bounds it on an H100: neither bytes (4.77 MB at CTC-3L-421H-UNI
// width, 1.4 us of HBM time) nor operations, but the chain of step
// latencies, T + L - 1 at most.  The first K4's clock stamps (PERF.md) put
// a 40k-cycle diagonal 59 % into its tile MACs (4-byte dot loops), a fifth
// into a grid barrier that every CTA met, bubbles included, and a tenth
// into staging.  This design's stamps put an inner layer's ~6k-cycle step
// mostly into the exchanges of the plane below and of its own h_{t-1}
// (release, slowest CTA, acquire, bulk copy), then the own-h tiles (~1.2k)
// and the epilogue.
//
// Design: K3's (`lstm_q_epilogue.cuh`: tile MACs on the int8 tensor cores,
// the hop chain and the epilogue in registers, a pair of dot warps a task;
// `lstm_exchange.cuh`: the step exchange), with layers as a dataflow
// pipeline.  CTAs own (layer, row-slice) pairs of whole row groups of 8,
// with R the smallest such that L * ceil(padded_h / R) CTAs fit on the SMs
// (R = 16 at full width, 90 CTAs).  Weights come as K2's do: `w_in` holds
// the inner layers' below-h weights and `w_h` every layer's own-h weights;
// a CTA's rows of both (one family for layer 0) stay on chip for the
// chunk.  At step t the producer warp stages the layer below's h_t
// (`xch[l-1][t]`) once that layer's counter shows step t done by all its
// CTAs, and the layer's own h_{t-1} (`xch[l][t-1]`) once its own counter
// shows t - 1, each by one bulk copy as soon as it is ready; a CTA waits
// for nothing else, and none waits in a fill or drain bubble.  Then it
// requests the next step's mask row and, for layer 0, the next step's
// `acc_x` rows (one bulk copy a stream and gate).  The dot warps sum the
// below-h tiles (layer 0 starts from its prefix) while h_{t-1} may still be
// on its way, then the own-h tiles, then the epilogue; h_t and c_t go
// layer-major into (L, T, B, padded_h), h_t also into `xch[l][t]`.  Every
// (layer, step) writes its own slots, so a layer running ahead clobbers
// nothing.  Clock stamps (-DCLOCK_STAMPS) time, for the first dot warp's
// lane 0, the prologue, the below-h tiles (with their wait), the wait for
// h_{t-1}, the own-h tiles and the epilogue with the step's barrier.
#include <cuda_runtime.h>

#include "clock_stamps.cuh"
#include "lstm_exchange.cuh"
#include "lstm_q_epilogue.cuh"

namespace {

using namespace lstm_exchange;
using QLayout = lstm_q::Layout;

__host__ __device__ QLayout q_layout(int B, int P_h, int tile,
                                      int R) {
  return lstm_q::layout(B, P_h, 0, tile, R, P_h / tile, 2, 2, true);
}

// xch: h_t, (L, T, B, sp), what later steps stage; counters: one progress
// counter per layer, then `done`
__global__ void __launch_bounds__(32 * (lstm_q::kMaxDotWarps + 1))
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
                        int8_t* xch, unsigned* counters, int T, int B,
                        int P_h, int tile, int L, int R, int cpl) {
  extern __shared__ __align__(128) unsigned char smem[];
  const QLayout Q = q_layout(B, P_h, tile, R);
  const int cols = P_h / tile, B8 = lstm_q::kChunk * Q.chunks;
  // [0] own plane, [1] below plane (layer 0: its acc_x prefix)
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int8_t* own = reinterpret_cast<int8_t*>(smem + Q.planes);     // [B8][sp]
  int8_t* below = reinterpret_cast<int8_t*>(smem + Q.planes + Q.plane);
  // [own-h, below-h][groups][32][sw]
  const unsigned char* w_s = smem + Q.w;
  const size_t fam = (size_t)4 * R * Q.sw;
  // [task][m-tile][32]; [pair][2 rounds][m-tile][32]
  uint2* spill = reinterpret_cast<uint2*>(smem + Q.spill);
  int* prefix = reinterpret_cast<int*>(smem + Q.prefix);  // [2][B8][4][R]
  int2* slots = reinterpret_cast<int2*>(smem + Q.trade);
  int8_t* c_s = reinterpret_cast<int8_t*>(smem + Q.c);         // [R][B8]
  const int16_t* bias_s = reinterpret_cast<int16_t*>(smem + Q.consts);
  const int8_t* peep_s =
      reinterpret_cast<int8_t*>(smem + Q.consts + 8 * R);
  const int8_t* lut_s = reinterpret_cast<int8_t*>(smem + Q.lut);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const bool producer = warp == Q.dot_warps;
  const int l = blockIdx.x / cpl;
  const int row0 = (blockIdx.x % cpl) * R;
  const bool inner = l > 0;
  const int g = lane >> 2, t4 = lane & 3;
  // dot warps: pair `pair` of `pairs` takes tasks pair, pair + pairs, ...;
  // warp `half` of it m-tile `half`
  const int pair = warp >> 1, half = warp & 1, pairs = Q.dot_warps / 2;
  const size_t plane_n = (size_t)B * P_h, mat = (size_t)4 * P_h * P_h;
  const size_t xch_n = (size_t)B * Q.sp;   // bytes of one xch plane
  const int8_t* xch_own = xch + (size_t)l * T * xch_n;
  // layer 0 reads no plane below (its pointers are never dereferenced)
  const int8_t* xch_below = inner ? xch_own - (size_t)T * xch_n : xch;
  unsigned* p_own = counters + (size_t)l * kCounterStride;
  const unsigned* p_below = inner ? p_own - kCounterStride : p_own;
  Clock clk;

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    mbar_init_fence();
  }
#pragma unroll 1
  for (int f = 0; f < (inner ? 2 : 1); ++f) {
    const int8_t* base = f == 0 ? w_h + l * mat : w_in + (l - 1) * mat;
    lstm_q::stage_weights(
        smem + Q.w + f * fam,
        [&](int gate, int r) {
          const int n = row0 + r;
          return n < P_h ? base + ((size_t)gate * P_h + n) * P_h : nullptr;
        },
        Q, cols, tile, ((uintptr_t)base | P_h | tile) % 16 == 0, tid,
        nthreads);
  }
  lstm_q::stage_state(smem, Q, h0 + l * plane_n, c0 + l * plane_n,
                      bias + (size_t)l * 4 * P_h, peep + (size_t)l * 3 * P_h,
                      mask, sig_lut, tanh_lut, B, P_h, R, row0, tid,
                      nthreads);
  // layer 0 (the producer warp): step t's acc_x rows of this CTA into step
  // t's buffer ([stream][gate][R] int32) by bulk copies onto the mbarrier
  // that inner layers use for the plane below: one contiguous run per
  // stream and gate (two where the rows cross a column tile's edge).  Lane
  // 0 arms the barrier with every run's bytes, then each lane copies the
  // runs of its (stream, gate) pairs.
  const int rows = min(R, P_h - row0), in_tile = row0 % tile;
  const int run0 = min(rows, tile - in_tile);
  auto stage_prefix = [&](int t) {
    int* dst = prefix + (size_t)(t & 1) * B8 * 4 * R;
    if (lane == 0)
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_u32(bar + 1)),
          "r"(16 * B * rows)
          : "memory");
    __syncwarp();
#pragma unroll 1
    for (int q = lane; q < 4 * B; q += 32) {
      const int b = q >> 2, gate = q & 3;
      const int* src = acc_x + (((size_t)t * B + b) * (P_h / tile) +
                                row0 / tile) * 4 * tile + gate * tile;
      int* d = dst + (b * 4 + gate) * R;
      lstm_q::bulk_copy(d, src + in_tile, 4 * run0, bar + 1);
      if (rows > run0)
        lstm_q::bulk_copy(d + run0, src + 4 * tile, 4 * (rows - run0),
                          bar + 1);
    }
  };
  if (!inner && producer) stage_prefix(0);
  // layer 0 waits for each step's prefix at the end of the step before, so
  // the producer arms the next phase only after every dot warp saw this one
  if (!inner && !producer) mbar_wait(bar + 1, 0);
  cp_async_wait_all();
  clk.sync_lap(0);   // a barrier: the prologue's requests are in

#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    if (producer) {
      // each plane as soon as its producers counted it
      if (lane == 0) {
        bool own_ready = t == 0, below_ready = !inner;
        const long long since = clock64();
        while (!own_ready || !below_ready) {
          spin_guard(since);
          if (!below_ready &&
              load_acquire(p_below) >= (unsigned)((t + 1) * cpl)) {
            below_ready = true;
            async_proxy_fence();
            bulk_load(below, xch_below + t * xch_n, (uint32_t)xch_n,
                      bar + 1);
          }
          if (!own_ready && load_acquire(p_own) >= (unsigned)(t * cpl)) {
            own_ready = true;
            async_proxy_fence();
            bulk_load(own, xch_own + (t - 1) * xch_n, (uint32_t)xch_n, bar);
          }
        }
      }
      // a step ahead: layer 0's prefix, and the mask row (read after the
      // step's barrier)
      if (t + 1 < T) {
        if (!inner) stage_prefix(t + 1);
        lstm_q::load_mask(smem, Q, mask, t + 1, B, lane, 32);
      }
    } else {
      // the below-h tiles, before h_{t-1} lands
      if (inner) {
        mbar_wait(bar + 1, t & 1);
#pragma unroll 1
        for (int task = pair; task < Q.tasks; task += pairs) {
          const int grp = task % Q.groups, s0 = (task / Q.groups) * 8;
          const int8_t* hb = below + (size_t)(s0 + g) * Q.sp + 4 * t4;
          int chain[4] = {0, 0, 0, 0};
          lstm_q::hop_tiles(
              chain, lstm_q::a_lane(w_s + fam + (grp * 32 + half * 16) * Q.sw,
                                    Q.sw, lane),
              Q.kp, cols, [&](int c, int k, unsigned b[2]) {
                const int8_t* p = hb + c * tile + k;
                b[0] = *reinterpret_cast<const unsigned*>(p);
                b[1] = *reinterpret_cast<const unsigned*>(p + 16);
              });
          spill[(task * 2 + half) * 32 + lane] = lstm_q::pack_chain(chain);
        }
      }
      clk.lap(1);
      if (t > 0) mbar_wait(bar, (t - 1) & 1);
      clk.lap(2);
      // the own-h tiles, then the epilogue, task by task
      const unsigned char* mask_s = lstm_q::mask_row(smem, Q, t);
      int round = 0;
#pragma unroll 1
      for (int task = pair; task < Q.tasks; task += pairs, ++round) {
        const int grp = task % Q.groups, s0 = (task / Q.groups) * 8;
        const int8_t* hb = own + (size_t)(s0 + g) * Q.sp + 4 * t4;
        int chain[4];
        if (inner) {
          lstm_q::unpack_chain(spill[(task * 2 + half) * 32 + lane], chain);
        } else {
          // element i: gate 2 half + i / 2, stream s0 + 2 t4 + i % 2
          const int* v = prefix + (size_t)(t & 1) * B8 * 4 * R +
                         ((s0 + 2 * t4) * 4 + 2 * half) * R + grp * 8 + g;
          chain[0] = v[0];
          chain[1] = v[4 * R];
          chain[2] = v[R];
          chain[3] = v[5 * R];
        }
        lstm_q::hop_tiles(
            chain, lstm_q::a_lane(w_s + (grp * 32 + half * 16) * Q.sw, Q.sw,
                                  lane),
            Q.kp, cols, [&](int c, int k, unsigned b[2]) {
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
              acc, c_s[r * B8 + b], own[(size_t)b * Q.sp + n],
              mask_s[b] != 0, bias_s, peep_s, R, r, lut_s);
          c_s[r * B8 + b] = q.c;
          const size_t o = ((size_t)l * T + t) * plane_n + (size_t)b * P_h + n;
          hs[o] = q.h;
          cs[o] = q.c;
          xch[((size_t)l * T + t) * xch_n + (size_t)b * Q.sp + n] = q.h;
        }
      }
      if (!inner && t + 1 < T) mbar_wait(bar + 1, (t + 1) & 1);
    }
    // a barrier: every h_t row of this CTA is written; both planes are free
    clk.sync_lap(4);
    // the top layer's last step feeds no one
    if (producer && lane == 0 && (t + 1 < T || l + 1 < L)) publish(p_own);
  }
  if (producer && lane == 0) finish(counters, L, gridDim.x);
  clk.save(T);
}

int set_smem(size_t smem) {
  return cudaFuncSetAttribute(lstm_stack_seq_q_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" {

int lstm_stack_seq_q_occupancy(int device, int B, int P_h, int tile, int L,
                               int R, int* blocks_per_sm) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  (void)L;
  const QLayout Q = q_layout(B, P_h, tile, R);
  e = (cudaError_t)set_smem(Q.total);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, lstm_stack_seq_q_kernel, lstm_q::threads(Q), Q.total);
}

// counters: zero, (L + 1) * kCounterStride words, used by no concurrent
// launch (the wrapper keeps one buffer per device and stream).
// xch: scratch of L * T * B * sp bytes, 16-byte aligned; w_in and w_h
// 4-byte aligned.
int lstm_stack_seq_q_launch(int device, const int* acc_x,
                            const int8_t* w_in, const int8_t* w_h,
                            const int8_t* peep, const int16_t* bias,
                            const int8_t* sig_lut, const int8_t* tanh_lut,
                            const int8_t* h0, const int8_t* c0,
                            const unsigned char* mask, int8_t* hs,
                            int8_t* cs, int8_t* xch, unsigned* counters,
                            int T, int B, int P_h, int tile, int L, int R,
                            void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const QLayout Q = q_layout(B, P_h, tile, R);
  e = (cudaError_t)set_smem(Q.total);
  if (e != cudaSuccess) return e;
  int cpl = (P_h + R - 1) / R;             // CTAs per layer
  void* args[] = {&acc_x, &w_in, &w_h, &peep, &bias, &sig_lut, &tanh_lut,
                  &h0, &c0, &mask, &hs, &cs, &xch, &counters, &T, &B, &P_h,
                  &tile, &L, &R, &cpl};
  e = cudaLaunchCooperativeKernel((const void*)lstm_stack_seq_q_kernel,
                                  dim3(L * cpl), dim3(lstm_q::threads(Q)),
                                  args, Q.total, (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

#ifdef CLOCK_STAMPS
int lstm_stack_seq_q_clock_stamps(void* host, int n_ctas) {
  return copy_stamps(host, n_ctas);
}
#endif

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
