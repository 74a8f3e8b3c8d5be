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
// What bounds them on an H100: bytes, in principle.  At the training shape
// (N_h = 421, B = 8) one K5 launch must read W_h (2.84 MB) and write 27 KB,
// 0.88 us at 3.35 TB/s, against 11.4 MFLOP (0.17 us at 67 TFLOP/s); K6
// reads W (3.66 MB for layer 0, N_in = 544; 5.67 MB for an inner layer,
// N_in = 842).  W stays in the 50 MB L2 from launch to launch, so what sets
// the pace is latency: the launch, every chain of dependent memory round
// trips, and fetching the instructions, which each launch does afresh (the
// clock stamps fell with every instruction taken off the path: loops are
// kept rolled, the staging code exists once, and a full chunk of 8 streams
// takes a dot without per-stream guards).  The arithmetic stays on
// the CUDA cores in full f32 (no tensor cores: TF32 would not hold the 1e-4
// parity with the f32 plain version, and the products take 0.17 us).
//
// Design: CTAs split the N_h hidden rows, R rows each (R = ceil(N_h / SMs),
// all four gates of a row in one CTA; 2 or 4 CTAs an SM measured slower).
// Everything a CTA reads is requested at its start, asynchronously, so the
// round trips overlap:
//   - its weight slab (for each gate g, rows row0 .. row0+R-1 of w[g]: one
//     contiguous span of R*K floats) and the B x K row inputs (h for K5,
//     [x; h] for K6) in chunks of 8 streams, each span by one bulk copy
//     (`cp.async.bulk`, completing on an mbarrier), its 16-byte-aligned part
//     rounded outward inside the tensor's own extent, the unaligned head and
//     tail (a view at any storage offset) by 4-byte `cp.async`;
//   - its rows of `pre` (K5), `c_prev`, `peep` and `bias` by 4-byte
//     `cp.async`.
// Input chunks run through a ring of S slots: with S = ceil(B / 8) (every
// shape of the training and cell paths) all of them are in flight at the
// start; a larger B refills a slot once its chunk is consumed.  Where even
// the slab and one slot do not fit in shared memory (S = 0), the dot reads
// global memory directly.  Compute runs from shared memory: for each chunk,
// each row's 4 gates x 8 streams are 32 sums a lane, K split over the lanes
// and over `splits` warps (k = lane + 32 (split + splits i)), then a fixed
// reduce-scatter butterfly over the warp (31 shuffles: lane l holds gate
// l / 8, stream l % 8) and a fixed-order sum over the splits in the
// epilogue.  No atomics: the same inputs give the same bits.  The epilogue
// (`lstm_f32_epilogue.cuh`, shared with K1 and K2) runs per chunk.  The dot
// order is the same in both kernels.
//
// Every launch is a programmatic dependent launch: its CTAs may start while
// the kernel before it on the stream is still running, and everything
// before `griddepcontrol.wait` overlaps that kernel's tail.  A launch
// flagged `early` (K5 on the `cuda_step` chain, steps 2 .. T of a layer,
// where the kernel just before is the K5 launch that wrote its `h` and
// `c_prev`) stages what that kernel cannot have written (its weights,
// `pre`, `peep`, `bias`) before the wait; any other launch, K6 included
// (the op's `cat` writes its weight), reads nothing before it.  `h`,
// `c_prev` and every write come after the wait.  A CTA signals
// `griddepcontrol.launch_dependents` right after its wait (never before:
// a dependent's early reads rely on every kernel before this one having
// finished).  Clock stamps (-DCLOCK_STAMPS) time the staging (waits
// included), the dot, the reduction and the epilogue.
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "clock_stamps.cuh"
#include "lstm_f32_epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;              // streams per input chunk
constexpr int kOut = 4 * kChunk;       // gate sums of one row and chunk

__host__ __device__ constexpr size_t round16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}
// shared bytes of a span of n floats placed at its global address mod 16,
// with room for the bulk copy rounded outward to 16 bytes
__host__ __device__ constexpr size_t span_bytes(size_t n) {
  return round16(4 * n) + 16;
}

// Shared memory (byte offsets): mbarriers [1 + S] | weight slab, 4 spans of
// R*K | S ring slots, each an input chunk (cap*K) then its pre [R][4][8]
// and c_prev [R][8] | gate sums [splits][R][32] | peep and bias [R][8]
struct Layout {
  int cap, chunks, splits;
  size_t slot_in, slot, w, slots, part, consts, total;
};
__host__ __device__ inline Layout layout(int B, int K, int R, int S) {
  Layout L;
  L.cap = B < kChunk ? B : kChunk;
  L.chunks = (B + kChunk - 1) / kChunk;
  L.splits = kWarps / R > 1 ? kWarps / R : 1;
  L.slot_in = span_bytes((size_t)L.cap * K);
  L.slot = L.slot_in + (size_t)4 * 5 * R * kChunk;
  L.w = round16((size_t)8 * (1 + S));
  L.slots = L.w + (S > 0 ? 4 * span_bytes((size_t)R * K) : 0);
  L.part = L.slots + (size_t)S * L.slot;
  L.consts = L.part + (size_t)4 * L.splits * R * kOut;
  L.total = L.consts + (size_t)4 * 8 * R;
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(arrivals)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Stages the span src[0, n) of a tensor whose floats are [lo, hi) into the
// shared region at `region` (span_bytes(n) long, 16-byte aligned), where it
// lands at region + (src mod 16 bytes).  One thread
// does it all: its 16-byte-aligned part, rounded outward but kept inside
// [lo, hi), as one bulk copy completing on `bar` (one arrival, armed with
// its bytes); the floats before and after that part (a view at any storage
// offset) as 4-byte `cp.async`.  Not inlined: its code is fetched once.
__device__ __noinline__ void stage_span(unsigned char* region,
                                        const float* src, int n,
                                        const float* lo, const float* hi,
                                        uint64_t* bar) {
  const uintptr_t s = (uintptr_t)src, e = s + 4 * (uintptr_t)n;
  uintptr_t a = s & ~(uintptr_t)15, b = (e + 15) & ~(uintptr_t)15;
  const uintptr_t l = ((uintptr_t)lo + 15) & ~(uintptr_t)15;
  const uintptr_t h = (uintptr_t)hi & ~(uintptr_t)15;
  if (a < l) a = l;
  if (b > h) b = h;
  if (b <= a) a = b = s;   // no aligned part: every float by itself
  float* dst = reinterpret_cast<float*>(region + (s & 15));
  mbar_expect(bar, (uint32_t)(b - a));
  if (b > a)
    bulk_load(reinterpret_cast<char*>(dst) + (a - s),
              reinterpret_cast<const void*>(a), (uint32_t)(b - a), bar);
  const int head = a > s ? (int)((a - s) / 4) : 0;
#pragma unroll 1
  for (int k = 0; k < head; ++k) cp_async_4(dst + k, src + k);
#pragma unroll 1
  for (int k = b > s ? (int)((b - s) / 4) : 0; k < n; ++k)
    cp_async_4(dst + k, src + k);
}

// One row's gate sums for one chunk of nb <= 8 streams, this lane's share
// of k (k0, k0 + kstep, ...): v[g * 8 + j] += w[g][k] x[j][k].  w[g] and x
// point to shared memory (staged) or global memory (S = 0), rows K long.
__device__ __forceinline__ void row_dot(float v[kOut], const float* w0,
                                        const float* w1, const float* w2,
                                        const float* w3, const float* x,
                                        int K, int nb, int k0, int kstep) {
#pragma unroll
  for (int i = 0; i < kOut; ++i) v[i] = 0.0f;
#pragma unroll 1
  for (int k = k0; k < K; k += kstep) {
    const float wk[4] = {w0[k], w1[k], w2[k], w3[k]};
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j < nb) {
        const float xk = x[(size_t)j * K + k];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          v[g * kChunk + j] = fmaf(wk[g], xk, v[g * kChunk + j]);
      }
    }
  }
}
// The sum over the warp's 32 lanes of v[i], scattered: lane l ends with
// the sum of v[l] in v[0].  A fixed butterfly (16 + 8 + 4 + 2 + 1
// shuffles): at the level of lane bit M a lane keeps the half of its live
// sums that its bit selects and adds its partner's copy of that half.
// Every index is a constant, so v stays in registers.
template <int M>
__device__ __forceinline__ void reduce_scatter(float v[kOut], int lane) {
  const bool up = (lane & M) != 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float send = up ? v[i] : v[i + M];
    const float keep = up ? v[i + M] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
  if constexpr (M > 1) reduce_scatter<M / 2>(v, lane);
}

// in: (B, K) row inputs; w: (4, N, K); pre: (B, 4, N), read only when
// kHasPre; out h, c: (B, N).  R rows per CTA, S ring slots (0: unstaged).
// At most 128 registers a thread (two CTAs an SM), so a dependent launch's
// CTAs fit beside this one's.
template <bool kHasPre>
__global__ void __launch_bounds__(kThreads, 2)
gates_step_kernel(const float* __restrict__ in,
                  const float* __restrict__ w,
                  const float* __restrict__ pre,
                  const float* __restrict__ peep,    // (3, N)
                  const float* __restrict__ bias,    // (4, N)
                  const float* __restrict__ c_prev,  // (B, N)
                  float* __restrict__ h_out,
                  float* __restrict__ c_out,
                  int B, int N, int row_len, int R, int S, int early) {
  // K5's rows are N long: the constant lets the compiler see it
  const int K = kHasPre ? N : row_len;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(B, K, R, S);
  // [0]: the weight slab (4 arrivals, one per gate span); [1 + s]: slot s
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* part_s = reinterpret_cast<float*>(smem + L.part);
  float* const_s = reinterpret_cast<float*>(smem + L.consts);   // [R][8]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, N - row0);
  const bool staged = S > 0;
  const int first = staged ? min(S, L.chunks) : 0;
  Clock clk;

  if (staged && tid == 0) {
    mbar_init(bar, 4);
#pragma unroll 1
    for (int i = 1; i <= S; ++i) mbar_init(bar + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto slot_of = [&](int c) { return smem + L.slots + (c % S) * L.slot; };
  auto nb_of = [&](int c) { return min(kChunk, B - c * kChunk); };
  // the slab's gate g rows (thread g), in shared memory
  auto slab = [&](int g) {
    return smem + L.w + g * span_bytes((size_t)R * K);
  };
  // row r of gate g in the slab: gate g's span lands at slab(g) + (its
  // global address mod 16 bytes)
  auto slab_row = [&](int g, int r) {
    const float* src = w + ((size_t)g * N + row0) * K;
    return reinterpret_cast<const float*>(slab(g) + ((uintptr_t)src & 15)) +
           (size_t)r * K;
  };
  // chunk c's pre rows, [R][4][8] after its input in its slot
  auto request_pre = [&](int c) {
    float* pre_s = reinterpret_cast<float*>(slot_of(c) + L.slot_in);
    const int nb = nb_of(c);
#pragma unroll 1
    for (int i = tid; i < rows * 4 * kChunk; i += kThreads) {
      const int r = i >> 5, g = (i >> 3) & 3, j = i & 7;
      if (j < nb)
        cp_async_4(pre_s + i,
                   pre + ((size_t)(c * kChunk + j) * 4 + g) * N + row0 + r);
    }
  };
  // what no launch of this kernel writes: peep and bias ([R][8]: 3 peep, 4
  // bias), the weight slab, and the first chunks' pre rows
  auto request_fixed = [&]() {
#pragma unroll 1
    for (int i = tid; i < rows * 8; i += kThreads) {
      const int r = i >> 3, g = i & 7;
      if (g < 7)
        cp_async_4(const_s + i, g < 3 ? peep + (size_t)g * N + row0 + r
                                      : bias + (size_t)(g - 3) * N + row0 + r);
    }
    if (staged && tid < 4)
      stage_span(slab(tid), w + ((size_t)tid * N + row0) * K, rows * K, w,
                 w + (size_t)4 * N * K, bar);
    if (kHasPre) {
#pragma unroll 1
      for (int c = 0; c < first; ++c) request_pre(c);
    }
  };
  // chunk c's inputs (one span of nb * K floats, thread c % kThreads) and
  // its c_prev rows, [R][8] after its pre rows
  auto request_in = [&](int c) {
    unsigned char* slot = slot_of(c);
    const int nb = nb_of(c);
    if (tid == c % kThreads)
      stage_span(slot, in + (size_t)c * kChunk * K, nb * K, in,
                 in + (size_t)B * K, bar + 1 + c % S);
    float* c_s = reinterpret_cast<float*>(slot + L.slot_in) + 4 * R * kChunk;
#pragma unroll 1
    for (int i = tid; i < rows * kChunk; i += kThreads) {
      const int r = i >> 3, j = i & 7;
      if (j < nb)
        cp_async_4(c_s + i, c_prev + (size_t)(c * kChunk + j) * N + row0 + r);
    }
  };

  // Every launch may start before the kernel ahead of it on the stream has
  // finished.  Only a launch that follows this kernel (`early`) reads the
  // operands that kernel cannot have written before waiting for it; any
  // other reads nothing before the wait, only its prologue overlaps.  (A
  // loop, so request_fixed's code exists once.)
#pragma unroll 1
  for (int step = 0; step < 2; ++step) {
    if (step == (early ? 1 : 0)) {
      grid_dependency_wait();   // the kernel before this one has finished
      grid_launch_dependents();
    }
    if (step == (early ? 0 : 1)) request_fixed();
  }
#pragma unroll 1
  for (int c = 0; c < first; ++c) request_in(c);
  if (staged) mbar_wait(bar, 0);

  const int split = warp % L.splits, row_step = kWarps / L.splits;
#pragma unroll 1
  for (int c = 0; c < L.chunks; ++c) {
    const int nb = nb_of(c);
    if (staged) mbar_wait(bar + 1 + c % S, (c / S) & 1);
    cp_async_wait_all();
    __syncthreads();
    clk.lap(0);

#pragma unroll 1
    for (int r = warp / L.splits; r < rows; r += row_step) {
      float v[kOut];
      if (staged) {
        const float* x = reinterpret_cast<const float*>(
            slot_of(c) + ((uintptr_t)(in + (size_t)c * kChunk * K) & 15));
        if (nb == kChunk)   // a full chunk: no per-stream guards
          row_dot(v, slab_row(0, r), slab_row(1, r), slab_row(2, r),
                  slab_row(3, r), x, K, kChunk, lane + 32 * split,
                  32 * L.splits);
        else
          row_dot(v, slab_row(0, r), slab_row(1, r), slab_row(2, r),
                  slab_row(3, r), x, K, nb, lane + 32 * split,
                  32 * L.splits);
      } else {
        const float* wr = w + (size_t)(row0 + r) * K;
        const size_t gs = (size_t)N * K;
        row_dot(v, wr, wr + gs, wr + 2 * gs, wr + 3 * gs,
                in + (size_t)c * kChunk * K, K, nb, lane + 32 * split,
                32 * L.splits);
      }
      clk.lap(1);
      reduce_scatter<kOut / 2>(v, lane);
      part_s[(split * R + r) * kOut + lane] = v[0];
      clk.lap(2);
    }
    __syncthreads();
    clk.lap(2);

    const float* pre_s =
        staged ? reinterpret_cast<const float*>(slot_of(c) + L.slot_in)
               : nullptr;
    const float* c_s = staged ? pre_s + 4 * R * kChunk : nullptr;
#pragma unroll 1
    for (int i = tid; i < rows * kChunk; i += kThreads) {
      const int r = i >> 3, j = i & 7, b = c * kChunk + j, n = row0 + r;
      if (j >= nb) continue;
      float a[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float sum = part_s[r * kOut + g * kChunk + j];
#pragma unroll 1
        for (int s = 1; s < L.splits; ++s)
          sum += part_s[(s * R + r) * kOut + g * kChunk + j];
        if (kHasPre)
          sum = (staged ? pre_s[(r * 4 + g) * kChunk + j]
                        : pre[((size_t)b * 4 + g) * N + n]) + sum;
        a[g] = sum;
      }
      const float cp = staged ? c_s[i] : c_prev[(size_t)b * N + n];
      const float* cr = const_s + r * 8;
      const lstm_f32::State st = lstm_f32::cell_update(a, cp, cr, cr + 3, 1, 0);
      h_out[(size_t)b * N + n] = st.h;
      c_out[(size_t)b * N + n] = st.c;
    }
    clk.lap(3);
    if (c + 1 < L.chunks) {
      __syncthreads();   // the gate sums and this chunk's slot are free
      if (staged && c + S < L.chunks) {
        if (kHasPre) request_pre(c + S);
        request_in(c + S);
      }
    }
  }
  clk.save(L.chunks);
}

template <bool kHasPre>
int launch(int device, const float* in, const float* w, const float* pre,
           const float* peep, const float* bias, const float* c_prev,
           float* h_out, float* c_out, int B, int N, int K, int R, int S,
           int early, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const size_t smem = layout(B, K, R, S).total;
  if (smem > 48 * 1024) {   // above the default only by opting in
    e = cudaFuncSetAttribute(gates_step_kernel<kHasPre>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + R - 1) / R);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, gates_step_kernel<kHasPre>, in, w, pre, peep,
                         bias, c_prev, h_out, c_out, B, N, K, R, S, early);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K5: h (B, N), w_h (4, N, N), pre (B, 4, N).  early: the kernel just
// before this launch on the stream is the K5 launch that wrote h and c_prev.
int lstm_gates_rec_launch(int device, const float* h, const float* w_h,
                          const float* pre, const float* peep,
                          const float* bias, const float* c_prev,
                          float* h_out, float* c_out, int B, int N, int R,
                          int S, int early, void* stream) {
  return launch<true>(device, h, w_h, pre, peep, bias, c_prev, h_out, c_out,
                      B, N, N, R, S, early, stream);
}

// K6: xh (B, K), w (4, N, K), K = N_x + N_h.  Never early: the kernel before
// it (`lstm_cell_fused`'s cat) writes its weight.
int lstm_gates_launch(int device, const float* xh, const float* w,
                      const float* peep, const float* bias,
                      const float* c_prev, float* h_out, float* c_out, int B,
                      int N, int K, int R, int S, void* stream) {
  return launch<false>(device, xh, w, nullptr, peep, bias, c_prev, h_out,
                       c_out, B, N, K, R, S, 0, stream);
}

#ifdef CLOCK_STAMPS
int lstm_gates_rec_clock_stamps(void* host, int n_ctas) {
  return copy_stamps(host, n_ctas);
}
#endif

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
