// What the sequence kernels share.  K1 (`lstm_seq.cu`), K2
// (`lstm_stack_seq.cu`), K3 (`lstm_seq_q.cu`) and K4 (`lstm_stack_seq_q.cu`)
// exchange their steps between CTAs by the protocol of the first part; K1
// and K2 also share the f32 operand layouts in shared memory and the
// register-blocked dot of the second part.  The f32 gate math is
// `lstm_f32_epilogue.cuh`, the int8 datapath `lstm_q_epilogue.cuh`.
//
// Step exchange.  A layer's CTAs count the steps they have finished on one
// counter per layer (`progress`, each on its own 128-byte line): after a
// CTA has written its rows of h_t and c_t, `__syncthreads()`, then one
// thread adds 1 with release semantics.  The counter passes k * CTAs only
// once every CTA of the layer has finished step k - 1, since no CTA can
// start step k before that.  A CTA's producer warp spins with acquire loads
// on one lane until a counter reaches that value, orders the async proxy
// after the generic one (the plane was written by ordinary stores on other
// SMs and is read by a bulk copy), and stages the plane with one bulk copy
// (`cp.async.bulk`) onto an mbarrier; the other warps (the dot warps) wait
// on that mbarrier.  No grid barrier: a CTA waits only for the planes it
// reads.  The counters stay zero between launches: each CTA adds 1 to
// `done` after its last wait, and the CTA that brings it to the grid size
// resets every counter, so one zeroed buffer per device and stream serves
// every launch on that stream.  Spin-waits need every CTA resident at
// once: the launch is cooperative.
//
// f32 operands, k-major (K1, K2).  An h plane travels between CTAs as
// (chunk, k, 8 streams) (`xs`, beside the (B, N) outputs), so a lane reads
// the 8 streams of its k as two 16-byte loads; a CTA's weight rows sit in
// shared memory as (row, k, 4 gates), one 16-byte load for the 4 gates of
// its k.  The first plane (h0, a (B, N) input) and the weights are
// requested into these layouts by 4-byte `cp.async`s in the prologue.
//
// f32 dot (K1, K2).  For one hidden row and an 8-stream chunk, a lane keeps
// the 32 gate sums (4 gates x 8 streams) in registers: per k, three 16-byte
// shared loads and 32 fused multiply-adds, so each weight is read once per
// chunk and each h value once per row.  A lane of the second quarter of
// each 8-lane group reads the streams' two halves in the other order, so
// the 8 lanes of a shared-memory phase touch 8 distinct bank groups.  K is
// split over the lanes and over `splits` warps; a fixed butterfly then
// leaves lane l with the sum of gate l / 8, stream l % 8 (`family_sums`),
// and the epilogue adds the splits, then the families, in a fixed order
// (`gate_sum`).  One weight family's sums need only its own plane, so K2
// sums W_in h_below while the layer's own h_{t-1} is still on its way.  No
// atomics in any sum: the same inputs give the same bits, whatever T or
// the chunking.
#pragma once
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace lstm_exchange {

constexpr int kChunk = 8;             // streams per dot pass
constexpr int kOut = 4 * kChunk;      // gate sums of one row and chunk
constexpr int kMaxDotWarps = 16;
constexpr int kCounterStride = 32;    // words: one 128-byte line a counter

__host__ __device__ constexpr size_t round_up(size_t bytes, size_t to) {
  return (bytes + to - 1) / to * to;
}
__host__ __device__ constexpr int chunks_of(int B) {
  return (B + kChunk - 1) / kChunk;
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
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// One bulk copy of `bytes` (a multiple of 16; both ends 16-byte aligned)
// onto `bar`: one arrival, armed with the bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// Requests the bytes [p, p + n) of a tensor by 4-byte `cp.async`s of the
// aligned words that hold them (never past the tensor's own words) into
// `region`; returns where byte p lands.  Threads tid, tid + nthreads, ...
__device__ __forceinline__ const unsigned char* request_bytes(
    unsigned char* region, const unsigned char* p, int n, int tid,
    int nthreads) {
  const uintptr_t a = (uintptr_t)p & ~(uintptr_t)3;
  const int words = (int)(((uintptr_t)p + n + 3 - a) / 4);
#pragma unroll 1
  for (int i = tid; i < words; i += nthreads)
    cp_async_4(region + 4 * i, reinterpret_cast<const void*>(a + 4 * i));
  return region + ((uintptr_t)p & 3);
}
// Requests `rows` rows of N floats, row q from src(q), k-major: element k
// of row q goes to dst(q) + stride * k.  Warp w takes rows w, w + warps,
// ...; its lanes take k, so each row is read coalesced.
template <typename Src, typename Dst>
__device__ __forceinline__ void request_k_major(Src src, Dst dst, int rows,
                                                int N, int stride, int warp,
                                                int warps, int lane) {
#pragma unroll 1
  for (int q = warp; q < rows; q += warps) {
    const float* s = src(q);
    float* d = dst(q);
#pragma unroll 1
    for (int k = lane; k < N; k += 32)
      cp_async_4(d + (size_t)stride * k, s + k);
  }
}

// --- the step exchange (one thread of the CTA calls each) ---------------

// After `__syncthreads()`: this CTA's rows of the step are written.
__device__ __forceinline__ void publish(unsigned* progress) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(progress)
               : "memory");
}
// A wait that outlasts this many cycles (~4 s) can only be a lost
// producer: trap, so the launch fails instead of holding the card.
constexpr long long kSpinLimit = 1ll << 33;
__device__ __forceinline__ void spin_guard(long long since) {
  if (clock64() - since > kSpinLimit) __trap();
}
__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
// Orders a bulk copy (async proxy) after the acquire that saw the plane,
// and after the generic-proxy writes to shared memory before it.
__device__ __forceinline__ void async_proxy_fence() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
// After the CTA's last wait: count it done; the last CTA of the grid
// resets every counter (`layers` progress counters, then `done`).
__device__ __forceinline__ void finish(unsigned* counters, int layers,
                                       unsigned ctas) {
  unsigned* done = counters + (size_t)layers * kCounterStride;
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(done)
               : "memory");
  if (old + 1 == ctas) {
#pragma unroll 1
    for (int l = 0; l < layers; ++l) counters[(size_t)l * kCounterStride] = 0;
    *done = 0;
  }
}

// --- the f32 operands and dot of K1 and K2 (the dot warps) ---------------

// Shared memory of a CTA that owns R rows of a layer whose rows take
// `fam` weight families (1: W_h; 2: W_h and W_in) and `fam` h planes
// (own h_{t-1}; the layer below's h_t), byte offsets:
//   2 mbarriers (own plane, below plane) | planes [fam][chunks][N][8],
//   each from a 128-byte boundary (K2 measured slower with the planes
//   after the weights, PERF.md) | weights [fam][R][N][4] | gate sums,
//   per family [chunks][splits][R][32] | peep and bias [R][8] | c [R][B]
//   | the step's pre_x rows [R][4][B] | its mask row, as the 4-byte words
//   that hold it
// Threads: one producer warp, then R * splits dot warps (at most 16).
// `splits` (K splits a row) defaults to 8 / R below 8 rows, else 1; K2
// passes its stack's, so every layer group sums in one order.
struct Layout {
  int splits, dot_warps;
  size_t planes, plane, plane_stride, w, part, sums, consts, c, pre, mask,
      total;
};
__host__ __device__ inline Layout layout(int B, int N, int R, int fam,
                                         int splits = 0) {
  Layout L;
  L.splits = splits > 0 ? splits : R < 8 ? 8 / R : 1;
  L.dot_warps = R * L.splits < kMaxDotWarps ? R * L.splits : kMaxDotWarps;
  L.planes = 128;
  L.plane = (size_t)32 * chunks_of(B) * N;
  L.plane_stride = round_up(L.plane, 128);
  L.w = L.planes + fam * L.plane_stride;
  L.part = L.w + (size_t)16 * fam * R * N;
  L.sums = (size_t)4 * chunks_of(B) * L.splits * R * kOut;
  L.consts = L.part + fam * L.sums;
  L.c = L.consts + (size_t)4 * 8 * R;
  L.pre = L.c + (size_t)4 * R * B;
  L.mask = L.pre + (size_t)4 * 4 * R * B;
  L.total = L.mask + round_up(B + 8, 16);
  return L;
}


// v[g * 8 + s] += w[k][g] x[k][s'] over this lane's k (k0, k0 + kstep, ...)
// for one row w ([N][4] in shared memory) and one chunk's plane x ([N][8]),
// where s' = s, or s ^ 4 for a lane with `swap` (it reads the halves of
// x[k] in the other order); `unswap` puts its sums back in stream order.
// Streams past B in a chunk hold no data: their sums are never read.
__device__ __forceinline__ void row_dot(float v[kOut], const float4* w,
                                        const float4* x, int K, int k0,
                                        int kstep, int swap) {
#pragma unroll 1
  for (int k = k0; k < K; k += kstep) {
    const float4 wk = w[k];
    const float4 lo = x[2 * k + swap], hi = x[2 * k + 1 - swap];
    const float wg[4] = {wk.x, wk.y, wk.z, wk.w};
    const float xs[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int s = 0; s < kChunk; ++s)
        v[g * kChunk + s] = fmaf(wg[g], xs[s], v[g * kChunk + s]);
  }
}
__device__ __forceinline__ void unswap(float v[kOut], int swap) {
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float a = v[g * kChunk + s], b = v[g * kChunk + s + 4];
      v[g * kChunk + s] = swap ? b : a;
      v[g * kChunk + s + 4] = swap ? a : b;
    }
}
// The sum over the warp's 32 lanes of v[i], scattered: lane l ends with the
// sum of v[l] in v[0].  A fixed butterfly (16 + 8 + 4 + 2 + 1 shuffles):
// at the level of lane bit M a lane keeps the half of its live sums that
// its bit selects and adds its partner's copy of that half.
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

// One weight family's gate sums against its staged plane (`plane`:
// [chunks][N][8]) for every (row, chunk) that dot warp `dw` owns: `w` is
// the family's [R][N][4] rows; lane l's sum of gate l / 8, stream l % 8
// goes to sums[c][split][r][l].
__device__ __forceinline__ void family_sums(float* sums, const float* w,
                                            const float* plane, int N,
                                            int B, int R, int rows,
                                            const Layout& L, int dw,
                                            int lane) {
  const int split = dw % L.splits, row_step = L.dot_warps / L.splits;
  const int swap = (lane >> 2) & 1;
#pragma unroll 1
  for (int c = 0; c < chunks_of(B); ++c) {
#pragma unroll 1
    for (int r = dw / L.splits; r < rows; r += row_step) {
      float v[kOut];
#pragma unroll
      for (int i = 0; i < kOut; ++i) v[i] = 0.0f;
      row_dot(v, reinterpret_cast<const float4*>(w + (size_t)r * N * 4),
              reinterpret_cast<const float4*>(plane + (size_t)c * N * 8), N,
              lane + 32 * split, 32 * L.splits, swap);
      unswap(v, swap);
      reduce_scatter<kOut / 2>(v, lane);
      sums[((c * L.splits + split) * R + r) * kOut + lane] = v[0];
    }
  }
}
// Row r, stream b, gate g of one family's sums, its splits added in order.
__device__ __forceinline__ float gate_sum(const float* sums, const Layout& L,
                                          int R, int r, int b, int g) {
  const float* s = sums + ((size_t)(b / kChunk) * L.splits * R + r) * kOut +
                   g * kChunk + b % kChunk;
  float sum = s[0];
#pragma unroll 1
  for (int k = 1; k < L.splits; ++k) sum += s[(size_t)k * R * kOut];
  return sum;
}
// Where stream b's value of row n sits in a [chunks][N][8] plane.
__device__ __forceinline__ size_t plane_at(int N, int b, int n) {
  return ((size_t)(b / kChunk) * N + n) * kChunk + b % kChunk;
}

}  // namespace lstm_exchange
