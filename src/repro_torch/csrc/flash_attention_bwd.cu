// K8's backward: FlashAttention-2's dq, dk and dv from the forward's
// log-sum-exp, on the tensor cores of sm_90a.
//
// Replaces no TPU kernel: the reference's training attention
// (`chunked_attention`, src/repro/models/layers.py:222) has a custom VJP
// whose backward `_ca_bwd` (:173) is plain jnp, not Pallas.  This computes
// what `_ca_bwd` computes, with its conventions: s = (q . k) * scale in f32,
// p = exp(s - lse_safe) under the mask (0 elsewhere; lse_safe = 0 where lse
// is NEG_INF, a row that sees no key), dv = p^T do, dp = do v^T,
// ds = p * (dp - delta) * scale, dq = ds k, dk = ds^T q.  delta =
// rowsum(do * o) comes in from the wrapper (one PyTorch expression, as the
// reference computes it in jnp).  The mask of query row i (position
// i + offset) and key j: j < Sk, and j <= i + offset when causal, and
// (i + offset) - j < window when a window is given.  Query head h reads kv
// head h / (H / Hkv); dk and dv sum over the heads of the group.  Inputs f32
// or bf16, sums in f32, outputs in the inputs' type.  There is no kv_len:
// the reference's training path has none.
//
// Deterministic, with no atomic on a gradient, so that a resumed run
// repeats its bits.  Two kernels, each one launch a call:
// * `kv_kernel` writes dk and dv.  A CTA of 4 warps owns a 64-key tile of
//   one kv head; each warp owns 16 keys, whose dK and dV accumulators stay
//   in its registers while the tiles of Q, dO, lse and delta that can see
//   the key tile stream through a 2-stage `cp.async` ring (every query head
//   of the group in turn).  The warp computes the scores transposed, S^T =
//   K Q^T and dP^T = V dO^T, so P^T and dS^T come out of the `mma` in the
//   accumulator layout that the next `mma` takes as its A operand: dV +=
//   P^T dO and dK += dS^T Q with no trip through shared memory.
//   The group split (the wrapper's rule, `attention_bwd_geometry`): where
//   the (key tile, kv head) grid would give under about two CTAs an SM, the
//   grid gains the query head of the group as an axis; each CTA writes an
//   f32 partial dk/dv of its head into scratch (B, H, Sk, D), and the last
//   CTA of each (kv head, key tile), found by an atomic ticket after
//   `__threadfence` (the ticket counts arrivals and touches no gradient;
//   the merging CTA sets it back to 0), sums the partials in head order,
//   whatever order they arrived in.
// * `q_kernel` writes dq.  A CTA of 4 warps owns 64 query rows of one head;
//   each warp 16 rows, whose dQ accumulator stays in its registers while
//   tiles of K and V stream through the ring: S = Q K^T, dP = dO V^T, then
//   dQ += dS K.
// Both recompute s and dp: 14 D flops a valid pair against FA2's 10 D, the
// price of no atomics.  The rule launches the causal grid heaviest first
// (`kv_kernel` from the first key, `q_kernel` from the last query row; the
// `reverse` argument, `tile_rows`), and passes every tile size; this file
// repeats no rule of its own and refuses the sizes it has no kernel for.
//
// Precision (as K8's forward, flash_attention.cu).  bf16: q, k, v and do
// are exact in bf16, so S and dP by `mma.sync.m16n8k16` bf16 -> f32 are
// exact products summed in f32; p and ds are f32 values, each fed to its
// product as hi + lo (two bf16 `mma`s into the same f32 accumulator, lo
// first), ~2^-17 relative error in place of one bf16 rounding (2^-9 on
// every term).  f32: every product by error-compensated 3xTF32
// (`mma.sync.m16n8k8` tf32 -> f32): each operand a = big + small with big =
// tf32(a), small = tf32(a - big) (`cvt.rna`), and a b = a_small b_big +
// a_big b_small + a_big b_big, small terms first: the error is of the order
// of f32 rounding (a single TF32 product would put ~2^-11 on every term).
// Outputs round once, at the end.  The plain mirror of this arithmetic is
// `ref.attention_bwd_mixed_ref`.
//
// Operands.  bf16 tiles (rows padded by 16 bytes) feed `ldmatrix`: A and
// the B of S^T/S (stored n x k) as they lie, the B of dV/dK/dQ (stored
// k x n) through `ldmatrix.trans`.  f32 tiles (rows padded by 4 floats,
// kLd = 4 mod 32) feed plain 32-bit loads, free of bank conflicts in both
// patterns: (row g, column t) for A and an n x k B, and (rows 2t, 2t + 1,
// column g) for a k x n B.  The latter because an accumulator fragment
// holds columns 2t, 2t + 1 of its rows where a tf32 A fragment wants t,
// t + 4: the accumulator is taken as it lies, as the A fragment of a
// product whose k is permuted (k = t <-> column 2t, k = t + 4 <-> 2t + 1),
// and B's rows are read in the same order, so no shuffle is needed.  In
// f32 the streamed tiles, the B operands every warp reads (Q and dO in
// `kv_kernel`, K and V in `q_kernel`), are split once a tile into tf32
// big (in place) and small (a buffer beside them); a warp's own A rows
// are split as they are loaded.  D % 8 != 0 in bf16 (or D % 4 in f32, or
// an unaligned tensor) stages the same tiles synchronously, zero-filled
// (template flag kVec).
//
// Accumulation.  Each product of one tile goes into zeroed registers and
// then into the running dK, dV or dQ by a rounded f32 add; 3xTF32's small
// products of S and dP run in a chain of their own.  The tensor cores'
// accumulation truncates: summed straight into one accumulator over the
// ~1,500 `mma`s of MiniCPM-2B's dK, the bias reached 5.35e-5 of its scale
// (1.9e-6 this way).
//
// Tiles and resources (4 warps a CTA, `__launch_bounds__(128, 2)`: without
// the CTA count ptxas capped some f32 kernels' registers and spilled).
// kv_kernel: 64 keys; streamed query tiles of 64 rows in bf16
// at D <= 64, 32 at D 128 (dK and dV take 128 registers a thread there)
// and 32 in f32.  q_kernel: 64 query rows; key tiles of 64 in bf16, 32 in
// f32.  Registers a thread (`cuobjdump -res-usage`, 16-byte staging) and
// shared memory a CTA: f32 D 64 kv 236 and 87,552 bytes, q 161 and
// 87,040; bf16 D 128 kv 255 with a 64-byte stack of spills and 70,144
// bytes, q 242 and 104,448.  Two CTAs an SM either way.
//
// What bounds it on an H100: operations.  At MiniCPM-2B's training shape
// (B 2, 36 heads, S 4096, D 64, causal, f32) the 604 M valid pairs need
// 8 D flops each in `kv_kernel` and 6 D in `q_kernel`: 309 and 232 GFLOP,
// three TF32 products each: 1.875 and 1.406 ms at 495 TFLOP/s.  At
// Qwen3-14B's (B 1, 40 on 8 heads, S 1024, D 128, causal, bf16) 0.0217 and
// 0.0163 ms at 989 TFLOP/s, where the split gives 640 kv CTAs, not 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // keys of a kv CTA, rows of a q CTA

struct Params {
  const void *q, *k, *v, *dout;   // q, dout (B, H, Sq, D); k, v (B, Hkv, Sk,
                                  // D)
  const float *lse, *delta;       // (B, H, Sq)
  void *dq, *dk, *dv;
  float *dk_part, *dv_part;       // the group split's (B, H, Sk, D) partials
  int* tickets;                   // (B * Hkv, key tiles), zero between
                                  // launches
  int B, H, Hkv, Sq, Sk, D;
  float scale;
  int causal, has_window, window, offset;
  int split;     // kv CTAs a (kv head, key tile): 1 or the GQA group
  int reverse;   // the grid walks its rows from the last (`tile_rows`)
};

// padded row of a tile: 16 bytes past kDMax elements
template <int kDMax, typename T>
constexpr int row_ld() {
  return kDMax + 16 / (int)sizeof(T);
}

// The rows [r0, r0 + n) of grid row y, of n_total: tiles of kRows from row
// 0, or where `reverse` from the last row (tiles end at n_total, n_total -
// kRows, ...; a ragged tile comes last and starts at 0)
__device__ __forceinline__ void tile_rows(int y, int n_total, bool reverse,
                                          int& r0, int& n) {
  if (reverse) {
    const int end = n_total - y * kRows;
    r0 = max(0, end - kRows);
    n = end - r0;
  } else {
    r0 = y * kRows;
    n = min(kRows, n_total - r0);
  }
}

__device__ __forceinline__ bool visible(int pos, int kp, int Sk, bool causal,
                                        bool has_window, int window) {
  return kp < Sk && (!causal || pos >= kp) &&
         (!has_window || pos - kp < window);
}

template <int kN>
__device__ __forceinline__ void zero(float (*c)[4]) {
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.0f;
}

// ------------------------------------------------------------- products
//
// Two products, each for one warp's 16 rows.  `abt`: c = A B^T over kDMax
// (S, dP and their transposes), A the warp's 16 rows of a tile and B the
// kN rows of a shared tile, both as they lie (row-major, stride kLd, zero
// past D).  `xb`: acc += X B, X the warp's 16 x kK accumulator fragments
// (p or ds), B kK rows of a shared tile.  In f32 the shared tile comes
// split into tf32 big (in place) and small (`b_small`, the same layout;
// `split_tile`), once a tile for every warp; A is split as it is loaded.
// `xb` takes X's fragments all at once and sums each 8-column block of
// the output in zeroed registers over the tile's kK, then into acc by a
// rounded f32 add (the header's Accumulation).

template <int kN, int kDMax, int kLd>
__device__ __forceinline__ void abt(float (*c)[4], const __nv_bfloat16* a,
                                    const __nv_bfloat16* b,
                                    const __nv_bfloat16*, int lane) {
#pragma unroll 1
  for (int dc = 0; dc < kDMax / 32; ++dc) {
    uint32_t a0[4], a1[4];
    const __nv_bfloat16* ar = a + (lane & 15) * kLd + dc * 32 +
                              (lane >> 4) * 8;
    ldmatrix_x4(a0, ar);
    ldmatrix_x4(a1, ar + 16);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      uint32_t bk[4];
      ldmatrix_x4(bk, b + (8 * j + (lane & 7)) * kLd + dc * 32 +
                          (lane >> 3) * 8);
      mma_bf16(c[j], a0, bk[0], bk[1]);
      mma_bf16(c[j], a1, bk[2], bk[3]);
    }
  }
}
template <int kN, int kDMax, int kLd>
__device__ __forceinline__ void abt(float (*c)[4], const float* a,
                                    const float* b, const float* b_small,
                                    int lane) {
  const int g = lane >> 2, t = lane & 3;
  float cs[kN / 8][4];   // the small products, a chain of their own
  zero<kN / 8>(cs);
#pragma unroll 2
  for (int kk = 0; kk < kDMax / 8; ++kk) {
    uint32_t a_big[4], a_small[4];
    const float* ar = a + g * kLd + 8 * kk + t;
    split_tf32(ar[0], a_big[0], a_small[0]);
    split_tf32(ar[8 * kLd], a_big[1], a_small[1]);
    split_tf32(ar[4], a_big[2], a_small[2]);
    split_tf32(ar[8 * kLd + 4], a_big[3], a_small[3]);
    const int off = g * kLd + 8 * kk + t;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const float* bb = b + off + 8 * j * kLd;
      const float* bs = b_small + off + 8 * j * kLd;
      const uint32_t b_big[2] = {__float_as_uint(bb[0]),
                                 __float_as_uint(bb[4])};
      const uint32_t b_sm[2] = {__float_as_uint(bs[0]),
                                __float_as_uint(bs[4])};
      mma_tf32(cs[j], a_small, b_big[0], b_big[1]);
      mma_tf32(cs[j], a_big, b_sm[0], b_sm[1]);
      mma_tf32(c[j], a_big, b_big[0], b_big[1]);
    }
  }
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] += cs[j][e];
}

// bf16: X as hi + lo, lo first
template <int kK, int kDMax, int kLd>
__device__ __forceinline__ void xb(float (*acc)[4], const float (*x)[4],
                                   const __nv_bfloat16* b,
                                   const __nv_bfloat16*, int lane) {
  uint32_t hi[kK / 16][4], lo[kK / 16][4];
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk) {
    split_pair(x[2 * kk][0], x[2 * kk][1], hi[kk][0], lo[kk][0]);
    split_pair(x[2 * kk][2], x[2 * kk][3], hi[kk][1], lo[kk][1]);
    split_pair(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[kk][2], lo[kk][2]);
    split_pair(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[kk][3], lo[kk][3]);
  }
  const __nv_bfloat16* br = b + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                            (lane >> 4) * 8;
#pragma unroll
  for (int dn = 0; dn < kDMax / 16; ++dn) {
    float c0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float c1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, br + 16 * kk * kLd + dn * 16);
      mma_bf16(c0, lo[kk], bv[0], bv[1]);
      mma_bf16(c0, hi[kk], bv[0], bv[1]);
      mma_bf16(c1, lo[kk], bv[2], bv[3]);
      mma_bf16(c1, hi[kk], bv[2], bv[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * dn][e] += c0[e];
      acc[2 * dn + 1][e] += c1[e];
    }
  }
}
// f32: 3xTF32, the accumulator taken as the A fragment of a product whose
// k is permuted (k = t <-> column 2t, k = t + 4 <-> 2t + 1), B's rows read
// in the same order
template <int kK, int kDMax, int kLd>
__device__ __forceinline__ void xb(float (*acc)[4], const float (*x)[4],
                                   const float* b, const float* b_small,
                                   int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t a_big[kK / 8][4], a_small[kK / 8][4];
#pragma unroll
  for (int j = 0; j < kK / 8; ++j) {
    split_tf32(x[j][0], a_big[j][0], a_small[j][0]);   // row g, column 2t
    split_tf32(x[j][2], a_big[j][1], a_small[j][1]);   // row g + 8, 2t
    split_tf32(x[j][1], a_big[j][2], a_small[j][2]);   // row g, 2t + 1
    split_tf32(x[j][3], a_big[j][3], a_small[j][3]);   // row g + 8, 2t + 1
  }
  const int off = 2 * t * kLd + g;
#pragma unroll
  for (int n = 0; n < kDMax / 8; ++n) {
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < kK / 8; ++j) {
      const float* bb = b + off + 8 * j * kLd + 8 * n;
      const float* bs = b_small + off + 8 * j * kLd + 8 * n;
      const uint32_t b_big[2] = {__float_as_uint(bb[0]),
                                 __float_as_uint(bb[kLd])};
      const uint32_t b_sm[2] = {__float_as_uint(bs[0]),
                                __float_as_uint(bs[kLd])};
      mma_3xtf32(c, a_big[j], a_small[j], b_big, b_sm);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += c[e];
  }
}

// An f32 tile of n_rows x kDMax (stride kLd) split for the tensor cores:
// big = tf32(x) in place, small = tf32(x - big) into `small`; bf16 tiles
// are used as they lie
template <int kNRows, int kDMax, int kLd>
__device__ __forceinline__ void split_tile(float* big, float* small) {
  constexpr int kQuads = kDMax / 4;
  for (int i = threadIdx.x; i < kNRows * kQuads; i += kThreads) {
    const int at = (i / kQuads) * kLd + (i % kQuads) * 4;
    float4 x = *reinterpret_cast<const float4*>(big + at);
    uint32_t bg[4], sm[4];
    split_tf32(x.x, bg[0], sm[0]);
    split_tf32(x.y, bg[1], sm[1]);
    split_tf32(x.z, bg[2], sm[2]);
    split_tf32(x.w, bg[3], sm[3]);
    *reinterpret_cast<uint4*>(big + at) = make_uint4(bg[0], bg[1], bg[2],
                                                     bg[3]);
    *reinterpret_cast<uint4*>(small + at) = make_uint4(sm[0], sm[1], sm[2],
                                                       sm[3]);
  }
}
template <int kNRows, int kDMax, int kLd>
__device__ __forceinline__ void split_tile(__nv_bfloat16*, __nv_bfloat16*) {}

// The 16 x kDMax accumulators of rows `row0` + g (+ 8) into out (rows of
// length D, n_rows of them), as T.
template <int kDMax, typename T>
__device__ __forceinline__ void write_rows(T* out, const float (*acc)[4],
                                           int row0, int n_rows, int D,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = row0 + g + 8 * (e >> 1);
    if (r >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < kDMax / 8; ++n) {
      const int d = 8 * n + 2 * t + (e & 1);
      if (d < D) store(out + (size_t)r * D + d, acc[n][e]);
    }
  }
}

// -------------------------------------------------------------- dk, dv

template <int kDMax, int kBQ, typename T>
struct KvLayout {
  static constexpr int kLd = row_ld<kDMax, T>();
  static constexpr int kKTile = kRows * kLd, kQTile = kBQ * kLd;
  static constexpr bool kSplit = sizeof(T) == 4;   // f32: tf32 big + small
  // K V | stage s: Q at 2s, dO at 2s + 1 | f32: the small parts of the
  // current Q and dO | stage s: lse at 2s, delta at 2s + 1
  static constexpr size_t kRowsOff =
      sizeof(T) * (2 * (size_t)kKTile + (kSplit ? 6 : 4) * (size_t)kQTile);
  static constexpr size_t kBytes = kRowsOff + 4 * 4 * (size_t)kBQ;
};

// grid (B * Hkv * split, key tiles)
template <int kDMax, int kBQ, bool kVec, typename T>
__global__ void __launch_bounds__(kThreads, 2) kv_kernel(const Params p) {
  using L = KvLayout<kDMax, kBQ, T>;
  constexpr int kLd = L::kLd;
  extern __shared__ uint4 kv_smem[];
  T* k_s = reinterpret_cast<T*>(kv_smem);
  T* v_s = k_s + L::kKTile;
  T* ring = v_s + L::kKTile;
  T* small_s = ring + 4 * L::kQTile;   // f32 only
  float* rows_s = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(kv_smem) + L::kRowsOff);
  __shared__ int last;

  const T* q = static_cast<const T*>(p.q);
  const T* dout = static_cast<const T*>(p.dout);
  const int bkv = blockIdx.x / p.split, hs = blockIdx.x % p.split;
  const int b = bkv / p.Hkv, kvh = bkv % p.Hkv, group = p.H / p.Hkv;
  int k0, n_k;
  tile_rows(blockIdx.y, p.Sk, p.reverse != 0, k0, n_k);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool causal = p.causal != 0, has_window = p.has_window != 0;

  // the query rows that may see a key of this tile (a superset), in tiles
  // of kBQ, for each query head of the CTA
  const int q_lo = causal ? max(0, k0 - p.offset) : 0;
  const int q_hi = has_window ? min(p.Sq, k0 + n_k - 1 + p.window - p.offset)
                              : p.Sq;
  const int n_qt = q_hi > q_lo ? (q_hi - q_lo + kBQ - 1) / kBQ : 0;
  const int h0 = kvh * group + (p.split > 1 ? hs : 0);
  const int n_items = (p.split > 1 ? 1 : group) * n_qt;
  auto head = [&](int it) { return (size_t)b * p.H + h0 + it / n_qt; };
  auto row0 = [&](int it) { return q_lo + (it % n_qt) * kBQ; };

  auto load_item = [&](int it) {
    const size_t bh = head(it);
    const int q0 = row0(it), n_q = min(kBQ, p.Sq - q0);
    T* dst = ring + 2 * (it & 1) * L::kQTile;
    load_tile<kDMax, kVec, kThreads>(dst, kLd, q + (bh * p.Sq + q0) * p.D,
                                     kBQ, n_q, p.D);
    load_tile<kDMax, kVec, kThreads>(dst + L::kQTile, kLd,
                                     dout + (bh * p.Sq + q0) * p.D, kBQ, n_q,
                                     p.D);
    float* r = rows_s + 2 * (it & 1) * kBQ;
    for (int i = threadIdx.x; i < 2 * kBQ; i += kThreads) {
      const int row = i % kBQ;
      const float* src = (i < kBQ ? p.lse : p.delta) + bh * p.Sq + q0 + row;
      cp_async_4(r + i, row < n_q ? src : p.lse, row < n_q ? 4 : 0);
    }
  };
  load_tile<kDMax, kVec, kThreads>(
      k_s, kLd, static_cast<const T*>(p.k) + ((size_t)bkv * p.Sk + k0) * p.D,
      kRows, n_k, p.D);
  load_tile<kDMax, kVec, kThreads>(
      v_s, kLd, static_cast<const T*>(p.v) + ((size_t)bkv * p.Sk + k0) * p.D,
      kRows, n_k, p.D);
  if (n_items > 0) load_item(0);
  cp_async_commit();

  float dk_acc[kDMax / 8][4], dv_acc[kDMax / 8][4];
  zero<kDMax / 8>(dk_acc);
  zero<kDMax / 8>(dv_acc);
  const int key0 = k0 + warp * 16;   // the warp's keys: key0 + g (+ 8)
  const float scale2 = p.scale * kLog2e;   // p = 2^(s scale2 - lse log2 e)
  const int key_last = min(key0 + 15, p.Sk - 1);

  for (int it = 0; it < n_items; ++it) {
    if (it + 1 < n_items) load_item(it + 1);
    cp_async_commit();
    cp_async_wait<1>();   // everything but item it + 1 has landed
    __syncthreads();
    T* q_t = ring + 2 * (it & 1) * L::kQTile;
    T* do_t = q_t + L::kQTile;
    if constexpr (L::kSplit) {
      split_tile<kBQ, kDMax, kLd>(q_t, small_s);
      split_tile<kBQ, kDMax, kLd>(do_t, small_s + L::kQTile);
      __syncthreads();
    }
    const float* lse_t = rows_s + 2 * (it & 1) * kBQ;
    const float* delta_t = lse_t + kBQ;
    const int q0 = row0(it), n_q = min(kBQ, p.Sq - q0);
    const int pos_lo = q0 + p.offset, pos_hi = q0 + n_q - 1 + p.offset;
    // some pair of the warp's keys and the tile's rows is visible; every
    // pair is
    const bool any = key0 < p.Sk && (!causal || pos_hi >= key0) &&
                     (!has_window || pos_lo - key_last < p.window);
    const bool full = key0 + 15 < p.Sk && n_q == kBQ &&
                      (!causal || pos_lo >= key0 + 15) &&
                      (!has_window || pos_hi - key0 < p.window);
    if (any) {
      float s[kBQ / 8][4], dp[kBQ / 8][4];
      zero<kBQ / 8>(s);
      zero<kBQ / 8>(dp);
      abt<kBQ, kDMax, kLd>(s, k_s + warp * 16 * kLd, q_t, small_s,
                           lane);                                     // S^T
      abt<kBQ, kDMax, kLd>(dp, v_s + warp * 16 * kLd, do_t,
                           small_s + L::kQTile, lane);               // dP^T
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int r = 8 * j + 2 * t + c;   // the tile's query row
          const float l = lse_t[r] == kNegInf ? 0.0f : lse_t[r] * kLog2e;
          const float dl = delta_t[r];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 2 * i + c;
            const bool ok = full || (r < n_q &&
                                     visible(pos_lo + r, key0 + g + 8 * i,
                                             p.Sk, causal, has_window,
                                             p.window));
            const float pv = ok ? exp2f(s[j][e] * scale2 - l) : 0.0f;
            s[j][e] = pv;
            dp[j][e] = pv * (dp[j][e] - dl) * p.scale;   // dS^T
          }
        }
      xb<kBQ, kDMax, kLd>(dv_acc, s, do_t, small_s + L::kQTile, lane);
      xb<kBQ, kDMax, kLd>(dk_acc, dp, q_t, small_s, lane);
    }
    __syncthreads();   // before the next load overwrites this stage
  }
  cp_async_wait<0>();

  const size_t kv_row = (size_t)bkv * p.Sk + k0;
  if (p.split == 1) {
    write_rows<kDMax>(static_cast<T*>(p.dk) + kv_row * p.D, dk_acc,
                      warp * 16, n_k, p.D, lane);
    write_rows<kDMax>(static_cast<T*>(p.dv) + kv_row * p.D, dv_acc,
                      warp * 16, n_k, p.D, lane);
    return;
  }
  // the group split: this head's partial, then the last CTA of the (kv
  // head, key tile) sums every head's in head order
  const size_t part_row = ((size_t)b * p.H + h0) * p.Sk + k0;
  write_rows<kDMax>(p.dk_part + part_row * p.D, dk_acc, warp * 16, n_k, p.D,
                    lane);
  write_rows<kDMax>(p.dv_part + part_row * p.D, dv_acc, warp * 16, n_k, p.D,
                    lane);
  __threadfence();
  __syncthreads();
  int* ticket = p.tickets + (size_t)bkv * gridDim.y + blockIdx.y;
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == p.split - 1;
  __syncthreads();
  if (!last) return;
  if (threadIdx.x == 0) *ticket = 0;   // every head has counted: reuse it
  __threadfence();
  const size_t head_stride = (size_t)p.Sk * p.D;
  const size_t first = (((size_t)b * p.H + kvh * group) * p.Sk + k0) * p.D;
  for (int i = threadIdx.x; i < n_k * p.D; i += kThreads) {
    float sk = 0.0f, sv = 0.0f;
    for (int h = 0; h < group; ++h) {
      sk += __ldcg(p.dk_part + first + h * head_stride + i);
      sv += __ldcg(p.dv_part + first + h * head_stride + i);
    }
    store(static_cast<T*>(p.dk) + kv_row * p.D + i, sk);
    store(static_cast<T*>(p.dv) + kv_row * p.D + i, sv);
  }
}

// ------------------------------------------------------------------- dq

template <int kDMax, int kBK, typename T>
struct QLayout {
  static constexpr int kLd = row_ld<kDMax, T>();
  static constexpr int kQTile = kRows * kLd, kKTile = kBK * kLd;
  static constexpr bool kSplit = sizeof(T) == 4;   // f32: tf32 big + small
  // Q dO | stage s: K at 2s, V at 2s + 1 | f32: the small parts of the
  // current K and V
  static constexpr size_t kBytes =
      sizeof(T) * (2 * (size_t)kQTile + (kSplit ? 6 : 4) * (size_t)kKTile);
};

// grid (B * H, query tiles)
template <int kDMax, int kBK, bool kVec, typename T>
__global__ void __launch_bounds__(kThreads, 2) q_kernel(const Params p) {
  using L = QLayout<kDMax, kBK, T>;
  constexpr int kLd = L::kLd;
  extern __shared__ uint4 q_smem[];
  T* q_s = reinterpret_cast<T*>(q_smem);
  T* do_s = q_s + L::kQTile;
  T* ring = do_s + L::kQTile;
  T* small_s = ring + 4 * L::kKTile;   // f32 only

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int bkv = b * p.Hkv + h / (p.H / p.Hkv);
  int q0, n_q;
  tile_rows(blockIdx.y, p.Sq, p.reverse != 0, q0, n_q);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool causal = p.causal != 0, has_window = p.has_window != 0;
  const T* k_h = static_cast<const T*>(p.k) + (size_t)bkv * p.Sk * p.D;
  const T* v_h = static_cast<const T*>(p.v) + (size_t)bkv * p.Sk * p.D;

  // the keys any row of this tile may see (a superset of the mask's)
  const int pos_lo = q0 + p.offset, pos_hi = q0 + n_q - 1 + p.offset;
  const int k_end = causal ? min(p.Sk, pos_hi + 1) : p.Sk;
  const int k_begin = has_window ? max(0, pos_lo - p.window + 1) : 0;
  const int n_kt = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  auto load_kv = [&](int it) {
    const int k0 = k_begin + it * kBK, n_k = min(kBK, p.Sk - k0);
    T* dst = ring + 2 * (it & 1) * L::kKTile;
    load_tile<kDMax, kVec, kThreads>(dst, kLd, k_h + (size_t)k0 * p.D, kBK,
                                     n_k, p.D);
    load_tile<kDMax, kVec, kThreads>(dst + L::kKTile, kLd,
                                     v_h + (size_t)k0 * p.D, kBK, n_k, p.D);
  };
  const size_t q_row = (size_t)bh * p.Sq + q0;
  load_tile<kDMax, kVec, kThreads>(q_s, kLd,
                                   static_cast<const T*>(p.q) + q_row * p.D,
                                   kRows, n_q, p.D);
  load_tile<kDMax, kVec, kThreads>(do_s, kLd,
                                   static_cast<const T*>(p.dout) +
                                       q_row * p.D,
                                   kRows, n_q, p.D);
  if (n_kt > 0) load_kv(0);
  cp_async_commit();

  // the thread's rows warp * 16 + g and + 8: lse_safe and delta (0 past n_q)
  const int r0 = warp * 16 + g;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const float l = r < n_q ? p.lse[q_row + r] : 0.0f;
    lse_r[i] = l == kNegInf ? 0.0f : l * kLog2e;   // in the base-2 domain
    delta_r[i] = r < n_q ? p.delta[q_row + r] : 0.0f;
  }
  const float scale2 = p.scale * kLog2e;   // p = 2^(s scale2 - lse log2 e)
  const int w_lo = pos_lo + warp * 16;   // the warp's first row's position
  const int w_hi = min(pos_lo + warp * 16 + 15, pos_hi);

  float acc[kDMax / 8][4];
  zero<kDMax / 8>(acc);
  for (int it = 0; it < n_kt; ++it) {
    if (it + 1 < n_kt) load_kv(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    T* k_t = ring + 2 * (it & 1) * L::kKTile;
    T* v_t = k_t + L::kKTile;
    if constexpr (L::kSplit) {
      split_tile<kBK, kDMax, kLd>(k_t, small_s);
      split_tile<kBK, kDMax, kLd>(v_t, small_s + L::kKTile);
      __syncthreads();
    }
    const int k0 = k_begin + it * kBK, n_k = min(kBK, p.Sk - k0);
    const int k_last = k0 + n_k - 1;
    const bool any = warp * 16 < n_q && (!causal || w_hi >= k0) &&
                     (!has_window || w_lo - k_last < p.window);
    const bool full = warp * 16 + 15 < n_q && n_k == kBK &&
                      (!causal || w_lo >= k_last) &&
                      (!has_window || w_hi - k0 < p.window);
    if (any) {
      float s[kBK / 8][4], dp[kBK / 8][4];
      zero<kBK / 8>(s);
      zero<kBK / 8>(dp);
      abt<kBK, kDMax, kLd>(s, q_s + warp * 16 * kLd, k_t, small_s, lane);
      abt<kBK, kDMax, kLd>(dp, do_s + warp * 16 * kLd, v_t,
                           small_s + L::kKTile, lane);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, r = r0 + 8 * i;
          const bool ok = full || (r < n_q && visible(pos_lo + r,
                                                      k0 + 8 * j + 2 * t +
                                                          (e & 1),
                                                      p.Sk, causal,
                                                      has_window, p.window));
          const float pv = ok ? exp2f(s[j][e] * scale2 - lse_r[i]) : 0.0f;
          s[j][e] = pv * (dp[j][e] - delta_r[i]) * p.scale;   // dS
        }
      xb<kBK, kDMax, kLd>(acc, s, k_t, small_s, lane);
    }
    __syncthreads();   // before the next load overwrites this stage
  }
  cp_async_wait<0>();
  write_rows<kDMax>(static_cast<T*>(p.dq) + q_row * p.D, acc, warp * 16,
                    n_q, p.D, lane);
}

// ---------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;   // above only by opting in
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The tile sizes there are kernels for: kv_kernel's query rows a streamed
// tile, q_kernel's keys (32 in f32, whose split operands double the
// streamed tiles' shared memory; 32 rows at D 128, where dK and dV take
// 128 registers)
template <int kDMax, typename T>
constexpr int kv_rows() {
  return sizeof(T) == 4 || kDMax == 128 ? 32 : 64;
}
template <typename T>
constexpr int q_keys() {
  return sizeof(T) == 4 ? 32 : 64;
}

template <int kDMax, bool kVec, typename T>
int launch_kv(const Params& a, int tiles, cudaStream_t stream) {
  constexpr int kBQ = kv_rows<kDMax, T>();
  auto kernel = kv_kernel<kDMax, kBQ, kVec, T>;
  const size_t smem = KvLayout<kDMax, kBQ, T>::kBytes;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.B * a.Hkv * a.split, tiles);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int kDMax, bool kVec, typename T>
int launch_q(const Params& a, int tiles, cudaStream_t stream) {
  auto kernel = q_kernel<kDMax, q_keys<T>(), kVec, T>;
  const size_t smem = QLayout<kDMax, q_keys<T>(), T>::kBytes;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.B * a.H, tiles);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kKv, int kDMax, typename T>
int launch_vec(const Params& a, int vec, int tiles, cudaStream_t stream) {
  if (kKv)
    return vec ? launch_kv<kDMax, true, T>(a, tiles, stream)
               : launch_kv<kDMax, false, T>(a, tiles, stream);
  return vec ? launch_q<kDMax, true, T>(a, tiles, stream)
             : launch_q<kDMax, false, T>(a, tiles, stream);
}

// The geometry the wrapper's rule gave: d_tile (D padded: 32, 64 or 128),
// warps a CTA, the streamed tile's rows (kv: query rows; q: keys), tiles
// (the grid's y), split (kv: CTAs a (kv head, key tile)), reverse.
template <bool kKv, typename T>
int launch(int device, const Params& a, int vec, int d_tile, int warps,
           int rows, int tiles, cudaStream_t stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (warps != kWarps || a.D > d_tile || tiles < 1 ||
      (kKv && a.split != 1 && a.split != a.H / a.Hkv))
    return cudaErrorInvalidValue;
  if (d_tile == 32 && rows == (kKv ? kv_rows<32, T>() : q_keys<T>()))
    return launch_vec<kKv, 32, T>(a, vec, tiles, stream);
  if (d_tile == 64 && rows == (kKv ? kv_rows<64, T>() : q_keys<T>()))
    return launch_vec<kKv, 64, T>(a, vec, tiles, stream);
  if (d_tile == 128 && rows == (kKv ? kv_rows<128, T>() : q_keys<T>()))
    return launch_vec<kKv, 128, T>(a, vec, tiles, stream);
  return cudaErrorInvalidValue;
}

template <bool kKv>
int launch_dtype(int device, const Params& a, int bf16, int vec, int d_tile,
                 int warps, int rows, int tiles, void* stream) {
  if (bf16)
    return launch<kKv, __nv_bfloat16>(device, a, vec, d_tile, warps, rows,
                                      tiles, (cudaStream_t)stream);
  return launch<kKv, float>(device, a, vec, d_tile, warps, rows, tiles,
                            (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// q, dout (B, H, Sq, D); k, v (B, Hkv, Sk, D); lse, delta (B, H, Sq) f32.
// bf16: 0 for f32 tensors, 1 for bf16 ones; vec: D a multiple of 16 bytes
// and every tensor 16-byte aligned.  window: only read when has_window.
// Writes dk and dv (B, Hkv, Sk, D).  split > 1 (the GQA group): dk_part and
// dv_part (B, H, Sk, D) f32 scratch and B * Hkv * tiles int32 tickets,
// zero before the launch and after it; null otherwise.
int flash_attention_bwd_kv_launch(int device, const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, void* dk_part,
                                  void* dv_part, void* tickets, int B, int H,
                                  int Hkv, int Sq, int Sk, int D, float scale,
                                  int causal, int has_window, int window,
                                  int offset, int bf16, int vec, int d_tile,
                                  int warps, int rows, int tiles, int split,
                                  int reverse, void* stream) {
  if (split > 1 && (dk_part == nullptr || dv_part == nullptr ||
                    tickets == nullptr))
    return cudaErrorInvalidValue;
  const Params a{q,       k,       v,        dout,  (const float*)lse,
                 (const float*)delta, nullptr, dk,  dv,
                 (float*)dk_part, (float*)dv_part, (int*)tickets, B, H, Hkv,
                 Sq, Sk, D, scale, causal, has_window, window, offset, split,
                 reverse};
  return launch_dtype<true>(device, a, bf16, vec, d_tile, warps, rows, tiles,
                            stream);
}

// The same inputs; writes dq (B, H, Sq, D).  rows: keys a streamed tile.
int flash_attention_bwd_q_launch(int device, const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq,
                                 int B, int H, int Hkv, int Sq, int Sk, int D,
                                 float scale, int causal, int has_window,
                                 int window, int offset, int bf16, int vec,
                                 int d_tile, int warps, int rows, int tiles,
                                 int reverse, void* stream) {
  const Params a{q,       k,       v,       dout,    (const float*)lse,
                 (const float*)delta, dq,  nullptr, nullptr, nullptr,
                 nullptr, nullptr, B, H, Hkv, Sq, Sk, D, scale, causal,
                 has_window, window, offset, 1, reverse};
  return launch_dtype<false>(device, a, bf16, vec, d_tile, warps, rows,
                             tiles, stream);
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
