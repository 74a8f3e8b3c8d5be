// K8: blockwise online-softmax attention (flash style) with causal masking,
// a sliding window, a key-length bound, a query offset and GQA, for sm_90a.
//
// Replaces the TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention/kernel.py, with its semantics kept
// exactly: scores s = (q . k) * scale in f32, masked scores NEG_INF = -1e30
// (not -inf), the running max made safe (`m_safe` = 0 while the max is still
// NEG_INF) and `alpha` = 0 for a row that has seen no valid key, p zeroed
// under the mask, and a row with no valid key written as 0 (`l_safe`).  The
// mask of query row i (absolute position i + offset) and key j: j < kv_len,
// and j <= i + offset when causal, and (i + offset) - j < window when a
// window is given (also without causal).  Query head h reads kv head
// h / (H / Hkv).  Inputs f32 or bf16; softmax and sums in f32; output in
// the inputs' type.  Its public op is `mha`.
//
// What bounds it on an H100: operations for a prefill.  At Mixtral 8x22B's
// shape (H = 48, Hkv = 8, D = 128, Sq = Sk = 8192, window 4096, causal) the
// 25.2 M valid (query, key) pairs of a head need 4 D flops each, 619 GFLOP:
// 0.63 ms at the 989 TFLOP/s of the bf16 tensor cores, 9.2 ms of f32
// arithmetic at 67 TFLOP/s.  A decode row (Sq = 1) is bound by the bytes of
// its cache window (16.8 MB in bf16, 5 us).
//
// Three schedules, one launch per call (the wrapper picks by
// `attention_geometry`):
//
// * bf16 prefill (`tc::kernel`), FlashAttention-2's shape on the tensor
//   cores.  One CTA per (batch x head, 64- or 128-row query tile: 128 where
//   the grid still gives every SM two CTAs, which halves the K/V traffic a
//   query row costs), 4 or 8 warps; each warp owns 16 query rows, whose Q
//   fragments stay in registers for the whole key loop.  64-key tiles of K
//   and V stay bf16 in shared memory (rows padded by 16 bytes, so
//   `ldmatrix` is conflict-free) and go through a 2-stage `cp.async`
//   ring: tile j + 1 loads while tile j computes.
//   S = Q K^T by `mma.sync.m16n8k16` bf16 -> f32 (products of bf16 values
//   are exact in f32; only the order of the sum changes); scale and mask on
//   the f32 accumulator fragment; the online softmax in f32, in the base-2
//   domain, row maxima reduced over the 4 threads of a quad.  P V: p is NOT
//   rounded to bf16 alone (the reference sums p v in f32, and one bf16
//   rounding of p would put ~2^-9 relative error on every term): p = p_hi +
//   p_lo, two bf16 values with ~16 significant bits, go into the same f32
//   accumulator by two `mma`s (V is exact in bf16), so 1.5x the mma work of
//   a plain FA2 leaves ~2^-17 relative error.  Rows that are not 16-byte
//   aligned (D % 8 != 0) take zero-filled synchronous staging into the same
//   layout (template flag kVec); ragged Sq and Sk tails are zero-filled by
//   `cp.async`'s source size.
// * f32 prefill (`flash_attention_kernel`), on the CUDA cores: one CTA of
//   256 threads per (batch x head, 64-row query tile), the query tile in
//   shared memory (transposed) and 64-key tiles of K (transposed) and V
//   streamed through it; thread (ty, tx) of a 16 x 16 grid owns rows
//   4 ty .. 4 ty + 3, keys tx + 16 j and output columns tx + 16 c.
// * decode and short Sq (`split::kernel`, flash-decoding), both dtypes, when
//   the tiled grid would fill fewer CTAs than the card has SMs and the
//   packed rows (Sq x GQA group) fit one CTA.  One CTA serves every query
//   head of one kv head, so each K/V byte is read once per kv head, not once
//   per query head; the live key range (after the window and kv_len) is cut
//   into n_splits ranges of whole 64-key tiles, up to two CTAs an SM.  Each
//   CTA streams 16 KB tiles of K and V through a 2-stage `cp.async` ring
//   (16-byte copies), computes in f32 on the CUDA cores (8 or 32 packed
//   rows, a template constant, so every per-thread row loop unrolls without
//   a branch: rows past Sq x group compute on zeros and are never written),
//   and writes a partial (m, l, acc) to f32 scratch; the last CTA of each
//   kv head to finish (an atomic ticket after `__threadfence`) merges them
//   in the same launch: m = max m_s, each partial weighted by
//   exp(m_s - m_safe) (0 where m_s is NEG_INF), l_safe as above.
//
// In every schedule, key tiles that the mask empties for a whole query tile
// are skipped, which is exact: such a tile would leave m, l and the
// accumulator unchanged (alpha = 1 or all zero).
//
// Training: both tiled schedules also write each row's log-sum-exp (f32,
// (B, H, Sq)) when given an `lse` pointer, with the reference's
// conventions (`_attn_fwd_scan`): lse = m + log(l), NEG_INF for a row that
// sees no key.  The backward (`flash_attention_bwd.cu`) recomputes p from
// it.  A null pointer writes nothing and changes nothing else; the split
// schedule takes none (the wrapper runs training on the tiled ones).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "clock_stamps.cuh"
#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64, kBK = 64, kThreads = 256;
constexpr int kRowsPerThread = kBQ / 16, kKeysPerThread = kBK / 16;
constexpr int kBQP = kBQ + 4;   // padded row of the transposed q and p tiles

template <int kDMax>
size_t smem_floats() {
  // q_t [kDMax][kBQP] | k_t [kDMax][kBK] | v_s [kBK][kDMax] | p_t [kBK][kBQP]
  return (size_t)kDMax * kBQP + (size_t)kDMax * kBK + (size_t)kBK * kDMax +
         (size_t)kBK * kBQP;
}

// Four consecutive elements at p, of which the first `n` exist (zero
// after); one vector load when `vec` (then p is aligned to 4 elements).
__device__ __forceinline__ void load4(const float* p, int n, bool vec,
                                      float o[4]) {
  if (vec && n == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = t.x, o[1] = t.y, o[2] = t.z, o[3] = t.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = i < n ? __ldg(p + i) : 0.0f;
}

// Rows [0, n_rows) of src (row length D) into dst, zero-filled to kRows x
// kDMax: transposed (dst[d * ld + r]) or as they lie (dst[r * ld + d]).
template <int kRows, int kDMax, bool kTranspose, typename T>
__device__ __forceinline__ void stage(const T* src, int n_rows, int D,
                                      bool vec, float* dst, int ld) {
  for (int i = threadIdx.x; i < kRows * (kDMax / 4); i += kThreads) {
    // transposed: rows fastest over the threads, so the scattered shared
    // stores of a warp fall on consecutive words
    const int r = kTranspose ? i % kRows : i / (kDMax / 4);
    const int d = 4 * (kTranspose ? i / kRows : i % (kDMax / 4));
    float o[4];
    const int n = r < n_rows ? max(0, min(4, D - d)) : 0;
    load4(src + (size_t)(r < n_rows ? r : 0) * D + (n ? d : 0), n, vec, o);
    if (kTranspose) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[(d + e) * ld + r] = o[e];
    } else {
      *reinterpret_cast<float4*>(dst + r * ld + d) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

template <int kDMax, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q,    // (B, H, Sq, D)
                       const T* __restrict__ k,    // (B, Hkv, Sk, D)
                       const T* __restrict__ v,    // (B, Hkv, Sk, D)
                       T* __restrict__ out,        // (B, H, Sq, D)
                       float* __restrict__ lse,    // (B, H, Sq) or null
                       int H, int Hkv, int Sq, int Sk, int D, float scale,
                       bool causal, bool has_window, int window, int kv_len,
                       int offset, bool vec) {
  extern __shared__ float smem[];
  float* q_t = smem;
  float* k_t = q_t + kDMax * kBQP;
  float* v_s = k_t + kDMax * kBK;
  float* p_t = v_s + kBK * kDMax;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = b * Hkv + h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n_q = min(kBQ, Sq - q0);
  const T* q_bh = q + ((size_t)bh * Sq + q0) * D;
  const T* k_h = k + (size_t)kvh * Sk * D;
  const T* v_h = v + (size_t)kvh * Sk * D;

  // the keys any row of this tile may see (a superset of the mask's)
  const int pos_lo = q0 + offset, pos_hi = q0 + n_q - 1 + offset;
  int k_end = min(Sk, kv_len);
  if (causal) k_end = min(k_end, pos_hi + 1);
  int k_begin = has_window ? max(0, pos_lo - window + 1) : 0;
  k_begin = k_begin / kBK * kBK;

  stage<kBQ, kDMax, true>(q_bh, n_q, D, vec, q_t, kBQP);

  float m[kRowsPerThread], l[kRowsPerThread];
  float acc[kRowsPerThread][kDMax / 16];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf, l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kDMax / 16; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    const int n_k = min(kBK, Sk - k0);
    stage<kBK, kDMax, true>(k_h + (size_t)k0 * D, n_k, D, vec, k_t, kBK);
    stage<kBK, kDMax, false>(v_h + (size_t)k0 * D, n_k, D, vec, v_s, kDMax);
    __syncthreads();

    float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(q_t + d * kBQP +
                                                         4 * ty);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const float kv = k_t[d * kBK + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          s[i][j] = fmaf(qr[i], kv, s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int pos = q0 + 4 * ty + i + offset;
      bool valid[kKeysPerThread];
      float m_cur = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int kp = k0 + tx + 16 * j;
        valid[j] = kp < kv_len && kp < Sk && (!causal || pos >= kp) &&
                   (!has_window || pos - kp < window);
        s[i][j] = valid[j] ? s[i][j] * scale : kNegInf;
        m_cur = fmaxf(m_cur, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, off));
      const float m_new = fmaxf(m[i], m_cur);
      const float m_safe = m_new == kNegInf ? 0.0f : m_new;
      float p_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        s[i][j] = valid[j] ? expf(s[i][j] - m_safe) : 0.0f;   // now p
        p_sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        p_sum += __shfl_xor_sync(0xffffffffu, p_sum, off);
      const float alpha = m[i] == kNegInf ? 0.0f : expf(m[i] - m_safe);
      l[i] = alpha * l[i] + p_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDMax / 16; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j)
      *reinterpret_cast<float4*>(p_t + (tx + 16 * j) * kBQP + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < n_k; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(p_t + j * kBQP +
                                                         4 * ty);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int c = 0; c < kDMax / 16; ++c) {
        const float vv = v_s[j * kDMax + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          acc[i][c] = fmaf(pr[i], vv, acc[i][c]);
      }
    }
    __syncthreads();   // before the next tile overwrites k_t, v_s, p_t
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = 4 * ty + i;
    if (r >= n_q) continue;
    const float l_safe = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int c = 0; c < kDMax / 16; ++c) {
      const int d = tx + 16 * c;
      if (d < D) store(out + ((size_t)bh * Sq + q0 + r) * D + d,
                       acc[i][c] / l_safe);
    }
    // m and l are the same in the 16 threads of the row
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * Sq + q0 + r] =
          l[i] == 0.0f ? kNegInf : m[i] + logf(l[i]);
  }
}


// ---------------------------------------------------------------- helpers

// Whether query position `pos` sees key `kp` (kp < kv_end folds kv_len and
// the end of the key range the caller walks).
__device__ __forceinline__ bool visible(int pos, int kp, int kv_end,
                                        bool causal, bool has_window,
                                        int window) {
  return kp < kv_end && (!causal || pos >= kp) &&
         (!has_window || pos - kp < window);
}

// ------------------------------------------------- bf16 tensor-core prefill
namespace tc {

constexpr int kBK = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// kBQ query rows a CTA (64 or 128), one warp per 16
template <int kDMax, int kBQ>
struct Layout {
  static constexpr int kThreads = 2 * kBQ;
  static constexpr int kLd = kDMax + 8;      // bf16 per smem row (+16 bytes)
  static constexpr int kQTile = kBQ * kLd, kTile = kBK * kLd;
  // Q | K0 V0 | K1 V1
  static constexpr size_t kBytes = 2 * ((size_t)kQTile + 4 * kTile);
};

template <int kDMax, bool kVec, int kBQ>
__global__ void __launch_bounds__(Layout<kDMax, kBQ>::kThreads)
kernel(const __nv_bfloat16* __restrict__ q,   // (B, H, Sq, D)
       const __nv_bfloat16* __restrict__ k,   // (B, Hkv, Sk, D)
       const __nv_bfloat16* __restrict__ v,   // (B, Hkv, Sk, D)
       __nv_bfloat16* __restrict__ out,       // (B, H, Sq, D)
       float* __restrict__ lse,               // (B, H, Sq) or null
       int H, int Hkv, int Sq, int Sk, int D, float scale, bool causal,
       bool has_window, int window, int kv_len, int offset) {
  using L = Layout<kDMax, kBQ>;
  constexpr int kLd = L::kLd, kThreads = L::kThreads;
  extern __shared__ uint4 tc_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* kv_s = q_s + L::kQTile;   // stage s: K at 2s, V at 2s + 1

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = b * Hkv + h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_q = min(kBQ, Sq - q0);
  const __nv_bfloat16* k_h = k + (size_t)kvh * Sk * D;
  const __nv_bfloat16* v_h = v + (size_t)kvh * Sk * D;

  // the keys any row of this tile may see (a superset of the mask's)
  const int pos_lo = q0 + offset, pos_hi = q0 + n_q - 1 + offset;
  int k_end = min(Sk, kv_len);
  if (causal) k_end = min(k_end, pos_hi + 1);
  int k_begin = has_window ? max(0, pos_lo - window + 1) : 0;
  k_begin = k_begin / kBK * kBK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK
                                      : 0;

  auto load_kv = [&](int it) {
    const int k0 = k_begin + it * kBK, n_k = min(kBK, Sk - k0);
    __nv_bfloat16* dst = kv_s + 2 * (it & 1) * L::kTile;
    load_tile<kDMax, kVec, kThreads>(dst, kLd, k_h + (size_t)k0 * D, kBK,
                                     n_k, D);
    load_tile<kDMax, kVec, kThreads>(dst + L::kTile, kLd,
                                     v_h + (size_t)k0 * D, kBK, n_k, D);
  };
  load_tile<kDMax, kVec, kThreads>(q_s, kLd, q + ((size_t)bh * Sq + q0) * D,
                                   kBQ, n_q, D);
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  const float scale2 = scale * kLog2e;   // softmax in the base-2 domain
  const int pos0 = q0 + warp * 16 + g + offset;   // rows g and g + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[kDMax / 8][4];
#pragma unroll
  for (int n = 0; n < kDMax / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  uint32_t qf[kDMax / 16][4];
  // debug builds: cycles issuing the next tile and waiting for this one
  // (0), computing S and the softmax (1), P V (2)
  Clock clk;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_kv(it + 1);
    cp_async_commit();
    cp_async_wait<1>();   // everything but tile it + 1 has landed
    __syncthreads();
    clk.lap(0);
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < kDMax / 16; ++kk)
        ldmatrix_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * kLd +
                                kk * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* k_t = kv_s + 2 * (it & 1) * L::kTile;
    const __nv_bfloat16* v_t = k_t + L::kTile;
    const int k0 = k_begin + it * kBK;

    // S = Q K^T: key block j (8 keys) x 32 d per ldmatrix
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int dc = 0; dc < kDMax / 32; ++dc)
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        uint32_t bk[4];
        ldmatrix_x4(bk, k_t + (8 * j + (lane & 7)) * kLd + dc * 32 +
                            (lane >> 3) * 8);
        mma_bf16(s[j], qf[2 * dc], bk[0], bk[1]);
        mma_bf16(s[j], qf[2 * dc + 1], bk[2], bk[3]);
      }

    // scale and mask on the accumulator fragment; a tile that every row of
    // the CTA sees whole skips the per-element test
    const bool full = k0 + kBK <= min(Sk, kv_len) &&
                      (!causal || k0 + kBK - 1 <= pos_lo) &&
                      (!has_window || pos_hi - k0 < window);
    uint32_t valid = 0xffffffffu;   // bit 4 j + e
    float m_cur[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * j + 2 * t + (e & 1);
        const bool ok = full || visible(pos0 + 8 * (e >> 1), kp,
                                        min(Sk, kv_len), causal, has_window,
                                        window);
        if (!ok) valid &= ~(1u << (4 * j + e));
        s[j][e] = ok ? s[j][e] * scale2 : kNegInf;
        m_cur[e >> 1] = fmaxf(m_cur[e >> 1], s[j][e]);
      }
    float m_safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 1));
      m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 2));
      const float m_new = fmaxf(m[r], m_cur[r]);
      m_safe[r] = m_new == kNegInf ? 0.0f : m_new;
      const float alpha = m[r] == kNegInf ? 0.0f : exp2f(m[r] - m_safe[r]);
      m[r] = m_new;
      l[r] *= alpha;   // each thread keeps its own partial row sum
#pragma unroll
      for (int n = 0; n < kDMax / 8; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (valid >> (4 * j + e)) & 1u
                            ? exp2f(s[j][e] - m_safe[e >> 1])
                            : 0.0f;
        s[j][e] = p;
        l[e >> 1] += p;
      }

    clk.lap(1);
    // O += P V with p = p_hi + p_lo; 16 keys per step, 16 d per ldmatrix
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_pair(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_pair(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int dn = 0; dn < kDMax / 16; ++dn) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_t + (16 * kk + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * kLd +
                                  dn * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dn], hi, bv[0], bv[1]);
        mma_bf16(acc[2 * dn], lo, bv[0], bv[1]);
        mma_bf16(acc[2 * dn + 1], hi, bv[2], bv[3]);
        mma_bf16(acc[2 * dn + 1], lo, bv[2], bv[3]);
      }
    }
    clk.lap(2);
    __syncthreads();   // before the next load overwrites this stage
  }
  cp_async_wait<0>();
  clk.save(n_tiles);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = warp * 16 + g + 8 * r;
    if (row >= n_q) continue;
    // m is in the base-2 domain: lse = m ln 2 + ln l
    if (lse != nullptr && t == 0)
      lse[(size_t)bh * Sq + q0 + row] =
          l[r] == 0.0f ? kNegInf : m[r] * kLn2 + logf(l[r]);
    const float l_safe = l[r] == 0.0f ? 1.0f : l[r];
    __nv_bfloat16* o = out + ((size_t)bh * Sq + q0 + row) * D;
#pragma unroll
    for (int n = 0; n < kDMax / 8; ++n) {
      const int d = 8 * n + 2 * t;
      const float x = acc[n][2 * r] / l_safe, y = acc[n][2 * r + 1] / l_safe;
      if (kVec) {   // D % 8 == 0: both or neither of d, d + 1 exist
        if (d < D)
          *reinterpret_cast<uint32_t*>(o + d) =
              pack_bf16(__float2bfloat16_rn(x), __float2bfloat16_rn(y));
      } else {
        if (d < D) o[d] = __float2bfloat16_rn(x);
        if (d + 1 < D) o[d + 1] = __float2bfloat16_rn(y);
      }
    }
  }
}

}  // namespace tc

// ------------------------------------------ split-KV decode (flash-decoding)
namespace split {

// kRows (a template constant): packed rows (query row x GQA group member)
// a CTA, 8 (decode with a GQA group up to 8) or 32
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxSplits = 64;   // the merge's weights fit kRows x 64 floats

template <int kDMax, int kRows, typename T>
struct Layout {
  static constexpr int kBK = 128 / (int)sizeof(T);   // keys a tile: 16 KB
  static constexpr int kLd = kDMax + 16 / (int)sizeof(T);   // +16 bytes
  static constexpr int kTile = kBK * kLd;                    // elements
  static constexpr size_t kRing = 4 * (size_t)kTile * sizeof(T);   // K V K V
  // q (kRows x kDMax) and p (kRows x kBK) f32, then kRows of alpha; the
  // merge reuses q and p for its kRows x kMaxSplits weights
  static constexpr size_t kBytes = kRing + 4 * ((size_t)kRows * kDMax +
                                                kRows * kBK + kRows);
  static_assert(kDMax + kBK >= kMaxSplits, "merge weights do not fit");
};

// 16 bytes of shared memory as floats
__device__ __forceinline__ void load16(const float* p, float o[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x, o[1] = t.y, o[2] = t.z, o[3] = t.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float o[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x, o[2 * i + 1] = f.y;
  }
}

// grid (n_splits, B * Hkv), n_splits <= kMaxSplits.  Packed row r of kv
// head (b, kvh) is query row r / group of query head kvh * group + r %
// group; R = Sq * group <= kRows.  Split s walks keys [key_lo + s *
// split_keys, min(key_hi, ...)) in tiles of kBK.  Partials: m_part, l_part
// (n_splits, B * Hkv, R); acc_part (n_splits, B * Hkv, R, D); tickets
// (B * Hkv,) zero before the launch, and zero again after it: the merging
// CTA resets its kv head's ticket.
template <int kDMax, int kRows, bool kVec, typename T>
__global__ void __launch_bounds__(kThreads)
kernel(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, T* __restrict__ out, int H, int Hkv, int Sq,
       int Sk, int D, float scale, bool causal, bool has_window, int window,
       int kv_len, int offset, int key_lo, int key_hi, int split_keys,
       float* __restrict__ m_part, float* __restrict__ l_part,
       float* __restrict__ acc_part, int* __restrict__ tickets) {
  using L = Layout<kDMax, kRows, T>;
  constexpr int kBK = L::kBK, kLd = L::kLd;
  constexpr int kElems = 16 / sizeof(T);
  constexpr int kScoreGroups = kThreads / kBK;     // row groups of scores
  constexpr int kPvGroups = kThreads / kDMax;      // row groups of P V
  extern __shared__ uint4 split_smem[];
  T* ring = reinterpret_cast<T*>(split_smem);
  float* q_s = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(split_smem) + L::kRing);
  float* p_s = q_s + kRows * kDMax;     // [kRows][kBK]: scores, then p
  float* alpha_s = p_s + kRows * kBK;
  __shared__ int last;

  const int split = blockIdx.x, n_splits = gridDim.x;
  const int bkv = blockIdx.y, b = bkv / Hkv, kvh = bkv % Hkv;
  const int group = H / Hkv, R = Sq * group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* k_h = k + (size_t)bkv * Sk * D;
  const T* v_h = v + (size_t)bkv * Sk * D;
  const int lo = key_lo + split * split_keys;
  const int hi = min(key_hi, lo + split_keys);
  const int kv_end = min(hi, min(Sk, kv_len));
  const int n_tiles = hi > lo ? (hi - lo + kBK - 1) / kBK : 0;
  // the query row of packed row r, as an offset into q and out
  auto row_off = [&](int r) {
    return (((size_t)b * H + kvh * group + r % group) * Sq + r / group) * D;
  };

  auto load_kv = [&](int it) {
    const int k0 = lo + it * kBK, n_k = min(kBK, hi - k0);
    T* dst = ring + 2 * (it & 1) * L::kTile;
    load_tile<kDMax, kVec, kThreads>(dst, kLd, k_h + (size_t)k0 * D, kBK,
                                     n_k, D);
    load_tile<kDMax, kVec, kThreads>(dst + L::kTile, kLd,
                                     v_h + (size_t)k0 * D, kBK, n_k, D);
  };
  // debug builds: cycles staging q and waiting for tiles (0), on scores
  // (1), on the softmax and P V (2), writing the partial and, in the last
  // CTA, merging (3)
  Clock clk;
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();
  for (int i = tid; i < kRows * kDMax; i += kThreads) {
    const int r = i / kDMax, d = i % kDMax;
    q_s[i] = r < R && d < D ? to_float(q[row_off(r) + d]) : 0.0f;
  }

  // softmax state: warp w owns packed rows w + kWarps i
  float m[kRows / kWarps], l[kRows / kWarps];
#pragma unroll
  for (int i = 0; i < kRows / kWarps; ++i) m[i] = kNegInf, l[i] = 0.0f;
  // P V: thread (d, group) owns column d of rows group + kPvGroups i
  const int pv_d = tid % kDMax, pv_g = tid / kDMax;
  float acc[kRows / kPvGroups];
#pragma unroll
  for (int i = 0; i < kRows / kPvGroups; ++i) acc[i] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_kv(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    clk.lap(0);
    const T* k_t = ring + 2 * (it & 1) * L::kTile;
    const T* v_t = k_t + L::kTile;
    const int k0 = lo + it * kBK;

    {   // scores: thread (key j, group rg) for rows rg + kScoreGroups i
      const int j = tid % kBK, rg = tid / kBK;
      float sc[kRows / kScoreGroups];
#pragma unroll
      for (int i = 0; i < kRows / kScoreGroups; ++i) sc[i] = 0.0f;
#pragma unroll 2
      for (int d = 0; d < kDMax; d += kElems) {
        float kx[kElems];
        load16(k_t + j * kLd + d, kx);
#pragma unroll
        for (int i = 0; i < kRows / kScoreGroups; ++i) {
          const float* qr = q_s + (rg + kScoreGroups * i) * kDMax + d;
#pragma unroll
          for (int e = 0; e < kElems; ++e) sc[i] = fmaf(qr[e], kx[e], sc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRows / kScoreGroups; ++i) {   // rows past R: unused
        const int r = rg + kScoreGroups * i;
        const bool ok = visible(r / group + offset, k0 + j, kv_end, causal,
                                has_window, window);
        p_s[r * kBK + j] = ok ? sc[i] * scale : kNegInf;
      }
    }
    __syncthreads();
    clk.lap(1);

#pragma unroll
    for (int i = 0; i < kRows / kWarps; ++i) {   // online softmax, per row
      const int r = warp + kWarps * i;
      if (r >= R) break;
      const int pos = r / group + offset;
      float* pr = p_s + r * kBK;
      float x[kBK / 32];
      float m_cur = kNegInf;
#pragma unroll
      for (int c = 0; c < kBK / 32; ++c) {
        x[c] = pr[lane + 32 * c];
        m_cur = fmaxf(m_cur, x[c]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, off));
      const float m_new = fmaxf(m[i], m_cur);
      const float m_safe = m_new == kNegInf ? 0.0f : m_new;
      float p_sum = 0.0f;
#pragma unroll
      for (int c = 0; c < kBK / 32; ++c) {
        const bool ok = visible(pos, k0 + lane + 32 * c, kv_end, causal,
                                has_window, window);
        x[c] = ok ? expf(x[c] - m_safe) : 0.0f;
        p_sum += x[c];
        pr[lane + 32 * c] = x[c];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        p_sum += __shfl_xor_sync(0xffffffffu, p_sum, off);
      const float alpha = m[i] == kNegInf ? 0.0f : expf(m[i] - m_safe);
      l[i] = alpha * l[i] + p_sum;
      m[i] = m_new;
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRows / kPvGroups; ++i)   // rows past R: unused
      acc[i] *= alpha_s[pv_g + kPvGroups * i];
    // every key of the tile: past the range p is 0 and V zero-filled
#pragma unroll 16
    for (int j = 0; j < kBK; ++j) {
      const float vv = to_float(v_t[j * kLd + pv_d]);
#pragma unroll
      for (int i = 0; i < kRows / kPvGroups; ++i)
        acc[i] = fmaf(p_s[(pv_g + kPvGroups * i) * kBK + j], vv, acc[i]);
    }
    __syncthreads();   // before the next tile reuses p_s and this stage
    clk.lap(2);
  }
  cp_async_wait<0>();

  // this split's partial (m, l, acc); an empty split leaves NEG_INF, 0, 0
  const int n_bkv = gridDim.y;
  const size_t part = (size_t)split * n_bkv + bkv;
#pragma unroll
  for (int i = 0; i < kRows / kWarps; ++i) {
    const int r = warp + kWarps * i;
    if (r < R && lane == 0) {
      m_part[part * R + r] = m[i];
      l_part[part * R + r] = l[i];
    }
  }
#pragma unroll
  for (int i = 0; i < kRows / kPvGroups; ++i) {
    const int r = pv_g + kPvGroups * i;
    if (r < R && pv_d < D) acc_part[(part * R + r) * D + pv_d] = acc[i];
  }

  // the last CTA of this kv head to finish merges every split's partial
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + bkv, 1) == n_splits - 1;
  __syncthreads();
  if (!last) {
    clk.lap(3);
    clk.save(0);
    return;
  }
  if (tid == 0) tickets[bkv] = 0;   // every split has counted: reuse it
  __threadfence();
  // per row: m = max m_s, weights exp(m_s - m_safe) (0 for NEG_INF) into
  // w_s, and l = sum of weight x l_s into alpha_s
  float* w_s = q_s;
  for (int r = warp; r < R; r += kWarps) {
    float ms[kMaxSplits / 32];
    float m_max = kNegInf;
#pragma unroll
    for (int c = 0; c < kMaxSplits / 32; ++c) {
      const int s = lane + 32 * c;
      ms[c] = s < n_splits ? __ldcg(m_part + ((size_t)s * n_bkv + bkv) * R +
                                    r)
                           : kNegInf;
      m_max = fmaxf(m_max, ms[c]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m_max = fmaxf(m_max, __shfl_xor_sync(0xffffffffu, m_max, off));
    const float m_safe = m_max == kNegInf ? 0.0f : m_max;
    float l_sum = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxSplits / 32; ++c) {
      const int s = lane + 32 * c;
      if (s >= n_splits) continue;
      const float w = ms[c] == kNegInf ? 0.0f : expf(ms[c] - m_safe);
      w_s[r * kMaxSplits + s] = w;
      l_sum += w * __ldcg(l_part + ((size_t)s * n_bkv + bkv) * R + r);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l_sum += __shfl_xor_sync(0xffffffffu, l_sum, off);
    if (lane == 0) alpha_s[r] = l_sum == 0.0f ? 1.0f : l_sum;   // l_safe
  }
  __syncthreads();
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const float* w = w_s + r * kMaxSplits;
    const float* a = acc_part + ((size_t)bkv * R + r) * D + d;
    const size_t stride = (size_t)n_bkv * R * D;   // one split's partials
    float o = 0.0f;
#pragma unroll 8
    for (int s = 0; s < n_splits; ++s) o += w[s] * __ldcg(a + s * stride);
    store(out + row_off(r) + d, o / alpha_s[r]);
  }
  clk.lap(3);
  clk.save(1);   // the merging CTA
}

}  // namespace split

// ---------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;   // above only by opting in
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
  const void *q, *k, *v;
  void* out;
  int B, H, Hkv, Sq, Sk, D;
  float scale;
  int causal, has_window, window, kv_len, offset, vec;
  int tile_rows, n_splits, key_lo, key_hi, split_keys;
  float *m_part, *l_part, *acc_part;
  int* tickets;
  float* lse;
  cudaStream_t stream;
};

template <int kDMax, typename T>
int launch_f32_cores(const Args& a) {
  auto kernel = flash_attention_kernel<kDMax, T>;
  const size_t smem = smem_floats<kDMax>() * sizeof(float);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.H);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.out, a.lse, a.H,
      a.Hkv, a.Sq, a.Sk, a.D, a.scale, a.causal != 0, a.has_window != 0,
      a.window, a.kv_len, a.offset, a.vec != 0);
  return cudaGetLastError();
}

template <int kDMax, bool kVec, int kBQ>
int launch_tc(const Args& a) {
  using L = tc::Layout<kDMax, kBQ>;
  auto kernel = tc::kernel<kDMax, kVec, kBQ>;
  cudaError_t e = allow_smem(kernel, L::kBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.H);
  kernel<<<grid, L::kThreads, L::kBytes, a.stream>>>(
      (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k,
      (const __nv_bfloat16*)a.v, (__nv_bfloat16*)a.out, a.lse, a.H, a.Hkv,
      a.Sq, a.Sk, a.D, a.scale, a.causal != 0, a.has_window != 0, a.window,
      a.kv_len, a.offset);
  return cudaGetLastError();
}

template <int kDMax, int kRows, bool kVec, typename T>
int launch_split(const Args& a) {
  auto kernel = split::kernel<kDMax, kRows, kVec, T>;
  const size_t smem = split::Layout<kDMax, kRows, T>::kBytes;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.n_splits, a.B * a.Hkv);
  kernel<<<grid, split::kThreads, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.out, a.H, a.Hkv,
      a.Sq, a.Sk, a.D, a.scale, a.causal != 0, a.has_window != 0, a.window,
      a.kv_len, a.offset, a.key_lo, a.key_hi, a.split_keys, a.m_part,
      a.l_part, a.acc_part, a.tickets);
  return cudaGetLastError();
}

template <int kDMax, typename T>
int launch_schedule(const Args& a) {
  if (a.n_splits > 0) {
    if (a.Sq * (a.H / a.Hkv) <= 8)
      return a.vec ? launch_split<kDMax, 8, true, T>(a)
                   : launch_split<kDMax, 8, false, T>(a);
    return a.vec ? launch_split<kDMax, 32, true, T>(a)
                 : launch_split<kDMax, 32, false, T>(a);
  }
  if constexpr (sizeof(T) == 4) {
    return launch_f32_cores<kDMax, T>(a);
  } else {
    if (a.tile_rows == 128)
      return a.vec ? launch_tc<kDMax, true, 128>(a)
                   : launch_tc<kDMax, false, 128>(a);
    return a.vec ? launch_tc<kDMax, true, 64>(a)
                 : launch_tc<kDMax, false, 64>(a);
  }
}

template <typename T>
int launch_d(const Args& a) {
  if (a.D <= 32) return launch_schedule<32, T>(a);
  if (a.D <= 64) return launch_schedule<64, T>(a);
  return launch_schedule<128, T>(a);
}

}  // namespace

extern "C" {

// D <= 128 (the wrapper checks).  bf16: 0 for f32 tensors, 1 for bf16.
// kv_len: min(kv_len, Sk), or Sk when the caller gave none.  vec: D is a
// multiple of 16 bytes and every tensor 16-byte aligned.  tile_rows: the
// bf16 tiled schedule's query rows a CTA (64 or 128; f32 takes 64).
// n_splits: 0 for the tiled schedules, else the split schedule's grid
// (n_splits, B * Hkv)
// over keys [key_lo, key_hi) in ranges of split_keys, with its f32 partials
// (m_part, l_part: n_splits * B * Hkv * Sq * H / Hkv; acc_part: that times
// D) and B * Hkv int32 tickets, zero before the launch and after it.
// lse: null, or B * H * Sq floats for the rows' log-sum-exp (tiled
// schedules only).
int flash_attention_launch(int device, const void* q, const void* k,
                           const void* v, void* out, int B, int H, int Hkv,
                           int Sq, int Sk, int D, float scale, int causal,
                           int has_window, int window, int kv_len,
                           int offset, int bf16, int vec, int tile_rows,
                           int n_splits,
                           int key_lo, int key_hi, int split_keys,
                           void* m_part, void* l_part, void* acc_part,
                           void* tickets, void* lse, void* stream) {
  if (lse != nullptr && n_splits > 0) return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const Args a{q, k, v, out, B, H, Hkv, Sq, Sk, D, scale, causal,
               has_window, window, kv_len, offset, vec, tile_rows, n_splits,
               key_lo,
               key_hi, split_keys, (float*)m_part, (float*)l_part,
               (float*)acc_part, (int*)tickets, (float*)lse,
               (cudaStream_t)stream};
  if (bf16) return launch_d<__nv_bfloat16>(a);
  return launch_d<float>(a);
}

#ifdef CLOCK_STAMPS
int flash_attention_clock_stamps(void* host, int n_ctas) {
  return copy_stamps(host, n_ctas);
}
#endif

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
