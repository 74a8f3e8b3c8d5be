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
// h / (H / Hkv).  Inputs f32 or bf16; arithmetic in f32; output in the
// inputs' type.  Its public op is `mha`.
//
// What bounds it on an H100: operations for a prefill.  At Mixtral 8x22B's
// shape (H = 48, Hkv = 8, D = 128, Sq = Sk = 8192, window 4096, causal) the
// 25.2 M valid (query, key) pairs of a head need 4 D flops each, 619 GFLOP:
// 9.2 ms of f32 arithmetic at 67 TFLOP/s (0.63 ms at the 989 TFLOP/s of
// bf16 tensor cores, which this kernel does not use).  A decode row (Sq = 1)
// is bound by the bytes of its cache window.
//
// Design: one CTA of 256 threads per (batch x head, 64-row query tile).  The
// query tile stays in shared memory (transposed, d-major) for the whole key
// loop; 64-key tiles of K (transposed) and V are streamed through shared
// memory, converted to f32 on the way in.  Key tiles that the mask empties
// for every row of the query tile are skipped, which is exact: such a tile
// would leave m, l and the accumulator unchanged (alpha = 1 or all zero).
// Thread (ty, tx) of a 16 x 16 grid owns query rows 4 ty .. 4 ty + 3, keys
// tx + 16 j of the tile and output columns tx + 16 c, so every shared load
// of K, V and P is conflict-free or a broadcast.  Row maxima and sums reduce
// over the 16 threads of a row with shuffles; p goes through shared memory
// (transposed) from the score layout to the P.V layout.  f32 arithmetic on
// the CUDA cores; no tensor cores, no double buffering yet: a later change
// makes it fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
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
__device__ __forceinline__ void load4(const __nv_bfloat16* p, int n, bool vec,
                                      float o[4]) {
  if (vec && n == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&t.y));
    o[0] = a.x, o[1] = a.y, o[2] = b.x, o[3] = b.y;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = i < n ? __bfloat162float(p[i]) : 0.0f;
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
  }
}

template <int kDMax, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Hkv, int Sq, int Sk, int D, float scale, int causal,
           int has_window, int window, int kv_len, int offset, int vec,
           cudaStream_t stream) {
  auto kernel = flash_attention_kernel<kDMax, T>;
  const size_t smem = smem_floats<kDMax>() * sizeof(float);
  if (smem > 48 * 1024) {   // above the default only by opting in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, Hkv, Sq, Sk, D,
      scale, causal != 0, has_window != 0, window, kv_len, offset, vec != 0);
  return cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int H, int Hkv, int Sq, int Sk, int D, float scale, int causal,
             int has_window, int window, int kv_len, int offset, int vec,
             cudaStream_t stream) {
  if (D <= 32)
    return launch<32, T>(q, k, v, out, B, H, Hkv, Sq, Sk, D, scale, causal,
                         has_window, window, kv_len, offset, vec, stream);
  if (D <= 64)
    return launch<64, T>(q, k, v, out, B, H, Hkv, Sq, Sk, D, scale, causal,
                         has_window, window, kv_len, offset, vec, stream);
  return launch<128, T>(q, k, v, out, B, H, Hkv, Sq, Sk, D, scale, causal,
                        has_window, window, kv_len, offset, vec, stream);
}

}  // namespace

extern "C" {

// D <= 128 (the wrapper checks).  bf16: 0 for f32 tensors, 1 for bf16.
// kv_len: min(kv_len, Sk), or Sk when the caller gave none.  vec: D % 4 ==
// 0 and every tensor aligned to 4 elements.
int flash_attention_launch(int device, const void* q, const void* k,
                           const void* v, void* out, int B, int H, int Hkv,
                           int Sq, int Sk, int D, float scale, int causal,
                           int has_window, int window, int kv_len,
                           int offset, int bf16, int vec, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_d<__nv_bfloat16>(q, k, v, out, B, H, Hkv, Sq, Sk, D, scale,
                                   causal, has_window, window, kv_len, offset,
                                   vec, s);
  return launch_d<float>(q, k, v, out, B, H, Hkv, Sq, Sk, D, scale, causal,
                         has_window, window, kv_len, offset, vec, s);
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
