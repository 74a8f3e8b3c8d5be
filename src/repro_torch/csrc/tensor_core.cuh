// Helpers shared by K8's forward (flash_attention.cu) and its backward
// (flash_attention_bwd.cu): asynchronous tile copies, the f32 <-> element
// conversions, a zero-filling tile loader, and the warp-level tensor-core
// operations they run on (`ldmatrix`, `mma.sync` in bf16 and in tf32).
//
// Fragment layouts are PTX's for `mma.sync.aligned.m16n8k16` (bf16) and
// `m16n8k8` (tf32): lane = 4 g + t; the f32 accumulator of a 16 x 8 tile
// holds (row g, columns 2t, 2t + 1) and (row g + 8, the same columns).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// ------------------------------------------------------ asynchronous copies

// 16 bytes from global to shared memory, asynchronously; only the first
// `src_bytes` (0 or 16) are read, the rest of the 16 are zero-filled.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
// 4 bytes, likewise (`src_bytes` 0 or 4)
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// ------------------------------------------------------------ conversions

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Rows [0, n_rows) of src (row length D, in elements) into an
// n_tile_rows x kDMax tile of dst (row stride ld elements), zero-filled
// past n_rows and past D.  kVec: 16-byte `cp.async` copies (then D is a
// multiple of 16 bytes and src 16-byte aligned); else element loads.
template <int kDMax, bool kVec, int kNThreads, typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int n_tile_rows, int n_rows,
                                          int D) {
  constexpr int kElems = 16 / sizeof(T);
  if (kVec) {
    constexpr int kChunks = kDMax / kElems;
    for (int i = threadIdx.x; i < n_tile_rows * kChunks; i += kNThreads) {
      const int r = i / kChunks, d = (i % kChunks) * kElems;
      const bool ok = r < n_rows && d < D;
      cp_async_16(dst + r * ld + d, src + (ok ? (size_t)r * D + d : 0),
                  ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < n_tile_rows * kDMax; i += kNThreads) {
      const int r = i / kDMax, d = i % kDMax;
      if (r < n_rows && d < D)
        dst[r * ld + d] = src[(size_t)r * D + d];
      else
        store(dst + r * ld + d, 0.0f);
    }
  }
}

// ------------------------------------------------------- bf16 tensor cores

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
// p (two f32 values, the lower column first) as p_hi + p_lo in bf16 pairs
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 xh = __float2bfloat16_rn(x), yh = __float2bfloat16_rn(y);
  hi = pack_bf16(xh, yh);
  lo = pack_bf16(__float2bfloat16_rn(x - __bfloat162float(xh)),
                 __float2bfloat16_rn(y - __bfloat162float(yh)));
}

// ------------------------------------------------------- tf32 tensor cores

// x rounded to tf32 as `cvt.rna` rounds (10 mantissa bits, to nearest, ties
// away from zero), its low 13 bits cleared, so x - tf32(x) is exact in f32
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}
// x = big + small (3xTF32's split): big = tf32(x), small = tf32(x - big)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a b in f32 by error-compensated 3xTF32: a_small b_big + a_big
// b_small + a_big b_big, the small terms first (a_small b_small, ~2^-22
// of the product, is left out)
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t a_big[4],
                                           const uint32_t a_small[4],
                                           const uint32_t b_big[2],
                                           const uint32_t b_small[2]) {
  mma_tf32(c, a_small, b_big[0], b_big[1]);
  mma_tf32(c, a_big, b_small[0], b_small[1]);
  mma_tf32(c, a_big, b_big[0], b_big[1]);
}
