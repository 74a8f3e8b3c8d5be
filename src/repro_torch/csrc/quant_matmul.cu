// K7: int8 x int8 -> int32 matmul with the per-row x per-column dequant
// epilogue, for sm_90a.
//
// Replaces the TPU kernel `quant_matmul` of
// src/repro/kernels/quant_matmul/kernel.py: out (M, N) = (float(acc) *
// x_scale[m]) * w_scale[n] with acc = x_q (M, K) @ w_q (K, N) summed
// exactly in int32, the epilogue in the TPU kernel's order (kernel.py:35),
// written as f32 or bf16 (round to nearest even).  Its public op is
// `quantized_linear` (per-row dynamic activation scales).
//
// What bounds it on an H100: bytes at the shapes it serves.  At Mixtral
// 8x22B's expert up-projection (M = 256 tokens, K = 6144, N = 16384) it must
// read the 100.7 MB int8 weight once, 35.5 us at 3.35 TB/s, against 51.5 G
// int8 operations, 26 us at 1,979 TOP/s on the tensor cores: 512 operations
// per weight byte against the card's ~590, so the weight must stream from
// HBM once, its loads overlapping the products.
//
// Design.  A CTA computes a BM x 128 output tile (BM = 256, 128 or 64, from
// `qmm_geometry`; at Mixtral one tile holds all of M, so every weight byte
// is fetched by one CTA, 128 CTAs) over all of K, with one warpgroup
// per 64 rows issuing `wgmma.m64n128k32` s8 products (int32 accumulators
// in registers) from shared memory.  K goes in stages of 128 through a
// 4-stage ring filled by TMA (one thread starts two 2-D box loads a stage,
// completing on the slot's mbarrier): x as k-major rows of 128 bytes in
// `wgmma`'s 128-byte swizzle, which TMA writes itself, and the weight tile
// as it lies, 128 rows of 128 bytes.  The one transpose: `wgmma` takes
// int8 operands k-major only, and the weight is n-major (`ldmatrix.trans`
// and `wgmma`'s transpose move 16-bit elements only).  So once per stage
// the CTA transposes the weight tile in shared memory with `__byte_perm`
// (4 x 4 bytes at a time; each warp reads whole rows, and a per-lane byte
// rotation keeps the 8-byte stores conflict-free) into a k-major [n][k]
// tile in the 128-byte swizzle.  Two transposed tiles alternate: stage
// it's `wgmma`s run asynchronously, queued behind stage it - 1's without a
// fence, while the CTA starts stage it + 3's loads and transposes stage
// it + 1.  Clock stamps (-DCLOCK_STAMPS) put the rest of the time in the
// transpose and in issuing `wgmma`, about equally, at Mixtral's shape.
//
// The int32 sum of int8 products is exact in any order (|sum| <= K * 128^2
// < 2^31 for K < 2^17, which the wrapper checks), so tiling does not change
// a bit.  Shapes whose rows are not 16-byte aligned (K or N not a multiple
// of 16; TMA needs 16-byte strides) stage bytes with bounds checks into the
// same layout (template flag kVec); ragged M, N and K tiles read as zeros.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "clock_stamps.cuh"

namespace {

constexpr int kBN = 128, kBK = 128, kStages = 4;

template <int kBM>
struct Layout {
  static constexpr int kThreads = 2 * kBM;   // a warpgroup per 64 rows
  static constexpr int kA = kBM * kBK, kB = kBK * kBN;   // bytes per stage
  // the ring, then two stages' weights transposed ([n][k]); every tile
  // 1024-byte aligned (the 128-byte swizzle's period), hence the slack
  static constexpr size_t kBytes =
      (size_t)kStages * (kA + kB) + 2 * (size_t)kBN * kBK + 1024;
};

// byte offset of (row r, k byte c) in a k-major operand tile (x, or the
// transposed weight): rows of 128 bytes, chunk c / 16 at (c / 16) ^ (r % 8),
// the 128-byte swizzle that `wgmma` reads
__device__ __forceinline__ int k_off(int r, int c) {
  return r * kBK + ((((c >> 4) ^ (r & 7))) << 4) + (c & 15);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// `wgmma` descriptor of a k-major tile at p (1024-byte aligned): rows of
// 128 bytes with the 128-byte swizzle, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t k_major_desc(const void* p) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3ffff) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// d (64 x 128, this warpgroup) += A (64 x 32 k, desc da) B (32 k x 128,
// desc db), int8 -> int32
__device__ __forceinline__ void wgmma_m64n128k32(int d[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}
// pin the accumulators at this point of the program, so that no other
// instruction touching them moves into the `wgmma` pipeline: without the
// fences before and after the K loop, ptxas serializes every `wgmma`
// (warning C7514), which cost about 10 % at Mixtral's shape on an H100
__device__ __forceinline__ void fence_acc(int acc[64]) {
#pragma unroll
  for (int j = 0; j < 64; ++j) asm volatile("" : "+r"(acc[j])::"memory");
}
// mbarrier of one ring slot: armed by thread 0 with the bytes the TMA
// loads bring, complete when they have landed
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
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
// TMA: the box at (inner c0, outer c1) of map into dst, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
// make this thread's shared-memory writes visible to `wgmma`'s reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// r[i]: bytes (column c) of k row i -> o[c]: bytes (k row i) of column c
__device__ __forceinline__ void transpose4x4(const uint32_t r[4],
                                             uint32_t o[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ float epilogue(int acc, float xs, float ws) {
  return ((float)acc * xs) * ws;   // the TPU kernel's order
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// grid (ceil(N / 128), ceil(M / BM)); each CTA covers all of K
template <int kBM, bool kVec, typename Out>
__global__ void __launch_bounds__(Layout<kBM>::kThreads, 1)
quant_matmul_kernel(const int8_t* __restrict__ x_q,      // (M, K)
                    const int8_t* __restrict__ w_q,      // (K, N)
                    const float* __restrict__ x_scale,   // (M,)
                    const float* __restrict__ w_scale,   // (N,)
                    Out* __restrict__ out,               // (M, N)
                    int M, int N, int K,
                    const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap w_map) {
  using L = Layout<kBM>;
  constexpr int kThreads = L::kThreads;
  extern __shared__ uint4 qmm_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(qmm_smem) + 1023) & ~(uintptr_t)1023);
  unsigned char* bt_s = smem + kStages * (L::kA + L::kB);   // 2 x [n][k]
  __shared__ uint64_t bar[kStages];   // kVec: each slot's TMA loads

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;     // fragment row, column pair
  const int wg = warp >> 2, wq = warp & 3;   // warpgroup: 64 rows x 128
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int n_iter = (K + kBK - 1) / kBK;
  // debug builds: cycles waiting for the previous stage's products and the
  // next stage's data (0), issuing loads (1), transposing (2), issuing
  // wgmma (3)
  Clock clk;

  // stage `it` of K into ring slot it % kStages
  auto load = [&](int it) {
    const int k0 = it * kBK;
    unsigned char* a_s = smem + (it % kStages) * (L::kA + L::kB);
    unsigned char* b_s = a_s + L::kA;
    if (kVec) {
      // both tiles by TMA, x in wgmma's swizzle and the weight as it lies;
      // past M, N and K they read as 0
      if (tid == 0) {
        uint64_t* b = bar + it % kStages;
        mbar_expect(b, L::kA + L::kB);
        tma_load_2d(a_s, &x_map, b, k0, m0);
        tma_load_2d(b_s, &w_map, b, n0, k0);
      }
    } else {
      for (int i = tid; i < kBM * kBK; i += kThreads) {
        const int r = i / kBK, c = i % kBK, m = m0 + r, k = k0 + c;
        a_s[k_off(r, c)] =
            m < M && k < K ? (unsigned char)x_q[(size_t)m * K + k] : 0;
      }
      for (int i = tid; i < kBK * kBN; i += kThreads) {
        const int r = i / kBN, c = i % kBN, k = k0 + r, n = n0 + c;
        b_s[r * kBN + c] =
            k < K && n < N ? (unsigned char)w_q[(size_t)k * N + n] : 0;
      }
    }
  };
  auto wait_stage = [&](int it) {
    if (kVec) mbar_wait(bar + it % kStages, (it / kStages) & 1);
  };

  // the one transpose, of stage `it` into bt_s[it % 2].  Task (16-k chunk
  // q, half h, column group c4 = its lane) reads 8 words (k rows 16 q +
  // 8 h .. + 7 of columns 4 c4 .. 4 c4 + 3; a warp's 32 lanes read 32
  // distinct words) and writes each column's 8 k bytes.  Each word is
  // first rotated by `rot` bytes, so the lane pairs of a store start at
  // different columns: 8 lanes hit 8 chunks, and the two halves of a
  // 16-lane phase (h alternating every 8 lanes) hit the two halves of a
  // chunk.
  auto transpose = [&](int it) {
    const unsigned char* b_s =
        smem + (it % kStages) * (L::kA + L::kB) + L::kA;
    unsigned char* bt = bt_s + (it & 1) * kBN * kBK;
    const int rot = (lane >> 1) & 3;
    for (int i = tid; i < (kBK / 8) * (kBN / 4); i += kThreads) {
      const int w32 = i >> 5, c4 = i & 31;
      const int k0 = 16 * (w32 >> 1) + 8 * (((c4 >> 3) ^ w32) & 1);
      uint32_t w[8], lo[4], hi[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const uint32_t x = *reinterpret_cast<const uint32_t*>(
            b_s + (k0 + r) * kBN + 4 * c4);
        w[r] = __funnelshift_r(x, x, 8 * rot);   // byte b: column b + rot
      }
      transpose4x4(w, lo);
      transpose4x4(w + 4, hi);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        *reinterpret_cast<uint2*>(bt + k_off(4 * c4 + ((b + rot) & 3), k0)) =
            make_uint2(lo[b], hi[b]);
    }
    fence_proxy_async();   // bt for wgmma's reads
  };

  int acc[64];   // this thread's share of its warpgroup's 64 x 128
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0;

  if (kVec && tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bar + st);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // stages 0 .. kStages - 2 go ahead
  for (int st = 0; st < kStages - 1 && st < n_iter; ++st) load(st);
  if (n_iter > 0) {
    wait_stage(0);
    __syncthreads();   // the byte-staged instance's stores
    transpose(0);
  }
  __syncthreads();
  // iteration it: wgmma on stage it runs while stage it + 1 is transposed
  // and stage it + kStages - 1 starts loading.  Successive products into
  // the same accumulators are ordered without a fence, so stage it's queue
  // behind stage it - 1's
  fence_acc(acc);
  wgmma_fence();
  for (int it = 0; it < n_iter; ++it) {
    const unsigned char* a_s = smem + (it % kStages) * (L::kA + L::kB);
    const uint64_t da = k_major_desc(a_s + wg * 64 * kBK);
    const uint64_t db = k_major_desc(bt_s + (it & 1) * kBN * kBK);
    // all of the stage: past K both tiles are zero
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks)
      wgmma_m64n128k32(acc, da + 2 * ks, db + 2 * ks);   // +32 bytes of k
    wgmma_commit();
    clk.lap(3);
    wgmma_wait<1>();   // stage it - 1's products are done
    __syncthreads();   // in every warpgroup: its slot and bt_s are free
    clk.lap(0);
    if (it + kStages - 1 < n_iter) load(it + kStages - 1);
    clk.lap(1);
    if (it + 1 < n_iter) {
      wait_stage(it + 1);
      transpose(it + 1);
    }
    __syncthreads();
    clk.lap(2);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  clk.save(n_iter);

  // acc[4 nb + e] is output (m0 + 64 wg + 16 wq + g + 8 (e / 2),
  // n0 + 8 nb + 2 t + e % 2)
  const int row0 = m0 + wg * 64 + wq * 16 + g;
  const bool vec2 = (N & 1) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= M) continue;
    const float xs = x_scale[row];
#pragma unroll
    for (int nb = 0; nb < kBN / 8; ++nb) {
      const int col = n0 + nb * 8 + 2 * t;
      if (col >= N) continue;
      const float v0 = epilogue(acc[4 * nb + 2 * half], xs, w_scale[col]);
      Out* p = out + (size_t)row * N + col;
      if (col + 1 >= N) {
        store1(p, v0);
        continue;
      }
      const float v1 =
          epilogue(acc[4 * nb + 2 * half + 1], xs, w_scale[col + 1]);
      if (vec2) {
        store2(p, v0, v1);
      } else {
        store1(p, v0);
        store1(p + 1, v1);
      }
    }
  }
}

// A TMA map of a row-major int8 matrix (outer x inner bytes, inner a
// multiple of 16) in boxes of 128 inner bytes x box_outer rows; the
// encoder is looked up at run time, so the library links only the runtime.
cudaError_t tensor_map(CUtensorMap* map, const int8_t* p, int inner,
                       int outer, int box_outer, CUtensorMapSwizzle swizzle) {
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || !fn)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner};
  const cuuint32_t box[2] = {128, (cuuint32_t)box_outer};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(p), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int kBM, bool kVec, typename Out>
int launch(const int8_t* x_q, const int8_t* w_q, const float* x_scale,
           const float* w_scale, void* out, int M, int N, int K,
           cudaStream_t stream) {
  auto kernel = quant_matmul_kernel<kBM, kVec, Out>;
  const size_t smem = Layout<kBM>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  CUtensorMap x_map = {}, w_map = {};   // unused by byte staging
  if (kVec) {
    // x: 128 k x BM rows in wgmma's 128-byte swizzle; w: 128 n x 128 k
    e = tensor_map(&x_map, x_q, K, M, kBM, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e == cudaSuccess)
      e = tensor_map(&w_map, w_q, N, K, kBK, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  kernel<<<grid, Layout<kBM>::kThreads, smem, stream>>>(
      x_q, w_q, x_scale, w_scale, (Out*)out, M, N, K, x_map, w_map);
  return cudaGetLastError();
}

template <int kBM, typename Out>
int launch_vec(bool vec, const int8_t* x_q, const int8_t* w_q,
               const float* x_scale, const float* w_scale, void* out, int M,
               int N, int K, cudaStream_t stream) {
  return vec ? launch<kBM, true, Out>(x_q, w_q, x_scale, w_scale, out, M, N,
                                      K, stream)
             : launch<kBM, false, Out>(x_q, w_q, x_scale, w_scale, out, M,
                                       N, K, stream);
}

template <typename Out>
int launch_bm(int bm, bool vec, const int8_t* x_q, const int8_t* w_q,
              const float* x_scale, const float* w_scale, void* out, int M,
              int N, int K, cudaStream_t stream) {
  if (bm == 256)
    return launch_vec<256, Out>(vec, x_q, w_q, x_scale, w_scale, out, M, N,
                                K, stream);
  if (bm == 128)
    return launch_vec<128, Out>(vec, x_q, w_q, x_scale, w_scale, out, M, N,
                                K, stream);
  return launch_vec<64, Out>(vec, x_q, w_q, x_scale, w_scale, out, M, N, K,
                             stream);
}

}  // namespace

extern "C" {

// out_bf16: 0 writes f32 to `out`, 1 writes bf16.  vec: K > 0, K and N
// multiples of 16, and x_q, w_q 16-byte aligned.  bm (256, 128 or 64) from
// the wrapper's `qmm_geometry`.
int quant_matmul_launch(int device, const int8_t* x_q, const int8_t* w_q,
                        const float* x_scale, const float* w_scale, void* out,
                        int M, int N, int K, int out_bf16, int vec, int bm,
                        void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = (cudaStream_t)stream;
  if (out_bf16)
    return launch_bm<__nv_bfloat16>(bm, vec != 0, x_q, w_q, x_scale, w_scale,
                                    out, M, N, K, s);
  return launch_bm<float>(bm, vec != 0, x_q, w_q, x_scale, w_scale, out, M,
                          N, K, s);
}

#ifdef CLOCK_STAMPS
int quant_matmul_clock_stamps(void* host, int n_ctas) {
  return copy_stamps(host, n_ctas);
}
#endif

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
