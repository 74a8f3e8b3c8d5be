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
// int8 operations, 26 us at 1,979 TOP/s on the tensor cores.
//
// Design (simple and exact first): CTA tiles of 128 x 128 outputs, K in
// steps of 64; eight warps in a 2 x 4 grid, each 64 x 32 outputs as 4 x 4
// tensor-core `mma.sync.m16n8k32` s8 products into int32 registers.  The
// int32 sum of int8 products is exact in any order (|sum| <= K * 128^2 <
// 2^31 for K < 2^17, which the wrapper checks), so the tile order does not
// change a bit.  A tile is staged in shared memory with k contiguous per row
// (x as it lies, w transposed 4 x 4 bytes at a time with `__byte_perm`), rows
// of 80 bytes so that the fragment loads of a warp hit 32 distinct banks.
// Loads are 4-byte words when K and N are multiples of 4, single bytes with
// bounds checks otherwise; ragged M, N and K tiles are zero-filled.  No
// double buffering and no TMA yet: a later change makes it fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kThreads = 256;           // 8 warps: 2 along M x 4 along N
constexpr int kWM = 64, kWN = 32;       // outputs per warp
constexpr int kMT = kWM / 16, kNT = kWN / 8;
constexpr int kRowWords = kBK / 4 + 4;  // 80-byte smem rows (20 words)

// 4 bytes at p, of which the first `valid` (0..4) exist; as one word when
// `vec` (the address is then 4-byte aligned), else byte by byte.
__device__ __forceinline__ uint32_t load4(const int8_t* p, int valid,
                                          bool vec) {
  if (vec && valid == 4) return __ldg(reinterpret_cast<const uint32_t*>(p));
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < valid) v |= (uint32_t)(uint8_t)__ldg(p + i) << (8 * i);
  return v;
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename Out>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const int8_t* __restrict__ x_q,      // (M, K)
                    const int8_t* __restrict__ w_q,      // (K, N)
                    const float* __restrict__ x_scale,   // (M,)
                    const float* __restrict__ w_scale,   // (N,)
                    Out* __restrict__ out,               // (M, N)
                    int M, int N, int K, bool vec) {
  __shared__ uint32_t a_s[kBM * kRowWords];   // [m][k/4]
  __shared__ uint32_t b_s[kBN * kRowWords];   // [n][k/4]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;    // mma group and thread in group
  const int wm = warp / (kBN / kWN), wn = warp % (kBN / kWN);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // x tile: 128 rows x 16 words, row-major as it lies in memory
    for (int i = tid; i < kBM * (kBK / 4); i += kThreads) {
      const int r = i / (kBK / 4), kw = i % (kBK / 4);
      const int m = m0 + r, k = k0 + 4 * kw;
      const int valid = m < M ? max(0, min(4, K - k)) : 0;
      a_s[r * kRowWords + kw] =
          load4(x_q + (size_t)(m < M ? m : 0) * K + k, valid, vec);
    }
    // w tile: 4 x 4 byte blocks (16 along k x 32 along n), transposed so
    // that each n row holds its k bytes contiguously; a warp takes all 16
    // k blocks of two n blocks, so its stores hit 32 distinct banks
    for (int i = tid; i < (kBK / 4) * (kBN / 4); i += kThreads) {
      const int kb = i % (kBK / 4), nb = i / (kBK / 4);
      const int k = k0 + 4 * kb, n = n0 + 4 * nb;
      const int valid_n = max(0, min(4, N - n));
      uint32_t r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r[j] = load4(w_q + (size_t)(k + j < K ? k + j : 0) * N +
                         (valid_n ? n : 0),
                     k + j < K ? valid_n : 0, vec);
      const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
      const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
      const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
      const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
      uint32_t* dst = b_s + (4 * nb) * kRowWords + kb;
      dst[0 * kRowWords] = __byte_perm(t0, t1, 0x5410);
      dst[1 * kRowWords] = __byte_perm(t0, t1, 0x7632);
      dst[2 * kRowWords] = __byte_perm(t2, t3, 0x5410);
      dst[3 * kRowWords] = __byte_perm(t2, t3, 0x7632);
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      const int kw = ks * 8 + tig;
      uint32_t a[kMT][4], b[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const uint32_t* p = a_s + (wm * kWM + i * 16 + g) * kRowWords + kw;
        a[i][0] = p[0];
        a[i][1] = p[8 * kRowWords];
        a[i][2] = p[4];
        a[i][3] = p[8 * kRowWords + 4];
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const uint32_t* p = b_s + (wn * kWN + j * 8 + g) * kRowWords + kw;
        b[j][0] = p[0];
        b[j][1] = p[4];
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // epilogue: (float(acc) * x_scale) * w_scale, the TPU kernel's order
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * kWM + i * 16 + g + 8 * half;
      if (m >= M) continue;
      const float xs = x_scale[m];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * kWN + j * 8 + 2 * tig + e;
          if (n < N)
            store(out + (size_t)m * N + n,
                  ((float)acc[i][j][2 * half + e] * xs) * w_scale[n]);
        }
    }
}

}  // namespace

extern "C" {

// out_bf16: 0 writes f32 to `out`, 1 writes bf16.  vec: K and N are
// multiples of 4 and x_q, w_q 4-byte aligned.
int quant_matmul_launch(int device, const int8_t* x_q, const int8_t* w_q,
                        const float* x_scale, const float* w_scale, void* out,
                        int M, int N, int K, int out_bf16, int vec,
                        void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  cudaStream_t s = (cudaStream_t)stream;
  if (out_bf16)
    quant_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        x_q, w_q, x_scale, w_scale, (__nv_bfloat16*)out, M, N, K, vec != 0);
  else
    quant_matmul_kernel<float><<<grid, kThreads, 0, s>>>(
        x_q, w_q, x_scale, w_scale, (float*)out, M, N, K, vec != 0);
  return cudaGetLastError();
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
