// K8's backward: FlashAttention-2's dq, dk and dv from the forward's
// log-sum-exp, for sm_90a.
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
// or bf16, arithmetic in f32, outputs in the inputs' type.  There is no
// kv_len: the reference's training path has none.
//
// Deterministic, with no atomics, so that a resumed run repeats its bits:
// * `kv_kernel` writes dk and dv: one CTA per (batch x kv head, 64-key
//   tile), looping over every query head of the group and every 64-row
//   query tile that can see the key tile, so each dk/dv element is summed
//   by one thread in a fixed order;
// * `q_kernel` writes dq: one CTA per (batch x head, 64-row query tile),
//   looping over the key tiles its rows can see.
// Both recompute s and dp (the price of no atomics: 14 D flops a valid
// pair against FA2's 10 D).
//
// What bounds it on an H100: operations.  At MiniCPM-2B's training shape
// (B 2, 36 heads, S 4096, D 64, causal, f32) the 604 M valid pairs need
// 8 D flops each in `kv_kernel` and 6 D in `q_kernel`: 309 and 232 GFLOP,
// 4.6 and 3.5 ms at the 67 TFLOP/s of f32 arithmetic.  This first version
// runs on the CUDA cores from shared memory (tiles of 64 x D in f32,
// 256 threads on a 16 x 16 grid, each thread a 4 x 4 block of scores and
// 4 rows x D/16 columns of its accumulators); tensor cores (`mma`/`wgmma`)
// and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64, kBK = 64, kThreads = 256;
constexpr int kLdS = kBK + 4;   // padded row of a 64 x 64 score tile

template <int kDMax>
struct Layout {
  static constexpr int kLd = kDMax + 4;   // padded row of a 64 x D tile
  static constexpr int kTile = 64 * kLd;
  static constexpr int kScores = 64 * kLdS;
  // kv: k v q do | p ds | lse delta;  q: q do k v | ds^T | lse delta
  static constexpr size_t kKvBytes = 4 * (4 * (size_t)kTile + 2 * kScores +
                                          2 * kBQ);
  static constexpr size_t kQBytes = 4 * (4 * (size_t)kTile + kScores +
                                         2 * kBQ);
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Rows [0, n_rows) of src (row length D) into a 64 x kDMax f32 tile of row
// stride kLd, zero past n_rows and past D.
template <int kDMax, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int n_rows,
                                      int D) {
  constexpr int kLd = Layout<kDMax>::kLd;
  for (int i = threadIdx.x; i < 64 * kDMax; i += kThreads) {
    const int r = i / kDMax, d = i % kDMax;
    dst[r * kLd + d] =
        r < n_rows && d < D ? to_float(src[(size_t)r * D + d]) : 0.0f;
  }
}

// out[i][j] = row (4 ty + i) of a . row (tx + 16 j) of b, over kDMax
// (zero-filled past D).  Each quarter warp reads one a row (a broadcast)
// and eight b rows kLd apart (distinct banks).
template <int kDMax>
__device__ __forceinline__ void tile_dots(const float* a, const float* b,
                                          int ty, int tx, float out[4][4]) {
  constexpr int kLd = Layout<kDMax>::kLd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < kDMax; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (4 * ty + i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        out[i][j] = fmaf(av[i].x, bv[j].x, out[i][j]);
        out[i][j] = fmaf(av[i].y, bv[j].y, out[i][j]);
        out[i][j] = fmaf(av[i].z, bv[j].z, out[i][j]);
        out[i][j] = fmaf(av[i].w, bv[j].w, out[i][j]);
      }
  }
}

__device__ __forceinline__ bool visible(int pos, int kp, int Sk, bool causal,
                                        bool has_window, int window) {
  return kp < Sk && (!causal || pos >= kp) &&
         (!has_window || pos - kp < window);
}

// Query row r of the tile at q0: lse_safe and delta into shared memory
// (0 past n_q; such rows see no key).
__device__ __forceinline__ void stage_rows(float* lse_s, float* delta_s,
                                           const float* lse,
                                           const float* delta, int n_q) {
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const float l = r < n_q ? lse[r] : 0.0f;
    lse_s[r] = l == kNegInf ? 0.0f : l;
    delta_s[r] = r < n_q ? delta[r] : 0.0f;
  }
}

// p and ds of the thread's 4 x 4 scores: rows q0 + 4 ty + i (of n_q),
// keys k0 + tx + 16 j.
__device__ __forceinline__ void p_and_ds(float s[4][4], float dp[4][4],
                                         const float* lse_s,
                                         const float* delta_s, int q0,
                                         int n_q, int k0, int ty, int tx,
                                         int Sk, float scale, bool causal,
                                         bool has_window, int window,
                                         int offset) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    const int pos = q0 + r + offset;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = r < n_q && visible(pos, k0 + tx + 16 * j, Sk, causal,
                                         has_window, window);
      const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.0f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - delta_s[r]) * scale;   // now ds
    }
  }
}

// grid (ceil(Sk / 64), B * Hkv)
template <int kDMax, typename T>
__global__ void __launch_bounds__(kThreads)
kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv, int Sq,
          int Sk, int D, float scale, bool causal, bool has_window,
          int window, int offset) {
  using L = Layout<kDMax>;
  constexpr int kLd = L::kLd;
  extern __shared__ float4 kv_smem[];
  float* k_s = reinterpret_cast<float*>(kv_smem);
  float* v_s = k_s + L::kTile;
  float* q_s = v_s + L::kTile;
  float* do_s = q_s + L::kTile;
  float* p_s = do_s + L::kTile;        // [query row][key]
  float* ds_s = p_s + L::kScores;
  float* lse_s = ds_s + L::kScores;
  float* delta_s = lse_s + kBQ;

  const int bkv = blockIdx.y, b = bkv / Hkv, kvh = bkv % Hkv;
  const int group = H / Hkv;
  const int k0 = blockIdx.x * kBK, n_k = min(kBK, Sk - k0);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  stage<kDMax>(k_s, k + ((size_t)bkv * Sk + k0) * D, n_k, D);
  stage<kDMax>(v_s, v + ((size_t)bkv * Sk + k0) * D, n_k, D);

  // the query rows that may see a key of this tile (a superset)
  const int q_lo = causal ? max(0, k0 - offset) : 0;
  const int q_hi = has_window ? min(Sq, k0 + n_k - 1 + window - offset) : Sq;

  float dk_acc[4][kDMax / 16], dv_acc[4][kDMax / 16];   // keys 4 ty + a
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kDMax / 16; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.0f;

  for (int g = 0; g < group; ++g) {
    const size_t bh = (size_t)b * H + kvh * group + g;
    for (int q0 = q_lo; q0 < q_hi; q0 += kBQ) {
      const int n_q = min(kBQ, Sq - q0);
      __syncthreads();   // the previous tile's reads are done
      stage<kDMax>(q_s, q + (bh * Sq + q0) * D, n_q, D);
      stage<kDMax>(do_s, dout + (bh * Sq + q0) * D, n_q, D);
      stage_rows(lse_s, delta_s, lse + bh * Sq + q0, delta + bh * Sq + q0,
                 n_q);
      __syncthreads();

      float s[4][4], dp[4][4];
      tile_dots<kDMax>(q_s, k_s, ty, tx, s);
      tile_dots<kDMax>(do_s, v_s, ty, tx, dp);
      p_and_ds(s, dp, lse_s, delta_s, q0, n_q, k0, ty, tx, Sk, scale,
               causal, has_window, window, offset);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p_s[(4 * ty + i) * kLdS + tx + 16 * j] = s[i][j];
          ds_s[(4 * ty + i) * kLdS + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();

      // dv += p^T do, dk += ds^T q over this tile's rows
#pragma unroll 2
      for (int r = 0; r < n_q; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(p_s + r * kLdS +
                                                           4 * ty);
        const float4 dsv = *reinterpret_cast<const float4*>(ds_s + r * kLdS +
                                                            4 * ty);
        const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
        const float dsr[4] = {dsv.x, dsv.y, dsv.z, dsv.w};
#pragma unroll
        for (int c = 0; c < kDMax / 16; ++c) {
          const float dov = do_s[r * kLd + tx + 16 * c];
          const float qv = q_s[r * kLd + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            dv_acc[a][c] = fmaf(pr[a], dov, dv_acc[a][c]);
            dk_acc[a][c] = fmaf(dsr[a], qv, dk_acc[a][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = 4 * ty + a;
    if (key >= n_k) continue;
    const size_t row = ((size_t)bkv * Sk + k0 + key) * D;
#pragma unroll
    for (int c = 0; c < kDMax / 16; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        store(dk + row + d, dk_acc[a][c]);
        store(dv + row + d, dv_acc[a][c]);
      }
    }
  }
}

// grid (ceil(Sq / 64), B * H)
template <int kDMax, typename T>
__global__ void __launch_bounds__(kThreads)
q_kernel(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         T* __restrict__ dq, int H, int Hkv, int Sq, int Sk, int D,
         float scale, bool causal, bool has_window, int window, int offset) {
  using L = Layout<kDMax>;
  constexpr int kLd = L::kLd;
  extern __shared__ float4 q_smem[];
  float* q_s = reinterpret_cast<float*>(q_smem);
  float* do_s = q_s + L::kTile;
  float* k_s = do_s + L::kTile;
  float* v_s = k_s + L::kTile;
  float* ds_t = v_s + L::kTile;        // [key][query row]
  float* lse_s = ds_t + L::kScores;
  float* delta_s = lse_s + kBQ;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = b * Hkv + h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ, n_q = min(kBQ, Sq - q0);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  stage<kDMax>(q_s, q + ((size_t)bh * Sq + q0) * D, n_q, D);
  stage<kDMax>(do_s, dout + ((size_t)bh * Sq + q0) * D, n_q, D);
  stage_rows(lse_s, delta_s, lse + (size_t)bh * Sq + q0,
             delta + (size_t)bh * Sq + q0, n_q);

  // the keys any row of this tile may see (a superset of the mask's)
  const int pos_lo = q0 + offset, pos_hi = q0 + n_q - 1 + offset;
  const int k_end = causal ? min(Sk, pos_hi + 1) : Sk;
  const int k_begin = has_window ? max(0, pos_lo - window + 1) / kBK * kBK
                                 : 0;

  float acc[4][kDMax / 16];   // rows 4 ty + a, columns tx + 16 c
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kDMax / 16; ++c) acc[a][c] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    const int n_k = min(kBK, Sk - k0);
    __syncthreads();   // the previous tile's reads are done
    stage<kDMax>(k_s, k + ((size_t)kvh * Sk + k0) * D, n_k, D);
    stage<kDMax>(v_s, v + ((size_t)kvh * Sk + k0) * D, n_k, D);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dots<kDMax>(q_s, k_s, ty, tx, s);
    tile_dots<kDMax>(do_s, v_s, ty, tx, dp);
    p_and_ds(s, dp, lse_s, delta_s, q0, n_q, k0, ty, tx, Sk, scale, causal,
             has_window, window, offset);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(ds_t + (tx + 16 * j) * kLdS + 4 * ty) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    __syncthreads();

    // dq += ds k over this tile's keys
#pragma unroll 2
    for (int c = 0; c < n_k; ++c) {
      const float4 dsv = *reinterpret_cast<const float4*>(ds_t + c * kLdS +
                                                          4 * ty);
      const float dsr[4] = {dsv.x, dsv.y, dsv.z, dsv.w};
#pragma unroll
      for (int m = 0; m < kDMax / 16; ++m) {
        const float kv = k_s[c * kLd + tx + 16 * m];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][m] = fmaf(dsr[a], kv, acc[a][m]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = 4 * ty + a;
    if (r >= n_q) continue;
    const size_t row = ((size_t)bh * Sq + q0 + r) * D;
#pragma unroll
    for (int m = 0; m < kDMax / 16; ++m) {
      const int d = tx + 16 * m;
      if (d < D) store(dq + row + d, acc[a][m]);
    }
  }
}

// ---------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;   // above only by opting in
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, H, Hkv, Sq, Sk, D;
  float scale;
  int causal, has_window, window, offset;
  cudaStream_t stream;
};

template <int kDMax, typename T>
int launch_kv(const Args& a) {
  auto kernel = kv_kernel<kDMax, T>;
  const size_t smem = Layout<kDMax>::kKvBytes;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sk + kBK - 1) / kBK, a.B * a.Hkv);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
      a.delta, (T*)a.dk, (T*)a.dv, a.H, a.Hkv, a.Sq, a.Sk, a.D, a.scale,
      a.causal != 0, a.has_window != 0, a.window, a.offset);
  return cudaGetLastError();
}

template <int kDMax, typename T>
int launch_q(const Args& a) {
  auto kernel = q_kernel<kDMax, T>;
  const size_t smem = Layout<kDMax>::kQBytes;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.H);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
      a.delta, (T*)a.dq, a.H, a.Hkv, a.Sq, a.Sk, a.D, a.scale,
      a.causal != 0, a.has_window != 0, a.window, a.offset);
  return cudaGetLastError();
}

template <bool kKv, typename T>
int launch_d(const Args& a) {
  if (a.D <= 32) return kKv ? launch_kv<32, T>(a) : launch_q<32, T>(a);
  if (a.D <= 64) return kKv ? launch_kv<64, T>(a) : launch_q<64, T>(a);
  return kKv ? launch_kv<128, T>(a) : launch_q<128, T>(a);
}

template <bool kKv>
int launch(int device, const Args& a, int bf16) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (bf16) return launch_d<kKv, __nv_bfloat16>(a);
  return launch_d<kKv, float>(a);
}

}  // namespace

extern "C" {

// q, dout (B, H, Sq, D); k, v (B, Hkv, Sk, D); lse, delta (B, H, Sq) f32;
// D <= 128 (the wrapper checks).  bf16: 0 for f32 tensors, 1 for bf16 ones.
// window: only read when has_window.  Writes dk and dv (B, Hkv, Sk, D).
int flash_attention_bwd_kv_launch(int device, const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int H, int Hkv,
                                  int Sq, int Sk, int D, float scale,
                                  int causal, int has_window, int window,
                                  int offset, int bf16, void* stream) {
  const Args a{q,  k,  v, dout, (const float*)lse, (const float*)delta,
               nullptr, dk, dv, B, H, Hkv, Sq, Sk, D, scale, causal,
               has_window, window, offset, (cudaStream_t)stream};
  return launch<true>(device, a, bf16);
}

// The same inputs; writes dq (B, H, Sq, D).
int flash_attention_bwd_q_launch(int device, const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq,
                                 int B, int H, int Hkv, int Sq, int Sk, int D,
                                 float scale, int causal, int has_window,
                                 int window, int offset, int bf16,
                                 void* stream) {
  const Args a{q,  k,  v, dout, (const float*)lse, (const float*)delta,
               dq, nullptr, nullptr, B, H, Hkv, Sq, Sk, D, scale, causal,
               has_window, window, offset, (cudaStream_t)stream};
  return launch<false>(device, a, bf16);
}

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
