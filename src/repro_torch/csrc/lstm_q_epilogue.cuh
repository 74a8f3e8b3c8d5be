// The int8 datapath of the Chipmunk LSTM cell, shared by K3
// (`lstm_seq_q.cu`) and K4 (`lstm_stack_seq_q.cu`): the exact tile MACs on
// the int8 tensor cores, the serial saturating hop chain in registers, the
// epilogue of `core.systolic._quantized_state_update`, operation for
// operation, and the mask select.  `>>` on a signed int is an arithmetic
// shift.
//
// Tile MACs.  One `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32` (no
// `.satfinite`) multiplies 16 weight rows by 8 streams over 32 k.  A column
// tile of `tile` k is padded with zeros to `tile_k(tile)` (a multiple of 32)
// in the weights, so no k-step straddles two column tiles; its MMAs start
// from a zero accumulator, whose int32 sum is exact (|sum| <= 96 * 128 *
// 128 < 2^31 at the silicon's tile).  Each element is then saturated to
// int16 and added into the hop chain with a saturation after the add, tile
// after tile in the silicon's column order (`hop_tiles`).
//
// Layout of a fragment.  A row group is 8 hidden rows: m-tile 0 holds gate i
// (m-rows 0-7) and gate f (8-15) of those rows, m-tile 1 gates g and o.  A
// task (row group, 8-stream chunk) goes to a pair of dot warps, one m-tile
// each.  In a C fragment lane l holds m-rows l / 4 and l / 4 + 8 for
// streams 2 (l % 4) and 2 (l % 4) + 1; the two warps trade the sums of one
// stream through shared memory (`trade`), so lane l of the pair's warp h
// holds all four gate sums of its hidden row for stream 2 (l % 4) + h and
// runs the epilogue (`state_update`) for it.  A weight block is 32 m-rows of
// `sw` bytes, loaded by `ldmatrix.x4`; an h plane is (streams, padded_h)
// row-major at `sp` bytes a stream: the `.col` B operand as it lies (a lane
// reads 4 consecutive k of its stream as one word).  Both strides are odd
// multiples of 16 bytes, so the 8 rows of a fragment load fall in 8
// distinct 16-byte bank groups.
#pragma once

#include <stdint.h>

#include "lstm_exchange.cuh"

namespace lstm_q {

using lstm_exchange::round_up;

__device__ __forceinline__ int sat16(int x) {
  return min(max(x, -32768), 32767);
}
__device__ __forceinline__ int clip8(int x) { return min(max(x, -128), 127); }
__device__ __forceinline__ int rshift_round(int x, int s) {
  return (x + (1 << (s - 1))) >> s;
}

// One gate: sat16 -> >>5 rounded -> clip -> LUT.
__device__ __forceinline__ int gate_lut(int a, const int8_t* lut) {
  return lut[clip8(rshift_round(sat16(a), 5)) + 128];
}

struct Codes {
  int8_t h, c;
};

// One (row n, stream) update from the four hop-chain accumulators (gate
// order i, f, g, o): gate = LUT(clip(sat16(acc + bias (+ peep * c)) >> 5));
// c = clip(sat16(f*c + (i*g >> 2)) >> 7); the o gate's peephole reads the
// clipped c; h = clip((o * tanh_lut(c)) >> 9).  A masked step (`live`
// false) re-emits the carried `h_prev` and keeps `c_prev`.  `bias` is
// (4, stride), `peep` (3, stride); `luts` holds the sigmoid LUT at [0, 256)
// and the tanh LUT at [256, 512).
__device__ __forceinline__ Codes state_update(const int acc[4], int c_prev,
                                              int8_t h_prev, bool live,
                                              const int16_t* bias,
                                              const int8_t* peep, int stride,
                                              int n, const int8_t* luts) {
  const int ig = gate_lut(acc[0] + bias[0 * stride + n] +
                              peep[0 * stride + n] * c_prev, luts);
  const int fg = gate_lut(acc[1] + bias[1 * stride + n] +
                              peep[1 * stride + n] * c_prev, luts);
  const int gg = gate_lut(acc[2] + bias[2 * stride + n], luts + 256);
  const int c_new = sat16(fg * c_prev + rshift_round(ig * gg, 2));
  const int c8 = clip8(rshift_round(c_new, 7));
  const int og = gate_lut(acc[3] + bias[3 * stride + n] +
                              peep[2 * stride + n] * c8, luts);
  const int h8 = clip8(rshift_round(og * luts[256 + c8 + 128], 9));
  if (!live) return Codes{h_prev, (int8_t)c_prev};
  return Codes{(int8_t)h8, (int8_t)c8};
}

// --- launch shape and shared memory ---------------------------------------

constexpr int kGroup = 8;          // hidden rows of one row group
constexpr int kChunk = 8;          // streams of one n8 chunk
constexpr int kMaxDotWarps = 8;

// k bytes of one column tile in shared memory: the MMA's 32 k per step
__host__ __device__ constexpr int tile_k(int tile) {
  return (tile + 31) / 32 * 32;
}
// A row stride of at least `bytes`, an odd multiple of 16.
__host__ __device__ constexpr size_t row_stride(size_t bytes) {
  return (bytes + 31) / 32 * 32 + 16;
}

// Shared memory of a CTA that owns R hidden rows (R / 8 row groups) of a
// layer, byte offsets:
//   2 mbarriers on their own 128-byte line (the own h plane; the plane
//   below, or K4 layer 0's acc_x rows, or K3's x plane)
//   | `nplanes` h planes [chunks * 8][sp] (+ 32 bytes, which the last
//   tile's padded k-step may read past a row), each from a 128-byte line
//   | K3 (`P_x` > 0): two steps' x planes [chunks * 8][sx], the same way
//   | `fams` weight blocks [R / 8][32][sw], each row its `cols` column
//   tiles of `kp` bytes | the hop chains that wait for a plane, 8 bytes a
//   lane, task and m-tile | K4 (`prefix`): two steps' acc_x rows of layer
//   0, [chunks * 8][4 gates][R] int32 | each warp pair's traded sums, two
//   rounds of 8 bytes a lane and warp | c codes [R][chunks * 8] | bias
//   int16 [4][R], peep [3][R] | two steps' mask rows | both LUTs
// Threads: R / 8 * chunks tasks (row group, chunk) over `dot_warps` / 2
// pairs of dot warps, then one producer warp.
struct Layout {
  int groups, chunks, tasks, dot_warps, kp;
  size_t sp, sx, sw, planes, plane, x, xplane, w, spill, prefix, trade, c,
      consts, mask, mask_row, lut, total;
};
__host__ __device__ inline Layout layout(int B, int P_h, int P_x, int tile,
                                         int R, int cols, int fams,
                                         int nplanes, bool prefix) {
  Layout Q;
  Q.groups = R / kGroup;
  Q.chunks = (B + kChunk - 1) / kChunk;
  Q.tasks = Q.groups * Q.chunks;
  Q.dot_warps = 2 * Q.tasks < kMaxDotWarps ? 2 * Q.tasks : kMaxDotWarps;
  Q.kp = tile_k(tile);
  Q.sp = row_stride(P_h);
  Q.sx = row_stride(P_x);
  Q.sw = row_stride((size_t)cols * Q.kp);
  Q.planes = 128;
  Q.plane = round_up((size_t)kChunk * Q.chunks * Q.sp + 32, 128);
  Q.x = Q.planes + nplanes * Q.plane;
  Q.xplane =
      P_x > 0 ? round_up((size_t)kChunk * Q.chunks * Q.sx + 32, 128) : 0;
  Q.w = Q.x + 2 * Q.xplane;
  Q.spill = Q.w + (size_t)fams * 4 * R * Q.sw;
  Q.prefix = Q.spill + (size_t)16 * 32 * Q.tasks;
  Q.trade = Q.prefix + (prefix ? (size_t)64 * 32 * Q.tasks : 0);
  Q.c = Q.trade + (size_t)16 * 32 * Q.dot_warps;
  Q.consts = Q.c + round_up((size_t)R * kChunk * Q.chunks, 16);
  Q.mask = Q.consts + round_up((size_t)11 * R, 16);
  Q.mask_row = round_up((size_t)kChunk * Q.chunks, 16);
  Q.lut = Q.mask + 2 * Q.mask_row;
  Q.total = Q.lut + 512;
  return Q;
}
__host__ __device__ inline int threads(const Layout& Q) {
  return 32 * (Q.dot_warps + 1);
}

// --- staging ---------------------------------------------------------------

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   lstm_exchange::smem_u32(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

// Requests one family's weight block: m-row q = 32 * group + 16 * mt + r
// holds gate 2 mt + r / 8 of local row 8 * group + r % 8, i.e. the row
// `rows(gate, local row)` of a dense (gate, n, k) matrix (nullptr: a row
// past padded_h, all zeros), column tile c from its byte c * tile into
// [c * kp, c * kp + tile), zeros up to (c + 1) * kp.  16-byte `cp.async`s
// where every piece is 16-byte aligned (`vec16`), else 4-byte ones.
template <typename Rows>
__device__ __forceinline__ void stage_weights(unsigned char* w_s, Rows rows,
                                              const Layout& Q, int cols,
                                              int tile, bool vec16, int tid,
                                              int nthreads) {
  const int q = vec16 ? 16 : 4;
  // one (m-row, column tile) pair a thread, its pieces in an inner loop
#pragma unroll 1
  for (int i = tid; i < 32 * Q.groups * cols; i += nthreads) {
    const int m = i / cols, c = i % cols;
    const int gate = 2 * ((m >> 4) & 1) + ((m >> 3) & 1);
    const int8_t* row = rows(gate, 8 * (m >> 5) + (m & 7));
    const int8_t* src = row + (size_t)c * tile;
    unsigned char* dst = w_s + (size_t)m * Q.sw + c * Q.kp;
#pragma unroll 1
    for (int k = 0; k < Q.kp; k += q) {
      if (row != nullptr && k < tile) {
        if (vec16)
          cp_async_16(dst + k, src + k);
        else
          lstm_exchange::cp_async_4(dst + k, src + k);
      } else if (vec16) {
        *reinterpret_cast<uint4*>(dst + k) = make_uint4(0, 0, 0, 0);
      } else {
        *reinterpret_cast<unsigned*>(dst + k) = 0;
      }
    }
  }
}

// Requests `rows` rows of `n` bytes, row q from src + q * n into dst + q *
// stride (`stride` a multiple of 16): by 16-byte `cp.async`s when `src`
// and `n` allow, else 4-byte ones (`n` is a multiple of 4), else by plain
// byte copies, which take any alignment.
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const int8_t* src, int rows, int n,
                                           size_t stride, int tid,
                                           int nthreads) {
  const int q = ((uintptr_t)src | n) % 16 == 0 ? 16
                : (uintptr_t)src % 4 == 0       ? 4
                                                : 1;
#pragma unroll 1
  for (int r = 0; r < rows; ++r) {
    const int8_t* s = src + (size_t)r * n;
    unsigned char* d = dst + (size_t)r * stride;
#pragma unroll 1
    for (int k = q * tid; k < n; k += q * nthreads) {
      if (q == 16)
        cp_async_16(d + k, s + k);
      else if (q == 4)
        lstm_exchange::cp_async_4(d + k, s + k);
      else
        d[k] = (unsigned char)s[k];
    }
  }
}

// Step t's mask row into its slot (t % 2), by plain loads: threads tid,
// tid + nthreads, ...
__device__ __forceinline__ void load_mask(unsigned char* smem,
                                          const Layout& Q,
                                          const unsigned char* mask, int t,
                                          int B, int tid, int nthreads) {
  unsigned char* row = smem + Q.mask + (t & 1) * Q.mask_row;
#pragma unroll 1
  for (int b = tid; b < B; b += nthreads) row[b] = mask[(size_t)t * B + b];
}
// Where step t's mask row sits.
__device__ __forceinline__ const unsigned char* mask_row(
    const unsigned char* smem, const Layout& Q, int t) {
  return smem + Q.mask + (t & 1) * Q.mask_row;
}

// One bulk copy of `bytes` (a multiple of 16; both ends 16-byte aligned)
// onto `bar`, which an arrival elsewhere has armed with its bytes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(lstm_exchange::smem_u32(dst)),
      "l"(__cvta_generic_to_global(src)), "r"(bytes),
      "r"(lstm_exchange::smem_u32(bar))
      : "memory");
}

// A bulk copy of `rows` rows of `n` bytes (a multiple of 16; `src`
// 16-byte aligned), row q from src + q * n to dst + q * stride, onto `bar`:
// one arrival armed with every row's bytes.
__device__ __forceinline__ void bulk_rows(unsigned char* dst,
                                          const int8_t* src, int rows, int n,
                                          size_t stride, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          lstm_exchange::smem_u32(bar)),
      "r"(rows * n)
      : "memory");
#pragma unroll 1
  for (int q = 0; q < rows; ++q)
    bulk_copy(dst + (size_t)q * stride, src + (size_t)q * n, n, bar);
}

// The first h plane (`h0`, (B, P_h) of this layer), c0, bias, peep, the
// mask row of step 0 and both LUTs: `c0` (B, P_h); `bias` (4, P_h); `peep`
// (3, P_h).
__device__ __forceinline__ void stage_state(
    unsigned char* smem, const Layout& Q, const int8_t* h0, const int8_t* c0,
    const int16_t* bias, const int8_t* peep, const unsigned char* mask,
    const int8_t* sig_lut, const int8_t* tanh_lut, int B, int P_h, int R,
    int row0, int tid, int nthreads) {
  const int B8 = kChunk * Q.chunks;
  stage_rows(smem + Q.planes, h0, B, P_h, Q.sp, tid, nthreads);
  stage_rows(smem + Q.lut, sig_lut, 1, 256, 256, tid, nthreads);
  stage_rows(smem + Q.lut + 256, tanh_lut, 1, 256, 256, tid, nthreads);
  load_mask(smem, Q, mask, 0, B, tid, nthreads);
  int8_t* c_s = reinterpret_cast<int8_t*>(smem + Q.c);
#pragma unroll 1
  for (int i = tid; i < R * B8; i += nthreads) {
    const int r = i / B8, b = i % B8, n = row0 + r;
    c_s[i] = n < P_h && b < B ? c0[(size_t)b * P_h + n] : 0;
  }
  int16_t* bias_s = reinterpret_cast<int16_t*>(smem + Q.consts);
  int8_t* peep_s = reinterpret_cast<int8_t*>(smem + Q.consts + 8 * R);
#pragma unroll 1
  for (int i = tid; i < 7 * R; i += nthreads) {
    const int g = i / R, r = i % R, n = row0 + r;
    if (g < 4)
      bias_s[i] = n < P_h ? bias[(size_t)g * P_h + n] : 0;
    else
      peep_s[i - 4 * R] = n < P_h ? peep[(size_t)(g - 4) * P_h + n] : 0;
  }
}

// --- the tile MACs (one dot warp) -------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(unsigned a[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void mma_s8(int d[4], const unsigned a[4],
                                       const unsigned b[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// This lane's `ldmatrix` row address in a weight block's m-tile (16
// m-rows from `tile16`): lanes 8 j .. 8 j + 7 address the rows of matrix j
// (m-rows 0-7, 8-15, 0-7, 8-15 at k + 0, + 0, + 16, + 16).
__device__ __forceinline__ uint32_t a_lane(const unsigned char* tile16,
                                           size_t sw, int lane) {
  return lstm_exchange::smem_u32(
      tile16 + (size_t)((lane & 7) + 8 * ((lane >> 3) & 1)) * sw +
      16 * (lane >> 4));
}

// One k-step's operands of `n` column tiles from tile c0 on, and their
// MMAs.
template <int n, typename LoadB>
__device__ __forceinline__ void load_step(unsigned b[n][2], unsigned w[n][4],
                                          uint32_t a, int kp, int c0, int k,
                                          LoadB& ldb) {
#pragma unroll
  for (int u = 0; u < n; ++u) {
    ldb(c0 + u, k, b[u]);
    ldmatrix_x4(w[u], a + (c0 + u) * kp + k);
  }
}
template <int n>
__device__ __forceinline__ void mma_step(int acc[n][4], unsigned b[n][2],
                                         unsigned w[n][4]) {
#pragma unroll
  for (int u = 0; u < n; ++u) mma_s8(acc[u], w[u], b[u]);
}

// `n` column tiles of one m-tile from tile c0 on, each its own accumulator,
// so their MMAs depend on each other only along one tile's k-steps.  The
// k-steps are software-pipelined over two register sets: the next step's
// operands are requested before this step's MMAs issue (the last request
// repeats the last step and goes unused), so a step waits for one load
// latency, not one per tile.  Then each tile's sum, saturated to int16, is
// added into the chain in column order with a saturation after the add.
// No branch around `ldmatrix` or `mma`: both need the whole warp, and a
// branch per tile serialized them.
template <int n, typename LoadB>
__device__ __forceinline__ void hop_batch(int chain[4], uint32_t a, int kp,
                                          int c0, LoadB& ldb) {
  int acc[n][4] = {};
  unsigned b0[n][2], w0[n][4], b1[n][2], w1[n][4];
  const int last = kp - 32;
  load_step<n>(b0, w0, a, kp, c0, 0, ldb);
#pragma unroll 1
  for (int k = 0;; k += 64) {
    load_step<n>(b1, w1, a, kp, c0, min(k + 32, last), ldb);
    mma_step<n>(acc, b0, w0);
    if (k + 32 > last) break;
    load_step<n>(b0, w0, a, kp, c0, min(k + 64, last), ldb);
    mma_step<n>(acc, b1, w1);
    if (k + 64 > last) break;
  }
#pragma unroll
  for (int u = 0; u < n; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      chain[i] = sat16(chain[i] + sat16(acc[u][i]));
}

// The hop chain of one m-tile over `cols` column tiles: `chain` (this
// lane's C fragment) += each tile's exact sum, saturated to int16, with a
// saturation after every add, in batches of up to `kBatch` tiles
// (`hop_batch`).  `a` is `a_lane` of the m-tile at the family's first
// tile; `ldb(c, k, b)` sets b[0], b[1] to this lane's B words of tile c at
// k-step offset k (bytes k + 4 (lane % 4) and k + 16 + 4 (lane % 4) of the
// tile, of stream lane / 4).
constexpr int kBatch = 5;
template <typename LoadB>
__device__ __forceinline__ void hop_tiles(int chain[4], uint32_t a, int kp,
                                          int cols, LoadB ldb) {
#pragma unroll 1
  for (int c0 = 0; c0 < cols; c0 += kBatch) {
    switch (min(cols - c0, kBatch)) {
      case 5: hop_batch<5>(chain, a, kp, c0, ldb); break;
      case 4: hop_batch<4>(chain, a, kp, c0, ldb); break;
      case 3: hop_batch<3>(chain, a, kp, c0, ldb); break;
      case 2: hop_batch<2>(chain, a, kp, c0, ldb); break;
      default: hop_batch<1>(chain, a, kp, c0, ldb); break;
    }
  }
}

// A chain's 4 values, each within int16, as one 8-byte word and back: a
// chain waits in shared memory while its lane works on its other tasks.
__device__ __forceinline__ uint2 pack_chain(const int chain[4]) {
  return make_uint2((unsigned)(chain[0] & 0xffff) | ((unsigned)chain[1] << 16),
                    (unsigned)(chain[2] & 0xffff) | ((unsigned)chain[3] << 16));
}
__device__ __forceinline__ void unpack_chain(uint2 v, int chain[4]) {
  chain[0] = (int)(short)(v.x & 0xffff);
  chain[1] = (int)v.x >> 16;
  chain[2] = (int)(short)(v.y & 0xffff);
  chain[3] = (int)v.y >> 16;
}

// The pair's trade: warp `half` (m-tile `half`, gates 2 half and 2 half +
// 1) keeps stream 2 (lane % 4) + half and hands its sums of the other
// stream to its partner, through round `round`'s slots (`trade`: [pairs][2
// rounds][2 halves][32] int2; a slot is written again only two rounds
// later, after the partner's next barrier); `bar` is the pair's named
// barrier.  Returns the four gate sums (i, f, g, o) of the kept stream.
__device__ __forceinline__ void trade(int2* slots, int pair, int half,
                                      int round, int lane, const int chain[4],
                                      int acc[4]) {
  int2* base = slots + ((pair * 2 + (round & 1)) * 2) * 32;
  base[half * 32 + lane] = make_int2(chain[1 - half], chain[3 - half]);
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + pair) : "memory");
  const int2 o = base[(1 - half) * 32 + lane];
  const int mine0 = chain[half], mine1 = chain[2 + half];
  acc[0] = half == 0 ? mine0 : o.x;
  acc[1] = half == 0 ? mine1 : o.y;
  acc[2] = half == 0 ? o.x : mine0;
  acc[3] = half == 0 ? o.y : mine1;
}

}  // namespace lstm_q
