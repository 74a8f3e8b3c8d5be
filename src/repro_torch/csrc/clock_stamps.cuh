// clock64() stamps of a kernel's phases, per CTA, in a debug build only.
//
// Compiled with -DCLOCK_STAMPS (``kernels._build.DEFINES``), a kernel
// declares `Clock clk;` at its start, calls `clk.lap(i)` at the end of each
// timed phase (the cycles since the previous lap go to part i;
// `clk.sync_lap(i)` for a phase that ends in a CTA barrier), and
// `clk.save(x)` once; thread 0 of each CTA stores (parts 0 .. kParts - 1,
// cycles since the start, x) in `g_stamps`, which the library's
// `<name>_clock_stamps` export copies out.  Without the flag every call is
// empty and the kernel's code is unchanged.
#pragma once
#include <cuda_runtime.h>

#ifdef CLOCK_STAMPS
constexpr int kStampCtas = 8192, kParts = 5;
__device__ long long g_stamps[kStampCtas][kParts + 2];

struct Clock {
  long long t0, t, parts[kParts];
  __device__ Clock() {
    t0 = t = clock64();
    for (int i = 0; i < kParts; ++i) parts[i] = 0;
  }
  __device__ void lap(int i) {
    const long long now = clock64();
    parts[i] += now - t;
    t = now;
  }
  // A CTA barrier, then lap i.  The lap waits for the barrier's result, so
  // its clock is read once the barrier has completed (a clock read right
  // after `__syncthreads()` may issue before it does).
  __device__ void sync_lap(int i) {
    if (__syncthreads_count(1) > 0) lap(i);
  }
  __device__ void save(long long x) {
    const int cta = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                    blockIdx.x;
    if (threadIdx.x != 0 || cta >= kStampCtas) return;
    for (int i = 0; i < kParts; ++i) g_stamps[cta][i] = parts[i];
    g_stamps[cta][kParts] = clock64() - t0;
    g_stamps[cta][kParts + 1] = x;
  }
};

inline int copy_stamps(void* host, int n_ctas) {
  const int n = n_ctas < kStampCtas ? n_ctas : kStampCtas;
  return cudaMemcpyFromSymbol(host, g_stamps, n * sizeof(g_stamps[0]));
}
#else
struct Clock {
  __device__ void lap(int) {}
  __device__ void sync_lap(int) { __syncthreads(); }
  __device__ void save(long long) {}
};
#endif
