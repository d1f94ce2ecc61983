// Launch counting inside the kernels, shared by every family's source.
//
// Each kernel adds one to its slot of `g_launch_counts` from thread 0 of
// block 0 as it starts, so a count is the number of times the kernel ran on
// the device: eager launches and the launches a CUDA graph replays alike
// (a graph runs its kernels without calling the host wrappers). The
// counters are per device and per library; `launch_counts` copies them to
// the host (a synchronous copy: it waits for the device) and optionally
// zeroes them. Define LAUNCH_COUNT_SLOTS before including this header when
// a family has more than one counted kernel.
//
// The host code that launches a kernel also records the launch's geometry
// (`record_launch`): `last_launch` reports the library's last launch, so the
// card can hold each launch to its static description (the port's
// kernels/meta.py `CudaLaunch`, built by each family's `launch_meta`).
#pragma once
#include <cuda_runtime.h>

#ifndef LAUNCH_COUNT_SLOTS
#define LAUNCH_COUNT_SLOTS 1
#endif

__device__ unsigned long long g_launch_counts[LAUNCH_COUNT_SLOTS];

__device__ __forceinline__ void count_launch(int slot) {
  if ((threadIdx.x | threadIdx.y | threadIdx.z | blockIdx.x | blockIdx.y |
       blockIdx.z) == 0)
    atomicAdd(&g_launch_counts[slot], 1ull);
}

// The last launch this library made, as the host asked for it.
struct LastLaunch {
  const void* func;
  unsigned grid[3], block[3], cluster[3];
  long long dynamic_smem;
};
static LastLaunch g_last_launch = {};

static inline void record_launch(const void* func, dim3 grid, dim3 block,
                                 size_t dynamic_smem,
                                 dim3 cluster = dim3(1, 1, 1)) {
  LastLaunch& r = g_last_launch;
  r.func = func;
  r.grid[0] = grid.x, r.grid[1] = grid.y, r.grid[2] = grid.z;
  r.block[0] = block.x, r.block[1] = block.y, r.block[2] = block.z;
  r.cluster[0] = cluster.x, r.cluster[1] = cluster.y, r.cluster[2] = cluster.z;
  r.dynamic_smem = (long long)dynamic_smem;
}

extern "C" {

// The geometry of this library's last launch into `out` (13 values): grid
// x, y, z; block x, y, z; cluster x, y, z; dynamic shared bytes; then from
// cudaFuncGetAttributes of the launched kernel its static shared bytes, its
// dynamic shared limit (raised above 48 KB only by an opt-in) and its
// registers a thread. All zero before the first launch.
int last_launch(long long* out, int n) {
  if (n < 13) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 13; ++i) out[i] = 0;
  if (!g_last_launch.func) return 0;
  for (int i = 0; i < 3; ++i) {
    out[i] = g_last_launch.grid[i];
    out[3 + i] = g_last_launch.block[i];
    out[6 + i] = g_last_launch.cluster[i];
  }
  out[9] = g_last_launch.dynamic_smem;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, g_last_launch.func);
  if (e != cudaSuccess) return (int)e;
  out[10] = (long long)a.sharedSizeBytes;
  out[11] = (long long)a.maxDynamicSharedSizeBytes;
  out[12] = (long long)a.numRegs;
  return 0;
}

// Copy the first `n` counters of the current device into `out`; with
// `reset`, zero them afterwards.
int launch_counts(unsigned long long* out, int n, int reset) {
  if (n < 1 || n > LAUNCH_COUNT_SLOTS) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(unsigned long long) * n;
  cudaError_t e = cudaMemcpyFromSymbol(out, g_launch_counts, bytes);
  if (e != cudaSuccess || !reset) return (int)e;
  unsigned long long zero[LAUNCH_COUNT_SLOTS] = {};
  return (int)cudaMemcpyToSymbol(g_launch_counts, zero, bytes);
}

}  // extern "C"
