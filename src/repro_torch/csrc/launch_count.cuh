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

extern "C" {

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
