// RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * w, f32 math, cast
// back to x's type.
//
// Replaces the Pallas TPU kernel rmsnorm (src/repro/kernels/rmsnorm/kernel.py).
// Bound: bytes. One read of x, one write of y and a D-wide weight against
// ~4 flops per element. One block per row: the block's threads stride the
// row with coalesced loads, reduce the sum of squares in f32 (warp shuffles,
// then shared memory), and a second sweep over the row (an L1/L2 hit at
// these widths) scales and stores it. No row padding is needed: the grid is
// exactly the row count.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename TX, typename TW>
__global__ void rmsnorm_kernel(const TX* __restrict__ x,
                               const TW* __restrict__ w, TX* __restrict__ y,
                               int64_t d, float eps) {
  const int64_t base = (int64_t)blockIdx.x * d;
  float ss = 0.0f;
  for (int64_t c = threadIdx.x; c < d; c += kThreads) {
    float v = to_f32(x[base + c]);
    ss = __fadd_rn(ss, __fmul_rn(v, v));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_down_sync(0xffffffffu, ss, o);
  __shared__ float part[kThreads / 32];
  __shared__ float scale;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < kThreads / 32 ? part[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_down_sync(0xffffffffu, ss, o);
    if (lane == 0) scale = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)d), eps));
  }
  __syncthreads();
  const float r = scale;
  for (int64_t c = threadIdx.x; c < d; c += kThreads) {
    float v = __fmul_rn(to_f32(x[base + c]), r);
    y[base + c] = from_f32<TX>(__fmul_rn(v, to_f32(w[c])));
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* y, int64_t rows, int64_t d,
           float eps, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  rmsnorm_kernel<TX, TW><<<(unsigned)rows, kThreads, 0, (cudaStream_t)stream>>>(
      (const TX*)x, (const TW*)w, (TX*)y, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16
int rmsnorm_fwd(const void* x, const void* w, void* y, int64_t rows, int64_t d,
                float eps, int x_dtype, int w_dtype, void* stream) {
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, w, y, rows, d, eps, stream);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, d, eps, stream);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, y, rows, d, eps, stream);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(x, w, y, rows, d, eps, stream);
  return (int)cudaErrorInvalidValue;
}

const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
