// RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * w, f32 math, cast
// back to x's type.
//
// Replaces the Pallas TPU kernel rmsnorm (src/repro/kernels/rmsnorm/kernel.py).
// Bound: bytes. One read of x and one write of y against ~4 flops per
// element, so the kernel has to touch x once and stream it at the card's
// memory rate. Two variants, picked by the launcher's plan
// (kernels/rmsnorm/kernel.py `plan`) from the width, the type and the
// operands' alignment:
//
// * rows in registers (rmsnorm_rows_kernel): a row belongs to a group of
//   `threads_per_row` threads (whole warps), and a block holds several such
//   groups. Thread t of a group loads the row's vectors t, t + T, t + 2T, ...
//   (at most kMaxVecs of them) with one load each and keeps them in
//   registers from the sum of squares to the scaled store, so x is read from
//   device memory once. The block stages w in shared memory once, while its
//   rows' loads are in flight, and its row groups read it from there.
//   Widths up to kMaxVecs * kBlockThreads vectors: 8192 bf16 or 4096 f32
//   with 16-byte vectors.
// * two sweeps (rmsnorm_sweep_kernel), for wider rows: one block per row,
//   the sum of squares over the row, then a second sweep that re-reads x
//   (an L2 hit) to scale and store it.
//
// Vectors are 16 bytes (8 bf16 or 4 f32) when the width is a multiple of
// that and x and w are 16-byte aligned; otherwise one element (`VEC` = 1).
// They are held as raw 32-bit words and moved with explicit 16-byte
// accesses, and a bf16 becomes an f32 by a shift. The arithmetic is the
// plain version's, rounded explicitly: an f32 sum of squares,
// __fdiv_rn(ss, d), + eps, rsqrtf, x*r, *w, then a round-to-nearest cast to
// the output type. Every thread of a row reduces the warp and block partials
// in the same order, so all of them scale by the same r.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_count.cuh"

namespace {

constexpr int kMaxVecs = 4;         // vectors a thread holds of a row
constexpr int kBlockThreads = 256;  // threads of a block (both variants)
constexpr int kMinBlocks = 6;       // resident blocks: <= 40 registers

// N elements of T (float or bf16) as raw 32-bit words, moved as one access
// of up to 16 bytes (two for 32); a lone bf16 sits in the low half of u[0]
template <typename T, int N>
struct Vec {
  static constexpr int kBytes = (int)sizeof(T) * N;
  static constexpr int kWords = kBytes < 4 ? 1 : kBytes / 4;
  uint32_t u[kWords];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kBytes >= 16) {
#pragma unroll
      for (int k = 0; k < kBytes / 16; ++k) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[k];
        u[4 * k] = v.x;
        u[4 * k + 1] = v.y;
        u[4 * k + 2] = v.z;
        u[4 * k + 3] = v.w;
      }
    } else if constexpr (kBytes == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      u[0] = v.x;
      u[1] = v.y;
    } else if constexpr (kBytes == 4) {
      u[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      u[0] = *reinterpret_cast<const unsigned short*>(p);
    }
  }

  __device__ __forceinline__ void store(T* p) const {
    if constexpr (kBytes >= 16) {
#pragma unroll
      for (int k = 0; k < kBytes / 16; ++k)
        reinterpret_cast<uint4*>(p)[k] =
            make_uint4(u[4 * k], u[4 * k + 1], u[4 * k + 2], u[4 * k + 3]);
    } else if constexpr (kBytes == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
    } else if constexpr (kBytes == 4) {
      *reinterpret_cast<uint32_t*>(p) = u[0];
    } else {
      *reinterpret_cast<unsigned short*>(p) = (unsigned short)u[0];
    }
  }

  // element e as f32 (exact)
  __device__ __forceinline__ float get(int e) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(u[e]);
    } else {
      const uint32_t w = u[e >> 1];
      return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
    }
  }

  // element e from f32, rounded to nearest (elements set in order from 0)
  __device__ __forceinline__ void set(int e, float v) {
    if constexpr (sizeof(T) == 4) {
      u[e] = __float_as_uint(v);
    } else {
      const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(v));
      u[e >> 1] = (e & 1) ? (u[e >> 1] | (b << 16)) : b;
    }
  }
};

// every lane ends with the same value: a + b == b + a in IEEE arithmetic,
// so each butterfly stage leaves both partners with identical sums
__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_scale(float ss, int d, float eps) {
  return rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)d), eps));
}

template <typename T, int N>
__device__ __forceinline__ float sum_squares(const Vec<T, N>& v, float ss) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float a = v.get(e);
    ss = __fadd_rn(ss, __fmul_rn(a, a));
  }
  return ss;
}

template <typename TX, typename TW, int VEC>
__device__ __forceinline__ Vec<TX, VEC> scale(const Vec<TX, VEC>& xv,
                                              const Vec<TW, VEC>& wv,
                                              float r) {
  Vec<TX, VEC> yv;
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    yv.set(e, __fmul_rn(__fmul_rn(xv.get(e), r), wv.get(e)));
  return yv;
}

// block (threads_per_row, rows_per_block); threadIdx.y is the row group.
// The register cap (kMinBlocks resident blocks of kBlockThreads) keeps
// enough rows in flight to cover the loads' latency.
template <typename TX, typename TW, int VEC>
__global__ void __launch_bounds__(kBlockThreads, kMinBlocks)
    rmsnorm_rows_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                        TX* __restrict__ y, int64_t rows, int d, float eps,
                        int nv) {
  count_launch(0);
  extern __shared__ __align__(16) unsigned char smem[];
  TW* ws = reinterpret_cast<TW*>(smem);  // w, staged once for the block
  __shared__ float part[kBlockThreads / 32];
  const int t = threadIdx.x, tpr = blockDim.x, grp = threadIdx.y;
  const int nvec = d / VEC;
  const int warps = tpr / 32, warp = t / 32, lane = t % 32;
  const int64_t row = (int64_t)blockIdx.x * blockDim.y + grp;
  const bool live = row < rows;
  const TX* xr = x + (live ? row : 0) * d;
  Vec<TX, VEC> xv[kMaxVecs];
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int j = t + i * tpr;
    if (live && i < nv && j < nvec) xv[i].load(xr + j * VEC);
  }
  // stage w while the loads of x are in flight
  for (int j = grp * tpr + t; j < nvec; j += tpr * blockDim.y) {
    Vec<TW, VEC> wv;
    wv.load(w + j * VEC);
    wv.store(ws + j * VEC);
  }
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int j = t + i * tpr;
    if (live && i < nv && j < nvec) ss = sum_squares(xv[i], ss);
  }
  ss = warp_allsum(ss);
  if (lane == 0) part[grp * warps + warp] = ss;
  __syncthreads();  // w staged, every warp's partial written
  ss = part[grp * warps];
  for (int k = 1; k < warps; ++k) ss = __fadd_rn(ss, part[grp * warps + k]);
  const float r = row_scale(ss, d, eps);
  TX* yr = y + (live ? row : 0) * d;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int j = t + i * tpr;
    if (live && i < nv && j < nvec) {
      Vec<TW, VEC> wv;
      wv.load(ws + j * VEC);
      scale<TX, TW, VEC>(xv[i], wv, r).store(yr + j * VEC);
    }
  }
}

// one block of kBlockThreads per row: sum of squares, then scale and store
template <typename TX, typename TW, int VEC>
__global__ void __launch_bounds__(kBlockThreads)
    rmsnorm_sweep_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                         TX* __restrict__ y, int d, float eps) {
  count_launch(0);
  __shared__ float part[kBlockThreads / 32];
  const int t = threadIdx.x, nvec = d / VEC;
  const int warps = blockDim.x / 32, warp = t / 32, lane = t % 32;
  const TX* xr = x + (int64_t)blockIdx.x * d;
  float ss = 0.0f;
  for (int j = t; j < nvec; j += blockDim.x) {
    Vec<TX, VEC> xv;
    xv.load(xr + j * VEC);
    ss = sum_squares(xv, ss);
  }
  ss = warp_allsum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  ss = part[0];
  for (int k = 1; k < warps; ++k) ss = __fadd_rn(ss, part[k]);
  const float r = row_scale(ss, d, eps);
  TX* yr = y + (int64_t)blockIdx.x * d;
  for (int j = t; j < nvec; j += blockDim.x) {
    Vec<TX, VEC> xv;
    Vec<TW, VEC> wv;
    xv.load(xr + j * VEC);
    wv.load(w + j * VEC);
    scale<TX, TW, VEC>(xv, wv, r).store(yr + j * VEC);
  }
}

// Launch with the grid and dynamic shared memory of the caller's launch
// description (kernels/rmsnorm/kernel.py `launch_meta`), after checking them
// against the plan: rows in registers takes ceil(rows / groups) blocks of
// (tpr, groups) threads and d elements of w in shared memory, two sweeps
// one block of kBlockThreads per row and none.
template <typename TX, typename TW, int VEC>
int launch(const void* x, const void* w, void* y, int64_t rows, int d,
           float eps, int variant, int tpr, int nv, int groups,
           int64_t grid_x, int64_t smem, cudaStream_t st) {
  const dim3 block(tpr, groups);
  if (variant == 0) {
    if (tpr % 32 || tpr < 32 || groups < 1 || tpr * groups > kBlockThreads ||
        nv < 1 || nv > kMaxVecs ||
        (int64_t)tpr * nv * VEC < d)
      return (int)cudaErrorInvalidValue;
    if (grid_x != (rows + groups - 1) / groups || grid_x > 0x7fffffffLL ||
        smem != (int64_t)sizeof(TW) * d)
      return (int)cudaErrorInvalidValue;
    auto kernel = rmsnorm_rows_kernel<TX, TW, VEC>;
    record_launch((const void*)kernel, dim3((unsigned)grid_x), block,
                  (size_t)smem);
    kernel<<<(unsigned)grid_x, block, (size_t)smem, st>>>(
        (const TX*)x, (const TW*)w, (TX*)y, rows, d, eps, nv);
  } else if (variant == 1) {
    if (grid_x != rows || rows > 0x7fffffffLL || smem != 0 ||
        tpr != kBlockThreads || groups != 1)
      return (int)cudaErrorInvalidValue;
    auto kernel = rmsnorm_sweep_kernel<TX, TW, VEC>;
    record_launch((const void*)kernel, dim3((unsigned)grid_x), block, 0);
    kernel<<<(unsigned)grid_x, block, 0, st>>>((const TX*)x, (const TW*)w,
                                               (TX*)y, d, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename TX, typename TW>
int dispatch_vec(const void* x, const void* w, void* y, int64_t rows, int d,
                 float eps, int vec, int variant, int tpr, int nv, int groups,
                 int64_t grid_x, int64_t smem, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(TX);
  if (vec == kVec) {
    if (d % kVec || ((uintptr_t)x | (uintptr_t)w | (uintptr_t)y) % 16)
      return (int)cudaErrorMisalignedAddress;
    return launch<TX, TW, kVec>(x, w, y, rows, d, eps, variant, tpr, nv,
                                groups, grid_x, smem, st);
  }
  if (vec == 1)
    return launch<TX, TW, 1>(x, w, y, rows, d, eps, variant, tpr, nv, groups,
                             grid_x, smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// `config` packs the dtypes and the launch plan of kernels/rmsnorm/kernel.py
// (`launch_config`): bit 0 x_dtype, bit 1 w_dtype (0 = float32,
// 1 = bfloat16), bits 2-3 variant (0 = rows in registers, 1 = two sweeps),
// bits 4-7 vec, bits 8-11 vecs_per_thread, bits 12-23 threads_per_row,
// bits 24-30 rows_per_block. One int keeps the ctypes call short.
// `grid_x` and `smem` are the launch description's grid and dynamic shared
// bytes (checked against the plan before the launch).
int rmsnorm_fwd(const void* x, const void* w, void* y, int64_t rows, int64_t d,
                float eps, int config, int64_t grid_x, int64_t smem,
                void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  if (d > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int x_dtype = config & 1, w_dtype = (config >> 1) & 1;
  const int variant = (config >> 2) & 3, vec = (config >> 4) & 15;
  const int nv = (config >> 8) & 15, tpr = (config >> 12) & 4095;
  const int groups = (config >> 24) & 127;
  const cudaStream_t st = (cudaStream_t)stream;
  const int dd = (int)d;
#define RMSNORM_ARGS \
  x, w, y, rows, dd, eps, vec, variant, tpr, nv, groups, grid_x, smem, st
  if (x_dtype == 0 && w_dtype == 0)
    return dispatch_vec<float, float>(RMSNORM_ARGS);
  if (x_dtype == 1 && w_dtype == 1)
    return dispatch_vec<__nv_bfloat16, __nv_bfloat16>(RMSNORM_ARGS);
  if (x_dtype == 1 && w_dtype == 0)
    return dispatch_vec<__nv_bfloat16, float>(RMSNORM_ARGS);
  return dispatch_vec<float, __nv_bfloat16>(RMSNORM_ARGS);
#undef RMSNORM_ARGS
}

const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
