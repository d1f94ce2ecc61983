// Fused CHORDS solver step + rectification (+ accept reduction) for Hopper.
//
// Replaces the Pallas TPU kernels fused_step_rectify and
// fused_step_rectify_accept (src/repro/kernels/rectify/kernel.py). Per row r
// of the flattened [R, M] slot x core grid:
//
//   out = x + (dt_r * f + (fire_r ? dsnap_r * (f_up - f_snap) + (x_up - x_snap) : 0))
//
// associated exactly as the plain version (kernels/rectify/ref.py). Every
// operation is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// __fsub_rn): nvcc would otherwise contract a*b+c into one FMA and the
// output would stop being bitwise equal to PyTorch's separately rounded ops.
//
// Bound: bytes. Six (seven with prev) latent reads and one write of 4 bytes
// per element against ~0.3 flop per byte, so the kernels only have to stream
// at the card's memory rate.
//
// fused_step_rectify: one launch covers the whole grid, the rows folded
// into x (blockIdx.x = row * tiles + column tile of the row: any row
// count, where blockIdx.y would stop at 65535 rows). At the serving shape
// ([32, 1024], ~1 MB) the kernel is bound by its launch and one round trip
// of loads, not by its 0.0003 ms of bytes, so the plan
// (kernels/rectify/kernel.py `step_plan`) cuts each row into tiles until
// rows x tiles fills the SMs
// (128 blocks of 64 threads there) and each thread takes exactly one piece
// of VEC columns: its six operand loads (float4 where the operands allow)
// are all in flight before any arithmetic, so a block costs one round trip
// of loads. `fire` is read as the bytes of a torch.bool tensor (no cast
// kernel before the launch).
//
// fused_step_rectify_accept adds err_sq[r] = sum((out - prev)^2) and
// out_sq[r] = sum(out*out). At the serving shape ([32, 1024]) it moves
// ~1 MB, so it is bound by launch latency more than by bytes, and it is one
// launch with no scratch in device memory and no atomics: one thread block
// cluster per row (C <= 8 blocks, C picked so that rows x C fills the SMs),
// each block streaming its share of the row's columns (float4 loads where
// the operands allow) and reducing its two partial sums in shared memory;
// each block writes them into rank 0's shared memory (distributed shared
// memory), and rank 0 adds the C partials in rank order. Every sum is taken
// in one fixed order, so the sums are the same from launch to launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define LAUNCH_COUNT_SLOTS 2  // 0 step, 1 accept
#include "launch_count.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;  // the portable cluster size

__device__ __forceinline__ float step_rect(float x, float f, float xu,
                                           float fu, float xs, float fs,
                                           float dt, float ds, bool fire) {
  float delta = __fmul_rn(dt, f);
  float rect = __fadd_rn(__fmul_rn(ds, __fsub_rn(fu, fs)), __fsub_rn(xu, xs));
  return __fadd_rn(x, __fadd_rn(delta, fire ? rect : 0.0f));
}

// Block b is tile b % tiles of row b / tiles; its thread t takes the VEC
// columns from (tile * blockDim.x + t) * VEC of the row (VEC = 4 needs
// m % 4 == 0, so a piece never straddles the row's end).
template <int VEC>
__global__ void __launch_bounds__(kThreads) step_rectify_kernel(
    const float* __restrict__ x, const float* __restrict__ f,
    const float* __restrict__ xu, const float* __restrict__ fu,
    const float* __restrict__ xs, const float* __restrict__ fs,
    const float* __restrict__ dt, const float* __restrict__ ds,
    const uint8_t* __restrict__ fire, float* __restrict__ out, int64_t m,
    unsigned tiles) {
  count_launch(0);
  const unsigned row = blockIdx.x / tiles, tile = blockIdx.x - row * tiles;
  const int64_t c =
      ((int64_t)tile * blockDim.x + threadIdx.x) * (int64_t)VEC;
  if (c >= m) return;
  const int64_t j = (int64_t)row * m + c;
  const float d = dt[row], s = ds[row];
  const bool fr = fire[row] != 0;
  if (VEC == 4) {
    const float4 a = *reinterpret_cast<const float4*>(x + j);
    const float4 b = *reinterpret_cast<const float4*>(f + j);
    const float4 g = *reinterpret_cast<const float4*>(xu + j);
    const float4 h = *reinterpret_cast<const float4*>(fu + j);
    const float4 p = *reinterpret_cast<const float4*>(xs + j);
    const float4 q = *reinterpret_cast<const float4*>(fs + j);
    float4 o;
    o.x = step_rect(a.x, b.x, g.x, h.x, p.x, q.x, d, s, fr);
    o.y = step_rect(a.y, b.y, g.y, h.y, p.y, q.y, d, s, fr);
    o.z = step_rect(a.z, b.z, g.z, h.z, p.z, q.z, d, s, fr);
    o.w = step_rect(a.w, b.w, g.w, h.w, p.w, q.w, d, s, fr);
    *reinterpret_cast<float4*>(out + j) = o;
  } else {
    const float a = x[j], b = f[j], g = xu[j], h = fu[j], p = xs[j],
                q = fs[j];
    out[j] = step_rect(a, b, g, h, p, q, d, s, fr);
  }
}

// shuffle-down tree: lane 0 ends with ((v0 + v16) + (v8 + v24)) + ..., the
// order kernels/rectify/ref.py `accept_sums_in_kernel_order` emulates
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// The rows are folded into x: the cluster of blocks [r*C, (r+1)*C) is row
// r's. Block b (cluster rank) of row r's cluster owns columns [b*span,
// min(m, (b+1)*span)); thread t takes its VEC-wide pieces t, t + T, ...
// of them. Each block reduces its partial sums (thread, then warp tree, then
// the warp partials as one more tree) and writes them into rank 0's shared
// memory (distributed shared memory); after a cluster barrier rank 0 adds
// the C block partials in rank order and writes the row's sums. A block
// may write to another's shared memory only once every block of the
// cluster has started: the kernel arrives at a first cluster barrier on
// entry and waits on it just before that write, so the wait overlaps the
// loads.
template <int VEC>
__global__ void __launch_bounds__(kThreads) step_rectify_accept_kernel(
    const float* __restrict__ x, const float* __restrict__ f,
    const float* __restrict__ xu, const float* __restrict__ fu,
    const float* __restrict__ xs, const float* __restrict__ fs,
    const float* __restrict__ prev, const float* __restrict__ dt,
    const float* __restrict__ ds, const uint8_t* __restrict__ fire,
    float* __restrict__ out, float* __restrict__ err_sq,
    float* __restrict__ out_sq, int64_t m, int64_t group, int64_t span) {
  count_launch(1);
  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const unsigned rank = cluster.block_rank();
  const int64_t row = blockIdx.x / cluster.num_blocks();
  const float d = dt[row], s = ds[row];
  const bool fr = fire[row] != 0;
  const int64_t base = row * m;
  const int64_t pbase = (row / group) * m;  // prev row shared by a slot's cores
  const int64_t c0 = (int64_t)rank * span;
  const int64_t c1 = c0 + span < m ? c0 + span : m;
  float err = 0.0f, osq = 0.0f;
  if (VEC == 4) {
    for (int64_t c = c0 + 4 * (int64_t)threadIdx.x; c < c1;
         c += 4 * (int64_t)blockDim.x) {
      const int64_t j = base + c;
      const float4 a = *reinterpret_cast<const float4*>(x + j);
      const float4 b = *reinterpret_cast<const float4*>(f + j);
      const float4 g = *reinterpret_cast<const float4*>(xu + j);
      const float4 h = *reinterpret_cast<const float4*>(fu + j);
      const float4 p = *reinterpret_cast<const float4*>(xs + j);
      const float4 q = *reinterpret_cast<const float4*>(fs + j);
      const float4 v = *reinterpret_cast<const float4*>(prev + pbase + c);
      float4 o;
      o.x = step_rect(a.x, b.x, g.x, h.x, p.x, q.x, d, s, fr);
      o.y = step_rect(a.y, b.y, g.y, h.y, p.y, q.y, d, s, fr);
      o.z = step_rect(a.z, b.z, g.z, h.z, p.z, q.z, d, s, fr);
      o.w = step_rect(a.w, b.w, g.w, h.w, p.w, q.w, d, s, fr);
      *reinterpret_cast<float4*>(out + j) = o;
      const float ov[4] = {o.x, o.y, o.z, o.w};
      const float pv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ee = __fsub_rn(ov[e], pv[e]);
        err = __fadd_rn(err, __fmul_rn(ee, ee));
        osq = __fadd_rn(osq, __fmul_rn(ov[e], ov[e]));
      }
    }
  } else {
    for (int64_t c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
      const int64_t j = base + c;
      const float o =
          step_rect(x[j], f[j], xu[j], fu[j], xs[j], fs[j], d, s, fr);
      out[j] = o;
      const float ee = __fsub_rn(o, prev[pbase + c]);
      err = __fadd_rn(err, __fmul_rn(ee, ee));
      osq = __fadd_rn(osq, __fmul_rn(o, o));
    }
  }
  __shared__ float se[kThreads / 32], so[kThreads / 32];
  __shared__ float parts[2 * kMaxCluster];  // rank 0's: every block's sums
  err = warp_sum(err);
  osq = warp_sum(osq);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    se[warp] = err;
    so[warp] = osq;
  }
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x / 32;
    err = warp_sum(lane < warps ? se[lane] : 0.0f);
    osq = warp_sum(lane < warps ? so[lane] : 0.0f);
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (threadIdx.x == 0) {
    float* dst = cluster.map_shared_rank(parts, 0);
    dst[2 * rank] = err;
    dst[2 * rank + 1] = osq;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    float e = parts[0], o = parts[1];
    for (unsigned r = 1; r < cluster.num_blocks(); ++r) {
      e = __fadd_rn(e, parts[2 * r]);
      o = __fadd_rn(o, parts[2 * r + 1]);
    }
    err_sq[row] = e;
    out_sq[row] = o;
  }
}

}  // namespace

extern "C" {

// One launch over [rows, m]: blocks of `threads` threads, `tiles` =
// ceil(m / (threads * vec)) of them per row, the rows folded into x (grid
// x = rows * tiles, which the caller passes as `grid_x` from its launch
// description and this function checks), each thread one piece of `vec`
// columns. `config` packs the plan of kernels/rectify/kernel.py
// `launch_meta`: bits 0-11 threads, bits 12-15 vec (4: float4 loads,
// m % 4 == 0 and the seven latent pointers 16-byte aligned; or 1). `fire`
// is read as bytes holding 0 or 1 (a torch.bool tensor).
int fused_step_rectify_f32(const void* x, const void* f, const void* xu,
                           const void* fu, const void* xs, const void* fs,
                           const void* dt, const void* ds, const void* fire,
                           void* out, int64_t rows, int64_t m, int config,
                           int64_t grid_x, void* stream) {
  if (rows <= 0 || m <= 0) return 0;
  const int threads = config & 4095, vec = (config >> 12) & 15;
  if (threads < 32 || threads > kThreads || threads % 32 ||
      (vec != 4 && vec != 1))
    return (int)cudaErrorInvalidValue;
  if (vec == 4 && (m % 4 ||
                   ((uintptr_t)x | (uintptr_t)f | (uintptr_t)xu |
                    (uintptr_t)fu | (uintptr_t)xs | (uintptr_t)fs |
                    (uintptr_t)out) % 16))
    return (int)cudaErrorMisalignedAddress;
  const int64_t tile = (int64_t)threads * vec;
  const int64_t tiles = (m + tile - 1) / tile;
  if (tiles > 2147483647 / rows || grid_x != rows * tiles)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)grid_x);
  const cudaStream_t st = (cudaStream_t)stream;
  const void* kernel = vec == 4 ? (const void*)step_rectify_kernel<4>
                                : (const void*)step_rectify_kernel<1>;
  record_launch(kernel, grid, dim3(threads), 0);
  if (vec == 4)
    step_rectify_kernel<4><<<grid, threads, 0, st>>>(
        (const float*)x, (const float*)f, (const float*)xu, (const float*)fu,
        (const float*)xs, (const float*)fs, (const float*)dt,
        (const float*)ds, (const uint8_t*)fire, (float*)out, m,
        (unsigned)tiles);
  else
    step_rectify_kernel<1><<<grid, threads, 0, st>>>(
        (const float*)x, (const float*)f, (const float*)xu, (const float*)fu,
        (const float*)xs, (const float*)fs, (const float*)dt,
        (const float*)ds, (const uint8_t*)fire, (float*)out, m,
        (unsigned)tiles);
  return (int)cudaGetLastError();
}

// One launch: a cluster of `cluster` blocks of `threads` threads per row,
// the rows folded into x (grid x = rows * cluster, passed as `grid_x` from
// the caller's launch description and checked here), block b of a row
// covering columns [b*span, (b+1)*span); `vec` is 4 for float4 loads
// (m % 4 == 0, operands 16-byte aligned, span % 4 == 0) or 1. `config`
// packs the plan of kernels/rectify/kernel.py `launch_meta_accept`: bits
// 0-3 cluster, bits 4-15 threads, bits 16-19 vec (one int keeps the ctypes
// call short). `fire` is read as bytes holding 0 or 1 (a torch.bool
// tensor); `sums` is [2, rows]: err_sq, then out_sq.
int fused_step_rectify_accept_f32(
    const void* x, const void* f, const void* xu, const void* fu,
    const void* xs, const void* fs, const void* prev, const void* dt,
    const void* ds, const void* fire, void* out, void* sums, int64_t rows,
    int64_t m, int64_t group, int64_t span, int config, int64_t grid_x,
    void* stream) {
  if (rows <= 0 || m <= 0) return 0;
  const int cluster = config & 15, threads = (config >> 4) & 4095;
  const int vec = (config >> 16) & 15;
  if (cluster < 1 || cluster > kMaxCluster || span < 1 ||
      (int64_t)cluster * span < m || threads < 32 || threads > kThreads ||
      threads % 32 || group < 1 || rows % group ||
      rows > 2147483647 / cluster || grid_x != rows * cluster)
    return (int)cudaErrorInvalidValue;
  if (vec == 4 && (m % 4 || span % 4 ||
                   ((uintptr_t)x | (uintptr_t)f | (uintptr_t)xu |
                    (uintptr_t)fu | (uintptr_t)xs | (uintptr_t)fs |
                    (uintptr_t)prev | (uintptr_t)out) % 16))
    return (int)cudaErrorMisalignedAddress;
  if (vec != 4 && vec != 1) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid_x);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto kernel = vec == 4 ? step_rectify_accept_kernel<4>
                         : step_rectify_accept_kernel<1>;
  record_launch((const void*)kernel, cfg.gridDim, cfg.blockDim, 0,
                dim3((unsigned)cluster));
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, (const float*)x, (const float*)f, (const float*)xu,
      (const float*)fu, (const float*)xs, (const float*)fs,
      (const float*)prev, (const float*)dt, (const float*)ds,
      (const uint8_t*)fire, (float*)out, (float*)sums, (float*)sums + rows,
      m, group, span);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* rectify_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
