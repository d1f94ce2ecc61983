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
// per element against ~0.3 flop per byte, so the kernel only has to stream
// at the card's memory rate: one launch covers the whole grid (blockIdx.y =
// row, blockIdx.x = tile of the row), each thread walks its tile with
// coalesced loads.
//
// Accept variant: err_sq[r] = sum((out - prev)^2), out_sq[r] = sum(out*out).
// Each block reduces its tile (warp shuffles, then shared memory) into a
// per-(row, tile) partial; a second kernel sums each row's partials in a
// fixed order. Two passes instead of f32 atomics keep the sums
// deterministic from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;

__device__ __forceinline__ float step_rect(float x, float f, float xu,
                                           float fu, float xs, float fs,
                                           float dt, float ds, bool fire) {
  float delta = __fmul_rn(dt, f);
  float rect = __fadd_rn(__fmul_rn(ds, __fsub_rn(fu, fs)), __fsub_rn(xu, xs));
  return __fadd_rn(x, __fadd_rn(delta, fire ? rect : 0.0f));
}

__global__ void step_rectify_kernel(
    const float* __restrict__ x, const float* __restrict__ f,
    const float* __restrict__ xu, const float* __restrict__ fu,
    const float* __restrict__ xs, const float* __restrict__ fs,
    const float* __restrict__ dt, const float* __restrict__ ds,
    const uint8_t* __restrict__ fire, float* __restrict__ out, int64_t m) {
  const int64_t row = blockIdx.y;
  const float d = dt[row], s = ds[row];
  const bool fr = fire[row] != 0;
  const int64_t base = row * m;
  const int64_t start = (int64_t)blockIdx.x * kTile + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    int64_t col = start + (int64_t)i * kThreads;
    if (col < m) {
      int64_t j = base + col;
      out[j] = step_rect(x[j], f[j], xu[j], fu[j], xs[j], fs[j], d, s, fr);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void step_rectify_accept_kernel(
    const float* __restrict__ x, const float* __restrict__ f,
    const float* __restrict__ xu, const float* __restrict__ fu,
    const float* __restrict__ xs, const float* __restrict__ fs,
    const float* __restrict__ prev, const float* __restrict__ dt,
    const float* __restrict__ ds, const uint8_t* __restrict__ fire,
    float* __restrict__ out, float* __restrict__ err_part,
    float* __restrict__ osq_part, int64_t m, int64_t group) {
  const int64_t row = blockIdx.y;
  const float d = dt[row], s = ds[row];
  const bool fr = fire[row] != 0;
  const int64_t base = row * m;
  const int64_t pbase = (row / group) * m;  // prev row shared by a slot's cores
  const int64_t start = (int64_t)blockIdx.x * kTile + threadIdx.x;
  float err = 0.0f, osq = 0.0f;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    int64_t col = start + (int64_t)i * kThreads;
    if (col < m) {
      int64_t j = base + col;
      float o = step_rect(x[j], f[j], xu[j], fu[j], xs[j], fs[j], d, s, fr);
      out[j] = o;
      float e = __fsub_rn(o, prev[pbase + col]);
      err = __fadd_rn(err, __fmul_rn(e, e));
      osq = __fadd_rn(osq, __fmul_rn(o, o));
    }
  }
  __shared__ float se[kThreads / 32], so[kThreads / 32];
  err = warp_sum(err);
  osq = warp_sum(osq);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    se[warp] = err;
    so[warp] = osq;
  }
  __syncthreads();
  if (warp == 0) {
    err = lane < kThreads / 32 ? se[lane] : 0.0f;
    osq = lane < kThreads / 32 ? so[lane] : 0.0f;
    err = warp_sum(err);
    osq = warp_sum(osq);
    if (lane == 0) {
      err_part[row * gridDim.x + blockIdx.x] = err;
      osq_part[row * gridDim.x + blockIdx.x] = osq;
    }
  }
}

// second pass: one warp per row sums that row's tile partials
__global__ void row_sum_kernel(const float* __restrict__ err_part,
                               const float* __restrict__ osq_part,
                               float* __restrict__ err_sq,
                               float* __restrict__ out_sq, int64_t rows,
                               int64_t tiles) {
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float e = 0.0f, o = 0.0f;
  for (int64_t t = lane; t < tiles; t += 32) {
    e += err_part[row * tiles + t];
    o += osq_part[row * tiles + t];
  }
  e = warp_sum(e);
  o = warp_sum(o);
  if (lane == 0) {
    err_sq[row] = e;
    out_sq[row] = o;
  }
}

}  // namespace

extern "C" {

int64_t rectify_num_tiles(int64_t m) { return (m + kTile - 1) / kTile; }

int fused_step_rectify_f32(const void* x, const void* f, const void* xu,
                           const void* fu, const void* xs, const void* fs,
                           const void* dt, const void* ds, const void* fire,
                           void* out, int64_t rows, int64_t m, void* stream) {
  if (rows <= 0 || m <= 0) return 0;
  dim3 grid((unsigned)rectify_num_tiles(m), (unsigned)rows);
  step_rectify_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)f, (const float*)xu, (const float*)fu,
      (const float*)xs, (const float*)fs, (const float*)dt, (const float*)ds,
      (const uint8_t*)fire, (float*)out, m);
  return (int)cudaGetLastError();
}

int fused_step_rectify_accept_f32(
    const void* x, const void* f, const void* xu, const void* fu,
    const void* xs, const void* fs, const void* prev, const void* dt,
    const void* ds, const void* fire, void* out, void* err_part,
    void* osq_part, void* err_sq, void* out_sq, int64_t rows, int64_t m,
    int64_t group, void* stream) {
  if (rows <= 0 || m <= 0) return 0;
  const int64_t tiles = rectify_num_tiles(m);
  dim3 grid((unsigned)tiles, (unsigned)rows);
  cudaStream_t st = (cudaStream_t)stream;
  step_rectify_accept_kernel<<<grid, kThreads, 0, st>>>(
      (const float*)x, (const float*)f, (const float*)xu, (const float*)fu,
      (const float*)xs, (const float*)fs, (const float*)prev,
      (const float*)dt, (const float*)ds, (const uint8_t*)fire, (float*)out,
      (float*)err_part, (float*)osq_part, m, group);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int warps = 8;
  row_sum_kernel<<<(unsigned)((rows + warps - 1) / warps), warps * 32, 0, st>>>(
      (const float*)err_part, (const float*)osq_part, (float*)err_sq,
      (float*)out_sq, rows, tiles);
  return (int)cudaGetLastError();
}

const char* rectify_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
