// Flash attention forward for Hopper: online softmax over KV tiles.
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention/kernel.py). q [B, Sq, H, Dh] and k/v
// [B, Sk, KV, Dh] are read in that layout (no transposes); query head h
// reads KV head h / (H / KV) (GQA). q is pre-scaled by `scale` in f32 as in
// the plain version; m, l and the output accumulator stay in f32.
//
// Design: one block per (q tile of kBQ rows, head, batch), 256 threads, four
// threads per query row. The block holds its q tile and one kBK-row K/V tile
// at a time in shared memory (rows padded by one float so that the
// column-strided reads are free of bank conflicts) and streams the KV tiles
// through them; the four threads of a row keep that row's running max and
// sum in registers (two xor-shuffles combine them) and a quarter of its
// output accumulator. Sq and Sk tails are masked in the kernel, so no shape
// needs padding or a fallback path. Causal: KV tiles wholly past the
// diagonal of the q tile are skipped; masked scores inside a tile take
// -1e30 like the plain version.
//
// Bound: at the CHORDS-DiT serving shape (B=32, S=64, H=24, Dh=128, bf16)
// the card's bound is bytes — 25 MB of q/k/v/o against 1.6 GFLOP that the
// tensor cores would do in a tenth of the time — but this first kernel does
// the two products as f32 FMAs on the CUDA cores (no wgmma, no TMA), so in
// practice the multiply rate bounds it. Moving QK and PV onto the tensor
// cores is later work; at longer sequences (S >= ~300) the bound turns to
// operations anyway.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 4 per query row
constexpr float kMaskValue = -1e30f;

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

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)kBQ * (DH + 1) + (size_t)kBK * (DH + 1) + (size_t)kBK * DH +
          (size_t)kBQ * (kBK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
                 int nh, int nkv, float scale, int causal) {
  extern __shared__ float smem[];
  float* sQ = smem;                       // [kBQ][DH+1]
  float* sK = sQ + kBQ * (DH + 1);        // [kBK][DH+1]
  float* sV = sK + kBK * (DH + 1);        // [kBK][DH]
  float* sP = sV + kBK * DH;              // [kBQ][kBK+1]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (nh / nkv);
  const int tid = threadIdx.x;
  const int row = tid / 4, sub = tid % 4;

  for (int idx = tid; idx < kBQ * DH; idx += kThreads) {
    const int i = idx / DH, d = idx % DH;
    const int qi = q0 + i;
    float val = 0.0f;
    if (qi < sq) val = __fmul_rn(to_f32(q[(((int64_t)b * sq + qi) * nh + h) * DH + d]), scale);
    sQ[i * (DH + 1) + d] = val;
  }

  int n_kv = (sk + kBK - 1) / kBK;
  if (causal) {
    const int last_q = min(q0 + kBQ, sq) - 1;
    n_kv = min(n_kv, last_q / kBK + 1);
  }

  float m = kMaskValue, l = 0.0f;
  float acc[DH / 4];
#pragma unroll
  for (int j = 0; j < DH / 4; ++j) acc[j] = 0.0f;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous tile's sK/sV/sP fully consumed (and sQ ready)
    for (int idx = tid; idx < kBK * DH; idx += kThreads) {
      const int c = idx / DH, d = idx % DH;
      const int kc = k0 + c;
      float kv = 0.0f, vv = 0.0f;
      if (kc < sk) {
        const int64_t off = (((int64_t)b * sk + kc) * nkv + kvh) * DH + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      sK[c * (DH + 1) + d] = kv;
      sV[c * DH + d] = vv;
    }
    __syncthreads();

    float s[kBK / 4];
#pragma unroll
    for (int jj = 0; jj < kBK / 4; ++jj) s[jj] = 0.0f;
    const float* qrow = sQ + row * (DH + 1);
    for (int d = 0; d < DH; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int jj = 0; jj < kBK / 4; ++jj)
        s[jj] = fmaf(qv, sK[(sub + 4 * jj) * (DH + 1) + d], s[jj]);
    }

    float mx = kMaskValue;
#pragma unroll
    for (int jj = 0; jj < kBK / 4; ++jj) {
      const int kc = k0 + sub + 4 * jj;
      if (kc >= sk)
        s[jj] = -INFINITY;
      else if (causal && kc > q0 + row)
        s[jj] = kMaskValue;
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float ps = 0.0f;
#pragma unroll
    for (int jj = 0; jj < kBK / 4; ++jj) {
      const float p = expf(s[jj] - m_new);
      sP[row * (kBK + 1) + sub + 4 * jj] = p;
      ps += p;
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    l = l * corr + ps;
    m = m_new;
    __syncwarp();  // a row's P is written and read by the same four lanes

#pragma unroll
    for (int j = 0; j < DH / 4; ++j) acc[j] *= corr;
    const float* prow = sP + row * (kBK + 1);
    for (int c = 0; c < kBK; ++c) {
      const float p = prow[c];
      const float* vrow = sV + c * DH + sub;
#pragma unroll
      for (int j = 0; j < DH / 4; ++j) acc[j] = fmaf(p, vrow[4 * j], acc[j]);
    }
  }

  const int qi = q0 + row;
  if (qi < sq) {
    const float inv_l = 1.0f / fmaxf(l, 1e-30f);
    T* orow = o + (((int64_t)b * sq + qi) * nh + h) * DH;
#pragma unroll
    for (int j = 0; j < DH / 4; ++j) orow[sub + 4 * j] = from_f32<T>(acc[j] * inv_l);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int sk, int nh, int nkv, float scale, int causal,
           void* stream) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)nh, (unsigned)b);
  flash_fwd_kernel<T, DH><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, sk, nh, nkv, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(const void* q, const void* k, const void* v, void* o, int b,
                int sq, int sk, int nh, int nkv, int dh, float scale,
                int causal, void* stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, o, b, sq, sk, nh, nkv, scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, sq, sk, nh, nkv, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, sq, sk, nh, nkv, scale, causal, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int b, int sq, int sk, int nh, int nkv, int dh,
                        float scale, int causal, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0) return 0;
  if (nkv <= 0 || nh % nkv != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_dh<float>(q, k, v, o, b, sq, sk, nh, nkv, dh, scale, causal, stream);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(q, k, v, o, b, sq, sk, nh, nkv, dh, scale, causal,
                                      stream);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
