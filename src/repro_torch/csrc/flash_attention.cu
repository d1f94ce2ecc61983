// Flash attention forward for Hopper: online softmax over KV tiles.
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention/kernel.py). q [B, Sq, H, Dh] and k/v
// [B, Sk, KV, Dh] are read in that layout (no transposes); query head h
// reads KV head h / (H / KV) (GQA). m, l and the output accumulator stay in
// f32. Sq and Sk tails are masked in the kernel, so no shape needs padding.
// Causal: KV tiles wholly past the diagonal of the q tile are skipped;
// masked scores inside a tile take -1e30 like the plain version, columns
// past Sk take -inf. Head dims 16, 32, 64, 80 and 128 are compiled. The
// dtype alone picks the kernel: bf16 -> flash_fwd_mma_kernel, f32 ->
// flash_fwd_kernel.
//
// Bound: at the serving shapes (CHORDS-DiT [32, 64, 24, 128] non-causal;
// the zamba2 shared block [32, 64, 32, 80] causal; bf16) the card's bound
// is bytes: q/k/v/o once is 50 MB (0.015 ms at 3.35 TB/s) against 1.6
// GFLOP, which the tensor cores do in a few microseconds.
//
// bf16 route (flash_fwd_mma_kernel), FlashAttention-2 style: one block of
// 4 warps per 64-row q tile, each warp owning 16 rows. Q, K and V tiles
// arrive by 16-byte cp.async (rows past Sq/Sk zero-filled) in shared
// memory whose rows are padded by 16 bytes, so that ldmatrix's eight row
// addresses fall in eight distinct bank groups at every head dim. K and V
// are separate commit groups: QK^T of a tile runs while its V lands, and
// with several KV tiles the next tile's K/V load into a second buffer
// while this tile's products run (one buffer when Sk fits one tile, which
// leaves room for more blocks per SM at the serving shapes). QK^T and PV
// are mma.sync.m16n8k16 bf16 products with f32 accumulators, operands by
// ldmatrix (V by ldmatrix.trans); `scale` multiplies S in f32 (folded with
// log2(e) so that the softmax uses exp2); m and l live in registers and
// combine across a row's quad by shuffles; P is rounded to bf16 in
// registers and used directly as PV's A operand. The output is divided by
// max(l, 1e-30), staged through the warp's own Q rows and stored as bf16
// with 16-byte stores. mma.sync, not wgmma: at these shapes the bound is
// bytes and the 1.6 GFLOP take a few microseconds at mma.sync's rate, so
// the asynchronous warpgroup product would buy nothing that the loads do
// not already hide; tests/test_torch_flash_numerics.py holds this rounding
// plan against the JAX kernel at 2e-2.
//
// f32 route (flash_fwd_kernel): 256 threads, four per query
// row, tiles widened to f32 in padded shared memory, both products as f32
// FMAs on the CUDA cores. A bf16 or TF32 product cannot hold the f32
// contract of 2e-5, so the f32 route stays off the tensor cores and is
// bound by its shared-memory operand traffic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // f32 route: 4 per query row
constexpr int kMmaThreads = 128;  // bf16 route: 4 warps x 16 rows
constexpr float kMaskValue = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

// cudaFuncSetAttribute once per kernel instance and device, not per launch:
// `allowed` is the calling instance's own record of what it has set.
cudaError_t allow_smem(const void* kernel, int bytes,
                       int (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && allowed[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return e;
}

// ---------------------------------------------------------------------------
// f32 route: products on the CUDA cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

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

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int sq, int sk, int nh, int nkv, float scale, int causal,
               void* stream) {
  const int smem = (int)smem_bytes<DH>();
  static int allowed[kMaxDevices] = {};
  cudaError_t e =
      allow_smem((const void*)flash_fwd_kernel<float, DH>, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)nh, (unsigned)b);
  flash_fwd_kernel<float, DH><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, sq, sk,
      nh, nkv, scale, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: products on the tensor cores (mma.sync.m16n8k16)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte global -> shared copy; valid == false fills the 16 bytes with 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[4] += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DH>
struct MmaTile {
  static constexpr int LD = DH + 8;         // row stride in bf16 (+16 bytes)
  static constexpr int ELEMS = kBQ * LD;    // one 64-row tile
  static constexpr int CHUNKS = DH / 8;     // 16-byte chunks per row
  // Q, then K/V of each buffer
  static constexpr int bytes(int stages) {
    return (int)sizeof(__nv_bfloat16) * ELEMS * (1 + 2 * stages);
  }
};

// 64 rows of DH bf16 (row r at src + r * stride) -> padded shared tile;
// rows at or past `rows` are zero-filled.
template <int DH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t stride, int rows, int tid) {
  using Tile = MmaTile<DH>;
#pragma unroll
  for (int i = 0; i < kBQ * Tile::CHUNKS / kMmaThreads; ++i) {
    const int idx = tid + i * kMmaThreads;
    const int r = idx / Tile::CHUNKS, c = idx % Tile::CHUNKS;
    const bool valid = r < rows;
    cp_async16(smem_addr(dst + r * Tile::LD + c * 8),
               src + (valid ? r * stride + c * 8 : 0), valid);
  }
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int sq, int sk, int nh,
                     int nkv, float scale_log2, int causal) {
  using Tile = MmaTile<DH>;
  constexpr int LD = Tile::LD;
  constexpr int KD = DH / 16;  // k16 steps of QK^T; n16 pairs of PV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // buffer s: K at sQ + (1 + 2s) tiles, V right after it

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (nh / nkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group, column pair
  const int64_t q_stride = (int64_t)nh * DH, kv_stride = (int64_t)nkv * DH;
  const __nv_bfloat16* qg = q + (((int64_t)b * sq + q0) * nh + h) * DH;
  const __nv_bfloat16* kg = k + ((int64_t)b * sk * nkv + kvh) * DH;
  const __nv_bfloat16* vg = v + ((int64_t)b * sk * nkv + kvh) * DH;

  int n_kv = (sk + kBK - 1) / kBK;
  if (causal) n_kv = min(n_kv, (min(q0 + kBQ, sq) - 1) / kBK + 1);

  load_tile<DH>(sQ, qg, q_stride, sq - q0, tid);
  load_tile<DH>(sQ + Tile::ELEMS, kg, kv_stride, sk, tid);
  cp_async_commit();
  load_tile<DH>(sQ + 2 * Tile::ELEMS, vg, kv_stride, sk, tid);
  cp_async_commit();

  // ldmatrix row addresses: A (Q) x4 = rows 0-15 x k 0-7 / 8-15; B (K) x4 =
  // n 0-7 x k 0-7, n 0-7 x k 8-15, n 8-15 x k 0-7, n 8-15 x k 8-15; V
  // (.trans) x4 = j 0-7 x d 0-7, j 8-15 x d 0-7, j 0-7 x d 8-15, ...
  const int a_row = warp * 16 + lane % 16, a_col = (lane / 16) * 8;
  const int k_row = (lane % 8) + (lane / 16) * 8, k_col = ((lane / 8) % 2) * 8;
  const int v_row = (lane % 8) + ((lane / 8) % 2) * 8, v_col = (lane / 16) * 8;
  const uint32_t q_addr = smem_addr(sQ + a_row * LD + a_col);

  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m_run[2] = {kMaskValue, kMaskValue};  // rows g and g + 8, log2 units
  float l_run[2] = {0.0f, 0.0f};              // this thread's partial sums
  const int row0 = q0 + warp * 16 + g;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK;
    const __nv_bfloat16* sK = sQ + (1 + 2 * (kt & 1)) * Tile::ELEMS;
    const __nv_bfloat16* sV = sK + Tile::ELEMS;
    const bool more = kt + 1 < n_kv;
    if (more) {  // the next tile lands in the other buffer meanwhile
      __nv_bfloat16* nK = sQ + (1 + 2 * ((kt + 1) & 1)) * Tile::ELEMS;
      load_tile<DH>(nK, kg + (int64_t)(k0 + kBK) * kv_stride, kv_stride,
                    sk - k0 - kBK, tid);
      cp_async_commit();
      load_tile<DH>(nK + Tile::ELEMS, vg + (int64_t)(k0 + kBK) * kv_stride,
                    kv_stride, sk - k0 - kBK, tid);
      cp_async_commit();
      cp_async_wait<3>();  // this tile's K (and Q)
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 columns per warp, 8 n-tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    const uint32_t k_addr = smem_addr(sK + k_row * LD + k_col);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, q_addr + kk * 32);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, k_addr + (np * 16 * LD + kk * 16) * 2);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // scale in f32 (log2 units), mask, online softmax
    const bool edge = k0 + kBK > sk || (causal && k0 + kBK - 1 > q0 + warp * 16);
    float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          if (col >= sk)
            x = -INFINITY;
          else if (causal && col > row0 + (e >> 1) * 8)
            x = kMaskValue;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      corr[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= corr[r];
    }
    uint32_t pa[4][4];  // P as the A operand of PV, one k16 step per 16 cols
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2f(s[j][0] - m_run[0]);
      const float p1 = exp2f(s[j][1] - m_run[0]);
      const float p2 = exp2f(s[j][2] - m_run[1]);
      const float p3 = exp2f(s[j][3] - m_run[1]);
      l_run[0] += p0 + p1;
      l_run[1] += p2 + p3;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    if (more)
      cp_async_wait<2>();  // this tile's V
    else
      cp_async_wait<0>();
    __syncthreads();

    // O += P V
    const uint32_t v_addr = smem_addr(sV + v_row * LD + v_col);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < KD; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_addr + (kk * 16 * LD + dp * 16) * 2);
        mma_bf16(acc[2 * dp], pa[kk], bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pa[kk], bv[2], bv[3]);
      }
    }
    if (more) __syncthreads();  // this buffer is refilled two tiles on
  }

  // normalize, stage the warp's 16 rows in its own Q rows, 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.0f / fmaxf(l, 1e-30f);
  }
  __nv_bfloat16* sO = sQ + warp * 16 * LD;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int c = j * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(sO + g * LD + c) =
        __floats2bfloat162_rn(acc[j][0] * inv[0], acc[j][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(sO + (g + 8) * LD + c) =
        __floats2bfloat162_rn(acc[j][2] * inv[1], acc[j][3] * inv[1]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * Tile::CHUNKS / 32; ++i) {
    const int idx = lane + i * 32;
    const int r = idx / Tile::CHUNKS, c = idx % Tile::CHUNKS;
    const int qi = q0 + warp * 16 + r;
    if (qi < sq)
      *reinterpret_cast<uint4*>(o + (((int64_t)b * sq + qi) * nh + h) * DH +
                                c * 8) =
          *reinterpret_cast<const uint4*>(sO + r * LD + c * 8);
  }
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int b,
                int sq, int sk, int nh, int nkv, float scale, int causal,
                void* stream) {
  using Tile = MmaTile<DH>;
  static int allowed[kMaxDevices] = {};
  cudaError_t e = allow_smem((const void*)flash_fwd_mma_kernel<DH>,
                             Tile::bytes(2), allowed);
  if (e != cudaSuccess) return (int)e;
  // a second K/V buffer only where some q tile streams several KV tiles
  int n_kv = (sk + kBK - 1) / kBK;
  if (causal) n_kv = min(n_kv, (sq + kBQ - 1) / kBQ);
  const int smem = Tile::bytes(n_kv > 1 ? 2 : 1);
  dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)nh, (unsigned)b);
  flash_fwd_mma_kernel<DH><<<grid, kMmaThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, sq, sk, nh, nkv,
      scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

template <bool BF16>
int dispatch_dh(const void* q, const void* k, const void* v, void* o, int b,
                int sq, int sk, int nh, int nkv, int dh, float scale,
                int causal, void* stream) {
#define FLASH_CASE(D)                                                         \
  case D:                                                                     \
    return BF16 ? launch_bf16<D>(q, k, v, o, b, sq, sk, nh, nkv, scale,       \
                                 causal, stream)                              \
                : launch_f32<D>(q, k, v, o, b, sq, sk, nh, nkv, scale,        \
                                causal, stream);
  switch (dh) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor cores)
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int b, int sq, int sk, int nh, int nkv, int dh,
                        float scale, int causal, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0) return 0;
  if (nkv <= 0 || nh % nkv != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_dh<false>(q, k, v, o, b, sq, sk, nh, nkv, dh, scale, causal,
                              stream);
  if (dtype == 1)
    return dispatch_dh<true>(q, k, v, o, b, sq, sk, nh, nkv, dh, scale, causal,
                             stream);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
