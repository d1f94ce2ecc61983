// SSD (Mamba2) intra-chunk block for Hopper, f32 in and out.
//
// Replaces the Pallas TPU kernel ssd_chunk
// (src/repro/kernels/ssd_scan/kernel.py). For each (g, h) of a
// [G = batch * chunks, H] grid, with C/B [Lc, N] shared by the H heads of g,
// xdt [Lc, hd] and cum [Lc] (inclusive cumulative log-decay, non-increasing):
//   y[l]    = sum_{m <= l} (C_l . B_m) * exp(cum_l - cum_m) * xdt_m
//   s_local = sum_m (xdt_m * exp(cum_last - cum_m))^T B_m      [hd, N]
// in the plain version's association: P = (C B^T) o M, then P xdt; and
// xw = xdt * w, then xw^T B. The inter-chunk recurrence stays outside.
//
// Bound: at the serving shape (G=32, H=80, Lc=N=hd=64) one launch moves
// ~127 MB (xdt, y and s ~42 MB each; C/B are per g) and needs ~2.7 GFLOP of
// f32 products (the causal half of C B^T, P xdt, and xw^T B): ~0.04 ms
// either way at 3.35 TB/s and 67 TFLOP/s. The products stay f32 FMAs on the
// CUDA cores with fixed-order sums (TF32 or wgmma would break the 1e-4
// contract), so in practice the shared-memory operand traffic of those FMAs
// bounds this first kernel.
//
// Design: one block of 256 threads per (g, h). The block walks 64-row
// l-tiles and, inside each, the m-tiles at or below the diagonal (upper
// tiles are skipped). Shared memory holds the C_l tile, the B_m and xdt_m
// tiles (C/B rows padded by one float: conflict-free column reads), the
// masked P tile and all of cum. Each product is register-tiled (a thread
// owns a strided 4x4, or narrower, micro-tile): P = C_l B_m^T, y_l += P xdt_m
// (y in registers across m-tiles), and on the diagonal tile, which each
// m-tile is exactly once, s += xw_m^T B_m (s in registers across the whole
// chunk). exp(cum_l - cum_m) is formed only where m <= l, so no exponential
// of a positive difference is computed. Rows past Lc are zero in shared
// memory and never stored, so any Lc works. N and hd are template
// parameters (8, 16, 32, 64); anything else is refused.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;  // rows of an l-tile and of an m-tile
constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // H100: 227 KB per block

// Thread layouts of the three register-tiled products.
template <int N, int HD>
struct Layout {
  // y_l += P xdt_m: YX threads across hd, YY across the tile's rows
  static constexpr int YX = HD < 16 ? HD : 16;
  static constexpr int YY = kThreads / YX;
  static constexpr int YR = kT / YY;
  static constexpr int YC = HD / YX;
  // s += xw^T B: SX threads across N, SY across hd (rows >= hd idle)
  static constexpr int SX = N < 16 ? N : 16;
  static constexpr int SY = kThreads / SX;
  static constexpr int SR = (HD + SY - 1) / SY;
  static constexpr int SC = N / SX;
};

template <int N, int HD>
constexpr size_t smem_floats() {
  return 2 * (size_t)kT * (N + 1) + 2 * (size_t)kT * HD +
         (size_t)kT * (kT + 1);
}

template <int N, int HD>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ cmat, const float* __restrict__ bmat,
                 const float* __restrict__ xdt, const float* __restrict__ cum,
                 float* __restrict__ y, float* __restrict__ s, int nh,
                 int lc) {
  using Lay = Layout<N, HD>;
  extern __shared__ float smem[];
  float* sC = smem;                   // [kT][N+1]  C rows of the l-tile
  float* sB = sC + kT * (N + 1);      // [kT][N+1]  B rows of the m-tile
  float* sX = sB + kT * (N + 1);      // [kT][HD]   xdt rows of the m-tile
  float* sXw = sX + kT * HD;          // [kT][HD]   xdt * w (diagonal tile)
  float* sP = sXw + kT * HD;          // [kT][kT+1] masked (C B^T) o M
  float* sCum = sP + kT * (kT + 1);   // [lc]

  const int64_t gh = blockIdx.x;  // g * nh + h
  const int64_t g = gh / nh;
  const float* C = cmat + g * lc * N;
  const float* Bm = bmat + g * lc * N;
  const float* X = xdt + gh * lc * HD;
  float* Y = y + gh * lc * HD;
  float* S = s + gh * HD * N;
  const int tid = threadIdx.x;

  for (int i = tid; i < lc; i += kThreads) sCum[i] = cum[gh * lc + i];
  __syncthreads();
  const float cum_last = sCum[lc - 1];

  const int ptx = tid % 16, pty = tid / 16;  // P: rows pty+16i, cols ptx+16j
  const int ytx = tid % Lay::YX, yty = tid / Lay::YX;
  const int stx = tid % Lay::SX, sty = tid / Lay::SX;

  float s_acc[Lay::SR][Lay::SC];
#pragma unroll
  for (int i = 0; i < Lay::SR; ++i)
#pragma unroll
    for (int j = 0; j < Lay::SC; ++j) s_acc[i][j] = 0.0f;

  const int n_tiles = (lc + kT - 1) / kT;
  for (int lt = 0; lt < n_tiles; ++lt) {
    const int l0 = lt * kT;
    __syncthreads();  // the previous l-tile's sC is consumed
    for (int idx = tid; idx < kT * N; idx += kThreads) {
      const int r = idx / N, n = idx % N;
      sC[r * (N + 1) + n] =
          l0 + r < lc ? C[(int64_t)(l0 + r) * N + n] : 0.0f;
    }
    float y_acc[Lay::YR][Lay::YC];
#pragma unroll
    for (int i = 0; i < Lay::YR; ++i)
#pragma unroll
      for (int j = 0; j < Lay::YC; ++j) y_acc[i][j] = 0.0f;

    for (int mt = 0; mt <= lt; ++mt) {
      const int m0 = mt * kT;
      const int m_end = min(kT, lc - m0);
      const bool diag = mt == lt;
      __syncthreads();  // the previous m-tile's sB/sX/sXw/sP are consumed
      for (int idx = tid; idx < kT * N; idx += kThreads) {
        const int r = idx / N, n = idx % N;
        sB[r * (N + 1) + n] =
            m0 + r < lc ? Bm[(int64_t)(m0 + r) * N + n] : 0.0f;
      }
      for (int idx = tid; idx < kT * HD; idx += kThreads) {
        const int r = idx / HD;
        const bool in = m0 + r < lc;
        const float xv = in ? X[(int64_t)m0 * HD + idx] : 0.0f;
        sX[idx] = xv;
        if (diag)
          sXw[idx] = in ? __fmul_rn(xv, expf(cum_last - sCum[m0 + r])) : 0.0f;
      }
      __syncthreads();

      // P[r][c] = (C_l . B_m) * exp(cum_l - cum_m) for m <= l < lc, else 0
      float pacc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) pacc[i][j] = 0.0f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sC[(pty + 16 * i) * (N + 1) + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = sB[(ptx + 16 * j) * (N + 1) + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) pacc[i][j] = fmaf(cv[i], bv[j], pacc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = pty + 16 * i, c = ptx + 16 * j;
          const int l = l0 + r, m = m0 + c;
          float v = 0.0f;
          if (l < lc && m <= l) v = __fmul_rn(pacc[i][j], expf(sCum[l] - sCum[m]));
          sP[r * (kT + 1) + c] = v;
        }
      }

      if (diag) {  // s += xw_m^T B_m
        for (int m = 0; m < m_end; ++m) {
          float xw[Lay::SR], bv[Lay::SC];
#pragma unroll
          for (int i = 0; i < Lay::SR; ++i) {
            const int p = sty + Lay::SY * i;
            xw[i] = p < HD ? sXw[m * HD + p] : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < Lay::SC; ++j) bv[j] = sB[m * (N + 1) + stx + Lay::SX * j];
#pragma unroll
          for (int i = 0; i < Lay::SR; ++i)
#pragma unroll
            for (int j = 0; j < Lay::SC; ++j)
              s_acc[i][j] = fmaf(xw[i], bv[j], s_acc[i][j]);
        }
      }
      __syncthreads();  // sP complete

      // y_l += P xdt_m
      for (int m = 0; m < m_end; ++m) {
        float pv[Lay::YR], xv[Lay::YC];
#pragma unroll
        for (int i = 0; i < Lay::YR; ++i) pv[i] = sP[(yty + Lay::YY * i) * (kT + 1) + m];
#pragma unroll
        for (int j = 0; j < Lay::YC; ++j) xv[j] = sX[m * HD + ytx + Lay::YX * j];
#pragma unroll
        for (int i = 0; i < Lay::YR; ++i)
#pragma unroll
          for (int j = 0; j < Lay::YC; ++j) y_acc[i][j] = fmaf(pv[i], xv[j], y_acc[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < Lay::YR; ++i) {
      const int l = l0 + yty + Lay::YY * i;
      if (l < lc) {
#pragma unroll
        for (int j = 0; j < Lay::YC; ++j) Y[(int64_t)l * HD + ytx + Lay::YX * j] = y_acc[i][j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < Lay::SR; ++i) {
    const int p = sty + Lay::SY * i;
    if (p < HD) {
#pragma unroll
      for (int j = 0; j < Lay::SC; ++j) S[p * N + stx + Lay::SX * j] = s_acc[i][j];
    }
  }
}

template <int N, int HD>
int launch(const void* c, const void* b, const void* x, const void* cum,
           void* y, void* s, int64_t g, int nh, int lc, void* stream) {
  const size_t smem = sizeof(float) * (smem_floats<N, HD>() + (size_t)lc);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_kernel<N, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_kernel<N, HD><<<(unsigned)(g * nh), kThreads, smem,
                            (cudaStream_t)stream>>>(
      (const float*)c, (const float*)b, (const float*)x, (const float*)cum,
      (float*)y, (float*)s, nh, lc);
  return (int)cudaGetLastError();
}

template <int N>
int dispatch_hd(const void* c, const void* b, const void* x, const void* cum,
                void* y, void* s, int64_t g, int nh, int lc, int hd,
                void* stream) {
  switch (hd) {
    case 8: return launch<N, 8>(c, b, x, cum, y, s, g, nh, lc, stream);
    case 16: return launch<N, 16>(c, b, x, cum, y, s, g, nh, lc, stream);
    case 32: return launch<N, 32>(c, b, x, cum, y, s, g, nh, lc, stream);
    case 64: return launch<N, 64>(c, b, x, cum, y, s, g, nh, lc, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// c/b [g, lc, n], x [g, nh, lc, hd], cum [g, nh, lc] -> y [g, nh, lc, hd],
// s [g, nh, hd, n]; all f32, contiguous.
int ssd_chunk_fwd(const void* c, const void* b, const void* x,
                  const void* cum, void* y, void* s, int64_t g, int nh,
                  int lc, int n, int hd, void* stream) {
  if (g <= 0 || nh <= 0 || lc <= 0) return 0;
  if (g * nh > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  switch (n) {
    case 8: return dispatch_hd<8>(c, b, x, cum, y, s, g, nh, lc, hd, stream);
    case 16: return dispatch_hd<16>(c, b, x, cum, y, s, g, nh, lc, hd, stream);
    case 32: return dispatch_hd<32>(c, b, x, cum, y, s, g, nh, lc, hd, stream);
    case 64: return dispatch_hd<64>(c, b, x, cum, y, s, g, nh, lc, hd, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
