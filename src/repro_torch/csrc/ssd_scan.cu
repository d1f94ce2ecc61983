// SSD (Mamba2) intra-chunk block for Hopper, f32 in and out.
//
// Replaces the Pallas TPU kernel ssd_chunk
// (src/repro/kernels/ssd_scan/kernel.py). For each g of G = batch * chunks
// and each of its H heads, with C/B [Lc, N] shared by the H heads of g,
// xdt [Lc, hd] and cum [Lc] (inclusive cumulative log-decay, non-increasing):
//   y[l]    = sum_{m <= l} (C_l . B_m) * exp(cum_l - cum_m) * xdt_m
//   s_local = sum_m (xdt_m * exp(cum_last - cum_m))^T B_m      [hd, N]
// in the plain version's association: P = (C B^T) o M, then P xdt; and
// xw = xdt * w, then xw^T B. The inter-chunk recurrence stays outside.
//
// Bound: at the serving shape (G=32, H=80, Lc=N=hd=64) one launch moves
// 127.5 MB (xdt, y and s ~42 MB each; C/B are per g) and needs 2.05 GFLOP
// of f32 products (C B^T over the causal pairs once per g, then per head
// the mask product, P xdt, xdt w and xw^T B): 0.038 ms by bytes at
// 3.35 TB/s, 0.031 ms by operations at 67 TFLOP/s. The products stay f32
// FMAs on the CUDA cores, each output summed in ascending k by one fmaf
// chain as the plain version's products sum it (TF32 or wgmma would break
// the 1e-4 contract), so the kernel has to run near both the FMA rate and
// the memory rate at once.
//
// Design: one block of 256 threads per (g, group of hg consecutive heads);
// the launcher picks hg in [1, 8] so that the grid fills whole waves of
// resident blocks (hg = 5 at the serving shape on 132 SMs: 512 blocks, two
// per SM). The block holds B of the whole chunk in shared memory. For each
// 64-row l-tile it computes the causal C B^T tiles [l-tile, m-tiles <= l]
// once into shared memory (stored transposed, Gt[m][l]; micro-tiles above
// the diagonal left out) and then walks the heads of its group over them,
// one step per (head, m-tile): P_h = Gt o exp(cum_l - cum_m) for m <= l
// only (so no exponential of a positive difference exists), stored as
// Pt[m][l]; y_l += P_h xdt_m with y in registers across the head's
// m-tiles, the diagonal tile's zero upper triangle skipped per micro-tile
// row. The local state needs every m-tile of the chunk; the last l-tile's
// walk visits them all, so s_h += xw_m^T B_m accumulates in registers
// there (no second pass). Every product is one 64 x 64 output
// register-tiled over the 256 threads as contiguous 4 x 4 micro-tiles
// whose operands are read k-major with one float4 load each: 2 shared
// loads per 16 FMAs (0.125 per FMA, against 0.5 for strided scalar reads);
// at 64 x 64 outputs a larger micro-tile would leave threads idle. While a
// step computes, the next step's xdt tile (and, at a new head, its cum)
// lands by cp.async in the other of two buffers. Rows past Lc are
// zero-filled and never stored, so any Lc in [1, 256] works: B and the
// l-tile's C B^T tiles are held whole, and 256 is the largest chunk of any
// config. N and hd are template parameters (8, 16, 32, 64).
//
// What holds it back (H100 SXM, benchmarks/torch_kernel_ablation.py): the
// parts of a head step add up rather than overlap. The head's output
// stores cost the most, about twice what a plain fill takes for the same
// bytes; then the products, which read a 256-byte operand row per k for a
// warp's 8 x 64 tile and so keep the SM's shared-memory bandwidth nearly
// busy. Reshaping the warp tiles, fusing the two products, balancing the
// causal triangle across warps and bulk-copy (TMA) stores were each
// measured and moved nothing; what is left is a deeper pipeline or fewer
// bytes to move.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;  // rows of an l-tile and of an m-tile
constexpr int kThreads = 256;
constexpr int kMaxLc = 256;
constexpr int kMaxGroup = 8;
constexpr int kLT = kT + 4;  // row stride of the [*][64] tiles (16-byte rows)
constexpr int kMaxDevices = 64;

// cudaFuncSetAttribute once per kernel instance and device, not per launch:
// `allowed` is the calling instance's own record of what it has set.
cudaError_t allow_smem(const void* kernel, int bytes,
                       int (&allowed)[kMaxDevices], int* dev) {
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  if (*dev < kMaxDevices && allowed[*dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && *dev < kMaxDevices) allowed[*dev] = bytes;
  return e;
}

template <int N, int HD>
struct Smem {
  static constexpr int LB = N + 4;   // B, row-major
  static constexpr int LX = HD + 4;  // xdt and xw tiles
  // Xw [kT][LX], or Bt [N][kLT] while C B^T is computed
  static constexpr int W = kT * LX > N * kLT ? kT * LX : N * kLT;
  static constexpr size_t floats(int n_tiles) {
    return (size_t)n_tiles * kT * LB     // B of the chunk
           + (size_t)n_tiles * kT * kLT  // Gt tiles of one l-tile
           + (size_t)kT * kLT            // Pt (Ct while C B^T is computed)
           + W                           // Xw (Bt)
           + 2 * (size_t)kT * LX         // xdt, two buffers
           + 2 * (size_t)n_tiles * kT;   // cum, two buffers
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16-byte global -> shared copy; valid == false fills the 16 bytes with 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// acc[i][j] += sum_{k < k_end} at[k][r0 + i] * bk[k][c0 + j] for an R x C
// output (threads with r0 >= R or c0 >= C hold no part of it): one fmaf
// chain per output in ascending k, operands as one float4 each.
template <int R, int C>
__device__ __forceinline__ void mm4x4(float (&acc)[4][4], const float* at,
                                      int lda, const float* bk, int ldb,
                                      int k_end, int r0, int c0) {
  if (r0 >= R || c0 >= C) return;
  at += r0;
  bk += c0;
#pragma unroll 4
  for (int k = 0; k < k_end; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(at + k * lda);
    const float4 b = *reinterpret_cast<const float4*>(bk + k * ldb);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void store4x4(float* dst, int ld,
                                         const float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(dst + i * ld) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

template <int N, int HD>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_kernel(const float* __restrict__ cmat, const float* __restrict__ bmat,
                 const float* __restrict__ xdt, const float* __restrict__ cum,
                 float* __restrict__ y, float* __restrict__ s, int nh, int lc,
                 int hg) {
  using S = Smem<N, HD>;
  extern __shared__ __align__(16) float smem[];
  const int n_tiles = (lc + kT - 1) / kT;
  const int lpad = n_tiles * kT;
  float* sB = smem;                       // [lpad][LB]    B rows
  float* sG = sB + lpad * S::LB;          // [n_tiles][kT][kLT]  Gt[m][l]
  float* sP = sG + n_tiles * kT * kLT;    // [kT][kLT]  Pt[m][l]; Ct[n][l]
  float* sW = sP + kT * kLT;              // [kT][LX]  Xw[m][p]; Bt[n][kLT]
  float* sX = sW + S::W;                  // [2][kT][LX]  xdt rows
  float* sCum = sX + 2 * kT * S::LX;      // [2][lpad]

  const int groups = (nh + hg - 1) / hg;
  const int64_t g = blockIdx.x / groups;
  const int h0 = (blockIdx.x % groups) * hg;
  const int nhg = min(hg, nh - h0);
  const int tid = threadIdx.x;
  const int r0 = 4 * (tid / 16), c0 = 4 * (tid % 16);  // micro-tile origin
  const float* C = cmat + g * lc * N;
  const float* Bg = bmat + g * lc * N;

  // one step's operands: xdt rows [m0, m0 + kT) of head h into sX[xbuf],
  // and with a new head its cum into sCum[cbuf]; one commit group
  auto load_step = [&](int h, int m0, int xbuf, bool with_cum, int cbuf) {
    const int64_t gh = g * nh + h;
    const float* X = xdt + (gh * lc + m0) * HD;
    float* dst = sX + xbuf * kT * S::LX;
    for (int idx = tid; idx < kT * HD / 4; idx += kThreads) {
      const int r = idx / (HD / 4), c = 4 * (idx % (HD / 4));
      const bool valid = m0 + r < lc;
      cp_async16(smem_addr(dst + r * S::LX + c), X + (valid ? r * HD + c : 0),
                 valid);
    }
    if (with_cum) {
      float* cd = sCum + cbuf * lpad;
      for (int i = tid; i < lc; i += kThreads)
        cp_async4(smem_addr(cd + i), cum + gh * lc + i);
    }
    cp_async_commit();
  };

  for (int idx = tid; idx < lpad * N / 4; idx += kThreads) {
    const int r = idx / (N / 4), c = 4 * (idx % (N / 4));
    const bool valid = r < lc;
    cp_async16(smem_addr(sB + r * S::LB + c), Bg + (valid ? r * N + c : 0),
               valid);
  }
  cp_async_commit();
  load_step(h0, 0, 0, true, 0);

  int step = 0, visit = 0;  // parities pick the xdt and the cum buffers
  for (int lt = 0; lt < n_tiles; ++lt) {
    const int l0 = lt * kT;
    const bool last = lt == n_tiles - 1;
    __syncthreads();  // the previous l-tile's reads of sP, sW, sG are done
    for (int idx = tid; idx < kT * N / 4; idx += kThreads) {  // Ct[n][l]
      const int l = idx / (N / 4), n = 4 * (idx % (N / 4));
      float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (l0 + l < lc)
        c = *reinterpret_cast<const float4*>(C + (int64_t)(l0 + l) * N + n);
      sP[(n + 0) * kLT + l] = c.x;
      sP[(n + 1) * kLT + l] = c.y;
      sP[(n + 2) * kLT + l] = c.z;
      sP[(n + 3) * kLT + l] = c.w;
    }
    cp_async_wait_all();  // B (first l-tile) and the next step's operands
    for (int mt = 0; mt <= lt; ++mt) {
      __syncthreads();  // Ct written; the previous Gt product read Bt
      for (int idx = tid; idx < kT * N; idx += kThreads) {  // Bt[n][m]
        const int m = idx % kT, n = idx / kT;
        sW[n * kLT + m] = sB[(mt * kT + m) * S::LB + n];
      }
      __syncthreads();
      // Gt[m][l] = sum_n B[m][n] C[l][n]; on the diagonal only m <= l
      if (mt < lt || r0 <= c0 + 3) {
        float acc[4][4] = {};
        mm4x4<kT, kT>(acc, sW, kLT, sP, kLT, N, r0, c0);
        store4x4(sG + mt * kT * kLT + r0 * kLT + c0, kLT, acc);
      }
    }

    for (int hi = 0; hi < nhg; ++hi, ++visit) {
      float y_acc[4][4] = {}, s_acc[4][4] = {};
      const float* cumh = sCum + (visit & 1) * lpad;
      for (int mt = 0; mt <= lt; ++mt, ++step) {
        const int m0 = mt * kT;
        const float* X = sX + (step & 1) * kT * S::LX;
        cp_async_wait_all();
        __syncthreads();  // operands landed; the last step's products done
        const float* Gt = sG + mt * kT * kLT;
        for (int idx = tid; idx < kT * kT / 4; idx += kThreads) {
          const int m = idx / (kT / 4), l = 4 * (idx % (kT / 4));
          const int mg = m0 + m;
          const float4 gv = *reinterpret_cast<const float4*>(Gt + m * kLT + l);
          const float gs[4] = {gv.x, gv.y, gv.z, gv.w};
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int lg = l0 + l + e;
            p[e] = mg <= lg && lg < lc
                       ? __fmul_rn(gs[e], expf(cumh[lg] - cumh[mg]))
                       : 0.0f;
          }
          *reinterpret_cast<float4*>(sP + m * kLT + l) =
              make_float4(p[0], p[1], p[2], p[3]);
        }
        if (last) {  // xw = xdt * exp(cum_last - cum_m)
          const float cl = cumh[lc - 1];
          for (int idx = tid; idx < kT * HD / 4; idx += kThreads) {
            const int m = idx / (HD / 4), c = 4 * (idx % (HD / 4));
            float4 xw = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (m0 + m < lc) {
              const float w = expf(cl - cumh[m0 + m]);
              const float4 xv =
                  *reinterpret_cast<const float4*>(X + m * S::LX + c);
              xw = make_float4(__fmul_rn(xv.x, w), __fmul_rn(xv.y, w),
                               __fmul_rn(xv.z, w), __fmul_rn(xv.w, w));
            }
            *reinterpret_cast<float4*>(sW + m * S::LX + c) = xw;
          }
        }
        __syncthreads();

        int nlt = lt, nhi = hi, nmt = mt + 1;  // the next step, prefetched
        if (nmt > lt) {
          nmt = 0;
          if (++nhi == nhg) {
            nhi = 0;
            ++nlt;
          }
        }
        if (nlt < n_tiles)
          load_step(h0 + nhi, nmt * kT, (step + 1) & 1, nmt == 0,
                    (visit + (nmt == 0)) & 1);

        const int kv = min(kT, lc - m0);
        mm4x4<kT, HD>(y_acc, sP, kLT, X, S::LX,
                      mt == lt ? min(kv, r0 + 4) : kv, r0, c0);
        if (last)
          mm4x4<HD, N>(s_acc, sW, S::LX, sB + m0 * S::LB, S::LB, kv, r0, c0);
      }

      const int64_t gh = g * nh + h0 + hi;
      if (c0 < HD) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = l0 + r0 + i;
          if (l < lc)
            *reinterpret_cast<float4*>(y + (gh * lc + l) * HD + c0) =
                make_float4(y_acc[i][0], y_acc[i][1], y_acc[i][2],
                            y_acc[i][3]);
        }
      }
      if (last && r0 < HD && c0 < N)
        store4x4(s + (gh * HD + r0) * N + c0, N, s_acc);
    }
  }
}

// The head-group size: the grid G * ceil(H / hg) runs in waves of
// `slots` resident blocks, and a block costs about hg head steps plus a
// third of one for its C B^T (the causal half of 64^3 FMAs, against
// ~1.5 x 64^3 for a head step's products): minimise waves * (3 hg + 1),
// the larger hg on a tie.
int pick_group(int64_t g, int nh, int64_t slots) {
  int best = 1;
  int64_t best_cost = -1;
  for (int hg = 1; hg <= kMaxGroup && hg <= nh; ++hg) {
    const int64_t blocks = g * ((nh + hg - 1) / hg);
    const int64_t cost = (blocks + slots - 1) / slots * (3 * hg + 1);
    if (best_cost < 0 || cost <= best_cost) {
      best = hg;
      best_cost = cost;
    }
  }
  return best;
}

template <int N, int HD>
int launch(const void* c, const void* b, const void* x, const void* cum,
           void* y, void* s, int64_t g, int nh, int lc, void* stream) {
  using S = Smem<N, HD>;
  const void* kernel = (const void*)ssd_chunk_kernel<N, HD>;
  static int allowed[kMaxDevices] = {};
  static int occ_smem[kMaxDevices] = {}, occ_slots[kMaxDevices] = {};
  if (lc > kMaxLc) return (int)cudaErrorInvalidValue;
  const int smem = (int)(sizeof(float) * S::floats((lc + kT - 1) / kT));
  int dev = 0;
  cudaError_t e = allow_smem(
      kernel, (int)(sizeof(float) * S::floats(kMaxLc / kT)), allowed, &dev);
  if (e != cudaSuccess) return (int)e;
  int slots = 0;
  if (dev < kMaxDevices && occ_smem[dev] == smem) {
    slots = occ_slots[dev];
  } else {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    slots = per_sm * sms;
    if (slots <= 0) return (int)cudaErrorInvalidConfiguration;
    if (dev < kMaxDevices) {
      occ_smem[dev] = smem;
      occ_slots[dev] = slots;
    }
  }
  const int hg = pick_group(g, nh, slots);
  const int64_t blocks = g * ((nh + hg - 1) / hg);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ssd_chunk_kernel<N, HD><<<(unsigned)blocks, kThreads, smem,
                            (cudaStream_t)stream>>>(
      (const float*)c, (const float*)b, (const float*)x, (const float*)cum,
      (float*)y, (float*)s, nh, lc, hg);
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
// s [g, nh, hd, n]; all f32, contiguous, 16-byte aligned.
int ssd_chunk_fwd(const void* c, const void* b, const void* x,
                  const void* cum, void* y, void* s, int64_t g, int nh,
                  int lc, int n, int hd, void* stream) {
  if (g <= 0 || nh <= 0 || lc <= 0) return 0;
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
