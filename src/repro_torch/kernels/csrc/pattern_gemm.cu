// Tile-pattern sparse GEMM for Hopper (sm_90a):
//   y[:, panel j] = act(x[:, lane_idx[j]] @ w_packed[j] + bias[panel j])
//
// Replaces the Pallas TPU kernel repro/kernels/pattern_gemm.py:pattern_gemm
// (body _kernel). The weight W (Q, P) keeps `keep` of every `group_q` input
// lanes, shared across each panel of bp output columns, and is stored
// blocked: w_packed (nb, Kp, bp), one contiguous panel per output block,
// with lane_idx (nb, Kp) int32 naming the source row of x for each packed
// row. x (M, Q) and out (M, P = nb*bp) are row-major; bf16 or fp32 in, fp32
// accumulate, the bias/activation epilogue runs on the fp32 accumulator
// before the single store. The caller names the variant (`variant`), as
// repro_torch/kernels/pattern_gemm.py:tiled_variant decides it.
//
// What bounds it on an H100: at decode (M = batch, a few rows) every packed
// weight byte is read once for a handful of FMAs: memory-bound, and with
// few panels (12 for a 1536-wide output) latency-bound too. So the skinny
// variant spreads panels, column groups AND slices of the packed K rows over
// blocks (about two blocks per SM), stages the gathered x slice in shared
// memory with independent loads, and streams the panel with vector loads.
// At prefill (M = B*S in the thousands) the work is compute-bound (2 M Kp P
// FLOPs against a few MB): it wants Hopper's wgmma at full rate, fed without
// stalls. The earlier WMMA tile lost 4-5x to cuBLAS there, by gathering A
// with one 2-byte load per element through the lane table, a one-deep
// register prefetch with two block barriers per 32-deep K step, mma.sync
// (which cannot reach Hopper's tensor-core rate) and a grid that swept every
// panel before the next row tile (the LM head's weight streamed from HBM
// once per row tile). The wgmma variant (sm90_gemm.cuh, GATHER mode) keeps
// the gather fused but dense: a tile-pattern lane table is banded, so each
// 64-deep K stage TMA-loads the 128 x columns its packed rows can read, the
// panel slice and the stage's lane indices into a 2- or 3-stage mbarrier
// ring fed by one producer thread (two blocks share an SM); each consumer thread picks its A
// fragments from the staged band in shared memory (2-byte loads, which with
// the band's 2x over-fetch keep it at about half of column_gemm's rate) and
// runs wgmma m64n{bp}k16 from registers; the bf16 tile leaves through
// shared memory by TMA stores. Row tiles run fastest in the grid, so a panel
// streams from HBM once. Lanes off the band (a table from another packer)
// are read from device memory, so any table is right.
// The WMMA tile stays for shapes TMA cannot describe (Q % 8 or Kp % 4 not
// 0, unaligned operands); fp32 inputs take fp32 FMAs so fp32 results stay
// fp32.

#include "sm90_gemm.cuh"

#include <mma.h>

namespace {

// ---------------------------------------------------------------- skinny
// M <= SK_MMAX (decode). Block (j, g, z): panel j, columns
// [g*32*CPL, +32*CPL) of that panel, packed rows [z*kchunk, +kchunk).
// The block first gathers x[m, lane_idx[j, k]] for a KC-row slice into
// shared memory (all threads, independent loads), then warp w streams
// packed rows k = w, w + SK_WARPS, ... of the slice, each lane reading CPL
// adjacent columns with one vector load; partial sums meet in shared
// memory. With ksplit > 1 each K slice writes fp32 partials to `ws`
// (ksplit, M, P) and pg_reduce adds them in a fixed order and applies the
// epilogue, so results do not depend on scheduling.
constexpr int SK_WARPS = 8;
constexpr int SK_KC = 128;

template <typename T, int CPL> struct Vec;
template <> struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) { v[0] = *p; }
};
template <> struct Vec<float, 2> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  }
};
template <> struct Vec<bf16, 1> {
  static __device__ __forceinline__ void load(const bf16* p, float* v) {
    v[0] = __bfloat162float(*p);
  }
};
template <> struct Vec<bf16, 2> {
  static __device__ __forceinline__ void load(const bf16* p, float* v) {
    const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(p);
    v[0] = __low2float(t); v[1] = __high2float(t);
  }
};

template <typename T, int CPL>
__global__ void __launch_bounds__(SK_WARPS * 32)
pg_skinny(const T* __restrict__ x, const T* __restrict__ w,
          const int* __restrict__ lane_idx, const T* __restrict__ bias,
          T* __restrict__ out, float* __restrict__ ws, int M, int Q, int Kp,
          int bp, int kchunk, int act) {
  __shared__ float xs[SK_MMAX][SK_KC];
  __shared__ float red[SK_WARPS][SK_MMAX][32 * CPL];
  const int j = blockIdx.x, z = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cbase = blockIdx.y * 32 * CPL;          // first column in panel
  const T* wj = w + (size_t)j * Kp * bp + cbase + lane * CPL;
  const int* li = lane_idx + (size_t)j * Kp;
  const int k_lo = z * kchunk, k_hi = min(Kp, k_lo + kchunk);

  float acc[SK_MMAX][CPL];
#pragma unroll
  for (int m = 0; m < SK_MMAX; ++m)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[m][c] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += SK_KC) {
    const int kn = min(SK_KC, k_hi - k0);
    __syncthreads();                                 // xs free again
    for (int e = threadIdx.x; e < M * SK_KC; e += SK_WARPS * 32) {
      const int m = e / SK_KC, kk = e % SK_KC;
      xs[m][kk] = kk < kn ? to_f(x[(size_t)m * Q + li[k0 + kk]]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = warp; kk < kn; kk += SK_WARPS) {
      float wv[CPL];
      Vec<T, CPL>::load(wj + (size_t)(k0 + kk) * bp, wv);
#pragma unroll
      for (int m = 0; m < SK_MMAX; ++m) {
        if (m < M) {
          const float xv = xs[m][kk];
#pragma unroll
          for (int c = 0; c < CPL; ++c) acc[m][c] = fmaf(xv, wv[c], acc[m][c]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < SK_MMAX; ++m)
#pragma unroll
    for (int c = 0; c < CPL; ++c) red[warp][m][lane * CPL + c] = acc[m][c];
  __syncthreads();

  const int P = gridDim.x * bp;
  for (int e = threadIdx.x; e < M * 32 * CPL; e += SK_WARPS * 32) {
    const int m = e / (32 * CPL), c = e % (32 * CPL);
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < SK_WARPS; ++wi) s += red[wi][m][c];
    const int col = j * bp + cbase + c;
    if (gridDim.z == 1) {
      const float b = bias ? to_f(bias[col]) : 0.f;
      out[(size_t)m * P + col] = from_f<T>(epilogue(s, b, act));
    } else {
      ws[((size_t)z * M + m) * P + col] = s;
    }
  }
}

// out[m, col] = act(sum_z ws[z, m, col] + bias[col])
template <typename T>
__global__ void __launch_bounds__(256)
pg_reduce(const float* __restrict__ ws, const T* __restrict__ bias,
          T* __restrict__ out, int M, int P, int ksplit, int act) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= M * P) return;
  float s = 0.f;
  for (int z = 0; z < ksplit; ++z) s += ws[(size_t)z * M * P + e];
  const float b = bias ? to_f(bias[e % P]) : 0.f;
  out[e] = from_f<T>(epilogue(s, b, act));
}

// ------------------------------------------------------ WMMA tile, bf16
// For shapes the wgmma variant's TMA maps cannot describe (Q % 8 != 0,
// Kp % 4 != 0, operands not 16-byte aligned).
// Block (j, i): output rows [i*TMB, +TMB) of panel j; 8 warps in a 4 x 2
// grid, warp (wr, wc) owning rows [32wr, +32) and columns [wc*BN/2, +BN/2)
// as 2 x BN/32 WMMA accumulators. Each K step's gathered A slice and panel
// slice are loaded into registers while the tensor cores work on the
// previous step's shared-memory copy. In the A gather every thread keeps
// one packed row k (one lane_idx load) and reads it for 16 rows of x.
constexpr int TK = 32;
constexpr int TMB = 128;

template <int BN>
__global__ void __launch_bounds__(256)
pg_wmma_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
             const int* __restrict__ lane_idx, const bf16* __restrict__ bias,
             bf16* __restrict__ out, int M, int Q, int Kp, int act) {
  using namespace nvcuda;
  constexpr int WN = BN / 2, FN = WN / 16;
  constexpr int BV = TK * BN / 8;                  // 16-byte loads per slice
  constexpr int BPT = (BV + 255) / 256;
  constexpr int APT = TMB * TK / 256;              // gathered A per thread
  // row pads keep WMMA's 32-byte pointer alignment and break bank conflicts
  __shared__ __align__(32) bf16 As[TMB][TK + 8];
  __shared__ __align__(32) bf16 Bs[TK][BN + 8];
  __shared__ __align__(32) float Es[8][16 * 16];   // per-warp epilogue tile
  const int j = blockIdx.x, m0 = blockIdx.y * TMB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp >> 1, wc = warp & 1;
  const bf16* wj = w + (size_t)j * Kp * BN;
  const int* li = lane_idx + (size_t)j * Kp;
  const bf16 zero = __float2bfloat16(0.f);

  bf16 areg[APT];
  uint4 breg[BPT];
  auto load = [&](int k0) {
    const int k = k0 + (tid & 31);
    const int q = k < Kp ? li[k] : -1;
#pragma unroll
    for (int i = 0; i < APT; ++i) {
      const int m = m0 + (tid >> 5) + 8 * i;
      areg[i] = (m < M && q >= 0) ? x[(size_t)m * Q + q] : zero;
    }
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      const int e = tid + 256 * i, r = e / (BN / 8), c = (e % (BN / 8)) * 8;
      breg[i] = make_uint4(0, 0, 0, 0);
      if (e < BV && k0 + r < Kp)
        breg[i] = *reinterpret_cast<const uint4*>(wj + (size_t)(k0 + r) * BN + c);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < APT; ++i) As[(tid >> 5) + 8 * i][tid & 31] = areg[i];
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      const int e = tid + 256 * i, r = e / (BN / 8), c = (e % (BN / 8)) * 8;
      if (e < BV) *reinterpret_cast<uint4*>(&Bs[r][c]) = breg[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][FN];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int f = 0; f < FN; ++f) wmma::fill_fragment(acc[i][f], 0.f);

  load(0);
  store();
  __syncthreads();
  for (int k0 = 0; k0 < Kp; k0 += TK) {
    const bool more = k0 + TK < Kp;
    if (more) load(k0 + TK);                       // in flight during MMAs
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[wr * 32 + i * 16][kk], TK + 8);
#pragma unroll
      for (int f = 0; f < FN; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, &Bs[kk][wc * WN + f * 16], BN + 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][f], a[i], b, acc[i][f]);
      }
    }
    __syncthreads();                               // tiles fully consumed
    if (more) {
      store();
      __syncthreads();
    }
  }

  const int P = gridDim.x * BN;
  float* es = Es[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int f = 0; f < FN; ++f) {
      wmma::store_matrix_sync(es, acc[i][f], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wr * 32 + i * 16 + e / 16;
        const int col = j * BN + wc * WN + f * 16 + e % 16;
        if (m < M) {
          const float b = bias ? to_f(bias[col]) : 0.f;
          out[(size_t)m * P + col] = from_f<bf16>(epilogue(es[e], b, act));
        }
      }
      __syncwarp();
    }
  }
}

// ----------------------------------------------------------- tiled, fp32
// 64-row tiles with fp32 FMAs: 16x16 threads, thread (ty, tx) owns rows
// 4ty..4ty+3 and columns tx + 16c.
constexpr int TM = 64;
template <int BN>
__global__ void __launch_bounds__(256)
pg_simt_f32(const float* __restrict__ x, const float* __restrict__ w,
            const int* __restrict__ lane_idx, const float* __restrict__ bias,
            float* __restrict__ out, int M, int Q, int Kp, int act) {
  __shared__ float As[TK][TM + 1];                  // transposed: As[k][m]
  __shared__ float Bs[TK][BN];
  const int j = blockIdx.x, m0 = blockIdx.y * TM;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* wj = w + (size_t)j * Kp * BN;
  const int* li = lane_idx + (size_t)j * Kp;
  float acc[4][BN / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < BN / 16; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < Kp; k0 += TK) {
    for (int e = tid; e < TM * TK; e += 256) {
      const int r = e / TK, c = e % TK, m = m0 + r, k = k0 + c;
      As[c][r] = (m < M && k < Kp) ? x[(size_t)m * Q + li[k]] : 0.f;
    }
    for (int e = tid; e < TK * BN; e += 256) {
      const int r = e / BN, c = e % BN, k = k0 + r;
      Bs[r][c] = (k < Kp) ? wj[(size_t)k * BN + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < TK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int c = 0; c < BN / 16; ++c) {
        const float b = Bs[kk][tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(a[i], b, acc[i][c]);
      }
    }
    __syncthreads();
  }
  const int P = gridDim.x * BN;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < BN / 16; ++c) {
      const int col = j * BN + tx + 16 * c;
      const float b = bias ? bias[col] : 0.f;
      out[(size_t)m * P + col] = epilogue(acc[i][c], b, act);
    }
  }
}

template <typename T>
void launch_skinny(const void* x, const void* w, const int* li, const void* b,
                   void* o, float* ws, int M, int Q, int nb, int Kp, int bp,
                   int ksplit, int act, cudaStream_t s) {
  const T* xt = (const T*)x; const T* wt = (const T*)w;
  const T* bt = (const T*)b; T* ot = (T*)o;
  const int kchunk = (Kp + ksplit - 1) / ksplit;
  if (bp == 32) {
    pg_skinny<T, 1><<<dim3(nb, 1, ksplit), SK_WARPS * 32, 0, s>>>(
        xt, wt, li, bt, ot, ws, M, Q, Kp, bp, kchunk, act);
  } else {
    pg_skinny<T, 2><<<dim3(nb, bp / 64, ksplit), SK_WARPS * 32, 0, s>>>(
        xt, wt, li, bt, ot, ws, M, Q, Kp, bp, kchunk, act);
  }
  if (ksplit > 1) {
    const int n = M * nb * bp;
    pg_reduce<T><<<(n + 255) / 256, 256, 0, s>>>(ws, bt, ot, M, nb * bp,
                                                 ksplit, act);
  }
}

template <int BN>
void launch_tiled(const void* x, const void* w, const int* li, const void* b,
                  void* o, int M, int Q, int nb, int Kp, int is_bf16, int act,
                  cudaStream_t s) {
  if (is_bf16) {
    pg_wmma_bf16<BN><<<dim3(nb, (M + TMB - 1) / TMB), 256, 0, s>>>(
        (const bf16*)x, (const bf16*)w, li, (const bf16*)b, (bf16*)o, M, Q,
        Kp, act);
  } else {
    pg_simt_f32<BN><<<dim3(nb, (M + TM - 1) / TM), 256, 0, s>>>(
        (const float*)x, (const float*)w, li, (const float*)b, (float*)o, M,
        Q, Kp, act);
  }
}

// wgmma variant: TMA maps over x (Q, M), the panels (bp, Kp, nb) and
// lane_idx (Kp, nb), innermost first; then the fixed-order reduce of a K
// split.
template <int BN>
cudaError_t launch_wgmma(const void* x, const void* w, const int* li,
                         const void* b, void* o, float* ws, int M, int Q,
                         int nb, int Kp, int block_m, int ksplit,
                         int mfast, int act, cudaStream_t s) {
  constexpr int BI = BN < 64 ? BN : 64;
  CUtensorMap tx, tw, tl;
  const cuuint64_t xd[2] = {(cuuint64_t)Q, (cuuint64_t)M};
  const cuuint64_t xs[1] = {(cuuint64_t)Q * 2};
  const cuuint32_t xb[2] = {64, (cuuint32_t)block_m};
  const cuuint64_t wd[3] = {BN, (cuuint64_t)Kp, (cuuint64_t)nb};
  const cuuint64_t wst[2] = {BN * 2, (cuuint64_t)Kp * BN * 2};
  const cuuint32_t wb[3] = {BI, sm90::BK, 1};
  const cuuint64_t ld[2] = {(cuuint64_t)Kp, (cuuint64_t)nb};
  const cuuint64_t ls[1] = {(cuuint64_t)Kp * 4};
  const cuuint32_t lb[2] = {sm90::BK, 1};
  if (!sm90::make_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xd, xs, xb,
                      CU_TENSOR_MAP_SWIZZLE_128B) ||
      !sm90::make_map(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, w, wd, wst, wb,
                      BI == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_64B) ||
      !sm90::make_map(&tl, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, li, ld, ls, lb,
                      CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  sm90::Args a;
  a.x = (const bf16*)x; a.bias = (const bf16*)b; a.out = (bf16*)o;
  a.ws = ksplit > 1 ? ws : nullptr;
  a.M = M; a.Q = Q; a.K = Kp; a.P = nb * BN;
  a.ksteps = (Kp + sm90::BK - 1) / sm90::BK;
  a.kper = (a.ksteps + ksplit - 1) / ksplit;
  a.panel = 1; a.act = act; a.mfast = mfast;
  const cudaError_t e =
      block_m == 128
          ? sm90::launch_gemm<128, BN, true>(tx, tw, tl, a, nb, ksplit, s)
          : sm90::launch_gemm<64, BN, true>(tx, tw, tl, a, nb, ksplit, s);
  if (e != cudaSuccess || ksplit == 1) return e;
  const int n = M * nb * BN;
  pg_reduce<bf16><<<(n + 255) / 256, 256, 0, s>>>(ws, (const bf16*)b,
                                                  (bf16*)o, M, nb * BN,
                                                  ksplit, act);
  return cudaGetLastError();
}

}  // namespace

// bias may be null; bp must be 32, 64 or 128. `variant` is the route the
// caller chose (V_*; pattern_gemm.py:tiled_variant): skinny for M <= 16,
// wgmma (bf16; Q % 8 == 0, Kp % 4 == 0, 16-byte aligned operands) with a
// `block_m` of 64 or 128 rows and a `grid_order` (1: row tiles fastest, 0:
// panels fastest; kernels/sm90.py:GRID_ORDERS), wmma (bf16) or simt (fp32),
// which ignore the grid order. skinny and wgmma split
// the packed rows `ksplit` ways, and ksplit > 1 needs an fp32 workspace `ws`
// of ksplit * M * nb * bp floats. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the variant does not take.
extern "C" int pattern_gemm_launch(const void* x, const void* w_packed,
                                   const void* lane_idx, const void* bias,
                                   void* out, void* ws, int M, int Q, int nb,
                                   int Kp, int bp, int ksplit, int variant,
                                   int block_m, int grid_order, int is_bf16,
                                   int act, void* stream) {
  if ((bp != 32 && bp != 64 && bp != 128) || M <= 0 || nb <= 0 || Kp <= 0 ||
      (grid_order != 0 && grid_order != 1))
    return (int)cudaErrorInvalidValue;
  if (ksplit < 1 || ksplit > 65535 || (ksplit > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  const bool ok =
      variant == V_SKINNY ? M <= SK_MMAX
      : variant == V_WGMMA ? M > SK_MMAX && is_bf16 && Q % 8 == 0 &&
                                 Kp % 4 == 0 &&
                                 (block_m == 64 || block_m == 128)
      : variant == V_WMMA ? M > SK_MMAX && is_bf16 && ksplit == 1
      : variant == V_SIMT ? M > SK_MMAX && !is_bf16 && ksplit == 1
                          : false;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* li = (const int*)lane_idx;
  if (variant == V_SKINNY) {
    if (is_bf16)
      launch_skinny<bf16>(x, w_packed, li, bias, out, (float*)ws, M, Q, nb,
                          Kp, bp, ksplit, act, s);
    else
      launch_skinny<float>(x, w_packed, li, bias, out, (float*)ws, M, Q, nb,
                           Kp, bp, ksplit, act, s);
  } else if (variant == V_WGMMA) {
    cudaError_t e =
        bp == 32
            ? launch_wgmma<32>(x, w_packed, li, bias, out, (float*)ws, M, Q,
                               nb, Kp, block_m, ksplit, grid_order, act, s)
        : bp == 64
            ? launch_wgmma<64>(x, w_packed, li, bias, out, (float*)ws, M, Q,
                               nb, Kp, block_m, ksplit, grid_order, act, s)
            : launch_wgmma<128>(x, w_packed, li, bias, out, (float*)ws, M, Q,
                                nb, Kp, block_m, ksplit, grid_order, act, s);
    if (e != cudaSuccess) return (int)e;
  } else if (bp == 32) {
    launch_tiled<32>(x, w_packed, li, bias, out, M, Q, nb, Kp, is_bf16, act, s);
  } else if (bp == 64) {
    launch_tiled<64>(x, w_packed, li, bias, out, M, Q, nb, Kp, is_bf16, act, s);
  } else {
    launch_tiled<128>(x, w_packed, li, bias, out, M, Q, nb, Kp, is_bf16, act, s);
  }
  return (int)cudaGetLastError();
}
