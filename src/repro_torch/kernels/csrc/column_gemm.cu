// Column-pruned GEMM for Hopper (sm_90a):
//   y = act(x[:, kept_idx] @ w_packed + bias)
//
// Replaces the Pallas TPU kernel repro/kernels/column_gemm.py:column_gemm
// (body _kernel). Column pruning removes whole contraction rows of W (Q, P),
// the same rows for every output column, so one index list kept_idx (K,)
// int32 serves the whole layer and w_packed (K, P) is the surviving rows,
// row-major, exactly as the reference stores them. x (M, Q) and out (M, P)
// are row-major; bf16 or fp32 in, fp32 accumulate, and the bias/activation
// epilogue runs on the fp32 accumulator before the single store. K and P
// may be ragged. The caller names the variant (`variant`), as
// repro_torch/kernels/column_gemm.py:tiled_variant decides it.
//
// What bounds it on an H100: at decode (M = batch, a few rows) every packed
// weight byte is read once for M FMAs, so the product is bound by the bytes
// of w_packed. The skinny variant streams w_packed with 16-byte loads (a
// warp reads 512 contiguous bytes of a row), splits K over the 8 warps of a
// block and over blocks (about two blocks per SM), keeps the gathered x
// slice in shared memory, and sums the K slices in a fixed order in a second
// pass, so results do not depend on scheduling. At prefill (M = B*S in the
// thousands) the product is compute-bound and wants Hopper's wgmma at full
// rate. The earlier WMMA tile fused the kept_idx gather into its A load and
// lost 4-5x to cuBLAS: 2-byte loads through the index list, repeated in
// every one of the P/128 column blocks (1187 at the LM head), a one-deep
// register prefetch with two block barriers per 32-deep K step, mma.sync,
// and a grid that swept all columns before the next row tile. So the bf16
// variant now gathers once, as the reference does outside its kernel:
// cg_gather writes xg = x[:, kept_idx] (M, K) with 16-byte stores (3 MB at
// M = 2048, K = 768: microseconds against a GEMM of 0.1-0.5 ms), and a dense
// wgmma GEMM (sm90_gemm.cuh) reads xg and w_packed by TMA into a 3- or
// 4-stage mbarrier ring (two blocks share an SM), w_packed through wgmma's
// transposed-B mode, writes its bf16 tile through shared memory by TMA
// stores, and runs row tiles fastest so a weight larger than L2 streams
// from HBM once. The
// WMMA tile stays for P % 8 != 0 (TMA needs 16-byte row strides) and
// unaligned operands; fp32 inputs take fp32 FMAs so fp32 results stay fp32.

#include "sm90_gemm.cuh"

#include <mma.h>

namespace {

// CPL consecutive values starting at p, as fp32; CPL * sizeof(T) is 16
// bytes (one vector load) or CPL is 1
template <typename T, int CPL> struct Row;
template <> struct Row<bf16, 8> {
  static __device__ __forceinline__ void load(const bf16* p, float* v) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __low2float(h[i]);
      v[2 * i + 1] = __high2float(h[i]);
    }
  }
};
template <> struct Row<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
};
template <typename T> struct Row<T, 1> {
  static __device__ __forceinline__ void load(const T* p, float* v) {
    v[0] = to_f(*p);
  }
};

// ---------------------------------------------------------------- skinny
// M <= SK_MMAX (decode). Block (g, z): output columns [g*32*CPL, +32*CPL),
// packed rows [z*kchunk, +kchunk). The block first gathers x[m, kept[k]]
// for a KC-row slice into shared memory (all threads, independent loads),
// then warp w streams packed rows k = w, w + SK_WARPS, ... of the slice,
// each lane reading CPL adjacent columns with one vector load. The 8 warps'
// partial sums meet in shared memory one row of x at a time. With
// ksplit > 1 each K slice writes fp32 partials to `ws` (ksplit, M, P) and
// cg_reduce adds them in a fixed order and applies the epilogue.
constexpr int SK_WARPS = 8;
constexpr int SK_KC = 128;

template <typename T, int CPL, int MT>
__global__ void __launch_bounds__(SK_WARPS * 32)
cg_skinny(const T* __restrict__ x, const T* __restrict__ w,
          const int* __restrict__ kept, const T* __restrict__ bias,
          T* __restrict__ out, float* __restrict__ ws, int M, int Q, int K,
          int P, int kchunk, int act) {
  __shared__ float xs[MT][SK_KC];
  __shared__ float red[SK_WARPS][32 * CPL];
  const int z = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cbase = blockIdx.x * 32 * CPL;
  const int col = cbase + lane * CPL;              // this lane's first column
  const bool live = col < P;          // CPL > 1 only when P % CPL == 0
  const int k_lo = z * kchunk, k_hi = min(K, k_lo + kchunk);

  float acc[MT][CPL];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[m][c] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += SK_KC) {
    const int kn = min(SK_KC, k_hi - k0);
    __syncthreads();                                 // xs free again
    for (int e = threadIdx.x; e < MT * SK_KC; e += SK_WARPS * 32) {
      const int m = e / SK_KC, kk = e % SK_KC;
      xs[m][kk] = (m < M && kk < kn) ? to_f(x[(size_t)m * Q + kept[k0 + kk]])
                                     : 0.f;
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int kk = warp; kk < kn; kk += SK_WARPS) {
        float wv[CPL];
        Row<T, CPL>::load(w + (size_t)(k0 + kk) * P + col, wv);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xs[m][kk];
#pragma unroll
          for (int c = 0; c < CPL; ++c) acc[m][c] = fmaf(xv, wv[c], acc[m][c]);
        }
      }
    }
  }

  // m is unrolled so acc stays in registers; M is uniform over the block,
  // so every thread reaches the same barriers
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;
    __syncthreads();                                 // red free again
#pragma unroll
    for (int c = 0; c < CPL; ++c) red[warp][lane * CPL + c] = acc[m][c];
    __syncthreads();
    for (int c = threadIdx.x; c < 32 * CPL; c += SK_WARPS * 32) {
      const int o = cbase + c;
      if (o >= P) continue;
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < SK_WARPS; ++wi) s += red[wi][c];
      if (gridDim.y == 1) {
        const float b = bias ? to_f(bias[o]) : 0.f;
        out[(size_t)m * P + o] = from_f<T>(epilogue(s, b, act));
      } else {
        ws[((size_t)z * M + m) * P + o] = s;
      }
    }
  }
}

// out[m, col] = act(sum_z ws[z, m, col] + bias[col])
template <typename T>
__global__ void __launch_bounds__(256)
cg_reduce(const float* __restrict__ ws, const T* __restrict__ bias,
          T* __restrict__ out, int M, int P, int ksplit, int act) {
  const size_t e = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (e >= (size_t)M * P) return;
  float s = 0.f;
  for (int z = 0; z < ksplit; ++z) s += ws[(size_t)z * M * P + e];
  const float b = bias ? to_f(bias[e % P]) : 0.f;
  out[e] = from_f<T>(epilogue(s, b, act));
}

// ------------------------------------------------------ WMMA tile, bf16
// For P % 8 != 0 and operands that are not 16-byte aligned.
// Block (j, i): output rows [i*TMB, +TMB), columns [j*BN, +BN); 8 warps in
// a 4 x 2 grid, warp (wr, wc) owning rows [32wr, +32) and columns
// [wc*BN/2, +BN/2) as 2 x BN/32 WMMA accumulators. Each K step's gathered A
// slice and w_packed slice are loaded into registers while the tensor cores
// work on the previous step's shared-memory copy. In the A gather every
// thread keeps one packed row k (one kept_idx load) and reads it for 16
// rows of x. VEC: P % 8 == 0, so w_packed rows take 16-byte loads.
constexpr int TK = 32;
constexpr int TMB = 128;

template <int BN, bool VEC>
__global__ void __launch_bounds__(256)
cg_wmma_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
             const int* __restrict__ kept, const bf16* __restrict__ bias,
             bf16* __restrict__ out, int M, int Q, int K, int P, int act) {
  using namespace nvcuda;
  constexpr int WN = BN / 2, FN = WN / 16;
  constexpr int BV = TK * BN / 8;                  // 16-byte loads per slice
  constexpr int BPT = (BV + 255) / 256;
  constexpr int APT = TMB * TK / 256;              // gathered A per thread
  // row pads keep WMMA's 32-byte pointer alignment and break bank conflicts
  __shared__ __align__(32) bf16 As[TMB][TK + 8];
  __shared__ __align__(32) bf16 Bs[TK][BN + 8];
  __shared__ __align__(32) float Es[8][16 * 16];   // per-warp epilogue tile
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * TMB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp >> 1, wc = warp & 1;
  const bf16 zero = __float2bfloat16(0.f);

  bf16 areg[APT];
  uint4 breg[BPT];
  auto load = [&](int k0) {
    const int k = k0 + (tid & 31);
    const int q = k < K ? kept[k] : -1;
#pragma unroll
    for (int i = 0; i < APT; ++i) {
      const int m = m0 + (tid >> 5) + 8 * i;
      areg[i] = (m < M && q >= 0) ? x[(size_t)m * Q + q] : zero;
    }
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      const int e = tid + 256 * i, r = e / (BN / 8), c = (e % (BN / 8)) * 8;
      const int kr = k0 + r, col = n0 + c;
      breg[i] = make_uint4(0, 0, 0, 0);
      if (e >= BV || kr >= K) continue;
      const bf16* src = w + (size_t)kr * P + col;
      if (VEC) {
        if (col < P) breg[i] = *reinterpret_cast<const uint4*>(src);
      } else {
        bf16* v = reinterpret_cast<bf16*>(&breg[i]);
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] = col + t < P ? src[t] : zero;
      }
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
  for (int k0 = 0; k0 < K; k0 += TK) {
    const bool more = k0 + TK < K;
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

  float* es = Es[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int f = 0; f < FN; ++f) {
      wmma::store_matrix_sync(es, acc[i][f], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wr * 32 + i * 16 + e / 16;
        const int col = n0 + wc * WN + f * 16 + e % 16;
        if (m < M && col < P) {
          const float b = bias ? to_f(bias[col]) : 0.f;
          out[(size_t)m * P + col] = from_f<bf16>(epilogue(es[e], b, act));
        }
      }
      __syncwarp();
    }
  }
}

// ----------------------------------------------------------- tiled, fp32
// 64 x 64 tiles with fp32 FMAs: 16x16 threads, thread (ty, tx) owns rows
// 4ty..4ty+3 and columns tx + 16c.
constexpr int TM = 64;
constexpr int TN = 64;
__global__ void __launch_bounds__(256)
cg_simt_f32(const float* __restrict__ x, const float* __restrict__ w,
            const int* __restrict__ kept, const float* __restrict__ bias,
            float* __restrict__ out, int M, int Q, int K, int P, int act) {
  __shared__ float As[TK][TM + 1];                  // transposed: As[k][m]
  __shared__ float Bs[TK][TN];
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float acc[4][TN / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < TN / 16; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int e = tid; e < TM * TK; e += 256) {
      const int r = e / TK, c = e % TK, m = m0 + r, k = k0 + c;
      As[c][r] = (m < M && k < K) ? x[(size_t)m * Q + kept[k]] : 0.f;
    }
    for (int e = tid; e < TK * TN; e += 256) {
      const int r = e / TN, c = e % TN, k = k0 + r, col = n0 + c;
      Bs[r][c] = (k < K && col < P) ? w[(size_t)k * P + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < TK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int c = 0; c < TN / 16; ++c) {
        const float b = Bs[kk][tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(a[i], b, acc[i][c]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < TN / 16; ++c) {
      const int col = n0 + tx + 16 * c;
      if (col >= P) continue;
      const float b = bias ? bias[col] : 0.f;
      out[(size_t)m * P + col] = epilogue(acc[i][c], b, act);
    }
  }
}

template <typename T, int CPL, int MT>
void launch_skinny_mt(const T* x, const T* w, const int* kept, const T* b,
                      T* o, float* ws, int M, int Q, int K, int P, int ksplit,
                      int act, cudaStream_t s) {
  const int kchunk = (K + ksplit - 1) / ksplit;
  const int groups = (P + 32 * CPL - 1) / (32 * CPL);
  cg_skinny<T, CPL, MT><<<dim3(groups, ksplit), SK_WARPS * 32, 0, s>>>(
      x, w, kept, b, o, ws, M, Q, K, P, kchunk, act);
}

template <typename T, int CPL>
void launch_skinny(const void* x, const void* w, const int* kept,
                   const void* b, void* o, float* ws, int M, int Q, int K,
                   int P, int ksplit, int act, cudaStream_t s) {
  const T* xt = (const T*)x; const T* wt = (const T*)w;
  const T* bt = (const T*)b; T* ot = (T*)o;
  if (M <= 4)
    launch_skinny_mt<T, CPL, 4>(xt, wt, kept, bt, ot, ws, M, Q, K, P, ksplit,
                                act, s);
  else if (M <= 8)
    launch_skinny_mt<T, CPL, 8>(xt, wt, kept, bt, ot, ws, M, Q, K, P, ksplit,
                                act, s);
  else
    launch_skinny_mt<T, CPL, 16>(xt, wt, kept, bt, ot, ws, M, Q, K, P, ksplit,
                                 act, s);
  if (ksplit > 1) {
    const size_t n = (size_t)M * P;
    cg_reduce<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(ws, bt, ot, M, P,
                                                            ksplit, act);
  }
}

// ---------------------------------------------------------- gather, bf16
// xg[m, k] = x[m, kept[k]] for k < K, 0 for K <= k < Kpad (Kpad % 8 == 0):
// one 16-byte store of 8 consecutive k per thread.
__global__ void __launch_bounds__(256)
cg_gather(const bf16* __restrict__ x, const int* __restrict__ kept,
          bf16* __restrict__ xg, int M, int Q, int K, int Kpad) {
  const int chunks = Kpad / 8;
  const size_t e = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (e >= (size_t)M * chunks) return;
  const int m = (int)(e / chunks), k = (int)(e % chunks) * 8;
  const bf16* xr = x + (size_t)m * Q;
  uint4 v;
  bf16* h = reinterpret_cast<bf16*>(&v);
#pragma unroll
  for (int t = 0; t < 8; ++t)
    h[t] = k + t < K ? xr[kept[k + t]] : __float2bfloat16(0.f);
  *reinterpret_cast<uint4*>(xg + (size_t)m * Kpad + k) = v;
}

// wgmma variant: gather, then TMA maps over xg (K, M) and w_packed
// (P, K, 1), innermost first; then the fixed-order reduce of a K split.
cudaError_t launch_wgmma(const void* x, const void* w, const int* kept,
                         const void* b, void* o, float* ws, void* xg, int M,
                         int Q, int K, int P, int block_m, int ksplit,
                         int act, cudaStream_t s) {
  const int Kpad = (K + 7) / 8 * 8;
  const size_t n_chunks = (size_t)M * (Kpad / 8);
  cg_gather<<<(unsigned)((n_chunks + 255) / 256), 256, 0, s>>>(
      (const bf16*)x, kept, (bf16*)xg, M, Q, K, Kpad);
  CUtensorMap ta, tw;
  const cuuint64_t ad[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t as[1] = {(cuuint64_t)Kpad * 2};
  const cuuint32_t ab[2] = {sm90::BK, (cuuint32_t)block_m};
  const cuuint64_t wd[3] = {(cuuint64_t)P, (cuuint64_t)K, 1};
  const cuuint64_t wst[2] = {(cuuint64_t)P * 2, (cuuint64_t)K * P * 2};
  const cuuint32_t wb[3] = {64, sm90::BK, 1};
  if (!sm90::make_map(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, xg, ad, as,
                      ab, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !sm90::make_map(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, w, wd, wst, wb,
                      CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  sm90::Args a;
  a.x = (const bf16*)x; a.bias = (const bf16*)b; a.out = (bf16*)o;
  a.ws = ksplit > 1 ? ws : nullptr;
  a.M = M; a.Q = Q; a.K = K; a.P = P;
  a.ksteps = (K + sm90::BK - 1) / sm90::BK;
  a.kper = (a.ksteps + ksplit - 1) / ksplit;
  a.panel = 0; a.act = act;
  const int n_tiles = (P + 127) / 128;
  const cudaError_t e =
      block_m == 128
          ? sm90::launch_gemm<128, 128, false>(ta, tw, ta, a, n_tiles, ksplit, s)
          : sm90::launch_gemm<64, 128, false>(ta, tw, ta, a, n_tiles, ksplit, s);
  if (e != cudaSuccess || ksplit == 1) return e;
  const size_t n = (size_t)M * P;
  cg_reduce<bf16><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      ws, (const bf16*)b, (bf16*)o, M, P, ksplit, act);
  return cudaGetLastError();
}

}  // namespace

// bias may be null. `variant` is the route the caller chose (V_*;
// column_gemm.py:tiled_variant): skinny for M <= 16, wgmma (bf16; K > 0,
// P % 8 == 0, 16-byte aligned operands) with a `block_m` of 64 or 128 rows
// and a scratch `xg` of M * roundup(K, 8) bf16, wmma (bf16) or simt (fp32).
// skinny and wgmma split K `ksplit` ways, and ksplit > 1 needs an fp32
// workspace `ws` of ksplit * M * P floats. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the variant does not take.
extern "C" int column_gemm_launch(const void* x, const void* w_packed,
                                  const void* kept_idx, const void* bias,
                                  void* out, void* ws, void* xg, int M, int Q,
                                  int K, int P, int ksplit, int variant,
                                  int block_m, int is_bf16, int act,
                                  void* stream) {
  if (M <= 0 || P <= 0 || K < 0 || Q <= 0)
    return (int)cudaErrorInvalidValue;
  if (ksplit < 1 || ksplit > 65535 || (ksplit > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  const bool ok =
      variant == V_SKINNY ? M <= SK_MMAX
      : variant == V_WGMMA ? M > SK_MMAX && is_bf16 && K > 0 && P % 8 == 0 &&
                                 xg && (block_m == 64 || block_m == 128)
      : variant == V_WMMA ? M > SK_MMAX && is_bf16 && ksplit == 1
      : variant == V_SIMT ? M > SK_MMAX && !is_bf16 && ksplit == 1
                          : false;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* kept = (const int*)kept_idx;
  if (variant == V_SKINNY) {
    if (is_bf16) {
      if (P % 8 == 0)
        launch_skinny<bf16, 8>(x, w_packed, kept, bias, out, (float*)ws, M, Q,
                               K, P, ksplit, act, s);
      else
        launch_skinny<bf16, 1>(x, w_packed, kept, bias, out, (float*)ws, M, Q,
                               K, P, ksplit, act, s);
    } else {
      if (P % 4 == 0)
        launch_skinny<float, 4>(x, w_packed, kept, bias, out, (float*)ws, M,
                                Q, K, P, ksplit, act, s);
      else
        launch_skinny<float, 1>(x, w_packed, kept, bias, out, (float*)ws, M,
                                Q, K, P, ksplit, act, s);
    }
  } else if (variant == V_WGMMA) {
    const cudaError_t e = launch_wgmma(x, w_packed, kept, bias, out,
                                       (float*)ws, xg, M, Q, K, P, block_m,
                                       ksplit, act, s);
    if (e != cudaSuccess) return (int)e;
  } else if (variant == V_WMMA) {
    const dim3 grid((P + 127) / 128, (M + TMB - 1) / TMB);
    if (P % 8 == 0)
      cg_wmma_bf16<128, true><<<grid, 256, 0, s>>>(
          (const bf16*)x, (const bf16*)w_packed, kept, (const bf16*)bias,
          (bf16*)out, M, Q, K, P, act);
    else
      cg_wmma_bf16<128, false><<<grid, 256, 0, s>>>(
          (const bf16*)x, (const bf16*)w_packed, kept, (const bf16*)bias,
          (bf16*)out, M, Q, K, P, act);
  } else {
    cg_simt_f32<<<dim3((P + TN - 1) / TN, (M + TM - 1) / TM), 256, 0, s>>>(
        (const float*)x, (const float*)w_packed, kept, (const float*)bias,
        (float*)out, M, Q, K, P, act);
  }
  return (int)cudaGetLastError();
}
