// Pattern-pruned 3x3 convolution for Hopper (sm_90a), stride 1, SAME:
//   y[b, h, w, a] = act(sum_{c, j} x[b, h + dy(c,j), w + dx(c,j), c]
//                       * w_packed[c*4 + j, a] + bias[a])
// with (dy, dx) = (taps[c, j] / 3 - 1, taps[c, j] % 3 - 1), zero outside
// the image.
//
// Replaces the Pallas TPU kernel repro/kernels/pattern_conv.py:
// pattern_conv_gemm (body _kernel) together with the XLA tap gather
// gather_taps that feeds it. Every filter of input channel c keeps the same
// 4 of the 9 taps, so the conv is one GEMM (B*H*W, 4C) @ (4C, A). The
// reference builds the gathered matrix xg in device memory first; at VGG-16's
// conv1_2 with batch 32 that is 1.6 M x 256 bf16, about 0.8 GB written and
// read again per layer. This kernel never builds xg: it is an implicit GEMM
// whose A-tile load computes each tap's offset from taps[c, j].
//
// x (B, H, W, C) and out (B, H, W, A) are NHWC, w_packed (4C, A) row-major,
// taps (C, 4) int32; bf16 or fp32 in, fp32 accumulate, and the bias /
// activation epilogue runs on the fp32 accumulator before the single NHWC
// store.
//
// What bounds it on an H100: at batch 32 and 224 x 224 the 4C x A product is
// large (2 * M * 4C * A is 53 GFLOP at conv1_2, 0.44 TFLOP over VGG-16's 13
// convs) and the bf16 path is compute-bound on the tensor cores at every
// VGG-16 shape but the first (C = 3); reading x once and writing y once is
// the least traffic. The naive A load would be scattered 2-byte reads (K runs
// channel-major and each channel has its own taps). So a block owns a 2-D
// patch of output pixels (TH x TW of NIMG images, 128 pixels for bf16, 64
// for fp32), and for each K step of CC = 8 channels it stages the patch plus
// its one-pixel halo for those channels in shared memory with 16-byte loads
// along C: each input pixel is read from device memory once per tile and
// K step (the paper's load-redundancy elimination; the halo costs
// (TH+2)(TW+2)/(TH*TW), 1.4x at 8 x 16). The 4 taps of each channel are then
// picked out of shared memory into the A tile, which feeds bf16 WMMA
// tensor-core MMAs (fp32 accumulate) or, for fp32, fp32 FMAs so fp32 results
// stay fp32. The next step's halo and weight slice load into registers while
// the current step computes. wgmma/TMA pipelining is left for a later
// change. Ragged C (C = 3 at the first conv: K = 12), A below the tile width
// and ragged image edges are all masked in the kernel; zero-weight pad slots
// use tap 0 and contribute nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// act(acc + bias), the contract of repro_torch/kernels/epilogue.py
// (gelu is the tanh approximation, as jax.nn.gelu)
__device__ __forceinline__ float epilogue(float acc, float b, int act) {
  acc += b;
  switch (act) {
    case ACT_RELU: return fmaxf(acc, 0.f);
    case ACT_SILU: return acc / (1.f + expf(-acc));
    case ACT_GELU: {
      const float c = 0.7978845608028654f;   // sqrt(2/pi)
      return 0.5f * acc * (1.f + tanhf(c * (acc + 0.044715f * acc * acc * acc)));
    }
    default: return acc;
  }
}

constexpr int CC = 8;            // input channels per K step
constexpr int TK = 4 * CC;       // packed rows per K step
constexpr int NT = 256;          // threads per block

// Where a block's output patch lies: NIMG images x TH rows x TW columns,
// tile t of the grid (column tiles fastest). Halo slot (img, hh, ww) holds
// input pixel (b0 + img, h0 - 1 + hh, w0 - 1 + ww).
struct Patch {
  int b0, h0, w0, TH, TW, HH, HW;     // HH = TH + 2, HW = TW + 2
  __device__ Patch(int t, int H, int W, int TH_, int TW_, int NIMG) {
    TH = TH_; TW = TW_; HH = TH + 2; HW = TW + 2;
    const int tw = (W + TW - 1) / TW, th = (H + TH - 1) / TH;
    w0 = (t % tw) * TW; t /= tw;
    h0 = (t % th) * TH;
    b0 = (t / th) * NIMG;
  }
  // halo slot of output pixel m of the patch, before the tap shift
  __device__ int slot(int m) const {
    const int img = m / (TH * TW), r = (m / TW) % TH, c = m % TW;
    return (img * HH + r) * HW + c;
  }
  // NHWC offset of output pixel m, or -1 outside the batch or the image
  __device__ long long out_pixel(int m, int B, int H, int W) const {
    const int img = m / (TH * TW), r = (m / TW) % TH, c = m % TW;
    const int b = b0 + img, h = h0 + r, w = w0 + c;
    if (b >= B || h >= H || w >= W) return -1;
    return ((long long)b * H + h) * W + w;
  }
};

// CC channels [c0, c0 + CC) of halo slot s as one 16-byte (bf16) or two
// 16-byte (fp32) vectors; zero outside the image and past C. VEC: C % 8 == 0.
template <typename T, bool VEC> struct Halo;
template <bool VEC> struct Halo<bf16, VEC> {
  typedef uint4 V;
  static __device__ __forceinline__ void load(
      const bf16* __restrict__ x, const Patch& p, int s, int c0, int B, int H,
      int W, int C, V* v) {
    const int img = s / (p.HH * p.HW), rem = s % (p.HH * p.HW);
    const int b = p.b0 + img, h = p.h0 - 1 + rem / p.HW, w = p.w0 - 1 + rem % p.HW;
    v[0] = make_uint4(0, 0, 0, 0);
    if (b >= B || h < 0 || h >= H || w < 0 || w >= W) return;
    const bf16* src = x + (((size_t)b * H + h) * W + w) * C + c0;
    if (VEC) {
      v[0] = *reinterpret_cast<const uint4*>(src);
    } else {
      bf16* e = reinterpret_cast<bf16*>(v);
#pragma unroll
      for (int i = 0; i < CC; ++i) e[i] = c0 + i < C ? src[i] : __float2bfloat16(0.f);
    }
  }
};
template <bool VEC> struct Halo<float, VEC> {
  typedef float4 V;
  static __device__ __forceinline__ void load(
      const float* __restrict__ x, const Patch& p, int s, int c0, int B, int H,
      int W, int C, V* v) {
    const int img = s / (p.HH * p.HW), rem = s % (p.HH * p.HW);
    const int b = p.b0 + img, h = p.h0 - 1 + rem / p.HW, w = p.w0 - 1 + rem % p.HW;
    v[0] = v[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (b >= B || h < 0 || h >= H || w < 0 || w >= W) return;
    const float* src = x + (((size_t)b * H + h) * W + w) * C + c0;
    if (VEC) {
      v[0] = *reinterpret_cast<const float4*>(src);
      v[1] = *reinterpret_cast<const float4*>(src + 4);
    } else {
      float* e = reinterpret_cast<float*>(v);
#pragma unroll
      for (int i = 0; i < CC; ++i) e[i] = c0 + i < C ? src[i] : 0.f;
    }
  }
};

// ----------------------------------------------------------------- bf16
// TMB = 128 output pixels x BN filters per block; 8 warps in a 4 x 2 grid,
// warp (wr, wc) owning pixels [32wr, +32) and filters [wc*BN/2, +BN/2) as
// 2 x BN/32 WMMA accumulators. Building the A tile, every thread keeps one
// packed row kk (channel kk / 4, tap kk % 4: one fixed shift into the halo)
// and fills it for 16 pixels.
constexpr int TMB = 128;
constexpr int SLOTS_BF16 = 9 * TMB;       // halo slots at most (1 x 1 images)

template <int BN, bool VEC>
__global__ void __launch_bounds__(NT)
pc_wmma_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
             const int* __restrict__ taps, const bf16* __restrict__ bias,
             bf16* __restrict__ out, int B, int H, int W, int C, int A,
             int TH, int TW, int NIMG, int act) {
  using namespace nvcuda;
  constexpr int WN = BN / 2, FN = WN / 16;
  constexpr int BV = TK * BN / 8;                  // 16-byte loads per slice
  constexpr int BPT = (BV + NT - 1) / NT;
  constexpr int HPT = (SLOTS_BF16 + NT - 1) / NT;
  constexpr int APT = TMB * TK / NT;
  __shared__ __align__(16) uint4 Xs[SLOTS_BF16];   // CC channels per slot
  __shared__ __align__(32) bf16 As[TMB][TK + 8];
  __shared__ __align__(32) bf16 Bs[TK][BN + 8];
  __shared__ __align__(32) float Es[8][16 * 16];   // per-warp epilogue tile
  __shared__ int Ts[TK];                           // tap of each packed row
  const Patch p(blockIdx.x, H, W, TH, TW, NIMG);
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp >> 1, wc = warp & 1;
  const int slots = NIMG * p.HH * p.HW;
  const int K = 4 * C;

  // A-tile build: this thread's packed row and its 16 pixels' halo slots
  const int my_kk = tid & 31;
  int my_slot[APT];
#pragma unroll
  for (int i = 0; i < APT; ++i) my_slot[i] = p.slot((tid >> 5) + 8 * i);

  uint4 hreg[HPT];
  uint4 breg[BPT];
  int treg = 0;
  auto load = [&](int c0) {
#pragma unroll
    for (int i = 0; i < HPT; ++i) {
      const int s = tid + NT * i;
      if (s < slots) Halo<bf16, VEC>::load(x, p, s, c0, B, H, W, C, &hreg[i]);
    }
    const int k0 = 4 * c0;
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      const int e = tid + NT * i, r = e / (BN / 8), c = (e % (BN / 8)) * 8;
      const int kr = k0 + r, col = n0 + c;
      breg[i] = make_uint4(0, 0, 0, 0);
      if (e >= BV || kr >= K) continue;
      const bf16* src = w + (size_t)kr * A + col;
      if (A % 8 == 0) {
        if (col < A) breg[i] = *reinterpret_cast<const uint4*>(src);
      } else {
        bf16* v = reinterpret_cast<bf16*>(&breg[i]);
#pragma unroll
        for (int t = 0; t < 8; ++t)
          v[t] = col + t < A ? src[t] : __float2bfloat16(0.f);
      }
    }
    if (tid < TK) treg = k0 + tid < K ? taps[k0 + tid] : -1;
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < HPT; ++i) {
      const int s = tid + NT * i;
      if (s < slots) Xs[s] = hreg[i];
    }
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      const int e = tid + NT * i, r = e / (BN / 8), c = (e % (BN / 8)) * 8;
      if (e < BV) *reinterpret_cast<uint4*>(&Bs[r][c]) = breg[i];
    }
    if (tid < TK) Ts[tid] = treg;
  };
  // picks each pixel's tap out of the halo: As[m][kk] = x at tap Ts[kk] of
  // channel kk / 4 (needs Xs and Ts stored and synced)
  auto build_a = [&]() {
    const int t = Ts[my_kk];
    const bool ok = t >= 0 && t < 9;
    const int shift = ok ? (t / 3) * p.HW + t % 3 : 0;
    const bf16* xs = reinterpret_cast<const bf16*>(Xs) + (my_kk >> 2);
#pragma unroll
    for (int i = 0; i < APT; ++i)
      As[(tid >> 5) + 8 * i][my_kk] =
          ok ? xs[(my_slot[i] + shift) * CC] : __float2bfloat16(0.f);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][FN];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int f = 0; f < FN; ++f) wmma::fill_fragment(acc[i][f], 0.f);

  load(0);
  store();
  __syncthreads();
  build_a();
  __syncthreads();
  for (int c0 = 0; c0 < C; c0 += CC) {
    const bool more = c0 + CC < C;
    if (more) load(c0 + CC);                       // in flight during MMAs
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
    __syncthreads();                               // As, Bs fully consumed
    if (more) {
      store();
      __syncthreads();
      build_a();
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
        const long long pix = p.out_pixel(wr * 32 + i * 16 + e / 16, B, H, W);
        const int col = n0 + wc * WN + f * 16 + e % 16;
        if (pix >= 0 && col < A) {
          const float b = bias ? to_f(bias[col]) : 0.f;
          out[pix * A + col] = from_f<bf16>(epilogue(es[e], b, act));
        }
      }
      __syncwarp();
    }
  }
}

// ----------------------------------------------------------------- fp32
// TMF = 64 output pixels x TNF = 64 filters per block with fp32 FMAs:
// 16x16 threads, thread (ty, tx) owns pixels 4ty..4ty+3 and filters
// tx + 16c. Building the (transposed) A tile, thread tid keeps pixel
// tid % 64 and fills packed rows tid / 64 + 4i.
constexpr int TMF = 64;
constexpr int TNF = 64;
constexpr int SLOTS_F32 = 9 * TMF;

template <bool VEC>
__global__ void __launch_bounds__(NT)
pc_simt_f32(const float* __restrict__ x, const float* __restrict__ w,
            const int* __restrict__ taps, const float* __restrict__ bias,
            float* __restrict__ out, int B, int H, int W, int C, int A,
            int TH, int TW, int NIMG, int act) {
  constexpr int HPT = (SLOTS_F32 + NT - 1) / NT;
  __shared__ __align__(16) float4 Xs[SLOTS_F32][2];  // CC channels per slot
  __shared__ float As[TK][TMF + 4];                  // transposed: As[k][m]
  __shared__ float Bs[TK][TNF];
  __shared__ int Ts[TK];
  const Patch p(blockIdx.x, H, W, TH, TW, NIMG);
  const int n0 = blockIdx.y * TNF;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int slots = NIMG * p.HH * p.HW;
  const int K = 4 * C;
  const int my_m = tid % TMF, my_slot = p.slot(my_m);

  float4 hreg[HPT][2];
  float breg[TK * TNF / NT];
  int treg = 0;
  auto load = [&](int c0) {
#pragma unroll
    for (int i = 0; i < HPT; ++i) {
      const int s = tid + NT * i;
      if (s < slots) Halo<float, VEC>::load(x, p, s, c0, B, H, W, C, hreg[i]);
    }
    const int k0 = 4 * c0;
#pragma unroll
    for (int i = 0; i < TK * TNF / NT; ++i) {
      const int e = tid + NT * i, r = e / TNF, c = e % TNF;
      const int kr = k0 + r, col = n0 + c;
      breg[i] = (kr < K && col < A) ? w[(size_t)kr * A + col] : 0.f;
    }
    if (tid < TK) treg = k0 + tid < K ? taps[k0 + tid] : -1;
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < HPT; ++i) {
      const int s = tid + NT * i;
      if (s < slots) { Xs[s][0] = hreg[i][0]; Xs[s][1] = hreg[i][1]; }
    }
#pragma unroll
    for (int i = 0; i < TK * TNF / NT; ++i) {
      const int e = tid + NT * i;
      Bs[e / TNF][e % TNF] = breg[i];
    }
    if (tid < TK) Ts[tid] = treg;
  };
  auto build_a = [&]() {
    const float* xs = reinterpret_cast<const float*>(Xs);
#pragma unroll
    for (int i = 0; i < TK / (NT / TMF); ++i) {
      const int kk = tid / TMF + (NT / TMF) * i;
      const int t = Ts[kk];
      const bool ok = t >= 0 && t < 9;
      As[kk][my_m] = ok ? xs[(my_slot + (t / 3) * p.HW + t % 3) * CC + (kk >> 2)]
                        : 0.f;
    }
  };

  float acc[4][TNF / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < TNF / 16; ++c) acc[i][c] = 0.f;

  load(0);
  store();
  __syncthreads();
  build_a();
  __syncthreads();
  for (int c0 = 0; c0 < C; c0 += CC) {
    const bool more = c0 + CC < C;
    if (more) load(c0 + CC);
#pragma unroll 4
    for (int kk = 0; kk < TK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int c = 0; c < TNF / 16; ++c) {
        const float b = Bs[kk][tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(a[i], b, acc[i][c]);
      }
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
      build_a();
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long pix = p.out_pixel(ty * 4 + i, B, H, W);
    if (pix < 0) continue;
#pragma unroll
    for (int c = 0; c < TNF / 16; ++c) {
      const int col = n0 + tx + 16 * c;
      if (col >= A) continue;
      const float b = bias ? bias[col] : 0.f;
      out[pix * A + col] = epilogue(acc[i][c], b, act);
    }
  }
}

// Patch shape for `tm` pixels: TW a power of two up to 16 covering W where
// it can, TH a power of two covering H where it can, and the rest of the
// tm pixels spread over NIMG images (small images share a block).
void patch_shape(int tm, int H, int W, int* TH, int* TW, int* NIMG) {
  int tw = 1;
  while (tw < W && tw < 16) tw <<= 1;
  int th = 1;
  while (th < H && th * tw < tm) th <<= 1;
  *TH = th; *TW = tw; *NIMG = tm / (th * tw);
}

long long patch_count(int B, int H, int W, int TH, int TW, int NIMG) {
  return (long long)((W + TW - 1) / TW) * ((H + TH - 1) / TH) *
         ((B + NIMG - 1) / NIMG);
}

}  // namespace

// bias may be null. Returns cudaGetLastError().
extern "C" int pattern_conv_launch(const void* x, const void* w_packed,
                                   const void* taps, const void* bias,
                                   void* out, int B, int H, int W, int C,
                                   int A, int is_bf16, int act, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || A <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* t = (const int*)taps;
  const bool vec = C % 8 == 0;
  int TH, TW, NIMG;
  if (is_bf16) {
    patch_shape(TMB, H, W, &TH, &TW, &NIMG);
    const long long n = patch_count(B, H, W, TH, TW, NIMG);
    if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const bf16 *xb = (const bf16*)x, *wb = (const bf16*)w_packed,
               *bb = (const bf16*)bias;
    bf16* ob = (bf16*)out;
    if (A % 128 == 0) {
      const dim3 grid((unsigned)n, A / 128);
      if (vec)
        pc_wmma_bf16<128, true><<<grid, NT, 0, s>>>(xb, wb, t, bb, ob, B, H, W,
                                                    C, A, TH, TW, NIMG, act);
      else
        pc_wmma_bf16<128, false><<<grid, NT, 0, s>>>(xb, wb, t, bb, ob, B, H,
                                                     W, C, A, TH, TW, NIMG, act);
    } else {
      const dim3 grid((unsigned)n, (A + 63) / 64);
      if (vec)
        pc_wmma_bf16<64, true><<<grid, NT, 0, s>>>(xb, wb, t, bb, ob, B, H, W,
                                                   C, A, TH, TW, NIMG, act);
      else
        pc_wmma_bf16<64, false><<<grid, NT, 0, s>>>(xb, wb, t, bb, ob, B, H, W,
                                                    C, A, TH, TW, NIMG, act);
    }
  } else {
    patch_shape(TMF, H, W, &TH, &TW, &NIMG);
    const long long n = patch_count(B, H, W, TH, TW, NIMG);
    if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)n, (A + TNF - 1) / TNF);
    if (vec)
      pc_simt_f32<true><<<grid, NT, 0, s>>>(
          (const float*)x, (const float*)w_packed, t, (const float*)bias,
          (float*)out, B, H, W, C, A, TH, TW, NIMG, act);
    else
      pc_simt_f32<false><<<grid, NT, 0, s>>>(
          (const float*)x, (const float*)w_packed, t, (const float*)bias,
          (float*)out, B, H, W, C, A, TH, TW, NIMG, act);
  }
  return (int)cudaGetLastError();
}
