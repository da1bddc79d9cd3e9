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
// What bounds it on an H100: reading x once and writing y once is the least
// traffic, and the 4C x A product is 2 * M * 4C * A FLOPs (53 GFLOP at
// VGG-16's conv1_2 at batch 32, 0.44 TFLOP over its 13 convs). At 224 x 224
// and C = A = 64 the bytes set the bound (x 205 MB in, y 205 MB out:
// 0.12 ms, against 0.054 ms of bf16 tensor-core FLOPs); the deeper layers
// are closer to the FLOP bound. The naive A load would be scattered 2-byte
// reads (K runs channel-major and each channel has its own taps), so every
// route stages a block's 2-D patch of output pixels (TH x TW of NIMG
// images) plus its one-pixel halo for a slice of channels in shared
// memory, reads each input pixel from device memory once per tile and
// channel slice (the paper's load-redundancy elimination), and picks each
// packed row's tap out of the staged halo with one fixed shift per
// (channel, tap). Three routes, chosen by the wrapper
// (pattern_conv.py:conv_variant) and named by the caller:
//
//  - wgmma (bf16, C % 16 == 0, A % 8 == 0): one producer warp keeps a ring
//    of 16-channel stages full by TMA (the halo as one 4-D box whose
//    out-of-tensor zero fill is the SAME padding, and the stage's 64 packed
//    weight rows); two consumer warpgroups of 64 pixels pick their wgmma
//    A fragments out of the halo into registers and run wgmma RS against
//    the weight rows read N-major (namespace pc90 below). One tile covers
//    up to 256 output channels, so a halo is read from device memory once
//    for A <= 256. The epilogue stages the tile and writes it with 4-D TMA
//    stores; blocks are persistent, so the next tile's loads overlap it.
//  - wmma (any other bf16 call: C = 3 at VGG-16's first conv and the
//    ResNet-18 stem, ragged C or A): 128 pixels per block, 8-channel K
//    steps staged with 16-byte loads along C into registers while the
//    previous step computes, the A tile picked into shared memory and fed
//    to WMMA tensor-core MMAs.
//  - simt (fp32): the same staging with 64 pixels per block and fp32 FMAs,
//    so fp32 results stay fp32.
//
// Ragged C and A below the tile width are masked in the kernels (or
// zero-filled by TMA), as are ragged image and batch edges; zero-weight
// pad slots use tap 0 and contribute nothing.

#include <mma.h>

#include "sm90.cuh"

namespace {

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

// ----------------------------------------------------------------- wgmma
// BM = 128 output pixels (a TH x TW x NIMG patch, planned by the wrapper:
// pattern_conv.py:conv_plan) x BN output channels per tile: two consumer
// warpgroups of 64 pixels and one producer warp. Each ring stage holds
// CK = 16 input channels: the weight rows [4 c0, 4 c0 + 64) x BN, read
// N-major by wgmma (64-column boxes, 128-byte swizzle, as the GEMM core),
// and the (TH+2) x (TW+2) x NIMG halo of the patch for those channels, as
// two 4-D TMA boxes of 8 channels over (C, W, H, B) whose start (c0 + 8h,
// w0 - 1, h0 - 1, b0) lets TMA's zero fill of everything outside the
// tensor be the SAME padding. 16-byte halo pixels (not 32) put the 8
// pixels a warp's picks start from on 8 different bank groups.
// Blocks are persistent (as many as fit the card, each walking tiles
// blockIdx.x, + gridDim.x, ...) and the ring runs on across tiles, so the
// producer loads the next tile while the consumers store this one: at
// C = 64 a tile is only four stages deep.
namespace pc90 {

using namespace sm90;

constexpr int CK = 16;             // input channels per ring stage
constexpr int HC = 8;              // channels per halo box: 16-byte pixels
constexpr int KR = 4 * CK;         // packed rows per stage: four k16 steps
constexpr int BM = 128;            // output pixels per tile
constexpr int THREADS = 2 * 128 + 32;
constexpr int MAX_SLOTS = 512;     // halo pixels per stage at most
constexpr int MAX_STAGES = 6;

struct Args {
  const bf16* bias;                // (A,) or null
  const int* taps;                 // (C, 4)
  int C, A, act;
  int TH, TW, NIMG;                // the output patch of a tile
  int tiles_w, tiles_h, n_tiles;   // patch grid; BN-wide channel tiles
  int tiles;                       // tiles in all
  int stages, box_bytes, half, stage_bytes;  // half: 2nd box's offset
};

// blocks sharing an SM: three at BN = 64 and two at BN = 128 (one block's
// epilogue and picks then overlap another's MMAs); BN = 256 has the SM to
// itself (its accumulator alone is 128 registers a thread). Each gets an
// equal share of the SM's 228 KB of shared memory, less the 1 KB the
// runtime reserves per block.
template <int BN> constexpr int blocks_per_sm() {
  return BN == 256 ? 1 : BN == 128 ? 2 : 3;
}
template <int BN> constexpr int smem_budget() {
  return 228 * 1024 / blocks_per_sm<BN>() - 1024;
}

template <int BN>
__global__ void __launch_bounds__(THREADS, blocks_per_sm<BN>())
pc_wgmma(const __grid_constant__ CUtensorMap tm_x,
         const __grid_constant__ CUtensorMap tm_w,
         const __grid_constant__ CUtensorMap tm_o, const Args a) {
  constexpr int W_BYTES = BN * KR * 2;   // BN / 64 boxes of 8 KB
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  uint8_t* epi = ring + a.stages * a.stage_bytes;      // BM x BN bf16 tile
  uint16_t* sh = reinterpret_cast<uint16_t*>(epi + BM * BN * 2);
  uint64_t* full = reinterpret_cast<uint64_t*>(sh + 4 * a.C);
  uint64_t* empty = full + a.stages;

  // tile `id` -> its channel tile (fastest: tiles in flight share a halo)
  // and its patch origin
  struct Tile { int n0, w0, h0, b0; };
  auto tile_of = [&](int id) {
    Tile t;
    t.n0 = (id % a.n_tiles) * BN;
    id /= a.n_tiles;
    t.w0 = (id % a.tiles_w) * a.TW;
    id /= a.tiles_w;
    t.h0 = (id % a.tiles_h) * a.TH;
    t.b0 = (id / a.tiles_h) * a.NIMG;
    return t;
  };
  const int tid = threadIdx.x;
  const int HW = a.TW + 2, nsteps = a.C / CK;

  // per packed row (channel row / 4, tap taps[row]): the byte offset of its
  // input from a pixel's own halo slot, one fixed shift
  for (int e = tid; e < 4 * a.C; e += THREADS) {
    const int tp = a.taps[e];
    const int c = (e >> 2) & (CK - 1);
    sh[e] = (uint16_t)((((tp / 3) * HW + tp % 3) << 4) + (c / HC) * a.half +
                       (c % HC) * 2);
  }
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);              // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {                         // producer warp
    if (tid == 256) {
      int gs = 0;                           // ring steps issued, all tiles
      for (int id = blockIdx.x; id < a.tiles; id += gridDim.x) {
        const Tile t = tile_of(id);
        for (int i = 0; i < nsteps; ++i, ++gs) {
          const int st = gs % a.stages;
          if (gs >= a.stages) mbar_wait(&empty[st], ((gs / a.stages) - 1) & 1);
          uint8_t* ws = ring + st * a.stage_bytes;
          mbar_expect_tx(&full[st], W_BYTES + 2 * a.box_bytes);
#pragma unroll
          for (int hb = 0; hb < CK / HC; ++hb)
            tma_4d(ws + W_BYTES + hb * a.half, &tm_x, &full[st],
                   i * CK + hb * HC, t.w0 - 1, t.h0 - 1, t.b0);
#pragma unroll
          for (int hb = 0; hb < BN / 64; ++hb)
            tma_2d(ws + hb * 64 * KR * 2, &tm_w, &full[st], t.n0 + 64 * hb,
                   i * KR);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg owns patch pixels [64 wg, +64); thread (warp, g,
  // q) holds pixels m and m + 8 of the fragments. A pixel past the patch
  // reads slot 0: computed, never stored.
  const int wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int m = wg * 64 + warp * 16 + g;
  auto slot = [&](int p) -> int {
    if (p >= a.NIMG * a.TH * a.TW) return 0;
    const int img = p / (a.TH * a.TW), r = (p / a.TW) % a.TH, c = p % a.TW;
    return ((img * (a.TH + 2) + r) * HW + c) << 4;
  };
  const int base0 = slot(m), base1 = slot(m + 8);
  auto release = [&](int gs) {             // ring step gs consumed
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[gs % a.stages]);
  };
  float acc[BN / 2];
  uint32_t fa[2][4];
  int gs = 0;                               // ring steps consumed, all tiles
  for (int id = blockIdx.x; id < a.tiles; id += gridDim.x) {
    const Tile tl = tile_of(id);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    // Each k16 step j of a stage: packed rows 16j + 2q + {0, 1} (channel
    // 4j + q/2, taps 2(q%2) + {0, 1}) and the same 8 rows on (channel
    // 4j + 2 + q/2) are this thread's A-fragment columns; one 32-bit load
    // brings both taps' shifts. Fragments are double-buffered per k16
    // step: the wgmma of step j reads buffer j & 1 while step j + 1 fills
    // the other.
    for (int i = 0; i < nsteps; ++i, ++gs) {
      const int st = gs % a.stages;
      mbar_wait(&full[st], (gs / a.stages) & 1);
      const uint8_t* ws = ring + st * a.stage_bytes;
      const uint8_t* halo = ws + W_BYTES;
      const uint16_t* shs = sh + i * KR;
      auto px = [&](int base, uint32_t off) -> uint32_t {
        return *reinterpret_cast<const uint16_t*>(halo + base + off);
      };
#pragma unroll
      for (int j = 0; j < KR / 16; ++j) {
        uint32_t (&f)[4] = fa[j & 1];
        const uint32_t sa =
            *reinterpret_cast<const uint32_t*>(shs + 16 * j + 2 * q);
        const uint32_t sb =
            *reinterpret_cast<const uint32_t*>(shs + 16 * j + 8 + 2 * q);
        f[0] = px(base0, sa & 0xffff) | (px(base0, sa >> 16) << 16);
        f[1] = px(base1, sa & 0xffff) | (px(base1, sa >> 16) << 16);
        f[2] = px(base0, sb & 0xffff) | (px(base0, sb >> 16) << 16);
        f[3] = px(base1, sb & 0xffff) | (px(base1, sb >> 16) << 16);
        wgmma_fence();
        wgmma_rs<BN>(acc, f, make_desc(smem_u32(ws) + j * 16 * 128,
                                       64 * KR * 2, 1024, 1));
        wgmma_commit();
        wgmma_wait<1>();                   // the previous k16 step is done
        if (j == 0 && i > 0) release(gs - 1);
      }
    }
    wgmma_wait<0>();
    fence_acc<BN>(acc);
    release(gs - 1);

    // epilogue: act(acc + bias) on the fp32 accumulator, the bf16 tile
    // staged in 64-column boxes of BM rows, 128-byte swizzled, then one 4-D
    // TMA store per box over (A, W, H, B), which clips the patch at the
    // image, batch and channel edges. The first barrier also waits for the
    // previous tile's stores to have read the staging tile.
    named_sync(1, 256);
#pragma unroll
    for (int c8 = 0; c8 < BN / 8; ++c8) {
      const int col = tl.n0 + 8 * c8 + 2 * q;
      float bv0 = 0.f, bv1 = 0.f;
      if (a.bias && col < a.A) {           // A % 8 == 0: col + 1 < A too
        bv0 = to_f(a.bias[col]);
        bv1 = to_f(a.bias[col + 1]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = m + 8 * hh;
        *reinterpret_cast<uint32_t*>(epi + (c8 >> 3) * BM * 128 + r * 128 +
                                     (((c8 & 7) ^ g) << 4) + 4 * q) =
            pack_bf16(epilogue(acc[4 * c8 + 2 * hh], bv0, a.act),
                      epilogue(acc[4 * c8 + 2 * hh + 1], bv1, a.act));
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1, 256);
    if (tid == 0) {
#pragma unroll
      for (int hb = 0; hb < BN / 64; ++hb)
        if (tl.n0 + 64 * hb < a.A)
          tma_store_4d(&tm_o, epi + hb * BM * 128, tl.n0 + 64 * hb, tl.w0,
                       tl.h0, tl.b0);
      tma_store_wait();
    }
  }
}

template <int BN>
int launch(const void* x, const void* w, const int* taps, const void* bias,
           void* o, int B, int H, int W, int C, int A, int TH, int TW,
           int NIMG, int act, cudaStream_t s) {
  Args a;
  a.bias = (const bf16*)bias; a.taps = taps;
  a.C = C; a.A = A; a.act = act;
  a.TH = TH; a.TW = TW; a.NIMG = NIMG;
  a.tiles_w = (W + TW - 1) / TW; a.tiles_h = (H + TH - 1) / TH;
  a.n_tiles = (A + BN - 1) / BN;
  const long long tiles = (long long)a.tiles_w * a.tiles_h *
                          ((B + NIMG - 1) / NIMG) * a.n_tiles;
  a.tiles = (int)tiles;
  a.box_bytes = NIMG * (TH + 2) * (TW + 2) * HC * 2;
  a.half = (a.box_bytes + 127) & ~127;
  a.stage_bytes = (BN * KR * 2 + 2 * a.half + 1023) & ~1023;
  const int fixed = 1024 + BM * BN * 2 + 8 * C + 16 * MAX_STAGES;
  a.stages = min(MAX_STAGES, (smem_budget<BN>() - fixed) / a.stage_bytes);
  const int smem = fixed + a.stages * a.stage_bytes;
  if (a.stages < 2 || tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // x (C, W, H, B) in halo boxes; w_packed (A, 4C) and out (A, W, H, B) in
  // 64-column 128-byte-swizzled boxes
  CUtensorMap tx, tw, to;
  const cuuint64_t xd[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)B};
  const cuuint64_t xs[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                            (cuuint64_t)H * W * C * 2};
  const cuuint32_t xb[4] = {HC, (cuuint32_t)TW + 2, (cuuint32_t)TH + 2,
                            (cuuint32_t)NIMG};
  const cuuint64_t wd[2] = {(cuuint64_t)A, (cuuint64_t)4 * C};
  const cuuint64_t wst[1] = {(cuuint64_t)A * 2};
  const cuuint32_t wb[2] = {64, KR};
  const cuuint64_t od[4] = {(cuuint64_t)A, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)B};
  const cuuint64_t os[3] = {(cuuint64_t)A * 2, (cuuint64_t)W * A * 2,
                            (cuuint64_t)H * W * A * 2};
  const cuuint32_t ob[4] = {64, (cuuint32_t)TW, (cuuint32_t)TH,
                            (cuuint32_t)NIMG};
  if (!make_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, xd, xs, xb,
                CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, wd, wst, wb,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&to, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, o, od, os, ob,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  auto kernel = pc_wgmma<BN>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = (int)min(tiles, (long long)per_sm * sms);
  kernel<<<grid, THREADS, smem, s>>>(tx, tw, to, a);
  return (int)cudaGetLastError();
}

}  // namespace pc90

}  // namespace

// bias may be null. `variant` is the route the caller chose (V_*;
// pattern_conv.py:conv_variant): wgmma (bf16, C % 16 == 0, A % 8 == 0,
// 16-byte aligned operands) over tiles of TH x TW x NIMG pixels (at most
// pc90::BM, and pc90::MAX_SLOTS halo pixels) and BN channels (64, 128 or
// 256; pattern_conv.py:conv_plan), wmma (any bf16 call) or simt
// (fp32); wmma and simt plan their own patches and ignore TH..BN. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the variant
// does not take.
extern "C" int pattern_conv_launch(const void* x, const void* w_packed,
                                   const void* taps, const void* bias,
                                   void* out, int B, int H, int W, int C,
                                   int A, int is_bf16, int act, int variant,
                                   int TH, int TW, int NIMG, int BN,
                                   void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || A <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* t = (const int*)taps;
  if (variant == V_WGMMA) {
    if (!is_bf16 || C % pc90::CK || A % 8 || TH < 1 || TW < 1 || NIMG < 1 ||
        TH * TW * NIMG > pc90::BM ||
        NIMG * (TH + 2) * (TW + 2) > pc90::MAX_SLOTS || NIMG > 256 ||
        TW + 2 > 256 || TH + 2 > 256)
      return (int)cudaErrorInvalidValue;
    switch (BN) {
      case 64: return pc90::launch<64>(x, w_packed, t, bias, out, B, H, W, C, A, TH, TW, NIMG, act, s);
      case 128: return pc90::launch<128>(x, w_packed, t, bias, out, B, H, W, C, A, TH, TW, NIMG, act, s);
      case 256: return pc90::launch<256>(x, w_packed, t, bias, out, B, H, W, C, A, TH, TW, NIMG, act, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (variant != (is_bf16 ? V_WMMA : V_SIMT)) return (int)cudaErrorInvalidValue;
  const bool vec = C % 8 == 0;
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
