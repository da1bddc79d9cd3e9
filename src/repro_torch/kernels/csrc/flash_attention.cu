// Flash attention forward for Hopper (sm_90a), causal and/or sliding
// window, grouped-query heads.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py:flash_attention (body _kernel).
// q (B, S, H, hd), k/v (B, S, KV, hd), out (B, S, H, hd), all row-major and
// contiguous, bf16 or fp32; scores, the online softmax (m, l, acc) and the
// output accumulator are fp32. Query head h reads KV head h / (H / KV) in
// place, so no repeated copy of k or v is ever built. Masking keeps the
// reference semantics: keys past S and outside the causal / window band
// score NEG_INF = -1e30, and out = acc / max(l, 1e-30). Both routes visit
// only the kv tiles of a q tile's causal/window band, the band of the TPU
// kernel.
//
// What bounds it on an H100: at the served shapes (B 4, H 12, KV 2,
// hd 128, S 512) a call moves 14.7 MB (q, k, v, out once: 4.4 us at
// 3.35 TB/s) and does 3.2 GFLOP of causal QK^T and PV (3.3 us at the bf16
// tensor-core peak): both products must run on the tensor cores and the
// loads must overlap them. Two routes, chosen by the wrapper
// (flash_attention.py:flash_variant) and named by the caller:
//
//  - wgmma (bf16, hd 64, 80 or 128): a block is one producer warp plus one or
//    two consumer warpgroups, each owning 64 query rows of one (b, h). The
//    producer loads the q tile once by TMA and streams the band's 64-key K
//    and V tiles through a two-stage mbarrier ring; the maps run over
//    (hd, heads, S, B), so a tile is read where it lies and TMA's zero fill
//    past S covers the ragged edge. S = Q K^T is one wgmma SS chain (Q the
//    K-major A operand, the K tile the K-major B operand: no transpose).
//    The online softmax runs on the fp32 accumulator fragments in
//    registers (row max and sum over the quad by shuffles); p is rounded
//    to bf16 in registers, where the m64n64 accumulator layout is the k16
//    A-fragment layout, and O += P V is wgmma RS with the V tile read
//    N-major (transposed-B mode), as the reference rounds p to v's dtype
//    before P.V; the sum l stays over the fp32 p, as there. Only tiles on
//    the band's edge are masked; a tile that no row of a warpgroup may
//    see is skipped. The grid runs the heaviest causal q tiles first. The
//    epilogue stages O over the q tile and writes it with TMA stores,
//    which clip rows past S.
//    hd 80 (h2o-danube-1.8b) runs the HD = 128 instance on maps whose
//    innermost dimension is the real 80 columns (a 160-byte row stride):
//    TMA zero-fills columns 80..127 of the second 64-column box of every
//    q, K and V load, so they add nothing to Q K^T or P V, and the output
//    store clips at column 80. A box partly out of bounds still delivers
//    its full byte count to the mbarrier, as at the ragged S edge. The
//    zero columns waste 3/8 of the MMA work; a 64 + 16 box layout would
//    not.
//  - simt (fp32, any route the wgmma kernel does not take; hd 16, 32, 64,
//    80 or 128, hd 16 being the reduced configs'): one block per 64-row
//    q tile keeps each 64 x 64 score tile in shared memory and does both
//    products with fp32 FMAs: each thread owns
//    one query row's quarter (16 scores, hd / 4 output columns), the 4
//    threads of a row meeting through warp shuffles. fp32 stays fp32: TF32
//    tensor cores would miss the 2e-5 tolerance.

#include "sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ------------------------------------------------------------------ simt
constexpr int BQ = 64, BK = 64, NT = 256;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int H, int KV,
          float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // BQ x (HD+1)
  float* Ks = Qs + BQ * (HD + 1);         // BK x (HD+1)
  float* Vs = Ks + BK * (HD + 1);         // BK x HD
  float* Ps = Vs + BK * HD;               // BQ x (BK+1)

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, r = tid >> 2, tx = tid & 3;
  const int qpos = q0 + r;

  for (int e = tid; e < BQ * HD; e += NT) {
    const int i = e / HD, d = e % HD, s = q0 + i;
    Qs[i * (HD + 1) + d] =
        s < S ? to_f(q[(((size_t)b * S + s) * H + h) * HD + d]) : 0.f;
  }

  float m_i = NEG_INF, l_i = 0.f;
  float acc[HD / 4];
#pragma unroll
  for (int d = 0; d < HD / 4; ++d) acc[d] = 0.f;

  // the causal/window band of kv tiles (the TPU kernel's lo/hi)
  const int n_k = (S + BK - 1) / BK;
  const int hi = causal ? min((q0 + BQ + BK - 1) / BK, n_k) : n_k;
  int lo = 0;
  if (window > 0) {
    const int t = q0 - (window - 1);
    lo = t > 0 ? t / BK : 0;
  }

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                      // previous tile fully consumed
    for (int e = tid; e < BK * HD; e += NT) {
      const int i = e / HD, d = e % HD, s = k0 + i;
      const size_t off = (((size_t)b * S + s) * KV + kvh) * HD + d;
      Ks[i * (HD + 1) + d] = s < S ? to_f(k[off]) : 0.f;
      Vs[i * HD + d] = s < S ? to_f(v[off]) : 0.f;
    }
    __syncthreads();

    float sc[BK / 4];
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const int c = tx + 4 * i, kpos = k0 + c;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d)
        dot = fmaf(Qs[r * (HD + 1) + d], Ks[c * (HD + 1) + d], dot);
      bool ok = kpos < S;
      if (causal) ok = ok && qpos >= kpos;
      if (window > 0) ok = ok && (qpos - kpos < window);
      sc[i] = ok ? dot * scale : NEG_INF;
      mx = fmaxf(mx, sc[i]);
    }
    // the 4 threads of a row are adjacent lanes of one warp
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    const float corr = expf(m_i - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const float p = expf(sc[i] - m_new);
      Ps[r * (BK + 1) + tx + 4 * i] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_i = l_i * corr + psum;
    m_i = m_new;
    __syncwarp();                         // row's p written by its own warp
#pragma unroll
    for (int d = 0; d < HD / 4; ++d) acc[d] *= corr;
    for (int c = 0; c < BK; ++c) {
      const float p = Ps[r * (BK + 1) + c];
#pragma unroll
      for (int d = 0; d < HD / 4; ++d)
        acc[d] = fmaf(p, Vs[c * HD + tx + 4 * d], acc[d]);
    }
  }

  if (qpos < S) {
    const float inv = 1.f / fmaxf(l_i, 1e-30f);
    T* orow = o + (((size_t)b * S + qpos) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < HD / 4; ++d) orow[tx + 4 * d] = from_f<T>(acc[d] * inv);
  }
}

template <typename T, int HD>
int launch_simt(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int KV, float scale, int causal, int window,
                cudaStream_t s) {
  const size_t smem = smem_bytes<HD>();
  static bool configured = false;         // one attribute call per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd<T, HD><<<grid, NT, smem, s>>>((const T*)q, (const T*)k,
                                          (const T*)v, (T*)o, S, H, KV, scale,
                                          causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int simt_hd(const void* q, const void* k, const void* v, void* o, int B,
            int S, int H, int KV, int hd, float scale, int causal, int window,
            cudaStream_t s) {
  switch (hd) {
    case 16: return launch_simt<T, 16>(q, k, v, o, B, S, H, KV, scale, causal, window, s);
    case 32: return launch_simt<T, 32>(q, k, v, o, B, S, H, KV, scale, causal, window, s);
    case 64: return launch_simt<T, 64>(q, k, v, o, B, S, H, KV, scale, causal, window, s);
    case 80: return launch_simt<T, 80>(q, k, v, o, B, S, H, KV, scale, causal, window, s);
    case 128: return launch_simt<T, 128>(q, k, v, o, B, S, H, KV, scale, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ----------------------------------------------------------------- wgmma
namespace fa90 {

using namespace sm90;

constexpr int BKV = 64;            // keys per K/V tile (one ring stage)
constexpr int STAGES = 2;

template <int HD, int WG> struct Cfg {
  static constexpr int BQ = 64 * WG;                 // query rows per block
  static constexpr int THREADS = 128 * WG + 32;      // + one producer warp
  static constexpr int Q_BYTES = BQ * HD * 2;        // HD / 64 boxes
  static constexpr int KV_BYTES = BKV * HD * 2;      // one K or V tile
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE + 8 * (2 * STAGES + 1);
};

struct Args {
  int B, S, H, KV, nq;               // nq: q tiles per (b, h)
  float scale_log2;                  // softmax scale * log2(e)
  int causal, window;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A 64-column box of 128-byte rows, 128-byte swizzled: row r's 16-byte
// chunk c sits at chunk c ^ (r % 8). K-major operands (Q, the K tile) step
// 32 bytes per k16 inside a box and a whole box per 64 columns.
template <int HD, int WG>
__global__ void __launch_bounds__(Cfg<HD, WG>::THREADS, WG == 1 ? 2 : 1)
flash_wgmma(const __grid_constant__ CUtensorMap tm_q,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v,
            const __grid_constant__ CUtensorMap tm_o, const Args a) {
  using C = Cfg<HD, WG>;
  constexpr int BQ = C::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;
  uint8_t* ring = smem + C::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  // q tiles run slowest and in reverse: the longest causal bands start first
  const int tid = threadIdx.x;
  const int bh = blockIdx.x % (a.H * a.B);
  const int qt = a.nq - 1 - (int)blockIdx.x / (a.H * a.B);
  const int h = bh % a.H, b = bh / a.H;
  const int q0 = qt * BQ, kvh = h / (a.H / a.KV);
  const int nk = (a.S + BKV - 1) / BKV;
  const int hi = a.causal ? min((q0 + BQ + BKV - 1) / BKV, nk) : nk;
  int lo = 0;
  if (a.window > 0) {
    const int t = q0 - (a.window - 1);
    lo = t > 0 ? t / BKV : 0;
  }
  const int n = max(hi - lo, 0);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WG);         // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * WG) {                    // producer warp
    if (tid == 128 * WG) {
      mbar_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < HD / 64; ++c)
        tma_4d(qs + c * BQ * 128, &tm_q, qbar, 64 * c, h, q0, b);
      for (int i = 0; i < n; ++i) {
        const int st = i % STAGES, k0 = (lo + i) * BKV;
        if (i >= STAGES) mbar_wait(&empty[st], ((i / STAGES) - 1) & 1);
        uint8_t* ks = ring + st * C::STAGE;
        uint8_t* vs = ks + C::KV_BYTES;
        mbar_expect_tx(&full[st], C::STAGE);
#pragma unroll
        for (int c = 0; c < HD / 64; ++c) {
          tma_4d(ks + c * BKV * 128, &tm_k, &full[st], 64 * c, kvh, k0, b);
          tma_4d(vs + c * BKV * 128, &tm_v, &full[st], 64 * c, kvh, k0, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg owns query rows [r0, r0 + 64); thread (warp, g,
  // q) holds rows `row` and `row + 8` of the fragments
  const int wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int r0 = q0 + wg * 64, row = r0 + warp * 16 + g;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const uint32_t qa = smem_u32(qs) + wg * 64 * 128;
  mbar_wait(qbar, 0);

  for (int i = 0; i < n; ++i) {
    const int st = i % STAGES, k0 = (lo + i) * BKV;
    mbar_wait(&full[st], (i / STAGES) & 1);
    // a tile no row of this warpgroup may see: rows past S, keys past the
    // causal diagonal or older than the window for every row
    const bool skip = r0 >= a.S || (a.causal && k0 > r0 + 63) ||
                      (a.window > 0 && k0 + BKV - 1 <= r0 - a.window);
    if (!skip) {
      const uint32_t ka = smem_u32(ring + st * C::STAGE);
      const uint32_t va = ka + C::KV_BYTES;
      float s[BKV / 2];
#pragma unroll
      for (int i2 = 0; i2 < BKV / 2; ++i2) s[i2] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < HD / 16; ++j)
        wgmma_ss_kb<BKV>(
            s, make_desc(qa + (j >> 2) * BQ * 128 + (j & 3) * 32, 16, 1024, 1),
            make_desc(ka + (j >> 2) * BKV * 128 + (j & 3) * 32, 16, 1024, 1));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc<BKV>(s);

      // scores in the log2 domain; mask only a tile on the band's edge
      const bool edge = k0 + BKV > a.S || (a.causal && k0 + BKV - 1 > r0) ||
                        (a.window > 0 && k0 <= r0 + 63 - a.window);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int c = 0; c < BKV / 8; ++c) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = s[4 * c + 2 * hh + e] * a.scale_log2;
            if (edge) {
              const int kpos = k0 + 8 * c + 2 * q + e, qpos = row + 8 * hh;
              const bool ok = kpos < a.S && (!a.causal || qpos >= kpos) &&
                              (a.window <= 0 || qpos - kpos < a.window);
              v = ok ? v : NEG_INF;
            }
            s[4 * c + 2 * hh + e] = v;
            mx[hh] = fmaxf(mx[hh], v);
          }
        }
      }
      float corr[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float mn = fmaxf(m[hh], mx[hh]);
        corr[hh] = ex2(m[hh] - mn);
        m[hh] = mn;
      }
      // p in bf16 as the k16 A fragments of P V: score columns [16j, 16j+16)
      // are accumulator groups c = 2j, 2j + 1 -> registers {0, 1}, {2, 3}
      uint32_t pf[BKV / 16][4];
#pragma unroll
      for (int c = 0; c < BKV / 8; ++c) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float p0 = ex2(s[4 * c + 2 * hh] - m[hh]);
          const float p1 = ex2(s[4 * c + 2 * hh + 1] - m[hh]);
          ps[hh] += p0 + p1;
          pf[c >> 1][(c & 1) * 2 + hh] = pack_bf16(p0, p1);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        ps[hh] += __shfl_xor_sync(0xffffffffu, ps[hh], 1);
        ps[hh] += __shfl_xor_sync(0xffffffffu, ps[hh], 2);
        l[hh] = l[hh] * corr[hh] + ps[hh];
      }
#pragma unroll
      for (int i2 = 0; i2 < HD / 2; ++i2) o[i2] *= corr[(i2 >> 1) & 1];
      __syncwarp();                         // reconverge for .aligned
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j)
        wgmma_rs<HD>(o, pf[j], make_desc(va + j * 16 * 128, BKV * 128, 1024, 1));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc<HD>(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // epilogue: O / max(l, 1e-30) in bf16 over this warpgroup's rows of the
  // q tile (only its own wgmmas read them), then TMA stores clipped at S
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) inv[hh] = 1.f / fmaxf(l[hh], 1e-30f);
  uint8_t* tile = qs + wg * 64 * 128;
#pragma unroll
  for (int c8 = 0; c8 < HD / 8; ++c8) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = warp * 16 + g + 8 * hh;
      *reinterpret_cast<uint32_t*>(tile + (c8 >> 3) * BQ * 128 + r * 128 +
                                   (((c8 & 7) ^ g) << 4) + 4 * q) =
          pack_bf16(o[4 * c8 + 2 * hh] * inv[hh],
                    o[4 * c8 + 2 * hh + 1] * inv[hh]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  named_sync(1 + wg, 128);
  if (t == 0 && r0 < a.S) {
#pragma unroll
    for (int c = 0; c < HD / 64; ++c)
      tma_store_4d(&tm_o, tile + c * BQ * 128, 64 * c, h, r0, b);
    tma_store_wait();
  }
}

// maps over (hd, heads, S, B), innermost first, in 64-column boxes; an hd
// below the instance's HD leaves the boxes' last columns out of bounds
inline bool head_map(CUtensorMap* map, const void* p, int hd, int heads,
                     int S, int B, int rows) {
  const cuuint64_t d[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S,
                           (cuuint64_t)B};
  const cuuint64_t st[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                            (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, p, d, st, box,
                  CU_TENSOR_MAP_SWIZZLE_128B);
}

// hd: the operands' real head dim, HD or (80 under HD = 128) less
template <int HD, int WG>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, int hd, float scale, int causal, int window,
           cudaStream_t s) {
  using C = Cfg<HD, WG>;
  CUtensorMap tq, tk, tv, to;
  if (!head_map(&tq, q, hd, H, S, B, C::BQ) ||
      !head_map(&tk, k, hd, KV, S, B, BKV) ||
      !head_map(&tv, v, hd, KV, S, B, BKV) ||
      !head_map(&to, o, hd, H, S, B, 64))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.B = B; a.S = S; a.H = H; a.KV = KV;
  a.nq = (S + C::BQ - 1) / C::BQ;
  a.scale_log2 = scale * 1.4426950408889634f;
  a.causal = causal; a.window = window;
  const long long blocks = (long long)a.nq * H * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = flash_wgmma<HD, WG>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, C::THREADS, C::SMEM, s>>>(tq, tk, tv, to, a);
  return (int)cudaGetLastError();
}

}  // namespace fa90

}  // namespace

// window <= 0 means no sliding window. `variant` is the route the caller
// chose (V_*; flash_attention.py:flash_variant): wgmma (bf16, hd 64, 80
// or 128, 16-byte aligned operands) with `block_q` of 64 or 128 query
// rows, or simt (bf16 or fp32, hd 16, 32, 64, 80 or 128). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the variant
// does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int KV, int hd, float scale,
                                      int causal, int window, int is_bf16,
                                      int variant, int block_q,
                                      void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == V_WGMMA) {
    if (!is_bf16 || (hd != 64 && hd != 80 && hd != 128) ||
        (block_q != 64 && block_q != 128))
      return (int)cudaErrorInvalidValue;
    if (hd == 64)
      return block_q == 64
                 ? fa90::launch<64, 1>(q, k, v, out, B, S, H, KV, hd, scale, causal, window, s)
                 : fa90::launch<64, 2>(q, k, v, out, B, S, H, KV, hd, scale, causal, window, s);
    // hd 80 on the HD = 128 instance: see the wgmma note at the top
    return block_q == 64
               ? fa90::launch<128, 1>(q, k, v, out, B, S, H, KV, hd, scale, causal, window, s)
               : fa90::launch<128, 2>(q, k, v, out, B, S, H, KV, hd, scale, causal, window, s);
  }
  if (variant != V_SIMT) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return simt_hd<bf16>(q, k, v, out, B, S, H, KV, hd, scale, causal, window, s);
  return simt_hd<float>(q, k, v, out, B, S, H, KV, hd, scale, causal, window, s);
}
