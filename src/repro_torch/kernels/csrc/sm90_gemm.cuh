// Shared sm_90a GEMM core of the tiled bf16 variants of pattern_gemm.cu and
// column_gemm.cu, built from the raw-PTX primitives of sm90.cuh.
//
//   out[m0:+BM, n0:+BN] = act(A[m0:+BM, :] @ B[:, n0:+BN] + bias)   (bf16 in,
//   fp32 accumulate in registers, one cast and one store)
//
// A block is BM/64 consumer warpgroups plus one producer warp, and covers
// BM rows x BN columns. One producer thread keeps a ring of STAGES
// shared-memory stages filled by TMA (cp.async.bulk.tensor), each stage
// guarded by a `full` mbarrier (bytes landed) and an `empty` mbarrier
// (every consumer warp done with it). Each consumer warpgroup owns 64 rows
// and runs wgmma.mma_async m64nBNk16 on every 64-deep K stage, with one
// group of wgmmas left in flight while the next is fed. The epilogue stages
// the bf16 tile in shared memory and writes it with TMA stores. The ring is
// sized (~100 KB) so that two blocks share an SM: one block's prologue and
// epilogue then overlap the other's main loop, which measured faster than
// one block with a deeper ring or with 128 x 256 tiles on an H100 (PERF.md
// section 6).
//
// B is the packed weight, N-major (row-major K x N, as both packers store
// it), read by wgmma's transposed-B mode from 128-byte (64-byte for 32-wide
// panels) swizzled TMA tiles: box h of a stage holds BK rows x 64 columns.
// A comes one of two ways:
//  - dense (GATHER = false): a K-major bf16 matrix, 128-byte swizzled TMA
//    tiles read by wgmma from shared memory (column_gemm's gathered xg);
//  - fused lane gather (GATHER = true, pattern_gemm): the stage holds the
//    dense x block of the 128 columns the stage's packed rows can read when
//    the lane table is banded (a tile-pattern packer keeps `keep` of every
//    `group_q` lanes in order, so packed rows [k0, k0+64) read x columns
//    [k0 Q/Kp, (k0+64) Q/Kp)), plus the panel's 64 lane indices; each
//    consumer thread picks its wgmma A-fragment values out of
//    that block (2-byte shared loads) and feeds wgmma from registers. A lane
//    outside the staged band is read from device memory, so any lane table
//    is right.
//
// TMA zero-fills reads past the tensor (ragged M, K, P); stores mask M and
// P. The grid order only names which tile index a block's x index is:
// `mfast` (the default) runs the row tiles fastest, otherwise the column
// tiles; every output element's K sum is the same either way. With
// gridDim.z > 1 the K steps are split over blocks and each writes
// fp32 partials to `ws` (z, M, P), summed in a fixed order by the caller's
// reduce kernel: results never depend on scheduling.
#pragma once

#include "sm90.cuh"

namespace {

constexpr int SK_MMAX = 16;        // the decode variant serves M <= this

namespace sm90 {

constexpr int BK = 64;             // K rows per stage: one 128-byte bf16 row
constexpr int XW = 128;            // x columns staged per stage (GATHER)
constexpr int SMEM_BUDGET = 100 * 1024;   // two blocks fit an SM

struct Args {
  const bf16* x;     // GATHER: x (M, Q), read directly for lanes off the band
  const bf16* bias;  // (P,) or null
  bf16* out;         // (M, P)
  float* ws;         // (gridDim.z, M, P) fp32 partials when gridDim.z > 1
  int M, Q, K, P;    // K: packed rows
  int ksteps, kper;  // BK-deep K steps in all, and per K split
  int panel;         // B is (P / BN, K, BN) panels: column tile n reads panel n
  int act;
  int mfast;         // 1: blockIdx.x is the row tile; 0: the column tile
};

template <int BM, int BN, bool GATHER> struct Cfg {
  static constexpr int WG = BM / 64;                  // consumer warpgroups
  static constexpr int THREADS = 128 * WG + 32;       // + one producer warp
  static constexpr int BI = BN < 64 ? BN : 64;        // B box width
  static constexpr int A_BYTES = GATHER ? BM * XW * 2 : BM * BK * 2;
  static constexpr int STAGE = A_BYTES + BK * BN * 2; // multiple of 1024
  static constexpr int L_BYTES = GATHER ? BK * 4 : 0; // lane indices
  static constexpr int STAGES = SMEM_BUDGET / (STAGE + L_BYTES);
  static constexpr int SMEM = 1024 + STAGES * (STAGE + L_BYTES) + 16 * STAGES;
  // the epilogue stages the bf16 tile in 64-column boxes over the ring
  static constexpr bool TMA_OUT = BN % 64 == 0;
  static_assert(STAGES >= 2 && BM * BN * 2 <= STAGES * STAGE, "ring");
};

// first x column of the band that packed rows [k0, k0 + BK) read, rounded
// down to 8 columns: a TMA box must start on a 16-byte boundary
__device__ __forceinline__ int band_start(int k0, int Q, int K) {
  return (int)(((long long)k0 * Q) / K) & ~7;
}

// byte offset of x column c of the band (c taken mod XW, so any c lands
// inside the stage) in a row r with r % 8 == g, gx = g << 4: two 64-column
// boxes of BM 128-byte rows; the 128-byte swizzle XORs the 16-byte chunk
// index (bits 4-6) with r % 8
template <int BM>
__device__ __forceinline__ int band_col(int c, int gx) {
  return ((c & 64) * (2 * BM) + ((c & 63) << 1)) ^ gx;
}

template <int BM, int BN, bool GATHER>
__global__ void __launch_bounds__(Cfg<BM, BN, GATHER>::THREADS, 2)
gemm_bf16(const __grid_constant__ CUtensorMap tm_a,
          const __grid_constant__ CUtensorMap tm_b,
          const __grid_constant__ CUtensorMap tm_l,
          const __grid_constant__ CUtensorMap tm_o, const Args args) {
  using C = Cfg<BM, BN, GATHER>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* lanes = smem + C::STAGES * C::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(lanes + C::STAGES * C::L_BYTES);
  uint64_t* empty = full + C::STAGES;

  const int tid = threadIdx.x;
  const int m_tile = args.mfast ? blockIdx.x : blockIdx.y;
  const int n_tile = args.mfast ? blockIdx.y : blockIdx.x, z = blockIdx.z;
  const int m0 = m_tile * BM, n0 = n_tile * BN;
  const int s_lo = z * args.kper;
  const int nsteps = max(0, min(args.ksteps, s_lo + args.kper) - s_lo);

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C::WG);       // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * C::WG) {                  // producer warp
    if (tid == 128 * C::WG) {
      for (int i = 0; i < nsteps; ++i) {
        const int st = i % C::STAGES;
        if (i >= C::STAGES) mbar_wait(&empty[st], ((i / C::STAGES) - 1) & 1);
        uint8_t* a = smem + st * C::STAGE;
        uint8_t* b = a + C::A_BYTES;
        const int k0 = (s_lo + i) * BK;
        mbar_expect_tx(&full[st], C::STAGE + C::L_BYTES);
        if constexpr (GATHER) {
          const int c0 = band_start(k0, args.Q, args.K);
          tma_2d(a, &tm_a, &full[st], c0, m0);
          tma_2d(a + BM * 128, &tm_a, &full[st], c0 + 64, m0);
          tma_2d(lanes + st * C::L_BYTES, &tm_l, &full[st], k0, n_tile);
        } else {
          tma_2d(a, &tm_a, &full[st], k0, m0);
        }
#pragma unroll
        for (int h = 0; h < BN / C::BI; ++h)
          tma_3d(b + h * C::BI * BK * 2, &tm_b, &full[st],
                 args.panel ? h * C::BI : n0 + h * C::BI, k0,
                 args.panel ? n_tile : 0);
      }
    }
    return;
  }

  // consumer warpgroup wg owns tile rows [64 wg, +64); thread (warp, g, q)
  // holds rows `row` and `row + 8` of the wgmma fragments
  const int wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int row = wg * 64 + warp * 16 + g;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  auto b_desc = [&](int st, int j) {
    const uint32_t addr = smem_u32(smem + st * C::STAGE + C::A_BYTES) +
                          j * 16 * (C::BI * 2);
    return make_desc(addr, C::BI * BK * 2, 8 * C::BI * 2, C::BI == 64 ? 1 : 2);
  };
  auto release = [&](int i) {                // stage of step i consumed
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i % C::STAGES]);
  };

  if constexpr (GATHER) {
    // Each k16 step: this thread's 4 packed columns 2q, 2q+1, 2q+8, 2q+9 of
    // the panel's lane table -> A fragments picked from the staged x band
    // (row, row + 8), or from device memory for a lane off the band.
    // Fragments are double-buffered per k16 step: the wgmma of step j reads
    // buffer j & 1 while step j + 1 fills the other.
    const uint16_t* xg = reinterpret_cast<const uint16_t*>(args.x);
    const int gx = g << 4;
    uint32_t fa[2][4];
    for (int i = 0; i < nsteps; ++i) {
      const int st = i % C::STAGES;
      mbar_wait(&full[st], (i / C::STAGES) & 1);
      const uint8_t* r0 = smem + st * C::STAGE + row * 128;
      const int* li = reinterpret_cast<const int*>(lanes + st * C::L_BYTES);
      const int c0 = band_start((s_lo + i) * BK, args.Q, args.K);
      // band_col masks its column to the band, so a band load is always
      // inside the stage; a lane off the band (a table that is not banded,
      // zero-filled lanes past a ragged Kp) is then read from x itself
      auto band = [&](int lane_v, int h) -> uint32_t {
        return *reinterpret_cast<const uint16_t*>(
            r0 + h * 1024 + band_col<BM>(lane_v - c0, gx));
      };
      auto pick = [&](int lane_v, int h) -> uint32_t {
        if ((unsigned)(lane_v - c0) < (unsigned)XW) return band(lane_v, h);
        const int m = m0 + row + 8 * h;
        return m < args.M ? xg[(size_t)m * args.Q + lane_v] : 0u;
      };
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t (&f)[4] = fa[j & 1];
        const int2 lo = *reinterpret_cast<const int2*>(li + 16 * j + 2 * q);
        const int2 hi = *reinterpret_cast<const int2*>(li + 16 * j + 2 * q + 8);
        f[0] = band(lo.x, 0) | (band(lo.y, 0) << 16);
        f[1] = band(lo.x, 1) | (band(lo.y, 1) << 16);
        f[2] = band(hi.x, 0) | (band(hi.y, 0) << 16);
        f[3] = band(hi.x, 1) | (band(hi.y, 1) << 16);
        const bool off = (unsigned)(lo.x - c0) >= (unsigned)XW ||
                         (unsigned)(lo.y - c0) >= (unsigned)XW ||
                         (unsigned)(hi.x - c0) >= (unsigned)XW ||
                         (unsigned)(hi.y - c0) >= (unsigned)XW;
        if (__any_sync(0xffffffffu, off) && off) {
          f[0] = pick(lo.x, 0) | (pick(lo.y, 0) << 16);
          f[1] = pick(lo.x, 1) | (pick(lo.y, 1) << 16);
          f[2] = pick(hi.x, 0) | (pick(hi.y, 0) << 16);
          f[3] = pick(hi.x, 1) | (pick(hi.y, 1) << 16);
        }
        __syncwarp();                        // reconverge for .aligned
        wgmma_fence();
        wgmma_rs<BN>(acc, f, b_desc(st, j));
        wgmma_commit();
        wgmma_wait<1>();                     // the previous k16 step is done
        if (j == 0 && i > 0) release(i - 1);
      }
    }
  } else {
    for (int i = 0; i < nsteps; ++i) {
      const int st = i % C::STAGES;
      mbar_wait(&full[st], (i / C::STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const uint32_t a =
            smem_u32(smem + st * C::STAGE) + wg * 64 * 128 + j * 32;
        wgmma_ss<BN>(acc, make_desc(a, 16, 1024, 1), b_desc(st, j));
      }
      wgmma_commit();
      wgmma_wait<1>();                       // step i - 1 fully consumed
      if (i > 0) release(i - 1);
    }
  }
  wgmma_wait<0>();
  fence_acc<BN>(acc);

  // epilogue: act(acc + bias) on the fp32 accumulator
  const int P = args.P, M = args.M;
  auto value = [&](float v, int col) {
    const float b = args.bias && gridDim.z == 1 ? to_f(args.bias[col]) : 0.f;
    return epilogue(v, b, args.act);
  };
  if (gridDim.z == 1 && C::TMA_OUT) {
    // bf16 tile -> shared memory (the ring is free once every consumer
    // warpgroup is past its last wgmma) in 64 x 64 boxes, 128-byte
    // swizzled (conflict-free writes), then one TMA store per box; TMA
    // clips rows past M and columns past P.
    named_sync(3, 128 * C::WG);
    uint8_t* tile = smem + wg * (64 * BN * 2);
#pragma unroll
    for (int c8 = 0; c8 < BN / 8; ++c8) {
      const int col = min(n0 + c8 * 8 + 2 * q, P - 2);   // bias in bounds
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;      // row in this warpgroup
        *reinterpret_cast<__nv_bfloat162*>(
            tile + (c8 >> 3) * 8192 + r * 128 + (((c8 & 7) ^ g) << 4) + 4 * q) =
            __floats2bfloat162_rn(value(acc[4 * c8 + 2 * h], col),
                                  value(acc[4 * c8 + 2 * h + 1], col + 1));
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(4 + wg, 128);
    if (t == 0) {
#pragma unroll
      for (int b = 0; b < BN / 64; ++b)
        tma_store_2d(&tm_o, tile + b * 8192, n0 + b * 64, m0 + wg * 64);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
    return;
  }
  // fp32 partials of a K split, or a 32-wide panel: direct stores
#pragma unroll
  for (int c8 = 0; c8 < BN / 8; ++c8) {
    const int col = n0 + c8 * 8 + 2 * q;
    if (col >= P) continue;                  // P % 8 == 0: col + 1 < P too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + row + 8 * h;
      if (m >= M) continue;
      const int i = 4 * c8 + 2 * h;
      if (gridDim.z > 1) {
        *reinterpret_cast<float2*>(args.ws + ((size_t)z * M + m) * P + col) =
            make_float2(acc[i], acc[i + 1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(args.out + (size_t)m * P + col) =
            __floats2bfloat162_rn(value(acc[i], col), value(acc[i + 1], col + 1));
      }
    }
  }
}

// Launch gemm_bf16 over (M / BM row tiles, n_tiles, ksplit), by default
// (args.mfast) the row tile fastest so that blocks in flight share B and a
// weight larger than L2 streams from device memory once; else the column
// tile fastest, so that blocks in flight share A. tm_l is read only by
// GATHER; the output map is made here.
template <int BM, int BN, bool GATHER>
cudaError_t launch_gemm(const CUtensorMap& tm_a, const CUtensorMap& tm_b,
                        const CUtensorMap& tm_l, const Args& args,
                        int n_tiles, int ksplit, cudaStream_t s) {
  using C = Cfg<BM, BN, GATHER>;
  // out (M, P) bf16 in 64 x 64 boxes, for the TMA-store epilogue
  CUtensorMap tm_o;
  const cuuint64_t od[2] = {(cuuint64_t)args.P, (cuuint64_t)args.M};
  const cuuint64_t os[1] = {(cuuint64_t)args.P * 2};
  const cuuint32_t ob[2] = {64, 64};
  if (!make_map(&tm_o, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, args.out, od, os,
                ob, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  auto kernel = gemm_bf16<BM, BN, GATHER>;
  const int m_tiles = (args.M + BM - 1) / BM;
  if ((args.mfast ? n_tiles : m_tiles) > 65535 || ksplit > 65535)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid = args.mfast ? dim3(m_tiles, n_tiles, ksplit)
                               : dim3(n_tiles, m_tiles, ksplit);
  kernel<<<grid, C::THREADS, C::SMEM, s>>>(tm_a, tm_b, tm_l, tm_o, args);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace
