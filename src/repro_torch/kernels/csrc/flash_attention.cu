// Flash attention forward for Hopper (sm_90a), causal and/or sliding
// window, grouped-query heads.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py:flash_attention (body _kernel).
// q (B, S, H, hd), k/v (B, S, KV, hd), out (B, S, H, hd), all row-major and
// contiguous, bf16 or fp32; scores, the online softmax (m, l, acc) and the
// output accumulator are fp32.
//
// One block per (q tile of BQ rows, head h, batch b). The block loops over
// the kv tiles of the causal/window band only, exactly the band of the TPU
// kernel, keeping each BQ x BK score tile in shared memory: device-memory
// traffic is q + k + v + out. Query head h reads KV head h / (H / KV)
// directly, so no repeated copy of k or v is ever built. The ragged S edge
// is masked in the kernel (keys past S score NEG_INF and load as zeros), so
// any S is served. Masking keeps the reference semantics: NEG_INF = -1e30
// and out = acc / max(l, 1e-30).
//
// What bounds it on an H100: at prefill lengths (S <= 512, hd = 128) the
// work per head is small and the kernel is bound by its fp32 FMA issue
// rate (both products run on the CUDA cores, not the tensor cores). Each
// thread owns one query row's quarter: 16 scores of a 64-key tile and 32 of
// the 128 output columns; the 4 threads of a row meet through warp
// shuffles for the row max and sum. Tensor-core MMAs and a wgmma/TMA
// pipeline are left for a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64, BK = 64, NT = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

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
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, float scale, int causal, int window,
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
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int KV, int hd, float scale, int causal,
              int window, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, scale, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, scale, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, scale, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// window <= 0 means no sliding window; hd must be 32, 64 or 128.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int KV, int hd, float scale,
                                      int causal, int window, int is_bf16,
                                      void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_hd<bf16>(q, k, v, out, B, S, H, KV, hd, scale, causal, window, s);
  return launch_hd<float>(q, k, v, out, B, S, H, KV, hd, scale, causal, window, s);
}
