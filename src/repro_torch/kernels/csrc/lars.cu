// LARS update for Hopper (sm_90a), two kernels, plain C entry points.
//
// Replaces the TPU kernels of repro/kernels/lars.py: _norms_kernel (body at
// lars.py:25, pl.pallas_call at :62) and _update_kernel (body at :32,
// pl.pallas_call at :80). For one weight leaf w, its gradient g and its
// momentum m (fp32, n elements, flat) they compute, in fp32,
//   ||w||, ||g||;  trust = eta*||w|| / (||g|| + wd*||w|| + eps) when both
//   norms are > 0, else exactly 1;   upd = g + wd*w
//   scaled (paper Fig. 5):   m' = mu*m + upd;            w' = w - lr*trust*m'
//   unscaled (Fig. 6):       m' = mu*m + lr*trust*upd;   w' = w - m'
// and write w' and m' over w and m (the caller holds no second copy).
//
// Design. The TPU pads the leaf to 64k-element VMEM tiles and runs its grid
// in order; here blocks run in parallel and nothing carries over between
// them, so the reduction is two-phase without atomics:
//   1. lars_norms_kernel: a fixed grid (at most kMaxNormBlocks) strides over
//      w and g with 16-byte loads, accumulates w^2 and g^2 per thread in
//      fp32, reduces per block (warp shuffles, then shared memory) and
//      writes one (sum w^2, sum g^2) pair per block.
//   2. lars_update_kernel: every block first sums the pairs in the same
//      fixed order (so every block, and every rerun, gets the bitwise same
//      trust), applies the trust rule, reads lr from device memory, then
//      runs the elementwise update with 16-byte loads and stores.
// The grid of phase 1 is a function of n alone (the caller passes it), so a
// rerun on the same inputs is bitwise equal. lr and the trust never leave
// the card: the caller does not synchronise.
//
// Bound on the H100: bytes. Phase 1 reads 8 B an element, phase 2 reads 12
// and writes 8: at ResNet-50's largest leaf (3x3x512x512, 2,359,296
// elements) 18,874,368 B = 0.0056 ms and 47,185,920 B = 0.0141 ms at
// 3.35 TB/s. A simple, correct first version: one launch pair per leaf (a
// multi-tensor launch over all leaves would hide the small leaves' launch
// latency), and each phase-2 block re-reduces the <= 264 pairs (2 KiB from
// L2) in its prologue instead of a third, one-block launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxNormBlocks = 264;     // 2 per SM of the H100's 132
constexpr int kMaxUpdateBlocks = 132 * 8;

__device__ __forceinline__ float2 warp_sum2(float2 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  return v;
}

// Sum of v over the block, in a fixed order; the result is in every thread.
__device__ __forceinline__ float2 block_sum2(float2 v) {
  __shared__ float2 part[kWarps];
  v = warp_sum2(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = lane < kWarps ? part[lane] : make_float2(0.f, 0.f);
  return warp_sum2(v);
}

__device__ __forceinline__ void sq2(float2& acc, float w, float g) {
  acc.x = fmaf(w, w, acc.x);
  acc.y = fmaf(g, g, acc.y);
}

// V = 4: every pointer 16-byte aligned, float4 loads; V = 1: scalar loads.
template <int V>
__global__ void __launch_bounds__(kThreads)
lars_norms_kernel(const float* __restrict__ w, const float* __restrict__ g,
                  float2* __restrict__ partial, long long n) {
  float2 acc = make_float2(0.f, 0.f);
  const long long nv = n / V;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < nv; i += stride) {
    if constexpr (V == 4) {
      const float4 a = reinterpret_cast<const float4*>(w)[i];
      const float4 b = reinterpret_cast<const float4*>(g)[i];
      sq2(acc, a.x, b.x);
      sq2(acc, a.y, b.y);
      sq2(acc, a.z, b.z);
      sq2(acc, a.w, b.w);
    } else {
      sq2(acc, w[i], g[i]);
    }
  }
  if (blockIdx.x == 0)  // the < V elements past the last full vector
    for (long long i = nv * V + threadIdx.x; i < n; i += kThreads)
      sq2(acc, w[i], g[i]);
  acc = block_sum2(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

template <bool kScaled>
__device__ __forceinline__ void update1(float& w, float g, float& m,
                                        float scale, float wd, float mu) {
  const float upd = fmaf(wd, w, g);
  if constexpr (kScaled) {
    m = fmaf(mu, m, upd);
    w = fmaf(-scale, m, w);
  } else {
    m = fmaf(mu, m, scale * upd);
    w = w - m;
  }
}

template <int V, bool kScaled>
__global__ void __launch_bounds__(kThreads)
lars_update_kernel(float* __restrict__ w, const float* __restrict__ g,
                   float* __restrict__ m, const float2* __restrict__ partial,
                   int n_parts, const float* __restrict__ lr,
                   float* __restrict__ trust_out, long long n, float wd,
                   float mu, float eta, float eps) {
  float2 s = make_float2(0.f, 0.f);
  for (int i = threadIdx.x; i < n_parts; i += kThreads) {
    const float2 p = partial[i];
    s.x += p.x;
    s.y += p.y;
  }
  s = block_sum2(s);
  const float wn = sqrtf(s.x), gn = sqrtf(s.y);
  const float trust =
      (wn > 0.f && gn > 0.f) ? eta * wn / (gn + wd * wn + eps) : 1.f;
  if (trust_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    *trust_out = trust;
  const float scale = *lr * trust;

  const long long nv = n / V;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < nv; i += stride) {
    if constexpr (V == 4) {
      float4 a = reinterpret_cast<const float4*>(w)[i];
      const float4 b = reinterpret_cast<const float4*>(g)[i];
      float4 c = reinterpret_cast<const float4*>(m)[i];
      update1<kScaled>(a.x, b.x, c.x, scale, wd, mu);
      update1<kScaled>(a.y, b.y, c.y, scale, wd, mu);
      update1<kScaled>(a.z, b.z, c.z, scale, wd, mu);
      update1<kScaled>(a.w, b.w, c.w, scale, wd, mu);
      reinterpret_cast<float4*>(w)[i] = a;
      reinterpret_cast<float4*>(m)[i] = c;
    } else {
      update1<kScaled>(w[i], g[i], m[i], scale, wd, mu);
    }
  }
  if (blockIdx.x == 0)
    for (long long i = nv * V + threadIdx.x; i < n; i += kThreads)
      update1<kScaled>(w[i], g[i], m[i], scale, wd, mu);
}

bool aligned16(const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) & 15) == 0;
}

}  // namespace

// w, g: n fp32 values. Writes partial[0 .. n_blocks) as (sum w^2, sum g^2)
// pairs (2 * n_blocks fp32). n_blocks in [1, 264], chosen by the caller as a
// function of n only.
extern "C" int lars_norms(const void* w, const void* g, void* partial,
                          long long n, int n_blocks, void* stream) {
  if (n <= 0 || n_blocks < 1 || n_blocks > kMaxNormBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* gf = static_cast<const float*>(g);
  float2* out = static_cast<float2*>(partial);
  if (aligned16(w, g, g))
    lars_norms_kernel<4><<<n_blocks, kThreads, 0, s>>>(wf, gf, out, n);
  else
    lars_norms_kernel<1><<<n_blocks, kThreads, 0, s>>>(wf, gf, out, n);
  return static_cast<int>(cudaGetLastError());
}

// w, m (updated in place), g: n fp32 values; partial: n_parts pairs from
// lars_norms; lr: one fp32 value on the card; trust_out: one fp32 value the
// trust is written to, or null. scaled: 1 for Fig. 5, 0 for Fig. 6.
extern "C" int lars_update(void* w, const void* g, void* m,
                           const void* partial, int n_parts, const void* lr,
                           void* trust_out, long long n, float wd, float mu,
                           float eta, float eps, int scaled, void* stream) {
  if (n <= 0 || n_parts < 1 || n_parts > kMaxNormBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned16(w, g, m);
  long long want = ((vec ? n / 4 : n) + kThreads - 1) / kThreads;
  if (want < 1) want = 1;
  const int blocks =
      static_cast<int>(want < kMaxUpdateBlocks ? want : kMaxUpdateBlocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wf = static_cast<float*>(w);
  const float* gf = static_cast<const float*>(g);
  float* mf = static_cast<float*>(m);
  const float2* pf = static_cast<const float2*>(partial);
  const float* lrf = static_cast<const float*>(lr);
  float* tf = static_cast<float*>(trust_out);
#define LARS_LAUNCH(V, S)                                                    \
  lars_update_kernel<V, S><<<blocks, kThreads, 0, s>>>(                      \
      wf, gf, mf, pf, n_parts, lrf, tf, n, wd, mu, eta, eps)
  if (vec && scaled)
    LARS_LAUNCH(4, true);
  else if (vec)
    LARS_LAUNCH(4, false);
  else if (scaled)
    LARS_LAUNCH(1, true);
  else
    LARS_LAUNCH(1, false);
#undef LARS_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
