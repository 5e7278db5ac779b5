// Ragged paged attention for Hopper (sm_90a), plain C entry point.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py:_kernel
// (pl.pallas_call at paged_attention.py:186). For every batch row b and
// query head h it computes, for each of the row's C new tokens (query
// i sits at absolute position pos[b] + i), softmax(q . K^T * scale)
// over the keys j with  page_table[b, j / page] >= 0,  j < pos + n_valid,
// j <= qpos  and (window > 0)  j > qpos - window,  and sums V under those
// weights. Accumulators are fp32; the output is in q's dtype.
//
// Design. The TPU grid's sequential page axis carried m/l/acc in VMEM;
// here one block owns (row b, head h, kWarps consecutive queries), reads
// its own page-table row, pos and n_valid, and walks only the key range
// its valid queries can see, kTile keys at a time. All 128 threads stage
// a tile of K and V (16-byte loads, converted to fp32) in shared memory;
// each warp then runs the online softmax for its one query, holding q,
// m, l and a D/32-wide slice of acc in registers. Unmapped pages are
// zero-filled and masked, never read, and page ids are clipped to the
// pool. Queries past n_valid are garbage by contract (repro/kernels/
// ref.py); this kernel writes 0 for them and skips their work, so an
// engine decode row (n_valid = 1 of C) pays for one query, not C.
//
// Bound on the H100: the bytes of the occupied K/V pages, read once, at
// 3.35 TB/s; the arithmetic (4 * D flops per query-key pair) is far
// below the tensor-core rate. A simple, correct first version: no TMA,
// no wgmma, no split over pages.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // queries per block, one per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;  // keys staged in shared memory per step
constexpr float kNegInf = -1e30f;  // finite, as the reference masks

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16-byte load of consecutive pool elements, widened to fp32.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* src, float* dst) {
    float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* src,
                                              float* dst) {
    uint4 v = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q, const KVT* __restrict__ kp,
                       const KVT* __restrict__ vp,
                       const int32_t* __restrict__ page_table,
                       const int32_t* __restrict__ pos,
                       const int32_t* __restrict__ n_valid,
                       QT* __restrict__ out, int C, int H, int K, int P,
                       int page, int npg, int window, float scale) {
  constexpr int kPerLane = D / 32;
  constexpr int kVec = Vec<KVT>::N;
  constexpr int kVecPerRow = D / kVec;
  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];
  __shared__ bool mapped[kTile];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int c0 = blockIdx.x * kWarps;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c = c0 + warp;
  const int kh = h / (H / K);
  const int p0 = pos[b];
  const int nv = n_valid[b];
  const int n_real = min(C, nv);  // queries with defined output
  const bool active = c < n_real;
  QT* o = out + ((static_cast<size_t>(b) * C + c) * H + h) * D;

  if (c0 >= n_real) {  // no valid query in this block
    if (c < C) {
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) store(o + lane + 32 * i, 0.f);
    }
    return;
  }

  // Key range the block's valid queries can see.
  const int lim = p0 + nv;
  const int c_last = min(n_real, c0 + kWarps) - 1;
  const int k_hi = min(min(lim, npg * page), p0 + c_last + 1);
  const int k_lo = window > 0 ? max(0, p0 + c0 - window + 1) : 0;
  const int qpos = p0 + c;
  const int32_t* pt_row = page_table + static_cast<size_t>(b) * npg;

  float qr[kPerLane], acc[kPerLane];
  float m = kNegInf, l = 0.f;
  if (active) {
    const QT* qv = q + ((static_cast<size_t>(b) * C + c) * H + h) * D;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      qr[i] = to_float(qv[lane + 32 * i]) * scale;
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.f;

  for (int j0 = k_lo; j0 < k_hi; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x; idx < kTile * kVecPerRow; idx += kThreads) {
      const int t = idx / kVecPerRow;
      const int v = idx % kVecPerRow;
      const int j = j0 + t;
      int phys = -1;
      if (j < k_hi) phys = min(pt_row[j / page], P - 1);
      float* kd = &ks[t][v * kVec];
      float* vd = &vs[t][v * kVec];
      if (phys >= 0) {
        const size_t off =
            ((static_cast<size_t>(phys) * page + j % page) * K + kh) * D +
            v * kVec;
        Vec<KVT>::load(kp + off, kd);
        Vec<KVT>::load(vp + off, vd);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kd[e] = vd[e] = 0.f;
      }
      if (v == 0) mapped[t] = phys >= 0;
    }
    __syncthreads();
    if (!active) continue;

    float s[kTile];
    unsigned ok_bits = 0;
    float tile_max = kNegInf;
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const int j = j0 + t;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) dot += qr[i] * ks[t][lane + 32 * i];
      dot = warp_sum(dot);
      const bool ok = mapped[t] && j <= qpos &&
                      (window <= 0 || j > qpos - window);
      s[t] = dot;
      if (ok) {
        ok_bits |= 1u << t;
        tile_max = fmaxf(tile_max, dot);
      }
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[i] *= corr;
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const float p = (ok_bits >> t) & 1u ? expf(s[t] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) acc[i] += p * vs[t][lane + 32 * i];
    }
    m = m_new;
  }

  if (c < C) {
    const float inv = active ? 1.f / fmaxf(l, 1e-30f) : 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) store(o + lane + 32 * i, acc[i] * inv);
  }
}

template <typename QT, typename KVT, int D>
void launch(const void* q, const void* kp, const void* vp, const void* pt,
            const void* pos, const void* nv, void* out, int B, int C, int H,
            int K, int P, int page, int npg, int window, float scale,
            cudaStream_t stream) {
  dim3 grid((C + kWarps - 1) / kWarps, H, B);
  paged_attention_kernel<QT, KVT, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(kp),
      static_cast<const KVT*>(vp), static_cast<const int32_t*>(pt),
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(nv),
      static_cast<QT*>(out), C, H, K, P, page, npg, window, scale);
}

template <typename QT, typename KVT>
bool launch_d(int D, const void* q, const void* kp, const void* vp,
              const void* pt, const void* pos, const void* nv, void* out,
              int B, int C, int H, int K, int P, int page, int npg,
              int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      launch<QT, KVT, 64>(q, kp, vp, pt, pos, nv, out, B, C, H, K, P, page,
                          npg, window, scale, stream);
      return true;
    case 128:
      launch<QT, KVT, 128>(q, kp, vp, pt, pos, nv, out, B, C, H, K, P, page,
                           npg, window, scale, stream);
      return true;
    case 256:
      launch<QT, KVT, 256>(q, kp, vp, pt, pos, nv, out, B, C, H, K, P, page,
                           npg, window, scale, stream);
      return true;
    default:
      return false;
  }
}

}  // namespace

// q: (B, C, H, D); kp/vp: (P, page, K, D); page_table: (B, npg) int32;
// pos, n_valid: (B,) int32; out: (B, C, H, D) in q's dtype. All
// contiguous and on one device. q_bf16/kv_bf16 pick bf16 (1) or fp32
// (0) storage. window <= 0 means no window. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an unsupported D).
extern "C" int paged_attention_launch(const void* q, const void* kp,
                                      const void* vp, const void* page_table,
                                      const void* pos, const void* n_valid,
                                      void* out, int B, int C, int H, int K,
                                      int D, int P, int page, int npg,
                                      int window, float scale, int q_bf16,
                                      int kv_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok;
  if (q_bf16 && kv_bf16)
    ok = launch_d<__nv_bfloat16, __nv_bfloat16>(
        D, q, kp, vp, page_table, pos, n_valid, out, B, C, H, K, P, page, npg,
        window, scale, s);
  else if (q_bf16)
    ok = launch_d<__nv_bfloat16, float>(D, q, kp, vp, page_table, pos,
                                        n_valid, out, B, C, H, K, P, page,
                                        npg, window, scale, s);
  else if (kv_bf16)
    ok = launch_d<float, __nv_bfloat16>(D, q, kp, vp, page_table, pos,
                                        n_valid, out, B, C, H, K, P, page,
                                        npg, window, scale, s);
  else
    ok = launch_d<float, float>(D, q, kp, vp, page_table, pos, n_valid, out,
                                B, C, H, K, P, page, npg, window, scale, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
