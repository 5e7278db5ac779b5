// Ragged paged attention for Hopper (sm_90a), plain C entry points.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py:_kernel
// (pl.pallas_call at paged_attention.py:186), bf16/fp32 pools and the
// quantized branches (int4=True or the ks_ref/vs_ref scale operands,
// paged_attention.py:55-59, :75-82). For every batch row b and query
// head h it computes, for each of the row's C new tokens (query i sits
// at absolute position pos[b] + i), softmax(q . K^T * scale) over the
// keys j with  page_table[b, j / page] >= 0,  j < pos + n_valid,
// j <= qpos  and (window > 0)  j > qpos - window,  and sums V under those
// weights. Accumulators are fp32; the output is in q's dtype.
//
// Design. The TPU grid's sequential page axis carried m/l/acc in VMEM;
// here one block owns (row b, head h, kWarps consecutive queries), reads
// its own page-table row, pos and n_valid, and walks only the key range
// its valid queries can see, kTile keys at a time. All 128 threads stage
// a tile of K and V (16-byte loads, widened to fp32) in shared memory;
// each warp then runs the online softmax for its one query, holding q,
// m, l and a D/32-wide slice of acc in registers. Unmapped pages are
// zero-filled and masked, never read, and page ids are clipped to the
// pool. Queries past n_valid are garbage by contract (repro/kernels/
// ref.py); this kernel writes 0 for them and skips their work, so an
// engine decode row (n_valid = 1 of C) pays for one query, not C.
//
// Quantized pools (int8 values, or int4 nibbles packed over D/2 in the
// halves layout of repro/kernels/quant.py) carry fp32 scales of shape
// (P, page, K), one per (token, kv head). The staging loop dequantizes
// as it widens: (float)value * scale, for K and V alike, so the dots,
// the softmax and the accumulation stay fp32 exactly as in the bf16
// branch. An int4 byte is read as int8_t, widened to int, and split
// into dim j (((b & 0xF) ^ 8) - 8) and dim j + D/2
// ((((b >> 4) & 0xF) ^ 8) - 8).
//
// Bound on the H100: the bytes of the occupied K/V pages (and their
// scales), read once, at 3.35 TB/s; the arithmetic (4 * D flops per
// query-key pair) is far below the tensor-core rate. int8 halves and
// int4 quarters the page bytes of a bf16 pool. A simple, correct first
// version: no TMA, no wgmma, no split over pages.
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

// Quantized pool kinds (the element type of both is int8_t).
struct Int8Pool {};  // (P, page, K, D) int8 values
struct Int4Pool {};  // (P, page, K, D / 2) packed nibbles

// How one row (one token, one kv head) of a pool is stored and widened
// to fp32: kRowElems stored elements a row, kVecs 16-byte loads a row;
// load(row, v, s, dst) widens load v into the fp32 row dst (times the
// row's scale s for a quantized pool), zero(v, dst) writes 0 where load
// v would have written.
template <typename KVT, int D>
struct Pool {  // bf16 and fp32 pools
  using Elem = KVT;
  static constexpr bool kQuant = false;
  static constexpr int kRowElems = D;
  static constexpr int kN = Vec<KVT>::N;
  static constexpr int kVecs = D / kN;
  static __device__ __forceinline__ void load(const Elem* row, int v, float,
                                              float* dst) {
    Vec<KVT>::load(row + v * kN, dst + v * kN);
  }
  static __device__ __forceinline__ void zero(int v, float* dst) {
#pragma unroll
    for (int e = 0; e < kN; ++e) dst[v * kN + e] = 0.f;
  }
};

template <int D>
struct Pool<Int8Pool, D> {
  using Elem = int8_t;
  static constexpr bool kQuant = true;
  static constexpr int kRowElems = D;
  static constexpr int kVecs = D / 16;
  static __device__ __forceinline__ void load(const Elem* row, int v,
                                              float s, float* dst) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + v * 16);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 16; ++e)
      dst[v * 16 + e] = static_cast<float>(b[e]) * s;
  }
  static __device__ __forceinline__ void zero(int v, float* dst) {
#pragma unroll
    for (int e = 0; e < 16; ++e) dst[v * 16 + e] = 0.f;
  }
};

template <int D>
struct Pool<Int4Pool, D> {
  using Elem = int8_t;
  static constexpr bool kQuant = true;
  static constexpr int kRowElems = D / 2;
  static constexpr int kVecs = D / 32;  // each 16 bytes hold 32 dims
  static __device__ __forceinline__ void load(const Elem* row, int v,
                                              float s, float* dst) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + v * 16);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int x = static_cast<int>(b[e]);
      const int lo = ((x & 0xF) ^ 8) - 8;         // dim v * 16 + e
      const int hi = (((x >> 4) & 0xF) ^ 8) - 8;  // dim D / 2 + v * 16 + e
      dst[v * 16 + e] = static_cast<float>(lo) * s;
      dst[D / 2 + v * 16 + e] = static_cast<float>(hi) * s;
    }
  }
  static __device__ __forceinline__ void zero(int v, float* dst) {
#pragma unroll
    for (int e = 0; e < 16; ++e) dst[v * 16 + e] = dst[D / 2 + v * 16 + e] = 0.f;
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q,
                       const typename Pool<KVT, D>::Elem* __restrict__ kp,
                       const typename Pool<KVT, D>::Elem* __restrict__ vp,
                       const float* __restrict__ kp_scale,
                       const float* __restrict__ vp_scale,
                       const int32_t* __restrict__ page_table,
                       const int32_t* __restrict__ pos,
                       const int32_t* __restrict__ n_valid,
                       QT* __restrict__ out, int C, int H, int K, int P,
                       int page, int npg, int window, float scale) {
  using PoolT = Pool<KVT, D>;
  constexpr int kPerLane = D / 32;
  constexpr int kVecPerRow = PoolT::kVecs;
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
      if (phys >= 0) {
        const size_t r = (static_cast<size_t>(phys) * page + j % page) * K + kh;
        float sk = 1.f, sv = 1.f;
        if constexpr (PoolT::kQuant) {
          sk = kp_scale[r];
          sv = vp_scale[r];
        }
        PoolT::load(kp + r * PoolT::kRowElems, v, sk, ks[t]);
        PoolT::load(vp + r * PoolT::kRowElems, v, sv, vs[t]);
      } else {
        PoolT::zero(v, ks[t]);
        PoolT::zero(v, vs[t]);
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

struct Args {
  const void *q, *kp, *vp, *ks, *vs, *pt, *pos, *nv;
  void* out;
  int B, C, H, K, P, page, npg, window;
  float scale;
  cudaStream_t stream;
};

template <typename QT, typename KVT, int D>
void launch(const Args& a) {
  using Elem = typename Pool<KVT, D>::Elem;
  dim3 grid((a.C + kWarps - 1) / kWarps, a.H, a.B);
  paged_attention_kernel<QT, KVT, D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const Elem*>(a.kp),
      static_cast<const Elem*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int32_t*>(a.pt),
      static_cast<const int32_t*>(a.pos), static_cast<const int32_t*>(a.nv),
      static_cast<QT*>(a.out), a.C, a.H, a.K, a.P, a.page, a.npg, a.window,
      a.scale);
}

template <typename QT, typename KVT>
bool launch_d(int D, const Args& a) {
  switch (D) {
    case 64:
      launch<QT, KVT, 64>(a);
      return true;
    case 128:
      launch<QT, KVT, 128>(a);
      return true;
    case 256:
      launch<QT, KVT, 256>(a);
      return true;
    default:
      return false;
  }
}

template <typename KVT>
bool launch_q(int q_bf16, int D, const Args& a) {
  return q_bf16 ? launch_d<__nv_bfloat16, KVT>(D, a)
                : launch_d<float, KVT>(D, a);
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
  const Args a{q, kp, vp, nullptr, nullptr, page_table, pos, n_valid, out,
               B, C, H, K, P, page, npg, window, scale,
               static_cast<cudaStream_t>(stream)};
  const bool ok = kv_bf16 ? launch_q<__nv_bfloat16>(q_bf16, D, a)
                          : launch_q<float>(q_bf16, D, a);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The quantized branches. kp/vp: int8 (P, page, K, D) values, or with
// packed4 = 1 int4 nibbles (P, page, K, D / 2); kp_scale/vp_scale: fp32
// (P, page, K). The rest as paged_attention_launch.
extern "C" int paged_attention_quant_launch(
    const void* q, const void* kp, const void* vp, const void* kp_scale,
    const void* vp_scale, const void* page_table, const void* pos,
    const void* n_valid, void* out, int B, int C, int H, int K, int D, int P,
    int page, int npg, int window, float scale, int q_bf16, int packed4,
    void* stream) {
  const Args a{q, kp, vp, kp_scale, vp_scale, page_table, pos, n_valid, out,
               B, C, H, K, P, page, npg, window, scale,
               static_cast<cudaStream_t>(stream)};
  const bool ok = packed4 ? launch_q<Int4Pool>(q_bf16, D, a)
                       : launch_q<Int8Pool>(q_bf16, D, a);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
