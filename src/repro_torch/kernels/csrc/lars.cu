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
// in order over "each core's 1/N shard of the flattened parameter buffer",
// one pass over all leaves. Here blocks run in parallel and nothing carries
// over between them, so the reduction is two-phase without atomics, and each
// phase is one launch over up to kMaxLeaves leaves (every kernel leaf of a
// ResNet-50 step). Each launch's leaf table (pointers, n, the leaf's range
// in the launch's work list) travels by value as a __grid_constant__
// parameter, so nothing is copied to the card first; a fixed grid of
// persistent blocks walks the work list, and every thread keeps several
// 16-byte loads per tensor in flight (kUnroll).
//   1. lars_norms_kernel: each leaf is cut into chunks whose length is a
//      function of n alone (kernels/lars.py:norm_chunk: at least 4096
//      elements, a multiple of 1024, at most kMaxNormBlocks chunks a
//      leaf); 8 blocks an SM walk the chunk list with a fixed stride, and a
//      chunk's (sum w^2, sum g^2) pair is reduced by one block in a fixed
//      order and written to its own slot, so a leaf's pairs are bit for bit
//      the same alone or beside other leaves, and on every rerun. (A
//      producer thread feeding a ring of 1-D bulk copies to consumer warps
//      measured no faster.)
//   2. lars_update_kernel: each leaf is cut into tiles of kTile elements;
//      as many blocks as fit on the card at once each take one contiguous
//      range of the tile list, so a block crosses few leaf boundaries. On
//      its first tile of a leaf a block issues the tile's loads of w, g and
//      m, then sums the leaf's rows of the norms output in one fixed order
//      (strided per thread, then block_sum2: the trust is bitwise the same
//      in every block, in every launch the leaf is part of, and on every
//      rerun) while they are in flight, applies the trust rule and reads lr
//      from device memory; then every tile runs the elementwise update with
//      16-byte loads and stores (an unaligned leaf takes the scalar path).
//      A leaf's w' and m' are bitwise those of a one-leaf launch.
// lr and the trust never leave the card: the caller does not synchronise.
//
// Bound on the H100: bytes. Phase 1 reads 8 B an element, phase 2 reads 12
// and writes 8: over ResNet-50's 54 kernel leaves (25,502,912 elements)
// 204 MB = 0.0609 ms and 510 MB = 0.1523 ms at 3.35 TB/s; at its largest
// leaf (3x3x512x512) 18,874,368 B = 0.0056 ms and 47,185,920 B = 0.0141 ms.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxNormBlocks = 264;     // partial pairs of one leaf at most
constexpr int kMaxLeaves = 64;          // leaves a launch

// One leaf of a norms launch; kernels/lars.py:_NormLeaf packs it (32 B).
struct NormLeaf {
  const float* w;
  const float* g;
  long long n;
  int first;  // index of the leaf's first chunk within the launch
  int chunk;  // chunk length in elements, a multiple of 1024
};
struct NormTable {
  NormLeaf leaf[kMaxLeaves];
  int n_leaves;
  int n_chunks;
};
static_assert(sizeof(NormLeaf) == 32, "kernels/lars.py packs 32-byte leaves");
static_assert(sizeof(NormTable) <= 4096, "kernel parameters are at most 4 KB");

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

__device__ __forceinline__ void sq2(float2& acc, float4 a, float4 b) {
  sq2(acc, a.x, b.x);
  sq2(acc, a.y, b.y);
  sq2(acc, a.z, b.z);
  sq2(acc, a.w, b.w);
}

// Chunk c of the launch: its leaf's w and g from the chunk's start, its
// length, and whether both pointers are 16-byte aligned (the chunk start is
// a multiple of 1024 elements, so the leaf's alignment is the chunk's).
struct Chunk {
  const float* w;
  const float* g;
  int len;
  bool vec;
};

__device__ __forceinline__ Chunk chunk_of(const NormTable& t, int c) {
  int lo = 0, hi = t.n_leaves - 1;  // the last leaf whose first chunk <= c
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].first <= c) lo = mid; else hi = mid - 1;
  }
  const NormLeaf& L = t.leaf[lo];
  const long long begin = static_cast<long long>(c - L.first) * L.chunk;
  const long long left = L.n - begin;
  Chunk k;
  k.w = L.w + begin;
  k.g = L.g + begin;
  k.len = static_cast<int>(left < L.chunk ? left : L.chunk);
  k.vec = ((reinterpret_cast<uintptr_t>(L.w) |
            reinterpret_cast<uintptr_t>(L.g)) & 15) == 0;
  return k;
}

// Every thread keeps kUnroll float4 pairs of w and g in flight: a chunk of
// 4096 elements is one round of loads for the block.
constexpr int kUnroll = 4;
constexpr int kNormGrid = 132 * 8;  // persistent blocks: 8 an SM

__global__ void __launch_bounds__(kThreads)
lars_norms_kernel(const __grid_constant__ NormTable t,
                  float2* __restrict__ partial) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = blockIdx.x; c < t.n_chunks; c += gridDim.x) {
    const Chunk k = chunk_of(t, c);
    float2 acc = make_float2(0.f, 0.f);
    int done = 0;
    if (k.vec) {
      const float4* __restrict__ w4 = reinterpret_cast<const float4*>(k.w);
      const float4* __restrict__ g4 = reinterpret_cast<const float4*>(k.g);
      const int nv = k.len >> 2;
      for (int base = threadIdx.x; base < nv; base += kUnroll * kThreads) {
        float4 a[kUnroll], b[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = base + u * kThreads;
          a[u] = i < nv ? __ldg(w4 + i) : zero;
          b[u] = i < nv ? __ldg(g4 + i) : zero;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) sq2(acc, a[u], b[u]);
      }
      done = nv << 2;
    }
    for (int i = done + threadIdx.x; i < k.len; i += kThreads)
      sq2(acc, k.w[i], k.g[i]);  // an unaligned leaf, or the < 4 left over
    acc = block_sum2(acc);
    if (threadIdx.x == 0) partial[c] = acc;
    __syncthreads();  // block_sum2's slots are written again next chunk
  }
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

// One leaf of an update launch; kernels/lars.py:_UpdateLeaf packs it (48 B).
struct UpdateLeaf {
  float* w;
  const float* g;
  float* m;
  const float2* part;  // the leaf's rows of the norms output
  long long n;
  int parts;           // how many rows
  int first;           // index of the leaf's first tile within the launch
};
struct UpdateTable {
  UpdateLeaf leaf[kMaxLeaves];
  int n_leaves;
  int n_tiles;
};
static_assert(sizeof(UpdateLeaf) == 48, "kernels/lars.py packs 48-byte leaves");
// the table and the kernel's other 32 bytes of parameters
static_assert(sizeof(UpdateTable) + 32 <= 4096,
              "kernel parameters are at most 4 KB");

// Elements a tile: one round of kUnroll float4 loads of w, g and m a thread.
constexpr int kTile = kUnroll * kThreads * 4;

__device__ __forceinline__ bool aligned16(const void* a, const void* b,
                                          const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) & 15) == 0;
}

// The leaf's trust from its rows of the norms output, in every thread.
__device__ __forceinline__ float leaf_trust(const UpdateLeaf& L, float wd,
                                            float eta, float eps) {
  float2 s = make_float2(0.f, 0.f);
  for (int i = threadIdx.x; i < L.parts; i += kThreads) {
    const float2 p = L.part[i];
    s.x += p.x;
    s.y += p.y;
  }
  s = block_sum2(s);
  __syncthreads();  // block_sum2's slots are written again at the next leaf
  const float wn = sqrtf(s.x), gn = sqrtf(s.y);
  return (wn > 0.f && gn > 0.f) ? eta * wn / (gn + wd * wn + eps) : 1.f;
}

template <bool kScaled>
__device__ __forceinline__ void update4(float4& w, const float4& g, float4& m,
                                        float scale, float wd, float mu) {
  update1<kScaled>(w.x, g.x, m.x, scale, wd, mu);
  update1<kScaled>(w.y, g.y, m.y, scale, wd, mu);
  update1<kScaled>(w.z, g.z, m.z, scale, wd, mu);
  update1<kScaled>(w.w, g.w, m.w, scale, wd, mu);
}

template <bool kScaled>
__global__ void __launch_bounds__(kThreads)
lars_update_kernel(const __grid_constant__ UpdateTable t,
                   const float* __restrict__ lr,
                   float* __restrict__ trust_out, float wd, float mu,
                   float eta, float eps) {
  // this block's tiles: [lo, hi), one contiguous range of the work list
  const int lo = static_cast<int>(static_cast<long long>(blockIdx.x) *
                                  t.n_tiles / gridDim.x);
  const int hi = static_cast<int>(static_cast<long long>(blockIdx.x + 1) *
                                  t.n_tiles / gridDim.x);
  int li = 0, top = t.n_leaves - 1;  // the last leaf whose first tile <= lo
  while (li < top) {
    const int mid = (li + top + 1) >> 1;
    if (t.leaf[mid].first <= lo) li = mid; else top = mid - 1;
  }
  const float rate = *lr;
  int cur = -1;  // the leaf whose trust `scale` holds
  float scale = 0.f;
  for (int c = lo; c < hi; ++c) {
    while (li + 1 < t.n_leaves && t.leaf[li + 1].first <= c) ++li;
    const UpdateLeaf& L = t.leaf[li];
    const long long begin = static_cast<long long>(c - L.first) * kTile;
    const long long left = L.n - begin;
    const int len = static_cast<int>(left < kTile ? left : kTile);
    float* __restrict__ w = L.w + begin;
    const float* __restrict__ g = L.g + begin;
    float* __restrict__ m = L.m + begin;
    const int nv = aligned16(L.w, L.g, L.m) ? len >> 2 : 0;
    float4 a[kUnroll], b[kUnroll], d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < nv) {
        a[u] = reinterpret_cast<const float4*>(w)[i];
        b[u] = __ldg(reinterpret_cast<const float4*>(g) + i);
        d[u] = reinterpret_cast<const float4*>(m)[i];
      }
    }
    if (li != cur) {  // the block's first tile of this leaf: loads in flight
      const float trust = leaf_trust(L, wd, eta, eps);
      if (trust_out != nullptr && c == L.first && threadIdx.x == 0)
        trust_out[li] = trust;
      scale = rate * trust;
      cur = li;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < nv) {
        update4<kScaled>(a[u], b[u], d[u], scale, wd, mu);
        reinterpret_cast<float4*>(w)[i] = a[u];
        reinterpret_cast<float4*>(m)[i] = d[u];
      }
    }
    for (int i = (nv << 2) + threadIdx.x; i < len; i += kThreads)
      update1<kScaled>(w[i], g[i], m[i], scale, wd, mu);  // unaligned, or < 4
  }
}

// Blocks of lars_update_kernel<kScaled> that fit on the card at once.
template <bool kScaled>
int resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, lars_update_kernel<kScaled>, kThreads, 0) !=
            cudaSuccess)
      return 0;
    blocks = sms * per_sm;
  }
  return blocks;
}

}  // namespace

// leaves: n_leaves (1 .. kMaxLeaves) NormLeaf entries in host memory, each
// with n > 0, chunk a multiple of 1024 giving at most kMaxNormBlocks chunks,
// and first the number of chunks of the leaves before it. Writes partial[c]
// = (sum w^2, sum g^2) over chunk c, for every chunk of the launch (2 fp32
// values each).
extern "C" int lars_norms(const void* leaves, int n_leaves, void* partial,
                          void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  NormTable t = {};
  const NormLeaf* in = static_cast<const NormLeaf*>(leaves);
  int next = 0;
  for (int i = 0; i < n_leaves; ++i) {
    const NormLeaf& L = in[i];
    if (L.n <= 0 || L.chunk <= 0 || L.chunk % 1024 || L.first != next)
      return static_cast<int>(cudaErrorInvalidValue);
    const long long k = (L.n + L.chunk - 1) / L.chunk;
    if (k > kMaxNormBlocks) return static_cast<int>(cudaErrorInvalidValue);
    t.leaf[i] = L;
    next += static_cast<int>(k);
  }
  t.n_leaves = n_leaves;
  t.n_chunks = next;
  lars_norms_kernel<<<next < kNormGrid ? next : kNormGrid, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<float2*>(partial));
  return static_cast<int>(cudaGetLastError());
}

// leaves: n_leaves (1 .. kMaxLeaves) UpdateLeaf entries in host memory, each
// with w, g, m (n > 0 fp32 values; w and m updated in place), part (its
// parts rows of (sum w^2, sum g^2) from lars_norms, 1 .. kMaxNormBlocks), and
// first the number of tiles (kTile elements, the last one short) of the
// leaves before it. lr: one fp32 value on the card; trust_out: n_leaves fp32
// values the trusts are written to, or null. scaled: 1 for Fig. 5, 0 for
// Fig. 6.
extern "C" int lars_update(const void* leaves, int n_leaves, const void* lr,
                           void* trust_out, float wd, float mu, float eta,
                           float eps, int scaled, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || lr == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  UpdateTable t = {};
  const UpdateLeaf* in = static_cast<const UpdateLeaf*>(leaves);
  long long next = 0;
  for (int i = 0; i < n_leaves; ++i) {
    const UpdateLeaf& L = in[i];
    if (L.n <= 0 || L.parts < 1 || L.parts > kMaxNormBlocks ||
        L.first != next || !L.w || !L.g || !L.m || !L.part)
      return static_cast<int>(cudaErrorInvalidValue);
    t.leaf[i] = L;
    next += (L.n + kTile - 1) / kTile;
    if (next > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  t.n_leaves = n_leaves;
  t.n_tiles = static_cast<int>(next);
  const int resident = scaled ? resident_blocks<true>()
                              : resident_blocks<false>();
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = t.n_tiles < resident ? t.n_tiles : resident;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lrf = static_cast<const float*>(lr);
  float* tf = static_cast<float*>(trust_out);
  if (scaled)
    lars_update_kernel<true><<<grid, kThreads, 0, s>>>(t, lrf, tf, wd, mu,
                                                       eta, eps);
  else
    lars_update_kernel<false><<<grid, kThreads, 0, s>>>(t, lrf, tf, wd, mu,
                                                        eta, eps);
  return static_cast<int>(cudaGetLastError());
}
