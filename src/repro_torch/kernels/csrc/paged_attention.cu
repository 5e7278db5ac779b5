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
// What bounds it. The bytes of the K/V rows some valid query can see (and
// their scales), read once, at 3.35 TB/s: a few MB at serving shapes, a
// few microseconds, so in practice latency bounds it: the launch, one
// round trip for the page table, the loads of the longest row, and the
// arithmetic (4 D flops per visible query-key pair) if it runs on CUDA
// cores one key at a time.
//
// Design: split-KV (flash-decoding). The grid is (key split, KV head, row
// b); a split is kSplit = 64 consecutive keys of the row's page table,
// whatever the page size, so the number of splits comes from the static
// shapes (npg * page) and the host never reads pos, n_valid or the table.
// A block whose split lies outside its row's visible key range exits at
// once. Otherwise it reads the split's page ids, then issues 16-byte
// cp.async copies of every K and V row that a valid query can see, all in
// flight together in two groups (Q and K, then V), gathered through the
// page table; unmapped pages and keys out of range are zero-filled and
// never read, page ids are clipped to the pool. The block holds all C x G
// query rows of its KV head (G = H / K, rows c * G + g, up to 64 at once),
// so each K/V row is staged once a call. Per 16-row tile: scores, a
// masked softmax over the split's 64 keys, and P V.
//  * bf16 q on a bf16, int8 or int4 pool: tensor cores. Scores and P V
//    are mma.sync m16n8k16 (bf16 in, fp32 accumulate) with fragments by
//    ldmatrix (.trans for V); each of 4 warps owns 16 keys of the scores
//    and D / 4 columns of P V. int8 values, and int4 nibbles after the
//    unpack of Pool<Int4Pool>, are exact in bf16, so a quantized row is
//    staged as stored at the end of its bf16 row and widened in place,
//    without its scale (shared memory stays that of a bf16 pool: two
//    blocks an SM at D 256); each fp32 score is multiplied by its key's K
//    scale and each key's V scale is folded into its probability before
//    P is rounded to bf16.
//  * fp32 q, or an fp32 pool: the same splits on CUDA cores at full fp32
//    (K and V widened, times their scales, as they are staged).
// Each split writes its rows' (m, l, unnormalised fp32 sum) to scratch;
// a second launch merges a row's splits in ascending split order by
// their log-sum-exp. A row whose visible range lies in one split is
// written by that split directly and skipped by the merge. Every sum has
// one fixed order (keys within a split in mma's or the FMA loop's order,
// splits ascending), no atomics, so reruns are bitwise equal. Queries
// past n_valid are garbage by contract (repro/kernels/ref.py); this
// kernel writes 0 for them and for a query with no visible key.
#include <type_traits>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;      // 4 warps
constexpr int kSplit = 64;         // keys a split (one block)
constexpr int kMaxRows = 64;       // query rows staged at once
constexpr int kSLd = kSplit + 4;   // fp32 score row stride
constexpr float kNegInf = -1e30f;  // finite, as the reference masks

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
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
struct Vec<bf16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const bf16* src, float* dst) {
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

// How one row (one token, one kv head) of a pool is stored: kRowElems
// stored elements a row, kVecs 16-byte chunks a row. load(row, v, s, dst)
// widens chunk v into the fp32 row dst (times the row's scale s for a
// quantized pool); to_bf16(w, v, dst) widens chunk v (the 16 bytes w) of
// a quantized row into the bf16 row dst, without the scale (exact).
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
  static __device__ __forceinline__ void to_bf16(uint4 w, int v, bf16* dst) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&w);
    uint32_t o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = sm90::pack_bf16(static_cast<float>(b[2 * e]),
                             static_cast<float>(b[2 * e + 1]));
    uint4* d = reinterpret_cast<uint4*>(dst + v * 16);
    d[0] = make_uint4(o[0], o[1], o[2], o[3]);
    d[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
};

// An int4 byte, read as int8_t and widened to int, holds dim j in its low
// nibble (((b & 0xF) ^ 8) - 8) and dim j + D/2 in its high one
// ((((b >> 4) & 0xF) ^ 8) - 8): the halves layout of repro/kernels/quant.py.
__device__ __forceinline__ int int4_lo(int x) { return ((x & 0xF) ^ 8) - 8; }
__device__ __forceinline__ int int4_hi(int x) {
  return (((x >> 4) & 0xF) ^ 8) - 8;
}

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
      dst[v * 16 + e] = static_cast<float>(int4_lo(x)) * s;
      dst[D / 2 + v * 16 + e] = static_cast<float>(int4_hi(x)) * s;
    }
  }
  static __device__ __forceinline__ void to_bf16(uint4 w, int v, bf16* dst) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&w);
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int x0 = static_cast<int>(b[2 * e]);
      const int x1 = static_cast<int>(b[2 * e + 1]);
      lo[e] = sm90::pack_bf16(static_cast<float>(int4_lo(x0)),
                              static_cast<float>(int4_lo(x1)));
      hi[e] = sm90::pack_bf16(static_cast<float>(int4_hi(x0)),
                              static_cast<float>(int4_hi(x1)));
    }
    uint4* d = reinterpret_cast<uint4*>(dst + v * 16);
    d[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    d[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    d = reinterpret_cast<uint4*>(dst + D / 2 + v * 16);
    d[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    d[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
  }
};

struct Args {
  const void *q, *kp, *vp, *ks, *vs, *pt, *pos, *nv;
  void* out;
  float* part;  // scratch: per (b, kh, split, row) the sum over D, then (m, l)
  int B, C, H, K, P, page, npg, window;
  float scale;
  cudaStream_t stream;
};

// The keys a row's valid queries can see and the splits they fall in:
// queries c < n_real, keys [k_lo, k_hi), splits s_lo..s_hi (none when
// s_hi < s_lo).
struct RowRange {
  int p0, n_real, k_lo, k_hi, s_lo, s_hi;
};

__device__ __forceinline__ RowRange row_range(const int32_t* pos,
                                              const int32_t* n_valid, int b,
                                              int C, int n_keys, int window) {
  RowRange r;
  r.p0 = pos[b];
  r.n_real = max(0, min(C, static_cast<int>(n_valid[b])));
  r.k_lo = window > 0 ? max(0, r.p0 - window + 1) : 0;
  r.k_hi = min(n_keys, r.p0 + r.n_real);
  const bool any = r.n_real > 0 && r.k_hi > r.k_lo;
  r.s_lo = any ? r.k_lo / kSplit : 0;
  r.s_hi = any ? (r.k_hi - 1) / kSplit : -1;
  return r;
}

// Row-major index of (b, kh, split s, row r) among a call's partial sums.
__device__ __forceinline__ size_t part_index(int b, int kh, int s, int r,
                                             int K, int nsplit, int rows) {
  return ((static_cast<size_t>(b) * K + kh) * nsplit + s) * rows + r;
}

// Shared state of a split block besides its K/V/Q tiles.
struct SplitShared {
  float* scores;   // [16][kSLd] fp32 scores of one row tile
  float* row_m;    // [16]
  float* row_l;    // [16]
  float* kscale;   // [kSplit] K scale of each key (quantized pools)
  float* vscale;   // [kSplit]
  int* phys;       // [kSplit] physical row of each key (page * page_size +
                   // offset), -1 if no valid query sees it or it is unmapped
};

__device__ __forceinline__ SplitShared carve(unsigned char* p) {
  SplitShared s;
  s.scores = reinterpret_cast<float*>(p);
  s.row_m = s.scores + 16 * kSLd;
  s.row_l = s.row_m + 16;
  s.kscale = s.row_l + 16;
  s.vscale = s.kscale + kSplit;
  s.phys = reinterpret_cast<int*>(s.vscale + kSplit);
  return s;
}
constexpr int kSharedBytes = 4 * (16 * kSLd + 32 + 3 * kSplit);

// Every thread: the split's page lookups into sh.phys (and the keys'
// scales), for keys [jl, jh) of row b; others -1.
template <bool kQuant>
__device__ __forceinline__ void lookup_pages(const SplitShared& sh,
                                             const int32_t* __restrict__ pt,
                                             const float* __restrict__ ks,
                                             const float* __restrict__ vs,
                                             int b, int kh, int j0, int jl,
                                             int jh, const Args& a) {
  for (int t = threadIdx.x; t < kSplit; t += kThreads) {
    const int j = j0 + t;
    int row = -1;
    if (j >= jl && j < jh) {
      const int pg = pt[static_cast<size_t>(b) * a.npg + j / a.page];
      if (pg >= 0) row = min(pg, a.P - 1) * a.page + j % a.page;
    }
    sh.phys[t] = row;
    if constexpr (kQuant) {
      const size_t r = static_cast<size_t>(row) * a.K + kh;
      sh.kscale[t] = row >= 0 ? ks[r] : 0.f;
      sh.vscale[t] = row >= 0 ? vs[r] : 0.f;
    }
  }
}

// The masked softmax of one 16-row tile over the split's keys: rows
// r_first + 0..15 (valid below R), 8 threads a row, 8 keys a thread.
// Writes P (times the key's V scale when vscale is set) as PT into
// Ps[16][ldp], and each row's max and sum into sh.row_m / sh.row_l and,
// when ml is set, into the partial (m, l) of the row.
template <typename PT>
__device__ __forceinline__ void softmax_tile(const SplitShared& sh, PT* Ps,
                                             int ldp, bool vscaled,
                                             int r_first, int R, int G,
                                             int p0, int j0, int window,
                                             float* ml) {
  const int tr = threadIdx.x / 8, part = threadIdx.x % 8;
  const int r = r_first + tr;
  const int qpos = p0 + r / G;
  float x[8];
  bool ok[8];
  float mx = kNegInf;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int key = part * 8 + e;
    const int j = j0 + key;
    ok[e] = r < R && sh.phys[key] >= 0 && j <= qpos &&
            (window <= 0 || j > qpos - window);
    x[e] = sh.scores[tr * kSLd + key];
    if (ok[e]) mx = fmaxf(mx, x[e]);
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int key = part * 8 + e;
    const float p = ok[e] ? expf(x[e] - mx) : 0.f;
    sum += p;
    store(Ps + tr * ldp + key, vscaled ? p * sh.vscale[key] : p);
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (part == 0) {
    sh.row_m[tr] = mx;
    sh.row_l[tr] = sum;
    if (ml && r < R) {
      ml[2 * static_cast<size_t>(r)] = mx;
      ml[2 * static_cast<size_t>(r) + 1] = sum;
    }
  }
}

// Output element (row r of the block, column d) pair: the final value
// (acc / l, 0 when the row sees no key) into out when the row's range
// lies in this split, else the unnormalised sums into the partial row.
template <typename QT, int D>
__device__ __forceinline__ void emit_pair(QT* __restrict__ out,
                                          float* __restrict__ part_o,
                                          bool direct, int b, int r, int kh,
                                          int G, int C, int H, int d, float v0,
                                          float v1, float l) {
  if (direct) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    QT* o = out + ((static_cast<size_t>(b) * C + r / G) * H + kh * G + r % G) *
                      D + d;
    store(o, v0 * inv);
    store(o + 1, v1 * inv);
  } else {
    *reinterpret_cast<float2*>(part_o + static_cast<size_t>(r) * D + d) =
        make_float2(v0, v1);
  }
}

// ---------------------------------------------------------------------------
// Split kernel, bf16 q on a bf16, int8 or int4 pool: mma.sync.
// ---------------------------------------------------------------------------
// Shared memory of the tensor-core split kernel: K and V tiles of kSplit
// bf16 rows (a quantized pool's stored row lands at the end of its bf16
// row and is widened in place), P, the split's state, then Q.
template <int D>
struct MmaLayout {
  static constexpr int kLd = D + 8;                   // bf16 row stride
  static constexpr int kPLd = kSplit + 8;             // P row stride
  static constexpr int kTile = kSplit * kLd * 2;      // one K or V tile
  static constexpr int kP = 16 * kPLd * 2;
  static size_t bytes(int rows_cap) {
    return 2 * kTile + kP + kSharedBytes +
           static_cast<size_t>(rows_cap) * kLd * 2;
  }
};

template <typename KVT, int D>
__global__ void __launch_bounds__(kThreads)
paged_split_mma_kernel(const bf16* __restrict__ q,
                       const typename Pool<KVT, D>::Elem* __restrict__ kp,
                       const typename Pool<KVT, D>::Elem* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int32_t* __restrict__ pt,
                       const int32_t* __restrict__ pos,
                       const int32_t* __restrict__ n_valid,
                       bf16* __restrict__ out, float* __restrict__ part,
                       Args a, int rows_cap) {
  using PoolT = Pool<KVT, D>;
  using L = MmaLayout<D>;
  constexpr bool kQuant = PoolT::kQuant;
  constexpr int kRawRow = PoolT::kRowElems * sizeof(typename PoolT::Elem);
  constexpr int kRawAt = 2 * D - kRawRow;  // stored row within its bf16 row
  constexpr int kChunks = kRawRow / 16;    // 16-byte chunks a stored row
  const int s = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.K, nsplit = gridDim.x, rows = a.C * G;
  const RowRange rr = row_range(pos, n_valid, b, a.C, a.npg * a.page, a.window);
  if (s < rr.s_lo || s > rr.s_hi) return;
  const int j0 = s * kSplit;
  const int jl = max(j0, rr.k_lo), jh = min(j0 + kSplit, rr.k_hi);
  const int R = rr.n_real * G;  // valid query rows
  const bool direct = rr.s_lo == rr.s_hi;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Kt = reinterpret_cast<bf16*>(smem);
  bf16* Vt = Kt + kSplit * L::kLd;
  bf16* Ps = Vt + kSplit * L::kLd;
  const SplitShared sh = carve(reinterpret_cast<unsigned char*>(Ps + 16 * L::kPLd));
  bf16* Qt = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(sh.phys) +
                                     4 * kSplit);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // Q rows [r0, r0 + rows_cap) of the block (row r: token r / G, head
  // kh * G + r % G), zero past R.
  auto stage_q = [&](int r0) {
    constexpr int kQChunks = D / 8;
    for (int idx = threadIdx.x; idx < rows_cap * kQChunks; idx += kThreads) {
      const int rq = idx / kQChunks, v = idx % kQChunks;
      const int r = r0 + rq;
      const bf16* src = q;
      if (r < R)
        src = q + ((static_cast<size_t>(b) * a.C + r / G) * a.H + kh * G + r % G) *
                      D + v * 8;
      sm90::cp_async16(Qt + rq * L::kLd + v * 8, src, r < R ? 16 : 0);
    }
  };
  // Chunk v of stored row key, at the end of the key's bf16 row.
  auto chunk = [&](bf16* tile, int key, int v) {
    return reinterpret_cast<unsigned char*>(tile + key * L::kLd) + kRawAt +
           16 * v;
  };
  auto stage_kv = [&](const typename PoolT::Elem* pool, bf16* tile) {
    for (int idx = threadIdx.x; idx < kSplit * kChunks; idx += kThreads) {
      const int key = idx / kChunks, v = idx % kChunks;
      const int row = sh.phys[key];
      const typename PoolT::Elem* src = pool;
      if (row >= 0)
        src = pool + (static_cast<size_t>(row) * a.K + kh) * PoolT::kRowElems +
              v * (16 / sizeof(typename PoolT::Elem));
      sm90::cp_async16(chunk(tile, key, v), src, row >= 0 ? 16 : 0);
    }
  };
  // A quantized tile widened in place: every thread reads its chunks,
  // then (after a barrier) writes their bf16 values over the row.
  auto widen = [&](bf16* tile) {
    if constexpr (kQuant) {
      constexpr int kPer = kSplit * kChunks / kThreads;
      uint4 w[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        w[i] = *reinterpret_cast<const uint4*>(
            chunk(tile, idx / kChunks, idx % kChunks));
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        PoolT::to_bf16(w[i], idx % kChunks, tile + (idx / kChunks) * L::kLd);
      }
    }
  };

  stage_q(0);
  lookup_pages<kQuant>(sh, pt, ks, vs, b, kh, j0, jl, jh, a);
  __syncthreads();
  stage_kv(kp, Kt);
  sm90::cp_async_commit();  // group: Q and K
  stage_kv(vp, Vt);
  sm90::cp_async_commit();  // group: V
  sm90::cp_async_wait<1>();
  __syncthreads();
  widen(Kt);
  __syncthreads();

  float* part_o = part + part_index(b, kh, s, 0, a.K, nsplit, rows) * D;
  float* part_ml = part + static_cast<size_t>(a.B) * a.K * nsplit * rows * D +
                   2 * part_index(b, kh, s, 0, a.K, nsplit, rows);
  constexpr int kWCols = D / 4;  // P V columns a warp
  bool v_ready = false;
  for (int r0 = 0; r0 < R; r0 += rows_cap) {
    if (r0 > 0) {
      __syncthreads();  // every warp is done with the previous Q rows
      stage_q(r0);
      sm90::cp_async_commit();
      sm90::cp_async_wait<0>();
      __syncthreads();
    }
    for (int m0 = 0; m0 < min(rows_cap, R - r0); m0 += 16) {
      // Scores of rows m0..m0+15 and keys 16 warp .. 16 warp + 15.
      // ldmatrix rows: A (Q) row lane % 8 + 8 (lane / 8 % 2), column
      // block lane / 16; B (K) key lane % 8 + 8 (lane / 16), column block
      // lane / 8 % 2.
      const uint32_t q_at = sm90::smem_u32(
          Qt + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * L::kLd +
          (lane >> 4) * 8);
      const uint32_t k_at = sm90::smem_u32(
          Kt + (16 * warp + (lane & 7) + (lane >> 4) * 8) * L::kLd +
          ((lane >> 3) & 1) * 8);
      float sc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t af[4], bf[4];
        sm90::ldmatrix_x4(af, q_at + 32 * kk);
        sm90::ldmatrix_x4(bf, k_at + 32 * kk);
        sm90::mma_bf16(sc[0], af, bf[0], bf[1]);
        sm90::mma_bf16(sc[1], af, bf[2], bf[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 16 * warp + 8 * nt + 2 * t + (e & 1);
          sh.scores[(g + (e >= 2 ? 8 : 0)) * kSLd + key] =
              sc[nt][e] * a.scale * (kQuant ? sh.kscale[key] : 1.f);
        }
      if (!v_ready) sm90::cp_async_wait<0>();
      __syncthreads();
      if (!v_ready) {
        widen(Vt);
        v_ready = true;
      }
      softmax_tile(sh, Ps, L::kPLd, kQuant, r0 + m0, R, G, rr.p0, j0,
                   a.window, direct ? nullptr : part_ml);
      __syncthreads();
      // P V over the split's 64 keys, columns kWCols * warp onward.
      // ldmatrix rows: A (P) as Q above; B (V, transposed) key
      // lane % 8 + 8 (lane / 8 % 2), column block lane / 16.
      const uint32_t p_at = sm90::smem_u32(
          Ps + ((lane & 7) + ((lane >> 3) & 1) * 8) * L::kPLd +
          (lane >> 4) * 8);
      const uint32_t v_at = sm90::smem_u32(
          Vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * L::kLd +
          kWCols * warp + (lane >> 4) * 8);
      float acc[kWCols / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < kSplit / 16; ++kk) {
        uint32_t af[4];
        sm90::ldmatrix_x4(af, p_at + 32 * kk);
#pragma unroll
        for (int np = 0; np < kWCols / 16; ++np) {
          uint32_t bf[4];
          sm90::ldmatrix_x4_trans(bf, v_at + (16 * kk * L::kLd + 16 * np) * 2);
          sm90::mma_bf16(acc[2 * np], af, bf[0], bf[1]);
          sm90::mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = r0 + m0 + g + 8 * h2;
        if (r >= R) continue;
        const float l = sh.row_l[g + 8 * h2];
#pragma unroll
        for (int nt = 0; nt < kWCols / 8; ++nt)
          emit_pair<bf16, D>(out, part_o, direct, b, r, kh, G, a.C, a.H,
                             kWCols * warp + 8 * nt + 2 * t,
                             acc[nt][2 * h2], acc[nt][2 * h2 + 1], l);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Split kernel, fp32 q or an fp32 pool: CUDA cores at full fp32.
// ---------------------------------------------------------------------------
template <int D>
struct F32Layout {
  static constexpr int kLd = D + 4;  // fp32 row stride
  static constexpr int kPLd = kSplit + 4;
  static constexpr size_t kBytes =
      4 * (2 * kSplit * kLd + 16 * kLd + 16 * kPLd) + kSharedBytes;
};

template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(kThreads)
paged_split_f32_kernel(const QT* __restrict__ q,
                       const typename Pool<KVT, D>::Elem* __restrict__ kp,
                       const typename Pool<KVT, D>::Elem* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int32_t* __restrict__ pt,
                       const int32_t* __restrict__ pos,
                       const int32_t* __restrict__ n_valid,
                       QT* __restrict__ out, float* __restrict__ part, Args a) {
  using PoolT = Pool<KVT, D>;
  using L = F32Layout<D>;
  constexpr bool kQuant = PoolT::kQuant;
  // P V: a thread owns kCpt columns (col0 + 128 i) of kRpt rows.
  constexpr int kColsPass = D < kThreads ? D : kThreads;
  constexpr int kCpt = D / kColsPass;
  constexpr int kRpt = 16 / (kThreads / kColsPass);
  const int s = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.K, nsplit = gridDim.x, rows = a.C * G;
  const RowRange rr = row_range(pos, n_valid, b, a.C, a.npg * a.page, a.window);
  if (s < rr.s_lo || s > rr.s_hi) return;
  const int j0 = s * kSplit;
  const int jl = max(j0, rr.k_lo), jh = min(j0 + kSplit, rr.k_hi);
  const int R = rr.n_real * G;
  const bool direct = rr.s_lo == rr.s_hi;

  extern __shared__ __align__(16) unsigned char smem[];
  float* Kt = reinterpret_cast<float*>(smem);
  float* Vt = Kt + kSplit * L::kLd;
  float* Qt = Vt + kSplit * L::kLd;
  float* Ps = Qt + 16 * L::kLd;
  const SplitShared sh = carve(reinterpret_cast<unsigned char*>(Ps + 16 * L::kPLd));

  lookup_pages<kQuant>(sh, pt, ks, vs, b, kh, j0, jl, jh, a);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kSplit * PoolT::kVecs; idx += kThreads) {
    const int key = idx / PoolT::kVecs, v = idx % PoolT::kVecs;
    const int row = sh.phys[key];
    float* kd = Kt + key * L::kLd;
    float* vd = Vt + key * L::kLd;
    if (row >= 0) {
      const size_t at = (static_cast<size_t>(row) * a.K + kh) * PoolT::kRowElems;
      PoolT::load(kp + at, v, kQuant ? sh.kscale[key] : 1.f, kd);
      PoolT::load(vp + at, v, kQuant ? sh.vscale[key] : 1.f, vd);
    } else {  // zeros where load v would have written
      constexpr int kPer = D / PoolT::kVecs;  // dims a chunk widens to
      for (int e = 0; e < kPer; ++e) {
        const int dim = kQuant && kPer == 32
                            ? (e < 16 ? v * 16 + e : D / 2 + v * 16 + e - 16)
                            : v * kPer + e;
        kd[dim] = 0.f;
        vd[dim] = 0.f;
      }
    }
  }

  float* part_o = part + part_index(b, kh, s, 0, a.K, nsplit, rows) * D;
  float* part_ml = part + static_cast<size_t>(a.B) * a.K * nsplit * rows * D +
                   2 * part_index(b, kh, s, 0, a.K, nsplit, rows);
  const int col0 = threadIdx.x % kColsPass;
  const int rg = (threadIdx.x / kColsPass) * kRpt;
  for (int m0 = 0; m0 < R; m0 += 16) {
    __syncthreads();  // K/V staged; the previous tile's Q, P consumed
    for (int idx = threadIdx.x; idx < 16 * D; idx += kThreads) {
      const int rq = idx / D, d = idx % D;
      const int r = m0 + rq;
      Qt[rq * L::kLd + d] =
          r < R ? to_float(q[((static_cast<size_t>(b) * a.C + r / G) * a.H +
                              kh * G + r % G) * D + d])
                : 0.f;
    }
    __syncthreads();
    {  // scores: key threadIdx % 64, rows threadIdx / 64 + 2 i
      const int key = threadIdx.x % kSplit;
      const float4* kr = reinterpret_cast<const float4*>(Kt + key * L::kLd);
      for (int i = 0; i < 8; ++i) {
        const int rq = threadIdx.x / kSplit + 2 * i;
        const float4* qr = reinterpret_cast<const float4*>(Qt + rq * L::kLd);
        float dot = 0.f;
        for (int d = 0; d < D / 4; ++d) {
          const float4 x = qr[d], y = kr[d];
          dot = fmaf(x.x, y.x, dot);
          dot = fmaf(x.y, y.y, dot);
          dot = fmaf(x.z, y.z, dot);
          dot = fmaf(x.w, y.w, dot);
        }
        sh.scores[rq * kSLd + key] = dot * a.scale;
      }
    }
    __syncthreads();
    softmax_tile(sh, Ps, L::kPLd, false, m0, R, G, rr.p0, j0, a.window,
                 direct ? nullptr : part_ml);
    __syncthreads();
    float acc[kCpt][kRpt] = {};
    for (int key = 0; key < kSplit; ++key) {
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        const float p = Ps[(rg + i) * L::kPLd + key];
#pragma unroll
        for (int c = 0; c < kCpt; ++c)
          acc[c][i] = fmaf(p, Vt[key * L::kLd + col0 + kColsPass * c], acc[c][i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      const int r = m0 + rg + i;
      if (r >= R) continue;
      const float l = sh.row_l[rg + i];
      const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
      for (int c = 0; c < kCpt; ++c) {
        const int d = col0 + kColsPass * c;
        if (direct)
          store(out + ((static_cast<size_t>(b) * a.C + r / G) * a.H + kh * G +
                       r % G) * D + d,
                acc[c][i] * inv);
        else
          part_o[static_cast<size_t>(r) * D + d] = acc[c][i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Merge: a thread per (row b, query c, head h, 4 columns) writes out: 0
// past n_valid or with no visible key; nothing where one split wrote it;
// else sum_s acc_s exp(m_s - M) / sum_s l_s exp(m_s - M), folded over the
// splits in ascending order with a running max.
// ---------------------------------------------------------------------------
template <typename QT, int D>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ part,
                     const int32_t* __restrict__ pos,
                     const int32_t* __restrict__ n_valid,
                     QT* __restrict__ out, Args a, int nsplit) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z;
  if (idx >= a.H * (D / 4)) return;
  const RowRange rr = row_range(pos, n_valid, b, a.C, a.npg * a.page, a.window);
  const bool live = c < rr.n_real && rr.s_hi >= rr.s_lo;
  if (live && rr.s_lo == rr.s_hi) return;
  const int h = idx / (D / 4), d = (idx % (D / 4)) * 4;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (live) {
    const int G = a.H / a.K, rows = a.C * G;
    const int kh = h / G, r = c * G + h % G;
    const float* ml = part + static_cast<size_t>(a.B) * a.K * nsplit * rows * D;
    float M = kNegInf, L = 0.f;
#pragma unroll 4
    for (int s = rr.s_lo; s <= rr.s_hi; ++s) {
      const size_t i = part_index(b, kh, s, r, a.K, nsplit, rows);
      const float m = ml[2 * i], l = ml[2 * i + 1];
      const float4 x = *reinterpret_cast<const float4*>(part + i * D + d);
      const float m_new = fmaxf(M, m);
      const float w_old = expf(M - m_new), w = expf(m - m_new);
      L = L * w_old + l * w;
      v[0] = v[0] * w_old + x.x * w;
      v[1] = v[1] * w_old + x.y * w;
      v[2] = v[2] * w_old + x.z * w;
      v[3] = v[3] * w_old + x.w * w;
      M = m_new;
    }
    const float inv = L > 0.f ? 1.f / L : 0.f;
    for (int e = 0; e < 4; ++e) v[e] *= inv;
  }
  QT* o = out + ((static_cast<size_t>(b) * a.C + c) * a.H + h) * D + d;
  for (int e = 0; e < 4; ++e) store(o + e, v[e]);
}

constexpr size_t kMaxSmem = 232448;  // per block on the H100

int n_splits(const Args& a) { return (a.npg * a.page + kSplit - 1) / kSplit; }

template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <typename QT, int D>
int combine(const Args& a) {
  const int blocks = (a.H * (D / 4) + kThreads - 1) / kThreads;
  paged_combine_kernel<QT, D><<<dim3(blocks, a.C, a.B), kThreads, 0,
                                 a.stream>>>(
      a.part, static_cast<const int32_t*>(a.pos),
      static_cast<const int32_t*>(a.nv), static_cast<QT*>(a.out), a,
      n_splits(a));
  return static_cast<int>(cudaGetLastError());
}

template <typename KVT, int D>
int launch_mma(const Args& a) {
  using Elem = typename Pool<KVT, D>::Elem;
  const int rows = a.C * (a.H / a.K);
  const int rows_cap = min(kMaxRows, (rows + 15) / 16 * 16);
  const size_t bytes = MmaLayout<D>::bytes(rows_cap);
  auto kernel = paged_split_mma_kernel<KVT, D>;
  if (int err = allow_smem(kernel, bytes)) return err;
  kernel<<<dim3(n_splits(a), a.K, a.B), kThreads, bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const Elem*>(a.kp),
      static_cast<const Elem*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int32_t*>(a.pt),
      static_cast<const int32_t*>(a.pos), static_cast<const int32_t*>(a.nv),
      static_cast<bf16*>(a.out), a.part, a, rows_cap);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  return combine<bf16, D>(a);
}

template <typename QT, typename KVT, int D>
int launch_f32(const Args& a) {
  using Elem = typename Pool<KVT, D>::Elem;
  constexpr size_t bytes = F32Layout<D>::kBytes;
  auto kernel = paged_split_f32_kernel<QT, KVT, D>;
  if (int err = allow_smem(kernel, bytes)) return err;
  kernel<<<dim3(n_splits(a), a.K, a.B), kThreads, bytes, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const Elem*>(a.kp),
      static_cast<const Elem*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int32_t*>(a.pt),
      static_cast<const int32_t*>(a.pos), static_cast<const int32_t*>(a.nv),
      static_cast<QT*>(a.out), a.part, a);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  return combine<QT, D>(a);
}

// bf16 q takes the tensor cores unless the pool is fp32.
template <typename KVT, int D>
int launch(int q_bf16, const Args& a) {
  if constexpr (!std::is_same<KVT, float>::value)
    if (q_bf16) return launch_mma<KVT, D>(a);
  return q_bf16 ? launch_f32<bf16, KVT, D>(a) : launch_f32<float, KVT, D>(a);
}

template <typename KVT>
int launch_d(int q_bf16, int D, const Args& a) {
  switch (D) {
    case 64: return launch<KVT, 64>(q_bf16, a);
    case 128: return launch<KVT, 128>(q_bf16, a);
    case 256: return launch<KVT, 256>(q_bf16, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The scratch the launch needs, in floats: per (b, kv head, split, row)
// D partial sums and (m, l).
long long scratch_floats(int B, int C, int H, int D, int page, int npg) {
  const long long splits = (static_cast<long long>(npg) * page + kSplit - 1) /
                           kSplit;
  return static_cast<long long>(B) * C * H * splits * (D + 2);
}

}  // namespace

// q: (B, C, H, D); kp/vp: (P, page, K, D); page_table: (B, npg) int32;
// pos, n_valid: (B,) int32; out: (B, C, H, D) in q's dtype; scratch: fp32,
// at least B * C * H * ceil(npg * page / 64) * (D + 2) of them. All contiguous
// and on one device. q_bf16/kv_bf16 pick bf16 (1) or fp32 (0) storage.
// window <= 0 means no window. Launches the split kernel and the merge on
// the stream; returns the first CUDA error (cudaErrorInvalidValue for an
// unsupported D or too little scratch).
extern "C" int paged_attention_launch(const void* q, const void* kp,
                                      const void* vp, const void* page_table,
                                      const void* pos, const void* n_valid,
                                      void* out, void* scratch,
                                      long long scratch_size, int B, int C,
                                      int H, int K, int D, int P, int page,
                                      int npg, int window, float scale,
                                      int q_bf16, int kv_bf16, void* stream) {
  if (scratch_size < scratch_floats(B, C, H, D, page, npg))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, kp, vp, nullptr, nullptr, page_table, pos, n_valid, out,
               static_cast<float*>(scratch), B, C, H, K, P, page, npg, window,
               scale, static_cast<cudaStream_t>(stream)};
  return kv_bf16 ? launch_d<bf16>(q_bf16, D, a) : launch_d<float>(q_bf16, D, a);
}

// The quantized branches. kp/vp: int8 (P, page, K, D) values, or with
// packed4 = 1 int4 nibbles (P, page, K, D / 2); kp_scale/vp_scale: fp32
// (P, page, K). The rest as paged_attention_launch.
extern "C" int paged_attention_quant_launch(
    const void* q, const void* kp, const void* vp, const void* kp_scale,
    const void* vp_scale, const void* page_table, const void* pos,
    const void* n_valid, void* out, void* scratch, long long scratch_size,
    int B, int C, int H, int K, int D, int P, int page, int npg, int window,
    float scale, int q_bf16, int packed4, void* stream) {
  if (scratch_size < scratch_floats(B, C, H, D, page, npg))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, kp, vp, kp_scale, vp_scale, page_table, pos, n_valid, out,
               static_cast<float*>(scratch), B, C, H, K, P, page, npg, window,
               scale, static_cast<cudaStream_t>(stream)};
  return packed4 ? launch_d<Int4Pool>(q_bf16, D, a)
                 : launch_d<Int8Pool>(q_bf16, D, a);
}
