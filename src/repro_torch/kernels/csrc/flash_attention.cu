// Flash attention for Hopper (sm_90a), forward and backward, plain C
// entry points.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (pl.pallas_call at flash_attention.py:102, body _kernel at :26). For each
// (batch b, head h, query i) it computes softmax(q . K^T * scale) over the
// keys j with  j < Sk,  k_offset + j >= 0,  (causal) k_offset + j <=
// q_offset + i  and  (window > 0) k_offset + j > q_offset + i - window,
// and sums V under those weights. GQA: head h reads KV head h / (H / K).
// m, l and the accumulator are fp32; the output is in q's dtype. The
// forward also writes the log-sum-exp m + log(l) per (b, h, i) in fp32,
// from which the backward recomputes P (FlashAttention-2):
//   delta = rowsum(dO o O);  dV = P^T dO;  dP = dO V^T;
//   dS = P o (dP - delta);   dK = scale * dS^T Q;  dQ = scale * dS K.
// The reference has no backward kernel: its gradient is jax.grad of the
// jnp path repro/kernels/ops.py:_chunked_attention.
//
// Four kernels: forward; delta; dK/dV (one block per (b, KV head, key
// tile), looping over the G query heads of that KV head and the query
// tiles its band reaches, so GQA needs no atomics); dQ (one block per
// (b, h, query tile), looping over key tiles). Each output element is
// summed by one thread, over the tiles in ascending order and within a
// tile in wgmma's (or the FMA loop's) fixed order, so results are bitwise
// repeatable.
//
// Design. The TPU grid's sequential KV axis carried m/l/acc in VMEM;
// here a block owns a query tile of one (b, h) and loops inside itself
// over only the key tiles its causal/window band reaches (the block skip
// of ops._chunked_attention). Scores are scaled in fp32 (not a
// bf16-rounded q), masked with a finite -1e30 and exponentiated only
// where visible; P and dS are rounded to bf16 for the second product
// (about 4e-3 relative). A row with no visible key is written as 0, with
// an LSE of +1e30 that makes its gradients 0 (such rows are garbage by
// contract).
//
// The bf16 forward is warp-specialised for Hopper. A block of three
// warpgroups owns 128 query rows. The producer warpgroup gives up its
// registers (setmaxnreg 24) and one of its threads issues TMA loads: Q
// once, then 64-key tiles of K and V into a ring of stages (2 at D 256,
// 4 below), each signalled by a "full" mbarrier and released by an
// "empty" one. The two consumer warpgroups (setmaxnreg 240) own 64 rows
// each and per key tile run S = Q K^T as wgmma m64n64k16 with both
// operands K-major in shared memory, the online softmax on the wgmma
// accumulator in registers (row max and sum over the 4 lanes of a quad,
// exp2 of log2e-scaled scores), and O += P V as wgmma with P taken from
// the S registers rounded to bf16 (its layout is wgmma's A-register
// layout) and V read MN-major (transposed) from shared memory, in 64-wide
// column blocks of O. No score tile touches shared memory and the
// warpgroups never meet at a block-wide barrier. Every tile arrives in
// the 128-byte swizzle, as D / 64 boxes of 64 columns (128 bytes), from
// 4-D tensor maps over (D, heads, S, B), so a tile past Sq or Sk is
// zero-filled within its own batch. Only tiles that cross the causal
// diagonal, the window edge, a negative key position or Sk are masked;
// a warpgroup skips tiles its 64 rows cannot see. Query tiles run
// longest first (grid y reversed, heads and batch on x), so the causal
// tail does not leave SMs idle. At D 256: Q 64 KB plus 2 stages of K and
// V (128 KB) in shared memory, O's 64 x 256 fp32 accumulator 128
// registers a consumer thread.
//
// The bf16 backward has the same skeleton (a TMA producer warpgroup,
// wgmma consumers, the same tensor maps, masks only on edge tiles). What
// bounds it is the tensor cores (five products, 10 D flops per visible
// pair and head) and, at D 256, the registers: the dK and dV sums of a
// 64-key tile take 2 x 128 fp32 registers a thread across one warpgroup.
//  * dK/dV: a block owns 64 keys of one KV head; K and V stay in shared
//    memory (one TMA load), and the producer streams (Q, dO) tiles of 64
//    query rows through a ring (2 stages at D 256, 4 below), so each
//    64-key tile reads the band's Q and dO once per query head. Two
//    consumer warpgroups (setmaxnreg 240) split the work by output: the
//    first computes S^T = K Q^T, forms P^T = exp(S^T scale - lse) on its
//    accumulator and owns dV += P^T dO (P^T from registers, dO read
//    MN-major); the second computes dP^T = V dO^T and owns dK += dS^T Q
//    with dS^T = P^T o (dP^T - delta). The first hands P^T over in fp32
//    through a 16 KB shared tile, thread to thread in the accumulator
//    layout (conflict-free), behind two named barriers: it arrives at
//    "full" after writing, the second syncs there, reads, and arrives at
//    "free", where the first syncs before its next write. So the first
//    never waits for the second except to reuse the tile. Each consumer
//    holds one 64 x D accumulator (128 registers at D 256) and one 64 x
//    64 score tile (32).
//  * dQ: a block owns 64 query rows of one head; Q and dO stay resident,
//    a ring of 64-key K/V tiles (2 stages at D 256, 4 below) streams the
//    band, and one consumer warpgroup runs S = Q K^T and dP = dO V^T
//    (both K-major), dS = P o (dP - delta) in registers, and dQ += dS K
//    with dS as wgmma's A registers and K read MN-major. It recomputes two
//    products (7 in all, not 5) so that no sum needs atomics.
//  Both: the products that accumulate into dK, dV or dQ are one wgmma of
//  N = D per k-step (m64n256k16 at D 256), and the exp / dS arithmetic
//  runs as straight-line loops, masked only on an edge tile, since one
//  consumer warp per SM sub-partition has no other warp to hide its
//  latency behind. Each 64 x 64 step also streams a 64 KB tile pair
//  (Q, dO or K, V) from L2, and its S / dP products read both operands
//  from shared memory.
//
// The fp32 forward and backward kernels stage tiles in padded shared
// memory and run CUDA-core FMAs at full fp32 on 8 warps.
//
// Bound on the H100 at the train shape (B 4, S 2048, 16 heads of 256,
// causal, bf16): operations, 4 * B * H * D * S(S+1)/2 flops forward
// (1.37e11, 0.139 ms at 989 TFLOP/s) against 268 MB moved (0.080 ms at
// 3.35 TB/s); the backward does 2.5 times the forward's flops.
#include "sm90.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr float kNeg = -1e30f;       // finite mask value, as the reference
constexpr float kMaskedLse = 1e30f;  // LSE of a row with no visible key

typedef __nv_bfloat16 bf16;

struct Params {
  int B, Sq, Sk, H, K, causal, window, q_off, k_off;
  float scale;
};

__device__ __forceinline__ bool visible(const Params& p, int i, int j) {
  if (i >= p.Sq || j >= p.Sk) return false;
  const int kpos = p.k_off + j;
  const int qpos = p.q_off + i;
  if (kpos < 0) return false;
  if (p.causal && kpos > qpos) return false;
  if (p.window > 0 && kpos <= qpos - p.window) return false;
  return true;
}

// Key range [j_lo, j_hi) that queries [i0, i1) can see.
__device__ __forceinline__ void key_range(const Params& p, int i0, int i1,
                                          int& j_lo, int& j_hi) {
  j_lo = max(0, -p.k_off);
  j_hi = p.Sk;
  if (p.causal) j_hi = min(j_hi, p.q_off + i1 - p.k_off);
  if (p.window > 0) j_lo = max(j_lo, p.q_off + i0 - p.window + 1 - p.k_off);
}

// Query range [i_lo, i_hi) that keys [j0, min(Sk, j0 + rows)) are seen by.
__device__ __forceinline__ void query_range(const Params& p, int j0, int rows,
                                            int& i_lo, int& i_hi) {
  const int j1 = min(p.Sk, j0 + rows);
  const int jpos0 = max(j0, -p.k_off);
  i_lo = 0;
  i_hi = jpos0 < j1 ? p.Sq : 0;
  if (p.causal) i_lo = max(0, p.k_off + jpos0 - p.q_off);
  if (p.window > 0) i_hi = min(i_hi, p.k_off + j1 - 1 + p.window - p.q_off);
}

// ---------------------------------------------------------------------------
// The fp32 kernels: tiles staged in shared memory with rows padded by 16
// bytes (against bank conflicts), 32-row tiles, CUDA-core FMAs on 8 warps.
// ---------------------------------------------------------------------------
constexpr int kF32Tile = 32;

__host__ __device__ constexpr int ld_of(int cols) { return cols + 4; }

// Rows [r0, r0 + ROWS) of head hh of a (B, S, NH, D) tensor into a
// shared tile with row stride ld, 16 bytes a thread; rows past S are 0
// (a masked P of 0 times uninitialised memory could be NaN).
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          int b, int r0, int S, int NH,
                                          int hh) {
  constexpr int kPerRow = D / 4;
  for (int idx = threadIdx.x; idx < ROWS * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * 4;
    const int row = r0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < S)
      val = *reinterpret_cast<const float4*>(
          src + ((static_cast<size_t>(b) * S + row) * NH + hh) * D + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

// Element (r, c) of a shared matrix stored row-major (TRANS false) or
// as its transpose (TRANS true), with row stride ld.
template <bool TRANS>
__device__ __forceinline__ float elem(const float* m, int ld, int r, int c) {
  return TRANS ? m[c * ld + r] : m[r * ld + c];
}

// One warp: c[i] += A[m0:m0+16, 0:kdim] . B[0:kdim, n0+8i : n0+8i+8] for
// i < NT, with A(m, k) = elem<AT>(A, lda, m, k) and B(k, n) =
// elem<BT>(B, ldb, k, n), in fp32 FMAs. Accumulator layout is that of
// mma.sync m16n8k16: lane (g = lane / 4, t = lane % 4) holds c[i][0..1] at
// row g, columns 2t and 2t + 1 of tile i, and c[i][2..3] at row g + 8.
template <bool AT, bool BT, int NT>
__device__ __forceinline__ void warp_mma(float (&c)[NT][4], const float* A,
                                         int lda, int m0, const float* B,
                                         int ldb, int n0, int kdim) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int k = 0; k < kdim; ++k) {
    const float a0 = elem<AT>(A, lda, m0 + g, k);
    const float a1 = elem<AT>(A, lda, m0 + g + 8, k);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int n = n0 + 8 * i + 2 * t;
      const float b0 = elem<BT>(B, ldb, k, n);
      const float b1 = elem<BT>(B, ldb, k, n + 1);
      c[i][0] = fmaf(a0, b0, c[i][0]);
      c[i][1] = fmaf(a0, b1, c[i][1]);
      c[i][2] = fmaf(a1, b0, c[i][2]);
      c[i][3] = fmaf(a1, b1, c[i][3]);
    }
  }
}

// Row and column (within the warp's block) of accumulator element e of
// n-tile i.
__device__ __forceinline__ int acc_row(int e) {
  return ((threadIdx.x & 31) >> 2) + (e >= 2 ? 8 : 0);
}
__device__ __forceinline__ int acc_col(int i, int e) {
  return 8 * i + 2 * (threadIdx.x & 3) + (e & 1);
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
}

// Writes a warp's (16 x 8*NT) accumulator block, times mul, to rows
// [row0 + m0, ...) and columns [n0, ...) of head hh of a (B, S, NH, D)
// tensor, skipping rows past S.
template <int D, int NT>
__device__ __forceinline__ void store_acc(float* dst, const float (&c)[NT][4],
                                          int b, int row0, int m0, int n0,
                                          int S, int NH, int hh, float mul_lo,
                                          float mul_hi) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + m0 + acc_row(e);
      if (row < S)
        dst[((static_cast<size_t>(b) * S + row) * NH + hh) * D + n0 +
            acc_col(i, e)] = c[i][e] * (e >= 2 ? mul_hi : mul_lo);
    }
}

template <int D, int BQ, int BK>
constexpr size_t fwd_fp32_smem() {
  return sizeof(float) * ((BQ + 2 * BK) * ld_of(D) + BQ * ld_of(BK)) +
         sizeof(float) * (BQ * (BK + 4) + BQ);
}

// ---------------------------------------------------------------------------
// Forward, fp32: one block of 8 warps per (query tile, h, b), tiles staged
// in shared memory, CUDA-core FMAs.
// ---------------------------------------------------------------------------
template <int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, Params p) {
  constexpr int LD = ld_of(D);
  constexpr int LDP = ld_of(BK);
  constexpr int LDS = BK + 4;
  constexpr int WPR = kWarps / (BQ / 16);  // warps per 16-row block
  constexpr int NTS = BK / 8 / WPR;        // score tiles per warp
  constexpr int NTO = D / 8 / WPR;         // output tiles per warp
  constexpr int TPR = kThreads / BQ;       // softmax threads per row
  constexpr int CPT = BK / TPR;            // softmax columns per thread
  static_assert(NTS * 8 * WPR == BK && NTO * 8 * WPR == D, "warp tiling");
  static_assert(CPT * TPR == BK && TPR <= 32, "softmax tiling");
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;
  float* Ss = Ps + BQ * LDP;
  float* row_s = Ss + BQ * LDS;

  const int i0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp / WPR) * 16;
  const int wc = warp % WPR;
  const int srow = threadIdx.x / TPR, spart = threadIdx.x % TPR;

  load_rows<D, BQ>(Qs, LD, q, b, i0, p.Sq, p.H, h);
  int j_lo, j_hi;
  key_range(p, i0, min(p.Sq, i0 + BQ), j_lo, j_hi);

  float acc[NTO][4];
  zero(acc);
  float m_run = kNeg, l_run = 0.f;  // of row srow, held by its TPR threads

  for (int j0 = j_lo / BK * BK; j0 < j_hi; j0 += BK) {
    __syncthreads();  // the previous tile is consumed
    load_rows<D, BK>(Ks, LD, k, b, j0, p.Sk, p.K, kh);
    load_rows<D, BK>(Vs, LD, v, b, j0, p.Sk, p.K, kh);
    __syncthreads();
    float s[NTS][4];
    zero(s);
    warp_mma<false, true, NTS>(s, Qs, LD, m0, Ks, LD, wc * NTS * 8, D);
#pragma unroll
    for (int i = 0; i < NTS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + acc_row(e), c = wc * NTS * 8 + acc_col(i, e);
        Ss[r * LDS + c] =
            visible(p, i0 + r, j0 + c) ? s[i][e] * p.scale : kNeg;
      }
    __syncthreads();
    {  // online softmax of row srow over this tile
      const float* sr = Ss + srow * LDS + spart * CPT;
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < CPT; ++c) mx = fmaxf(mx, sr[c]);
#pragma unroll
      for (int o = TPR / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
      float* pr = Ps + srow * LDP + spart * CPT;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float x = sr[c];
        const float pv = x > kNeg ? expf(x - m_new) : 0.f;
        pr[c] = pv;
        sum += pv;
      }
#pragma unroll
      for (int o = TPR / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = expf(m_run - m_new);
      l_run = l_run * corr + sum;
      m_run = m_new;
      if (spart == 0) row_s[srow] = corr;
    }
    __syncthreads();
    const float c_lo = row_s[m0 + acc_row(0)], c_hi = row_s[m0 + acc_row(2)];
#pragma unroll
    for (int i = 0; i < NTO; ++i) {
      acc[i][0] *= c_lo;
      acc[i][1] *= c_lo;
      acc[i][2] *= c_hi;
      acc[i][3] *= c_hi;
    }
    warp_mma<false, false, NTO>(acc, Ps, LDP, m0, Vs, LD, wc * NTO * 8, BK);
  }

  __syncthreads();  // every warp has read the last tile's corrections
  if (spart == 0) {
    row_s[srow] = 1.f / fmaxf(l_run, 1e-30f);
    const int i = i0 + srow;
    if (i < p.Sq)
      lse[(static_cast<size_t>(b) * p.H + h) * p.Sq + i] =
          l_run > 0.f ? m_run + logf(l_run) : kMaskedLse;
  }
  __syncthreads();
  store_acc<D, NTO>(out, acc, b, i0, m0, wc * NTO * 8, p.Sq, p.H, h,
                    row_s[m0 + acc_row(0)], row_s[m0 + acc_row(2)]);
}

// ---------------------------------------------------------------------------
// Forward, bf16: warp-specialised, TMA into a ring of K/V stages, wgmma.
// ---------------------------------------------------------------------------
constexpr int kFwdRows = 128;     // query rows a block: 2 consumer warpgroups
constexpr int kFwdKeys = 64;      // keys a stage
constexpr int kFwdThreads = 384;  // 2 consumer warpgroups + 1 producer
constexpr int kConsumers = 256;   // threads that release a stage
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of the bf16 forward: Q as D / 64 column blocks of 128 rows
// of 128 bytes, then per stage K and V as D / 64 blocks of 64 rows each,
// every block in TMA's 128-byte swizzle and 1024-aligned.
template <int D>
struct FwdLayout {
  static constexpr int kCols = D / 64;
  static constexpr int kStages = D == 256 ? 2 : 4;
  static constexpr int kQBlock = kFwdRows * 128;
  static constexpr int kKVBlock = kFwdKeys * 128;
  static constexpr int kQBytes = kCols * kQBlock;
  static constexpr int kStageBytes = 2 * kCols * kKVBlock;  // K, then V
  static constexpr size_t kSmem = 1024 + kQBytes + kStages * kStageBytes;
};

// One consumer warpgroup: rows [i0 + 64 wg, + 64) of head h, batch b, over
// the block's key tiles t_lo .. t_lo + n_tiles - 1.
template <int D>
__device__ __forceinline__ void fwd_consumer(
    const Params& p, uint32_t q_base, uint32_t kv_base, uint64_t* q_full,
    uint64_t* full, uint64_t* empty, int i0, int t_lo, int n_tiles, int h,
    int b, bf16* __restrict__ out, float* __restrict__ lse) {
  using L = FwdLayout<D>;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int a0 = i0 + 64 * wg;        // the warpgroup's first row
  const int a1 = min(p.Sq, a0 + 64);  // past its last real row
  int wj_lo = 0, wj_hi = 0;           // keys its rows can see
  if (a0 < a1) key_range(p, a0, a1, wj_lo, wj_hi);
  const int row0 = a0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  const float scale2 = p.scale * kLog2e;
  const uint32_t q_addr = q_base + wg * 64 * 128;

  float o[L::kCols][32];
#pragma unroll
  for (int c = 0; c < L::kCols; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // m in log2 units

  sm90::mbar_wait(q_full, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % L::kStages;
    const int j0 = (t_lo + n) * kFwdKeys;
    sm90::mbar_wait(&full[s], (n / L::kStages) & 1);
    if (j0 < wj_hi && j0 + kFwdKeys > wj_lo) {
      const uint32_t k_addr = kv_base + s * L::kStageBytes;
      const uint32_t v_addr = k_addr + L::kCols * L::kKVBlock;
      float sc[32];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t at = (kk % 4) * 32;  // 16 columns
        sm90::wgmma_ss_k_k(
            sc, sm90::sw128_desc(q_addr + (kk / 4) * L::kQBlock + at, 16, 1024),
            sm90::sw128_desc(k_addr + (kk / 4) * L::kKVBlock + at, 16, 1024),
            kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(sc);

      // Scale into log2 units; mask only a tile that some (row, key) of
      // this warpgroup cannot see.
      const bool interior =
          j0 + kFwdKeys <= p.Sk && p.k_off + j0 >= 0 &&
          (!p.causal || p.k_off + j0 + kFwdKeys - 1 <= p.q_off + a0) &&
          (p.window <= 0 || p.k_off + j0 > p.q_off + a1 - 1 - p.window);
      if (interior) {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] *= scale2;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row0 + (e >= 2 ? 8 : 0);
            const int col = j0 + 8 * i + 2 * t + (e & 1);
            sc[4 * i + e] =
                visible(p, row, col) ? sc[4 * i + e] * scale2 : kNeg;
          }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const float x = sc[i];
        const float pv = (interior || x > kNeg) ? exp2f(x - m[r]) : 0.f;
        sc[i] = pv;
        sum[r] += pv;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
      for (int c = 0; c < L::kCols; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= corr[(i >> 1) & 1];

      // P (64 x 64) in wgmma's A-register layout: k-step kk covers the
      // accumulator's 8-column tiles 2kk and 2kk + 1.
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = sm90::pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
#pragma unroll
      for (int c = 0; c < L::kCols; ++c) sm90::fence_regs(o[c]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < L::kCols; ++c)
          sm90::wgmma_rs_mn(
              o[c], pa[kk],
              sm90::sw128_desc(v_addr + c * L::kKVBlock + kk * 2048,
                               L::kKVBlock, 1024));
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < L::kCols; ++c) sm90::fence_regs(o[c]);
    }
    sm90::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    bf16* dst = out + ((static_cast<size_t>(b) * p.Sq + row) * p.H + h) * D +
                2 * t;
#pragma unroll
    for (int c = 0; c < L::kCols; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<uint32_t*>(dst + 64 * c + 8 * i) = sm90::pack_bf16(
            o[c][4 * i + 2 * r] * inv, o[c][4 * i + 2 * r + 1] * inv);
    if (t == 0)
      lse[(static_cast<size_t>(b) * p.H + h) * p.Sq + row] =
          l[r] > 0.f ? m[r] * kLn2 + logf(l[r]) : kMaskedLse;
  }
}

// Grid (H * B, query tiles): x is (b, h), y the query tile counted from
// the last, so the longest causal tiles start first.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_kernel(__grid_constant__ const CUtensorMap qmap,
                 __grid_constant__ const CUtensorMap kmap,
                 __grid_constant__ const CUtensorMap vmap,
                 bf16* __restrict__ out, float* __restrict__ lse, Params p) {
  using L = FwdLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[L::kStages], empty[L::kStages];
  unsigned char* Qs = sm90::align1024(smem_raw);
  unsigned char* KVs = Qs + L::kQBytes;

  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kFwdRows;
  const int kh = h / (p.H / p.K);
  int j_lo, j_hi;
  key_range(p, i0, min(p.Sq, i0 + kFwdRows), j_lo, j_hi);
  const int t_lo = j_lo / kFwdKeys;
  const int n_tiles =
      j_hi > j_lo ? (j_hi + kFwdKeys - 1) / kFwdKeys - t_lo : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers) {
      sm90::mbar_expect_tx(&q_full, L::kQBytes);
      for (int c = 0; c < L::kCols; ++c)
        sm90::tma_load_4d(Qs + c * L::kQBlock, &qmap, &q_full, 64 * c, h, i0,
                          b);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % L::kStages;
        if (n >= L::kStages)
          sm90::mbar_wait(&empty[s], (n / L::kStages - 1) & 1);
        const int j0 = (t_lo + n) * kFwdKeys;
        unsigned char* Ks = KVs + s * L::kStageBytes;
        unsigned char* Vs = Ks + L::kCols * L::kKVBlock;
        sm90::mbar_expect_tx(&full[s], L::kStageBytes);
        for (int c = 0; c < L::kCols; ++c) {
          sm90::tma_load_4d(Ks + c * L::kKVBlock, &kmap, &full[s], 64 * c, kh,
                            j0, b);
          sm90::tma_load_4d(Vs + c * L::kKVBlock, &vmap, &full[s], 64 * c, kh,
                            j0, b);
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<240>();
    fwd_consumer<D>(p, sm90::smem_u32(Qs), sm90::smem_u32(KVs), &q_full, full,
                    empty, i0, t_lo, n_tiles, h, b, out, lse);
  }
}


// ---------------------------------------------------------------------------
// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d], one warp a row.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                   float* __restrict__ delta, int B, int Sq, int H, int D) {
  const size_t row = static_cast<size_t>(blockIdx.x) * kWarps +
                     (threadIdx.x >> 5);  // (b * Sq + i) * H + h
  if (row >= static_cast<size_t>(B) * Sq * H) return;
  const int lane = threadIdx.x & 31;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32)
    sum += to_float(o[row * D + d]) * to_float(dout[row * D + d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const size_t bi = row / H;
    const int i = static_cast<int>(bi % Sq);
    const int b = static_cast<int>(bi / Sq);
    delta[(static_cast<size_t>(b) * H + h) * Sq + i] = sum;
  }
}

// P and dS of one (query tile, key tile) pair, in a warp's accumulator
// block: P = exp(S * scale - lse) where visible, else 0; dS = P (dP -
// delta). Written into Pt / dSt (row stride ldp) when non-null.
template <int NT>
__device__ __forceinline__ void p_and_ds(const Params& p, const float (&s)[NT][4],
                                         const float (&dp)[NT][4],
                                         const float* lse_s,
                                         const float* delta_s, int i0, int j0,
                                         int m0, int n0, float* Pt, float* dSt,
                                         int ldp) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + acc_row(e), c = n0 + acc_col(i, e);
      const float pv = visible(p, i0 + r, j0 + c)
                           ? expf(s[i][e] * p.scale - lse_s[r])
                           : 0.f;
      if (Pt) Pt[r * ldp + c] = pv;
      dSt[r * ldp + c] = pv * (dp[i][e] - delta_s[r]);
    }
}

// lse and delta of query rows [i0, i0 + ROWS) of head h into shared.
template <int ROWS>
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s,
                                               const float* lse,
                                               const float* delta,
                                               const Params& p, int b, int h,
                                               int i0) {
  for (int r = threadIdx.x; r < ROWS; r += kThreads) {
    const int i = i0 + r;
    const size_t at = (static_cast<size_t>(b) * p.H + h) * p.Sq + i;
    lse_s[r] = i < p.Sq ? lse[at] : kMaskedLse;
    delta_s[r] = i < p.Sq ? delta[at] : 0.f;
  }
}

template <int D, int BQ, int BK>
constexpr size_t dkdv_fp32_smem() {
  return sizeof(float) * ((2 * BK + 2 * BQ) * ld_of(D) + 2 * BQ * ld_of(BK) +
                          2 * BQ);
}

// ---------------------------------------------------------------------------
// dK, dV, fp32: one block per (key tile, KV head, b).
// ---------------------------------------------------------------------------
template <int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_dkdv_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ dk,
                       float* __restrict__ dv, Params p) {
  constexpr int LD = ld_of(D);
  constexpr int LDP = ld_of(BK);
  constexpr int WPR_S = kWarps / (BQ / 16);  // S, dP: BQ x BK
  constexpr int NTS = BK / 8 / WPR_S;
  constexpr int WPR_A = kWarps / (BK / 16);  // dK, dV: BK x D
  constexpr int NTA = D / 8 / WPR_A;
  static_assert(NTS * 8 * WPR_S == BK && NTA * 8 * WPR_A == D, "warp tiling");
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Pt = dOs + BQ * LD;
  float* dSt = Pt + BQ * LDP;
  float* lse_s = dSt + BQ * LDP;
  float* delta_s = lse_s + BQ;

  const int j0 = blockIdx.x * BK, kh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.K;
  const int warp = threadIdx.x >> 5;
  const int ms = (warp / WPR_S) * 16, ns = (warp % WPR_S) * NTS * 8;
  const int ma = (warp / WPR_A) * 16, na = (warp % WPR_A) * NTA * 8;

  load_rows<D, BK>(Ks, LD, k, b, j0, p.Sk, p.K, kh);
  load_rows<D, BK>(Vs, LD, v, b, j0, p.Sk, p.K, kh);
  int i_lo, i_hi;
  query_range(p, j0, BK, i_lo, i_hi);

  float dk_acc[NTA][4], dv_acc[NTA][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int gh = 0; gh < G; ++gh) {
    const int h = kh * G + gh;
    for (int i0 = i_lo / BQ * BQ; i0 < i_hi; i0 += BQ) {
      __syncthreads();  // the previous query tile is consumed
      load_rows<D, BQ>(Qs, LD, q, b, i0, p.Sq, p.H, h);
      load_rows<D, BQ>(dOs, LD, dout, b, i0, p.Sq, p.H, h);
      load_row_stats<BQ>(lse_s, delta_s, lse, delta, p, b, h, i0);
      __syncthreads();
      float s[NTS][4], dp[NTS][4];
      zero(s);
      zero(dp);
      warp_mma<false, true, NTS>(s, Qs, LD, ms, Ks, LD, ns, D);
      warp_mma<false, true, NTS>(dp, dOs, LD, ms, Vs, LD, ns, D);
      p_and_ds<NTS>(p, s, dp, lse_s, delta_s, i0, j0, ms, ns, Pt, dSt, LDP);
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q over this tile's BQ queries.
      warp_mma<true, false, NTA>(dv_acc, Pt, LDP, ma, dOs, LD, na, BQ);
      warp_mma<true, false, NTA>(dk_acc, dSt, LDP, ma, Qs, LD, na, BQ);
    }
  }
  store_acc<D, NTA>(dv, dv_acc, b, j0, ma, na, p.Sk, p.K, kh, 1.f, 1.f);
  store_acc<D, NTA>(dk, dk_acc, b, j0, ma, na, p.Sk, p.K, kh, p.scale,
                    p.scale);
}

template <int D, int BQ, int BK>
constexpr size_t dq_fp32_smem() {
  return sizeof(float) * ((2 * BQ + 2 * BK) * ld_of(D) + BQ * ld_of(BK) +
                          2 * BQ);
}

// ---------------------------------------------------------------------------
// dQ, fp32: one block per (query tile, h, b).
// ---------------------------------------------------------------------------
template <int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_dq_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     Params p) {
  constexpr int LD = ld_of(D);
  constexpr int LDP = ld_of(BK);
  constexpr int WPR = kWarps / (BQ / 16);
  constexpr int NTS = BK / 8 / WPR;
  constexpr int NTO = D / 8 / WPR;
  static_assert(NTS * 8 * WPR == BK && NTO * 8 * WPR == D, "warp tiling");
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;
  float* lse_s = dSs + BQ * LDP;
  float* delta_s = lse_s + BQ;

  const int i0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp / WPR) * 16, wc = warp % WPR;

  load_rows<D, BQ>(Qs, LD, q, b, i0, p.Sq, p.H, h);
  load_rows<D, BQ>(dOs, LD, dout, b, i0, p.Sq, p.H, h);
  load_row_stats<BQ>(lse_s, delta_s, lse, delta, p, b, h, i0);
  int j_lo, j_hi;
  key_range(p, i0, min(p.Sq, i0 + BQ), j_lo, j_hi);

  float acc[NTO][4];
  zero(acc);
  for (int j0 = j_lo / BK * BK; j0 < j_hi; j0 += BK) {
    __syncthreads();  // the previous key tile is consumed
    load_rows<D, BK>(Ks, LD, k, b, j0, p.Sk, p.K, kh);
    load_rows<D, BK>(Vs, LD, v, b, j0, p.Sk, p.K, kh);
    __syncthreads();
    float s[NTS][4], dp[NTS][4];
    zero(s);
    zero(dp);
    warp_mma<false, true, NTS>(s, Qs, LD, m0, Ks, LD, wc * NTS * 8, D);
    warp_mma<false, true, NTS>(dp, dOs, LD, m0, Vs, LD, wc * NTS * 8, D);
    p_and_ds<NTS>(p, s, dp, lse_s, delta_s, i0, j0, m0, wc * NTS * 8,
                  nullptr, dSs, LDP);
    __syncthreads();
    warp_mma<false, false, NTO>(acc, dSs, LDP, m0, Ks, LD, wc * NTO * 8, BK);
  }
  store_acc<D, NTO>(dq, acc, b, i0, m0, wc * NTO * 8, p.Sq, p.H, h, p.scale,
                    p.scale);
}

// ---------------------------------------------------------------------------
// Backward, bf16: warp-specialised, TMA rings, wgmma (see the header).
// ---------------------------------------------------------------------------
constexpr int kBwdTile = 64;     // keys a dK/dV block, query rows a dQ block,
                                 // rows a streamed tile
constexpr int kBox = 64 * 128;   // one 64-row box of 64 columns, 128 B a row
constexpr int kDqThreads = 256;  // 1 consumer warpgroup + 1 producer
constexpr int kXchFull = 1, kXchFree = 2;  // named barriers of the P^T tile

// Shared memory of the bf16 backward: pairs of 64-row tiles (K and V, or Q
// and dO), each D / 64 boxes in TMA's 128-byte swizzle, 1024-aligned; the
// resident pair, then kStages streamed pairs, then (dK/dV) P^T in fp32.
template <int D>
struct BwdLayout {
  static constexpr int kCols = D / 64;
  static constexpr int kStages = D == 256 ? 2 : 4;
  static constexpr int kPair = 2 * kCols * kBox;
  static constexpr int kXch = 64 * 64 * 4;
  static constexpr size_t kDkdvSmem = 1024 + (1 + kStages) * kPair + kXch;
  static constexpr size_t kDqSmem = 1024 + (1 + kStages) * kPair;
};

// Whether every (query, key) of queries [i0, i0 + 64) and keys
// [j0, j0 + 64) is visible, so the tile needs no mask.
__device__ __forceinline__ bool tile_interior(const Params& p, int i0,
                                              int j0) {
  constexpr int T = kBwdTile;
  return i0 + T <= p.Sq && j0 + T <= p.Sk && p.k_off + j0 >= 0 &&
         (!p.causal || p.k_off + j0 + T - 1 <= p.q_off + i0) &&
         (p.window <= 0 || p.k_off + j0 > p.q_off + i0 + T - 1 - p.window);
}

// wgmma descriptors of a 64-row tile stored as D / 64 swizzled boxes:
// k-step kk (16 columns) read K-major, or k-step kk (16 rows) of column
// box c read MN-major.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return sm90::sw128_desc(tile + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int c, int kk) {
  return sm90::sw128_desc(tile + c * kBox + kk * 2048, kBox, 1024);
}

// A 64 x 64 fp32 accumulator rounded to bf16 in wgmma's A-register
// layout: k-step kk covers the accumulator's 8-column tiles 2kk, 2kk + 1.
__device__ __forceinline__ void to_a_regs(uint32_t (&a)[4][4],
                                          const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = sm90::pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// acc += a . tile over the 4 k-steps of a 64 x D tile read MN-major, one
// wgmma of N = D per k-step; returns with the sums in acc (D / 2 fp32
// registers in the accumulator layout over D / 8 column tiles).
template <int D>
__device__ __forceinline__ void accumulate_rs(float (&acc)[D / 2],
                                              const uint32_t (&a)[4][4],
                                              uint32_t tile) {
  sm90::fence_regs(acc);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = mnmajor(tile, 0, kk);
    if constexpr (D == 256) sm90::wgmma_rs_mn_n256(acc, a[kk], db);
    else if constexpr (D == 128) sm90::wgmma_rs_mn_n128(acc, a[kk], db);
    else sm90::wgmma_rs_mn(acc, a[kk], db);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait_all();
  sm90::fence_regs(acc);
}

// Stores a warpgroup's 64 x D accumulator (times mul) as bf16 rows
// [r0, r0 + 64) of head hh of a (B, S, NH, D) tensor, skipping rows past S.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           const float (&acc)[D / 2], int b,
                                           int r0, int S, int NH, int hh,
                                           float mul) {
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 16 * (tid / 32) + g + 8 * r;
    if (row >= S) continue;
    bf16* d = dst + ((static_cast<size_t>(b) * S + row) * NH + hh) * D + 2 * t;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(d + 8 * i) = sm90::pack_bf16(
          acc[4 * i + 2 * r] * mul, acc[4 * i + 2 * r + 1] * mul);
  }
}

// One consumer warpgroup of the dK/dV kernel, keys [j0, j0 + 64) of KV
// head kh over its n_it = G * nq (query head, query tile) steps. The dV
// side (first warpgroup) computes S^T = K Q^T, P^T and dV += P^T dO; the
// dK side computes dP^T = V dO^T, dS^T and dK += dS^T Q.
template <int D>
__device__ __forceinline__ void dkdv_consumer(
    const Params& p, bool dv_side, uint32_t kv_base, uint32_t qd_base,
    float* xch, uint64_t* kv_full, uint64_t* full, uint64_t* empty, int j0,
    int kh, int b, int G, int qt0, int nq, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dst) {
  using L = BwdLayout<D>;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32, t = lane % 4;
  const int key0 = j0 + 16 * (tid / 32) + lane / 4;  // rows key0, key0 + 8
  const int n_it = G * nq;
  const float scale2 = p.scale * kLog2e;
  const uint32_t a_tile = kv_base + (dv_side ? 0 : L::kCols * kBox);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  if (n_it > 0) sm90::mbar_wait(kv_full, 0);

  // The column statistic of this thread's 16 queries in step n: lse in
  // log2 units (dV side) or delta (dK side), loaded a step ahead; queries
  // past Sq are masked.
  auto load_stat = [&](float (&st)[16], int n) {
    const int h = kh * G + n / nq;
    const int i0 = (qt0 + n % nq) * kBwdTile;
    const float* src = (dv_side ? lse : delta) +
                       (static_cast<size_t>(b) * p.H + h) * p.Sq;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = i0 + 8 * (i / 2) + 2 * t + (i & 1);
      st[i] = col < p.Sq ? src[col] * (dv_side ? kLog2e : 1.f) : 0.f;
    }
  };
  float stat[16], next[16];
  if (n_it > 0) load_stat(stat, 0);

  for (int n = 0; n < n_it; ++n) {
    const int s = n % L::kStages;
    const int i0 = (qt0 + n % nq) * kBwdTile;
    const uint32_t q_tile = qd_base + s * L::kPair;
    const uint32_t do_tile = q_tile + L::kCols * kBox;
    if (n + 1 < n_it) load_stat(next, n + 1);
    sm90::mbar_wait(&full[s], (n / L::kStages) & 1);

    float x[32];  // S^T or dP^T: rows keys, columns queries
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss_k_k(x, kmajor(a_tile, kk),
                         kmajor(dv_side ? q_tile : do_tile, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(x);

    if (dv_side) {  // P^T = exp(S^T scale - lse), handed to the dK side
      // Straight-line loops (no branch per element), masked only on an
      // edge tile.
      if (tile_interior(p, i0, j0)) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          x[i] = exp2f(x[i] * scale2 - stat[2 * (i / 4) + (i & 1)]);
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = i0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int row = key0 + ((i & 2) ? 8 : 0);
          const float e = exp2f(x[i] * scale2 - stat[2 * (i / 4) + (i & 1)]);
          x[i] = visible(p, col, row) ? e : 0.f;
        }
      }
      if (n > 0) sm90::bar_sync(kXchFree, 256);
#pragma unroll
      for (int i = 0; i < 32; ++i) xch[i * 128 + tid] = x[i];
      sm90::bar_arrive(kXchFull, 256);
    } else {  // dS^T = P^T o (dP^T - delta)
      sm90::bar_sync(kXchFull, 256);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        x[i] = xch[i * 128 + tid] * (x[i] - stat[2 * (i / 4) + (i & 1)]);
      if (n + 1 < n_it) sm90::bar_arrive(kXchFree, 256);
    }
    uint32_t a[4][4];
    to_a_regs(a, x);
    accumulate_rs<D>(acc, a, dv_side ? do_tile : q_tile);  // dV, dK
    sm90::mbar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < 16; ++i) stat[i] = next[i];
  }
  store_rows<D>(dst, acc, b, j0, p.Sk, p.K, kh, dv_side ? 1.f : p.scale);
}

// Grid (key tiles, K * B): x is the key tile from the first, whose
// causal band is the longest, so long blocks start first; y is (b, kv
// head), so the blocks in flight share one head's Q and dO in L2.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_dkdv_kernel(__grid_constant__ const CUtensorMap qmap,
                  __grid_constant__ const CUtensorMap kmap,
                  __grid_constant__ const CUtensorMap vmap,
                  __grid_constant__ const CUtensorMap domap,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, Params p) {
  using L = BwdLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t kv_full, full[L::kStages], empty[L::kStages];
  unsigned char* KVs = sm90::align1024(smem_raw);  // K, then V
  unsigned char* QDs = KVs + L::kPair;             // stages of Q, then dO
  float* xch = reinterpret_cast<float*>(QDs + L::kStages * L::kPair);

  const int kh = blockIdx.y % p.K, b = blockIdx.y / p.K;
  const int j0 = blockIdx.x * kBwdTile;
  const int G = p.H / p.K;
  int i_lo, i_hi;
  query_range(p, j0, kBwdTile, i_lo, i_hi);
  const int qt0 = i_lo / kBwdTile;
  const int nq = i_hi > i_lo ? (i_hi + kBwdTile - 1) / kBwdTile - qt0 : 0;
  const int n_it = G * nq;  // (query head, query tile) steps, head-major

  if (threadIdx.x == 0) {
    sm90::mbar_init(&kv_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers && n_it > 0) {
      sm90::mbar_expect_tx(&kv_full, L::kPair);
      for (int c = 0; c < L::kCols; ++c) {
        sm90::tma_load_4d(KVs + c * kBox, &kmap, &kv_full, 64 * c, kh, j0, b);
        sm90::tma_load_4d(KVs + (L::kCols + c) * kBox, &vmap, &kv_full,
                          64 * c, kh, j0, b);
      }
      for (int n = 0; n < n_it; ++n) {
        const int s = n % L::kStages;
        if (n >= L::kStages)
          sm90::mbar_wait(&empty[s], (n / L::kStages - 1) & 1);
        const int h = kh * G + n / nq;
        const int i0 = (qt0 + n % nq) * kBwdTile;
        unsigned char* st = QDs + s * L::kPair;
        sm90::mbar_expect_tx(&full[s], L::kPair);
        for (int c = 0; c < L::kCols; ++c) {
          sm90::tma_load_4d(st + c * kBox, &qmap, &full[s], 64 * c, h, i0, b);
          sm90::tma_load_4d(st + (L::kCols + c) * kBox, &domap, &full[s],
                            64 * c, h, i0, b);
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<240>();
    const bool dv_side = threadIdx.x < 128;
    dkdv_consumer<D>(p, dv_side, sm90::smem_u32(KVs), sm90::smem_u32(QDs),
                     xch, &kv_full, full, empty, j0, kh, b, G, qt0, nq, lse,
                     delta, dv_side ? dv : dk);
  }
}

// The consumer warpgroup of the dQ kernel: rows [i0, i0 + 64) of head h
// over the key tiles t_lo .. t_lo + n_tiles - 1.
template <int D>
__device__ __forceinline__ void dq_consumer(
    const Params& p, uint32_t qd_base, uint32_t kv_base, uint64_t* qd_full,
    uint64_t* full, uint64_t* empty, int i0, int t_lo, int n_tiles, int h,
    int b, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq) {
  using L = BwdLayout<D>;
  const int tid = threadIdx.x;
  const int lane = tid % 32, t = lane % 4;
  const int row0 = i0 + 16 * (tid / 32) + lane / 4;  // rows row0, row0 + 8
  const float scale2 = p.scale * kLog2e;
  const uint32_t do_tile = qd_base + L::kCols * kBox;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const size_t at = (static_cast<size_t>(b) * p.H + h) * p.Sq + row;
    lse2[r] = row < p.Sq ? lse[at] * kLog2e : 0.f;
    dlt[r] = row < p.Sq ? delta[at] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  if (n_tiles > 0) sm90::mbar_wait(qd_full, 0);

  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % L::kStages;
    const int j0 = (t_lo + n) * kBwdTile;
    const uint32_t k_tile = kv_base + s * L::kPair;
    const uint32_t v_tile = k_tile + L::kCols * kBox;
    sm90::mbar_wait(&full[s], (n / L::kStages) & 1);
    float sc[32], dp[32];  // S = Q K^T, dP = dO V^T
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss_k_k(sc, kmajor(qd_base, kk), kmajor(k_tile, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss_k_k(dp, kmajor(do_tile, kk), kmajor(v_tile, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);

    // dS = P o (dP - delta): straight-line loops (no branch per
    // element), masked only on an edge tile.
    if (tile_interior(p, i0, j0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = exp2f(sc[i] * scale2 - lse2[r]) * (dp[i] - dlt[r]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const int col = j0 + 8 * (i / 4) + 2 * t + (i & 1);
        const float pv = exp2f(sc[i] * scale2 - lse2[r]);
        sc[i] = visible(p, row0 + 8 * r, col) ? pv * (dp[i] - dlt[r]) : 0.f;
      }
    }
    uint32_t a[4][4];
    to_a_regs(a, sc);
    accumulate_rs<D>(acc, a, k_tile);  // dQ += dS K
    sm90::mbar_arrive(&empty[s]);
  }
  store_rows<D>(dq, acc, b, i0, p.Sq, p.H, h, p.scale);
}

// Grid (query tiles, H * B): x is the query tile counted from the last,
// so the longest causal tiles start first; y is (b, h), so the blocks in
// flight share one head's K and V in L2.
template <int D>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_dq_kernel(__grid_constant__ const CUtensorMap qmap,
                __grid_constant__ const CUtensorMap kmap,
                __grid_constant__ const CUtensorMap vmap,
                __grid_constant__ const CUtensorMap domap,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dq, Params p) {
  using L = BwdLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t qd_full, full[L::kStages], empty[L::kStages];
  unsigned char* QDs = sm90::align1024(smem_raw);  // Q, then dO
  unsigned char* KVs = QDs + L::kPair;             // stages of K, then V

  const int h = blockIdx.y % p.H, b = blockIdx.y / p.H;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kBwdTile;
  const int kh = h / (p.H / p.K);
  int j_lo, j_hi;
  key_range(p, i0, min(p.Sq, i0 + kBwdTile), j_lo, j_hi);
  const int t_lo = j_lo / kBwdTile;
  const int n_tiles =
      j_hi > j_lo ? (j_hi + kBwdTile - 1) / kBwdTile - t_lo : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&qd_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warpgroup
    if (threadIdx.x == 128 && n_tiles > 0) {
      sm90::mbar_expect_tx(&qd_full, L::kPair);
      for (int c = 0; c < L::kCols; ++c) {
        sm90::tma_load_4d(QDs + c * kBox, &qmap, &qd_full, 64 * c, h, i0, b);
        sm90::tma_load_4d(QDs + (L::kCols + c) * kBox, &domap, &qd_full,
                          64 * c, h, i0, b);
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % L::kStages;
        if (n >= L::kStages)
          sm90::mbar_wait(&empty[s], (n / L::kStages - 1) & 1);
        const int j0 = (t_lo + n) * kBwdTile;
        unsigned char* st = KVs + s * L::kPair;
        sm90::mbar_expect_tx(&full[s], L::kPair);
        for (int c = 0; c < L::kCols; ++c) {
          sm90::tma_load_4d(st + c * kBox, &kmap, &full[s], 64 * c, kh, j0, b);
          sm90::tma_load_4d(st + (L::kCols + c) * kBox, &vmap, &full[s],
                            64 * c, kh, j0, b);
        }
      }
    }
  } else {
    dq_consumer<D>(p, sm90::smem_u32(QDs), sm90::smem_u32(KVs), &qd_full,
                   full, empty, i0, t_lo, n_tiles, h, b, lse, delta, dq);
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

constexpr size_t kMaxSmem = 232448;  // per block on the H100

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <int D>
int fwd_fp32(const void* q, const void* k, const void* v, void* out,
             void* lse, const Params& p, cudaStream_t s) {
  constexpr int BQ = kF32Tile, BK = kF32Tile;
  constexpr size_t bytes = fwd_fp32_smem<D, BQ, BK>();
  static_assert(bytes <= kMaxSmem, "forward tiles exceed shared memory");
  auto kernel = flash_fwd_fp32_kernel<D, BQ, BK>;
  if (int err = set_smem(kernel, bytes)) return err;
  kernel<<<dim3(cdiv(p.Sq, BQ), p.H, p.B), kThreads, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), p);
  return static_cast<int>(cudaGetLastError());
}

// Tensor map of a (B, S, NH, D) bf16 tensor as (D, NH, S, B), boxes of 64
// columns of one head over `rows` rows of one batch. S 0 (no keys, so no
// tile is ever loaded) is described as 1 row of `fallback`.
template <int D>
int head_map(CUtensorMap* map, const void* base, const void* fallback, int B,
             int S, int NH, int rows) {
  const uint64_t row = static_cast<uint64_t>(NH) * D * sizeof(bf16);
  const uint64_t dims[4] = {D, static_cast<uint64_t>(NH),
                            static_cast<uint64_t>(S > 0 ? S : 1),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {D * sizeof(bf16), row,
                               row * static_cast<uint64_t>(S > 0 ? S : 1)};
  const uint32_t box[4] = {64, 1, static_cast<uint32_t>(rows), 1};
  return sm90::encode_bf16_map<4>(map, S > 0 ? base : fallback, dims,
                                  strides, box, true);
}

template <int D>
int fwd_bf16(const void* q, const void* k, const void* v, void* out,
             void* lse, const Params& p, cudaStream_t s) {
  using L = FwdLayout<D>;
  static_assert(L::kSmem <= kMaxSmem, "forward tiles exceed shared memory");
  CUtensorMap qm, km, vm;
  if (int err = head_map<D>(&qm, q, q, p.B, p.Sq, p.H, kFwdRows)) return err;
  if (int err = head_map<D>(&km, k, q, p.B, p.Sk, p.K, kFwdKeys)) return err;
  if (int err = head_map<D>(&vm, v, q, p.B, p.Sk, p.K, kFwdKeys)) return err;
  auto kernel = flash_fwd_kernel<D>;
  if (int err = set_smem(kernel, L::kSmem)) return err;
  kernel<<<dim3(p.H * p.B, cdiv(p.Sq, kFwdRows)), kFwdThreads, L::kSmem, s>>>(
      qm, km, vm, static_cast<bf16*>(out), static_cast<float*>(lse), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_delta(const void* out, const void* dout, void* dl, const Params& p,
          int D, cudaStream_t s) {
  const int rows = p.B * p.Sq * p.H;
  flash_delta_kernel<T><<<cdiv(rows, kWarps), kThreads, 0, s>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<float*>(dl), p.B, p.Sq, p.H, D);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_fp32(const void* q, const void* k, const void* v, const void* out,
             const void* dout, const void* lse, void* dl, void* dq, void* dk,
             void* dv, const Params& p, cudaStream_t s) {
  if (int err = launch_delta<float>(out, dout, dl, p, D, s)) return err;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  const float* lset = static_cast<const float*>(lse);
  const float* dlt = static_cast<const float*>(dl);
  constexpr int T = kF32Tile;
  constexpr size_t kv_bytes = dkdv_fp32_smem<D, T, T>();
  static_assert(kv_bytes <= kMaxSmem, "dK/dV tiles exceed shared memory");
  auto kv_kernel = flash_dkdv_fp32_kernel<D, T, T>;
  if (int err = set_smem(kv_kernel, kv_bytes)) return err;
  kv_kernel<<<dim3(cdiv(p.Sk, T), p.K, p.B), kThreads, kv_bytes, s>>>(
      qt, kt, vt, dot, lset, dlt, static_cast<float*>(dk),
      static_cast<float*>(dv), p);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  constexpr size_t q_bytes = dq_fp32_smem<D, T, T>();
  static_assert(q_bytes <= kMaxSmem, "dQ tiles exceed shared memory");
  auto q_kernel = flash_dq_fp32_kernel<D, T, T>;
  if (int err = set_smem(q_kernel, q_bytes)) return err;
  q_kernel<<<dim3(cdiv(p.Sq, T), p.H, p.B), kThreads, q_bytes, s>>>(
      qt, kt, vt, dot, lset, dlt, static_cast<float*>(dq), p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_bf16(const void* q, const void* k, const void* v, const void* out,
             const void* dout, const void* lse, void* dl, void* dq, void* dk,
             void* dv, const Params& p, cudaStream_t s) {
  using L = BwdLayout<D>;
  static_assert(L::kDkdvSmem <= kMaxSmem && L::kDqSmem <= kMaxSmem,
                "backward tiles exceed shared memory");
  if (int err = launch_delta<bf16>(out, dout, dl, p, D, s)) return err;
  CUtensorMap qm, km, vm, dom;
  if (int err = head_map<D>(&qm, q, q, p.B, p.Sq, p.H, kBwdTile)) return err;
  if (int err = head_map<D>(&km, k, q, p.B, p.Sk, p.K, kBwdTile)) return err;
  if (int err = head_map<D>(&vm, v, q, p.B, p.Sk, p.K, kBwdTile)) return err;
  if (int err = head_map<D>(&dom, dout, q, p.B, p.Sq, p.H, kBwdTile))
    return err;
  const float* lset = static_cast<const float*>(lse);
  const float* dlt = static_cast<const float*>(dl);
  auto kv_kernel = flash_dkdv_kernel<D>;
  if (int err = set_smem(kv_kernel, L::kDkdvSmem)) return err;
  kv_kernel<<<dim3(cdiv(p.Sk, kBwdTile), p.K * p.B), kFwdThreads,
              L::kDkdvSmem, s>>>(qm, km, vm, dom, lset, dlt,
                                 static_cast<bf16*>(dk),
                                 static_cast<bf16*>(dv), p);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  auto q_kernel = flash_dq_kernel<D>;
  if (int err = set_smem(q_kernel, L::kDqSmem)) return err;
  q_kernel<<<dim3(cdiv(p.Sq, kBwdTile), p.H * p.B), kDqThreads, L::kDqSmem,
             s>>>(qm, km, vm, dom, lset, dlt, static_cast<bf16*>(dq), p);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(int B, int Sq, int Sk, int H, int K, int causal,
                   int window, int q_off, int k_off, float scale) {
  Params p;
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.K = K;
  p.causal = causal;
  p.window = window;
  p.q_off = q_off;
  p.k_off = k_off;
  p.scale = scale;
  return p;
}

}  // namespace

// q: (B, Sq, H, D); k, v: (B, Sk, K, D); out: (B, Sq, H, D); lse: (B, H,
// Sq) fp32. All contiguous, 16-byte aligned, on one device; bf16 (is_bf16
// 1) or fp32 (0); D in {64, 128, 256}; H % K == 0. window <= 0: none.
// Returns the CUDA error of the launch (cudaErrorInvalidValue for an
// unsupported D).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse, int B,
                                   int Sq, int Sk, int H, int K, int D,
                                   int causal, int window, int q_off,
                                   int k_off, float scale, int is_bf16,
                                   void* stream) {
  const Params p =
      make_params(B, Sq, Sk, H, K, causal, window, q_off, k_off, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FWD(KIND, DD) return fwd_##KIND<DD>(q, k, v, out, lse, p, s)
  if (is_bf16) {
    switch (D) {
      case 64: FWD(bf16, 64);
      case 128: FWD(bf16, 128);
      case 256: FWD(bf16, 256);
    }
  } else {
    switch (D) {
      case 64: FWD(fp32, 64);
      case 128: FWD(fp32, 128);
      case 256: FWD(fp32, 256);
    }
  }
#undef FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward of flash_attention_fwd over the same shapes: dout like
// out, lse as the forward wrote it, delta (B, H, Sq) fp32 scratch; dq
// like q, dk and dv like k. Launches the delta, dK/dV and dQ kernels in
// that order on the stream. Returns the first CUDA error.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Sk, int H, int K, int D,
                                   int causal, int window, int q_off,
                                   int k_off, float scale, int is_bf16,
                                   void* stream) {
  const Params p =
      make_params(B, Sq, Sk, H, K, causal, window, q_off, k_off, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BWD(KIND, DD) \
  return bwd_##KIND<DD>(q, k, v, out, dout, lse, delta, dq, dk, dv, p, s)
  if (is_bf16) {
    switch (D) {
      case 64: BWD(bf16, 64);
      case 128: BWD(bf16, 128);
      case 256: BWD(bf16, 256);
    }
  } else {
    switch (D) {
      case 64: BWD(fp32, 64);
      case 128: BWD(fp32, 128);
      case 256: BWD(fp32, 256);
    }
  }
#undef BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
