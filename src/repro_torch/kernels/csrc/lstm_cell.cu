// Fused LSTM cell for Hopper (sm_90a), forward and backward, plain C entry
// points.
//
// Replaces the TPU kernel repro/kernels/lstm_cell.py:_kernel (body at
// lstm_cell.py:18, pl.pallas_call at :51). For every batch row r and unit j
// of F it computes, in fp32,
//   gates = x_proj + h . W_h + b      (columns j, F+j, 2F+j, 3F+j: i, f, g, o)
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g);   h' = sigmoid(o) * tanh(c')
// and writes h' in x_proj's dtype and c' in fp32; on request it also writes
// the activated gates (B, 4F) in fp32 for the backward. The reference has no
// backward kernel (GNMT trains through jax.grad of repro/kernels/ref.py:
// lstm_cell); here the cell-local part of the gradient is one fused
// elementwise pass over (B, F):
//   dc = dc' + dh' * o * (1 - tanh(c')^2);   dc_prev = dc * f
//   di = dc * g * i(1-i);  df = dc * c * f(1-f);  dg = dc * i * (1-g^2);
//   do = dh' * tanh(c') * o(1-o)
// and in the same pass dx_proj (dgates in x_proj's dtype) and db (dgates
// summed over the rows); dh_prev and dW_h follow from dgates outside the
// kernel, as two fp32 products.
//
// Design. On the TPU, W_h (F, 4F) stays resident in VMEM across a grid over
// batch tiles. At GNMT's F = 1024 it is 8 MiB of bf16, far beyond one SM's
// 227 KB, so here the grid tiles the hidden units instead, and each W_h
// element is read from device memory once per call: a block owns 8 units
// (their four gate columns, 32 of 4F) and all the batch rows (128 a block;
// B 128 is one block row), so at F 1024 the grid is 128 blocks. The four
// gates of a (row, unit) land in one thread's accumulators, so the
// nonlinearities and the c update run in registers in the epilogue and the
// (B, 4F) gate pre-activations never reach device memory.
//
// The bf16 forward streams the k dimension through a ring of 6 stages of
// depth 64 in shared memory, kept full by a producer warp whose one thread
// issues TMA loads (a 128 x 64 tile of h in the 128-byte swizzle, and the
// four 64 x 8 gate slices of W_h), each stage signalled by a "full"
// mbarrier and released by an "empty" one, so six tiles' loads are in
// flight while the tensor cores work. Eight consumer warps each own 16
// rows: per k step of 16 they read h's A fragment with one ldmatrix and
// W_h's B fragments for two gates with one ldmatrix.trans, and run
// mma.sync m16n8k16 (bf16 in, fp32 accumulate). Ragged B and F are
// zero-filled by TMA and masked in the epilogue (F a multiple of 8, for the
// tensor maps' 16-byte strides and the 8-unit tiles). The fp32 variant
// stages 32 x 32 tiles of h and 32 x 128 of W_h through shared memory and
// runs CUDA-core FMAs at full fp32, as the reference's fp32 product.
//
// Bound on the H100 at GNMT's shape (B 128, F 1024, bf16): bytes. The
// forward moves 11,026,432 B (13,123,584 with the gates), 0.0033 ms
// (0.0039 ms) at 3.35 TB/s, against 1.07 GFLOP, 0.0011 ms at 989 TFLOP/s:
// W_h is read again at every time step. Each block also reads all of h
// (256 KB at B 128), from L2 after the first.
//
// The backward moves 7,618,560 B at that shape (gates, c_prev, c', dc' and
// bf16 dh in; dgates, dc_prev, bf16 dx and db out), 0.0023 ms at 3.35 TB/s.
// It writes dx and db itself, so no launch reads dgates again. Blocks of 8
// units over all rows (32-byte pieces of each row), and TMA boxes of 8
// units x 128 rows, measured slower than the 4-block cluster strips of 32
// units below.
#include <cooperative_groups.h>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// ---------------------------------------------------------------------------
// Forward, bf16: one block per (8-unit tile, 128-row tile); 8 consumer
// warps and one producer warp over a TMA ring of k tiles.
// ---------------------------------------------------------------------------
constexpr int kRows = 128;   // batch rows a block: 8 warps x 16
constexpr int kUnits = 8;    // hidden units a block: 4 x 8 gate columns
constexpr int kDepth = 64;   // k depth of a stage
constexpr int kStages = 6;
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kHBytes = kRows * kDepth * 2;      // h tile, 128-byte swizzle
constexpr int kGateBytes = kDepth * kUnits * 2;  // one gate's W_h slice
constexpr int kStageBytes = kHBytes + 4 * kGateBytes;
constexpr size_t kFwdSmem = 1024 + kStages * kStageBytes;

__global__ void __launch_bounds__(kMmaThreads + 32, 1)
lstm_fwd_kernel(__grid_constant__ const CUtensorMap hmap,
                __grid_constant__ const CUtensorMap wmap,
                const bf16* __restrict__ xp, const float* __restrict__ c,
                const float* __restrict__ bias, bf16* __restrict__ h_out,
                float* __restrict__ c_out, float* __restrict__ gates_out,
                int B, int F) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  unsigned char* smem = sm90::align1024(smem_raw);
  const int j0 = blockIdx.x * kUnits, r0 = blockIdx.y * kRows;
  const int n_k = (F + kDepth - 1) / kDepth;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kMmaThreads);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kMmaWarps) {  // the producer
    if (lane == 0) {
      for (int n = 0; n < n_k; ++n) {
        const int s = n % kStages;
        if (n >= kStages) sm90::mbar_wait(&empty[s], (n / kStages - 1) & 1);
        unsigned char* st = smem + s * kStageBytes;
        sm90::mbar_expect_tx(&full[s], kStageBytes);
        sm90::tma_load_2d(st, &hmap, &full[s], n * kDepth, r0);
        for (int q = 0; q < 4; ++q)
          sm90::tma_load_2d(st + kHBytes + q * kGateBytes, &wmap, &full[s],
                            q * F + j0, n * kDepth);
      }
    }
    return;
  }

  // Stage layout: h as 128 rows of 128 bytes (16-byte chunk k ^ row % 8),
  // then W_h as [gate][k][8 units]. ldmatrix lane addresses: h rows
  // 0-7 / 8-15 of the warp's 16 at k chunks 2kk / 2kk + 1; W_h rows k
  // 16kk + 0-7 / 8-15 of gates 2p / 2p + 1.
  const int m0 = 16 * warp;
  const int a_row = m0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_hi = lane >> 4;
  const int b_gate = lane >> 4;
  const int b_k = 8 * ((lane >> 3) & 1) + (lane & 7);
  float acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;

  for (int n = 0; n < n_k; ++n) {
    const int s = n % kStages;
    sm90::mbar_wait(&full[s], (n / kStages) & 1);
    const uint32_t hs = sm90::smem_u32(smem + s * kStageBytes);
    const uint32_t ws = hs + kHBytes;
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk) {
      uint32_t a[4];
      sm90::ldmatrix_x4(
          a, hs + a_row * 128 + (((2 * kk + a_hi) ^ (a_row & 7)) << 4));
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        uint32_t bw[4];
        sm90::ldmatrix_x4_trans(
            bw, ws + ((2 * pr + b_gate) * kDepth + 16 * kk + b_k) * 16);
        sm90::mma_bf16(acc[2 * pr], a, bw[0], bw[1]);
        sm90::mma_bf16(acc[2 * pr + 1], a, bw[2], bw[3]);
      }
    }
    sm90::mbar_arrive(&empty[s]);
  }

  const int g = lane / 4, t = lane % 4;
  const int j = j0 + 2 * t;
  const size_t F4 = 4 * static_cast<size_t>(F);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + m0 + g + 8 * r;
    if (row >= B) continue;
    const size_t xr = static_cast<size_t>(row) * F4;
    const size_t o = static_cast<size_t>(row) * F + j;
    float act[4][2];
    float2 cn, hn;
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // (x_proj + h . W_h) + b, as the reference
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xp + xr + q * F + j));
      const float2 bq = *reinterpret_cast<const float2*>(bias + q * F + j);
      act[q][0] = (acc[q][2 * r] + x.x) + bq.x;
      act[q][1] = (acc[q][2 * r + 1] + x.y) + bq.y;
    }
    const float2 cp = *reinterpret_cast<const float2*>(c + o);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      act[0][u] = sigmoid(act[0][u]);
      act[1][u] = sigmoid(act[1][u]);
      act[2][u] = tanhf(act[2][u]);
      act[3][u] = sigmoid(act[3][u]);
    }
    cn.x = act[1][0] * cp.x + act[0][0] * act[2][0];
    cn.y = act[1][1] * cp.y + act[0][1] * act[2][1];
    hn.x = act[3][0] * tanhf(cn.x);
    hn.y = act[3][1] * tanhf(cn.y);
    *reinterpret_cast<__nv_bfloat162*>(h_out + o) =
        __floats2bfloat162_rn(hn.x, hn.y);
    *reinterpret_cast<float2*>(c_out + o) = cn;
    if (gates_out)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float2*>(gates_out + xr + q * F + j) =
            make_float2(act[q][0], act[q][1]);
  }
}

// ---------------------------------------------------------------------------
// Forward, fp32: one block of 4 warps per (32-unit tile, 32-row tile), k
// tiles of depth 32 staged in shared memory, CUDA-core FMAs.
// ---------------------------------------------------------------------------
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int BM = 32;  // batch rows a block
constexpr int BN = 32;  // hidden units a block (4 * BN gate columns)
constexpr int BK = 32;  // depth of one staged k tile
constexpr int kPad = 4;  // shared row padding (16 bytes), against bank conflicts

// One warp: c[i] += A[m0:m0+16, 0:BK] . B[0:BK, n0+8i : n0+8i+8] for i < NT,
// A row-major (lda), B row-major (ldb), both in shared memory, in the
// accumulator layout of sm90::mma_bf16.
template <int NT>
__device__ __forceinline__ void warp_fma(float (&c)[NT][4], const float* A,
                                         int lda, int m0, const float* B,
                                         int ldb, int n0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < BK; ++k) {
    const float a0 = A[(m0 + g) * lda + k];
    const float a1 = A[(m0 + g + 8) * lda + k];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int n = n0 + 8 * i + 2 * t;
      const float b0 = B[k * ldb + n];
      const float b1 = B[k * ldb + n + 1];
      c[i][0] = fmaf(a0, b0, c[i][0]);
      c[i][1] = fmaf(a0, b1, c[i][1]);
      c[i][2] = fmaf(a1, b0, c[i][2]);
      c[i][3] = fmaf(a1, b1, c[i][3]);
    }
  }
}

// Shared column s of the staged W_h tile (0 <= s < 4 * BN) holds global
// column gate * F + j0 + 16 * wcol + within, with wcol = s / 64 (the warp
// column), gate = (s / 16) % 4 and within = s % 16: each warp's 64
// contiguous columns are the four gates of its 16 units, 8-column tile
// i = 2 * gate + (unit / 8).
__device__ __forceinline__ int w_unit(int s) { return 16 * (s >> 6) + (s & 15); }
__device__ __forceinline__ int w_gate(int s) { return (s >> 4) & 3; }

__global__ void __launch_bounds__(kThreads)
lstm_fwd_fp32_kernel(const float* __restrict__ xp, const float* __restrict__ h,
                     const float* __restrict__ c, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ h_out,
                     float* __restrict__ c_out, float* __restrict__ gates_out,
                     int B, int F) {
  constexpr int V = 4;  // floats per 16-byte load
  constexpr int LDH = BK + kPad;
  constexpr int LDW = 4 * BN + kPad;
  __shared__ __align__(16) float Hs[BM * LDH];
  __shared__ __align__(16) float Ws[BK * LDW];

  const int j0 = blockIdx.x * BN, r0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp >> 1) * 16;  // the warp's 16 rows within the tile
  const int wcol = warp & 1;        // the warp's 16 units: j0 + 16 * wcol
  const size_t F4 = 4 * static_cast<size_t>(F);

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int k0 = 0; k0 < F; k0 += BK) {
    for (int idx = threadIdx.x; idx < BM * (BK / V); idx += kThreads) {
      const int r = idx / (BK / V), kk = (idx % (BK / V)) * V;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < B && k0 + kk < F)
        val = *reinterpret_cast<const uint4*>(
            h + static_cast<size_t>(r0 + r) * F + k0 + kk);
      *reinterpret_cast<uint4*>(Hs + r * LDH + kk) = val;
    }
    for (int idx = threadIdx.x; idx < BK * (4 * BN / V); idx += kThreads) {
      const int kk = idx / (4 * BN / V), s = (idx % (4 * BN / V)) * V;
      const int unit = j0 + w_unit(s);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + kk < F && unit < F)
        val = *reinterpret_cast<const uint4*>(
            w + static_cast<size_t>(k0 + kk) * F4 +
            static_cast<size_t>(w_gate(s)) * F + unit);
      *reinterpret_cast<uint4*>(Ws + kk * LDW + s) = val;
    }
    __syncthreads();
    warp_fma<8>(acc, Hs, LDH, m0, Ws, LDW, 64 * wcol);
    __syncthreads();
  }

  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + m0 + (lane >> 2) + (e >= 2 ? 8 : 0);
      const int j = j0 + 16 * wcol + 8 * u + 2 * (lane & 3) + (e & 1);
      if (row >= B || j >= F) continue;
      const size_t xr = static_cast<size_t>(row) * F4;
      float pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)  // (x_proj + h . W_h) + b, as the reference
        pre[q] = (acc[2 * q + u][e] + xp[xr + q * F + j]) +
                 bias[q * F + j];
      const float ig = sigmoid(pre[0]), fg = sigmoid(pre[1]);
      const float gg = tanhf(pre[2]), og = sigmoid(pre[3]);
      const size_t o = static_cast<size_t>(row) * F + j;
      const float cn = fg * c[o] + ig * gg;
      h_out[o] = og * tanhf(cn);
      c_out[o] = cn;
      if (gates_out) {
        gates_out[xr + j] = ig;
        gates_out[xr + F + j] = fg;
        gates_out[xr + 2 * F + j] = gg;
        gates_out[xr + 3 * F + j] = og;
      }
    }
}

// ---------------------------------------------------------------------------
// Backward of the cell-local part, one fused pass. A cluster of 4 blocks
// owns a strip of 32 units (128 columns of dgates, 32 of each gate) over
// all B rows, so every row of every operand is read and written as whole
// 128-byte lines; block k of the cluster takes rows 32k .. 32k + 31 of
// every 128-row tile, and a thread owns (row, 4 units) and issues all its
// 16-byte loads before their first use. It writes dgates and dc_prev in
// fp32, dx (dgates in dh's dtype, bf16 only: an fp32 dx is dgates itself)
// and db: each block sums its columns over its rows in a fixed order
// (shuffles within a warp, then the warps in order through shared memory),
// blocks 1-3 push their sums into block 0's shared memory, and block 0 adds
// the four in rank order. No atomics, and a rerun is bitwise equal.
// ---------------------------------------------------------------------------
constexpr int kBwdThreads = 256;        // 32 rows x 8 threads of 4 units
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kCluster = 4;             // blocks a strip
constexpr int kStrip = 32;              // units a strip
constexpr int kBlockRows = kBwdThreads / (kStrip / 4);

__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void ld4(const bf16* p, float (&v)[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(bf16* p, const float (&v)[4]) {
  uint2 x;
  x.x = sm90::pack_bf16(v[0], v[1]);
  x.y = sm90::pack_bf16(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = x;
}

template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kBwdThreads)
lstm_bwd_kernel(const float* __restrict__ gates,
                const float* __restrict__ c_prev,
                const float* __restrict__ c_new, const T* __restrict__ dh,
                const float* __restrict__ dc_new, float* __restrict__ dgates,
                float* __restrict__ dc_prev, T* __restrict__ dx,
                float* __restrict__ db, int B, int F) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float part[kBwdWarps][4 * kStrip];
  __shared__ float slots[kCluster][4 * kStrip];  // block 0's: each block's sums
  sm90::cluster_arrive_relaxed();  // waited on before the first remote store
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = (blockIdx.x / kCluster) * kStrip;
  const int j = j0 + 4 * (threadIdx.x % (kStrip / 4));
  const size_t F4 = 4 * static_cast<size_t>(F);
  float sum[4][4] = {};
  if (j < F)
    for (int row = rank * kBlockRows + threadIdx.x / (kStrip / 4); row < B;
         row += kCluster * kBlockRows) {
      const size_t o = static_cast<size_t>(row) * F + j;
      const size_t gr = static_cast<size_t>(row) * F4 + j;
      float gt[4][4], cp[4], cn[4], dhv[4], dcn[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) ld4(gates + gr + q * F, gt[q]);
      ld4(c_prev + o, cp);
      ld4(c_new + o, cn);
      ld4(dh + o, dhv);
      ld4(dc_new + o, dcn);
      float d[4][4], dcp[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {  // gates in the order i, f, g, o
        const float ig = gt[0][u], fg = gt[1][u], gg = gt[2][u];
        const float og = gt[3][u];
        const float tc = tanhf(cn[u]);
        const float dc = dcn[u] + dhv[u] * og * (1.f - tc * tc);
        d[0][u] = dc * gg * (ig * (1.f - ig));
        d[1][u] = dc * cp[u] * (fg * (1.f - fg));
        d[2][u] = dc * ig * (1.f - gg * gg);
        d[3][u] = dhv[u] * tc * (og * (1.f - og));
        dcp[u] = dc * fg;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        st4(dgates + gr + q * F, d[q]);
        if (dx) st4(dx + gr + q * F, d[q]);
#pragma unroll
        for (int u = 0; u < 4; ++u) sum[q][u] += d[q][u];
      }
      st4(dc_prev + o, dcp);
    }
  // Lanes l, l + 8, l + 16, l + 24 hold the same 4 units: a butterfly over
  // lane bits 3-4, then the warps in order.
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float v = sum[q][u];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < kStrip / 4) part[warp][q * kStrip + 4 * lane + u] = v;
    }
  __syncthreads();
  sm90::cluster_wait();  // every block of the cluster has started
  if (threadIdx.x < 4 * kStrip) {
    float v = part[0][threadIdx.x];
    for (int w = 1; w < kBwdWarps; ++w) v += part[w][threadIdx.x];
    cluster.map_shared_rank(&slots[0][0], 0)[rank * 4 * kStrip +
                                            threadIdx.x] = v;
  }
  sm90::cluster_arrive_release();
  if (rank != 0) return;
  sm90::cluster_wait();  // the four blocks' sums are in slots
  if (threadIdx.x < 4 * kStrip) {
    float v = slots[0][threadIdx.x];
    for (int r = 1; r < kCluster; ++r) v += slots[r][threadIdx.x];
    const int c = j0 + threadIdx.x % kStrip;
    if (c < F) db[(threadIdx.x / kStrip) * F + c] = v;
  }
}

}  // namespace

// x_proj (B, 4F), h (B, F), w_h (F, 4F): bf16 (is_bf16 = 1) or fp32; c
// (B, F), b (4F,) fp32. Writes h_out (B, F) in x_proj's dtype, c_out
// (B, F) fp32 and, when gates_out is not null, the activated gates (B, 4F)
// fp32. All pointers 16-byte aligned, F a multiple of 8.
extern "C" int lstm_cell_fwd(const void* x_proj, const void* h, const void* c,
                             const void* w_h, const void* b, void* h_out,
                             void* c_out, void* gates_out, int B, int F,
                             int is_bf16, void* stream) {
  if (B <= 0 || F <= 0 || F % 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    lstm_fwd_fp32_kernel<<<dim3((F + BN - 1) / BN, (B + BM - 1) / BM),
                           kThreads, 0, s>>>(
        static_cast<const float*>(x_proj), static_cast<const float*>(h),
        static_cast<const float*>(c), static_cast<const float*>(w_h),
        static_cast<const float*>(b), static_cast<float*>(h_out),
        static_cast<float*>(c_out), static_cast<float*>(gates_out), B, F);
    return static_cast<int>(cudaGetLastError());
  }
  // h as (F, B), boxes of 64 k by 128 rows; W_h as (4F, F), boxes of 8
  // gate columns by 64 k.
  CUtensorMap hmap, wmap;
  const uint64_t f = static_cast<uint64_t>(F);
  if (int err = sm90::encode_bf16_map<2>(
          &hmap, h, {f, static_cast<uint64_t>(B)}, {f * sizeof(bf16)},
          {static_cast<uint32_t>(kDepth), static_cast<uint32_t>(kRows)}, true))
    return err;
  if (int err = sm90::encode_bf16_map<2>(
          &wmap, w_h, {4 * f, f}, {4 * f * sizeof(bf16)},
          {static_cast<uint32_t>(kUnits), static_cast<uint32_t>(kDepth)},
          false))
    return err;
  if (int err = static_cast<int>(cudaFuncSetAttribute(
          lstm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kFwdSmem))))
    return err;
  lstm_fwd_kernel<<<dim3(F / kUnits, (B + kRows - 1) / kRows),
                    kMmaThreads + 32, kFwdSmem, s>>>(
      hmap, wmap, static_cast<const bf16*>(x_proj),
      static_cast<const float*>(c), static_cast<const float*>(b),
      static_cast<bf16*>(h_out), static_cast<float*>(c_out),
      static_cast<float*>(gates_out), B, F);
  return static_cast<int>(cudaGetLastError());
}

// gates (B, 4F) activated, c_prev, c_new (B, F) fp32; dh (B, F) bf16
// (dh_bf16 = 1) or fp32; dc_new (B, F) fp32. Writes dgates (B, 4F) (the
// gradients of the pre-activations) and dc_prev (B, F) in fp32, db (4F,)
// fp32 (dgates summed over the rows) and, for bf16 dh, dx (B, 4F): dgates
// in bf16 (dx is null for fp32 dh). All pointers 16-byte aligned, F a
// multiple of 8.
extern "C" int lstm_cell_bwd(const void* gates, const void* c_prev,
                             const void* c_new, const void* dh,
                             const void* dc_new, void* dgates, void* dc_prev,
                             void* dx, void* db, int B, int F, int dh_bf16,
                             void* stream) {
  if (B <= 0 || F <= 0 || F % 8 || (dh_bf16 != 0) != (dx != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(kCluster * ((F + kStrip - 1) / kStrip));
  const float* g = static_cast<const float*>(gates);
  const float* cp = static_cast<const float*>(c_prev);
  const float* cn = static_cast<const float*>(c_new);
  const float* dcn = static_cast<const float*>(dc_new);
  float* dg = static_cast<float*>(dgates);
  float* dcp = static_cast<float*>(dc_prev);
  float* dbf = static_cast<float*>(db);
  if (dh_bf16)
    lstm_bwd_kernel<bf16><<<grid, kBwdThreads, 0, s>>>(
        g, cp, cn, static_cast<const bf16*>(dh), dcn, dg, dcp,
        static_cast<bf16*>(dx), dbf, B, F);
  else
    lstm_bwd_kernel<float><<<grid, kBwdThreads, 0, s>>>(
        g, cp, cn, static_cast<const float*>(dh), dcn, dg, dcp, nullptr, dbf,
        B, F);
  return static_cast<int>(cudaGetLastError());
}
