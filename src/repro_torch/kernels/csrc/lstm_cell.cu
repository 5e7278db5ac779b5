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
// (dx_proj, db, dh_prev and dW_h follow from dgates outside the kernel).
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
#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
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
// Backward of the cell-local part: one thread per (row, unit).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
lstm_bwd_kernel(const float* __restrict__ gates,
                const float* __restrict__ c_prev,
                const float* __restrict__ c_new, const T* __restrict__ dh,
                const float* __restrict__ dc_new, float* __restrict__ dgates,
                float* __restrict__ dc_prev, int B, int F) {
  const size_t n = static_cast<size_t>(B) * F;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       idx < n; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t row = idx / F, j = idx % F;
    const size_t gr = row * 4 * static_cast<size_t>(F) + j;
    const float ig = gates[gr], fg = gates[gr + F];
    const float gg = gates[gr + 2 * F], og = gates[gr + 3 * F];
    const float tc = tanhf(c_new[idx]);
    const float dhv = to_float(dh[idx]);
    const float dc = dc_new[idx] + dhv * og * (1.f - tc * tc);
    dgates[gr] = dc * gg * (ig * (1.f - ig));
    dgates[gr + F] = dc * c_prev[idx] * (fg * (1.f - fg));
    dgates[gr + 2 * F] = dc * ig * (1.f - gg * gg);
    dgates[gr + 3 * F] = dhv * tc * (og * (1.f - og));
    dc_prev[idx] = dc * fg;
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
// (dh_bf16 = 1) or fp32; dc_new (B, F) fp32. Writes dgates
// (B, 4F) (gradients of the pre-activations) and dc_prev (B, F), fp32.
extern "C" int lstm_cell_bwd(const void* gates, const void* c_prev,
                             const void* c_new, const void* dh,
                             const void* dc_new, void* dgates, void* dc_prev,
                             int B, int F, int dh_bf16, void* stream) {
  if (B <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(B) * F;
  const int blocks = static_cast<int>((n + 255) / 256 < 132 * 16
                                          ? (n + 255) / 256
                                          : 132 * 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh_bf16)
    lstm_bwd_kernel<bf16><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(gates), static_cast<const float*>(c_prev),
        static_cast<const float*>(c_new), static_cast<const bf16*>(dh),
        static_cast<const float*>(dc_new), static_cast<float*>(dgates),
        static_cast<float*>(dc_prev), B, F);
  else
    lstm_bwd_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(gates), static_cast<const float*>(c_prev),
        static_cast<const float*>(c_new), static_cast<const float*>(dh),
        static_cast<const float*>(dc_new), static_cast<float*>(dgates),
        static_cast<float*>(dc_prev), B, F);
  return static_cast<int>(cudaGetLastError());
}
