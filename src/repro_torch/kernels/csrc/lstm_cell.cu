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
// 227 KB, so here the grid tiles the batch rows by the hidden units instead:
// a block owns rows [r0, r0 + 32) and units [j0, j0 + 32) and accumulates
// the four gate columns of those units together, so the nonlinearities and
// the c update run in registers in the epilogue and the (B, 4F) gate
// pre-activations never reach device memory. The k loop over F stages a
// 32 x 32 tile of h and a 32 x 128 tile of W_h (the four 32-unit gate
// slices) in shared memory; each of the 4 warps runs mma.sync m16n8k16
// (bf16 in, fp32 accumulate) on a 16-row x (4 gates x 16 units) block,
// whose accumulator layout puts the four gates of one (row, unit) in the
// same thread. The fp32 variant runs the same tiles through CUDA-core FMAs
// at full fp32, as the reference's fp32 product. Ragged B and F are masked
// (F must be a multiple of 8, for 16-byte loads).
//
// Bound on the H100 at GNMT's shape (B 128, F 1024, bf16): bytes. The
// forward moves 11,026,432 B (13,123,584 with the gates), 0.0033 ms
// (0.0039 ms) at 3.35 TB/s, against 1.07 GFLOP, 0.0011 ms at 989 TFLOP/s:
// W_h is read again at every time step. Each W_h tile is read by B / 32
// blocks, from L2 after the first. A simple, correct first version: no
// cp.async or TMA double buffering, no wgmma, and W_h is not kept on chip
// across time steps (a persistent kernel could).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int BM = 32;  // batch rows a block
constexpr int BN = 32;  // hidden units a block (4 * BN gate columns)
constexpr int BK = 32;  // depth of one staged k tile

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Shared-memory row padding (16 bytes), against bank conflicts.
template <typename T>
__host__ __device__ constexpr int pad() {
  return 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// One warp: c[i] += A[m0:m0+16, 0:BK] . B[0:BK, n0+8i : n0+8i+8] for i < NT,
// A row-major (lda), B row-major (ldb), both in shared memory. Accumulator
// layout of mma.sync m16n8k16: lane (g = lane / 4, t = lane % 4) holds
// c[i][0..1] at row g, columns 2t and 2t + 1 of tile i, and c[i][2..3] at
// row g + 8.
template <typename T, int NT>
__device__ __forceinline__ void warp_mma(float (&c)[NT][4], const T* A,
                                         int lda, int m0, const T* B, int ldb,
                                         int n0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += 16) {
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(A + (m0 + g) * lda + k0 + 2 * t);
      a[1] = *reinterpret_cast<const uint32_t*>(A + (m0 + g + 8) * lda + k0 +
                                                2 * t);
      a[2] = *reinterpret_cast<const uint32_t*>(A + (m0 + g) * lda + k0 +
                                                2 * t + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(A + (m0 + g + 8) * lda + k0 +
                                                2 * t + 8);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int n = n0 + 8 * i + g;
        const int k = k0 + 2 * t;
        const uint32_t b0 = pack(B[k * ldb + n], B[(k + 1) * ldb + n]);
        const uint32_t b1 = pack(B[(k + 8) * ldb + n], B[(k + 9) * ldb + n]);
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      }
    }
  } else {
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
}

// Shared column s of the staged W_h tile (0 <= s < 4 * BN) holds global
// column gate * F + j0 + 16 * wcol + within, with wcol = s / 64 (the warp
// column), gate = (s / 16) % 4 and within = s % 16: each warp's 64
// contiguous columns are the four gates of its 16 units, 8-column tile
// i = 2 * gate + (unit / 8).
__device__ __forceinline__ int w_unit(int s) { return 16 * (s >> 6) + (s & 15); }
__device__ __forceinline__ int w_gate(int s) { return (s >> 4) & 3; }

// ---------------------------------------------------------------------------
// Forward: one block per (unit tile, row tile).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ h,
                const float* __restrict__ c, const T* __restrict__ w,
                const float* __restrict__ bias, T* __restrict__ h_out,
                float* __restrict__ c_out, float* __restrict__ gates_out,
                int B, int F) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int LDH = BK + pad<T>();
  constexpr int LDW = 4 * BN + pad<T>();
  __shared__ __align__(16)
      unsigned char smem[sizeof(T) * (BM * LDH + BK * LDW)];
  T* Hs = reinterpret_cast<T*>(smem);
  T* Ws = Hs + BM * LDH;

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
    warp_mma<T, 8>(acc, Hs, LDH, m0, Ws, LDW, 64 * wcol);
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
        pre[q] = (acc[2 * q + u][e] + to_float(xp[xr + q * F + j])) +
                 bias[q * F + j];
      const float ig = sigmoid(pre[0]), fg = sigmoid(pre[1]);
      const float gg = tanhf(pre[2]), og = sigmoid(pre[3]);
      const size_t o = static_cast<size_t>(row) * F + j;
      const float cn = fg * c[o] + ig * gg;
      store(h_out + o, og * tanhf(cn));
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
  const dim3 grid((F + BN - 1) / BN, (B + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    lstm_fwd_kernel<bf16><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(x_proj), static_cast<const bf16*>(h),
        static_cast<const float*>(c), static_cast<const bf16*>(w_h),
        static_cast<const float*>(b), static_cast<bf16*>(h_out),
        static_cast<float*>(c_out), static_cast<float*>(gates_out), B, F);
  else
    lstm_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x_proj), static_cast<const float*>(h),
        static_cast<const float*>(c), static_cast<const float*>(w_h),
        static_cast<const float*>(b), static_cast<float*>(h_out),
        static_cast<float*>(c_out), static_cast<float*>(gates_out), B, F);
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
