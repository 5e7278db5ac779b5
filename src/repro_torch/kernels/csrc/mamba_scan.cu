// Mamba S6 selective scan for Hopper (sm_90a), plain C entry point.
//
// Replaces the TPU kernel repro/kernels/mamba.py:mamba_scan (body _kernel at
// mamba.py:22, pl.pallas_call at :58). For every batch row b and channel d of
// Di it runs, from h = 0, over t = 0 .. S-1, in fp32,
//   h[n] = exp(dt[t,d] * A[d,n]) * h[n] + (dt[t,d] * u[t,d]) * B[t,n]
//   y[t,d] = sum_n h[n] * C[t,n] + D[d] * u[t,d]
// and writes y in u's dtype (rounded once, from fp32) and the final h in
// fp32.
//
// Design. The TPU kernel keeps a (block_d, N) state tile in VMEM for the whole
// time loop and streams time steps through it; its docstring names the CUDA
// selective_scan as the model. Here the state lives in registers: a channel
// belongs to a group of kLanes = 4 neighbouring threads, each holding
// kP = ceil(N / 4) (rounded to a power of two) of its N states, so
// h . C is a per-lane partial sum and two shuffles. A block of 128 threads
// owns 32 channels of one batch row and walks time in chunks of kT = 32
// steps: it stages u and dt of its channels (coalesced along Di), B_t and
// C_t (shared by every channel of the row) in shared memory, runs the chunk,
// and writes the chunk's y back coalesced from shared memory. B and C come
// in with their own batch and time strides (the model passes column slices
// of one projection), the last axis contiguous. States past N (when N is
// not a multiple of 4) read B = C = A = 0 and stay 0.
//
// Parallelism. Bt * Di is the only parallel dimension: at Jamba's prefill
// (Bt 1, Di 16384) the grid is 512 blocks of 128 threads, 65,536 threads,
// about 3.9 blocks (15.5 warps of 64) on each of the 132 SMs, so occupancy
// is at most 25%; the loop's latency is hidden by the independent channels
// and by the exponentials of a step not depending on h.
//
// Bound on the H100 at Jamba's prefill shape (Bt 1, S 256, Di 16384, N 16,
// bf16 u): bytes 35,749,888 B (u and y bf16; dt, A, B, C, D and h fp32),
// 0.0107 ms at 3.35 TB/s, against 67,108,864 exponentials at 16 a clock on
// each SM's special-function units, about 0.016 ms at 1.98 GHz: the
// exponentials bound it. No atomics (a rerun is bitwise equal), no host
// synchronisation, no cp.async or TMA double buffering: a simple, correct
// first version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;                        // threads a channel
constexpr int kChannels = 32;                    // channels a block
constexpr int kThreads = kLanes * kChannels;     // 128
constexpr int kT = 32;                           // time steps a chunk
constexpr int kMaxN = 64;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// kP states a lane: lane l of a channel's group holds states p * 4 + l.
template <typename TU, int kP>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const TU* __restrict__ u, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, const float* __restrict__ Dv,
                  TU* __restrict__ y, float* __restrict__ h_out, int S,
                  int Di, int N, long long sB_b, long long sB_t,
                  long long sC_b, long long sC_t) {
  __shared__ float u_s[kT][kChannels];
  __shared__ float dt_s[kT][kChannels];
  __shared__ float y_s[kT][kChannels];
  __shared__ float B_s[kT][kLanes * kP];
  __shared__ float C_s[kT][kLanes * kP];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x;
  const int cl = tid / kLanes;       // channel within the block
  const int lane = tid % kLanes;     // lane within the channel's group
  const int d = c0 + cl;
  const bool live = d < Di;
  constexpr int kNP = kLanes * kP;   // padded state count

  float a[kP], h[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int n = p * kLanes + lane;
    a[p] = (live && n < N) ? A[static_cast<long long>(d) * N + n] : 0.f;
    h[p] = 0.f;
  }
  const float dd = live ? Dv[d] : 0.f;

  const long long row = static_cast<long long>(b) * S;  // (b, t=0) of u, dt
  const float* Bb = Bm + b * sB_b;
  const float* Cb = Cm + b * sC_b;

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int nt = S - t0 < kT ? S - t0 : kT;
    __syncthreads();  // the previous chunk's y_s is written out
    for (int i = tid; i < nt * kChannels; i += kThreads) {
      const int tt = i / kChannels, c = i % kChannels;
      const long long at = (row + t0 + tt) * Di + c0 + c;
      const bool ok = c0 + c < Di;
      u_s[tt][c] = ok ? to_float(u[at]) : 0.f;
      dt_s[tt][c] = ok ? dt[at] : 0.f;
    }
    for (int i = tid; i < nt * kNP; i += kThreads) {
      const int tt = i / kNP, n = i % kNP;
      const long long t = t0 + tt;
      B_s[tt][n] = n < N ? Bb[t * sB_t + n] : 0.f;
      C_s[tt][n] = n < N ? Cb[t * sC_t + n] : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float u_t = u_s[tt][cl];
      const float dt_t = dt_s[tt][cl];
      const float dtu = dt_t * u_t;
      float part = 0.f;
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int n = p * kLanes + lane;
        const float da = expf(dt_t * a[p]);
        h[p] = fmaf(da, h[p], dtu * B_s[tt][n]);
        part = fmaf(h[p], C_s[tt][n], part);
      }
      // the group's 4 lanes are neighbours in one warp
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (lane == 0) y_s[tt][cl] = fmaf(dd, u_t, part);
    }
    __syncthreads();
    for (int i = tid; i < nt * kChannels; i += kThreads) {
      const int tt = i / kChannels, c = i % kChannels;
      if (c0 + c < Di)
        store(y + (row + t0 + tt) * Di + c0 + c, y_s[tt][c]);
    }
  }
  if (live) {
    float* hd = h_out + (static_cast<long long>(b) * Di + d) * N;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int n = p * kLanes + lane;
      if (n < N) hd[n] = h[p];
    }
  }
}

template <typename TU, int kP>
void launch(const void* u, const void* dt, const void* A, const void* B,
            const void* C, const void* D, void* y, void* h, int Bt, int S,
            int Di, int N, long long sB_b, long long sB_t, long long sC_b,
            long long sC_t, cudaStream_t s) {
  const dim3 grid((Di + kChannels - 1) / kChannels, Bt);
  mamba_scan_kernel<TU, kP><<<grid, kThreads, 0, s>>>(
      static_cast<const TU*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(D),
      static_cast<TU*>(y), static_cast<float*>(h), S, Di, N, sB_b, sB_t,
      sC_b, sC_t);
}

template <typename TU>
void launch_n(const void* u, const void* dt, const void* A, const void* B,
              const void* C, const void* D, void* y, void* h, int Bt, int S,
              int Di, int N, long long sB_b, long long sB_t, long long sC_b,
              long long sC_t, cudaStream_t s) {
  const int per_lane = (N + kLanes - 1) / kLanes;
#define MAMBA_LAUNCH(P)                                                      \
  launch<TU, P>(u, dt, A, B, C, D, y, h, Bt, S, Di, N, sB_b, sB_t, sC_b,     \
                sC_t, s)
  if (per_lane <= 1)
    MAMBA_LAUNCH(1);
  else if (per_lane <= 2)
    MAMBA_LAUNCH(2);
  else if (per_lane <= 4)
    MAMBA_LAUNCH(4);
  else if (per_lane <= 8)
    MAMBA_LAUNCH(8);
  else
    MAMBA_LAUNCH(16);
#undef MAMBA_LAUNCH
}

}  // namespace

// u, y: (Bt, S, Di) contiguous, bf16 (u_bf16 = 1) or fp32; dt: (Bt, S, Di)
// contiguous fp32; A: (Di, N) contiguous fp32; B, C: fp32 with element
// (b, t, n) at b * s*_b + t * s*_t + n; D: (Di,) fp32; h: (Bt, Di, N) fp32
// out. 1 <= N <= 64.
extern "C" int mamba_scan(const void* u, const void* dt, const void* A,
                          const void* B, const void* C, const void* D,
                          void* y, void* h, int Bt, int S, int Di, int N,
                          long long sB_b, long long sB_t, long long sC_b,
                          long long sC_t, int u_bf16, void* stream) {
  if (Bt <= 0 || S < 0 || Di <= 0 || N <= 0 || N > kMaxN || Bt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u_bf16)
    launch_n<bf16>(u, dt, A, B, C, D, y, h, Bt, S, Di, N, sB_b, sB_t, sC_b,
                   sC_t, s);
  else
    launch_n<float>(u, dt, A, B, C, D, y, h, Bt, S, Di, N, sB_b, sB_t, sC_b,
                    sC_t, s);
  return static_cast<int>(cudaGetLastError());
}
