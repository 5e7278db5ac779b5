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
// belongs to a group of kLanes = 4 neighbouring threads of a warp (8 for
// N > 16), lane l holding the kP = N / kLanes (a power of two, 4 at N 16)
// neighbouring states l * kP .. l * kP + kP - 1, so a step's B and C reach
// a lane as one 16-byte shared load. A block of 128 threads owns 32
// channels of one batch row and walks time in chunks of kT = 16 steps:
//   - staging: the next chunk's u, dt (coalesced along Di), B_t and C_t
//     (shared by every channel of the row) are loaded into registers while
//     the current chunk runs and stored to shared memory after it (any
//     alignment and stride);
//   - the recurrence: the whole chunk is unrolled (steps past S read zeros,
//     and ex2(0) = 1 exactly leaves h as it was). A step's path to the next
//     is one FFMA a state (h = da * h + dtu * B); the decay is
//     da = exp2(dt * A'), A' = A * log2(e) scaled once into registers, one
//     FMUL and one ex2.approx.ftz (MUFU.EX2) a (step, channel, state). Each
//     lane keeps its h . C partial for each of kLanes steps (a window), and
//     the group reduces the window at once by a butterfly that halves the
//     values at each of its log2(kLanes) shuffle stages, so lane l ends with
//     the whole sum of the window's step l (kLanes - 1 shuffles a window,
//     not log2(kLanes) a step). The sum's order is fixed: a lane's states in
//     order, then lanes l and l ^ 2, then l ^ 1 (tests/test_torch_mamba.py
//     writes it out in PyTorch);
//   - y goes through shared memory and out coalesced along Di.
// B and C come in with their own batch and time strides (the model passes
// column slices of one projection), the last axis contiguous. States past N
// read A = B = C = 0 and stay 0.
//
// What holds it at ~2.8x its bound (chip_smoke.py phase 2 with design
// variants in place; PERF.md § 6): the exponentials and the shared-memory
// loads share the SM's MIO pipe. A (step, channel, state) costs one
// MUFU.EX2 (8 cycles a warp on an SM quarter) plus the shared bytes its lane
// receives: its share of (u, dt), 8 B over kP states, and B and C, 8 B,
// which every channel's lanes receive again. Two or four channels a thread
// would share B and C, but leave too few warps to hide the latency:
// measured at Bt 1, 4 lanes of 4 states a channel (65,536 threads) beat 8
// lanes of 2, and 2 or 4 channels a thread.
//
// Parallelism. Bt * Di * kLanes threads: at Jamba's prefill (Bt 1, Di 16384)
// 512 blocks of 128 threads, 3.9 on each of the 132 SMs.
//
// Bound on the H100 at Jamba's prefill shape (Bt 1, S 256, Di 16384, N 16,
// bf16 u): bytes 35,749,888 B (u and y bf16; dt, A, B, C, D and h fp32),
// 0.0107 ms at 3.35 TB/s, against 67,108,864 exponentials at 16 a clock on
// each SM's special-function units, about 0.016 ms at 1.98 GHz: the
// exponentials bound it. No atomics (a rerun is bitwise equal), no host
// synchronisation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kT = 16;                           // time steps a chunk
constexpr int kMaxN = 64;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// 2^x on the special-function unit; ex2(+-0) = 1 exactly.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// K neighbouring floats from shared memory, in 8- or 16-byte loads.
template <int K>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[K]) {
  if constexpr (K == 1) {
    v[0] = p[0];
  } else if constexpr (K == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  }
}

// A channel belongs to kLanes neighbouring threads; lane l holds its states
// l * kP .. l * kP + kP - 1.
template <typename TU, int kLanes, int kP>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const TU* __restrict__ u, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, const float* __restrict__ Dv,
                  TU* __restrict__ y, float* __restrict__ h_out, int S,
                  int Di, int N, long long sB_b, long long sB_t,
                  long long sC_b, long long sC_t) {
  constexpr int kNP = kLanes * kP;                      // padded states
  constexpr int kCh = kThreads / kLanes;                // channels a block
  constexpr int kUD = kT * kCh / kThreads;              // u, dt a thread stages
  constexpr int kBC = (kT * kNP + kThreads - 1) / kThreads;  // B, C ditto
  static_assert(kUD * kThreads == kT * kCh, "whole u, dt shares");
  static_assert(kT % kLanes == 0, "a chunk is whole windows");
  __shared__ float2 ud_s[kT][kCh];                      // (u, dt)
  __shared__ __align__(16) float B_s[kT][kNP];
  __shared__ __align__(16) float C_s[kT][kNP];
  // rows of y_s kYRow apart (= 32 / kLanes mod 32): the kLanes rows a
  // window writes for a warp's 32 / kLanes channels fall in distinct banks
  constexpr int kYRow = kCh + (32 / kLanes - kCh % 32 + 32) % 32;
  __shared__ float y_s[kT][kYRow];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kCh;
  const int tid = threadIdx.x;
  const int cl = tid / kLanes;       // the thread's channel in the block
  const int lane = tid % kLanes;
  const int d = c0 + cl;

  float a2[kP], h[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int n = lane * kP + p;
    a2[p] = (d < Di && n < N) ? A[static_cast<long long>(d) * N + n] * kLog2e
                              : 0.f;
    h[p] = 0.f;
  }
  const float dd = d < Di ? Dv[d] : 0.f;

  const long long row = static_cast<long long>(b) * S;  // (b, t=0) of u, dt
  const float* Bb = Bm + b * sB_b;
  const float* Cb = Cm + b * sC_b;

  // The next chunk's inputs, held in registers while a chunk runs; zero
  // past S, Di and N.
  TU ur[kUD];
  float dr[kUD], br[kBC], cr[kBC];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int j = 0; j < kUD; ++j) {
      const int e = tid + j * kThreads, tt = e / kCh, c = e % kCh;
      const long long at = (row + t0 + tt) * Di + c0 + c;
      ur[j] = zero<TU>();
      dr[j] = 0.f;
      if (t0 + tt < S && c0 + c < Di) {
        ur[j] = u[at];
        dr[j] = dt[at];
      }
    }
#pragma unroll
    for (int j = 0; j < kBC; ++j) {
      const int e = tid + j * kThreads, tt = e / kNP, n = e % kNP;
      const long long t = t0 + tt;
      br[j] = 0.f;
      cr[j] = 0.f;
      if (tt < kT && t < S && n < N) {
        br[j] = Bb[t * sB_t + n];
        cr[j] = Cb[t * sC_t + n];
      }
    }
  };
  auto write_y = [&](int t0, int nt) {
    for (int e = tid; e < nt * kCh; e += kThreads) {
      const int tt = e / kCh, c = e % kCh;
      if (c0 + c < Di) store(y + (row + t0 + tt) * Di + c0 + c, y_s[tt][c]);
    }
  };

  const int n_chunks = (S + kT - 1) / kT;
  fetch(0);
  for (int k = 0; k < n_chunks; ++k) {
    const int t0 = k * kT;
    const int nt = S - t0 < kT ? S - t0 : kT;
    __syncthreads();  // the previous chunk's shared reads and y_s are done
    if (k > 0) write_y(t0 - kT, kT);
#pragma unroll
    for (int j = 0; j < kUD; ++j) {
      const int e = tid + j * kThreads;
      ud_s[e / kCh][e % kCh] = make_float2(to_float(ur[j]), dr[j]);
    }
#pragma unroll
    for (int j = 0; j < kBC; ++j) {
      const int e = tid + j * kThreads;
      if (e < kT * kNP) {
        B_s[e / kNP][e % kNP] = br[j];
        C_s[e / kNP][e % kNP] = cr[j];
      }
    }
    __syncthreads();
    if (k + 1 < n_chunks) fetch(t0 + kT);  // in flight during the chunk

    // The whole chunk unrolled, so one window's butterfly overlaps the
    // next one's exponentials; steps past S read zeros and leave h exact.
#pragma unroll
    for (int w = 0; w < kT / kLanes; ++w) {
      float part[kLanes];
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        const int tt = w * kLanes + j;
        const float2 ud = ud_s[tt][cl];
        const float dtu = ud.y * ud.x;
        float bv[kP], cv[kP];
        load_vec<kP>(&B_s[tt][lane * kP], bv);
        load_vec<kP>(&C_s[tt][lane * kP], cv);
        float s = 0.f;
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          h[p] = fmaf(ex2(ud.y * a2[p]), h[p], dtu * bv[p]);
          s = p == 0 ? h[p] * cv[p] : fmaf(h[p], cv[p], s);
        }
        part[j] = s;
      }
      // Butterfly over the group's lanes: at offset o each lane keeps the
      // half of its o * 2 values that its bit o selects and adds its
      // partner's; lane l ends with the sum of step w * kLanes + l.
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) {
        const bool upper = lane & o;
#pragma unroll
        for (int j = 0; j < o; ++j) {
          const float send = upper ? part[j] : part[j + o];
          const float keep = upper ? part[j + o] : part[j];
          part[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      const int tt = w * kLanes + lane;
      if (tt < nt) y_s[tt][cl] = fmaf(dd, ud_s[tt][cl].x, part[0]);
    }
  }
  if (n_chunks > 0) {
    __syncthreads();
    const int t0 = (n_chunks - 1) * kT;
    write_y(t0, S - t0);
  }
  if (d < Di) {
    float* hd = h_out + (static_cast<long long>(b) * Di + d) * N;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int n = lane * kP + p;
      if (n < N) hd[n] = h[p];
    }
  }
}

template <typename TU, int kLanes, int kP>
void launch(const void* u, const void* dt, const void* A, const void* B,
            const void* C, const void* D, void* y, void* h, int Bt, int S,
            int Di, int N, long long sB_b, long long sB_t, long long sC_b,
            long long sC_t, cudaStream_t s) {
  constexpr int kCh = kThreads / kLanes;
  const dim3 grid((Di + kCh - 1) / kCh, Bt);
  mamba_scan_kernel<TU, kLanes, kP><<<grid, kThreads, 0, s>>>(
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
#define MAMBA_LAUNCH(L, P)                                                   \
  launch<TU, L, P>(u, dt, A, B, C, D, y, h, Bt, S, Di, N, sB_b, sB_t, sC_b, \
                   sC_t, s)
  if (N <= 4)
    MAMBA_LAUNCH(4, 1);
  else if (N <= 8)
    MAMBA_LAUNCH(4, 2);
  else if (N <= 16)
    MAMBA_LAUNCH(4, 4);
  else if (N <= 32)
    MAMBA_LAUNCH(8, 4);
  else
    MAMBA_LAUNCH(8, 8);
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
