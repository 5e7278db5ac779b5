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
//
// Training. With an hs pointer the forward also writes the state entering
// every K-step chunk but the first (K a multiple of kT); the same kernel
// runs either way, so y and h do not move. mamba_scan_bwd_kernel, the
// port's own (the reference differentiates a chunked lax.scan with
// jax.grad), rebuilds each chunk from its boundary state and runs the
// reverse recurrence; see its comment. At Jamba's train shape (Bt 1, S
// 2048, Di 16384, N 16, bf16 u, K 16) it must move ~607 MB (0.181 ms)
// against 536,870,912 exponentials (0.128 ms): bytes bound it. This first
// version loads each 16-step tile synchronously and takes two exponentials
// an element (the rebuild and the reverse step).
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

// A lane's kP states of channel d into entry j of a (Bt, nj, Di, N) fp32
// array of states (the final h: nj = 1; the boundary states: one entry a
// K-step chunk boundary inside the sequence).
template <int kP>
__device__ __forceinline__ void store_state(float* out, const float (&h)[kP],
                                            int b, int j, int nj, int d,
                                            int Di, int N, int lane) {
  float* hd = out + ((static_cast<long long>(b) * nj + j) * Di + d) * N;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int n = lane * kP + p;
    if (n < N) hd[n] = h[p];
  }
}

// A channel belongs to kLanes neighbouring threads; lane l holds its states
// l * kP .. l * kP + kP - 1.
template <typename TU, int kLanes, int kP>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const TU* __restrict__ u, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, const float* __restrict__ Dv,
                  TU* __restrict__ y, float* __restrict__ h_out,
                  float* __restrict__ hs, int S, int Di, int N, int K,
                  long long sB_b, long long sB_t, long long sC_b,
                  long long sC_t) {
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
    // The state entering step t0 + kT, when that is a boundary of the
    // K-step chunks strictly inside the sequence (K a multiple of kT).
    if (hs != nullptr && (t0 + kT) % K == 0 && t0 + kT < S && d < Di)
      store_state(hs, h, b, (t0 + kT) / K - 1, (S - 1) / K, d, Di, N, lane);
  }
  if (n_chunks > 0) {
    __syncthreads();
    const int t0 = (n_chunks - 1) * kT;
    write_y(t0, S - t0);
  }
  if (d < Di) store_state(h_out, h, b, 0, 1, d, Di, N, lane);
}


// ---------------------------------------------------------------------------
// Backward: the port's own kernel (the reference differentiates its scan with
// jax.grad of ops._mamba_scan_jnp, a chunked, checkpointed lax.scan).
// ---------------------------------------------------------------------------
constexpr int kWarps = kThreads / 32;

// Sum over the kLanes lanes of a channel (xor butterfly: every lane ends
// with the same sum, in a fixed order).
template <int kLanes>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the 32 / kLanes channels of a warp, lane by lane (the same
// butterfly over the offsets kLanes .. 16).
template <int kLanes>
__device__ __forceinline__ float warp_channel_sum(float v) {
#pragma unroll
  for (int o = kLanes; o < 32; o <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A block owns kCh channels, every batch row in turn, and walks the K-step
// chunks from last to first, each in kT-step tiles from last to first. For a
// tile it rebuilds the state entering it from the chunk's boundary state
// (hs; zero for the first chunk), walking the chunk's earlier tiles forward,
// then keeps the tile's kT + 1 states in registers (hist, fully unrolled)
// and runs the reverse recurrence over it, with g = dL/dh:
//   g += C_t dy_t;               a = exp(dt_t A)
//   du_t = D dy_t + dt_t sum_n g B_t;   ddt_t = sum_n g (A a h_{t-1} + B_t u_t)
//   dA += g dt_t a h_{t-1};      dD += dy_t u_t      (in registers, all rows)
//   dB_t += g dt_t u_t;          dC_t += h_t dy_t    (summed over channels)
//   g *= a
// starting from the final state's cotangent dh (zero when null). The decay is
// the forward's own ex2(dt * A * log2 e), so the rebuilt states are bitwise
// the forward's. dB and dC are summed over a warp's channels by shuffles,
// over the block's warps in order through shared memory, and written as this
// block's partial; mamba_bc_reduce_kernel sums the partials in block order.
// No atomics: a rerun is bitwise equal.
template <typename TU, int kLanes, int kP>
__global__ void __launch_bounds__(kThreads)
mamba_scan_bwd_kernel(const TU* __restrict__ u, const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ Dv,
                      const float* __restrict__ hs, const TU* __restrict__ dy,
                      const float* __restrict__ dh, TU* __restrict__ du,
                      float* __restrict__ ddt, float* __restrict__ dA,
                      float* __restrict__ dD, float* __restrict__ part,
                      int Bt, int S, int Di, int N, int K, long long sB_b,
                      long long sB_t, long long sC_b, long long sC_t) {
  constexpr int kNP = kLanes * kP;
  constexpr int kCh = kThreads / kLanes;
  __shared__ float2 ud_s[kT][kCh];                      // (u, dt)
  __shared__ float dy_s[kT][kCh];
  __shared__ __align__(16) float B_s[kT][kNP];
  __shared__ __align__(16) float C_s[kT][kNP];
  __shared__ float2 out_s[kT][kCh];                     // (du, ddt)
  __shared__ float red_s[2][kT][kWarps][kNP];           // dB, dC a warp

  const int c0 = blockIdx.x * kCh;
  const int tid = threadIdx.x;
  const int cl = tid / kLanes;
  const int lane = tid % kLanes;
  const int warp = tid / 32;
  const int d = c0 + cl;
  const int n_blk = gridDim.x;

  float a2[kP], av[kP], dA_acc[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int n = lane * kP + p;
    av[p] = (d < Di && n < N) ? A[static_cast<long long>(d) * N + n] : 0.f;
    a2[p] = av[p] * kLog2e;
    dA_acc[p] = 0.f;
  }
  const float dd = d < Di ? Dv[d] : 0.f;
  float dD_acc = 0.f;
  const int n_chunks = (S + K - 1) / K;
  const int n_saved = S > 0 ? (S - 1) / K : 0;
  const long long SN = static_cast<long long>(S) * N;

  // The kT steps from t0 of row b into shared memory; zero past S, Di, N.
  auto stage = [&](int b, int t0) {
    __syncthreads();  // every read of the previous tiles is done
    for (int e = tid; e < kT * kCh; e += kThreads) {
      const int tt = e / kCh, c = e % kCh;
      float uv = 0.f, dv = 0.f, gv = 0.f;
      if (t0 + tt < S && c0 + c < Di) {
        const long long at =
            (static_cast<long long>(b) * S + t0 + tt) * Di + c0 + c;
        uv = to_float(u[at]);
        dv = dt[at];
        gv = to_float(dy[at]);
      }
      ud_s[tt][c] = make_float2(uv, dv);
      dy_s[tt][c] = gv;
    }
    for (int e = tid; e < kT * kNP; e += kThreads) {
      const int tt = e / kNP, n = e % kNP;
      const long long t = t0 + tt;
      float bv = 0.f, cv = 0.f;
      if (t < S && n < N) {
        bv = Bm[b * sB_b + t * sB_t + n];
        cv = Cm[b * sC_b + t * sC_t + n];
      }
      B_s[tt][n] = bv;
      C_s[tt][n] = cv;
    }
    __syncthreads();
  };

  for (int b = 0; b < Bt; ++b) {
    float g[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int n = lane * kP + p;
      g[p] = (dh != nullptr && d < Di && n < N)
                 ? dh[(static_cast<long long>(b) * Di + d) * N + n]
                 : 0.f;
    }
    for (int j = n_chunks - 1; j >= 0; --j) {
      const int cs = j * K;
      const int ce = S < cs + K ? S : cs + K;
      for (int t0 = cs + (ce - cs - 1) / kT * kT; t0 >= cs; t0 -= kT) {
        float hist[kT + 1][kP];
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          const int n = lane * kP + p;
          hist[0][p] =
              (j > 0 && d < Di && n < N)
                  ? hs[((static_cast<long long>(b) * n_saved + j - 1) * Di +
                        d) * N + n]
                  : 0.f;
        }
        // walk the chunk's earlier tiles to the state entering t0
        for (int t = cs; t < t0; t += kT) {
          stage(b, t);
#pragma unroll
          for (int i = 0; i < kT; ++i) {
            const float2 ud = ud_s[i][cl];
            const float dtu = ud.y * ud.x;
            float bv[kP];
            load_vec<kP>(&B_s[i][lane * kP], bv);
#pragma unroll
            for (int p = 0; p < kP; ++p)
              hist[0][p] = fmaf(ex2(ud.y * a2[p]), hist[0][p], dtu * bv[p]);
          }
        }
        stage(b, t0);
#pragma unroll
        for (int i = 0; i < kT; ++i) {
          const float2 ud = ud_s[i][cl];
          const float dtu = ud.y * ud.x;
          float bv[kP];
          load_vec<kP>(&B_s[i][lane * kP], bv);
#pragma unroll
          for (int p = 0; p < kP; ++p)
            hist[i + 1][p] = fmaf(ex2(ud.y * a2[p]), hist[i][p], dtu * bv[p]);
        }
        // the reverse recurrence over the tile (steps past S read zeros:
        // dy = dt = 0, so g, dA and dD do not move and nothing is written)
#pragma unroll
        for (int i = kT - 1; i >= 0; --i) {
          const float2 ud = ud_s[i][cl];
          const float u_t = ud.x, dt_t = ud.y, dy_t = dy_s[i][cl];
          float bv[kP], cv[kP], dbv[kP], dcv[kP];
          load_vec<kP>(&B_s[i][lane * kP], bv);
          load_vec<kP>(&C_s[i][lane * kP], cv);
          float sdu = 0.f, sdt = 0.f;
#pragma unroll
          for (int p = 0; p < kP; ++p) {
            g[p] = fmaf(cv[p], dy_t, g[p]);
            const float a = ex2(dt_t * a2[p]);
            const float ah = a * hist[i][p];
            sdu = fmaf(g[p], bv[p], sdu);
            sdt = fmaf(g[p], fmaf(av[p], ah, bv[p] * u_t), sdt);
            const float gdt = g[p] * dt_t;
            dA_acc[p] = fmaf(gdt, ah, dA_acc[p]);
            dbv[p] = gdt * u_t;
            dcv[p] = hist[i + 1][p] * dy_t;
            g[p] *= a;
          }
          sdu = lane_sum<kLanes>(sdu);
          sdt = lane_sum<kLanes>(sdt);
          if (lane == 0)
            out_s[i][cl] = make_float2(fmaf(dd, dy_t, dt_t * sdu), sdt);
          dD_acc = fmaf(dy_t, u_t, dD_acc);
#pragma unroll
          for (int p = 0; p < kP; ++p) {
            dbv[p] = warp_channel_sum<kLanes>(dbv[p]);
            dcv[p] = warp_channel_sum<kLanes>(dcv[p]);
          }
          if (tid % 32 < kLanes) {
#pragma unroll
            for (int p = 0; p < kP; ++p) {
              red_s[0][i][warp][lane * kP + p] = dbv[p];
              red_s[1][i][warp][lane * kP + p] = dcv[p];
            }
          }
        }
        __syncthreads();
        const int nt = S - t0 < kT ? S - t0 : kT;
        for (int e = tid; e < nt * kCh; e += kThreads) {
          const int tt = e / kCh, c = e % kCh;
          if (c0 + c < Di) {
            const long long at =
                (static_cast<long long>(b) * S + t0 + tt) * Di + c0 + c;
            store(du + at, out_s[tt][c].x);
            ddt[at] = out_s[tt][c].y;
          }
        }
        for (int e = tid; e < 2 * nt * kNP; e += kThreads) {
          const int q = e / (nt * kNP), r = e % (nt * kNP);
          const int tt = r / kNP, n = r % kNP;
          if (n < N) {
            float s = red_s[q][tt][0][n];
#pragma unroll
            for (int w = 1; w < kWarps; ++w) s += red_s[q][tt][w][n];
            part[((static_cast<long long>(q) * n_blk + blockIdx.x) * Bt + b) *
                     SN + static_cast<long long>(t0 + tt) * N + n] = s;
          }
        }
        // the next stage() starts with __syncthreads: these reads of out_s
        // and red_s end before the next tile writes them
      }
    }
  }
  if (d < Di) {
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int n = lane * kP + p;
      if (n < N) dA[static_cast<long long>(d) * N + n] = dA_acc[p];
    }
    if (lane == 0) dD[d] = dD_acc;
  }
}

// out[q][e] = sum over the n_blk blocks' partials part[q][k][e], in block
// order (q = 0: dB, 1: dC; e over Bt * S * N).
__global__ void mamba_bc_reduce_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, int n_blk,
                                       long long M) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= 2 * M) return;
  const long long q = e / M, r = e % M;
  const float* p = part + q * n_blk * M + r;
  float s = p[0];
  for (int k = 1; k < n_blk; ++k) s += p[k * M];
  out[e] = s;
}

template <typename TU, int kLanes, int kP>
void launch(const void* u, const void* dt, const void* A, const void* B,
            const void* C, const void* D, void* y, void* h, void* hs, int Bt,
            int S, int Di, int N, int K, long long sB_b, long long sB_t,
            long long sC_b, long long sC_t, cudaStream_t s) {
  constexpr int kCh = kThreads / kLanes;
  const dim3 grid((Di + kCh - 1) / kCh, Bt);
  mamba_scan_kernel<TU, kLanes, kP><<<grid, kThreads, 0, s>>>(
      static_cast<const TU*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(D),
      static_cast<TU*>(y), static_cast<float*>(h), static_cast<float*>(hs),
      S, Di, N, K, sB_b, sB_t, sC_b, sC_t);
}

template <typename TU>
void launch_n(const void* u, const void* dt, const void* A, const void* B,
              const void* C, const void* D, void* y, void* h, void* hs,
              int Bt, int S, int Di, int N, int K, long long sB_b,
              long long sB_t, long long sC_b, long long sC_t,
              cudaStream_t s) {
#define MAMBA_LAUNCH(L, P)                                                \
  launch<TU, L, P>(u, dt, A, B, C, D, y, h, hs, Bt, S, Di, N, K, sB_b,    \
                   sB_t, sC_b, sC_t, s)
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

// The backward's lanes a channel: at most 4 states a lane, so the tile's
// kT + 1 states of a lane fit in registers.
int bwd_lanes(int N) { return N <= 16 ? 4 : N <= 32 ? 8 : 16; }

template <typename TU, int kLanes, int kP>
void launch_bwd(const void* u, const void* dt, const void* A, const void* B,
                const void* C, const void* D, const void* hs, const void* dy,
                const void* dh, void* du, void* ddt, void* dA, void* dD,
                void* part, int Bt, int S, int Di, int N, int K,
                long long sB_b, long long sB_t, long long sC_b,
                long long sC_t, cudaStream_t s) {
  constexpr int kCh = kThreads / kLanes;
  mamba_scan_bwd_kernel<TU, kLanes, kP>
      <<<(Di + kCh - 1) / kCh, kThreads, 0, s>>>(
          static_cast<const TU*>(u), static_cast<const float*>(dt),
          static_cast<const float*>(A), static_cast<const float*>(B),
          static_cast<const float*>(C), static_cast<const float*>(D),
          static_cast<const float*>(hs), static_cast<const TU*>(dy),
          static_cast<const float*>(dh), static_cast<TU*>(du),
          static_cast<float*>(ddt), static_cast<float*>(dA),
          static_cast<float*>(dD), static_cast<float*>(part), Bt, S, Di, N,
          K, sB_b, sB_t, sC_b, sC_t);
}

template <typename TU>
void launch_bwd_n(const void* u, const void* dt, const void* A,
                  const void* B, const void* C, const void* D,
                  const void* hs, const void* dy, const void* dh, void* du,
                  void* ddt, void* dA, void* dD, void* part, int Bt, int S,
                  int Di, int N, int K, long long sB_b, long long sB_t,
                  long long sC_b, long long sC_t, cudaStream_t s) {
#define MAMBA_BWD(L, P)                                                    \
  launch_bwd<TU, L, P>(u, dt, A, B, C, D, hs, dy, dh, du, ddt, dA, dD,     \
                       part, Bt, S, Di, N, K, sB_b, sB_t, sC_b, sC_t, s)
  if (N <= 4)
    MAMBA_BWD(4, 1);
  else if (N <= 8)
    MAMBA_BWD(4, 2);
  else if (N <= 16)
    MAMBA_BWD(4, 4);
  else if (N <= 32)
    MAMBA_BWD(8, 4);
  else
    MAMBA_BWD(16, 4);
#undef MAMBA_BWD
}

}  // namespace

// u, y: (Bt, S, Di) contiguous, bf16 (u_bf16 = 1) or fp32; dt: (Bt, S, Di)
// contiguous fp32; A: (Di, N) contiguous fp32; B, C: fp32 with element
// (b, t, n) at b * s*_b + t * s*_t + n; D: (Di,) fp32; h: (Bt, Di, N) fp32
// out. hs: null, or (Bt, (S - 1) / K, Di, N) fp32 out, the state after
// steps K - 1, 2K - 1, ... (the boundaries of the K-step chunks inside the
// sequence), K a positive multiple of 16; without hs the launch is the
// same kernel and y and h are bitwise the same. 1 <= N <= 64.
extern "C" int mamba_scan(const void* u, const void* dt, const void* A,
                          const void* B, const void* C, const void* D,
                          void* y, void* h, void* hs, int Bt, int S, int Di,
                          int N, int K, long long sB_b, long long sB_t,
                          long long sC_b, long long sC_t, int u_bf16,
                          void* stream) {
  if (Bt <= 0 || S < 0 || Di <= 0 || N <= 0 || N > kMaxN || Bt > 65535 ||
      (hs != nullptr && (K <= 0 || K % kT != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (hs == nullptr) K = kT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u_bf16)
    launch_n<bf16>(u, dt, A, B, C, D, y, h, hs, Bt, S, Di, N, K, sB_b, sB_t,
                   sC_b, sC_t, s);
  else
    launch_n<float>(u, dt, A, B, C, D, y, h, hs, Bt, S, Di, N, K, sB_b, sB_t,
                    sC_b, sC_t, s);
  return static_cast<int>(cudaGetLastError());
}

// Channels a block of the backward owns at N states: the partials' count is
// ceil(Di / this).
extern "C" int mamba_scan_bwd_channels(int N) {
  return kThreads / bwd_lanes(N);
}

// The backward from the forward's boundary states. Inputs as mamba_scan's,
// plus hs ((Bt, (S - 1) / K, Di, N) fp32, from the forward with the same K),
// dy ((Bt, S, Di) contiguous, u's dtype) and dh (null, or (Bt, Di, N) fp32:
// the final state's cotangent). Out: du (u's dtype) and ddt ((Bt, S, Di)
// fp32), dA ((Di, N)), dD ((Di,)), dBC ((2, Bt, S, N): dB then dC), all
// fp32; part is scratch of 2 * ceil(Di / mamba_scan_bwd_channels(N)) * Bt *
// S * N floats. Two launches (the scan, then the partials' sum).
extern "C" int mamba_scan_bwd(const void* u, const void* dt, const void* A,
                              const void* B, const void* C, const void* D,
                              const void* hs, const void* dy, const void* dh,
                              void* du, void* ddt, void* dA, void* dBC,
                              void* dD, void* part, int Bt, int S, int Di,
                              int N, int K, long long sB_b, long long sB_t,
                              long long sC_b, long long sC_t, int u_bf16,
                              void* stream) {
  if (Bt <= 0 || S < 0 || Di <= 0 || N <= 0 || N > kMaxN || K <= 0 ||
      K % kT != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u_bf16)
    launch_bwd_n<bf16>(u, dt, A, B, C, D, hs, dy, dh, du, ddt, dA, dD, part,
                       Bt, S, Di, N, K, sB_b, sB_t, sC_b, sC_t, s);
  else
    launch_bwd_n<float>(u, dt, A, B, C, D, hs, dy, dh, du, ddt, dA, dD,
                        part, Bt, S, Di, N, K, sB_b, sB_t, sC_b, sC_t, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long M = static_cast<long long>(Bt) * S * N;
  if (M > 0) {
    const int n_blk = (Di + mamba_scan_bwd_channels(N) - 1) /
                      mamba_scan_bwd_channels(N);
    const int threads = 256;
    mamba_bc_reduce_kernel<<<static_cast<unsigned>((2 * M + threads - 1) /
                                                   threads),
                             threads, 0, s>>>(static_cast<const float*>(part),
                                              static_cast<float*>(dBC), n_blk,
                                              M);
  }
  return static_cast<int>(cudaGetLastError());
}
