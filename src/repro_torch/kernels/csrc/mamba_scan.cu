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
//     and decay(0, A) = 1 exactly leaves h as it was). A step's path to the
//     next is one FFMA a state (h = da * h + dtu * B); the decay is
//     da = decay(dt, A), CUDA's expf of the rounded dt * A: bitwise the
//     plain version's torch.exp on the card (one MUFU.EX2 and 8 FMA-pipe
//     instructions; ex2.approx of a pre-scaled A, 2 instructions, drifted
//     4.7e-5 from it over 2048 steps, past the reference's atol). Each
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
// What holds it at ~3.8x its bound (chip_smoke.py phase `mamba`; PERF.md
// § 6): the exponentials and the shared-memory loads share the SM's MIO
// pipe, and expf adds 8 FMA-pipe instructions an element (0.0472 ms at S
// 256 with ex2.approx, 0.0612 with expf, on an NVIDIA H100 80GB HBM3 at
// 700 W). Two or four channels a thread would share B and C, but leave too
// few warps to hide the latency: measured at Bt 1, 4 lanes of 4 states a
// channel (65,536 threads) beat 8 lanes of 2, and 2 or 4 channels a thread.
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
// against 536,870,912 exponentials (0.128 ms): bytes bound it. It takes
// ~1.28-1.30 ms there (7.1x the bound; the first version, synchronous
// tiles, two exponentials an element, 512 blocks in two waves, took 2.43
// ms, and 2.58 ms with expf), on an NVIDIA H100 80GB HBM3 at 700 W.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kT = 16;                           // time steps a chunk
constexpr int kMaxN = 64;

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

// The decay exp(dt * A): CUDA's expf (within 2 ulp; the function PyTorch's
// exp runs on the card) of the rounded product, never contracted, so it is
// bitwise the plain version's torch.exp(dt * A) there. Both scans and the
// backward's rebuild take it from here, so the rebuilt states are bitwise
// the forward's. decay(0, A) = 1 exactly: a step past S leaves h as it was.
__device__ __forceinline__ float decay(float dt, float a) {
  return expf(__fmul_rn(dt, a));
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

  float av[kP], h[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int n = lane * kP + p;
    av[p] = (d < Di && n < N) ? A[static_cast<long long>(d) * N + n] : 0.f;
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
          h[p] = fmaf(decay(ud.y, av[p]), h[p], dtu * bv[p]);
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
constexpr int kBwdThreads = 256;  // 2 blocks an SM at 128 registers
constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }

// Sums kV values over the lanes whose ids differ in the bits kHi, kHi / 2,
// ..., kLo (powers of two), in a fixed order. Going down from kHi, a lane
// that holds more than one value keeps the half its bit selects (the upper
// half when set) and adds its partner's copy of that half; one shuffle a
// value sent. Once it holds one value it adds its partner's. A lane ends
// with kOut sums, v[r] that of the values first at index base(lane) + r;
// lanes that differ only in the bits of kDup hold the same sums.
template <int kV, int kHi, int kLo>
struct Fly {
  static constexpr int kStages = ilog2(kHi / kLo) + 1;
  static constexpr int kHalve = kStages < ilog2(kV) ? kStages : ilog2(kV);
  static constexpr int kOut = kV >> kHalve;
  static constexpr int kDup =
      kHalve < kStages ? 2 * (kHi >> kHalve) - kLo : 0;

  __device__ static __forceinline__ void run(float (&v)[kV], int lane) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      const int o = kHi >> s;
      if (s < kHalve) {
        const int half = kV >> (s + 1);
        const bool upper = lane & o;
#pragma unroll
        for (int j = 0; j < half; ++j) {
          const float send = upper ? v[j] : v[j + half];
          const float keep = upper ? v[j + half] : v[j];
          v[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      } else {
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
      }
    }
  }
  __device__ static __forceinline__ int base(int lane) {
    int b = 0;
#pragma unroll
    for (int s = 0; s < kHalve; ++s)
      if (lane & (kHi >> s)) b += kV >> (s + 1);
    return b;
  }
};

template <int K>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[K]) {
  if constexpr (K == 1) {
    p[0] = v[0];
  } else if constexpr (K == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int q = 0; q < K / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

// How the backward stages each input (see copy_gran): 16- or 4-byte
// cp.async pieces, or 0, element by element.
struct BwdGran {
  int u, dt, dy, b, c, hs;
};

// Stages rows x cols elements of T at dst (cols * sizeof(T) a multiple of
// 16), row r from src + r * rs: its first vc elements when r < vr, zeros
// elsewhere, and all zeros when src is null. Pieces of gran bytes by
// cp.async (safe: a valid global address for pieces that read nothing), or
// with gran 0 element by element, synchronously.
template <typename T>
__device__ __forceinline__ void stage_box(T* dst, const T* src, long long rs,
                                          int rows, int cols, int vr, int vc,
                                          int gran, const void* safe,
                                          int tid) {
  if (gran == 0) {
    for (int e = tid; e < rows * cols; e += kBwdThreads) {
      const int r = e / cols, k = e % cols;
      dst[e] = (src != nullptr && r < vr && k < vc) ? src[r * rs + k]
                                                    : zero<T>();
    }
    return;
  }
  // per and pieces are powers of two
  const int per = gran / static_cast<int>(sizeof(T));
  const int lg = __ffs(cols / per) - 1;
  for (int e = tid; e < rows << lg; e += kBwdThreads) {
    const int r = e >> lg, k = (e & ((1 << lg) - 1)) * per;
    int n = (src != nullptr && r < vr) ? vc - k : 0;
    n = n < 0 ? 0 : n > per ? per : n;
    const void* from = n > 0 ? static_cast<const void*>(src + r * rs + k)
                             : safe;
    const int bytes = n * static_cast<int>(sizeof(T));
    if (gran == 16)
      sm90::cp_async16(dst + r * cols + k, from, bytes);
    else
      sm90::cp_async4(dst + r * cols + k, from, bytes);
  }
}

// Shared memory of the backward (byte offsets, each a multiple of 16): a
// ring of two stages, each one tile's u, dy, dt (kT x kCh), B, C (kT x
// kNP) and the boundary state entering it (kCh x kNP); the tile's decays
// (kT x threads x kP); each warp's dB and dC sums (kT x warps x 2 kNP).
template <typename TU, int kLanes, int kP>
struct BwdLayout {
  static constexpr int kNP = kLanes * kP;
  static constexpr int kCh = kBwdThreads / kLanes;
  static constexpr int kWarps = kBwdThreads / 32;
  static constexpr int kU = 0;
  static constexpr int kDy = kU + kT * kCh * static_cast<int>(sizeof(TU));
  static constexpr int kDt = kDy + kT * kCh * static_cast<int>(sizeof(TU));
  static constexpr int kB = kDt + kT * kCh * 4;
  static constexpr int kC = kB + kT * kNP * 4;
  static constexpr int kH = kC + kT * kNP * 4;
  static constexpr int kStage = kH + kCh * kNP * 4;
  static constexpr int kDec = 2 * kStage;
  static constexpr int kRed = kDec + kT * kBwdThreads * kP * 4;
  static constexpr int kBytes = kRed + kT * kWarps * 2 * kNP * 4;
};

// Where a block is in its walk: row b, chunk j, the tile m of the chunk
// being differentiated, and the tile w staged for it (w < m: a tile walked
// to reach m's first state; w == m: m itself).
struct Visit {
  int b, j, m, w;
};

// A block of 256 threads owns kCh channels (64 at N 16: 4 lanes of 4
// states), every batch row in turn, and walks the K-step chunks from last
// to first, each in kT-step tiles from last to first. For a tile it takes
// the state entering it from the chunk's boundary state (hs; zero for the
// first chunk), walking the chunk's earlier tiles forward (never at K = kT,
// the train path), then rebuilds the tile's kT + 1 states in registers
// (hist, fully unrolled), keeping each step's decays in shared memory (one
// exponential an element), and runs the reverse recurrence over it, with
// g = dL/dh:
//   g += C_t dy_t;               a = exp(dt_t A)   (the rebuild's)
//   du_t = D dy_t + dt_t sum_n g B_t;   ddt_t = sum_n g (A a h_{t-1} + B_t u_t)
//   dA += g dt_t a h_{t-1};      dD += dy_t u_t      (in registers, all rows)
//   dB_t += g dt_t u_t;          dC_t += h_t dy_t    (summed over channels)
//   g *= a
// starting from the final state's cotangent dh (zero when null). The decay is
// the forward's decay(), so the rebuilt states are bitwise the forward's.
// The next tile's inputs and boundary state are in flight (cp.async into
// the other stage of the ring) while a tile runs. dB and dC are summed over
// a warp's channels by a halving butterfly (7 shuffles a step, one finished
// sum a lane), over the block's warps in order through shared memory, and
// written as this block's partial; du and ddt over a channel's lanes by the
// same butterfly once every kW steps, staged over the u and dt they were
// made from and written out coalesced with the partials. A launch at the
// train shape is 256 blocks, 2 an SM at 128 registers and 108 KB of shared
// memory each: one wave. mamba_bc_reduce_kernel sums the partials in block
// order. No atomics: a rerun is bitwise equal.
//
// What holds it at ~7x its bound (chip_smoke.py phase `mamba` with
// knockout variants in place; PERF.md § 6): no one unit. The warps issue about a third of the cycles; of ~1.59 ms in
// a 128-thread design, the dB/dC butterfly took 0.22, expf 0.16, the du/ddt
// butterfly 0.10, the partials 0.06 and the kept decays 0.02. Blocks of 512
// threads, 2 lanes of 8 states (255 registers, spilling), half-tile states
// rebuilt from the kept decays, and dC summed in the rebuild all measured
// slower.
template <typename TU, int kLanes, int kP>
__global__ void __launch_bounds__(kBwdThreads, 2)
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
                      long long sB_t, long long sC_b, long long sC_t,
                      BwdGran gr) {
  using L = BwdLayout<TU, kLanes, kP>;
  constexpr int kNP = L::kNP, kCh = L::kCh, kWarps = L::kWarps;
  constexpr int kW = 2;                         // steps a du/ddt butterfly
  using ChFly = Fly<2 * kP, 16, kLanes>;        // dB, dC over channels
  using LnFly = Fly<2 * kW, kLanes / 2, 1>;     // du, ddt over lanes
  extern __shared__ __align__(16) unsigned char smem[];
  float* dec_s = reinterpret_cast<float*>(smem + L::kDec);
  float* red_s = reinterpret_cast<float*>(smem + L::kRed);

  const int c0 = blockIdx.x * kCh;
  const int tid = threadIdx.x;
  const int cl = tid / kLanes, ln = tid % kLanes;
  const int lane = tid % 32, warp = tid / 32;
  const int d = c0 + cl;
  const int vc = Di - c0 < kCh ? Di - c0 : kCh;   // channels inside Di
  const int n_blk = gridDim.x;

  float av[kP], dA_acc[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int n = ln * kP + p;
    av[p] = (d < Di && n < N) ? A[static_cast<long long>(d) * N + n] : 0.f;
    dA_acc[p] = 0.f;
  }
  const float dd = d < Di ? Dv[d] : 0.f;
  float dD_acc = 0.f;
  const int n_chunks = (S + K - 1) / K;
  const int n_saved = S > 0 ? (S - 1) / K : 0;
  const long long SN = static_cast<long long>(S) * N;

  auto tiles = [&](int j) {
    const int cs = j * K, ce = S < cs + K ? S : cs + K;
    return (ce - cs + kT - 1) / kT;
  };
  auto advance = [&](Visit v) {
    if (v.w < v.m) {
      ++v.w;
    } else if (v.m > 0) {
      --v.m;
      v.w = 0;
    } else if (v.j > 0) {
      --v.j;
      v.m = tiles(v.j) - 1;
      v.w = 0;
    } else {
      ++v.b;
      v.j = n_chunks - 1;
      v.m = tiles(v.j) - 1;
      v.w = 0;
    }
    return v;
  };
  // The tile of visit v into stage st (zero past S, Di and N); with w = 0
  // also the boundary state entering chunk j.
  auto issue = [&](const Visit& v, int st) {
    unsigned char* sb = smem + st * L::kStage;
    const int t = v.j * K + v.w * kT;
    const int vr = S - t < kT ? S - t : kT;
    const long long at = (static_cast<long long>(v.b) * S + t) * Di + c0;
    stage_box(reinterpret_cast<TU*>(sb + L::kU), u + at, Di, kT, kCh,
                   vr, vc, gr.u, dt, tid);
    stage_box(reinterpret_cast<TU*>(sb + L::kDy), dy + at, Di, kT, kCh,
                   vr, vc, gr.dy, dt, tid);
    stage_box(reinterpret_cast<float*>(sb + L::kDt), dt + at, Di, kT,
                   kCh, vr, vc, gr.dt, dt, tid);
    stage_box(reinterpret_cast<float*>(sb + L::kB),
                   Bm + v.b * sB_b + t * sB_t, sB_t, kT, kNP, vr, N, gr.b,
                   dt, tid);
    stage_box(reinterpret_cast<float*>(sb + L::kC),
                   Cm + v.b * sC_b + t * sC_t, sC_t, kT, kNP, vr, N, gr.c,
                   dt, tid);
    if (v.w == 0)
      stage_box(
          reinterpret_cast<float*>(sb + L::kH),
          v.j > 0 ? hs + ((static_cast<long long>(v.b) * n_saved + v.j - 1) *
                              Di + c0) * N
                  : nullptr,
          N, kCh, kNP, vc, N, gr.hs, dt, tid);
  };

  float g[kP];
  Visit cur{0, n_chunks - 1, n_chunks > 0 ? tiles(n_chunks - 1) - 1 : 0, 0};
  int st = 0;
  if (S > 0) {
    issue(cur, 0);
    sm90::cp_async_commit();
  }
  for (bool more = S > 0; more;) {
    sm90::cp_async_wait<0>();
    // cur's stage has landed for every thread, and every read of the other
    // stage and of red_s by the previous visit is done
    __syncthreads();
    {
      const Visit nxt = advance(cur);
      more = nxt.b < Bt;
      if (more) {
        issue(nxt, st ^ 1);
        sm90::cp_async_commit();
      }
    }
    unsigned char* sb = smem + st * L::kStage;
    TU* u_s = reinterpret_cast<TU*>(sb + L::kU);      // du once read
    const TU* dy_s = reinterpret_cast<const TU*>(sb + L::kDy);
    float* dt_s = reinterpret_cast<float*>(sb + L::kDt);  // ddt once read
    const float* B_s = reinterpret_cast<const float*>(sb + L::kB);
    const float* C_s = reinterpret_cast<const float*>(sb + L::kC);
    if (cur.j == n_chunks - 1 && cur.m == tiles(cur.j) - 1 && cur.w == 0) {
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int n = ln * kP + p;
        g[p] = (dh != nullptr && d < Di && n < N)
                   ? dh[(static_cast<long long>(cur.b) * Di + d) * N + n]
                   : 0.f;
      }
    }
    // the state entering the tile: the boundary state at w = 0, else where
    // the walk left it
    float h0[kP];
    load_vec<kP>(reinterpret_cast<const float*>(sb + L::kH) + cl * kNP + ln * kP,
                 h0);
    if (cur.w < cur.m) {  // walk to tile m's first state
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        const float u_t = to_float(u_s[i * kCh + cl]);
        const float dt_t = dt_s[i * kCh + cl];
        const float dtu = dt_t * u_t;
        float bv[kP];
        load_vec<kP>(&B_s[i * kNP + ln * kP], bv);
#pragma unroll
        for (int p = 0; p < kP; ++p)
          h0[p] = fmaf(decay(dt_t, av[p]), h0[p], dtu * bv[p]);
      }
      // for the next visit, whose stage stages no boundary state
      store_vec<kP>(reinterpret_cast<float*>(smem + (st ^ 1) * L::kStage +
                                             L::kH) + cl * kNP + ln * kP,
                    h0);
    } else {
      const int t0 = cur.j * K + cur.m * kT;
      // the rebuild: the tile's states in registers, its decays in dec_s
      // (steps past S read dt = 0: decay 1, h unchanged)
      float hist[kT + 1][kP];
#pragma unroll
      for (int p = 0; p < kP; ++p) hist[0][p] = h0[p];
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        const float u_t = to_float(u_s[i * kCh + cl]);
        const float dt_t = dt_s[i * kCh + cl];
        const float dtu = dt_t * u_t;
        float bv[kP], a[kP];
        load_vec<kP>(&B_s[i * kNP + ln * kP], bv);
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          a[p] = decay(dt_t, av[p]);
          hist[i + 1][p] = fmaf(a[p], hist[i][p], dtu * bv[p]);
        }
        store_vec<kP>(&dec_s[(i * kBwdThreads + tid) * kP], a);
      }
      // the reverse recurrence, kW steps at a time (steps past S read
      // zeros: g, dA and dD do not move; their outputs are not written)
#pragma unroll
      for (int w = kT / kW - 1; w >= 0; --w) {
        float x[2 * kW];  // the window's du, ddt sums: x[2 jj + q]
#pragma unroll
        for (int jj = kW - 1; jj >= 0; --jj) {
          const int i = w * kW + jj;
          const float u_t = to_float(u_s[i * kCh + cl]);
          const float dt_t = dt_s[i * kCh + cl];
          const float dy_t = to_float(dy_s[i * kCh + cl]);
          const float dtu = dt_t * u_t;
          float bv[kP], cv[kP], a[kP], v[2 * kP];
          load_vec<kP>(&B_s[i * kNP + ln * kP], bv);
          load_vec<kP>(&C_s[i * kNP + ln * kP], cv);
          load_vec<kP>(&dec_s[(i * kBwdThreads + tid) * kP], a);
          // ddt_t = sum_n A g a h_{t-1} + u_t sum_n g B_t; dA and ddt share
          // g a h_{t-1}
          float sdu = 0.f, sah = 0.f;
#pragma unroll
          for (int p = 0; p < kP; ++p) {
            g[p] = fmaf(cv[p], dy_t, g[p]);
            const float gah = g[p] * (a[p] * hist[i][p]);
            sdu = fmaf(g[p], bv[p], sdu);
            sah = fmaf(av[p], gah, sah);
            dA_acc[p] = fmaf(dt_t, gah, dA_acc[p]);
            v[p] = g[p] * dtu;                  // dB_t
            v[kP + p] = hist[i + 1][p] * dy_t;  // dC_t
            g[p] *= a[p];
          }
          x[2 * jj] = sdu;
          x[2 * jj + 1] = fmaf(u_t, sdu, sah);
          dD_acc = fmaf(dy_t, u_t, dD_acc);
          ChFly::run(v, lane);
          if ((lane & ChFly::kDup) == 0) {
            const int base = ChFly::base(lane);
#pragma unroll
            for (int r = 0; r < ChFly::kOut; ++r) {
              const int q = (base + r) / kP, n = ln * kP + (base + r) % kP;
              red_s[(i * kWarps + warp) * 2 * kNP + q * kNP + n] = v[r];
            }
          }
        }
        LnFly::run(x, ln);
        // du_t = D dy_t + dt_t sum_n g B_t over u_t's slot and ddt_t over
        // dt_t's, once every lane of the channel has read them
        const int base = LnFly::base(ln);
        float out[LnFly::kOut];
#pragma unroll
        for (int r = 0; r < LnFly::kOut; ++r) {
          const int i = w * kW + (base + r) / 2;
          out[r] = (base + r) % 2 ? x[r]
                                  : fmaf(dd, to_float(dy_s[i * kCh + cl]),
                                         dt_s[i * kCh + cl] * x[r]);
        }
        __syncwarp();
        if ((ln & LnFly::kDup) == 0) {
#pragma unroll
          for (int r = 0; r < LnFly::kOut; ++r) {
            const int i = w * kW + (base + r) / 2;
            if ((base + r) % 2)
              dt_s[i * kCh + cl] = out[r];
            else
              store(&u_s[i * kCh + cl], out[r]);
          }
        }
      }
      __syncthreads();  // every warp's dB, dC, du and ddt are in shared memory
      const int nt = S - t0 < kT ? S - t0 : kT;
      for (int e = tid; e < nt * kCh; e += kBwdThreads) {
        const int tt = e / kCh, c = e % kCh;
        if (c < vc) {
          const long long at =
              (static_cast<long long>(cur.b) * S + t0 + tt) * Di + c0 + c;
          du[at] = u_s[e];
          ddt[at] = dt_s[e];
        }
      }
      for (int e = tid; e < nt * 2 * kNP; e += kBwdThreads) {
        const int i = e / (2 * kNP), slot = e % (2 * kNP);
        const int q = slot / kNP, n = slot % kNP;
        if (n < N) {
          const float* r = red_s + i * kWarps * 2 * kNP + slot;
          float s = r[0];
#pragma unroll
          for (int w = 1; w < kWarps; ++w) s += r[w * 2 * kNP];
          part[((static_cast<long long>(q) * n_blk + blockIdx.x) * Bt +
                cur.b) * SN + static_cast<long long>(t0 + i) * N + n] = s;
        }
      }
    }
    cur = advance(cur);
    st ^= 1;
  }
  if (d < Di) {
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int n = ln * kP + p;
      if (n < N) dA[static_cast<long long>(d) * N + n] = dA_acc[p];
    }
    if (ln == 0) dD[d] = dD_acc;
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
#pragma unroll 8  // loads in flight together; the sum's order is unchanged
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

template <typename T>
struct Type {
  using type = T;
};
template <int V>
using Int = std::integral_constant<int, V>;

// fn(Type<TU>, Int<kLanes>, Int<kP>) for u's dtype and N states.
template <typename Fn>
cudaError_t bwd_dispatch(int N, int u_bf16, Fn&& fn) {
  auto by_n = [&](auto tu) {
    if (N <= 4) return fn(tu, Int<4>{}, Int<1>{});
    if (N <= 8) return fn(tu, Int<4>{}, Int<2>{});
    if (N <= 16) return fn(tu, Int<4>{}, Int<4>{});
    if (N <= 32) return fn(tu, Int<8>{}, Int<4>{});
    return fn(tu, Int<16>{}, Int<4>{});
  };
  return u_bf16 ? by_n(Type<bf16>{}) : by_n(Type<float>{});
}

// The widest cp.async piece (16 or 4 bytes; 0: element by element) that
// every address of an array of esize-byte elements allows: its base and
// its strides s0, s1 in elements. Column offsets are whole 16-byte pieces.
int copy_gran(const void* p, int esize, long long s0, long long s1) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  auto all = [&](long long m) {
    return a % m == 0 && s0 * esize % m == 0 && s1 * esize % m == 0;
  };
  return all(16) ? 16 : all(4) ? 4 : 0;
}

// The kernel's dynamic shared memory (above the default 48 KB) and a
// carveout that leaves room for every resident block.
template <typename TU, int kLanes, int kP>
cudaError_t bwd_attributes() {
  auto k = mamba_scan_bwd_kernel<TU, kLanes, kP>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BwdLayout<TU, kLanes, kP>::kBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  return e;
}

}  // namespace

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

// Partial dB/dC sums the backward writes for Di channels of N states, one
// a block: its part scratch holds 2 * this * Bt * S * N floats.
extern "C" int mamba_scan_bwd_partials(int Di, int N) {
  if (Di <= 0 || N <= 0 || N > kMaxN) return 0;
  const int ch = kBwdThreads / bwd_lanes(N);
  return (Di + ch - 1) / ch;
}

// What decides the backward's waves for N states and u's dtype: its
// registers a thread, resident blocks an SM, threads a block and shared
// bytes a block (a launch takes ceil(partials / (blocks an SM x SMs))).
extern "C" int mamba_scan_bwd_info(int N, int u_bf16, int* regs,
                                   int* blocks_per_sm, int* threads,
                                   int* smem_bytes) {
  if (N <= 0 || N > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(bwd_dispatch(
      N, u_bf16, [&](auto tu, auto l, auto p) {
        using TU = typename decltype(tu)::type;
        constexpr int kL = decltype(l)::value, kP = decltype(p)::value;
        auto k = mamba_scan_bwd_kernel<TU, kL, kP>;
        cudaError_t e = bwd_attributes<TU, kL, kP>();
        cudaFuncAttributes fa{};
        if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, k);
        const int bytes = BwdLayout<TU, kL, kP>::kBytes;
        if (e == cudaSuccess)
          e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              blocks_per_sm, k, kBwdThreads, bytes);
        *regs = fa.numRegs;
        *threads = kBwdThreads;
        *smem_bytes = bytes;
        return e;
      }));
}

// The backward from the forward's boundary states. Inputs as mamba_scan's,
// plus hs ((Bt, (S - 1) / K, Di, N) fp32, from the forward with the same K),
// dy ((Bt, S, Di) contiguous, u's dtype) and dh (null, or (Bt, Di, N) fp32:
// the final state's cotangent). Out: du (u's dtype) and ddt ((Bt, S, Di)
// fp32), dA ((Di, N)), dD ((Di,)), dBC ((2, Bt, S, N): dB then dC), all
// fp32; part is scratch of 2 * mamba_scan_bwd_partials(Di, N) * Bt * S * N
// floats. Two launches (the scan, then the partials' sum).
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
  const int n_blk = mamba_scan_bwd_partials(Di, N);
  cudaError_t err = bwd_dispatch(
      N, u_bf16, [&](auto tu, auto l, auto p) {
        using TU = typename decltype(tu)::type;
        constexpr int kL = decltype(l)::value, kP = decltype(p)::value;
        cudaError_t e = bwd_attributes<TU, kL, kP>();
        if (e != cudaSuccess) return e;
        const int esz = static_cast<int>(sizeof(TU));
        const BwdGran gr{copy_gran(u, esz, Di, Di),
                         copy_gran(dt, 4, Di, Di),
                         copy_gran(dy, esz, Di, Di),
                         copy_gran(B, 4, sB_t, sB_b),
                         copy_gran(C, 4, sC_t, sC_b),
                         copy_gran(hs, 4, N, static_cast<long long>(Di) * N)};
        mamba_scan_bwd_kernel<TU, kL, kP>
            <<<n_blk, kBwdThreads, BwdLayout<TU, kL, kP>::kBytes, s>>>(
                static_cast<const TU*>(u), static_cast<const float*>(dt),
                static_cast<const float*>(A), static_cast<const float*>(B),
                static_cast<const float*>(C), static_cast<const float*>(D),
                static_cast<const float*>(hs), static_cast<const TU*>(dy),
                static_cast<const float*>(dh), static_cast<TU*>(du),
                static_cast<float*>(ddt), static_cast<float*>(dA),
                static_cast<float*>(dD), static_cast<float*>(part), Bt, S,
                Di, N, K, sB_b, sB_t, sC_b, sC_t, gr);
        return cudaGetLastError();
      });
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long M = static_cast<long long>(Bt) * S * N;
  if (M > 0) {
    const int threads = 256;
    mamba_bc_reduce_kernel<<<static_cast<unsigned>((2 * M + threads - 1) /
                                                   threads),
                             threads, 0, s>>>(static_cast<const float*>(part),
                                              static_cast<float*>(dBC), n_blk,
                                              M);
  }
  return static_cast<int>(cudaGetLastError());
}
