// Mamba-1 selective scan forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `selective_scan_fwd` (body `_scan_kernel`) in
// src/repro/kernels/mamba_scan/kernel.py. It computes the same function,
// per batch row and channel c with an N-wide f32 state h:
//   h_t = exp(dt_t * A[c]) * h_{t-1} + (dt_t * x_t) * B_t
//   y_t = <h_t, C_t> + D[c] * x_t
// from h0, returning y (in x's type) and h_last = h_L (f32). Any L and di:
// the ragged last time tile and channel block are masked (the TPU kernel
// asserts L % chunk == 0; the reference's plain version takes any L).
//
// Layout: x, dt (Bt,L,di); B, C (Bt,L,N); each addressed through its own
// (batch, time) strides with the last dim contiguous, so B and C are read
// straight out of the x_proj output they are slices of. A (di,N), D (di,),
// h0 and h_last (Bt,di,N) and y (Bt,L,di) are contiguous.
//
// What bounds it: every (t, c, n) needs one exponential, Bt*L*di*N of them
// (201 M at the serve path's prefill, Bt=4, L=384, di=8192, N=16), which at
// the special-function units' 16 per clock per SM is ~48 us on an H100;
// the bytes (x, dt and y dominate, ~106 MB) take ~32 us at 3.35 TB/s. So
// the bound is the exponentials, with the bytes close behind.
//
// Design. The TPU's sequential chunk grid axis with its state in VMEM
// scratch becomes a loop over time inside each block, and the state's N
// columns are split across P neighbouring lanes (P = 2 for bf16, 4 for
// f32): a block of 128 threads owns 128/P channels of one batch row, each
// lane N/P of a channel's state columns and their rows of A (pre-scaled by
// log2 e, so each exponential is one ex2), in f32 registers. Each step's y
// is a tree: the lane's N/P products summed pairwise, then xor-shuffles
// across the P lanes. Every exponential of a step is independent of the
// state, and the 32-step tile loop is unrolled, so the exponentials run
// ahead of the dependent multiply-add chain. More lanes per channel give
// more resident warps but repeat each step's fixed work (the x and dt
// reads, the shuffles, the y write) on every lane: on an H100, P = 2
// (16 warps per SM at the serve shape) beat P = 4 (31) and P = 8 (62)
// (PERF.md).
//
// Time tiles of 32 steps of x, dt, B and C are staged in shared memory
// with cp.async, double-buffered: the next tile's copies are in flight
// while the current one is computed. Where every base is 16-B aligned and
// every stride is a multiple of 16 B (the serve path: B and C are 32-B
// rows at offsets 512 and 544 B of a 576-B x_proj row), each copy moves
// 16 B; otherwise (odd N, misaligned slices) one element at a time, with
// plain loads. Rows past L are zero-filled: dt = 0 and x = 0 leave the
// state unchanged, so the recurrence needs no mask. B and C are converted
// to f32 once per tile; y is staged and written back one tile at a time.
//
// Wide states (N > 16, `ss_fwd_wide_kernel`). Each lane keeps what the
// lanes above keep at N = 16 (8 state columns for bf16, 4 for f32), and
// the lanes per channel grow with N, P = 4 .. 32 (a power of two), so y's
// xor-shuffle tree spans them; N is read at run time and only P is a
// template argument. Past one warp (N above 256 for bf16, 128 for f32) the
// state is cut into groups of 32 lanes' columns, a grid axis: each group's
// block writes its f32 partial of <h_t, C_t> to a workspace, and
// `ss_fwd_combine_kernel` adds the groups in order, then D x_t once, and
// rounds to x's type once, so the arithmetic stays the reference's. B and
// C stay in x's type in shared memory and are converted as they are read.
// N <= 16 keeps the kernel above.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 128;
constexpr int TT = 32;          // timesteps per staged tile
constexpr int MAX_N = 16;       // widest state of ss_fwd_kernel
constexpr int MAX_LANES = 32;   // lanes per channel of the wide kernel
constexpr int MAX_GRID = 65535; // batch rows (grid y) and state groups (z)
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MIN_BLOCKS = 4;   // resident blocks the registers must allow

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* D;
  const float* h0;
  void* y;
  float* h_last;
  int L, di;
  long long x_b, x_t, dt_b, dt_t, B_b, B_t, C_b, C_t;  // element strides
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16-B copy into shared memory; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

// Lanes sharing one channel's state: 2 for bf16. f32 keeps 4: with 2, a
// block's tiles pass the 48 KB of shared memory it may hold statically.
template <typename T>
constexpr int kParts = sizeof(T) == 2 ? 2 : 4;

template <int N, int P, typename T>
struct Tile {
  static constexpr int CH = THREADS / P;     // channels per block
  static constexpr int NP = (N + P - 1) / P; // state columns per lane
  static constexpr int NPAD = NP * P;
  T x[2][TT][CH];
  float dt[2][TT][CH];
  T bc[2][TT][2 * N];            // B_t then C_t, as copied
  float Bf[TT][NPAD], Cf[TT][NPAD];
  T y[TT][CH];
};

// Issue the copies of time tile [t0, t0 + TT) into buffer `buf`.
template <int N, int P, typename T>
__device__ __forceinline__ void stage(Tile<N, P, T>& s, int buf, const Args& a,
                                      long long b, int c0, int t0, bool vec) {
  using S = Tile<N, P, T>;
  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.B);
  const T* Cm = static_cast<const T*>(a.C);
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int XE = 16 / sizeof(T);             // elements per copy
    constexpr int XC = S::CH / XE, DC = S::CH / 4; // copies per row
    // copies per B (C) row; only taken when N * sizeof(T) is a multiple
    // of 16 (can_vec), 1 keeps the unused instantiations well-formed
    constexpr int BC = N * sizeof(T) >= 16 ? N * sizeof(T) / 16 : 1;
    for (int i = tid; i < TT * (XC + DC + 2 * BC); i += THREADS) {
      int t, j;
      if (i < TT * XC) {
        t = i / XC; j = i - t * XC;
        const int c = c0 + j * XE;
        const bool ok = t0 + t < a.L && c < a.di;
        cp16(&s.x[buf][t][j * XE],
             ok ? x + b * a.x_b + (t0 + t) * a.x_t + c : x, ok ? 16 : 0);
      } else if (i < TT * (XC + DC)) {
        const int k = i - TT * XC;
        t = k / DC; j = k - t * DC;
        const int c = c0 + j * 4;
        const bool ok = t0 + t < a.L && c < a.di;
        cp16(&s.dt[buf][t][j * 4],
             ok ? a.dt + b * a.dt_b + (t0 + t) * a.dt_t + c : a.dt,
             ok ? 16 : 0);
      } else {
        const int k = i - TT * (XC + DC);
        t = k / (2 * BC); j = k - t * 2 * BC;
        const bool ok = t0 + t < a.L;
        const T* src = j < BC ? Bm + b * a.B_b + (t0 + t) * a.B_t + j * XE
                              : Cm + b * a.C_b + (t0 + t) * a.C_t
                                  + (j - BC) * XE;
        cp16(&s.bc[buf][t][j * XE], ok ? src : Bm, ok ? 16 : 0);
      }
    }
  } else {
    const T zero = T(0.f);
    for (int i = tid; i < TT * S::CH; i += THREADS) {
      const int t = i / S::CH, j = i - t * S::CH;
      const int c = c0 + j;
      const bool ok = t0 + t < a.L && c < a.di;
      s.x[buf][t][j] = ok ? x[b * a.x_b + (t0 + t) * a.x_t + c] : zero;
      s.dt[buf][t][j] = ok ? a.dt[b * a.dt_b + (t0 + t) * a.dt_t + c] : 0.f;
    }
    for (int i = tid; i < TT * 2 * N; i += THREADS) {
      const int t = i / (2 * N), n = i - t * 2 * N;
      const bool ok = t0 + t < a.L;
      s.bc[buf][t][n] = !ok ? zero
          : n < N ? Bm[b * a.B_b + (t0 + t) * a.B_t + n]
                  : Cm[b * a.C_b + (t0 + t) * a.C_t + n - N];
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N, int P, typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ss_fwd_kernel(const Args a, int vec) {
  using S = Tile<N, P, T>;
  constexpr int NP = S::NP;
  __shared__ __align__(16) S s;

  const long long b = blockIdx.y;
  const int tid = threadIdx.x;
  const int cl = tid / P, part = tid % P;
  const int c0 = blockIdx.x * S::CH;
  const int c = c0 + cl;
  const bool live = c < a.di;

  // this lane's state columns part*NP .. part*NP + NP - 1 (those >= N stay 0)
  float h[NP], a2[NP];
  float Dc = 0.f;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int n = part * NP + i;
    const bool on = live && n < N;
    h[i] = on ? a.h0[(b * a.di + c) * N + n] : 0.f;
    a2[i] = on ? a.A[(long long)c * N + n] * LOG2E : 0.f;
  }
  if (live) Dc = a.D[c];

  const int ntiles = (a.L + TT - 1) / TT;
  stage(s, 0, a, b, c0, 0, vec);
  for (int k = 0; k < ntiles; ++k) {
    const int cur = k & 1, t0 = k * TT;
    if (k + 1 < ntiles) {
      stage(s, cur ^ 1, a, b, c0, t0 + TT, vec);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();             // tile k has landed
    for (int i = tid; i < TT * S::NPAD; i += THREADS) {
      const int t = i / S::NPAD, n = i - t * S::NPAD;
      s.Bf[t][n] = n < N ? to_f32(s.bc[cur][t][n]) : 0.f;
      s.Cf[t][n] = n < N ? to_f32(s.bc[cur][t][N + n]) : 0.f;
    }
    __syncthreads();             // B and C of tile k are in f32

#pragma unroll
    for (int t = 0; t < TT; ++t) {
      const float dv = s.dt[cur][t][cl];
      const float xv = to_f32(s.x[cur][t][cl]);
      const float dx = dv * xv;
      const float* Bt = &s.Bf[t][part * NP];
      const float* Ct = &s.Cf[t][part * NP];
      float prod[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        h[i] = fmaf(fast_exp2(dv * a2[i]), h[i], dx * Bt[i]);
        prod[i] = h[i] * Ct[i];
      }
#pragma unroll
      for (int w = 1; w < NP; w *= 2)      // pairwise: a tree, not a chain
#pragma unroll
        for (int i = 0; i + w < NP; i += 2 * w) prod[i] += prod[i + w];
      float acc = prod[0];
#pragma unroll
      for (int off = P / 2; off >= 1; off /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (part == t % P) from_f32(&s.y[t][cl], acc + Dc * xv);
    }
    __syncthreads();             // the y tile is complete

    T* y = static_cast<T*>(a.y);
    const int nt = min(TT, a.L - t0);
    for (int i = tid; i < nt * S::CH; i += THREADS) {
      const int t = i / S::CH, j = i - t * S::CH;
      if (c0 + j < a.di) y[(b * a.L + t0 + t) * a.di + c0 + j] = s.y[t][j];
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int n = part * NP + i;
      if (n < N) a.h_last[(b * a.di + c) * N + n] = h[i];
    }
  }
}

template <typename T, int N = 1>
cudaError_t launch(int n, int Bt, const Args& a, int vec, cudaStream_t st) {
  if (n == N) {
    constexpr int P = kParts<T>;
    dim3 grid((a.di + Tile<N, P, T>::CH - 1) / Tile<N, P, T>::CH, Bt);
    ss_fwd_kernel<N, P, T><<<grid, THREADS, 0, st>>>(a, vec);
    return cudaGetLastError();
  }
  if constexpr (N < MAX_N) {
    return launch<T, N + 1>(n, Bt, a, vec, st);
  } else {
    return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Wide states: N > MAX_N (see the note at the top).
// ---------------------------------------------------------------------------
template <typename T>
constexpr int kCols = sizeof(T) == 2 ? 8 : 4;   // state columns per lane

template <int P, typename T>
struct Wide {
  static constexpr int NP = kCols<T>;
  static constexpr int NG = P * NP;              // state columns per group
  static constexpr int XE = 16 / sizeof(T);      // elements per 16-B copy
  // threads: at least one 16-B copy of channels per x row
  static constexpr int NT = P * XE > THREADS ? P * XE : THREADS;
  static constexpr int CH = NT / P;              // channels per block
  struct Tile {
    T x[2][TT][CH];
    float dt[2][TT][CH];
    T bc[2][TT][2 * NG];   // the group's B_t columns, then its C_t columns
    float y[TT][CH];       // y_t, or the group's f32 partial of it
  };
};

// Issue the copies of time tile [t0, t0 + TT) into buffer `buf`: x and dt
// of the block's channels, B and C of state columns g0 .. g0 + NG - 1
// (zero past N).
template <int P, typename T>
__device__ __forceinline__ void stage_wide(typename Wide<P, T>::Tile& s,
                                           int buf, const Args& a,
                                           long long b, int c0, int t0,
                                           int g0, int N, bool vec) {
  using W = Wide<P, T>;
  constexpr int CH = W::CH, NG = W::NG, NT = W::NT, XE = W::XE;
  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.B);
  const T* Cm = static_cast<const T*>(a.C);
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int XC = CH / XE, DC = CH / 4, BC = NG / XE;  // copies per row
    for (int i = tid; i < TT * (XC + DC + 2 * BC); i += NT) {
      int t, j;
      if (i < TT * XC) {
        t = i / XC; j = i - t * XC;
        const int c = c0 + j * XE;
        const bool ok = t0 + t < a.L && c < a.di;
        cp16(&s.x[buf][t][j * XE],
             ok ? x + b * a.x_b + (t0 + t) * a.x_t + c : x, ok ? 16 : 0);
      } else if (i < TT * (XC + DC)) {
        const int k = i - TT * XC;
        t = k / DC; j = k - t * DC;
        const int c = c0 + j * 4;
        const bool ok = t0 + t < a.L && c < a.di;
        cp16(&s.dt[buf][t][j * 4],
             ok ? a.dt + b * a.dt_b + (t0 + t) * a.dt_t + c : a.dt,
             ok ? 16 : 0);
      } else {
        const int k = i - TT * (XC + DC);
        t = k / (2 * BC); j = k - t * 2 * BC;
        const int n = g0 + (j < BC ? j : j - BC) * XE;
        const bool ok = t0 + t < a.L && n < N;
        const T* src = j < BC ? Bm + b * a.B_b + (t0 + t) * a.B_t + n
                              : Cm + b * a.C_b + (t0 + t) * a.C_t + n;
        cp16(&s.bc[buf][t][j * XE], ok ? src : Bm, ok ? 16 : 0);
      }
    }
  } else {
    const T zero = T(0.f);
    for (int i = tid; i < TT * CH; i += NT) {
      const int t = i / CH, j = i - t * CH;
      const int c = c0 + j;
      const bool ok = t0 + t < a.L && c < a.di;
      s.x[buf][t][j] = ok ? x[b * a.x_b + (t0 + t) * a.x_t + c] : zero;
      s.dt[buf][t][j] = ok ? a.dt[b * a.dt_b + (t0 + t) * a.dt_t + c] : 0.f;
    }
    for (int i = tid; i < TT * 2 * NG; i += NT) {
      const int t = i / (2 * NG), j = i - t * 2 * NG;
      const int n = g0 + (j < NG ? j : j - NG);
      const bool ok = t0 + t < a.L && n < N;
      s.bc[buf][t][j] = !ok ? zero
          : j < NG ? Bm[b * a.B_b + (t0 + t) * a.B_t + n]
                   : Cm[b * a.C_b + (t0 + t) * a.C_t + n];
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One block: CH channels of batch row blockIdx.y, state group blockIdx.z.
// With one group it writes y; with more, the group's f32 partials of
// <h_t, C_t> to part (groups, Bt, L, di), for ss_fwd_combine_kernel.
template <int P, typename T>
__global__ void __launch_bounds__(Wide<P, T>::NT, 512 / Wide<P, T>::NT)
ss_fwd_wide_kernel(const Args a, int N, float* part, int vec) {
  using W = Wide<P, T>;
  constexpr int NP = W::NP, CH = W::CH;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  typename W::Tile& s = *reinterpret_cast<typename W::Tile*>(wide_smem);

  const long long b = blockIdx.y;
  const int g0 = blockIdx.z * W::NG;
  const bool grouped = gridDim.z > 1;
  const int tid = threadIdx.x;
  const int cl = tid / P, part_id = tid % P;
  const int c0 = blockIdx.x * CH;
  const int c = c0 + cl;
  const bool live = c < a.di;

  // this lane's state columns g0 + part_id*NP .. + NP - 1 (those >= N
  // stay 0)
  float h[NP], a2[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int n = g0 + part_id * NP + i;
    const bool on = live && n < N;
    h[i] = on ? a.h0[(b * a.di + c) * N + n] : 0.f;
    a2[i] = on ? a.A[(long long)c * N + n] * LOG2E : 0.f;
  }
  const float Dc = live ? a.D[c] : 0.f;

  const int ntiles = (a.L + TT - 1) / TT;
  stage_wide<P, T>(s, 0, a, b, c0, 0, g0, N, vec);
  for (int k = 0; k < ntiles; ++k) {
    const int cur = k & 1, t0 = k * TT;
    if (k + 1 < ntiles) {
      stage_wide<P, T>(s, cur ^ 1, a, b, c0, t0 + TT, g0, N, vec);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();             // tile k has landed

#pragma unroll
    for (int t = 0; t < TT; ++t) {
      const float dv = s.dt[cur][t][cl];
      const float xv = to_f32(s.x[cur][t][cl]);
      const float dx = dv * xv;
      const T* Bt = &s.bc[cur][t][part_id * NP];
      const T* Ct = Bt + W::NG;
      float prod[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        h[i] = fmaf(fast_exp2(dv * a2[i]), h[i], dx * to_f32(Bt[i]));
        prod[i] = h[i] * to_f32(Ct[i]);
      }
#pragma unroll
      for (int w = 1; w < NP; w *= 2)      // pairwise: a tree, not a chain
#pragma unroll
        for (int i = 0; i + w < NP; i += 2 * w) prod[i] += prod[i + w];
      float acc = prod[0];
#pragma unroll
      for (int off = P / 2; off >= 1; off /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (part_id == t % P) s.y[t][cl] = grouped ? acc : acc + Dc * xv;
    }
    __syncthreads();             // the y tile is complete

    const int nt = min(TT, a.L - t0);
    for (int i = tid; i < nt * CH; i += W::NT) {
      const int t = i / CH, j = i - t * CH;
      if (c0 + j >= a.di) continue;
      const long long row = (long long)blockIdx.z * gridDim.y + b;
      if (grouped)
        part[(row * a.L + t0 + t) * a.di + c0 + j] = s.y[t][j];
      else
        from_f32(static_cast<T*>(a.y) + (b * a.L + t0 + t) * a.di + c0 + j,
                 s.y[t][j]);
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int n = g0 + part_id * NP + i;
      if (n < N) a.h_last[(b * a.di + c) * N + n] = h[i];
    }
  }
}

// y = (sum over groups of part, in group order) + D x, rounded once.
template <typename T>
__global__ void ss_fwd_combine_kernel(const Args a, const float* part,
                                      int groups, long long rows) {
  const long long n = rows * a.di;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / a.di, b = r / a.L;
    const int c = (int)(i - r * a.di), t = (int)(r - b * a.L);
    float acc = 0.f;
    for (int g = 0; g < groups; ++g) acc += part[g * n + i];
    const float xv =
        to_f32(static_cast<const T*>(a.x)[b * a.x_b + t * a.x_t + c]);
    from_f32(static_cast<T*>(a.y) + i, acc + a.D[c] * xv);
  }
}

// Lanes per channel of the wide kernel for N state columns.
template <typename T>
int wide_lanes(int N) {
  const int need = (N + kCols<T> - 1) / kCols<T>;
  int p = 4;
  while (p < need && p < MAX_LANES) p *= 2;
  return p;
}

template <typename T>
int state_groups(int N) {
  if (N <= MAX_N) return 1;
  const int cols = wide_lanes<T>(N) * kCols<T>;
  return (N + cols - 1) / cols;
}

template <typename T, int P>
cudaError_t launch_wide(int N, int Bt, const Args& a, int vec, float* part,
                        cudaStream_t st) {
  using W = Wide<P, T>;
  const int groups = state_groups<T>(N);
  constexpr int smem = (int)sizeof(typename W::Tile);
  static bool configured = false;   // the attribute is set once per body
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ss_fwd_wide_kernel<P, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((a.di + W::CH - 1) / W::CH, Bt, groups);
  ss_fwd_wide_kernel<P, T><<<grid, W::NT, smem, st>>>(a, N, part, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return err;
  const long long rows = (long long)Bt * a.L;
  const int blocks = (int)std::min<long long>((rows * a.di + 255) / 256,
                                              132 * 16);
  ss_fwd_combine_kernel<T><<<blocks, 256, 0, st>>>(a, part, groups, rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_any(int N, int Bt, const Args& a, int vec, float* part,
                       cudaStream_t st) {
  if (N <= MAX_N) return launch<T>(N, Bt, a, vec, st);
  switch (wide_lanes<T>(N)) {
    case 4:   // f32 past N 16 takes at least 8 lanes of 4 columns
      if constexpr (kCols<T> * 4 > MAX_N)
        return launch_wide<T, 4>(N, Bt, a, vec, part, st);
      return cudaErrorInvalidValue;
    case 8: return launch_wide<T, 8>(N, Bt, a, vec, part, st);
    case 16: return launch_wide<T, 16>(N, Bt, a, vec, part, st);
    default: return launch_wide<T, MAX_LANES>(N, Bt, a, vec, part, st);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Whether every 16-B copy of `stage` is aligned: bases, the strides of
// dims that are stepped, whole 16-B runs of channels and of B/C rows.
bool can_vec(const Args& a, int Bt, int N, int esize) {
  auto ok = [&](long long stride, int extent) {
    return extent == 1 || stride * esize % 16 == 0;
  };
  auto ok4 = [&](long long stride, int extent) {
    return extent == 1 || stride * 4 % 16 == 0;
  };
  return aligned16(a.x) && aligned16(a.dt) && aligned16(a.B) &&
         aligned16(a.C) && a.di * esize % 16 == 0 && a.di % 4 == 0 &&
         N * esize % 16 == 0 && ok(a.x_b, Bt) && ok(a.x_t, a.L) &&
         ok4(a.dt_b, Bt) && ok4(a.dt_t, a.L) && ok(a.B_b, Bt) &&
         ok(a.B_t, a.L) && ok(a.C_b, Bt) && ok(a.C_t, a.L);
}

}  // namespace

// dtype: 0 = x, B, C and y in float32, 1 = in bfloat16; dt, A, D, h0 and
// h_last are float32. part: an f32 workspace of ss_fwd_groups(dtype, N)
// x (Bt, L, di) where that is above 1, else unused. One launch takes Bt
// <= MAX_GRID; the wrapper cuts larger batches into such launches.
// Returns a cudaError_t (0 on a clean launch); does not synchronise.
extern "C" int ss_fwd(int dtype, const void* x, const void* dt, const void* A,
                      const void* B, const void* C, const void* D,
                      const void* h0, void* y, void* h_last, void* part,
                      int Bt, int L, int di, int N, long long x_b,
                      long long x_t, long long dt_b, long long dt_t,
                      long long B_b, long long B_t, long long C_b,
                      long long C_t, void* stream) {
  if (Bt < 1 || Bt > MAX_GRID || L < 1 || di < 1 || N < 1 || dtype < 0
      || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int groups = dtype == 0 ? state_groups<float>(N)
                                : state_groups<__nv_bfloat16>(N);
  if (groups > MAX_GRID || (groups > 1 && !part))
    return (int)cudaErrorInvalidValue;
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
         B, C, static_cast<const float*>(D), static_cast<const float*>(h0),
         y, static_cast<float*>(h_last), L, di,
         x_b, x_t, dt_b, dt_t, B_b, B_t, C_b, C_t};
  cudaStream_t st = (cudaStream_t)stream;
  float* ws = static_cast<float*>(part);
  const int vec = can_vec(a, Bt, N, dtype == 0 ? 4 : 2);
  cudaError_t err = dtype == 0
      ? launch_any<float>(N, Bt, a, vec, ws, st)
      : launch_any<__nv_bfloat16>(N, Bt, a, vec, ws, st);
  return (int)err;
}

// Lanes that share one channel's state for this dtype (0 = float32,
// 1 = bfloat16) and state width N, as this build launches the kernel.
extern "C" int ss_fwd_lanes(int dtype, int N) {
  if (N <= MAX_N) return dtype == 0 ? kParts<float> : kParts<__nv_bfloat16>;
  return dtype == 0 ? wide_lanes<float>(N) : wide_lanes<__nv_bfloat16>(N);
}

// State groups (grid z) of one launch for this dtype and N: 1 up to one
// warp of lanes' columns; above 1 the call needs the f32 workspace.
extern "C" int ss_fwd_groups(int dtype, int N) {
  return dtype == 0 ? state_groups<float>(N)
                    : state_groups<__nv_bfloat16>(N);
}
