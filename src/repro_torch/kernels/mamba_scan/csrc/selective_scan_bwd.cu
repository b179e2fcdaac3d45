// Mamba-1 selective scan backward for Hopper (sm_90a).
//
// The gradient of `selective_scan_fwd` (csrc/selective_scan_fwd.cu). The
// TPU package has no backward kernel: its custom_vjp runs the closed-form
// adjoint in XLA ops (`_closed_form_bwd`, src/repro/kernels/mamba_scan/
// ops.py), as `ops.closed_form_bwd` does in torch ops, materializing
// several (Bt, L, di, N) f32 tensors. This kernel computes the same
// cotangents with the states kept on chip. Per batch row and channel c,
// 0-based t, with a_t = exp(dt_t A[c]), h_{-1} = h0 and h_t = a_t h_{t-1} +
// dt_t x_t B_t:
//   lam_t  = ybar_t C_t + a_{t+1} lam_{t+1}     (a_L lam_L := hbar_last)
//   dA     = sum_{b,t} lam_t h_{t-1} a_t dt_t
//   d(dt)_t = <lam_t h_{t-1} a_t, A> + x_t <lam_t, B_t>
//   dx_t   = dt_t <lam_t, B_t> + D ybar_t
//   dB_t   = sum_c lam_t dt_t x_t,   dC_t = sum_c h_t ybar_t
//   dD     = sum_{b,t} ybar_t x_t,   dh0 = a_0 lam_0
// each returned in its input's dtype (dx, dB, dC in x's; the rest f32).
//
// What bounds it: every (t, c, n) needs a_t for the states and again for
// lam, 2*Bt*L*di*N exponentials at least (1.07 G at the train shape, Bt=2,
// L=2048, di=8192, N=16: ~0.26 ms at 16 per clock per SM on an H100); the
// bytes (x, dt, ybar read, dx, d(dt) written, the workspaces) ~0.6 GB,
// ~0.18 ms at 3.35 TB/s. So the exponentials bound it, the bytes close
// behind. This design takes 2.75 exponentials an element (below).
//
// Design. A block of 128 threads owns one batch row and 32 channels; each
// channel's state columns are split over 4 neighbouring lanes of 4 columns
// each, in f32 registers (a group of 16 columns; wider states below), with
// A pre-scaled by log2 e so each exponential is one ex2. Time tiles of 32
// steps of x, dt, B (and, walking back, C and ybar) are staged in shared
// memory with cp.async, double-buffered, 16 B a copy where every base and
// stride allows it, else one element at a time; rows past L are
// zero-filled (dt = 0 and x = 0 leave the state and lam unchanged, so the
// ragged tile needs no mask).
//   1. Forward sweep: the block runs the recurrence over the tiles but the
//      last and writes the state entering each tile to an f32 workspace
//      hb (Bt, ceil(L/32) - 1, di, N), 66 MB at the train shape.
//   2. Reverse sweep, tiles last to first: from the tile's entering state
//      it recomputes the states entering its sub-tiles of 8 steps (24
//      steps), then for each sub-tile, last first, the sub-tile's 8 states
//      and decays into registers, and carries lam back through them.
// d(dt) and dx sum over the state columns: xor-shuffles across a
// channel's 4 lanes. dA and dD sum over time in registers. dB and dC sum
// over channels: per step, a reduce-scatter over the warp's 8 channels (7
// shuffles for 8 values), the block's 4 warps added in order in shared
// memory once a tile, and each block's f32 partial written to a workspace
// (Bt, ceil(di/32), L, 2N); `ss_bwd_bc_kernel` adds the blocks in order and
// rounds to B's dtype once. dA and dD are written per batch row and
// `ss_bwd_rows_kernel` adds the rows in order. No atomics: a call's bits
// repeat exactly.
//
// Wide states (N > 16). The same body runs over groups of 16 state
// columns, a grid axis: the columns are independent but for the sums over
// them in d(dt) and dx, so each group writes its f32 partials of <lam, B>
// and <lam h a, A> to a workspace (groups, 2, Bt, L, di), and
// `ss_bwd_groups_kernel` adds the groups in order, then finishes dx and
// d(dt). Only the last group masks columns past N.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 128;
constexpr int P = 4;                 // lanes per channel
constexpr int NP = 4;                // state columns per lane
constexpr int NG = P * NP;           // state columns per group
constexpr int CH = THREADS / P;      // channels per block
constexpr int NW = THREADS / 32;     // warps per block
constexpr int TT = 32;               // timesteps per staged tile
constexpr int S = 8;                 // timesteps per sub-tile
constexpr int NS = TT / S;           // sub-tiles per tile
constexpr int MAX_GRID = 65535;      // batch rows (grid y) and groups (z)
constexpr int MIN_BLOCKS = 3;        // resident blocks the registers allow
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* D;
  const float* h0;
  const void* yb;        // cotangent of y
  const float* hlb;      // cotangent of h_last
  void* dx;
  float* ddt;
  void* dB;
  void* dC;
  float* dh0;
  float* dA_rows;        // (Bt, di, N): dA of each batch row
  float* dD_rows;        // (Bt, di)
  float* hb;             // (Bt, ntiles - 1, di, N): state entering tile k+1
  float* part;           // (Bt, nblk, L, 2N): dB, dC of each channel block
  float* sums;           // (groups, 2, Bt, L, di) where groups > 1
  int L, di;
  long long x_b, x_t, dt_b, dt_t, B_b, B_t, C_b, C_t, yb_b, yb_t;
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

template <typename T>
struct Tile {
  T x[2][TT][CH];
  float dt[2][TT][CH];
  T yb[2][TT][CH];
  T bc[2][TT][2 * NG];       // the group's B_t columns, then its C_t columns
  float Bf[TT][NG], Cf[TT][NG];
  float o1[TT][CH], o2[TT][CH];   // dx and d(dt), or the group's partials
  float red[TT][NW][2 * NG];      // each warp's channel sums of dB, dC
};

// Issue the copies of time tile [t0, t0 + TT) into buffer `buf`: x, dt
// and B columns g0 .. g0 + NG - 1 (zero past N); with `rev` also ybar and
// the C columns.
template <typename T>
__device__ __forceinline__ void stage(Tile<T>& s, int buf, const Args& a,
                                      long long b, int c0, int t0, int g0,
                                      int N, bool rev, bool vec) {
  const T* x = static_cast<const T*>(a.x);
  const T* yb = static_cast<const T*>(a.yb);
  const T* Bm = static_cast<const T*>(a.B);
  const T* Cm = static_cast<const T*>(a.C);
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int XE = 16 / sizeof(T);               // elements per copy
    constexpr int XC = CH / XE, DC = CH / 4, BC = NG / XE;  // per row
    for (int i = tid; i < TT * XC; i += THREADS) {
      const int t = i / XC, j = i - t * XC;
      const int c = c0 + j * XE;
      const bool ok = t0 + t < a.L && c < a.di;
      cp16(&s.x[buf][t][j * XE],
           ok ? x + b * a.x_b + (t0 + t) * a.x_t + c : x, ok ? 16 : 0);
      if (rev)
        cp16(&s.yb[buf][t][j * XE],
             ok ? yb + b * a.yb_b + (t0 + t) * a.yb_t + c : yb, ok ? 16 : 0);
    }
    for (int i = tid; i < TT * DC; i += THREADS) {
      const int t = i / DC, j = i - t * DC;
      const int c = c0 + j * 4;
      const bool ok = t0 + t < a.L && c < a.di;
      cp16(&s.dt[buf][t][j * 4],
           ok ? a.dt + b * a.dt_b + (t0 + t) * a.dt_t + c : a.dt,
           ok ? 16 : 0);
    }
    const int nb = rev ? 2 * BC : BC;
    for (int i = tid; i < TT * nb; i += THREADS) {
      const int t = i / nb, j = i - t * nb;
      const int n = g0 + (j < BC ? j : j - BC) * XE;
      const bool ok = t0 + t < a.L && n < N;
      const T* src = j < BC ? Bm + b * a.B_b + (t0 + t) * a.B_t + n
                            : Cm + b * a.C_b + (t0 + t) * a.C_t + n;
      cp16(&s.bc[buf][t][j * XE], ok ? src : Bm, ok ? 16 : 0);
    }
  } else {
    const T zero = T(0.f);
    for (int i = tid; i < TT * CH; i += THREADS) {
      const int t = i / CH, j = i - t * CH;
      const int c = c0 + j;
      const bool ok = t0 + t < a.L && c < a.di;
      s.x[buf][t][j] = ok ? x[b * a.x_b + (t0 + t) * a.x_t + c] : zero;
      s.dt[buf][t][j] = ok ? a.dt[b * a.dt_b + (t0 + t) * a.dt_t + c] : 0.f;
      if (rev)
        s.yb[buf][t][j] = ok ? yb[b * a.yb_b + (t0 + t) * a.yb_t + c] : zero;
    }
    const int nb = rev ? 2 * NG : NG;
    for (int i = tid; i < TT * nb; i += THREADS) {
      const int t = i / nb, j = i - t * nb;
      const int n = g0 + (j < NG ? j : j - NG);
      const bool ok = t0 + t < a.L && n < N;
      s.bc[buf][t][j] = !ok ? zero
          : j < NG ? Bm[b * a.B_b + (t0 + t) * a.B_t + n]
                   : Cm[b * a.C_b + (t0 + t) * a.C_t + n];
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One block: CH channels of batch row blockIdx.y, state columns
// blockIdx.z * NG .. + NG - 1.
template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ss_bwd_kernel(const Args a, int N, int vec) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  Tile<T>& s = *reinterpret_cast<Tile<T>*>(bwd_smem);

  const long long b = blockIdx.y;
  const int g0 = blockIdx.z * NG;
  const bool grouped = gridDim.z > 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = tid / P, part = tid % P;
  const int c0 = blockIdx.x * CH;
  const int c = c0 + cl;
  const bool live = c < a.di;
  const int ntiles = (a.L + TT - 1) / TT;
  const int col = part * NP;                 // this lane's first column
  const long long row = (b * a.di + c) * N;  // (b, c) in (Bt, di, N)

  // this lane's state columns g0 + col .. + NP - 1 (those >= N stay 0)
  float Av[NP], a2[NP], h[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int n = g0 + col + i;
    const bool on = live && n < N;
    Av[i] = on ? a.A[(long long)c * N + n] : 0.f;
    a2[i] = Av[i] * LOG2E;
    h[i] = on ? a.h0[row + n] : 0.f;
  }

  // 1. forward sweep: the state entering each tile but the first to hb
  for (int k = 0; k + 1 < ntiles; ++k) {
    const int cur = k & 1, t0 = k * TT;
    if (k == 0) stage(s, 0, a, b, c0, 0, g0, N, false, vec);
    if (k + 2 < ntiles) {
      stage(s, cur ^ 1, a, b, c0, t0 + TT, g0, N, false, vec);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();             // tile k has landed
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      const float dv = s.dt[cur][t][cl];
      const float dx = dv * to_f32(s.x[cur][t][cl]);
      const T* Bt = &s.bc[cur][t][col];
#pragma unroll
      for (int i = 0; i < NP; ++i)
        h[i] = fmaf(fast_exp2(dv * a2[i]), h[i], dx * to_f32(Bt[i]));
    }
    __syncthreads();             // every lane is done with buffer cur
    if (live) {
      float* dst = a.hb + ((b * (ntiles - 1) + k) * a.di + c) * N;
#pragma unroll
      for (int i = 0; i < NP; ++i)
        if (g0 + col + i < N) dst[g0 + col + i] = h[i];
    }
  }

  // 2. reverse sweep
  float lam[NP], an[NP], dA[NP];   // lam_{t+1}, a_{t+1}; dA over time
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int n = g0 + col + i;
    lam[i] = live && n < N ? a.hlb[row + n] : 0.f;
    an[i] = 1.f;
    dA[i] = 0.f;
  }
  const float Dc = live ? a.D[c] : 0.f;
  float dD = 0.f;

  stage(s, 0, a, b, c0, (ntiles - 1) * TT, g0, N, true, vec);
  for (int kk = 0; kk < ntiles; ++kk) {
    const int k = ntiles - 1 - kk, cur = kk & 1, t0 = k * TT;
    if (k > 0) {
      stage(s, cur ^ 1, a, b, c0, t0 - TT, g0, N, true, vec);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();             // tile k has landed
    for (int i = tid; i < TT * NG; i += THREADS) {
      const int t = i / NG, n = i - t * NG;
      s.Bf[t][n] = to_f32(s.bc[cur][t][n]);
      s.Cf[t][n] = to_f32(s.bc[cur][t][NG + n]);
    }
    __syncthreads();             // B and C of tile k are in f32

    // the states entering the tile's sub-tiles
    float hsub[NS][NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int n = g0 + col + i;
      const bool on = live && n < N;
      hsub[0][i] = !on ? 0.f
          : k == 0 ? a.h0[row + n]
                   : a.hb[((b * (ntiles - 1) + k - 1) * a.di + c) * N + n];
    }
#pragma unroll
    for (int j = 0; j + 1 < NS; ++j) {
#pragma unroll
      for (int i = 0; i < NP; ++i) hsub[j + 1][i] = hsub[j][i];
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const int t = j * S + u;
        const float dv = s.dt[cur][t][cl];
        const float dx = dv * to_f32(s.x[cur][t][cl]);
#pragma unroll
        for (int i = 0; i < NP; ++i)
          hsub[j + 1][i] = fmaf(fast_exp2(dv * a2[i]), hsub[j + 1][i],
                                dx * s.Bf[t][col + i]);
      }
    }

#pragma unroll
    for (int j = NS - 1; j >= 0; --j) {
      float hs[S][NP], as[S][NP];    // h_t and a_t of the sub-tile
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const int t = j * S + u;
        const float dv = s.dt[cur][t][cl];
        const float dx = dv * to_f32(s.x[cur][t][cl]);
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          as[u][i] = fast_exp2(dv * a2[i]);
          hs[u][i] = fmaf(as[u][i], u ? hs[u - 1][i] : hsub[j][i],
                          dx * s.Bf[t][col + i]);
        }
      }
#pragma unroll
      for (int u = S - 1; u >= 0; --u) {
        const int t = j * S + u;
        const float dv = s.dt[cur][t][cl];
        const float xv = to_f32(s.x[cur][t][cl]);
        const float yv = to_f32(s.yb[cur][t][cl]);
        const float dvx = dv * xv;
        float sAh = 0.f, sB = 0.f, v[2 * NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          lam[i] = fmaf(an[i], lam[i], yv * s.Cf[t][col + i]);
          const float ah = lam[i] * (u ? hs[u - 1][i] : hsub[j][i])
                           * as[u][i];
          dA[i] = fmaf(ah, dv, dA[i]);
          sAh = fmaf(ah, Av[i], sAh);
          sB = fmaf(lam[i], s.Bf[t][col + i], sB);
          v[i] = lam[i] * dvx;
          v[NP + i] = hs[u][i] * yv;
          an[i] = as[u][i];
        }
        dD = fmaf(yv, xv, dD);
        // d(dt) and dx: the sums over the channel's lanes
        sAh += __shfl_xor_sync(FULL, sAh, 1);
        sB += __shfl_xor_sync(FULL, sB, 1);
        sAh += __shfl_xor_sync(FULL, sAh, 2);
        sB += __shfl_xor_sync(FULL, sB, 2);
        if (part == t % P) {
          s.o1[t][cl] = grouped ? sB : fmaf(dv, sB, Dc * yv);
          s.o2[t][cl] = grouped ? sAh : fmaf(xv, sB, sAh);
        }
        // dB and dC: reduce-scatter over the warp's 8 channels, the lanes
        // xor 16, 8, 4; lane ends with value (lane >> 2) & 7 summed
        const bool u1 = lane & 16, u2 = lane & 8, u3 = lane & 4;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float send = u1 ? v[i] : v[i + 4];
          v[i] = (u1 ? v[i + 4] : v[i]) + __shfl_xor_sync(FULL, send, 16);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float send = u2 ? v[i] : v[i + 2];
          v[i] = (u2 ? v[i + 2] : v[i]) + __shfl_xor_sync(FULL, send, 8);
        }
        {
          const float send = u3 ? v[0] : v[1];
          v[0] = (u3 ? v[1] : v[0]) + __shfl_xor_sync(FULL, send, 4);
        }
        const int q = (lane >> 2) & 7;
        s.red[t][warp][q < NP ? col + q : NG + col + q - NP] = v[0];
      }
    }
    __syncthreads();             // the tile's outputs are in shared memory

    const int nt = min(TT, a.L - t0);
    for (int i = tid; i < nt * CH; i += THREADS) {
      const int t = i / CH, j = i - t * CH;
      const int cc = c0 + j;
      if (cc >= a.di) continue;
      const long long o = (b * a.L + t0 + t) * a.di + cc;
      if (grouped) {
        const long long n = (long long)gridDim.y * a.L * a.di;
        a.sums[(2LL * blockIdx.z) * n + o] = s.o1[t][j];
        a.sums[(2LL * blockIdx.z + 1) * n + o] = s.o2[t][j];
      } else {
        from_f32(static_cast<T*>(a.dx) + o, s.o1[t][j]);
        a.ddt[o] = s.o2[t][j];
      }
    }
    for (int i = tid; i < nt * 2 * NG; i += THREADS) {
      const int t = i / (2 * NG), j = i - t * 2 * NG;
      const int n = g0 + (j < NG ? j : j - NG);
      if (n >= N) continue;
      float acc = s.red[t][0][j];
#pragma unroll
      for (int w = 1; w < NW; ++w) acc += s.red[t][w][j];
      a.part[((b * gridDim.x + blockIdx.x) * a.L + t0 + t) * 2 * N
             + (j < NG ? 0 : N) + n] = acc;
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int n = g0 + col + i;
      if (n < N) {
        a.dh0[row + n] = an[i] * lam[i];   // a_0 lam_0
        a.dA_rows[row + n] = dA[i];
      }
    }
    if (part == 0 && blockIdx.z == 0) a.dD_rows[b * a.di + c] = dD;
  }
}

// dB, dC = the channel blocks' partials added in block order, rounded once.
template <typename T>
__global__ void ss_bwd_bc_kernel(const Args a, int nblk, long long rows,
                                 int N) {
  const long long n = rows * 2 * N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / (2 * N), b = r / a.L;
    const int j = (int)(i - r * 2 * N), t = (int)(r - b * a.L);
    const float* p = a.part + (b * nblk * a.L + t) * 2 * N + j;
    float acc = 0.f;
    for (int k = 0; k < nblk; ++k) acc += p[(long long)k * a.L * 2 * N];
    if (j < N)
      from_f32(static_cast<T*>(a.dB) + r * N + j, acc);
    else
      from_f32(static_cast<T*>(a.dC) + r * N + j - N, acc);
  }
}

// Wide states: each group's <lam, B> and <lam h a, A> added in group
// order, then dx and d(dt) finished.
template <typename T>
__global__ void ss_bwd_groups_kernel(const Args a, int groups,
                                     long long rows) {
  const long long n = rows * a.di;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / a.di, b = r / a.L;
    const int c = (int)(i - r * a.di), t = (int)(r - b * a.L);
    float sB = 0.f, sAh = 0.f;
    for (int g = 0; g < groups; ++g) {
      sB += a.sums[2LL * g * n + i];
      sAh += a.sums[(2LL * g + 1) * n + i];
    }
    const float xv =
        to_f32(static_cast<const T*>(a.x)[b * a.x_b + t * a.x_t + c]);
    const float dv = a.dt[b * a.dt_b + t * a.dt_t + c];
    const float yv =
        to_f32(static_cast<const T*>(a.yb)[b * a.yb_b + t * a.yb_t + c]);
    from_f32(static_cast<T*>(a.dx) + i, fmaf(dv, sB, a.D[c] * yv));
    a.ddt[i] = fmaf(xv, sB, sAh);
  }
}

// dA (di, N) and dD (di,) = the batch rows' partials added in row order.
__global__ void ss_bwd_rows_kernel(const float* dA_rows, const float* dD_rows,
                                   float* dA, float* dD, int Bt, int di,
                                   int N) {
  const long long nA = (long long)di * N, n = nA + di;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const bool isA = i < nA;
    const float* p = isA ? dA_rows + i : dD_rows + (i - nA);
    const long long stride = isA ? nA : di;
    float acc = 0.f;
    for (int b = 0; b < Bt; ++b) acc += p[b * stride];
    if (isA) dA[i] = acc; else dD[i - nA] = acc;
  }
}

int grid_blocks(long long n) {
  return (int)std::max<long long>(
      1, std::min<long long>((n + 255) / 256, 132 * 16));
}

template <typename T>
cudaError_t launch(const Args& a, int Bt, int N, int vec, cudaStream_t st) {
  constexpr int smem = (int)sizeof(Tile<T>);
  static bool configured = false;   // the attribute is set once per body
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ss_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int groups = (N + NG - 1) / NG;
  dim3 grid((a.di + CH - 1) / CH, Bt, groups);
  ss_bwd_kernel<T><<<grid, THREADS, smem, st>>>(a, N, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = (long long)Bt * a.L;
  ss_bwd_bc_kernel<T><<<grid_blocks(rows * 2 * N), 256, 0, st>>>(
      a, grid.x, rows, N);
  err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return err;
  ss_bwd_groups_kernel<T><<<grid_blocks(rows * a.di), 256, 0, st>>>(
      a, groups, rows);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Whether every 16-B copy of `stage` is aligned: bases, the strides of
// dims that are stepped, whole 16-B runs of channels and of B/C rows.
bool can_vec(const Args& a, int Bt, int N, int esize) {
  auto ok = [&](long long stride, int extent, int es) {
    return extent == 1 || stride * es % 16 == 0;
  };
  return aligned16(a.x) && aligned16(a.dt) && aligned16(a.B) &&
         aligned16(a.C) && aligned16(a.yb) && a.di * esize % 16 == 0 &&
         a.di % 4 == 0 && N * esize % 16 == 0 && ok(a.x_b, Bt, esize) &&
         ok(a.x_t, a.L, esize) && ok(a.dt_b, Bt, 4) && ok(a.dt_t, a.L, 4) &&
         ok(a.B_b, Bt, esize) && ok(a.B_t, a.L, esize) &&
         ok(a.C_b, Bt, esize) && ok(a.C_t, a.L, esize) &&
         ok(a.yb_b, Bt, esize) && ok(a.yb_t, a.L, esize);
}

}  // namespace

// The layout the wrapper sizes its workspaces by: 0 = timesteps per tile,
// 1 = channels per block, 2 = state columns per group.
extern "C" int ss_bwd_layout(int what) {
  return what == 0 ? TT : what == 1 ? CH : what == 2 ? NG : -1;
}

// dtype: 0 = x, B, C, ybar, dx, dB, dC in float32, 1 = in bfloat16; the
// rest float32. Inputs x, dt, B, C, ybar through their (batch, time)
// strides with the last dim contiguous; A, D, h0, hlb and every output and
// workspace contiguous, shaped as in `Args`. One launch takes Bt <=
// MAX_GRID rows; dA_rows and dD_rows are that launch's rows, added up by
// ss_bwd_rows once every row has run. Returns a cudaError_t (0 on a clean
// launch); does not synchronise.
extern "C" int ss_bwd(int dtype, const void* x, const void* dt, const void* A,
                      const void* B, const void* C, const void* D,
                      const void* h0, const void* yb, const void* hlb,
                      void* dx, void* ddt, void* dB, void* dC, void* dh0,
                      void* dA_rows, void* dD_rows, void* hb, void* part,
                      void* sums, int Bt, int L, int di, int N,
                      long long x_b, long long x_t, long long dt_b,
                      long long dt_t, long long B_b, long long B_t,
                      long long C_b, long long C_t, long long yb_b,
                      long long yb_t, void* stream) {
  const int groups = N > 0 ? (N + NG - 1) / NG : 0;
  if (Bt < 1 || Bt > MAX_GRID || L < 1 || di < 1 || N < 1 || dtype < 0
      || dtype > 1 || groups > MAX_GRID || (groups > 1 && !sums)
      || (L > TT && !hb) || !part)
    return (int)cudaErrorInvalidValue;
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
         B, C, static_cast<const float*>(D), static_cast<const float*>(h0),
         yb, static_cast<const float*>(hlb), dx, static_cast<float*>(ddt),
         dB, dC, static_cast<float*>(dh0), static_cast<float*>(dA_rows),
         static_cast<float*>(dD_rows), static_cast<float*>(hb),
         static_cast<float*>(part), static_cast<float*>(sums), L, di,
         x_b, x_t, dt_b, dt_t, B_b, B_t, C_b, C_t, yb_b, yb_t};
  cudaStream_t st = (cudaStream_t)stream;
  const int vec = can_vec(a, Bt, N, dtype == 0 ? 4 : 2);
  cudaError_t err = dtype == 0 ? launch<float>(a, Bt, N, vec, st)
                               : launch<__nv_bfloat16>(a, Bt, N, vec, st);
  return (int)err;
}

// dA = sum over the Bt rows of dA_rows (Bt, di, N), dD likewise of
// dD_rows (Bt, di), in row order.
extern "C" int ss_bwd_rows(const void* dA_rows, const void* dD_rows, void* dA,
                           void* dD, int Bt, int di, int N, void* stream) {
  if (Bt < 1 || di < 1 || N < 1) return (int)cudaErrorInvalidValue;
  ss_bwd_rows_kernel<<<grid_blocks((long long)di * (N + 1)), 256, 0,
                       (cudaStream_t)stream>>>(
      static_cast<const float*>(dA_rows), static_cast<const float*>(dD_rows),
      static_cast<float*>(dA), static_cast<float*>(dD), Bt, di, N);
  return (int)cudaGetLastError();
}
