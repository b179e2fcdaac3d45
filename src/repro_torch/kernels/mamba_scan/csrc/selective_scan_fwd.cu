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
// (216 M at the serve path's prefill, Bt=4, L~412, di=8192, N=16), which at
// the special-function units' 16 per clock per SM is ~52 us on an H100;
// the bytes (x, dt and y dominate, ~113 MB) take ~34 us at 3.35 TB/s. So the
// bound is the exponentials, with the bytes close behind.
//
// Design, simple first: the TPU's sequential chunk grid axis with its state
// in VMEM scratch becomes a loop over time inside each block. Grid
// (ceil(di/128), Bt), one channel per thread; the thread keeps its N-wide
// state and its row of A (pre-scaled by log2 e, so each exponential is one
// exp2) in registers, N a template parameter. For each tile of 32 timesteps
// the block first stages x and dt (coalesced across neighbouring channels)
// and B_t, C_t (read by every channel of the block) into shared memory as
// f32, then runs the 32 dependent steps from there, writing y coalesced.
// Each step's N exponentials are independent, which is the only parallelism
// inside a thread; across the card there are only Bt*di threads (256 blocks
// of 128 at the serve shape), and the tile loads are not overlapped with
// compute. Splitting N or time across threads and cp.async/TMA staging are
// the next steps, in a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;      // channels per block, one per thread
constexpr int TT = 32;          // timesteps per staged tile
constexpr int MAX_N = 16;       // state width limit
constexpr float LOG2E = 1.4426950408889634f;

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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int N, typename T>
__global__ void __launch_bounds__(BLOCK) ss_fwd_kernel(const Args a) {
  __shared__ float x_s[TT][BLOCK];
  __shared__ float dt_s[TT][BLOCK];
  __shared__ __align__(16) float B_s[TT][N];
  __shared__ __align__(16) float C_s[TT][N];

  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.B);
  const T* Cm = static_cast<const T*>(a.C);
  T* y = static_cast<T*>(a.y);
  const long long b = blockIdx.y;
  const int tid = threadIdx.x;
  const int c = blockIdx.x * BLOCK + tid;
  const bool live = c < a.di;

  float h[N], a2[N];
  float Dc = 0.f;
  if (live) {
    const float* hp = a.h0 + (b * a.di + c) * N;
    const float* ap = a.A + (long long)c * N;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      h[n] = hp[n];
      a2[n] = ap[n] * LOG2E;
    }
    Dc = a.D[c];
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = a2[n] = 0.f;
  }

  for (int t0 = 0; t0 < a.L; t0 += TT) {
    const int nt = min(TT, a.L - t0);
    __syncthreads();            // the previous tile is consumed
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      float xv = 0.f, dv = 0.f;
      if (live && t < nt) {
        xv = to_f32(x[b * a.x_b + (t0 + t) * a.x_t + c]);
        dv = a.dt[b * a.dt_b + (t0 + t) * a.dt_t + c];
      }
      x_s[t][tid] = xv;
      dt_s[t][tid] = dv;
    }
    for (int i = tid; i < nt * N; i += BLOCK) {
      const int t = i / N, n = i - t * N;
      B_s[t][n] = to_f32(Bm[b * a.B_b + (t0 + t) * a.B_t + n]);
      C_s[t][n] = to_f32(Cm[b * a.C_b + (t0 + t) * a.C_t + n]);
    }
    __syncthreads();
    if (live) {
      T* yp = y + (b * a.L + t0) * a.di + c;
      for (int t = 0; t < nt; ++t) {
        const float dv = dt_s[t][tid], xv = x_s[t][tid];
        const float dx = dv * xv;
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = exp2f(dv * a2[n]) * h[n] + dx * B_s[t][n];
          acc += h[n] * C_s[t][n];
        }
        store(yp + (long long)t * a.di, acc + Dc * xv);
      }
    }
  }
  if (live) {
    float* hp = a.h_last + (b * a.di + c) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) hp[n] = h[n];
  }
}

template <typename T, int N = 1>
cudaError_t launch(int n, int Bt, const Args& a, cudaStream_t st) {
  if (n == N) {
    dim3 grid((a.di + BLOCK - 1) / BLOCK, Bt);
    ss_fwd_kernel<N, T><<<grid, BLOCK, 0, st>>>(a);
    return cudaGetLastError();
  }
  if constexpr (N < MAX_N) {
    return launch<T, N + 1>(n, Bt, a, st);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = x, B, C and y in float32, 1 = in bfloat16; dt, A, D, h0 and
// h_last are float32. Returns a cudaError_t (0 on a clean launch); does not
// synchronise.
extern "C" int ss_fwd(int dtype, const void* x, const void* dt, const void* A,
                      const void* B, const void* C, const void* D,
                      const void* h0, void* y, void* h_last, int Bt, int L,
                      int di, int N, long long x_b, long long x_t,
                      long long dt_b, long long dt_t, long long B_b,
                      long long B_t, long long C_b, long long C_t,
                      void* stream) {
  if (Bt < 1 || Bt > 65535 || L < 1 || di < 1 || N < 1 || N > MAX_N)
    return (int)cudaErrorInvalidValue;
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
         B, C, static_cast<const float*>(D), static_cast<const float*>(h0),
         y, static_cast<float*>(h_last), L, di,
         x_b, x_t, dt_b, dt_t, B_b, B_t, C_b, C_t};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = dtype == 0 ? launch<float>(N, Bt, a, st)
                               : launch<__nv_bfloat16>(N, Bt, a, st);
  return (int)err;
}
