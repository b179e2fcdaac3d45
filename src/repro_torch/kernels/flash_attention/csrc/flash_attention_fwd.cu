// Flash-attention forward for Hopper (sm_90a): blockwise online softmax
// with GQA, causal and kv_len masks.
//
// Replaces the TPU kernel `flash_attention_fwd` (body `_fa_kernel`) in
// src/repro/kernels/flash_attention/kernel.py. It computes the same
// function: for query head h the keys/values of kv head h / (H / KV);
// scores q.k * scale in f32, keys with k_pos >= kv_len masked, and with
// `causal` keys with k_pos > q_pos masked (positions counted from 0);
// f32 running max, denominator and accumulator; output
// acc / max(l, 1e-30) cast to the q dtype. Masked scores are -1e30, as in
// the TPU kernel, so a row with every key masked averages uniformly like
// the reference does.
//
// Layout: q (B,Sq,H,dq), k (B,Skv,KV,dq), v (B,Skv,KV,dv), o (B,Sq,H,dv),
// each addressed through its own (batch, seq, head) strides with the last
// dim contiguous, so the caller needs no transpose and no padding.
//
// What bounds it: at the serve path's prefill shape (B=4, H=32, KV=4,
// S~400-512, d=64, bf16, causal) q, k, v and o are ~15 MB and the visible
// (q, k) pairs' two products ~3 GFLOP: at the card's peaks that is ~4.5 us
// of HBM traffic against ~2.8 us of bf16 tensor-core work, so the bound is
// bytes, and both are microseconds.
//
// The design is deliberately simple so it is easy to hold against the plain
// version: one block per (64-row q tile, q head, batch), looping over
// 64-key K/V tiles staged in shared memory, and stopping at the causal
// diagonal and at kv_len. Two bodies:
//   * bf16 — both products on the tensor cores with mma.sync (bf16 inputs,
//     f32 accumulate), four warps of 16 q rows, the softmax state in the
//     mma fragments' registers;
//   * f32  — the products on the CUDA cores (tensor-core TF32 would miss
//     the reference's 2e-5 tolerance), 256 threads with a 4x4 register
//     micro-tile for the scores and a quad of threads per output row.
// Global loads are plain element loads with no copy/compute overlap;
// wgmma, TMA and warp specialisation are the next step, in a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;
constexpr int MAX_D = 128;      // dq and dv limit
constexpr int ACC = MAX_D / 4;  // accumulator slots per thread
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, s, h;
};

// ---------------------------------------------------------------------------
// f32: the products on the CUDA cores.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
fa_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  int H, int G, int Sq, int Skv, int dq, int dv,
                  Strides sq, Strides sk, Strides sv, Strides so,
                  float scale, int causal, int kv_len) {
  extern __shared__ float smem[];
  const int ldq = dq | 1;       // odd row stride: conflict-free column reads
  float* q_s = smem;                    // BQ x ldq
  float* k_s = q_s + BQ * ldq;          // BK x ldq
  float* v_s = k_s + BK * ldq;          // BK x dv
  float* s_s = v_s + BK * dv;           // BQ x (BK + 1)
  const int lds = BK + 1;

  // longest causal tiles first: a simple balance of the triangular work
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;

  for (int i = tid; i < BQ * dq; i += THREADS) {
    int r = i / dq, d = i - r * dq;
    int qr = q0 + r;
    q_s[r * ldq + d] = qr < Sq ? qb[qr * sq.s + d] : 0.f;
  }

  // keys this tile needs: up to kv_len, and with causal up to its last row
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, min(q0 + BQ, Sq));

  // score micro-tile: rows r1 + 0..3, columns c1 + 16 * 0..3
  const int r1 = (tid / 16) * 4;
  const int c1 = tid % 16;
  // softmax / accumulator ownership: row r2, dv columns l2 + 4 * m
  const int r2 = tid / 4;
  const int l2 = tid % 4;
  float m_run = NEG_INF, l_run = 0.f;
  float acc[ACC];
#pragma unroll
  for (int m = 0; m < ACC; ++m) acc[m] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    for (int i = tid; i < BK * dq; i += THREADS) {
      int c = i / dq, d = i - c * dq;
      int kr = k0 + c;
      k_s[c * ldq + d] = kr < Skv ? kb[kr * sk.s + d] : 0.f;
    }
    for (int i = tid; i < BK * dv; i += THREADS) {
      int c = i / dv, d = i - c * dv;
      int kr = k0 + c;
      v_s[c * dv + d] = kr < Skv ? vb[kr * sv.s + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dq; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(r1 + i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(c1 + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int qpos = q0 + r1 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int kpos = k0 + c1 + 16 * j;
        bool ok = kpos < kv_len && (!causal || kpos <= qpos);
        s_s[(r1 + i) * lds + c1 + 16 * j] = ok ? s[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax for row r2; the quad (4 adjacent lanes) shares it
    float* srow = s_s + r2 * lds;
    float mx = NEG_INF;
    for (int c = l2; c < BK; c += 4) mx = fmaxf(mx, srow[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float sum = 0.f;
    for (int c = l2; c < BK; c += 4) {
      float p = expf(srow[c] - m_new);
      srow[c] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    __syncwarp();   // the quad's p values are visible to all four lanes

#pragma unroll
    for (int m = 0; m < ACC; ++m) acc[m] *= alpha;
    for (int c = 0; c < BK; ++c) {
      const float p = srow[c];
      const float* vrow = v_s + c * dv;
#pragma unroll
      for (int m = 0; m < ACC; ++m) {
        int d = l2 + 4 * m;
        if (d < dv) acc[m] = fmaf(p, vrow[d], acc[m]);
      }
    }
    __syncthreads();   // tiles are overwritten by the next iteration
  }

  const int qr = q0 + r2;
  if (qr < Sq) {
    const float inv = 1.f / fmaxf(l_run, 1e-30f);
    float* orow = o + b * so.b + qr * so.s + h * so.h;
#pragma unroll
    for (int m = 0; m < ACC; ++m) {
      int d = l2 + 4 * m;
      if (d < dv) orow[d] = acc[m] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: both products on the tensor cores (mma.sync m16n8k16, bf16 inputs,
// f32 accumulate). The same tiling (64 q rows x 64 keys per step), one
// warp per 16 q rows; scores, running max/sum and the output accumulator
// stay in registers, in the mma fragment layout. P is rounded to bf16
// before the second product, as the reference rounds p to v's dtype.
// Head dims are zero-padded in shared memory to a multiple of 16 (q, k) or
// 8 (v); DMAX (64 or 128) sizes the register arrays.
// ---------------------------------------------------------------------------
constexpr int MMA_WARPS = BQ / 16;
constexpr int MMA_THREADS = 32 * MMA_WARPS;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int DMAX>
__global__ void __launch_bounds__(MMA_THREADS)
fa_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o,
                  int H, int G, int Sq, int Skv, int dq, int dv,
                  Strides sq, Strides sk, Strides sv, Strides so,
                  float scale, int causal, int kv_len) {
  constexpr int LD = DMAX + 8;    // q/k row stride: conflict-free 32-bit reads
  constexpr int LDV = BK + 8;     // v^T row stride
  constexpr int NK = DMAX / 16;   // k-steps of the first product
  constexpr int NV = DMAX / 8;    // n-tiles of the output
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* k_s = q_s + BQ * LD;          // BK x LD
  __nv_bfloat16* vt_s = k_s + BK * LD;         // DMAX x LDV (v transposed)

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;      // fragment row / column pair
  const int dqp = (dq + 15) / 16 * 16;
  const int dvp = (dv + 7) / 8 * 8;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + (h / G) * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + (h / G) * sv.h;

  for (int i = tid; i < BQ * dqp; i += MMA_THREADS) {
    int r = i / dqp, d = i - r * dqp;
    int qr = q0 + r;
    q_s[r * LD + d] = (qr < Sq && d < dq) ? qb[qr * sq.s + d] : zero;
  }
  __syncthreads();
  const int wr = warp * 16;
  uint32_t qf[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    if (kk * 16 < dqp) {
      const __nv_bfloat16* base = q_s + (wr + g) * LD + kk * 16 + 2 * t;
      qf[kk][0] = ld32(base);
      qf[kk][1] = ld32(base + 8 * LD);
      qf[kk][2] = ld32(base + 8);
      qf[kk][3] = ld32(base + 8 * LD + 8);
    }
  }

  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, min(q0 + BQ, Sq));
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float acc[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();   // the previous tile is no longer read
    for (int i = tid; i < BK * dqp; i += MMA_THREADS) {
      int c = i / dqp, d = i - c * dqp;
      int kr = k0 + c;
      k_s[c * LD + d] = (kr < Skv && d < dq) ? kb[kr * sk.s + d] : zero;
    }
    for (int i = tid; i < BK * dvp; i += MMA_THREADS) {
      int c = i / dvp, d = i - c * dvp;
      int kr = k0 + c;
      vt_s[d * LDV + c] = (kr < Skv && d < dv) ? vb[kr * sv.s + d] : zero;
    }
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        if (kk * 16 < dqp) {
          const __nv_bfloat16* kp = k_s + (8 * j + g) * LD + kk * 16 + 2 * t;
          mma_bf16(s[j], qf[kk], ld32(kp), ld32(kp + 8));
        }
      }
    }

    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int kpos = k0 + 8 * j + 2 * t + (e & 1);
        int qpos = e < 2 ? row0 : row1;
        bool ok = kpos < kv_len && (!causal || kpos <= qpos);
        s[j][e] = ok ? s[j][e] * scale : NEG_INF;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = expf(s[j][0] - mn0);
      s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1);
      s[j][3] = expf(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int off = 1; off <= 2; off *= 2) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      acc[j][0] *= al0; acc[j][1] *= al0;
      acc[j][2] *= al1; acc[j][3] *= al1;
    }

#pragma unroll
    for (int tt = 0; tt < BK / 16; ++tt) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * tt][0], s[2 * tt][1]);
      pa[1] = pack_bf16(s[2 * tt][2], s[2 * tt][3]);
      pa[2] = pack_bf16(s[2 * tt + 1][0], s[2 * tt + 1][1]);
      pa[3] = pack_bf16(s[2 * tt + 1][2], s[2 * tt + 1][3]);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (j * 8 < dvp) {
          const __nv_bfloat16* vp = vt_s + (8 * j + g) * LDV + tt * 16 + 2 * t;
          mma_bf16(acc[j], pa, ld32(vp), ld32(vp + 8));
        }
      }
    }
  }

  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int row = e < 2 ? row0 : row1;
      int col = 8 * j + 2 * t + (e & 1);
      if (row < Sq && col < dv)
        o[b * so.b + row * so.s + h * so.h + col] =
            __float2bfloat16(acc[j][e] * (e < 2 ? inv0 : inv1));
    }
  }
}

template <int DMAX>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int KV, int Sq, int Skv, int dq, int dv,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       float scale, int causal, int kv_len,
                       cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) *
      (size_t)((BQ + BK) * (DMAX + 8) + DMAX * (BK + 8));
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_mma_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_fwd_mma_kernel<DMAX><<<grid, MMA_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, H, H / KV, Sq, Skv, dq,
      dv, sq, sk, sv, so, scale, causal, kv_len);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int KV, int Sq, int Skv, int dq, int dv,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       float scale, int causal, int kv_len,
                       cudaStream_t stream) {
  const int ldq = dq | 1;
  size_t smem = sizeof(float) *
      (size_t)(BQ * ldq + BK * ldq + BK * dv + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_fwd_f32_kernel<<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, H,
      H / KV, Sq, Skv, dq, dv, sq, sk, sv, so, scale, causal, kv_len);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int fa_fwd(int dtype, const void* q, const void* k, const void* v,
                      void* o, int B, int H, int KV, int Sq, int Skv, int dq,
                      int dv, long long qb, long long qs, long long qh,
                      long long kb, long long ks, long long kh, long long vb,
                      long long vs, long long vh, long long ob, long long os,
                      long long oh, float scale, int causal, int kv_len,
                      void* stream) {
  if (dq < 1 || dv < 1 || dq > MAX_D || dv > MAX_D || KV < 1 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  Strides sq{qb, qs, qh}, sk{kb, ks, kh}, sv{vb, vs, vh}, so{ob, os, oh};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 0)
    err = launch_f32(q, k, v, o, B, H, KV, Sq, Skv, dq, dv, sq, sk, sv, so,
                     scale, causal, kv_len, st);
  else if ((dq + 15) / 16 * 16 <= 64 && (dv + 7) / 8 * 8 <= 64)
    err = launch_mma<64>(q, k, v, o, B, H, KV, Sq, Skv, dq, dv, sq, sk, sv,
                         so, scale, causal, kv_len, st);
  else
    err = launch_mma<128>(q, k, v, o, B, H, KV, Sq, Skv, dq, dv, sq, sk, sv,
                          so, scale, causal, kv_len, st);
  return (int)err;
}
