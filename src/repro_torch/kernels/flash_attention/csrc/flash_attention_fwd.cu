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
// (q, k) pairs' two products ~3 GFLOP: ~4.5 us of HBM traffic against
// ~2.8 us of bf16 tensor-core work, so the bound is bytes. At a 2048-token
// prompt the products (69 GFLOP, ~70 us) bound it.
//
// Head dims: any dq, dv up to 128 in one launch. Each body is
// instantiated for a few dq and dv bounds and pads up to the bound in
// shared memory, as the TPU kernel's wrapper pads every head dim to a
// multiple of 128 lanes. The tma body takes dq up to 256 (MLA's 128 + 64
// = 192 is the widest a model here uses). Above 256 the mma and f32 bodies
// stream q and k through shared memory in head-dim slices of 256 and sum
// the scores over the slices in f32 registers before the softmax: a whole
// 64-row bf16 q tile at dq 576 is 72 KB, as is one 64-key k tile, so
// wider tiles would not fit a block's 227 KB beside V. A dv above 128 is
// the wrapper's: O = P V is independent per output column and P does not
// depend on v, so it launches once per block of 128 columns of v and o.
//
// Three bodies; the wrapper (kernel.py `_body`) picks one from the shapes,
// strides and dtype alone:
//   * tma  — bf16 where TMA can address q, k, v and o (16-B aligned bases,
//     strides multiples of 16 B, head dims multiples of 8, dq <= 256). One
//     block per (128-row q tile, q head, batch): a producer warp loads the
//     q tile once and streams 64-key K/V tiles into a two-stage ring by TMA
//     (128-B swizzle, one 64-element box per head-dim slice, zero fill
//     past the sequence and head-dim edges), completing on mbarriers; two
//     consumer warpgroups of 64 q rows run wgmma: S = Q K^T with both
//     operands in shared memory (K-major), O += P V with P from registers
//     (rounded to bf16, as the reference rounds p to v's dtype) and V read
//     in place as an MN-major operand. Softmax state stays in f32
//     registers, scale and log2 e folded into one exp2; causal tiles past
//     the block's diagonal are never loaded, a warpgroup skips those past
//     its own rows' diagonal, and only tiles that cross it or kv_len are
//     masked. The output goes through shared memory (swizzled) and a TMA
//     store.
//   * mma  — bf16 for what TMA cannot address (odd strides, head dims
//     not a multiple of 8, dq above 256): mma.sync m16n8k16, four warps of
//     16 q rows, 64-key tiles staged by plain loads.
//   * f32  — the products on the CUDA cores (tensor-core TF32 would miss
//     the reference's 2e-5 tolerance), 256 threads with a 4x4 register
//     micro-tile for the scores and a quad of threads per output row; dq
//     is only the first product's loop length, dv sizes the accumulator.

#include <cuda.h>          // CUtensorMap; the encoder is found at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;
constexpr int MAX_DQ = 256;     // q/k head-dim columns staged at once
constexpr int MAX_DV = 128;     // v head dim of one launch
constexpr int MAX_GRID = 65535; // q heads (grid y) and batch rows (grid z)
constexpr int ACC = MAX_DV / 4; // accumulator slots per thread
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, s, h;
};

// ---------------------------------------------------------------------------
// f32: the products on the CUDA cores. SLICED (dq > MAX_DQ): q and k pass
// through shared memory in head-dim slices of MAX_DQ, q restaged with each
// key tile, and the scores add up over the slices in registers in
// head-dim order, as over one slice.
// ---------------------------------------------------------------------------
template <bool SLICED>
__global__ void __launch_bounds__(THREADS)
fa_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  int H, int G, int Sq, int Skv, int dq, int dv,
                  Strides sq, Strides sk, Strides sv, Strides so,
                  float scale, int causal, int kv_len) {
  extern __shared__ float smem[];
  const int dw = SLICED ? MAX_DQ : dq;  // head-dim columns staged at once
  const int ldq = dw | 1;       // odd row stride: conflict-free column reads
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

  // q's head-dim columns d0 .. d0 + w - 1 into q_s
  auto stage_q = [&](int d0, int w) {
    for (int i = tid; i < BQ * w; i += THREADS) {
      int r = i / w, d = i - r * w;
      int qr = q0 + r;
      q_s[r * ldq + d] = qr < Sq ? qb[qr * sq.s + d0 + d] : 0.f;
    }
  };
  if (!SLICED) stage_q(0, dq);

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
    for (int i = tid; i < BK * dv; i += THREADS) {
      int c = i / dv, d = i - c * dv;
      int kr = k0 + c;
      v_s[c * dv + d] = kr < Skv ? vb[kr * sv.s + d] : 0.f;
    }
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < dq; d0 += dw) {   // once unless SLICED
      const int w = min(dw, dq - d0);
      if (SLICED) {
        if (d0 > 0) __syncthreads();   // the previous slice is read
        stage_q(d0, w);
      }
      for (int i = tid; i < BK * w; i += THREADS) {
        int c = i / w, d = i - c * w;
        int kr = k0 + c;
        k_s[c * ldq + d] = kr < Skv ? kb[kr * sk.s + d0 + d] : 0.f;
      }
      __syncthreads();

      for (int d = 0; d < w; ++d) {
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
// 8 (v); DQM (64, 128 or 256) and DVM (64 or 128) size the register arrays.
// SLICED (dq > DQM): q and k pass through shared memory in head-dim slices
// of DQM, q restaged with each key tile and its fragments read from shared
// memory, and S adds up over the slices in the f32 accumulators.
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

template <int DQM, int DVM, bool SLICED>
__global__ void __launch_bounds__(MMA_THREADS)
fa_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o,
                  int H, int G, int Sq, int Skv, int dq, int dv,
                  Strides sq, Strides sk, Strides sv, Strides so,
                  float scale, int causal, int kv_len) {
  constexpr int LD = DQM + 8;     // q/k row stride: conflict-free 32-bit reads
  constexpr int LDV = BK + 8;     // v^T row stride
  constexpr int NK = DQM / 16;    // k-steps of the first product
  constexpr int NV = DVM / 8;     // n-tiles of the output
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* k_s = q_s + BQ * LD;          // BK x LD
  __nv_bfloat16* vt_s = k_s + BK * LD;         // DVM x LDV (v transposed)

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

  const int wr = warp * 16;
  uint32_t qf[SLICED ? 1 : NK][4];
  if constexpr (!SLICED) {
    for (int i = tid; i < BQ * dqp; i += MMA_THREADS) {
      int r = i / dqp, d = i - r * dqp;
      int qr = q0 + r;
      q_s[r * LD + d] = (qr < Sq && d < dq) ? qb[qr * sq.s + d] : zero;
    }
    __syncthreads();
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
  }
  // v^T of the key tile at k0 into vt_s
  auto stage_vt = [&](int k0) {
    for (int i = tid; i < BK * dvp; i += MMA_THREADS) {
      int c = i / dvp, d = i - c * dvp;
      int kr = k0 + c;
      vt_s[d * LDV + c] = (kr < Skv && d < dv) ? vb[kr * sv.s + d] : zero;
    }
  };

  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, min(q0 + BQ, Sq));
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float acc[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    float s[BK / 8][4];
    if constexpr (!SLICED) {
      __syncthreads();   // the previous tile is no longer read
      for (int i = tid; i < BK * dqp; i += MMA_THREADS) {
        int c = i / dqp, d = i - c * dqp;
        int kr = k0 + c;
        k_s[c * LD + d] = (kr < Skv && d < dq) ? kb[kr * sk.s + d] : zero;
      }
      stage_vt(k0);
      __syncthreads();

#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          if (kk * 16 < dqp) {
            const __nv_bfloat16* kp = k_s + (8 * j + g) * LD + kk * 16
                                      + 2 * t;
            mma_bf16(s[j], qf[kk], ld32(kp), ld32(kp + 8));
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      for (int d0 = 0; d0 < dq; d0 += DQM) {
        const int w = min(DQM, dq - d0), wp = (w + 15) / 16 * 16;
        __syncthreads();   // the previous slice or tile is no longer read
        for (int i = tid; i < BQ * wp; i += MMA_THREADS) {
          int r = i / wp, d = i - r * wp;
          int qr = q0 + r;
          q_s[r * LD + d] = (qr < Sq && d < w) ? qb[qr * sq.s + d0 + d]
                                               : zero;
        }
        for (int i = tid; i < BK * wp; i += MMA_THREADS) {
          int c = i / wp, d = i - c * wp;
          int kr = k0 + c;
          k_s[c * LD + d] = (kr < Skv && d < w) ? kb[kr * sk.s + d0 + d]
                                                : zero;
        }
        if (d0 == 0) stage_vt(k0);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          if (kk * 16 < wp) {
            const __nv_bfloat16* base = q_s + (wr + g) * LD + kk * 16 + 2 * t;
            const uint32_t qa[4] = {ld32(base), ld32(base + 8 * LD),
                                    ld32(base + 8), ld32(base + 8 * LD + 8)};
#pragma unroll
            for (int j = 0; j < BK / 8; ++j) {
              const __nv_bfloat16* kp = k_s + (8 * j + g) * LD + kk * 16
                                        + 2 * t;
              mma_bf16(s[j], qa, ld32(kp), ld32(kp + 8));
            }
          }
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

template <int DQM, int DVM, bool SLICED = false>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int KV, int Sq, int Skv, int dq, int dv,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       float scale, int causal, int kv_len,
                       cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) *
      (size_t)((BQ + BK) * (DQM + 8) + DVM * (BK + 8));
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_mma_kernel<DQM, DVM, SLICED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_fwd_mma_kernel<DQM, DVM, SLICED><<<grid, MMA_THREADS, smem, stream>>>(
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
  const bool sliced = dq > MAX_DQ;
  const int ldq = (sliced ? MAX_DQ : dq) | 1;
  size_t smem = sizeof(float) *
      (size_t)(BQ * ldq + BK * ldq + BK * dv + BQ * (BK + 1));
  auto kern = sliced ? fa_fwd_f32_kernel<true> : fa_fwd_f32_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, H,
      H / KV, Sq, Skv, dq, dv, sq, sk, sv, so, scale, causal, kv_len);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tma: bf16 on TMA, mbarriers and wgmma.
// ---------------------------------------------------------------------------
constexpr int TQ = 128;            // q rows per block: two warpgroups of 64
constexpr int TMA_THREADS = 288;   // two consumer warpgroups + a producer warp
constexpr int ROWB = 128;          // bytes per shared-memory row: one box of
                                   // 64 bf16, the 128-B swizzle's span
constexpr float LOG2E = 1.4426950408889634f;

// 64 keys per stage keep the d=64 body at ~95 registers, so two blocks
// (four consumer warpgroups) share an SM; 128 keys took ~159 and one block,
// and ran slower on an H100 at both the serve shape and S=2048, as did a
// ring of 4 stages (PERF.md).
constexpr int BN = 64;             // keys per K/V stage
constexpr int NST = 2;             // K/V ring stages

// Shared-memory plan of one block, in bytes from a 1024-B aligned base (the
// swizzle repeats every 8 rows of 128 B). The q region holds the q tile,
// one 128-row box per 64-wide head-dim slice, and afterwards each
// warpgroup's rows of the output.
template <int DQ, int DV>
struct TmaPlan {
  static constexpr int NQB = DQ / 64, NVB = DV / 64;
  static constexpr int QBOX = TQ * ROWB;
  static constexpr int QREG = (NQB > NVB ? NQB : NVB) * QBOX;
  static constexpr int KBOX = BN * ROWB;
  static constexpr int KSTAGE = NQB * KBOX, VSTAGE = NVB * KBOX;
  static constexpr int OFF_K = QREG;
  static constexpr int OFF_V = OFF_K + NST * KSTAGE;
  static constexpr int OFF_BAR = OFF_V + NST * VSTAGE;
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 3 * NST) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Returns once the phase of parity `parity` has completed. A wait that
// never ends (seconds of polls) traps, so a fault shows as a launch error
// and not as a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a 128-B swizzled tile: 8-row groups
// 1024 B apart (SBO); LBO is the distance between 64-element slices of an
// MN-major operand (unused, 16 B, for K-major ones).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
       | (static_cast<uint64_t>(1024 >> 4) << 32)
       | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
// Returns once every committed wgmma group has completed.
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from touching registers that an in-flight wgmma
// reads or writes: called after the wait.
template <int R>
__device__ __forceinline__ void reg_fence(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int R>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e]) :: "memory");
}

// m64nNk16 bf16 -> f32. wgmma_ss (N = 64, one tile of keys): A and B from
// shared memory, both K-major. wgmma_rs (N = 64 or 128, the value width): A
// from registers, B from shared memory MN-major (the transpose flag, which
// 16-bit types allow).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DQ, int DV>
__global__ void __launch_bounds__(TMA_THREADS, 1)
fa_fwd_tma_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap to,
                  int G, int Sq, float scale_log2, int causal, int kv_len) {
  using P = TmaPlan<DQ, DV>;
  extern __shared__ unsigned char tma_smem[];
  const uint32_t raw = smem_u32(tma_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const gbase = tma_smem + (base - raw);
  const uint32_t q_s = base, k_s = base + P::OFF_K, v_s = base + P::OFF_V;
  // barriers: q_full, then k_full[NST], v_full[NST], empty[NST]
  const uint32_t q_full = base + P::OFF_BAR;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * NST;
  const uint32_t empty = v_full + 8 * NST;

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * TQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // keys this tile needs: up to kv_len, and with causal up to its last row
  const int kv_end = causal ? min(kv_len, q0 + TQ) : kv_len;
  const int ntiles = (kv_end + BN - 1) / BN;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);   // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {   // producer: one thread issues every copy
    if (lane == 0) {
      const int kvh = h / G;
      mbar_expect_tx(q_full, P::NQB * P::QBOX);
      for (int i = 0; i < P::NQB; ++i)
        tma_load(q_s + i * P::QBOX, &tq, q_full, 64 * i, h, q0, b);
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % NST;
        const uint32_t par = (it / NST) & 1;
        mbar_wait(empty + 8 * st, par ^ 1);   // passes at once in round 0
        mbar_expect_tx(k_full + 8 * st, P::KSTAGE);
        for (int i = 0; i < P::NQB; ++i)
          tma_load(k_s + st * P::KSTAGE + i * P::KBOX, &tk, k_full + 8 * st,
                   64 * i, kvh, it * BN, b);
        mbar_expect_tx(v_full + 8 * st, P::VSTAGE);
        for (int i = 0; i < P::NVB; ++i)
          tma_load(v_s + st * P::VSTAGE + i * P::KBOX, &tv, v_full + 8 * st,
                   64 * i, kvh, it * BN, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows rbase .. rbase + 63; each thread
  // holds rows row0 and row1 of the wgmma fragment layout
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t = lane % 4;
  const int rbase = q0 + 64 * wg;
  const int row0 = rbase + 16 * wq + g, row1 = row0 + 8;
  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  float s[BN / 2];          // scores of one tile, then their exponentials
  uint32_t pa[BN / 16][4];  // P as the A operand of O += P V

  // S = Q K^T of tile `it` into s, issued (not waited for)
  auto issue_s = [&](int it) {
    const int st = it % NST;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    mbar_wait(k_full + 8 * st, (it / NST) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DQ / 16; ++kk) {
      const uint32_t qa = q_s + (kk / 4) * P::QBOX + wg * 64 * ROWB
                          + (kk % 4) * 32;
      const uint32_t ka = k_s + st * P::KSTAGE + (kk / 4) * P::KBOX
                          + (kk % 4) * 32;
      wgmma_ss(s, sw128_desc(qa, 16), sw128_desc(ka, 16), kk > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };
  // O += P V of tile `it` from pa, issued (not waited for)
  auto issue_pv = [&](int it) {
    const int st = it % NST;
    mbar_wait(v_full + 8 * st, (it / NST) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t va = v_s + st * P::VSTAGE + kk * 16 * ROWB;
      wgmma_rs(o, pa[kk], sw128_desc(va, P::KBOX), 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };
  // online softmax of tile `it`'s scores in s: masks, exponentials in
  // place, running max and sum; returns the rescale factors of O
  auto softmax = [&](int it, float& al0, float& al1) {
    const int k0 = it * BN;
    // scale into the exp2 domain; mask only tiles that cross kv_len or
    // this warpgroup's diagonal
    const bool edge = k0 + BN > kv_len || (causal && k0 + BN - 1 > rbase);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale_log2;
        if (edge) {
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          const int qpos = e < 2 ? row0 : row1;
          if (kpos >= kv_len || (causal && kpos > qpos)) x = NEG_INF;
        }
        s[4 * j + e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    al0 = fast_exp2(m0 - mx0);
    al1 = fast_exp2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;   // this thread's share; the quad's
                                    // shares are added once, at the end
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s[4 * j + 0] = fast_exp2(s[4 * j + 0] - mx0);
      s[4 * j + 1] = fast_exp2(s[4 * j + 1] - mx0);
      s[4 * j + 2] = fast_exp2(s[4 * j + 2] - mx1);
      s[4 * j + 3] = fast_exp2(s[4 * j + 3] - mx1);
      sum0 += s[4 * j + 0] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
  };
  auto rescale = [&](float al0, float al1) {
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      o[4 * j + 0] *= al0; o[4 * j + 1] *= al0;
      o[4 * j + 2] *= al1; o[4 * j + 3] *= al1;
    }
  };
  // P rounded to bf16: the accumulator layout of two adjacent 8-key
  // column tiles is the A fragment of one 16-key step
  auto pack_p = [&] {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  // tiles this warpgroup computes: none if its rows lie past Sq, and with
  // causal none wholly above its own diagonal. It still releases the
  // others, which the other warpgroup reads, once they have landed: an
  // early arrival would count towards the stage's previous round.
  const int wg_end = rbase >= Sq ? 0 : causal ? min(kv_len, rbase + 64)
                                              : kv_len;
  const int wg_tiles = min(ntiles, (wg_end + BN - 1) / BN);
  mbar_wait(q_full, 0);
  float al0, al1;
  for (int it = 0; it < ntiles; ++it) {
    if (it >= wg_tiles) {
      const int st = it % NST;
      mbar_wait(k_full + 8 * st, (it / NST) & 1);
      mbar_wait(v_full + 8 * st, (it / NST) & 1);
      mbar_arrive(empty + 8 * st);
      continue;
    }
    issue_s(it);
    wg_wait_all();
    reg_fence(s);
    softmax(it, al0, al1);
    rescale(al0, al1);
    pack_p();
    issue_pv(it);
    wg_wait_all();
    reg_fence(o);
    reg_fence(pa);
    mbar_arrive(empty + 8 * (it % NST));
  }

#pragma unroll
  for (int off = 1; off <= 2; off *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  // stage this warpgroup's 64 output rows over its own q rows (its last
  // wgmma has completed), in the swizzled layout the O map stores from
  unsigned char* const osm = gbase + wg * 64 * ROWB;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * wq + g + 8 * half;
      const int off = (j / 8) * P::QBOX + r * ROWB + (((j % 8) ^ g) * 16)
                      + 4 * t;
      const float inv = half ? inv1 : inv0;
      *reinterpret_cast<__nv_bfloat162*>(osm + off) = __floats2bfloat162_rn(
          o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  if (tid % 128 == 0 && rbase < Sq) {
    for (int i = 0; i < P::NVB; ++i)
      tma_store(&to, base + i * P::QBOX + wg * 64 * ROWB, 64 * i, h, rbase, b);
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// cuTensorMapEncodeTiled is a driver-API call: found in the driver library
// the process has already loaded, so the build needs no link flag.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"))
             : nullptr;
  }();
  return fn;
}

// A (d, heads, seq, batch) map of a bf16 tensor with the given element
// strides; boxes of 64 head-dim elements x `rows` positions of one head.
bool make_map(CUtensorMap* map, const void* ptr, int d, int heads, int seq,
              int batch, Strides s, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s.h * 2, (cuuint64_t)s.s * 2,
                                 (cuuint64_t)s.b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQ, int DV>
cudaError_t launch_tma(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int KV, int Sq, int Skv, int dq, int dv,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       float scale, int causal, int kv_len,
                       cudaStream_t stream) {
  using P = TmaPlan<DQ, DV>;
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, q, dq, H, Sq, B, sq, TQ) ||
      !make_map(&tk, k, dq, KV, Skv, B, sk, BN) ||
      !make_map(&tv, v, dv, KV, Skv, B, sv, BN) ||
      !make_map(&to, o, dv, H, Sq, B, so, 64))
    return cudaErrorInvalidValue;
  static bool configured = false;   // the attribute is set once per body
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_fwd_tma_kernel<DQ, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        P::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((Sq + TQ - 1) / TQ, H, B);
  fa_fwd_tma_kernel<DQ, DV><<<grid, TMA_THREADS, P::SMEM, stream>>>(
      tq, tk, tv, to, H / KV, Sq, scale * LOG2E, causal, kv_len);
  return cudaGetLastError();
}

}  // namespace

// body: 0 = f32, 1 = mma (bf16), 2 = tma (bf16); the caller picks it (see
// the note at the top). Strides are in elements. One launch takes dv <=
// MAX_DV, B and H <= MAX_GRID, and on the tma body dq <= MAX_DQ; the
// wrapper cuts larger calls into such launches. Returns the CUDA error
// code of the launch (0 on success; cudaErrorInvalidValue for arguments
// past those limits or if a tensor map cannot be encoded).
extern "C" int fa_fwd(int body, const void* q, const void* k, const void* v,
                      void* o, int B, int H, int KV, int Sq, int Skv, int dq,
                      int dv, long long qb, long long qs, long long qh,
                      long long kb, long long ks, long long kh, long long vb,
                      long long vs, long long vh, long long ob, long long os,
                      long long oh, float scale, int causal, int kv_len,
                      void* stream) {
  if (dq < 1 || dv < 1 || dv > MAX_DV || (body == 2 && dq > MAX_DQ)
      || KV < 1 || H % KV != 0 || body < 0 || body > 2 || B > MAX_GRID
      || H > MAX_GRID)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  Strides sq{qb, qs, qh}, sk{kb, ks, kh}, sv{vb, vs, vh}, so{ob, os, oh};
  cudaStream_t st = (cudaStream_t)stream;
#define FA_ARGS q, k, v, o, B, H, KV, Sq, Skv, dq, dv, sq, sk, sv, so, scale, \
                causal, kv_len, st
  cudaError_t err;
  if (body == 0)
    err = launch_f32(FA_ARGS);
  else if (body == 1)
    err = (dq + 15) / 16 * 16 <= 64 && (dv + 7) / 8 * 8 <= 64
              ? launch_mma<64, 64>(FA_ARGS)
          : (dq + 15) / 16 * 16 <= 128 ? launch_mma<128, 128>(FA_ARGS)
          : dq <= MAX_DQ ? launch_mma<256, 128>(FA_ARGS)
                         : launch_mma<MAX_DQ, MAX_DV, true>(FA_ARGS);
  else if (dq <= 64)
    err = dv <= 64 ? launch_tma<64, 64>(FA_ARGS) : launch_tma<64, 128>(FA_ARGS);
  else if (dq <= 128)
    err = dv <= 64 ? launch_tma<128, 64>(FA_ARGS)
                   : launch_tma<128, 128>(FA_ARGS);
  else if (dq <= 192)
    err = dv <= 64 ? launch_tma<192, 64>(FA_ARGS)
                   : launch_tma<192, 128>(FA_ARGS);
  else
    err = dv <= 64 ? launch_tma<256, 64>(FA_ARGS)
                   : launch_tma<256, 128>(FA_ARGS);
#undef FA_ARGS
  return (int)err;
}
