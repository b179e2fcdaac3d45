// SHA-256 of many byte ranges of device memory at once, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package hashes MDSS's values on the host
// (src/repro/cloud/wire.py, `manifest_of`). The port's MDSS keys its chunk
// index, the wire's dedup and step memoization on the same digests, and
// its largest values (the train state: bf16 params and AdamW's f32
// moments) live on the card. Hashing them there keeps every digest and
// moves only 16 bytes per chunk off the card, where the host path copied
// every byte to pageable memory and ran SHA-256 over it on one core.
//
// Input: a table of rows {src, len, out} (three int64 each). Each row's
// `len` bytes at `src` (16-B aligned; any length, 0 included) are hashed
// and the first 16 bytes of the SHA-256 digest are written to `out` (16-B
// aligned): byte for byte `hashlib.sha256(piece).digest()[:16]`.
//
// What bounds it on one H100. SHA-256 needs, per 64-byte block, in the
// card's three-input integer instructions (SHF for a rotation, LOP3 for
// any three-input logic, IADD3 for three-input adds): 64 rounds of 14
// (Sigma0 and Sigma1: 3 SHF + 1 LOP3 each; Ch, Maj: 1 LOP3 each; T1 =
// h + K + W + Sigma1 + Ch: 2 IADD3; e = d + T1, a = T1 + Sigma0 + Maj: 1
// IADD3 each), 48 schedule words of 10 (sigma0, sigma1: 2 SHF + 1 SHR + 1
// LOP3 each; 2 IADD3), 8 adds into the state and 16 byte swaps (PRMT):
// 1,400 operations (the build's main loop has 1,409 instructions). For the
// train cell's state (9.54 GB, ~9,100 chunks of 1 MiB):
//   * bytes: 9.54 GB / 3.35 TB/s = 2.85 ms;
//   * operations: 149 M blocks x 1,400 over 132 SMs x 64 lanes at 1.98
//     GHz = 12.5 ms. 64 lanes a clock per SM is the rate of 32-bit integer
//     add, logic and funnel shift on compute capability 9.0 (the ALU
//     pipe); adds issued as IMAD on the FMA pipe beside it could at most
//     halve this bound (the 128-lane issue limit);
//   * one chunk's chain: its 16,385 compressions run in order on one
//     thread, and its warp issues at most one instruction a cycle, so one
//     1 MiB chunk takes at least 16,385 x 1,400 / 1.98 GHz = 11.6 ms,
//     however many chunks run beside it (up to one warp on each of the
//     4 x 132 sub-partitions, ~16,900 chunks). Measured: 21-27 ms, the
//     dependent rounds holding a lone warp near half an instruction a
//     cycle (PERF.md).
// The third sets the time of every value up to that size; the first two
// are reached only past it. With one thread per chunk (the digest's
// definition fixes each chunk's order) a value costs about one chunk's
// chain, whatever its size.
//
// Design. One thread hashes one row. Blocks of 32 threads, so the ~9,100
// chunks of the train state spread over every SM, each warp on a scheduler
// of its own where the grid allows. The message is read as four 16-byte
// vector loads per block through the read-only path, one block ahead of
// the compression that consumes it, so a load's latency hides behind the
// previous block's 64 rounds. Words are byte-swapped with __byte_perm,
// rotations are __funnelshift_r, the 64 round constants sit in __constant__
// memory (fully unrolled rounds read them as immediate bank operands) and
// the schedule is a ring of 16 words in registers. The tail (the last
// len % 64 bytes, the 0x80 marker and the 64-bit bit length, one or two
// blocks) is assembled in registers from byte loads that never read past
// `len`, so a zero-length row reads nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;

__constant__ uint32_t kRound[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
    0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
    0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
    0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
    0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
    0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
    0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
    0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

struct Row {
  long long src;   // device address of the first byte
  long long len;   // bytes
  long long out;   // device address of the 16-byte digest
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, uint32_t n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ uint32_t swap(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// One compression of the 16 big-endian message words `w` into `s`; `w` is
// the schedule's ring and is overwritten.
__device__ __forceinline__ void compress(uint32_t s[8], uint32_t w[16]) {
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
  uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {            // W[i] = s1(W[i-2]) + W[i-7] + s0(W[i-15]) + W[i-16]
      const uint32_t x = w[(i + 1) & 15], y = w[(i + 14) & 15];
      w[i & 15] += (rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3)) + w[(i + 9) & 15]
                   + (rotr(y, 17) ^ rotr(y, 19) ^ (y >> 10));
    }
    const uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25))
                        + ((e & f) ^ (~e & g)) + kRound[i] + w[i & 15];
    const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22))
                        + ((a & b) | (c & (a | b)));
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  s[0] += a; s[1] += b; s[2] += c; s[3] += d;
  s[4] += e; s[5] += f; s[6] += g; s[7] += h;
}

__global__ void __launch_bounds__(kThreads)
sha256_chunks_kernel(const Row* __restrict__ rows, int n) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const Row row = rows[r];
  const uint4* __restrict__ p = reinterpret_cast<const uint4*>(row.src);
  const long long full = row.len >> 6;          // whole 64-byte blocks
  uint32_t s[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                   0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
  uint4 next[4];
  if (full > 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) next[k] = __ldg(p + k);
  }
#pragma unroll 1
  for (long long blk = 0; blk < full; ++blk) {
    uint32_t w[16];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[4 * k] = swap(next[k].x);
      w[4 * k + 1] = swap(next[k].y);
      w[4 * k + 2] = swap(next[k].z);
      w[4 * k + 3] = swap(next[k].w);
    }
    if (blk + 1 < full) {     // the next block's loads fly during this one
#pragma unroll
      for (int k = 0; k < 4; ++k) next[k] = __ldg(p + 4 * (blk + 1) + k);
    }
    compress(s, w);
  }
  // The tail: len % 64 bytes, 0x80, zeros, the length in bits (big-endian
  // 64-bit) in the last 8 bytes; two blocks where the bytes and the marker
  // leave fewer than 8.
  const unsigned char* tail =
      reinterpret_cast<const unsigned char*>(row.src) + (full << 6);
  const int rem = static_cast<int>(row.len & 63);
  const int blocks = rem >= 56 ? 2 : 1;
  const unsigned long long bits = static_cast<unsigned long long>(row.len) << 3;
#pragma unroll 1
  for (int q = 0; q < blocks; ++q) {
    uint32_t w[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * j + k;
        const uint32_t byte =
            q > 0 ? 0u : (i < rem ? tail[i] : (i == rem ? 0x80u : 0u));
        word = (word << 8) | byte;
      }
      w[j] = word;
    }
    if (q == blocks - 1) {
      w[14] = static_cast<uint32_t>(bits >> 32);
      w[15] = static_cast<uint32_t>(bits);
    }
    compress(s, w);
  }
  *reinterpret_cast<uint4*>(row.out) =
      make_uint4(swap(s[0]), swap(s[1]), swap(s[2]), swap(s[3]));
}

}  // namespace

// Hashes the `n` rows of `rows` (a device array of n x 3 int64: src, len,
// out) on `stream`; returns the launch's CUDA error (0 if queued).
extern "C" int sha256_chunks(const void* rows, int n, void* stream) {
  if (n < 0 || (n > 0 && !rows)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int grid = (n + kThreads - 1) / kThreads;
  sha256_chunks_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const Row*>(rows), n);
  return (int)cudaGetLastError();
}
