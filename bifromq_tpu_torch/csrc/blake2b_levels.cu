// BLAKE2b-8 level hashing: one final-block compression per (row, level).
//
// Replaces: the Pallas kernel `_build_pallas` in bifromq_tpu/ops/tokenize.py
// (body `_hash_lanes`), reached through `hash_topics_device`. Plain
// version: `_hash_lanes` in bifromq_tpu_torch/ops/tokenize.py.
//
// What it computes: for every lane (row r, level l < nlv[r]) the BLAKE2b
// (RFC 7693) digest_size=8 hash of the level's bytes rows[r, starts[r,l] :
// starts[r,l] + lens[r,l]] under the salt-folded initial state h0, as the
// low and high int32 halves of digest word 0. Lanes at or past nlv[r] are
// zero; nlv == -1 marks a padding row. Bit-exact with
// automaton.level_hash for levels of at most 128 bytes (one block).
//
// What bounds it on an H100: at the main-path shape (B = 16384 rows,
// W = 17 lanes, 256-byte rows) it moves about 8.7 MB (the byte block, the
// boundary grids and the two outputs) and runs about 2.7K 32-bit
// operations per live lane (12 rounds x 8 G-functions x 14 64-bit ops);
// with ~3.5 live lanes per row the two bounds are within a factor of two
// of each other, a few microseconds each.
//
// What the design does about it: one thread per lane with the 16-word
// state in native uint64_t registers (the reference's (lo, hi) uint32
// emulation was a TPU workaround), the 12 rounds written out with literal
// message indices so the message block never leaves registers, and the
// level bytes read straight from the row block with the byte mask at
// `lens` — no gather buffer in device memory. The ragged batch needs no
// tile padding: threads past B*W return. Later work can load the row
// bytes 16 at a time and share them across a row's lanes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

#define G(a, b, c, d, x, y)        \
  do {                             \
    a = a + b + (x);               \
    d = rotr64(d ^ a, 32);         \
    c = c + d;                     \
    b = rotr64(b ^ c, 24);         \
    a = a + b + (y);               \
    d = rotr64(d ^ a, 16);         \
    c = c + d;                     \
    b = rotr64(b ^ c, 63);         \
  } while (0)

#define ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, \
              s14, s15)                                                   \
  do {                                                                    \
    G(v0, v4, v8, v12, m[s0], m[s1]);                                     \
    G(v1, v5, v9, v13, m[s2], m[s3]);                                     \
    G(v2, v6, v10, v14, m[s4], m[s5]);                                    \
    G(v3, v7, v11, v15, m[s6], m[s7]);                                    \
    G(v0, v5, v10, v15, m[s8], m[s9]);                                    \
    G(v1, v6, v11, v12, m[s10], m[s11]);                                  \
    G(v2, v7, v8, v13, m[s12], m[s13]);                                   \
    G(v3, v4, v9, v14, m[s14], m[s15]);                                   \
  } while (0)

__global__ void blake2b_levels_kernel(
    const uint8_t* __restrict__ rows, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ lens, const int32_t* __restrict__ nlv,
    const uint64_t* __restrict__ h0, int32_t* __restrict__ h1,
    int32_t* __restrict__ h2, int b, int mb, int w) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)b * w) return;
  const int r = (int)(idx / w);
  const int lane = (int)(idx % w);
  if (lane >= nlv[r]) {
    h1[idx] = 0;
    h2[idx] = 0;
    return;
  }
  const int st = starts[idx];
  const int ln = lens[idx];
  const uint8_t* row = rows + (int64_t)r * mb;

  uint64_t m[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    uint64_t word = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int p = i * 8 + k;
      if (p < ln) {
        int pos = st + p;
        pos = pos < 0 ? 0 : (pos > mb - 1 ? mb - 1 : pos);
        word |= (uint64_t)__ldg(row + pos) << (8 * k);
      }
    }
    m[i] = word;
  }

  const uint64_t iv0 = 0x6A09E667F3BCC908ull, iv1 = 0xBB67AE8584CAA73Bull,
                 iv2 = 0x3C6EF372FE94F82Bull, iv3 = 0xA54FF53A5F1D36F1ull,
                 iv4 = 0x510E527FADE682D1ull, iv5 = 0x9B05688C2B3E6C1Full,
                 iv6 = 0x1F83D9ABFB41BD6Bull, iv7 = 0x5BE0CD19137E2179ull;
  uint64_t v0 = h0[0], v1 = h0[1], v2 = h0[2], v3 = h0[3];
  uint64_t v4 = h0[4], v5 = h0[5], v6 = h0[6], v7 = h0[7];
  uint64_t v8 = iv0, v9 = iv1, v10 = iv2, v11 = iv3;
  uint64_t v12 = iv4 ^ (uint64_t)(uint32_t)ln;  // t0: one block, <= 128 B
  uint64_t v13 = iv5;
  uint64_t v14 = ~iv6;                          // final-block flag
  uint64_t v15 = iv7;

  ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
  ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);
  ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4);
  ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8);
  ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13);
  ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9);
  ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11);
  ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10);
  ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5);
  ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0);
  ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
  ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);

  const uint64_t out = h0[0] ^ v0 ^ v8;
  h1[idx] = (int32_t)(uint32_t)out;
  h2[idx] = (int32_t)(uint32_t)(out >> 32);
}

}  // namespace

extern "C" int blake2b_levels(const void* rows, const void* starts,
                              const void* lens, const void* nlv,
                              const void* h0, void* h1, void* h2, int b,
                              int mb, int w, void* stream) {
  const int64_t total = (int64_t)b * w;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  blake2b_levels_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)rows, (const int32_t*)starts, (const int32_t*)lens,
      (const int32_t*)nlv, (const uint64_t*)h0, (int32_t*)h1, (int32_t*)h2,
      b, mb, w);
  return (int)cudaGetLastError();
}

#include "py_launch.cuh"

PY_LAUNCH_MODULE(blake2b_levels, blake2b_levels)
