// BLAKE2b-8 level hashing: one final-block compression per live (row,
// level) lane.
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
// automaton.level_hash for levels of at most 128 bytes (one block); byte
// positions outside the row clamp to its ends, as the plain version's
// gather does (the host packer never makes such a lane).
//
// What bounds it on an H100: the integer ALU pipe. A live lane runs 12
// rounds x 8 G steps; a G step makes 4 64-bit adds (2 instructions each,
// which may also issue on the FMA pipe), 4 xors (2 LOP3 each) and rotates
// by 24, 16 and 63 (2 funnel shifts each; by 32 swaps the halves): 14
// instructions only the ALU runs. Less the last round's steps the digest
// does not read, that is ~1.3K ALU instructions a lane on the SM's 64
// INT32 lanes (~16.7e12 a second). The config-2 probe batch (B = 16384,
// W = 17, 256-byte rows) has 57,185 live lanes, 3.49 a row on average:
// ~0.0044 ms of ALU work against ~0.003 ms for its ~8.7 MB of bytes.
//
// What the design does about it: only live lanes run the rounds. A block
// takes a tile of up to 32 rows, scans their level counts in shared
// memory and maps its threads densely onto the tile's live lanes, so no
// warp carries a dead lane through the rounds; the tile's dead lanes, and
// every lane of a padding row, get zeros through coalesced stores. The
// tile's row bytes are staged in shared memory once, with 16-byte loads,
// and each lane builds its 16 message words from there as 8-byte words
// joined by a funnel shift where the level starts unaligned, masked at
// `lens`. The 16-word state stays in native uint64_t registers (the
// reference's (lo, hi) uint32 emulation was a TPU workaround) and the 12
// rounds are written out with literal message indices, so the message
// block never leaves registers.
//
// Row width: any mb up to MQTT's 65,535-byte topic limit. A tile holds 32
// rows while their bytes fit the default 48 KB of shared memory (mb up to
// 1,520); wider rows opt in to Hopper's larger dynamic shared memory (up
// to 227 KB a block) and, once 32 rows do not fit even that, the tile
// holds fewer rows (3 at mb = 65,535). Lane order and values do not
// depend on the tile.

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

constexpr int TILE_ROWS = 32;  // at most; fewer for wide rows
constexpr int THREADS = 128;
constexpr int DEFAULT_SMEM = 48 * 1024;
// Hopper's 227 KB a block, less 1 KB for the static lane scan and slack
constexpr int MAX_SMEM = 227 * 1024 - 1024;

__global__ void __launch_bounds__(THREADS) blake2b_levels_kernel(
    const uint8_t* __restrict__ rows, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ lens, const int32_t* __restrict__ nlv,
    const uint64_t* __restrict__ h0, int32_t* __restrict__ h1,
    int32_t* __restrict__ h2, int b, int mb, int w, int stride, int tile) {
  // the tile's row bytes, `stride` (mb rounded up to 16) apart, plus 16
  // bytes of slack for the last row's trailing 8-byte word reads
  extern __shared__ __align__(16) uint8_t sbytes[];
  __shared__ int lane_off[TILE_ROWS + 1];  // exclusive scan of live lanes
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * tile;
  const int tile_rows = min(tile, b - r0);

  // 1. live lanes per row (lanes < nlv, at most w; none for padding rows),
  //    scanned by warp 0
  if (tid < 32) {
    int c = tid < tile_rows ? min(max(nlv[r0 + tid], 0), w) : 0;
    int x = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (tid >= off) x += y;
    }
    lane_off[tid + 1] = x;
    if (tid == 0) lane_off[0] = 0;
  }
  // 2. the tile's bytes, once, with 16-byte loads where rows allow them
  const uint8_t* src = rows + (int64_t)r0 * mb;
  if ((mb & 15) == 0) {
    const int per_row = mb >> 4;
    const int4* src4 = reinterpret_cast<const int4*>(src);
    for (int q = tid; q < tile_rows * per_row; q += THREADS) {
      const int r = q / per_row;
      reinterpret_cast<int4*>(sbytes + r * stride)[q - r * per_row] =
          __ldg(src4 + q);
    }
  } else {
    for (int q = tid; q < tile_rows * mb; q += THREADS) {
      const int r = q / mb;
      sbytes[r * stride + (q - r * mb)] = __ldg(src + q);
    }
  }
  __syncthreads();

  // 3. zeros for the tile's dead lanes, coalesced over its [rows, w] block
  const int64_t out0 = (int64_t)r0 * w;
  for (int q = tid; q < tile_rows * w; q += THREADS) {
    const int r = q / w;
    if (q - r * w >= lane_off[r + 1] - lane_off[r]) {
      h1[out0 + q] = 0;
      h2[out0 + q] = 0;
    }
  }

  // 4. the rounds, one thread per live lane
  const int n_live = lane_off[tile_rows];
  for (int q = tid; q < n_live; q += THREADS) {
    int lo = 0, hi = tile_rows;  // the row r with lane_off[r] <= q < [r+1]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (lane_off[mid] <= q) lo = mid; else hi = mid;
    }
    const int r = lo;
    const int64_t idx = out0 + (int64_t)r * w + (q - lane_off[r]);
    const int st = starts[idx];
    const int ln = lens[idx];
    const uint8_t* row = sbytes + r * stride;
    const int nbytes = min(max(ln, 0), 128);

    uint64_t m[16];
    if (st >= 0 && st <= mb - nbytes) {
      // in-row level: aligned 8-byte words, shifted into place
      const uint64_t* wp =
          reinterpret_cast<const uint64_t*>(row + (st & ~7));
      const int sh = (st & 7) * 8;
      uint64_t cur = wp[0];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int rem = nbytes - 8 * i;
        const uint64_t nx = rem > 0 ? wp[i + 1] : 0;
        uint64_t word = sh ? (cur >> sh) | (nx << (64 - sh)) : cur;
        if (rem <= 0) word = 0;
        else if (rem < 8) word &= (1ull << (8 * rem)) - 1;
        m[i] = word;
        cur = nx;
      }
    } else {
      // a level reaching outside the row: byte by byte, clamped
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        uint64_t word = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int p = i * 8 + k;
          if (p < ln) {
            int pos = st + p;
            pos = pos < 0 ? 0 : (pos > mb - 1 ? mb - 1 : pos);
            word |= (uint64_t)row[pos] << (8 * k);
          }
        }
        m[i] = word;
      }
    }

    const uint64_t iv0 = 0x6A09E667F3BCC908ull, iv1 = 0xBB67AE8584CAA73Bull,
                   iv2 = 0x3C6EF372FE94F82Bull, iv3 = 0xA54FF53A5F1D36F1ull,
                   iv4 = 0x510E527FADE682D1ull, iv5 = 0x9B05688C2B3E6C1Full,
                   iv6 = 0x1F83D9ABFB41BD6Bull, iv7 = 0x5BE0CD19137E2179ull;
    const unsigned long long* h0u =
        reinterpret_cast<const unsigned long long*>(h0);
    uint64_t v0 = __ldg(h0u + 0), v1 = __ldg(h0u + 1), v2 = __ldg(h0u + 2),
             v3 = __ldg(h0u + 3);
    uint64_t v4 = __ldg(h0u + 4), v5 = __ldg(h0u + 5), v6 = __ldg(h0u + 6),
             v7 = __ldg(h0u + 7);
    const uint64_t h00 = v0;
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

    const uint64_t out = h00 ^ v0 ^ v8;
    h1[idx] = (int32_t)(uint32_t)out;
    h2[idx] = (int32_t)(uint32_t)(out >> 32);
  }
}

}  // namespace

extern "C" int blake2b_levels(const void* rows, const void* starts,
                              const void* lens, const void* nlv,
                              const void* h0, void* h1, void* h2, int b,
                              int mb, int w, void* stream) {
  if (b < 1 || mb < 1 || w < 1 || mb > MAX_SMEM - 32)
    return (int)cudaErrorInvalidValue;
  const int stride = (mb + 15) & ~15;
  // 32 rows where they fit the default 48 KB, else as many as fit the
  // opt-in maximum (at least one)
  int tile = TILE_ROWS;
  if (tile * stride + 16 > DEFAULT_SMEM)
    tile = min(TILE_ROWS, (MAX_SMEM - 16) / stride);
  const int smem = tile * stride + 16;
  if (smem > DEFAULT_SMEM) {
    const cudaError_t e = cudaFuncSetAttribute(
        blake2b_levels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (b + tile - 1) / tile;
  blake2b_levels_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)rows, (const int32_t*)starts, (const int32_t*)lens,
      (const int32_t*)nlv, (const uint64_t*)h0, (int32_t*)h1, (int32_t*)h2,
      b, mb, w, stride, tile);
  return (int)cudaGetLastError();
}

#include "py_launch.cuh"

PY_LAUNCH_MODULE(blake2b_levels, blake2b_levels)
