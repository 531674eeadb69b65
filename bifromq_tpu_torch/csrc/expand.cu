// Ragged-arange fan-out expansion: interval lanes -> dense (slot, row) pairs,
// for G independent blocks in one call.
//
// Replaces: the Pallas kernel `_build_expand` in bifromq_tpu/models/kernels.py,
// reached through `pallas_expand`. Plain version: `_expand_pairs` in
// bifromq_tpu_torch/ops/match.py.
//
// What it computes: for each block g, the walk's [B, A] interval grid
// (`ivl_s` start, `ivl_c` count, negative counts read as 0) flattened to
// n = B*A lanes. With `lane_lo` the exclusive prefix sum of the counts,
// `total` their sum and limit = min(total, cap), output position j < limit
// belongs to the lane with lane_lo <= j < lane_lo + count and gets
// slot = start + (j - lane_lo), row = lane / A; positions in [limit, cap)
// get -1. Beside the pairs it writes row_offsets [B+1] (the prefix sum at
// every row end), trunc [B] (row_offsets[r+1] > cap) and n_pairs = limit.
// The reference computes the prefix sums in lax outside its Pallas kernel;
// fusing them here is a design choice of the port, not a change of function.
//
// Two kernels, launched back to back on one stream by one C entry:
//
// 1. `expand_scan_kernel`: a single-pass scan of the counts with decoupled
//    look-back. Tiles of 2048 lanes take their ids from an atomic counter
//    (so a tile only ever waits on tiles that are already running), scan in
//    registers and warp shuffles, publish their aggregate, and then warp 0
//    looks back over the predecessors' status words, 32 at a time, until it
//    meets an inclusive prefix. A status word is [flag:2|value:32], 0 while
//    unpublished; the expansion kernel clears this call's words once the
//    scan is done, and the tile that draws the last id resets the counter
//    (every other block has drawn its id by then), so the next call finds
//    both at 0 with no clearing launch of its own. The scan writes lane_lo
//    only for lanes that start below cap (no other lane is ever read) and,
//    per block, `n_live`, the number of such lanes.
// 2. `expand_pairs_kernel`: a load-balanced search (merge path). The lanes
//    that start below limit, keyed by lane_lo, are merged with the output
//    positions 0..cap-1 (a lane goes before position j when lane_lo <= j);
//    lanes that start at or past limit take the key "after every position".
//    Each thread block owns 1792 consecutive steps of that merge: it finds
//    where they start and end with two block-wide 128-ary searches on the
//    merge-path diagonals, stages its lanes' lane_lo and start in shared
//    memory with coalesced loads, and every thread walks 7 merge steps,
//    recording the lane of each position it passes. The block then writes
//    its contiguous run of positions, coalesced. A run of empty lanes or a
//    lane longer than a tile only changes how a tile's 1792 steps split
//    between lanes and positions, never how many steps a thread walks. No
//    atomic decides an output: the order is the host expander's row-major
//    order on every run.
//
// What bounds it on an H100: memory. Count each input byte read once and
// each output byte written once: ivl_s and ivl_c (2*G*B*A*4 B), slots and
// rows (2*G*cap*4 B), row_offsets, trunc and n_pairs. At the single path's
// main shape (G = 1, B = 16384, A = 32, cap = 1,048,576) that is 12.7 MB,
// about 3.8 us at 3.35 TB/s. The scan must read every count; the expansion
// reads only the lanes that feed the buffer (at config 2 a few thousand),
// and writes the two [cap] outputs once. At shapes this small the two
// launches' latency, not bandwidth, is the floor the design pays.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int EXP_THREADS = 256;
constexpr int EXP_ITEMS = 7;  // odd: the serial walks' shared reads spread
constexpr int EXP_TILE = EXP_THREADS * EXP_ITEMS;
constexpr int HALF = EXP_THREADS / 2;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long FLAG_AGG = 1, FLAG_PRE = 2;

// shared-memory index with one pad word per 32: conflict-free both for the
// striped (coalesced) pass and the blocked (8 consecutive per thread) pass
__host__ __device__ constexpr int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long flag, int v) {
  atomicExch(p, (flag << 32) | (unsigned)v);
}

__global__ void __launch_bounds__(SCAN_THREADS)
expand_scan_kernel(const int32_t* __restrict__ cnt, int n, int b, int a,
                   int cap, int tiles_per_block, int total_tiles,
                   unsigned long long* status,
                   unsigned int* tile_ctr, int32_t* __restrict__ lane_lo,
                   int32_t* __restrict__ n_live,
                   int32_t* __restrict__ row_offsets,
                   uint8_t* __restrict__ trunc,
                   int32_t* __restrict__ n_pairs) {
  __shared__ int sh[pad(SCAN_TILE)];
  __shared__ int sh_warp[SCAN_WARPS];
  __shared__ int sh_tile, sh_prefix;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    const unsigned t = atomicAdd(tile_ctr, 1u);
    if (t == (unsigned)total_tiles - 1) atomicExch(tile_ctr, 0u);
    sh_tile = (int)t;
  }
  __syncthreads();
  const int tile = sh_tile;
  const int g = tile / tiles_per_block;
  const int k = tile - g * tiles_per_block;
  const long long gbase = (long long)g * n;
  const int tile_lo = k * SCAN_TILE;

  // coalesced load of the tile's counts, clamped at 0
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    const int p = i * SCAN_THREADS + tid;
    const int l = tile_lo + p;
    sh[pad(p)] = l < n ? max(__ldg(cnt + gbase + l), 0) : 0;
  }
  __syncthreads();
  // each thread scans its 8 consecutive lanes in registers
  int c[SCAN_ITEMS], inc[SCAN_ITEMS];
  int acc = 0;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    c[i] = sh[pad(tid * SCAN_ITEMS + i)];
    acc += c[i];
    inc[i] = acc;
  }
  // warp scan of the thread totals, then of the warp totals
  int w = acc;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, w, o);
    if (lane >= o) w += y;
  }
  if (lane == 31) sh_warp[warp] = w;
  __syncthreads();
  if (warp == 0) {
    int v = lane < SCAN_WARPS ? sh_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < SCAN_WARPS; o <<= 1) {
      const int y = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += y;
    }
    if (lane < SCAN_WARPS) sh_warp[lane] = v;
  }
  __syncthreads();
  const int tile_sum = sh_warp[SCAN_WARPS - 1];
  const int thread_excl = w - acc + (warp ? sh_warp[warp - 1] : 0);

  // decoupled look-back over the tiles of block g before this one
  if (warp == 0) {
    unsigned long long* st = status + (long long)g * tiles_per_block;
    if (k == 0) {
      if (lane == 0) {
        publish(st, FLAG_PRE, tile_sum);
        sh_prefix = 0;
      }
    } else {
      if (lane == 0) publish(st + k, FLAG_AGG, tile_sum);
      int excl = 0;
      int pred = k - 1;
      while (true) {
        const int p = pred - lane;  // lane 0 looks at the nearest
        unsigned flag;
        int val;
        while (true) {
          if (p >= 0) {
            const unsigned long long s =
                *(volatile const unsigned long long*)(st + p);
            flag = (unsigned)(s >> 32);
            val = (int)(unsigned)s;
          } else {
            flag = (unsigned)FLAG_PRE;  // before tile 0: an empty prefix
            val = 0;
          }
          if (!__any_sync(FULL, flag == 0u)) break;
          __nanosleep(32);
        }
        const unsigned pre = __ballot_sync(FULL, flag == (unsigned)FLAG_PRE);
        const int upto = pre ? __ffs(pre) - 1 : 31;
        int v = lane <= upto ? val : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
        excl += v;
        if (pre) break;
        pred -= 32;
      }
      if (lane == 0) {
        publish(st + k, FLAG_PRE, excl + tile_sum);
        sh_prefix = excl;
      }
    }
  }
  __syncthreads();
  const int prefix = sh_prefix + thread_excl;

  // per-lane results: row ends, the pair count, the live-lane count
  int32_t* ro = row_offsets + (long long)g * (b + 1);
  const int first = tile_lo + tid * SCAN_ITEMS;
  if (first == 0) ro[0] = 0;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    const int l = first + i;
    if (l >= n) break;
    const int hi = prefix + inc[i];
    const int lo = hi - c[i];
    sh[pad(tid * SCAN_ITEMS + i)] = lo;
    if (lo < cap && (l == n - 1 || hi >= cap)) n_live[g] = l + 1;
    if ((l + 1) % a == 0) {
      const int r = l / a;
      ro[r + 1] = hi;
      trunc[(long long)g * b + r] = hi > cap;
    }
    if (l == n - 1) n_pairs[g] = min(hi, cap);
  }
  __syncthreads();
  // coalesced store of lane_lo, only for lanes that start below cap
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    const int p = i * SCAN_THREADS + tid;
    const int l = tile_lo + p;
    if (l < n) {
      const int lo = sh[pad(p)];
      if (lo < cap) lane_lo[gbase + l] = lo;
    }
  }
}

// lane i's merge key: where its pairs start, or past every position when
// it starts at or past the block's limit
__device__ __forceinline__ int merge_key(const int32_t* lo, int i,
                                         int limit) {
  const int v = __ldg(lo + i);
  return v < limit ? v : INT_MAX;
}

// one round of a block-wide search for the first index in [lo, hi) whose
// predicate is false (hi if none), given `c`, the number of the round's
// sample points lo, lo + step, ... that held
__device__ __forceinline__ void narrow(int& lo, int& hi, int step, int c) {
  if (lo >= hi) return;
  if (c == 0) {
    hi = lo;
  } else {
    const int base = lo;
    lo = base + (c - 1) * step + 1;
    hi = min(hi, base + c * step);
  }
}

__global__ void __launch_bounds__(EXP_THREADS)
expand_pairs_kernel(const int32_t* __restrict__ ivl_s,
                    const int32_t* __restrict__ lane_lo,
                    const int32_t* __restrict__ n_live,
                    const int32_t* __restrict__ n_pairs, int n, int a,
                    int cap, int tiles_per_block,
                    unsigned long long* __restrict__ status,
                    int32_t* __restrict__ slots,
                    int32_t* __restrict__ rows) {
  __shared__ int sh_key[EXP_TILE + 1];
  __shared__ int sh_s[EXP_TILE + 1];
  __shared__ int sh_lane[EXP_TILE];
  const int tid = threadIdx.x;
  const int g = blockIdx.y;
  if (blockIdx.x == 0) {  // the scan is done: clear its status words
    for (int i = tid; i < tiles_per_block; i += EXP_THREADS)
      status[(long long)g * tiles_per_block + i] = 0;
  }
  if (cap == 0) return;
  const int live = __ldg(n_live + g);
  const int limit = __ldg(n_pairs + g);
  const int merged = live + cap;
  const int d0 = blockIdx.x * EXP_TILE;
  if (d0 >= merged) return;
  const int d1 = min(d0 + EXP_TILE, merged);
  const int32_t* lo = lane_lo + (long long)g * n;

  // merge-path split of both diagonals: the number of lanes among the
  // first d steps is the first m with !(key(m) <= d - 1 - m). Threads
  // [0, 128) sample the d0 search, [128, 256) the d1 search.
  int lo0 = max(0, d0 - cap), hi0 = min(d0, live);
  int lo1 = max(0, d1 - cap), hi1 = min(d1, live);
  const bool second = tid >= HALF;
  const int t = second ? tid - HALF : tid;
  while (lo0 < hi0 || lo1 < hi1) {
    const int step0 = (hi0 - lo0 + HALF - 1) / HALF;
    const int step1 = (hi1 - lo1 + HALF - 1) / HALF;
    const int l = second ? lo1 : lo0, h = second ? hi1 : hi0;
    const int d = second ? d1 : d0;
    const int m = l + t * (second ? step1 : step0);
    const bool p = l < h && m < h && merge_key(lo, m, limit) <= d - 1 - m;
    const int c0 = __syncthreads_count(p && !second);
    const int c1 = __syncthreads_count(p && second);
    narrow(lo0, hi0, step0, c0);
    narrow(lo1, hi1, step1, c1);
  }
  const int a0 = lo0, b0 = d0 - lo0;
  const int na = lo1 - lo0, nb = (d1 - lo1) - b0;

  // stage lanes a0 - 1 .. a1 - 1: slot k holds lane a0 - 1 + k
  const int32_t* s_g = ivl_s + (long long)g * n;
  for (int k = tid; k <= na; k += EXP_THREADS) {
    const int l = a0 - 1 + k;
    sh_key[k] = l >= 0 ? merge_key(lo, l, limit) : 0;
    sh_s[k] = l >= 0 ? __ldg(s_g + l) : 0;
  }
  __syncthreads();

  // each thread: split its own 7-step diagonal in shared, then walk it
  const int td = min(tid * EXP_ITEMS, na + nb);
  int ai_lo = max(0, td - nb), ai_hi = min(td, na);
  while (ai_lo < ai_hi) {
    const int mid = (ai_lo + ai_hi) >> 1;
    if (sh_key[mid + 1] <= b0 + (td - 1 - mid)) {
      ai_lo = mid + 1;
    } else {
      ai_hi = mid;
    }
  }
  int ai = ai_lo, bi = td - ai_lo;
#pragma unroll
  for (int it = 0; it < EXP_ITEMS; ++it) {
    if (ai + bi >= na + nb) break;
    if (bi < nb && (ai >= na || sh_key[ai + 1] > b0 + bi)) {
      sh_lane[bi++] = ai;  // the position's lane: the last lane taken
    } else {
      ++ai;
    }
  }
  __syncthreads();

  int32_t* so = slots + (long long)g * cap;
  int32_t* rw = rows + (long long)g * cap;
  for (int i = tid; i < nb; i += EXP_THREADS) {
    const int j = b0 + i;
    int sv = -1, rv = -1;
    if (j < limit) {
      const int k = sh_lane[i];
      sv = sh_s[k] + (j - sh_key[k]);
      rv = (a0 - 1 + k) / a;
    }
    so[j] = sv;
    rw[j] = rv;
  }
}

}  // namespace

// One call expands G blocks: ivl_s, ivl_c [G, B, A] int32 in; slots, rows
// [G, cap] int32, row_offsets [G, B+1] int32, n_pairs [G] int32 and trunc
// [G, B] bool out. Scratch, kept by the caller for every call on one
// stream: status [G * ceil(B*A / 2048)] u64 and counter [1] u32, zeroed
// when allocated and left zeroed by every call; lane_lo [G, B*A] int32
// and n_live [G] int32, any content. Requires B*A >= 1 and
// B*A + cap < 2^31 - 1792.
extern "C" int expand_pairs(const void* ivl_s, const void* ivl_c, int g,
                            int b, int a, int cap, void* slots, void* rows,
                            void* row_offsets, void* n_pairs, void* trunc,
                            void* status, void* counter, void* lane_lo,
                            void* n_live, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int n = b * a;
  const int tiles = (n + SCAN_TILE - 1) / SCAN_TILE;
  expand_scan_kernel<<<g * tiles, SCAN_THREADS, 0, st>>>(
      (const int32_t*)ivl_c, n, b, a, cap, tiles, g * tiles,
      (unsigned long long*)status, (unsigned int*)counter, (int32_t*)lane_lo,
      (int32_t*)n_live, (int32_t*)row_offsets, (uint8_t*)trunc,
      (int32_t*)n_pairs);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + (long long)cap + EXP_TILE - 1) / EXP_TILE),
                  (unsigned)g);
  expand_pairs_kernel<<<grid, EXP_THREADS, 0, st>>>(
      (const int32_t*)ivl_s, (const int32_t*)lane_lo,
      (const int32_t*)n_live, (const int32_t*)n_pairs, n, a, cap, tiles,
      (unsigned long long*)status, (int32_t*)slots, (int32_t*)rows);
  return (int)cudaGetLastError();
}

#include "py_launch.cuh"

PY_LAUNCH_MODULE(expand, expand_pairs)
