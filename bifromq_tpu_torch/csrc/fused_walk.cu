// Fused interval-emitting NFA walk: one launch per probe batch, or one
// launch for every block of a mesh batch.
//
// Replaces: the Pallas kernel `_build_fused` in bifromq_tpu/models/kernels.py
// (body `_route_walk` of bifromq_tpu/ops/match.py), reached through
// `fused_walk_routes`. Plain version: `walk_routes(esc_k=0)` in
// bifromq_tpu_torch/ops/match.py, block by block for a [G, B] grid.
//
// What it computes, per topic row (exactly the reference's semantics,
// lane order included, because lane order is the emission order):
//   act = [root] (or [-1] for a padding row), cap = 1
//   for level i = 0 .. len:
//     every live state emits its '#'-child interval (route_tab HRSTART,
//     HRCOUNT) unless i == 0 on a '$' topic, and at i == len its own
//     interval (RSTART, RCOUNT); the emission row is [hc lanes | final
//     lanes], lanes in order, and only count > 0 intervals are kept;
//     below len every state steps to its literal child (one bucket of the
//     edge table, max child over the hits) and its '+' child; the
//     candidates are [exact lanes | plus lanes]. While 2*cap <= K they are
//     kept unsorted (cap doubles); once 2*cap > K they are sorted
//     descending, the first K kept (cap = K), and the row overflows if
//     more than K were live. K need not be a power of two: a width cap
//     with K/2 < cap < K sorts its 2*cap candidates down to K.
//   The first A kept intervals fill the [A] start/count lanes (zeros
//   after); n_routes sums every emitted count, kept or not; the row also
//   overflows if more than A intervals were emitted.
// K and A are run-time arguments, so every budget the reference accepts
// is served: K in [1, 256], any A >= 1. The kernel is instantiated on the
// capacity KC (32, 64, 128 or 256), the power of two >= 32 that holds K:
// it sizes the per-warp shared buffers and the states a lane carries,
// and lanes past K stay empty.
// Steps past a row's own length emit and advance nothing in the
// reference, so each row stops at its own length. Rows come as a [G, B]
// grid: block g walks the stacked tables of shard g % S (the mesh's
// row-major [R, S] block order); the single path is G = S = 1.
//
// What bounds it on an H100: random reads. A level costs each live state
// one 16-byte route-table read and one 256-byte edge-bucket read, each at
// a data-dependent address. On the config-2 probes (1M subscriptions,
// 1.59M nodes, 67 MB edge table, B = 16384, K = 32) the walk makes 192.7K
// bucket and 270.4K route-record visits, ~49 MB and ~4 MB read at random
// (98.9K buckets and 42.7K records distinct, ~27 MB), in at most 7
// dependent levels a row. On the H100, neither more rows in flight (two
// or four rows a warp), nor deeper loads in flight a lane (2, 4 or 8
// buckets), nor smaller blocks (one or two warps), nor skipping the
// probe's idle unrolled steps moved the time beyond the noise between
// calls: it stays near the rate at which the card serves these scattered
// reads, and most of a level's time is the wait for its bucket loads.
//
// What the design does about it: every load of a level depends only on the
// level's live states and token, so all of them are issued before any is
// used: a level costs one memory latency. One warp walks one row (several
// rows a warp in lockstep ran no faster). At a level's start each
// live state's route record is requested; the warp's live states are
// ballot-compacted into a list in shared memory, and each is given to a
// half-warp: 16 lanes, one int4 bucket entry each, so a bucket is one
// coalesced 256-byte read, with up to 8 states' buckets in flight (4 a
// half-warp, unrolled). Hits are compared per lane and the largest child
// taken by shuffles within the half-warp. The bucket width P is a
// template parameter (16, the compile default). After the probe: emission
// positions from warp ballots, the widening prefix as a shared-memory lane
// shuffle, the sorted compaction as a rank selection over the 2K
// candidates in shared memory. The row's tokens are read once into
// registers and broadcast by shuffle. A mesh batch's G blocks share one
// launch, so the card holds all of them in flight at once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int PROBE_UNROLL = 4;  // buckets in flight per half-warp
constexpr unsigned FULL = 0xffffffffu;

// MUST stay in sync with _mix_u32 in models/automaton.py and ops/match.py.
__device__ __forceinline__ uint32_t mix_u32(uint32_t node, uint32_t h1,
                                            uint32_t h2) {
  uint32_t x = node * 0x9E3779B1u;
  x ^= h1 * 0x85EBCA6Bu;
  x ^= x >> 15;
  x *= 0xC2B2AE35u;
  x ^= h2 * 0x27D4EB2Fu;
  x ^= x >> 13;
  return x;
}

template <int KC, int P>
__global__ void __launch_bounds__(32 * WARPS) fused_walk_kernel(
    const int4* __restrict__ edge_all, uint32_t mask, int64_t edge_stride,
    const int4* __restrict__ route_all, int64_t route_stride, int n_shards,
    int w, const int32_t* __restrict__ tok_h1,
    const int32_t* __restrict__ tok_h2, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ roots, const uint8_t* __restrict__ sys_mask,
    int b, int64_t total, int k, int a, int32_t* __restrict__ ivl_s,
    int32_t* __restrict__ ivl_c, int32_t* __restrict__ n_routes,
    uint8_t* __restrict__ overflow) {
  static_assert(KC >= 32 && (KC & (KC - 1)) == 0, "KC: power of two >= 32");
  static_assert(P == 16, "a bucket is one half-warp's int4 loads");
  constexpr int S = KC / 32;  // state slots per lane; state l = s*32 + t
  __shared__ int cand_buf[WARPS][2 * KC];
  __shared__ int next_buf[WARPS][KC];
  __shared__ int list_buf[WARPS][KC];   // the level's live states, compacted
  __shared__ int child_buf[WARPS][KC];  // their literal children, same order
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * WARPS + warp;
  if (row >= total) return;  // uniform per warp
  const int shard = (int)((row / b) % n_shards);
  const int4* __restrict__ edge = edge_all + shard * edge_stride;
  const int4* __restrict__ route = route_all + shard * route_stride;
  int* cand = cand_buf[warp];
  int* nxt = next_buf[warp];
  int* lst = list_buf[warp];
  int* kid = child_buf[warp];
  const unsigned below = (1u << t) - 1u;
  const int half = t >> 4;  // which of the two states a lane probes
  const int ent_i = t & 15;
  int32_t* out_s = ivl_s + row * a;
  int32_t* out_c = ivl_c + row * a;
  const int len = lengths[row];
  const bool sys = sys_mask[row] != 0;
  // the row's tokens, lane i holding level i (levels past 32 load per step)
  const int tk1 = t < w ? tok_h1[row * w + t] : 0;
  const int tk2 = t < w ? tok_h2[row * w + t] : 0;

  int act[S];
#pragma unroll
  for (int s = 0; s < S; ++s) act[s] = -1;
  if (t == 0 && len >= 0) act[0] = roots[row];
  int cap = 1;
  int n_ivl = 0;     // intervals emitted so far (uniform across the warp)
  int routes = 0;    // this lane's share of n_routes
  bool ovf = false;  // uniform across the warp

  // keep-order pack of one emission lane group, straight into [A] lanes
  auto emit = [&](int c, int st) {
    const bool keep = c > 0;
    const unsigned m = __ballot_sync(FULL, keep);
    const int pos = n_ivl + __popc(m & below);
    if (keep && pos < a) {
      out_s[pos] = st;
      out_c[pos] = c;
    }
    n_ivl += __popc(m);
    routes += c;
  };

  for (int i = 0; i <= len && i < w; ++i) {
    const bool allow_wc = !(sys && i == 0);
    const bool stepping = i < len;
    const bool is_final = i == len;
    int h1 = 0, h2 = 0;
    if (stepping) {
      h1 = i < 32 ? __shfl_sync(FULL, tk1, i) : tok_h1[row * w + i];
      h2 = i < 32 ? __shfl_sync(FULL, tk2, i) : tok_h2[row * w + i];
    }
    // 1. every live state's route record, requested now, used after the
    //    probe
    int4 rec[S];
    int fin_s[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      rec[s] = make_int4(-1, 0, 0, 0);
      fin_s[s] = 0;
      if (act[s] >= 0) {
        rec[s] = __ldg(route + 2 * (int64_t)act[s]);  // PLUS HRC RC HRS
        if (is_final) fin_s[s] = __ldg(route + 2 * (int64_t)act[s] + 1).x;
      }
    }
    // 2. the probe: live states compacted, one bucket per half-warp
    int exact[S];
#pragma unroll
    for (int s = 0; s < S; ++s) exact[s] = -1;
    if (stepping) {
      int n = 0;
      int pos[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const unsigned m = __ballot_sync(FULL, act[s] >= 0);
        pos[s] = n + __popc(m & below);
        if (act[s] >= 0) lst[pos[s]] = act[s];
        n += __popc(m);
      }
      __syncwarp();
      for (int j0 = 0; j0 < n; j0 += 2 * PROBE_UNROLL) {
        int4 ent[PROBE_UNROLL];
        int node[PROBE_UNROLL];
#pragma unroll
        for (int u = 0; u < PROBE_UNROLL; ++u) {
          const int j = j0 + 2 * u + half;
          node[u] = j < n ? lst[j] : -1;
          ent[u] = make_int4(-1, 0, 0, -1);
          if (node[u] >= 0) {
            const uint32_t bucket =
                mix_u32((uint32_t)node[u], (uint32_t)h1, (uint32_t)h2) & mask;
            ent[u] = __ldg(edge + (int64_t)bucket * P + ent_i);
          }
        }
#pragma unroll
        for (int u = 0; u < PROBE_UNROLL; ++u) {
          int v = (node[u] >= 0 && ent[u].x == node[u] && ent[u].y == h1 &&
                   ent[u].z == h2)
                      ? ent[u].w
                      : -1;
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            v = max(v, __shfl_xor_sync(FULL, v, off));
          if (ent_i == 0 && node[u] >= 0) kid[j0 + 2 * u + half] = v;
        }
      }
      __syncwarp();
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (act[s] >= 0) exact[s] = kid[pos[s]];
      __syncwarp();
    }

    // 3. emission: '#'-child lanes, then final lanes
#pragma unroll
    for (int s = 0; s < S; ++s)
      emit(act[s] >= 0 && allow_wc ? rec[s].y : 0, rec[s].w);
#pragma unroll
    for (int s = 0; s < S; ++s)
      emit(act[s] >= 0 && is_final ? rec[s].z : 0, fin_s[s]);
    if (!stepping) break;

    int plus[S];
#pragma unroll
    for (int s = 0; s < S; ++s)
      plus[s] = act[s] >= 0 && allow_wc ? rec[s].x : -1;

    if (2 * cap <= k) {
      // widening prefix: new lanes are [exact 0..cap | plus 0..cap], unsorted
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int l = s * 32 + t;
        if (l < cap) {
          cand[l] = exact[s];
          cand[cap + l] = plus[s];
        }
      }
      __syncwarp();
      cap *= 2;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int l = s * 32 + t;
        act[s] = l < cap ? cand[l] : -1;
      }
      __syncwarp();
    } else {
      // keep the K largest of the 2*cap candidates, descending; lanes at
      // or past cap are empty, so all KC lanes of both halves go in
#pragma unroll
      for (int s = 0; s < S; ++s) {
        cand[s * 32 + t] = exact[s];
        cand[KC + s * 32 + t] = plus[s];
      }
      __syncwarp();
      int n_live = 0;
#pragma unroll
      for (int c = 0; c < 2 * S; ++c)
        n_live += __popc(__ballot_sync(FULL, cand[c * 32 + t] >= 0));
      ovf |= n_live > k;
#pragma unroll
      for (int c = 0; c < 2 * S; ++c) {
        const int q = c * 32 + t;
        const int v = cand[q];
        if (v >= 0) {
          int r = 0;
          for (int u = 0; u < 2 * KC; ++u) {
            const int x = cand[u];
            r += (x > v) || (x == v && u < q);
          }
          if (r < k) nxt[r] = v;
        }
      }
      const int kept = min(n_live, k);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int l = s * 32 + t;
        if (l >= kept) nxt[l] = -1;
      }
      __syncwarp();
#pragma unroll
      for (int s = 0; s < S; ++s) act[s] = nxt[s * 32 + t];
      cap = k;
      __syncwarp();
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    routes += __shfl_xor_sync(FULL, routes, off);
  for (int pos = min(n_ivl, a) + t; pos < a; pos += 32) {
    out_s[pos] = 0;
    out_c[pos] = 0;
  }
  if (t == 0) {
    n_routes[row] = routes;
    overflow[row] = (ovf || n_ivl > a) ? 1 : 0;
  }
}

}  // namespace

// g blocks of b rows each; the tables are [s, nb, p, 4] and [s, n, 8]
// int32 stacks, block gi reading shard gi % s; 1 <= k <= 256, a >= 1.
extern "C" int fused_walk(const void* edge, const void* route, int s, int nb,
                          int p, int n, int w, const void* tok_h1,
                          const void* tok_h2, const void* lengths,
                          const void* roots, const void* sys_mask, int g,
                          int b, int k, void* ivl_s, void* ivl_c,
                          void* n_routes, void* overflow, int a,
                          void* stream) {
  if (p != 16 || s < 1 || g < 1 || b < 1 || k < 1 || k > 256 || a < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)g * b;
  const dim3 grid((unsigned)((total + WARPS - 1) / WARPS));
  const dim3 block(32 * WARPS);
  const uint32_t mask = (uint32_t)(nb - 1);
  const int64_t edge_stride = (int64_t)nb * p;  // int4 entries per shard
  const int64_t route_stride = (int64_t)n * 2;  // int4 pairs per shard
  cudaStream_t st = (cudaStream_t)stream;
#define FUSED_WALK_LAUNCH(KC_)                                              \
  fused_walk_kernel<KC_, 16><<<grid, block, 0, st>>>(                      \
      (const int4*)edge, mask, edge_stride, (const int4*)route,            \
      route_stride, s, w, (const int32_t*)tok_h1, (const int32_t*)tok_h2,  \
      (const int32_t*)lengths, (const int32_t*)roots,                      \
      (const uint8_t*)sys_mask, b, total, k, a, (int32_t*)ivl_s,           \
      (int32_t*)ivl_c, (int32_t*)n_routes, (uint8_t*)overflow)
  if (k <= 32) {
    FUSED_WALK_LAUNCH(32);
  } else if (k <= 64) {
    FUSED_WALK_LAUNCH(64);
  } else if (k <= 128) {
    FUSED_WALK_LAUNCH(128);
  } else {
    FUSED_WALK_LAUNCH(256);
  }
#undef FUSED_WALK_LAUNCH
  return (int)cudaGetLastError();
}

#include "py_launch.cuh"

PY_LAUNCH_MODULE(fused_walk, fused_walk)
