// Fused interval-emitting NFA walk: one launch per probe batch.
//
// Replaces: the Pallas kernel `_build_fused` in bifromq_tpu/models/kernels.py
// (body `_route_walk` of bifromq_tpu/ops/match.py), reached through
// `fused_walk_routes`. Plain version: `walk_routes(esc_k=0)` in
// bifromq_tpu_torch/ops/match.py.
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
//     descending, the first K kept, and the row overflows if more than K
//     were live.
//   The first A kept intervals fill the [A] start/count lanes (zeros
//   after); n_routes sums every emitted count, kept or not; the row also
//   overflows if more than A intervals were emitted.
// Steps past a row's own length emit and advance nothing in the
// reference, so each row stops at its own length.
//
// What bounds it on an H100: memory latency. A step costs each live state
// one 16-byte route-table read and one 256-byte edge-bucket scan, each at
// a data-dependent address; at the config-2 main path (1.59M nodes, 67 MB
// edge table, B = 16384) the bytes the walk must touch are tens of MB, a
// few tens of microseconds at 3.35 TB/s, but the loads form chains
// (bucket -> child -> next bucket) whose latency only parallelism hides.
//
// What the design does about it: one warp per row and one active state
// per lane (K/32 states per lane at K = 128), so a warp issues all of a
// row's independent gathers of one level together and 4 warps per block
// keep many rows in flight; the tables are read through the read-only
// path and stay in HBM (there is no VMEM-style fit gate). Emission
// positions come from warp ballots, the widening prefix is a shared-memory
// lane shuffle, and the sorted compaction is a rank selection over the 2K
// candidates in shared memory. cp.async/TMA staging and a warp-cooperative
// bucket scan are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
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

__device__ __forceinline__ int edge_lookup(const int4* __restrict__ edge,
                                           uint32_t mask, int p, int node,
                                           int h1, int h2) {
  const uint32_t bucket =
      mix_u32((uint32_t)node, (uint32_t)h1, (uint32_t)h2) & mask;
  const int4* row = edge + (int64_t)bucket * p;
  int best = -1;
  for (int e = 0; e < p; ++e) {
    const int4 ent = __ldg(row + e);
    if (ent.x == node && ent.y == h1 && ent.z == h2) best = max(best, ent.w);
  }
  return best;
}

template <int K, int A>
__global__ void __launch_bounds__(32 * WARPS) fused_walk_kernel(
    const int4* __restrict__ edge, uint32_t mask, int p, int w,
    const int4* __restrict__ route,  // [N, 8] int32 rows as int4 pairs
    const int32_t* __restrict__ tok_h1, const int32_t* __restrict__ tok_h2,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ roots,
    const uint8_t* __restrict__ sys_mask, int b,
    int32_t* __restrict__ ivl_s, int32_t* __restrict__ ivl_c,
    int32_t* __restrict__ n_routes, uint8_t* __restrict__ overflow) {
  static_assert(K >= 32 && (K & (K - 1)) == 0, "K: power of two >= 32");
  constexpr int S = K / 32;  // active states per lane; state l = s*32 + t
  __shared__ int cand_buf[WARPS][2 * K];
  __shared__ int next_buf[WARPS][K];
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= b) return;  // uniform per warp
  int* cand = cand_buf[warp];
  int* nxt = next_buf[warp];
  const unsigned below = (1u << t) - 1u;
  int32_t* out_s = ivl_s + (int64_t)row * A;
  int32_t* out_c = ivl_c + (int64_t)row * A;
  const int len = lengths[row];
  const bool sys = sys_mask[row] != 0;

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
    if (keep && pos < A) {
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
    const int h1 = stepping ? tok_h1[(int64_t)row * w + i] : 0;
    const int h2 = stepping ? tok_h2[(int64_t)row * w + i] : 0;
    int hc_c[S], hc_s[S], fin_c[S], fin_s[S], exact[S], plus[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int node = act[s];
      hc_c[s] = 0;
      hc_s[s] = 0;
      fin_c[s] = 0;
      fin_s[s] = 0;
      exact[s] = -1;
      plus[s] = -1;
      if (node >= 0) {  // lanes at or past cap hold -1
        const int4 rec = __ldg(route + 2 * (int64_t)node);  // PLUS HRC RC HRS
        if (allow_wc) {
          hc_c[s] = rec.y;
          hc_s[s] = rec.w;
        }
        if (is_final) {
          fin_c[s] = rec.z;
          fin_s[s] = __ldg(route + 2 * (int64_t)node + 1).x;  // RSTART
        }
        if (stepping) {
          exact[s] = edge_lookup(edge, mask, p, node, h1, h2);
          if (allow_wc) plus[s] = rec.x;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) emit(hc_c[s], hc_s[s]);
#pragma unroll
    for (int s = 0; s < S; ++s) emit(fin_c[s], fin_s[s]);
    if (!stepping) break;

    if (2 * cap <= K) {
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
      // cap == K: keep the K largest of the 2K candidates, descending
#pragma unroll
      for (int s = 0; s < S; ++s) {
        cand[s * 32 + t] = exact[s];
        cand[K + s * 32 + t] = plus[s];
      }
      __syncwarp();
      int n_live = 0;
#pragma unroll
      for (int c = 0; c < 2 * S; ++c)
        n_live += __popc(__ballot_sync(FULL, cand[c * 32 + t] >= 0));
      ovf |= n_live > K;
#pragma unroll
      for (int c = 0; c < 2 * S; ++c) {
        const int q = c * 32 + t;
        const int v = cand[q];
        if (v >= 0) {
          int r = 0;
          for (int u = 0; u < 2 * K; ++u) {
            const int x = cand[u];
            r += (x > v) || (x == v && u < q);
          }
          if (r < K) nxt[r] = v;
        }
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int l = s * 32 + t;
        if (l >= n_live) nxt[l] = -1;
      }
      __syncwarp();
#pragma unroll
      for (int s = 0; s < S; ++s) act[s] = nxt[s * 32 + t];
      __syncwarp();
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    routes += __shfl_xor_sync(FULL, routes, off);
  for (int pos = min(n_ivl, A) + t; pos < A; pos += 32) {
    out_s[pos] = 0;
    out_c[pos] = 0;
  }
  if (t == 0) {
    n_routes[row] = routes;
    overflow[row] = (ovf || n_ivl > A) ? 1 : 0;
  }
}

}  // namespace

extern "C" int fused_walk(const void* edge, const void* route, int nb, int p,
                          int w, const void* tok_h1, const void* tok_h2,
                          const void* lengths, const void* roots,
                          const void* sys_mask, int b, int k, void* ivl_s,
                          void* ivl_c, void* n_routes, void* overflow, int a,
                          void* stream) {
  const dim3 grid((b + WARPS - 1) / WARPS);
  const dim3 block(32 * WARPS);
  const uint32_t mask = (uint32_t)(nb - 1);
  cudaStream_t st = (cudaStream_t)stream;
#define FUSED_WALK_LAUNCH(K_, A_)                                           \
  fused_walk_kernel<K_, A_><<<grid, block, 0, st>>>(                       \
      (const int4*)edge, mask, p, w, (const int4*)route,                   \
      (const int32_t*)tok_h1, (const int32_t*)tok_h2,                      \
      (const int32_t*)lengths, (const int32_t*)roots,                      \
      (const uint8_t*)sys_mask, b, (int32_t*)ivl_s, (int32_t*)ivl_c,       \
      (int32_t*)n_routes, (uint8_t*)overflow)
  if (k == 32 && a == 32) {
    FUSED_WALK_LAUNCH(32, 32);
  } else if (k == 32 && a == 128) {
    FUSED_WALK_LAUNCH(32, 128);
  } else if (k == 128 && a == 32) {
    FUSED_WALK_LAUNCH(128, 32);
  } else if (k == 128 && a == 128) {
    FUSED_WALK_LAUNCH(128, 128);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef FUSED_WALK_LAUNCH
  return (int)cudaGetLastError();
}

#include "py_launch.cuh"

PY_LAUNCH_MODULE(fused_walk, fused_walk)
