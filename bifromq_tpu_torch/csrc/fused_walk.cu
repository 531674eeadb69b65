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
// is served: any K >= 1, any A >= 1. Up to K = 512 the kernel is
// instantiated on the capacity KC (32, 64, 128, 256 or 512), the power
// of two >= 32 that holds K: it sizes the per-warp shared buffers
// (5 KC ints, 40 KB a block of 4 warps at KC = 512) and the states a lane
// carries in registers (KC / 32), and lanes past K stay empty. Past 512
// the same walk runs with every per-lane state and exchange buffer in a
// global-memory scratch the wrapper allocates (14 KC ints a warp, KC = K
// rounded up to 32), on a grid of at most as many warps as the scratch
// holds, each warp walking rows in turn. The rank selection reads all
// 2 KC candidates for each of them, so its cost grows as K^2.
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
// the largest capacity held in registers and shared memory
constexpr int MAX_SHARED_KC = 512;
// ints of global scratch a warp of the scratch path takes, per unit of KC:
// rec (4), act, exact, plus, pos, fin, cand (2), next, list, child
constexpr int SCRATCH_INTS = 14;

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

struct WalkArgs {
  const int4* edge_all;
  uint32_t mask;
  int64_t edge_stride;
  const int4* route_all;
  int64_t route_stride;
  int n_shards;
  int w;
  const int32_t* tok_h1;
  const int32_t* tok_h2;
  const int32_t* lengths;
  const int32_t* roots;
  const uint8_t* sys_mask;
  int b;
  int64_t total;
  int k;
  int a;
  int32_t* ivl_s;
  int32_t* ivl_c;
  int32_t* n_routes;
  uint8_t* overflow;
};

// A warp's walk state, state l = s * 32 + t held by lane t. RegState keeps
// a lane's S = KC / 32 states in registers (every index a compile-time
// constant once the loops over s unroll) and the warp's exchange buffers
// in shared memory; ScratchState keeps both in the warp's slice of a
// global scratch.
template <int KC>
struct RegState {
  static constexpr int S = KC / 32;
  int4 rec_[S];
  int act_[S], exact_[S], plus_[S], pos_[S], fin_[S];
  int *cand, *nxt, *lst, *kid;
  __device__ __forceinline__ int4& rec(int s) { return rec_[s]; }
  __device__ __forceinline__ int& act(int s) { return act_[s]; }
  __device__ __forceinline__ int& exact(int s) { return exact_[s]; }
  __device__ __forceinline__ int& plus(int s) { return plus_[s]; }
  __device__ __forceinline__ int& pos(int s) { return pos_[s]; }
  __device__ __forceinline__ int& fin(int s) { return fin_[s]; }
};

struct ScratchState {
  int S;  // KC / 32, at run time
  int t;
  int4* rec_;
  int *act_, *exact_, *plus_, *pos_, *fin_;
  int *cand, *nxt, *lst, *kid;
  __device__ ScratchState(int* base, int kc, int lane) : S(kc / 32), t(lane) {
    rec_ = reinterpret_cast<int4*>(base);  // 16-byte aligned: kc % 32 == 0
    act_ = base + 4 * kc;
    exact_ = act_ + kc;
    plus_ = exact_ + kc;
    pos_ = plus_ + kc;
    fin_ = pos_ + kc;
    cand = fin_ + kc;
    nxt = cand + 2 * kc;
    lst = nxt + kc;
    kid = lst + kc;
  }
  __device__ __forceinline__ int4& rec(int s) { return rec_[s * 32 + t]; }
  __device__ __forceinline__ int& act(int s) { return act_[s * 32 + t]; }
  __device__ __forceinline__ int& exact(int s) { return exact_[s * 32 + t]; }
  __device__ __forceinline__ int& plus(int s) { return plus_[s * 32 + t]; }
  __device__ __forceinline__ int& pos(int s) { return pos_[s * 32 + t]; }
  __device__ __forceinline__ int& fin(int s) { return fin_[s * 32 + t]; }
};

// One row's walk by one warp; the body of both kernels below.
template <int P, class St>
__device__ __forceinline__ void walk_row(const WalkArgs& g, St& st,
                                         int64_t row, int t) {
  static_assert(P == 16, "a bucket is one half-warp's int4 loads");
  const int S = st.S;
  const int kc = 32 * S;
  const int k = g.k;
  const int a = g.a;
  const int w = g.w;
  const int shard = (int)((row / g.b) % g.n_shards);
  const int4* __restrict__ edge = g.edge_all + shard * g.edge_stride;
  const int4* __restrict__ route = g.route_all + shard * g.route_stride;
  int* cand = st.cand;
  int* nxt = st.nxt;
  int* lst = st.lst;
  int* kid = st.kid;
  const unsigned below = (1u << t) - 1u;
  const int half = t >> 4;  // which of the two states a lane probes
  const int ent_i = t & 15;
  int32_t* out_s = g.ivl_s + row * a;
  int32_t* out_c = g.ivl_c + row * a;
  const int len = g.lengths[row];
  const bool sys = g.sys_mask[row] != 0;
  // the row's tokens, lane i holding level i (levels past 32 load per step)
  const int tk1 = t < w ? g.tok_h1[row * w + t] : 0;
  const int tk2 = t < w ? g.tok_h2[row * w + t] : 0;

#pragma unroll
  for (int s = 0; s < S; ++s) st.act(s) = -1;
  if (t == 0 && len >= 0) st.act(0) = g.roots[row];
  int cap = 1;
  int n_ivl = 0;     // intervals emitted so far (uniform across the warp)
  int routes = 0;    // this lane's share of n_routes
  bool ovf = false;  // uniform across the warp

  // keep-order pack of one emission lane group, straight into [A] lanes
  auto emit = [&](int c, int start) {
    const bool keep = c > 0;
    const unsigned m = __ballot_sync(FULL, keep);
    const int pos = n_ivl + __popc(m & below);
    if (keep && pos < a) {
      out_s[pos] = start;
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
      h1 = i < 32 ? __shfl_sync(FULL, tk1, i) : g.tok_h1[row * w + i];
      h2 = i < 32 ? __shfl_sync(FULL, tk2, i) : g.tok_h2[row * w + i];
    }
    // 1. every live state's route record, requested now, used after the
    //    probe
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int node = st.act(s);
      int4 r = make_int4(-1, 0, 0, 0);
      int f = 0;
      if (node >= 0) {
        r = __ldg(route + 2 * (int64_t)node);  // PLUS HRC RC HRS
        if (is_final) f = __ldg(route + 2 * (int64_t)node + 1).x;
      }
      st.rec(s) = r;
      st.fin(s) = f;
    }
    // 2. the probe: live states compacted, one bucket per half-warp
#pragma unroll
    for (int s = 0; s < S; ++s) st.exact(s) = -1;
    if (stepping) {
      int n = 0;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int node = st.act(s);
        const unsigned m = __ballot_sync(FULL, node >= 0);
        const int p = n + __popc(m & below);
        st.pos(s) = p;
        if (node >= 0) lst[p] = node;
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
                mix_u32((uint32_t)node[u], (uint32_t)h1, (uint32_t)h2) &
                g.mask;
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
        if (st.act(s) >= 0) st.exact(s) = kid[st.pos(s)];
      __syncwarp();
    }

    // 3. emission: '#'-child lanes, then final lanes
#pragma unroll
    for (int s = 0; s < S; ++s)
      emit(st.act(s) >= 0 && allow_wc ? st.rec(s).y : 0, st.rec(s).w);
#pragma unroll
    for (int s = 0; s < S; ++s)
      emit(st.act(s) >= 0 && is_final ? st.rec(s).z : 0, st.fin(s));
    if (!stepping) break;

#pragma unroll
    for (int s = 0; s < S; ++s)
      st.plus(s) = st.act(s) >= 0 && allow_wc ? st.rec(s).x : -1;

    if (2 * cap <= k) {
      // widening prefix: new lanes are [exact 0..cap | plus 0..cap], unsorted
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int l = s * 32 + t;
        if (l < cap) {
          cand[l] = st.exact(s);
          cand[cap + l] = st.plus(s);
        }
      }
      __syncwarp();
      cap *= 2;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int l = s * 32 + t;
        st.act(s) = l < cap ? cand[l] : -1;
      }
      __syncwarp();
    } else {
      // keep the K largest of the 2*cap candidates, descending; lanes at
      // or past cap are empty, so all KC lanes of both halves go in
#pragma unroll
      for (int s = 0; s < S; ++s) {
        cand[s * 32 + t] = st.exact(s);
        cand[kc + s * 32 + t] = st.plus(s);
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
          for (int u = 0; u < 2 * kc; ++u) {
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
      for (int s = 0; s < S; ++s) st.act(s) = nxt[s * 32 + t];
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
    g.n_routes[row] = routes;
    g.overflow[row] = (ovf || n_ivl > a) ? 1 : 0;
  }
}

template <int KC, int P>
__global__ void __launch_bounds__(32 * WARPS)
    fused_walk_kernel(const WalkArgs g) {
  static_assert(KC >= 32 && (KC & (KC - 1)) == 0, "KC: power of two >= 32");
  __shared__ int cand_buf[WARPS][2 * KC];
  __shared__ int next_buf[WARPS][KC];
  __shared__ int list_buf[WARPS][KC];   // the level's live states, compacted
  __shared__ int child_buf[WARPS][KC];  // their literal children, same order
  const int warp = threadIdx.x >> 5;
  const int64_t row = (int64_t)blockIdx.x * WARPS + warp;
  if (row >= g.total) return;  // uniform per warp
  RegState<KC> st;
  st.cand = cand_buf[warp];
  st.nxt = next_buf[warp];
  st.lst = list_buf[warp];
  st.kid = child_buf[warp];
  walk_row<P>(g, st, row, threadIdx.x & 31);
}

// K past MAX_SHARED_KC: warp gw owns scratch ints [gw, gw + 1) x 14 kc and
// walks rows gw, gw + n_warps, ...
template <int P>
__global__ void __launch_bounds__(32 * WARPS)
    fused_walk_scratch_kernel(const WalkArgs g, int* __restrict__ scratch,
                              int kc, int64_t n_warps) {
  const int warp = threadIdx.x >> 5;
  const int64_t gw = (int64_t)blockIdx.x * WARPS + warp;
  ScratchState st(scratch + gw * SCRATCH_INTS * (int64_t)kc, kc,
                  threadIdx.x & 31);
  for (int64_t row = gw; row < g.total; row += n_warps)
    walk_row<P>(g, st, row, threadIdx.x & 31);
}

}  // namespace

// g blocks of b rows each; the tables are [s, nb, p, 4] and [s, n, 8]
// int32 stacks, block gi reading shard gi % s; k >= 1, a >= 1. For
// k > 512, `scratch` holds n_warps x 14 x kc int32 (kc = k rounded up to
// a multiple of 32; n_warps a multiple of 4); otherwise it is unused.
extern "C" int fused_walk(const void* edge, const void* route, int s, int nb,
                          int p, int n, int w, const void* tok_h1,
                          const void* tok_h2, const void* lengths,
                          const void* roots, const void* sys_mask, int g,
                          int b, int k, void* ivl_s, void* ivl_c,
                          void* n_routes, void* overflow, int a,
                          void* scratch, int n_warps, void* stream) {
  if (p != 16 || s < 1 || g < 1 || b < 1 || k < 1 || a < 1)
    return (int)cudaErrorInvalidValue;
  WalkArgs args;
  args.edge_all = (const int4*)edge;
  args.mask = (uint32_t)(nb - 1);
  args.edge_stride = (int64_t)nb * p;  // int4 entries per shard
  args.route_all = (const int4*)route;
  args.route_stride = (int64_t)n * 2;  // int4 pairs per shard
  args.n_shards = s;
  args.w = w;
  args.tok_h1 = (const int32_t*)tok_h1;
  args.tok_h2 = (const int32_t*)tok_h2;
  args.lengths = (const int32_t*)lengths;
  args.roots = (const int32_t*)roots;
  args.sys_mask = (const uint8_t*)sys_mask;
  args.b = b;
  args.total = (int64_t)g * b;
  args.k = k;
  args.a = a;
  args.ivl_s = (int32_t*)ivl_s;
  args.ivl_c = (int32_t*)ivl_c;
  args.n_routes = (int32_t*)n_routes;
  args.overflow = (uint8_t*)overflow;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 block(32 * WARPS);
  if (k > MAX_SHARED_KC) {
    if (scratch == nullptr || n_warps < WARPS || n_warps % WARPS)
      return (int)cudaErrorInvalidValue;
    fused_walk_scratch_kernel<16><<<n_warps / WARPS, block, 0, st>>>(
        args, (int*)scratch, (k + 31) / 32 * 32, n_warps);
    return (int)cudaGetLastError();
  }
  const dim3 grid((unsigned)((args.total + WARPS - 1) / WARPS));
  if (k <= 32) {
    fused_walk_kernel<32, 16><<<grid, block, 0, st>>>(args);
  } else if (k <= 64) {
    fused_walk_kernel<64, 16><<<grid, block, 0, st>>>(args);
  } else if (k <= 128) {
    fused_walk_kernel<128, 16><<<grid, block, 0, st>>>(args);
  } else if (k <= 256) {
    fused_walk_kernel<256, 16><<<grid, block, 0, st>>>(args);
  } else {
    fused_walk_kernel<512, 16><<<grid, block, 0, st>>>(args);
  }
  return (int)cudaGetLastError();
}

#include "py_launch.cuh"

PY_LAUNCH_MODULE(fused_walk, fused_walk)
