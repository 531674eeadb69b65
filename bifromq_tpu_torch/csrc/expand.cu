// Ragged-arange fan-out expansion: interval lanes -> dense (slot, row) pairs.
//
// Replaces: the Pallas kernel `_build_expand` in bifromq_tpu/models/kernels.py,
// reached through `pallas_expand`. Plain version: `_expand_pairs` in
// bifromq_tpu_torch/ops/match.py.
//
// What it computes: the walk's [B, A] interval grid flattened to n = B*A
// lanes, with `ends` the inclusive prefix sum of the lane counts and
// `lane_lo = ends - count`. For every output position j < cap, the owning
// lane is the smallest lane with ends[lane] > j (binary search; empty
// lanes share their predecessor's end and are skipped by the strict
// comparison), and the kernel emits slot = flat_s[lane] + (j - lane_lo[lane])
// and row = lane / A, or -1 for both at or past min(total, cap). The
// prefix sums, row offsets, truncation flags and pair count stay in
// PyTorch outside the kernel, as in the reference.
//
// What bounds it on an H100: memory. At the main-path shape (B = 16384,
// A = 32, cap = B * 64 = 1,048,576) the kernel must read three [n] int32
// lane arrays (6.3 MB) and write two [cap] int32 outputs (8.4 MB): about
// 4.4 us at 3.35 TB/s. The search adds ~20 dependent loads per position;
// the first levels of the search tree are shared by every thread and stay
// in L1/L2, so the dependent-load latency, not bandwidth, is what the
// simple design pays for.
//
// What the design does about it: one thread per output position, loads
// of the sorted `ends` through the read-only path, writes coalesced
// across the warp. Later work can give each warp a contiguous output
// range and search once per warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void expand_pairs_kernel(const int32_t* __restrict__ ends,
                                    const int32_t* __restrict__ lane_lo,
                                    const int32_t* __restrict__ flat_s,
                                    int n, int cap, int a,
                                    int32_t* __restrict__ slots,
                                    int32_t* __restrict__ rows) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cap) return;
  const int total = __ldg(ends + n - 1);
  if (j >= min(total, cap)) {
    slots[j] = -1;
    rows[j] = -1;
    return;
  }
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ends + mid) <= j) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int lane = min(lo, n - 1);
  slots[j] = __ldg(flat_s + lane) + (j - __ldg(lane_lo + lane));
  rows[j] = lane / a;
}

}  // namespace

extern "C" int expand_pairs(const void* ends, const void* lane_lo,
                            const void* flat_s, int n, int cap, int a,
                            void* slots, void* rows, void* stream) {
  const int threads = 256;
  const int blocks = (cap + threads - 1) / threads;
  expand_pairs_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ends, (const int32_t*)lane_lo, (const int32_t*)flat_s,
      n, cap, a, (int32_t*)slots, (int32_t*)rows);
  return (int)cudaGetLastError();
}
