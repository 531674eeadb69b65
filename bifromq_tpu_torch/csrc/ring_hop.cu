// One right-rotate hop of a ring over one axis of the [R, S] mesh grid.
//
// Replaces: the Pallas kernel in `pallas_right_permute`
// (bifromq_tpu/models/kernels.py), which ships each TPU's block to its
// ring successor as one remote DMA; `_ring_allreduce` in
// bifromq_tpu/parallel/sharded.py runs it once per ring step. Plain
// version: `ring_hop_plain` in bifromq_tpu_torch/models/kernels.py.
//
// What it computes: on one card the mesh is a leading [R, S] block axis,
// so the input is x [R, S, n] int32, contiguous, one block per mesh slot.
// A hop along the shard axis (axis = 1) writes
//   out[r, s, :] = x[r, (s - 1) mod S, :]
// and a hop along the replica axis (axis = 0) writes
//   out[r, s, :] = x[(r - 1) mod R, s, :]
// which is `jax.lax.ppermute` with perm = [(i, (i + 1) % size)], the
// reference kernel's parity oracle.
//
// What bounds it on an H100: bytes, read once and written once
// (2 * R * S * n * 4 B). On the serving path a block is the per-peer
// count vector, n = n_peers + 2 int32, so the whole hop moves tens of
// bytes and its real floor is the launch latency, a few microseconds. At
// [2, 4, 1 << 20] it moves 64 MiB: about 20 us at 3.35 TB/s.
//
// What the design does about it: one thread per output element, with the
// source block computed from the output's own block coordinate; neighbour
// threads touch neighbour addresses, so reads and writes coalesce. Where
// n % 4 == 0 an element is an int4, so every thread moves 16 bytes (the
// wrapper checks both pointers are 16-byte aligned). Across cards the hop
// becomes a peer-pointer copy over NVLink, in a later slice.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void ring_hop_kernel(const T* __restrict__ src,
                                T* __restrict__ dst, int r, int s,
                                long long m, int axis) {
  const long long o = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long total = (long long)r * s * m;
  if (o >= total) return;
  const long long blk = o / m;
  const long long k = o - blk * m;
  int ri = (int)(blk / s);
  int si = (int)(blk - (long long)ri * s);
  if (axis == 0) {
    ri = ri == 0 ? r - 1 : ri - 1;
  } else {
    si = si == 0 ? s - 1 : si - 1;
  }
  dst[o] = __ldg(src + ((long long)ri * s + si) * m + k);
}

template <typename T>
int launch(const void* src, void* dst, int r, int s, long long m, int axis,
           cudaStream_t stream) {
  const int threads = 256;
  const long long total = (long long)r * s * m;
  const long long blocks = (total + threads - 1) / threads;
  ring_hop_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      (const T*)src, (T*)dst, r, s, m, axis);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ring_hop(const void* src, void* dst, int r, int s, int n,
                        int axis, void* stream) {
  if (n % 4 == 0) {
    return launch<int4>(src, dst, r, s, n / 4, axis, (cudaStream_t)stream);
  }
  return launch<int32_t>(src, dst, r, s, n, axis, (cudaStream_t)stream);
}

#include "py_launch.cuh"

PY_LAUNCH_MODULE(ring_hop, ring_hop)
