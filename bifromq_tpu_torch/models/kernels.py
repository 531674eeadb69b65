"""Wrappers of the walk and expand kernels (port of the Pallas half of
``bifromq_tpu/models/kernels.py``).

- :func:`fused_walk_routes` launches ``csrc/fused_walk.cu``: the whole
  per-batch walk — token hash-mix, bucket probe, successor compaction,
  interval emission and the final keep-order pack — in one launch, one
  warp per topic row. Row-identical to ``ops.match.walk_routes(esc_k=0)``.
- :func:`kernel_expand` launches ``csrc/expand.cu``: the ragged-arange
  expansion of the [B, A] interval grids into dense (slot, row) pairs,
  one thread per output position. The O(B·A) prefix sums stay plain
  PyTorch outside the kernel, as in the reference. Identical to
  ``ops.match._expand_pairs``.
- :func:`ring_hop` launches ``csrc/ring_hop.cu``: one right-rotate hop
  of the mesh ring along one axis of an ``[R, S, n]`` block grid, one
  thread per output element. Identical to :func:`ring_hop_plain`.

On CPU tensors each wrapper runs its plain version; on CUDA tensors it
launches its kernel or raises. The tables stay in device memory: there
is no counterpart of the reference's VMEM fit gate.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.match import (DeviceTrie, Probes, RouteIntervals, RT_COLS,
                         _expand_pairs, _expand_prefix, walk_routes)
from ..utils.device import CudaKernel, check_cuda, ptr

# (K, A) pairs the walk kernel is instantiated for (csrc/fused_walk.cu)
WALK_SHAPES = ((32, 32), (32, 128), (128, 32), (128, 128))

FUSED_WALK = CudaKernel(
    "fused_walk.cu", "fused_walk",
    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int]
    + [ctypes.c_void_p])

EXPAND = CudaKernel(
    "expand.cu", "expand_pairs",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    + [ctypes.c_void_p])

RING_HOP = CudaKernel(
    "ring_hop.cu", "ring_hop",
    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def fused_walk_routes(trie: DeviceTrie, probes: Probes, *, probe_len: int,
                      k_states: int = 32,
                      max_intervals: int = 32) -> RouteIntervals:
    """The single-launch serving walk (replaces ``_build_fused`` /
    ``fused_walk_routes`` of ``bifromq_tpu/models/kernels.py``).

    Drop-in for ``walk_routes(..., esc_k=0)``: no on-device escalation —
    the matcher re-walks overflow rows through this same entry at a
    higher budget."""
    if probes.tok_h1.device.type == "cpu":
        return walk_routes(trie, probes, probe_len=probe_len,
                           k_states=k_states, max_intervals=max_intervals,
                           esc_k=0)
    if (k_states, max_intervals) not in WALK_SHAPES:
        raise ValueError(f"walk kernel has no (K={k_states}, "
                         f"A={max_intervals}) instance; have {WALK_SHAPES}")
    b, w = probes.tok_h1.shape
    nb = trie.edge_tab.shape[0]
    check_cuda("edge_tab", trie.edge_tab, torch.int32, (nb, probe_len, 4))
    n = trie.route_tab.shape[0]
    check_cuda("route_tab", trie.route_tab, torch.int32, (n, RT_COLS))
    check_cuda("tok_h1", probes.tok_h1, torch.int32, (b, w))
    check_cuda("tok_h2", probes.tok_h2, torch.int32, (b, w))
    check_cuda("lengths", probes.lengths, torch.int32, (b,))
    check_cuda("roots", probes.roots, torch.int32, (b,))
    check_cuda("sys_mask", probes.sys_mask, torch.bool, (b,))
    if nb & (nb - 1):
        raise ValueError(f"edge_tab bucket count {nb} is not a power of two")
    dev = probes.tok_h1.device
    ivl_s = torch.empty((b, max_intervals), dtype=torch.int32, device=dev)
    ivl_c = torch.empty((b, max_intervals), dtype=torch.int32, device=dev)
    n_routes = torch.empty(b, dtype=torch.int32, device=dev)
    overflow = torch.empty(b, dtype=torch.bool, device=dev)
    if b:
        FUSED_WALK.launch(
            ptr(trie.edge_tab), ptr(trie.route_tab), nb, probe_len, w,
            ptr(probes.tok_h1), ptr(probes.tok_h2), ptr(probes.lengths),
            ptr(probes.roots), ptr(probes.sys_mask), b, k_states,
            ptr(ivl_s), ptr(ivl_c), ptr(n_routes), ptr(overflow),
            max_intervals)
    return RouteIntervals(start=ivl_s, count=ivl_c, n_routes=n_routes,
                          overflow=overflow)


def kernel_expand(ivl_s: torch.Tensor, ivl_c: torch.Tensor, *, cap: int):
    """The expansion kernel's wrapper (replaces ``_build_expand`` /
    ``pallas_expand`` of ``bifromq_tpu/models/kernels.py``).

    Same output contract as ``ops.match._expand_pairs``: (slots [cap],
    rows [cap], row_offsets [B+1], n_pairs [], trunc [B]) in the host
    expander's row-major order."""
    if ivl_s.device.type == "cpu":
        return _expand_pairs(ivl_s, ivl_c, cap)
    b, a = ivl_s.shape
    check_cuda("ivl_s", ivl_s, torch.int32, (b, a))
    check_cuda("ivl_c", ivl_c, torch.int32, (b, a))
    flat_s, ends, lane_lo, row_offsets, trunc = _expand_prefix(
        ivl_s, ivl_c, cap)
    slots = torch.empty(cap, dtype=torch.int32, device=ivl_s.device)
    rows = torch.empty(cap, dtype=torch.int32, device=ivl_s.device)
    if cap:
        EXPAND.launch(ptr(ends), ptr(lane_lo), ptr(flat_s), b * a, cap, a,
                      ptr(slots), ptr(rows))
    return slots, rows, row_offsets, ends[-1].clamp(max=cap), trunc


def ring_hop_plain(x: torch.Tensor, axis: int) -> torch.Tensor:
    """The ring hop's plain version: ``out`` takes along ``axis`` the
    block of its ring predecessor, a gather at ``(i - 1) mod size``."""
    size = x.shape[axis]
    src = (torch.arange(size, device=x.device) - 1) % size
    return x.index_select(axis, src)


def ring_hop(x: torch.Tensor, axis: int) -> torch.Tensor:
    """The ring hop kernel's wrapper (replaces ``pallas_right_permute`` of
    ``bifromq_tpu/models/kernels.py``).

    ``x`` is ``[R, S, n]`` int32, one block per mesh slot; ``axis`` 0
    hops along the replica ring, 1 along the shard ring:
    ``out[r, s] = x[r, (s - 1) mod S]`` for axis 1, and likewise for 0."""
    if x.dim() != 3 or axis not in (0, 1):
        raise ValueError(f"ring_hop takes an [R, S, n] grid and axis 0 or "
                         f"1, got shape {tuple(x.shape)} and axis {axis}")
    if x.device.type == "cpu":
        return ring_hop_plain(x, axis)
    r, s, n = x.shape
    check_cuda("x", x, torch.int32)
    out = torch.empty_like(x)
    if x.numel():
        RING_HOP.launch(ptr(x), ptr(out), r, s, n, axis)
    return out
