"""Wrappers of the walk and expand kernels (port of the Pallas half of
``bifromq_tpu/models/kernels.py``).

- :func:`fused_walk_routes` launches ``csrc/fused_walk.cu``: the whole
  per-batch walk — token hash-mix, bucket probe, successor compaction,
  interval emission and the final keep-order pack — in one launch, one
  warp per topic row, each level's bucket loads issued together (one
  half-warp per live state's bucket). ``[G, B, W]`` probe grids over
  stacked shard tables walk every mesh block in the same one launch.
  Row-identical to ``ops.match.walk_routes(esc_k=0)``, block by block.
- :func:`kernel_expand` launches ``csrc/expand.cu``: the ragged-arange
  expansion of [B, A] interval grids — or of G such blocks at once,
  ``[G, B, A]`` — into dense (slot, row) pairs. One C entry launches two
  device kernels for all G blocks: a single-pass prefix scan with
  decoupled look-back, then a merge-path (load-balanced) expansion. The
  prefix sums run on the card too, where the reference keeps them in lax
  outside its kernel. Identical to ``ops.match._expand_pairs`` block by
  block.
- :func:`ring_hop` launches ``csrc/ring_hop.cu``: one right-rotate hop
  of the mesh ring along one axis of an ``[R, S, n]`` block grid, one
  thread per output element. Identical to :func:`ring_hop_plain`.

On CPU tensors each wrapper runs its plain version; on CUDA tensors it
launches its kernel or raises. The tables stay in device memory: there
is no counterpart of the reference's VMEM fit gate.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..ops.match import (DeviceTrie, Probes, RouteIntervals, RT_COLS,
                         _expand_pairs, walk_routes)
from ..utils.device import CudaKernel, check_cuda, ptr, stream_of

# csrc/fused_walk.cu takes any K >= 1 and A >= 1 at run time; up to this
# K a warp's states live in registers and shared memory, past it in a
# global scratch of WALK_SCRATCH_INTS x KC int32 a warp (KC = K rounded up
# to 32), on at most WALK_SCRATCH_WARPS warps and WALK_SCRATCH_BYTES
WALK_SHARED_MAX_K = 512
WALK_SCRATCH_INTS = 14
WALK_SCRATCH_WARPS = 132 * 16
WALK_SCRATCH_BYTES = 256 << 20
# edge-bucket widths P it is instantiated for: one half-warp's int4 loads
WALK_PROBE_LENS = (16,)

FUSED_WALK = CudaKernel("fused_walk.cu", "fused_walk")
EXPAND = CudaKernel("expand.cu", "expand_pairs")
# csrc/expand.cu's tile widths: lanes per scan tile, merge steps per
# expansion tile
EXPAND_SCAN_TILE = 2048
EXPAND_MERGE_TILE = 1792

RING_HOP = CudaKernel("ring_hop.cu", "ring_hop")


def _walk_blocks_plain(trie: DeviceTrie, probes: Probes, **kw
                       ) -> RouteIntervals:
    """:func:`walk_routes` (``esc_k=0``) block by block over the leading
    G axis of ``[G, B, W]`` probes, block g on shard ``g % S`` of the
    stacked tables, the four results stacked."""
    n_shards = trie.edge_tab.shape[0]
    outs = []
    for g in range(probes.tok_h1.shape[0]):
        sh = g % n_shards
        outs.append(walk_routes(
            DeviceTrie(trie.route_tab[sh], trie.edge_tab[sh], None, None,
                       trie.route_tab[sh]),
            Probes(probes.tok_h1[g], probes.tok_h2[g], probes.lengths[g],
                   probes.roots[g], probes.sys_mask[g], probes.max_len),
            esc_k=0, **kw))
    return RouteIntervals(*(torch.stack([getattr(o, f) for o in outs])
                            for f in ("start", "count", "n_routes",
                                      "overflow")))


def _walk_scratch(k_states: int, rows: int, dev: torch.device):
    """The scratch of the walk kernel's path past ``WALK_SHARED_MAX_K``:
    ``(int32 tensor, warps)``, one slice a warp, the warps a multiple of
    4 and no more than the rows need; ``(None, 0)`` at or below it."""
    if k_states <= WALK_SHARED_MAX_K:
        return None, 0
    kc = -(-k_states // 32) * 32
    per_warp = WALK_SCRATCH_INTS * kc
    fit = max(4, WALK_SCRATCH_BYTES // (4 * per_warp) // 4 * 4)
    n_warps = min(-(-rows // 4) * 4, WALK_SCRATCH_WARPS, fit)
    return torch.empty(n_warps * per_warp, dtype=torch.int32,
                       device=dev), n_warps


def fused_walk_routes(trie: DeviceTrie, probes: Probes, *, probe_len: int,
                      k_states: int = 32,
                      max_intervals: int = 32) -> RouteIntervals:
    """The single-launch serving walk (replaces ``_build_fused`` /
    ``fused_walk_routes`` of ``bifromq_tpu/models/kernels.py``).

    Drop-in for ``walk_routes(..., esc_k=0)``: no on-device escalation —
    the matcher re-walks overflow rows through this same entry at a
    higher budget. ``[B, W]`` probes walk ``edge_tab [NB, P, 4]`` /
    ``route_tab [N, RT_COLS]``. ``[G, B, W]`` probes (a mesh batch, its
    ``[R, S]`` blocks row-major) walk stacked ``[S, NB, P, 4]`` /
    ``[S, N, RT_COLS]`` tables, block g on shard ``g % S``, in one
    launch, and every result gains a leading [G]."""
    batched = probes.tok_h1.dim() == 3
    kw = dict(probe_len=probe_len, k_states=k_states,
              max_intervals=max_intervals)
    if probes.tok_h1.is_cpu:
        if batched:
            return _walk_blocks_plain(trie, probes, **kw)
        return walk_routes(trie, probes, esc_k=0, **kw)
    if not (k_states >= 1 and max_intervals >= 1):
        raise ValueError(f"walk kernel takes K >= 1 and A >= 1, not "
                         f"(K={k_states}, A={max_intervals})")
    if probe_len not in WALK_PROBE_LENS:
        raise ValueError(f"walk kernel has no bucket width P={probe_len} "
                         f"instance; have {WALK_PROBE_LENS}")
    edge, route = trie.edge_tab, trie.route_tab
    if not batched:
        edge, route = edge[None], route[None]
    g, b, w = probes.tok_h1.shape if batched else (1, *probes.tok_h1.shape)
    s, nb = edge.shape[:2]
    n = route.shape[1]
    lead = (g, b) if batched else (b,)
    check_cuda("edge_tab", edge, torch.int32, (s, nb, probe_len, 4))
    check_cuda("route_tab", route, torch.int32, (s, n, RT_COLS))
    check_cuda("tok_h1", probes.tok_h1, torch.int32, (*lead, w))
    check_cuda("tok_h2", probes.tok_h2, torch.int32, (*lead, w))
    check_cuda("lengths", probes.lengths, torch.int32, lead)
    check_cuda("roots", probes.roots, torch.int32, lead)
    check_cuda("sys_mask", probes.sys_mask, torch.bool, lead)
    if nb & (nb - 1):
        raise ValueError(f"edge_tab bucket count {nb} is not a power of two")
    dev = probes.tok_h1.device
    ivl_s = torch.empty((*lead, max_intervals), dtype=torch.int32,
                        device=dev)
    ivl_c = torch.empty((*lead, max_intervals), dtype=torch.int32,
                        device=dev)
    n_routes = torch.empty(lead, dtype=torch.int32, device=dev)
    overflow = torch.empty(lead, dtype=torch.bool, device=dev)
    if g and b:
        scratch, n_warps = _walk_scratch(k_states, g * b, dev)
        FUSED_WALK.launch(
            stream_of(probes.tok_h1), ptr(edge), ptr(route), s, nb,
            probe_len, n, w, ptr(probes.tok_h1), ptr(probes.tok_h2),
            ptr(probes.lengths), ptr(probes.roots), ptr(probes.sys_mask),
            g, b, k_states, ptr(ivl_s), ptr(ivl_c), ptr(n_routes),
            ptr(overflow), max_intervals,
            0 if scratch is None else ptr(scratch), n_warps)
    return RouteIntervals(start=ivl_s, count=ivl_c, n_routes=n_routes,
                          overflow=overflow)


# (card, stream) -> (status, words): the expansion's scratch, kept per
# stream because a call's look-back reads the status words its own scan
# tiles publish; every call leaves the status words and the tile counter
# (words[0]) at 0, which is how they were allocated
_EXPAND_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _expand_scratch(x: torch.Tensor, stream: int, n_tiles: int,
                    n_words: int) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (x.get_device(), stream)
    have = _EXPAND_SCRATCH.get(key)
    if (have is None or have[0].numel() < n_tiles
            or have[1].numel() < n_words):
        n_tiles = max(n_tiles, have[0].numel() if have else 0)
        n_words = max(n_words, have[1].numel() if have else 0)
        have = (torch.zeros(n_tiles, dtype=torch.int64, device=x.device),
                torch.zeros(n_words, dtype=torch.int32, device=x.device))
        _EXPAND_SCRATCH[key] = have
    return have


def _expand_blocks_plain(ivl_s: torch.Tensor, ivl_c: torch.Tensor,
                         cap: int):
    """:func:`_expand_pairs` block by block over a leading G axis, the
    five results stacked."""
    outs = [_expand_pairs(s, c, cap) for s, c in zip(ivl_s, ivl_c)]
    return tuple(torch.stack(x) for x in zip(*outs))


def kernel_expand(ivl_s: torch.Tensor, ivl_c: torch.Tensor, *, cap: int):
    """The expansion kernel's wrapper (replaces ``_build_expand`` /
    ``pallas_expand`` of ``bifromq_tpu/models/kernels.py``).

    Same output contract as ``ops.match._expand_pairs``: (slots [cap],
    rows [cap], row_offsets [B+1], n_pairs [], trunc [B]) in the host
    expander's row-major order. ``ivl_s``/``ivl_c`` of shape [G, B, A]
    expand G blocks in one call, each into its own ``cap``-pair buffer,
    and every result gains a leading [G]."""
    if ivl_s.dim() not in (2, 3) or ivl_c.dim() != ivl_s.dim():
        raise ValueError(f"kernel_expand takes [B, A] or [G, B, A] grids, "
                         f"got {tuple(ivl_s.shape)} and "
                         f"{tuple(ivl_c.shape)}")
    batched = ivl_s.dim() == 3
    if ivl_s.is_cpu:
        if batched:
            return _expand_blocks_plain(ivl_s, ivl_c, cap)
        return _expand_pairs(ivl_s, ivl_c, cap)
    g, b, a = ivl_s.shape if batched else (1, *ivl_s.shape)
    n = b * a
    if g < 1 or n < 1 or cap < 0 or n + cap >= (1 << 31) - EXPAND_MERGE_TILE:
        raise ValueError(f"kernel_expand: no kernel instance for G={g}, "
                         f"B*A={n}, cap={cap}")
    check_cuda("ivl_s", ivl_s, torch.int32, ivl_s.shape)
    check_cuda("ivl_c", ivl_c, torch.int32, ivl_s.shape)
    stream = stream_of(ivl_s)
    live_words = -(-g // 4) * 4
    status, words = _expand_scratch(
        ivl_s, stream, g * -(-n // EXPAND_SCAN_TILE), 4 + live_words + g * n)
    lead = (g,) if batched else ()
    dev = ivl_s.device
    slots = torch.empty((*lead, cap), dtype=torch.int32, device=dev)
    rows = torch.empty((*lead, cap), dtype=torch.int32, device=dev)
    row_offsets = torch.empty((*lead, b + 1), dtype=torch.int32, device=dev)
    n_pairs = torch.empty(lead, dtype=torch.int32, device=dev)
    trunc = torch.empty((*lead, b), dtype=torch.bool, device=dev)
    w = words.data_ptr()
    EXPAND.launch(stream, ptr(ivl_s), ptr(ivl_c), g, b, a, cap, ptr(slots),
                  ptr(rows), ptr(row_offsets), ptr(n_pairs), ptr(trunc),
                  ptr(status), w, w + 4 * (4 + live_words), w + 16)
    return slots, rows, row_offsets, n_pairs, trunc


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
    if x.is_cpu:
        return ring_hop_plain(x, axis)
    check_cuda("x", x, torch.int32)
    out = torch.empty_like(x)
    r, s, n = x.shape
    if n and r and s:
        RING_HOP.launch(stream_of(x), ptr(x), ptr(out), r, s, n, axis)
    return out
