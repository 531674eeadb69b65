"""Fixed-shape NFA trie walk and fan-out expansion, in plain PyTorch
(port of ``bifromq_tpu/ops/match.py``).

Everything in this module is the plain version of the device plane: the
interval-emitting walk (``walk_routes``, whose single-launch kernel is
``models/kernels.fused_walk_routes``), the ragged-arange expansion
(``_expand_pairs``, whose kernel is ``models/kernels.kernel_expand``) and
the per-peer bucketing (``_bucket_pairs``, plain PyTorch on the card too,
as it is plain XLA in the reference). ``patch_device_trie`` writes a
patched arena's dirty rows into the device tables. ``expand_intervals``
is the host expansion of the rows the device buffer truncates or the
escalation re-walks, through the native helper ``csrc/host/expand.cpp``.

- B topics × K active NFA states advance one topic level per step.
- Literal-edge lookup = ONE bucket-row gather of the single-choice hash
  table; '+' / '#' transitions read one packed route-table record.
- Successor compaction to K slots: per-row descending sort; rows whose
  active set would exceed K set an overflow flag and re-walk at a larger
  K (the matcher's escalation), and only rows that exceed even that fall
  back to the host oracle.
- Each accepting node owns a contiguous slot interval, so a topic's
  matched route set is a short list of (start, count) pairs.

Integer notes: torch has no full uint32 arithmetic and ``>>`` on a signed
tensor is arithmetic, so the bucket mixer holds uint32 values in int64
tensors and splits each 32-bit constant into 16-bit halves, which keeps
every product below 2^48.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..models.automaton import (
    NODE_HRCOUNT, NODE_HRSTART, NODE_PLUS, NODE_RCOUNT, NODE_RSTART,
    CompiledTrie, TokenizedTopics,
)
from ..utils.device import upload
from ..utils.env import env_int
from ..utils.nativelib import CALLS, CSRC_HOST, compile_and_load

# narrow count-walk table layout (see DeviceTrie.count_tab)
CT_PLUS = 0
CT_HRCOUNT = 1
CT_RCOUNT = 2
CT_COLS = 4

# route-materializing walk table (DeviceTrie.route_tab): plus-child
# (column 0), the '#'-child's folded (count, start) and the node's own
# (count, start), padded to 8 columns (32-byte rows)
RT_PLUS = 0
RT_HRCOUNT = 1
RT_RCOUNT = 2
RT_HRSTART = 3
RT_RSTART = 4
RT_COLS = 8

_M32 = 0xFFFFFFFF


def route_cols_from_node_tab(node_tab: np.ndarray) -> np.ndarray:
    """Extract the RT_* route-walk columns from a full node table."""
    route_cols = np.zeros((node_tab.shape[0], RT_COLS), dtype=np.int32)
    route_cols[:, RT_PLUS] = node_tab[:, NODE_PLUS]
    route_cols[:, RT_HRCOUNT] = node_tab[:, NODE_HRCOUNT]
    route_cols[:, RT_RCOUNT] = node_tab[:, NODE_RCOUNT]
    route_cols[:, RT_HRSTART] = node_tab[:, NODE_HRSTART]
    route_cols[:, RT_RSTART] = node_tab[:, NODE_RSTART]
    return route_cols


def count_cols_from_node_tab(node_tab: np.ndarray) -> np.ndarray:
    """Extract the CT_* count-walk columns from a full node table."""
    count_cols = np.zeros((node_tab.shape[0], CT_COLS), dtype=np.int32)
    count_cols[:, CT_PLUS] = node_tab[:, NODE_PLUS]
    count_cols[:, CT_HRCOUNT] = node_tab[:, NODE_HRCOUNT]
    count_cols[:, CT_RCOUNT] = node_tab[:, NODE_RCOUNT]
    return count_cols


def put(a: np.ndarray, device) -> torch.Tensor:
    """A device copy of a host array. Always a copy, on the CPU too: the
    host arenas are patched in place, and a device table that aliased
    them would change before its flush."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)


@dataclass
class DeviceTrie:
    """Compiled automaton tables resident on the device."""
    node_tab: torch.Tensor    # [N, NODE_COLS] int32
    edge_tab: torch.Tensor    # [NB, P, 4] int32
    child_list: torch.Tensor  # [E] int32
    count_tab: torch.Tensor   # [N, CT_COLS] int32
    route_tab: torch.Tensor   # [N, RT_COLS] int32 — what the walk reads

    @staticmethod
    def from_compiled(ct: CompiledTrie, device) -> "DeviceTrie":
        return DeviceTrie(
            node_tab=put(ct.node_tab, device),
            edge_tab=put(ct.edge_tab, device),
            child_list=put(ct.child_list, device),
            count_tab=put(count_cols_from_node_tab(ct.node_tab), device),
            route_tab=put(route_cols_from_node_tab(ct.node_tab), device),
        )


@dataclass
class Probes:
    """Device-side tokenized topic batch (see automaton.TokenizedTopics).

    ``max_len`` is the longest row's level count, taken from the host
    mirror: the plain walk's loop bound, read without a device sync."""
    tok_h1: torch.Tensor    # [B, L+1] int32
    tok_h2: torch.Tensor    # [B, L+1] int32
    lengths: torch.Tensor   # [B] int32
    roots: torch.Tensor     # [B] int32
    sys_mask: torch.Tensor  # [B] bool
    max_len: int

    @staticmethod
    def from_tokenized(t: TokenizedTopics, device) -> "Probes":
        return Probes(*upload([t.tok_h1, t.tok_h2, t.lengths, t.roots,
                               t.sys_mask], device),
                      int(t.lengths.max(initial=-1)))


@dataclass
class RouteIntervals:
    """Per-topic matched slot set in compressed fixed shape: row i's
    matched slots are the union of [start, start + count) over its A
    lanes (automaton DFS pre-order makes every accepting node's slots one
    contiguous interval)."""
    start: torch.Tensor     # [B, A] int32 — interval starts (0 where unused)
    count: torch.Tensor     # [B, A] int32 — interval lengths (0 where unused)
    n_routes: torch.Tensor  # [B] int32 — total matched slots per topic
    overflow: torch.Tensor  # [B] bool — state or interval overflow; the
    #                         row's intervals are unusable, host re-matches


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64: the constant is
    split into 16-bit halves so no product reaches 2^63."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix_u32(node: torch.Tensor, h1: torch.Tensor,
             h2: torch.Tensor) -> torch.Tensor:
    """MUST stay in sync with models.automaton._mix_u32 and mix_u32 in
    csrc/fused_walk.cu. Returns the uint32 mix held in int64."""
    x = _mul_u32(node.long() & _M32, 0x9E3779B1)
    x = x ^ _mul_u32(h1.long() & _M32, 0x85EBCA6B)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0xC2B2AE35)
    x = x ^ _mul_u32(h2.long() & _M32, 0x27D4EB2F)
    x = x ^ (x >> 13)
    return x


def _edge_lookup(edge_tab: torch.Tensor, probe_len: int, node: torch.Tensor,
                 h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Exact literal-child lookup; node/h1/h2 are [B,K]; returns child or
    -1. Every key lives in bucket mix1(key), so the lookup reads exactly
    one bucket row; the child is the max over hits in that row."""
    nb = edge_tab.shape[0]
    flat = edge_tab.reshape(nb, probe_len * 4)
    b1 = _mix_u32(node, h1, h2) & (nb - 1)
    rows = flat[b1].reshape(node.shape + (probe_len, 4))  # [B,K,P,4]
    hit = ((rows[..., 0] == node[..., None])
           & (rows[..., 1] == h1[..., None])
           & (rows[..., 2] == h2[..., None]))
    return torch.where(hit, rows[..., 3], -1).amax(dim=-1)


def _bitonic_desc(x: torch.Tensor) -> torch.Tensor:
    """Descending sort along dim 1 as a static compare-exchange network.
    Non-power-of-two widths are padded with INT32_MIN, which sorts past
    every real value including the -1 empty marker."""
    b, orig = x.shape
    n = 1 << (orig - 1).bit_length()
    if n != orig:
        pad = torch.full((b, n - orig), torch.iinfo(torch.int32).min,
                         dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad], dim=1)
    lane = torch.arange(n, device=x.device)[None, :]
    stage = 2
    while stage <= n:
        step = stage // 2
        while step >= 1:
            y = x.reshape(b, n // (2 * step), 2, step).flip(2).reshape(b, n)
            take_max = ((lane & stage) == 0) == ((lane & step) == 0)
            x = torch.where(take_max, torch.maximum(x, y),
                            torch.minimum(x, y))
            step //= 2
        stage *= 2
    return x


def _advance(trie: DeviceTrie, probes: Probes, probe_len: int, k: int,
             i: int, act, valid, allow_wc, node_rec, visits=None):
    """One NFA step: literal + '+' successors, compacted to K slots.

    ``act`` may be narrower than K ([B, cap] for the widening prefix
    steps); while the 2*cap candidates fit in K they are kept unsorted as
    ``[exact | plus]`` and overflow is impossible. Returns (new_act
    [B, min(2*cap, K)], overflowed [B])."""
    b, cap = act.shape
    stepping = (i < probes.lengths)[:, None]
    h1 = probes.tok_h1[:, i:i + 1].expand(b, cap)
    h2 = probes.tok_h2[:, i:i + 1].expand(b, cap)
    node = act.clamp(min=0)
    if visits is not None:
        nb = trie.edge_tab.shape[0]
        visits["buckets"].append(
            (_mix_u32(node, h1, h2) & (nb - 1))[stepping & valid])
    exact = _edge_lookup(trie.edge_tab, probe_len, node, h1, h2)
    exact = torch.where(stepping & valid, exact, -1)
    plus = torch.where(stepping & valid & allow_wc, node_rec[..., RT_PLUS],
                       -1)
    cand = torch.cat([exact, plus], dim=1)            # [B, 2*cap]
    if 2 * cap <= k:
        return cand, torch.zeros(b, dtype=torch.bool, device=act.device)
    overflowed = (cand >= 0).sum(dim=1) > k
    return _bitonic_desc(cand)[:, :k], overflowed


def _route_walk(trie: DeviceTrie, probes: Probes, probe_len: int,
                k_states: int, max_intervals: int, visits=None
                ) -> Tuple[torch.Tensor, ...]:
    """Interval-emitting walk body (the plain version of
    ``csrc/fused_walk.cu``).

    Per level, '#'-child accepts emit the folded (RT_HRSTART, RT_HRCOUNT)
    interval of each active state and final accepts (at i == length) emit
    (RT_RSTART, RT_RCOUNT); the emission row is ``[hc K | final K]``,
    level-major, and ONE keep-order pack at the end moves the live
    intervals into [B, A] lanes.

    ``visits`` (a dict with "rows" and "buckets" lists) collects the
    route-table rows and edge buckets each step reads, for a byte count.

    Returns (ivl_start [B, A], ivl_count [B, A], n_routes [B],
    overflow [B]).
    """
    b, width = probes.tok_h1.shape
    k = k_states
    dev = probes.tok_h1.device

    def pad_k(x):
        cap = x.shape[1]
        if cap == k:
            return x
        return torch.cat([x, x.new_zeros((b, k - cap))], dim=1)

    em_s: List[torch.Tensor] = []
    em_c: List[torch.Tensor] = []

    def step(i, act, overflow):
        in_range = (i <= probes.lengths)[:, None]
        valid = (act >= 0) & in_range
        allow_wc = torch.logical_not(probes.sys_mask & (i == 0))[:, None]
        if visits is not None:
            visits["rows"].append(act[valid])
        node_rec = trie.route_tab[act.clamp(min=0)]
        hc_cnt = torch.where(valid & allow_wc, node_rec[..., RT_HRCOUNT], 0)
        is_final = (i == probes.lengths)[:, None]
        fin_cnt = torch.where(is_final & valid, node_rec[..., RT_RCOUNT], 0)
        em_c.append(torch.cat([pad_k(hc_cnt), pad_k(fin_cnt)], dim=1))
        em_s.append(torch.cat([pad_k(node_rec[..., RT_HRSTART]),
                               pad_k(node_rec[..., RT_RSTART])], dim=1))
        new_act, overflowed = _advance(trie, probes, probe_len, k, i, act,
                                       valid, allow_wc, node_rec, visits)
        return new_act, overflow | overflowed

    overflow = torch.zeros(b, dtype=torch.bool, device=dev)
    act = torch.where(probes.lengths >= 0, probes.roots, -1)[:, None]
    i = 0
    # progressively-widening prefix: at most 2^s states after s steps
    while act.shape[1] < k and i < width:
        act, overflow = step(i, act, overflow)
        i += 1
    # then to the longest topic in the batch (host mirror: no sync)
    for j in range(i, min(max(probes.max_len + 1, i), width)):
        act, overflow = step(j, act, overflow)

    # ---- single compaction pass: dense emissions -> [B, A] interval lanes
    a = max_intervals
    flat_c = torch.cat(em_c, dim=1)
    flat_s = torch.cat(em_s, dim=1)
    keep = flat_c > 0
    n_ivl = keep.sum(dim=1, dtype=torch.int32)
    n_routes = flat_c.sum(dim=1, dtype=torch.int32)
    pos = torch.cumsum(keep.int(), dim=1) - 1
    pos = torch.where(keep, pos, a).clamp(max=a).long()  # col a == dropped
    ivl_s = flat_s.new_zeros((b, a + 1)).scatter_(1, pos, flat_s)[:, :a]
    ivl_c = flat_c.new_zeros((b, a + 1)).scatter_(1, pos, flat_c)[:, :a]
    return (ivl_s.contiguous(), ivl_c.contiguous(), n_routes,
            overflow | (n_ivl > a))


def walk_routes(trie: DeviceTrie, probes: Probes, *, probe_len: int,
                k_states: int = 32, max_intervals: int = 32, esc_k=None,
                esc_rows=None) -> RouteIntervals:
    """Interval walk + on-device overflow escalation (plain version).

    Overflowed rows (active states > k_states, or > max_intervals live
    intervals) re-walk in one compacted sub-batch of up to ``esc_rows``
    rows at ``esc_k`` states; only rows that overflow even then report
    overflow to the host fallback. ``esc_k=0`` is the single walk that
    the fused kernel computes.
    """
    b = probes.tok_h1.shape[0]
    ivl_s, ivl_c, n_routes, overflow = _route_walk(
        trie, probes, probe_len, k_states, max_intervals)
    if esc_k is None:
        esc_k = min(2 * k_states, 128)
    if not esc_k or esc_k <= k_states or not bool(overflow.any()):
        return RouteIntervals(ivl_s, ivl_c, n_routes, overflow)
    if esc_rows is None:
        esc_rows = max(64, b // 64)
    e = min(esc_rows, b)
    # overflow rows first, in row order; the rest only pad the sub-batch
    idx = torch.argsort(torch.logical_not(overflow).int(), stable=True)[:e]
    sel = torch.arange(e, device=idx.device) < overflow.sum()
    sub = Probes(tok_h1=probes.tok_h1[idx], tok_h2=probes.tok_h2[idx],
                 lengths=torch.where(sel, probes.lengths[idx], -1),
                 roots=probes.roots[idx], sys_mask=probes.sys_mask[idx],
                 max_len=probes.max_len)
    s2, c2, nr2, ovf2 = _route_walk(trie, sub, probe_len, esc_k,
                                    max_intervals)
    success = sel & torch.logical_not(ovf2)
    ok_idx = idx[success]
    ivl_s[ok_idx] = s2[success]
    ivl_c[ok_idx] = c2[success]
    n_routes[ok_idx] = nr2[success]
    overflow[ok_idx] = False
    return RouteIntervals(ivl_s, ivl_c, n_routes, overflow)


# ------------------- device-side patch application --------------------------
#
# A host patch (models.automaton.PatchableTrie) ships to the device as
# narrow row writes — idx + row values only, never a whole-table
# re-upload — unless the arena reshaped (node growth / edge regrow), which
# re-puts just the reshaped table. ``donate=True`` writes the rows into the
# serving tables in place (``index_copy_``): legal only when no dispatched
# batch still reads the old tables. ``donate=False`` returns new tensors
# and leaves the old ones intact for whoever holds them. The reference's
# ``_pad_patch_idx``, ``scatter_warm_shapes`` and ``warm_patch_scatter``
# exist to spare XLA re-traces of its scatter; eager PyTorch traces
# nothing, so they are not copied.


def patch_device_trie(dev: DeviceTrie, pt, *, device=None,
                      donate: bool = False):
    """Apply a PatchableTrie's pending dirty set to the device tables.

    Returns ``(new DeviceTrie, stats)`` with ``stats`` carrying the rows
    touched, host→device bytes shipped, the mutation count drained, and
    whether any table reshaped. On any failure the drained rows are
    restored as a full re-upload (``restore_dirty``) and the error
    propagates.
    """
    full, node_rows, edge_rows, ops = pt.drain_dirty()
    try:
        return _patch_device_trie(dev, pt, full, node_rows, edge_rows,
                                  ops, device=device, donate=donate)
    except BaseException:
        # the drained rows must not be lost (an in-place update may even
        # have written some tables and not others): full re-upload dirt
        pt.restore_dirty(ops)
        raise


def _patch_device_trie(dev, pt, full, node_rows, edge_rows, ops, *,
                       device, donate):
    if device is None:
        device = dev.node_tab.device

    def write(tab, idx, rows):
        if donate:
            return tab.index_copy_(0, idx, rows)
        return tab.index_copy(0, idx, rows)

    stats = {"rows": 0, "bytes": 0, "ops": ops, "reshaped": False,
             "full": sorted(full), "donated": bool(donate)}
    node_tab, count_tab, route_tab = (dev.node_tab, dev.count_tab,
                                      dev.route_tab)
    edge_tab = dev.edge_tab
    if "node" in full:
        stats["reshaped"] |= tuple(pt.node_tab.shape) \
            != tuple(dev.node_tab.shape)
        node_tab = put(pt.node_tab, device)
        count_tab = put(count_cols_from_node_tab(pt.node_tab), device)
        route_tab = put(route_cols_from_node_tab(pt.node_tab), device)
        stats["rows"] += int(pt.node_tab.shape[0])
        stats["bytes"] += int(pt.node_tab.nbytes) \
            + pt.node_tab.shape[0] * (CT_COLS + RT_COLS) * 4
    elif node_rows.size:
        rows_np = pt.node_tab[node_rows]
        idx = put(node_rows, device)
        node_tab = write(node_tab, idx, put(rows_np, device))
        count_tab = write(count_tab, idx,
                          put(count_cols_from_node_tab(rows_np), device))
        route_tab = write(route_tab, idx,
                          put(route_cols_from_node_tab(rows_np), device))
        stats["rows"] += int(node_rows.size)
        stats["bytes"] += int(node_rows.nbytes) + int(rows_np.nbytes) \
            + node_rows.size * (CT_COLS + RT_COLS) * 4
    if "edge" in full:
        stats["reshaped"] |= tuple(pt.edge_tab.shape) \
            != tuple(dev.edge_tab.shape)
        edge_tab = put(pt.edge_tab, device)
        stats["rows"] += int(pt.edge_tab.shape[0])
        stats["bytes"] += int(pt.edge_tab.nbytes)
    elif edge_rows.size:
        rows_np = pt.edge_tab[edge_rows]
        edge_tab = write(edge_tab, put(edge_rows, device),
                         put(rows_np, device))
        stats["rows"] += int(edge_rows.size)
        stats["bytes"] += int(edge_rows.nbytes) + int(rows_np.nbytes)
    return DeviceTrie(node_tab=node_tab, edge_tab=edge_tab,
                      child_list=dev.child_list, count_tab=count_tab,
                      route_tab=route_tab), stats


_EXPAND_SRC = CSRC_HOST / "expand.cpp"
_INT32_MAX = int(np.iinfo(np.int32).max)


def _type_expand(lib) -> None:
    # raw addresses, not POINTER objects: the mesh's truncated rows
    # expand one row a call, where the per-call cost is the binding's
    lib.expand_grid.restype = ctypes.c_int64
    lib.expand_grid.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_void_p,
                                ctypes.c_void_p]


def _expand_lib():
    return compile_and_load(_EXPAND_SRC, configure=_type_expand)


def _row_offsets(counts64: np.ndarray) -> np.ndarray:
    row_counts = (counts64.sum(axis=1) if counts64.ndim == 2
                  else counts64.sum(keepdims=True))
    return np.concatenate([np.zeros(1, np.int64), np.cumsum(row_counts)])


def expand_intervals(ivl_start: np.ndarray, ivl_count: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side interval -> slot-id expansion.

    Returns (slots, row_offsets): row i's matched slot ids are
    ``slots[row_offsets[i]:row_offsets[i+1]]``, int32. The C++ sequential
    stores of ``csrc/host/expand.cpp`` serve every grid whose total fits
    in int32 and is not 0; an empty grid, or one past int32, takes
    :func:`expand_intervals_numpy` (a size rule, as in the reference). A
    library that fails to build or load raises
    :class:`~bifromq_tpu_torch.utils.nativelib.NativeLibError`.
    """
    ivl_start = np.asarray(ivl_start)
    ivl_count = np.maximum(np.asarray(ivl_count), 0)
    total = int(ivl_count.sum(dtype=np.int64))
    if not 0 < total <= _INT32_MAX:
        return expand_intervals_numpy(ivl_start, ivl_count)
    lib = _expand_lib()
    grid = np.empty(ivl_count.shape + (2,), np.int32)
    grid[..., 0] = ivl_start
    grid[..., 1] = ivl_count
    rows = grid.shape[0] if grid.ndim == 3 else 1
    out = np.empty(total, np.int32)
    row_offsets = np.zeros(rows + 1, np.int64)
    w = lib.expand_grid(grid.ctypes.data, rows, grid.size // (2 * rows),
                        out.ctypes.data, row_offsets[1:].ctypes.data)
    assert w == total, (w, total)   # counts/grid must agree
    if rows > 1:        # one row (the mesh's truncated rows): [0, total]
        np.cumsum(row_offsets, out=row_offsets)
    CALLS["expand"] += 1
    return out, row_offsets


def expand_intervals_numpy(ivl_start: np.ndarray, ivl_count: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """The numpy leg of :func:`expand_intervals`, with the same results:
    one vectorized ragged arange."""
    ivl_start = np.asarray(ivl_start)
    counts64 = np.maximum(np.asarray(ivl_count), 0).astype(np.int64)
    row_offsets = _row_offsets(counts64)
    total = int(row_offsets[-1])
    flat_s = ivl_start.ravel().astype(np.int64)
    flat_c = counts64.ravel()
    ends = np.cumsum(flat_c)
    inner = np.arange(total, dtype=np.int64) - np.repeat(ends - flat_c,
                                                         flat_c)
    slots = (np.repeat(flat_s, flat_c) + inner).astype(np.int32)
    return slots, row_offsets


# ------------------ device-side fan-out ------------------------------------
#
# The walk's [B, A] interval grids become dense (slot, topic-row) pairs on
# the device via a ragged arange, then one stable counting sort groups the
# pairs by delivery peer so the host receives pre-bucketed grids. The raw
# surface is byte-compatible with expand_intervals' row-major order;
# bucketing ships as a SEPARATELY ordered view (peer_slots/peer_rows/
# peer_offsets).

# sentinel buckets appended after the n_peers real peers: slots whose
# delivery target the peer table cannot name land in UNKNOWN; PAD holds
# the expansion buffer's dead lanes so live buckets stay contiguous.
PEER_UNKNOWN = 0   # bucket id = n_peers + PEER_UNKNOWN
PEER_PAD = 1       # bucket id = n_peers + PEER_PAD
N_SENTINEL_BUCKETS = 2


def expand_cap_lanes() -> int:
    """``BIFROMQ_EXPAND_CAP``: per-row pair budget of the device expansion
    buffer (batch capacity = B x this). Rows whose fan-out pushes the batch
    past the buffer are flagged ``trunc`` and re-expand on host from the
    interval grids — exact, just not pre-bucketed."""
    return max(1, env_int("BIFROMQ_EXPAND_CAP", 64))


# the leaves the fetch reads every batch, and the interval grids that
# buffer-truncated rows re-expand from: the grids are copied with the rest
# because a later blocking read of them would wait for every batch
# dispatched on the stream since, not for this batch alone
FETCH_LEAVES = ("overflow", "slots", "rows", "row_offsets", "n_pairs",
                "trunc", "peer_slots", "peer_rows", "peer_offsets",
                "start", "count")


class HostFetch:
    """The fetch-on-ready half of one result, and its readiness leaf.

    On the card, :meth:`copy_to_host_async` enqueues a ``non_blocking``
    device→host copy of each leaf into a pinned host buffer on the
    current (serving) stream, the stream the kernels ran on, and records
    one CUDA event behind the copies: :meth:`is_ready` is that event's
    query, and :meth:`arrays` reads the pinned buffers with no further
    device sync. The buffers are this object's; whoever holds it (the
    result, or the quarantine holding the result) keeps them and the
    device tensors alive until the event completes. On the CPU every
    leaf is always ready and the fetch is a plain copy.
    """

    __slots__ = ("_dev", "_host", "_event")

    def __init__(self, tensors: Dict[str, torch.Tensor]) -> None:
        self._dev = tensors
        self._host = None
        self._event = None

    def copy_to_host_async(self) -> None:
        if self._host is not None:
            return
        first = next(iter(self._dev.values()))
        if not first.is_cuda:
            self._host = {k: v.numpy().copy() for k, v in self._dev.items()}
            return
        host: Dict[str, torch.Tensor] = {}
        by_id: Dict[int, torch.Tensor] = {}
        for name, t in self._dev.items():
            h = by_id.get(id(t))    # peer_* alias slots/rows at n_peers 0
            if h is None:
                h = by_id[id(t)] = torch.empty(t.shape, dtype=t.dtype,
                                               pin_memory=True)
                h.copy_(t, non_blocking=True)
            host[name] = h
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(first.device))
        self._host, self._event = host, event

    def is_ready(self) -> bool:
        self.copy_to_host_async()
        return self._event is None or self._event.query()

    def arrays(self) -> Dict[str, np.ndarray]:
        """Host arrays of every leaf, after the copies land (on the card,
        read in place from the pinned buffers)."""
        self.copy_to_host_async()
        if self._event is None:
            return self._host
        self._event.synchronize()
        return {k: v.numpy() for k, v in self._host.items()}


@dataclass
class ExpandedRoutes:
    """Device-expanded, peer-bucketed fan-out of one walk batch: the
    :class:`RouteIntervals` surface plus the expansion.

    - ``slots``/``rows``: dense (matching-slot, probe-row) pairs in the
      host expander's row-major order, ``-1`` past ``n_pairs``.
    - ``row_offsets``: row i's pairs live at ``[ro[i], ro[i+1])`` —
      valid wherever ``trunc[i]`` is False.
    - ``trunc``: the row's pairs did not fit the buffer; the host
      re-expands that row from ``start``/``count``.
    - ``peer_slots``/``peer_rows``/``peer_offsets``: the same pairs
      stably grouped by delivery peer (bucket ``n_peers`` = unknown
      target, ``n_peers + 1`` = dead padding), row-major in each bucket.
    """
    start: torch.Tensor         # [B, A] int32
    count: torch.Tensor         # [B, A] int32
    n_routes: torch.Tensor      # [B] int32
    overflow: torch.Tensor      # [B] bool — walk overflow (host re-match)
    slots: torch.Tensor         # [CAP] int32
    rows: torch.Tensor          # [CAP] int32
    row_offsets: torch.Tensor   # [B+1] int32
    n_pairs: torch.Tensor       # [] int32
    trunc: torch.Tensor         # [B] bool — expansion buffer overflow
    peer_slots: torch.Tensor    # [CAP] int32
    peer_rows: torch.Tensor     # [CAP] int32
    peer_offsets: torch.Tensor  # [n_peers+3] int32

    def host_fetch(self) -> HostFetch:
        """This result's one :class:`HostFetch` over ``FETCH_LEAVES``."""
        fetch = self.__dict__.get("_host_fetch")
        if fetch is None:
            fetch = self.__dict__["_host_fetch"] = HostFetch(
                {name: getattr(self, name) for name in FETCH_LEAVES})
        return fetch

    def ready_leaves(self):
        """The leaves the dispatch ring kicks and polls: one readiness
        handle for the pair buffers the fetch reads every batch."""
        return (self.host_fetch(),)


def _expand_prefix(ivl_s: torch.Tensor, ivl_c: torch.Tensor, cap: int):
    """The O(B·A) prefix sums every expansion needs (kept outside the
    kernel, as in the reference): (flat_s, ends, lane_lo, row_offsets,
    trunc), int32."""
    b, a = ivl_s.shape
    n = b * a
    flat_c = ivl_c.reshape(n).clamp(min=0)
    flat_s = ivl_s.reshape(n)
    ends = torch.cumsum(flat_c, dim=0, dtype=torch.int32)
    lane_lo = ends - flat_c
    row_offsets = torch.cat([ends.new_zeros(1), ends.reshape(b, a)[:, -1]])
    trunc = row_offsets[1:] > cap
    return flat_s.contiguous(), ends, lane_lo, row_offsets, trunc


def _expand_pairs(ivl_s: torch.Tensor, ivl_c: torch.Tensor, cap: int):
    """Ragged-arange expansion of [B, A] interval grids into dense pairs
    (the plain version of ``csrc/expand.cu``).

    Returns (slots [cap], rows [cap], row_offsets [B+1], n_pairs [],
    trunc [B]) in exactly ``expand_intervals``' row-major order, ``-1``
    past ``n_pairs``. Each output position's owning lane comes from one
    scatter-add of +1 at every lane start and one cumsum.
    """
    b, a = ivl_s.shape
    flat_s, ends, lane_lo, row_offsets, trunc = _expand_prefix(
        ivl_s, ivl_c, cap)
    total = ends[-1]
    # marks past the buffer land in a spare last position and are cut
    marks = ends.new_zeros(cap + 1).index_add_(
        0, lane_lo[1:].clamp(max=cap).long(),
        torch.ones_like(lane_lo[1:]))[:cap]
    lane_c = torch.cumsum(marks, dim=0, dtype=torch.int32)
    j = torch.arange(cap, dtype=torch.int32, device=ivl_s.device)
    valid = j < total
    comb = flat_s - lane_lo
    slots = torch.where(valid, comb[lane_c.long()] + j, -1)
    rows = torch.where(valid, lane_c // a, -1)
    return (slots.to(torch.int32), rows.to(torch.int32), row_offsets,
            total.clamp(max=cap), trunc)


def _bucket_pairs(slots: torch.Tensor, rows: torch.Tensor,
                  slot_peer: torch.Tensor, n_peers: int):
    """Stable counting sort of expanded pairs by delivery peer.

    ``slot_peer``: [n_slot] int32, peer id in [0, n_peers) or ``n_peers``
    for unknown. Pairs keep expansion (row-major) order inside each
    bucket; pad pairs (slot == -1) sort to the final bucket; slots beyond
    the table go to the unknown bucket. Up to 16 buckets this is a
    counting scan; wider peer sets take a stable argsort.
    """
    cap = slots.shape[0]
    n_slot = slot_peer.shape[0]
    unknown = n_peers + PEER_UNKNOWN
    pad = n_peers + PEER_PAD
    if n_slot == 0:
        peer = torch.where(slots < 0, pad, unknown)
    else:
        in_tab = (slots >= 0) & (slots < n_slot)
        peer = torch.where(
            slots < 0, pad,
            torch.where(in_tab, slot_peer[slots.clamp(0, n_slot - 1).long()],
                        unknown))
    p_tot = n_peers + N_SENTINEL_BUCKETS
    peer = peer.long()
    counts = torch.zeros(p_tot, dtype=torch.int32,
                         device=slots.device).index_add_(
        0, peer, torch.ones(cap, dtype=torch.int32, device=slots.device))
    starts = torch.cat([counts.new_zeros(1),
                        torch.cumsum(counts, dim=0, dtype=torch.int32)])
    if p_tot <= 16:
        rank = torch.zeros(cap, dtype=torch.int64, device=slots.device)
        for p in range(p_tot):
            m = peer == p
            rank = rank + torch.where(m, torch.cumsum(m.long(), dim=0) - 1,
                                      0)
        dst = starts.long()[peer] + rank
        peer_slots = torch.zeros_like(slots).scatter_(0, dst, slots)
        peer_rows = torch.zeros_like(rows).scatter_(0, dst, rows)
    else:
        order = torch.argsort(peer, stable=True)
        peer_slots = slots[order]
        peer_rows = rows[order]
    return peer_slots, peer_rows, starts


def _unbucketed_offsets(n_pairs: torch.Tensor, cap: int) -> torch.Tensor:
    """``peer_offsets`` where no delivery peer is known (n_peers == 0):
    every live pair sits in UNKNOWN as a contiguous prefix and the pad
    pairs trail, so the offsets are ``[0, n_pairs, cap]`` (``[..., 3]``
    over any leading block axes of ``n_pairs``)."""
    n_pairs = n_pairs.to(torch.int32)
    return torch.stack([torch.zeros_like(n_pairs), n_pairs,
                        torch.full_like(n_pairs, cap)], dim=-1)


def expand_routes(ivl: RouteIntervals, slot_peer: torch.Tensor, *,
                  cap: int, n_peers: int) -> ExpandedRoutes:
    """The serving expansion stage: walk intervals -> peer-bucketed pairs.

    Walk-overflow rows spend no buffer (their grids are junk and the host
    re-matches them regardless); their raw counts stay visible in
    ``.count`` for the escalation leg. The expansion itself is the
    expand kernel (``models/kernels.kernel_expand``).
    """
    from ..models.kernels import kernel_expand  # kernels imports this module
    serve_c = torch.where(ivl.overflow[:, None], 0, ivl.count)
    slots, rows, row_offsets, n_pairs, trunc = kernel_expand(
        ivl.start, serve_c, cap=cap)
    if n_peers == 0:
        # structurally bucketed already: the stable sort is the identity,
        # so the peer views alias the pair buffers, no copy
        peer_slots, peer_rows = slots, rows
        peer_offsets = _unbucketed_offsets(n_pairs, cap)
    else:
        peer_slots, peer_rows, peer_offsets = _bucket_pairs(
            slots, rows, slot_peer, n_peers)
    return ExpandedRoutes(ivl.start, ivl.count, ivl.n_routes, ivl.overflow,
                          slots, rows, row_offsets, n_pairs, trunc,
                          peer_slots, peer_rows, peer_offsets)


def bucket_pairs_host(slots: np.ndarray, rows: np.ndarray,
                      slot_peer: np.ndarray, n_peers: int):
    """Host reference of :func:`_bucket_pairs`: same bucket layout, numpy
    stable argsort."""
    slots = np.asarray(slots)
    rows = np.asarray(rows)
    slot_peer = np.asarray(slot_peer)
    n_slot = slot_peer.shape[0]
    unknown = n_peers + PEER_UNKNOWN
    pad = n_peers + PEER_PAD
    if n_slot == 0:
        peer = np.where(slots < 0, pad, unknown).astype(np.int32)
    else:
        in_tab = (slots >= 0) & (slots < n_slot)
        peer = np.where(
            slots < 0, pad,
            np.where(in_tab, slot_peer[np.clip(slots, 0, n_slot - 1)],
                     unknown)).astype(np.int32)
    p_tot = n_peers + N_SENTINEL_BUCKETS
    counts = np.bincount(peer, minlength=p_tot).astype(np.int32)
    starts = np.concatenate([np.zeros(1, np.int32),
                             np.cumsum(counts, dtype=np.int32)])
    order = np.argsort(peer, kind="stable")
    return slots[order], rows[order], starts
