"""Retained-message lookup: wildcard filters probe a trie of topics
(port of ``bifromq_tpu/ops/retained.py``).

The roles-swapped twin of ``ops/match.py``: the automaton stores
concrete retained topics, and the probes are SUBSCRIBE filters that may
hold '+' and '#'. Per probe level:

- literal → the same one-bucket edge lookup as ``ops/match``;
- '+'     → every literal child of every active node (a CSR range read,
            compacted by a cumsum partition; a row whose children exceed
            K sets its overflow flag and is served on the host);
- '#'     → terminal: with pre-order slot numbering a node's subtree is
            ONE contiguous slot range, so the walk emits (start, count).

[MQTT-4.7.2-1]: a root-level '+' / '#' must not reach '$'-prefixed first
levels. The compiler sorts '$' children first, so the walk skips a
prefix of the child range and of the slot range when i == 0.

The walk is plain PyTorch on the device too: the reference runs it as
``lax.fori_loop`` code, with no Pallas kernel. Its loop bound comes from
the probes' host mirror (``FilterProbes.max_len``), so a scan never
reads a device value to decide how many levels to walk.

A patched retained trie (``retained_plane/patched.py``) keeps its base
subtree ranges frozen and parks patch-era topic slots in an extras
plane: ``ext_tab[node] = (start, count, own_idx, pad)`` into
``extra_list``. The extras-aware walk reads one more 16-byte row per
active state and emits a second (start, count) pair per lane: '#' emits
the node's extras run, the final level the node's own patch slot. Base
ranges and extras are disjoint; dead slots in either are filtered on the
host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..models.automaton import (
    EXT_COLS, EXT_COUNT, EXT_OWN, EXT_START, KIND_HASH, KIND_LIT,
    KIND_PLUS, NODE_CCOUNT, NODE_CSTART, NODE_RCOUNT, NODE_RSTART,
    NODE_SUB_RCOUNT, NODE_SYS_CCOUNT, NODE_SYS_SLOTS, TokenizedFilters,
)
from ..utils.device import upload
from .match import HostFetch, _edge_lookup


@dataclass
class FilterProbes:
    """Device-side filter probe batch (see ``automaton.TokenizedFilters``).

    ``max_len`` is the longest row's level count, taken from the host
    mirror: the walk's loop bound, read without a device sync."""
    tok_h1: torch.Tensor     # [B, L+1] int32
    tok_h2: torch.Tensor     # [B, L+1] int32
    tok_kind: torch.Tensor   # [B, L+1] int32 (KIND_*)
    lengths: torch.Tensor    # [B] int32
    roots: torch.Tensor      # [B] int32
    max_len: int

    @staticmethod
    def from_tokenized(t: TokenizedFilters, device) -> "FilterProbes":
        return FilterProbes(*upload([t.tok_h1, t.tok_h2, t.tok_kind,
                                     t.lengths, t.roots], device),
                            int(t.lengths.max(initial=-1)))


RETAINED_TABLES = ("node_tab", "edge_tab", "child_list", "ext_tab",
                   "extra_list")


@dataclass
class RetainedDeviceTables:
    """The device-resident retained automaton: the compiled tables plus
    the extras plane (an empty plane for an unpatched compiled trie, so
    one walk serves both)."""
    node_tab: torch.Tensor     # [N, NODE_COLS] int32
    edge_tab: torch.Tensor     # [NB, P, 4] int32
    child_list: torch.Tensor   # [C] int32
    ext_tab: torch.Tensor      # [N, EXT_COLS] int32
    extra_list: torch.Tensor   # [E] int32 (slot ids; -1 slack)

    @staticmethod
    def host_arrays(ct) -> Tuple[np.ndarray, ...]:
        """The five tables of ``ct`` as host arrays, in field order."""
        ext = getattr(ct, "ext_tab", None)
        if ext is None:
            ext = np.zeros((ct.node_tab.shape[0], EXT_COLS), dtype=np.int32)
            ext[:, EXT_OWN] = -1
        extra = getattr(ct, "extra_list", None)
        if extra is None:
            extra = np.full(1, -1, dtype=np.int32)
        return ct.node_tab, ct.edge_tab, ct.child_list, ext, extra

    @staticmethod
    def from_trie(ct, device) -> "RetainedDeviceTables":
        return RetainedDeviceTables(
            *upload(RetainedDeviceTables.host_arrays(ct), device))


@dataclass
class RetainedScanResult:
    """One retained scan batch in flight: ``start`` the BASE slot ranges
    [B, K, 2], ``count`` the EXTRAS index ranges [B, K, 2] (into
    ``extra_list``), ``overflow`` the per-row escape flag [B]."""
    start: torch.Tensor
    count: torch.Tensor
    overflow: torch.Tensor

    def host_fetch(self) -> HostFetch:
        """This result's one :class:`HostFetch`: pinned host copies of
        the three leaves and one CUDA event."""
        fetch = self.__dict__.get("_host_fetch")
        if fetch is None:
            fetch = self.__dict__["_host_fetch"] = HostFetch(
                {"start": self.start, "count": self.count,
                 "overflow": self.overflow})
        return fetch

    def ready_leaves(self):
        """The leaves a scan plane's dispatch ring kicks and polls (and
        its quarantine holds): the fetch's one readiness handle."""
        return (self.host_fetch(),)


def retained_walk_ext(tables: RetainedDeviceTables, probes: FilterProbes,
                      *, probe_len: int, k_states: int = 32
                      ) -> RetainedScanResult:
    """Walk every filter row level by level over the retained tables.

    Returns base slot ranges, extras index ranges (resolved through
    ``extra_list`` on the host) and the overflow flags. Ranges with
    count <= 0 are empty; padding probes emit none."""
    b, width = probes.tok_h1.shape
    max_levels = width - 1
    k = k_states
    dev = probes.tok_h1.device
    i32 = torch.int32
    lengths = probes.lengths
    act = torch.full((b, k), -1, dtype=i32, device=dev)
    act[:, 0] = torch.where(lengths >= 0, probes.roots, -1)
    ranges = torch.zeros((b, k, 2), dtype=i32, device=dev)
    ext_ranges = torch.zeros((b, k, 2), dtype=i32, device=dev)
    overflow = torch.zeros((b,), dtype=torch.bool, device=dev)
    slot_ids = torch.arange(k, dtype=i32, device=dev)[None, :]   # [1,K]
    n_child = tables.child_list.shape[0]
    upper = min(max(probes.max_len + 1, 0), max_levels + 1)

    for i in range(upper):
        valid = act >= 0                                     # [B,K]
        stepping = (i < lengths)[:, None]
        node_idx = act.clamp(min=0).long()
        node_rec = tables.node_tab[node_idx]                 # [B,K,12]
        ext_rec = tables.ext_tab[node_idx]                   # [B,K,4]
        kind = probes.tok_kind[:, i:i + 1]                   # [B,1]
        at_root = i == 0   # the active set is {root} only before step 0

        # ---- '#': base subtree range + the node's extras run ----------
        hash_on = (stepping & (kind == KIND_HASH) & valid)[..., None]
        sys_skip = (node_rec[..., NODE_RCOUNT] + node_rec[..., NODE_SYS_SLOTS]
                    if at_root else 0)
        h_start = node_rec[..., NODE_RSTART] + sys_skip
        h_count = node_rec[..., NODE_SUB_RCOUNT] - sys_skip
        ranges = torch.where(hash_on, torch.stack(
            [h_start, torch.where(valid, h_count, 0)], dim=-1), ranges)
        # extras need no root '$' skip: '$'-rooted topics never enter the
        # tenant root's run (the patcher applies [MQTT-4.7.2-1] at insert)
        ext_ranges = torch.where(hash_on, torch.stack(
            [ext_rec[..., EXT_START],
             torch.where(valid, ext_rec[..., EXT_COUNT], 0)], dim=-1),
            ext_ranges)

        # ---- final level consumed: base own slots + own patch slot ----
        final_on = ((i == lengths)[:, None] & valid)[..., None]
        ranges = torch.where(final_on, torch.stack(
            [node_rec[..., NODE_RSTART],
             torch.where(valid, node_rec[..., NODE_RCOUNT], 0)], dim=-1),
            ranges)
        own_idx = ext_rec[..., EXT_OWN]
        ext_ranges = torch.where(final_on, torch.stack(
            [own_idx.clamp(min=0),
             (valid & (own_idx >= 0)).to(i32)], dim=-1), ext_ranges)

        # ---- successors ------------------------------------------------
        live = stepping & (kind != KIND_HASH) & valid
        h1 = probes.tok_h1[:, i:i + 1].expand(b, k)
        h2 = probes.tok_h2[:, i:i + 1].expand(b, k)
        exact = _edge_lookup(tables.edge_tab, probe_len, act.clamp(min=0),
                             h1, h2)
        exact = torch.where(live & (kind == KIND_LIT), exact, -1)

        # '+': every child of every active node, by a cumsum partition
        sys_cskip = node_rec[..., NODE_SYS_CCOUNT] if at_root else 0
        c_start = node_rec[..., NODE_CSTART] + sys_cskip
        c_count = torch.where(live & (kind == KIND_PLUS),
                              node_rec[..., NODE_CCOUNT] - sys_cskip, 0)
        offsets = torch.cumsum(c_count, dim=1, dtype=i32)    # inclusive
        total = offsets[:, -1]
        overflow = overflow | (total > k)
        # source state j of output slot s: the first j with offsets[j] > s
        src = (offsets[:, None, :] <= slot_ids[..., None]).sum(
            dim=-1).clamp(max=k - 1)                         # [B,K]
        base = offsets.gather(1, src) - c_count.gather(1, src)
        list_idx = c_start.gather(1, src) + (slot_ids - base)
        plus_kids = tables.child_list[
            list_idx.clamp(0, n_child - 1).long()]
        plus_kids = torch.where(slot_ids < total[:, None], plus_kids, -1)

        cand = torch.where(kind == KIND_PLUS, plus_kids, exact)   # [B,K]
        # compact: column K takes every dropped lane and is cut off
        cvalid = cand >= 0
        pos = torch.cumsum(cvalid, dim=1) - 1
        pos = torch.where(cvalid & (pos < k), pos, k)
        new_act = torch.full((b, k + 1), -1, dtype=i32, device=dev)
        act = new_act.scatter_(1, pos, cand)[:, :k]

    return RetainedScanResult(start=ranges, count=ext_ranges,
                              overflow=overflow)


# ---------------- device-side retained patch flush --------------------------

def patch_retained_tables(dev: RetainedDeviceTables, rt, *,
                          donate: bool = False
                          ) -> Tuple[RetainedDeviceTables, dict]:
    """Write a RetainedPatchableTrie's pending dirty rows into the five
    device tables (``ops.match.patch_device_trie`` for the retained
    tables). A reshaped table uploads whole. ``donate`` writes the rows
    in place; otherwise the written tables are new tensors and the old
    ones stay intact for a scan still reading them. A failed flush
    restores full-upload dirt (the host arenas stay authoritative) and
    raises."""
    full, node_rows, edge_rows, ext_rows, child_idx, extra_idx, ops = \
        rt.drain_dirty_retained()
    try:
        return _patch_retained(dev, rt, full, node_rows, edge_rows,
                               ext_rows, child_idx, extra_idx, ops,
                               donate=donate)
    except BaseException:
        rt.restore_dirty(ops)
        raise


def _patch_retained(dev, rt, full, node_rows, edge_rows, ext_rows,
                    child_idx, extra_idx, ops, *, donate):
    device = dev.node_tab.device
    stats = {"rows": 0, "bytes": 0, "ops": ops, "reshaped": False,
             "full": sorted(full), "donated": bool(donate)}

    def table(name, host, dev_tab, rows):
        if name in full:
            stats["reshaped"] |= tuple(host.shape) != tuple(dev_tab.shape)
            stats["rows"] += int(host.shape[0])
            stats["bytes"] += int(host.nbytes)
            return upload([host], device)[0]
        if rows.size:
            vals = host[rows]
            idx, vals_d = upload([rows, vals], device)
            stats["rows"] += int(rows.size)
            stats["bytes"] += int(rows.nbytes) + int(vals.nbytes)
            if donate:
                return dev_tab.index_copy_(0, idx, vals_d)
            return dev_tab.index_copy(0, idx, vals_d)
        return dev_tab

    return RetainedDeviceTables(
        node_tab=table("node", rt.node_tab, dev.node_tab, node_rows),
        edge_tab=table("edge", rt.edge_tab, dev.edge_tab, edge_rows),
        child_list=table("child", rt.child_list, dev.child_list, child_idx),
        ext_tab=table("ext", rt.ext_tab, dev.ext_tab, ext_rows),
        extra_list=table("extra", rt.extra_list, dev.extra_list,
                         extra_idx)), stats
