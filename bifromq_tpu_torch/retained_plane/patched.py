"""In-place patching of the retained trie's arenas (copy of
``bifromq_tpu/retained_plane/patched.py``).

``RetainedPatchableTrie`` extends :class:`PatchableTrie` with in-place
maintenance of the retained-mode columns the forward match walk never
reads:

- **child-list runs** (``NODE_CSTART`` / ``NODE_CCOUNT``): the retained
  walk's '+' expansion reads each node's contiguous child slice, so a
  patch-inserted literal child appends into the run's slack or moves the
  run to the child arena's tail with doubled capacity (the abandoned run
  becomes garbage the next compaction reclaims). '$'-prefixed children
  insert at the FRONT, so the '$'-children-first prefix that the root
  skip reads (``NODE_SYS_CCOUNT``, [MQTT-4.7.2-1]) survives patching.
- **subtree slot ranges** (``NODE_SUB_RCOUNT`` / ``NODE_SYS_SLOTS``):
  the '#' emission depends on compile-time pre-order slot contiguity,
  which no in-place insert can keep, so these stay FROZEN for base-era
  slots (still exact: removals tombstone in place and the host filters
  them) and patch-era topics ride a separate **extras plane**:
  ``ext_tab[node] = (extra_start, extra_count, own_idx, ·)`` into an
  append-only ``extra_list`` of slot ids. A new topic's slot id is
  appended to the extras run of its node and of every ancestor, the walk
  emits each '#'-node's extras run next to its base range, and the
  final-level step emits ``own_idx`` (the node's own patch slot) next to
  the base ``(RSTART, RCOUNT)`` pair. Base and extras are disjoint by
  construction.

A set, clear or expiry therefore costs row writes and at most O(depth)
run moves, never a ``compile_tries`` rebuild; a full compile runs only as
fragmentation-triggered compaction.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Set, Tuple

import numpy as np

from ..models.automaton import (
    _EMPTY, EXT_COLS, EXT_COUNT, EXT_OWN, EXT_START, NODE_CCOUNT,
    NODE_CSTART, NODE_RCOUNT, NODE_RSTART, NODE_SUB_RCOUNT,
    NODE_SYS_CCOUNT, PATCH_FRAG_FLOOR, PATCH_FRAG_RATIO, CompiledTrie,
    PatchableTrie, PatchFallback, _next_pow2, level_hash,
)
from ..utils import topic as topic_util


class RetainedPatchableTrie(PatchableTrie):
    """A PatchableTrie whose arenas accept in-place RETAINED-TOPIC
    patches (concrete topics only — wildcards are invalid in topics, so
    descent is purely literal and the '+'/'#' pointer columns stay
    empty by construction)."""

    def __init__(self, ct: CompiledTrie) -> None:
        super().__init__(ct)
        self._init_retained()

    def _init_retained(self) -> None:
        cap = int(self.node_tab.shape[0])
        # extras plane: per-node (start, count, own_idx) + the slot-id list
        ext = np.full((cap, EXT_COLS), 0, dtype=np.int32)
        ext[:, EXT_OWN] = _EMPTY
        self.ext_tab = ext
        self.extra_list = np.full(64, _EMPTY, dtype=np.int32)
        self.extra_live = 0
        self.extra_garbage = 0
        # child-list arena: base CSR runs + growth headroom at the tail
        base_cl = self.child_list
        # the match-plane pad (PatchableTrie pow2-floors child_list) is
        # dead tail, not live CSR data — size the retained arena from the
        # real run length so appends land right after the base runs
        used = int(self.child_used)
        ccap = _next_pow2(max(used + 1, int(used * 1.25)), floor=16)
        cl = np.full(ccap, _EMPTY, dtype=np.int32)
        cl[:used] = base_cl[:used]
        self.child_list = cl
        self.child_live = used
        self.child_garbage = 0
        # host-only run capacities (device only ever reads (start, count))
        self._child_cap: Dict[int, int] = {}
        self._ext_cap: Dict[int, int] = {}
        # patch-era own slots per node (base own slots live in the node
        # record; these live in the extras plane)
        self._own_slot: Dict[int, int] = {}
        self._roots: Set[int] = set(self.tenant_root.values())
        # dirty tracking for the three retained-only tables
        self._dirty_ext: Set[int] = set()
        self._dirty_child: Set[int] = set()
        self._dirty_extra: Set[int] = set()

    def install_retained_extras(self, *, ext_tab: np.ndarray,
                                extra_list: np.ndarray, extra_live: int,
                                extra_garbage: int, child_live: int,
                                child_garbage: int,
                                child_cap: Dict[int, int],
                                ext_cap: Dict[int, int],
                                own_slot: Dict[int, int]) -> None:
        """Install given retained extras verbatim — the retained-plane
        counterpart of :meth:`PatchableTrie.from_arenas`. The instance
        must come from ``RetainedPatchableTrie.from_arenas(...)`` (which
        skips ``_init_retained``); this supplies the half ``from_arenas``
        cannot: the extras plane, run capacities and patch-era own
        slots, byte-identical to their source so later patches land on
        the same rows."""
        self.ext_tab = np.asarray(ext_tab, dtype=np.int32)
        self.extra_list = np.asarray(extra_list, dtype=np.int32)
        self.extra_live = int(extra_live)
        self.extra_garbage = int(extra_garbage)
        # base child_list was installed by from_arenas — the given
        # arena already carries its grown capacity and slack
        self.child_live = int(child_live)
        self.child_garbage = int(child_garbage)
        self._child_cap = dict(child_cap)
        self._ext_cap = dict(ext_cap)
        self._own_slot = dict(own_slot)
        self._roots = set(self.tenant_root.values())
        self._dirty_ext = set()
        self._dirty_child = set()
        self._dirty_extra = set()

    # ---------------- arena growth ------------------------------------------

    def _grow_nodes(self) -> None:
        cap = self.node_tab.shape[0]
        super()._grow_nodes()
        ext = np.full((cap * 2, EXT_COLS), 0, dtype=np.int32)
        ext[:, EXT_OWN] = _EMPTY
        ext[:cap] = self.ext_tab
        self.ext_tab = ext
        self._full.add("ext")
        self._dirty_ext.clear()

    def _alloc_node(self) -> int:
        nid = super()._alloc_node()
        # retained-mode zeroing: a fresh node owns no base subtree slots
        # (its topics live in the extras plane), so the '#'-range count
        # must read 0, not the _EMPTY sentinel
        self.node_tab[nid, NODE_SUB_RCOUNT] = 0
        return nid

    def _child_alloc(self, n: int) -> int:
        need = self.child_live + n
        if need > self.child_list.shape[0]:
            ncap = _next_pow2(need, floor=self.child_list.shape[0] * 2)
            cl = np.full(ncap, _EMPTY, dtype=np.int32)
            cl[:self.child_live] = self.child_list[:self.child_live]
            self.child_list = cl
            self._full.add("child")
            self._dirty_child.clear()
        start = self.child_live
        self.child_live = need
        return start

    def _extra_alloc(self, n: int) -> int:
        need = self.extra_live + n
        if need > self.extra_list.shape[0]:
            ncap = _next_pow2(need, floor=self.extra_list.shape[0] * 2)
            el = np.full(ncap, _EMPTY, dtype=np.int32)
            el[:self.extra_live] = self.extra_list[:self.extra_live]
            self.extra_list = el
            self._full.add("extra")
            self._dirty_extra.clear()
        start = self.extra_live
        self.extra_live = need
        return start

    # ---------------- dirty bookkeeping -------------------------------------

    def _mark_child(self, idx: int, n: int = 1) -> None:
        if "child" not in self._full:
            self._dirty_child.update(range(idx, idx + n))

    def _mark_extra(self, idx: int, n: int = 1) -> None:
        if "extra" not in self._full:
            self._dirty_extra.update(range(idx, idx + n))

    def _mark_ext(self, nid: int) -> None:
        if "ext" not in self._full:
            self._dirty_ext.add(int(nid))

    @property
    def dirty(self) -> bool:
        return bool(super().dirty or self._dirty_ext or self._dirty_child
                    or self._dirty_extra)

    def drain_dirty_retained(self):
        """(full names, node rows, edge buckets, ext rows, child idx,
        extra idx, ops) since the last drain — the retained flush's
        superset of :meth:`PatchableTrie.drain_dirty`."""
        def _vec(s):
            return np.fromiter(sorted(s), dtype=np.int64, count=len(s))
        ext, child, extra = (_vec(self._dirty_ext), _vec(self._dirty_child),
                             _vec(self._dirty_extra))
        self._dirty_ext = set()
        self._dirty_child = set()
        self._dirty_extra = set()
        full, nodes, edges, ops = self.drain_dirty()
        return full, nodes, edges, ext, child, extra, ops

    def restore_dirty(self, ops: int) -> None:
        super().restore_dirty(ops)
        self._full |= {"child", "ext", "extra"}
        self._dirty_ext.clear()
        self._dirty_child.clear()
        self._dirty_extra.clear()

    def frag_pending(self) -> bool:
        if super().frag_pending():
            return True
        garbage = self.extra_garbage + self.child_garbage
        return garbage >= PATCH_FRAG_FLOOR and garbage >= \
            PATCH_FRAG_RATIO * max(1, self.extra_live + self.child_live)

    def patch_stats(self) -> Dict[str, object]:
        out = super().patch_stats()
        out.update({
            "extra_live": int(self.extra_live),
            "extra_garbage": int(self.extra_garbage),
            "child_live": int(self.child_live),
            "child_garbage": int(self.child_garbage),
            "patched_own_slots": len(self._own_slot),
        })
        return out

    # ---------------- run machinery -----------------------------------------

    def _append_child(self, parent: int, cid: int, level: str) -> None:
        """Insert ``cid`` into ``parent``'s child run, preserving the
        sys-children-prefix invariant ('$'-children insert at the
        FRONT). Relocates the run to the arena tail with doubled
        capacity when full (or when a front-insert is needed and the
        run cannot shift in place — base runs have no slack at all)."""
        is_sys = level.startswith(topic_util.SYS_PREFIX)
        cstart = int(self.node_tab[parent, NODE_CSTART])
        ccount = int(self.node_tab[parent, NODE_CCOUNT])
        cap = self._child_cap.get(parent, ccount if cstart >= 0 else 0)
        if ccount == 0:
            start = self._child_alloc(4)
            self.child_list[start] = cid
            self._child_cap[parent] = 4
            self.node_tab[parent, NODE_CSTART] = start
            self._mark_child(start)
        elif not is_sys and ccount < cap:
            self.child_list[cstart + ccount] = cid
            self._mark_child(cstart + ccount)
        else:
            ncap = max(4, 2 * (ccount + 1))
            start = self._child_alloc(ncap)
            run = self.child_list[cstart:cstart + ccount].copy()
            if is_sys:
                self.child_list[start] = cid
                self.child_list[start + 1:start + 1 + ccount] = run
            else:
                self.child_list[start:start + ccount] = run
                self.child_list[start + ccount] = cid
            self._child_cap[parent] = ncap
            self.node_tab[parent, NODE_CSTART] = start
            self.child_garbage += ccount
            self._mark_child(start, ccount + 1)
        self.node_tab[parent, NODE_CCOUNT] = ccount + 1
        if is_sys:
            self.node_tab[parent, NODE_SYS_CCOUNT] = \
                max(0, int(self.node_tab[parent, NODE_SYS_CCOUNT])) + 1
        self._mark_node(parent)

    def _ext_append(self, nid: int, slot: int, *, own: bool = False) -> None:
        """Append ``slot`` to ``nid``'s extras run (capacity-doubling
        relocation on overflow); ``own=True`` also records the entry's
        index in EXT_OWN for the final-level emission."""
        start = int(self.ext_tab[nid, EXT_START])
        count = int(self.ext_tab[nid, EXT_COUNT])
        cap = self._ext_cap.get(nid, 0)
        if count >= cap:
            ncap = max(8, 2 * cap)
            s = self._extra_alloc(ncap)
            if count:
                self.extra_list[s:s + count] = \
                    self.extra_list[start:start + count]
                self.extra_garbage += count
                own_idx = int(self.ext_tab[nid, EXT_OWN])
                if own_idx >= 0:
                    # the run moved; the own-slot entry moved with it
                    self.ext_tab[nid, EXT_OWN] = s + (own_idx - start)
            self._ext_cap[nid] = ncap
            start = s
            self.ext_tab[nid, EXT_START] = start
            self._mark_extra(start, count)
        self.extra_list[start + count] = slot
        self._mark_extra(start + count)
        self.ext_tab[nid, EXT_COUNT] = count + 1
        if own:
            self.ext_tab[nid, EXT_OWN] = start + count
        self._mark_ext(nid)

    # ---------------- descent -----------------------------------------------

    def _descend_retained(self, root: int, levels: Sequence[str],
                          create: bool) -> Tuple[int, bool]:
        """Literal-only descent; returns (node, created_any). A patch-era
        same-parent 64-bit hash collision raises PatchFallback (the
        caller schedules a re-salting rebuild — the compiler's exactness
        contract, never a guess)."""
        nid = root
        created = False
        for level in levels:
            h1, h2 = level_hash(level, self.salt)
            child = self._edge_child(nid, h1, h2)
            if child >= 0:
                known = self._edge_level.get((nid, h1, h2))
                if known is not None and known != level:
                    raise PatchFallback(
                        f"level-hash collision {known!r} vs {level!r}")
            else:
                if not create:
                    return _EMPTY, created
                child = self._alloc_node()
                self._edge_insert(nid, h1, h2, child)
                self._edge_level[(nid, h1, h2)] = level
                self._append_child(nid, child, level)
                self.parent[child] = nid
                created = True
            nid = child
        return nid, created

    # ---------------- the retained patch ops --------------------------------

    def _base_own_slot(self, nid: int) -> Optional[int]:
        rs = int(self.node_tab[nid, NODE_RSTART])
        rc = int(self.node_tab[nid, NODE_RCOUNT])
        return rs if rc > 0 else None

    def retained_add(self, tenant_id: str, levels: Sequence[str],
                     route) -> Tuple[str, int]:
        """Fold one retained SET into the arenas. Returns
        ``("exists"|"resurrect"|"add", slot)`` — "exists" when the topic
        is already live (payload replacement, index unchanged),
        "resurrect" when a tombstoned slot came back in place (zero
        device traffic), "add" when a fresh slot appended (extras plane
        updated for the node + every ancestor)."""
        if not levels:
            raise PatchFallback("empty retained topic")
        root = self.tenant_root.get(tenant_id, _EMPTY)
        if root < 0:
            root = self._alloc_node()
            self.tenant_root[tenant_id] = root
            self._roots.add(root)
        nid, _created = self._descend_retained(root, levels, create=True)
        base_s = self._base_own_slot(nid)
        if base_s is not None:
            if self._kind[base_s] != CompiledTrie.SLOT_DEAD:
                return "exists", base_s
            # base-era tombstone resurrection: the slot's matching IS
            # this topic (receiver == topic by construction), so flipping
            # the kind back restores base-range coverage exactly — no
            # device write at all (kinds are host-side)
            self._kind[base_s] = CompiledTrie.SLOT_NORMAL
            self.dead_slots = max(0, self.dead_slots - 1)
            self.patched_ops += 1
            return "resurrect", base_s
        own = self._own_slot.get(nid)
        if own is not None:
            if self._kind[own] != CompiledTrie.SLOT_DEAD:
                return "exists", own
            self._kind[own] = CompiledTrie.SLOT_NORMAL
            self.dead_slots = max(0, self.dead_slots - 1)
            self.patched_ops += 1
            return "resurrect", own
        slot = self._append_slot(route)
        self._own_slot[nid] = slot
        # extras: the node's own run records the slot as EXT_OWN (the
        # final-level emission), every ancestor's run carries it for the
        # '#'-subtree emission. [MQTT-4.7.2-1]: a '$'-rooted topic never
        # enters the TENANT ROOT's run — the root-level '#'/'+' skip.
        sys_topic = levels[0].startswith(topic_util.SYS_PREFIX)
        anc = nid
        first = True
        while anc >= 0:
            if not (sys_topic and anc == root):
                self._ext_append(anc, slot, own=first)
            first = False
            if anc == root:
                break
            anc = int(self.parent[anc])
        self.patched_ops += 1
        self._pending_ops += 1
        return "add", slot

    def retained_remove(self, tenant_id: str,
                        levels: Sequence[str]) -> bool:
        """Fold one retained CLEAR/EXPIRE in: tombstone the topic's slot
        (base-era or patch-era) — zero device traffic, reclaimed by the
        next fragmentation compaction."""
        root = self.tenant_root.get(tenant_id, _EMPTY)
        if root < 0:
            return False
        nid, _created = self._descend_retained(root, levels, create=False)
        if nid < 0:
            return False
        s = self._base_own_slot(nid)
        if s is None or self._kind[s] == CompiledTrie.SLOT_DEAD:
            s = self._own_slot.get(nid)
        if s is None or self._kind[s] == CompiledTrie.SLOT_DEAD:
            return False
        self._kind[s] = CompiledTrie.SLOT_DEAD
        self.dead_slots += 1
        self.patched_ops += 1
        self._pending_ops += 1
        return True

    @property
    def pristine(self) -> bool:
        """True when no patch-era slots or tombstones exist — the state
        in which base subtree ranges alone are exhaustive and exact (the
        native escalation walker and range-level ``limit`` clipping are
        only valid here)."""
        return self.extra_live == 0 and self.dead_slots == 0

    def expansion_budget(self) -> int:
        """Upper bound on dead slots any single emitted range set can
        contain — the ``limit`` head-room the expander adds before
        host-side dead filtering trims back down."""
        return int(self.dead_slots)

    # the forward-matcher patch entry points make no sense on a retained
    # trie (routes are concrete topics); refuse loudly rather than
    # silently corrupting the extras invariants
    def patch_add(self, *a, **kw):
        raise PatchFallback("retained trie: use retained_add")

    def patch_remove(self, *a, **kw):
        raise PatchFallback("retained trie: use retained_remove")


__all__ = ["RetainedPatchableTrie"]
