"""Retained-topic index: host authority and compiled trie for filter
probes (port of ``bifromq_tpu/models/retained.py``).

The per-tenant topic tries are the authority; the index compiles them
into the automaton the retained walk (``ops/retained.py``) reads on the
card. ``match_filter_host`` is the exact host matcher (RetainMatcher
semantics plus the [MQTT-4.7.2-1] root-'$' rule): the test oracle, and
the server of the rows the walk cannot serve.

Mutations patch the live :class:`~bifromq_tpu_torch.retained_plane.
patched.RetainedPatchableTrie` arenas in place (tombstones,
resurrections, extras-plane appends, child-run upkeep) and reach the
card as row writes before the next walk; ``compile_tries`` runs only for
the first build, for a rebuild after a hash collision or an unpatched
index's mutation, and for fragmentation-triggered compaction. A scan is
staged (prepare → dispatch → fetch → expand) so an asynchronous plane
can run its dispatch ring between the stages.

Unlike the reference, nothing is served around a fault of the program:
a native walker that fails to build raises out of ``match_batch``.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..types import RouteMatcher, RouteMatcherType
from ..utils import topic as topic_util
from ..utils.device import resolve_device
from .automaton import (CompiledTrie, PatchFallback, _next_pow2,
                        compile_tries, tokenize_filters)
from .oracle import Route, SubscriptionTrie, _TrieNode


def _topic_route(topic_levels: Sequence[str], topic_str: str) -> Route:
    """A retained topic stored as a wildcard-free 'route'; receiver == topic."""
    return Route(
        matcher=RouteMatcher(type=RouteMatcherType.NORMAL,
                             filter_levels=tuple(topic_levels),
                             mqtt_topic_filter=topic_str),
        broker_id=0, receiver_id=topic_str, deliverer_key="")


def match_filter_host(trie: SubscriptionTrie,
                      filter_levels: Sequence[str],
                      limit: Optional[int] = None) -> List[str]:
    """Exact filter-over-topic-trie match (the host oracle, and the
    server of the rows the device walk cannot).

    ``limit`` makes the walk scan-bounded (it stops once ``limit``
    topics are collected, the RetainMessageMatchLimit contract).
    Depth-first, so a bounded lookup costs about O(limit × depth) even
    for '+'-heavy filters over a million-topic trie.
    """
    out: List[str] = []
    cap = limit if limit is not None else (1 << 62)
    if cap <= 0:
        return out
    n_levels = len(filter_levels)

    class _Full(Exception):
        pass

    def emit(r) -> None:
        out.append(r.receiver_id)
        if len(out) >= cap:
            raise _Full()

    def collect_subtree(node: _TrieNode, skip_sys: bool) -> None:
        for r in node.routes.values():
            emit(r)
        for level, child in node.children.items():
            if skip_sys and level.startswith(topic_util.SYS_PREFIX):
                continue
            collect_subtree(child, False)

    def walk(node: _TrieNode, i: int) -> None:
        if i == n_levels:
            for r in node.routes.values():
                emit(r)
            return
        lvl = filter_levels[i]
        at_root = i == 0
        if lvl == topic_util.MULTI_WILDCARD:
            collect_subtree(node, skip_sys=at_root)
        elif lvl == topic_util.SINGLE_WILDCARD:
            for name, child in node.children.items():
                if at_root and name.startswith(topic_util.SYS_PREFIX):
                    continue
                walk(child, i + 1)
        else:
            child = node.children.get(lvl)
            if child is not None:
                walk(child, i + 1)

    try:
        walk(trie._root, 0)
    except _Full:
        pass
    return out


class _ScanPrep:
    """Stage-0 output of a retained scan: the filter probes on the device
    and the host mirrors the expansion needs. ``ct`` / ``recv`` are the
    snapshot the walk dispatched against: a compaction swapping the
    compiled base between dispatch and expansion must not let old slot
    ids index a renumbered world."""

    __slots__ = ("queries", "probes", "roots", "lengths", "batch", "ct",
                 "recv")

    def __init__(self, **kw) -> None:
        self.recv = None
        for k, v in kw.items():
            setattr(self, k, v)


class RetainedIndex:
    """Per-tenant retained-topic tries and their compiled automaton on the
    card.

    The query side takes wildcard FILTERS (the retained walk). With
    ``patched=True`` (the default) mutations fold into the live arenas in
    place: ``rebuilds`` stays 0 under a retained flood, and
    ``compactions`` counts the fragmentation-triggered compiles, the
    only ones after the first build. ``patched=False`` recompiles after
    every mutation. ``device=None`` means the card.
    """

    def __init__(self, *, max_levels: int = 16, k_states: int = 32,
                 probe_len: int = 16, device=None,
                 patched: bool = True) -> None:
        self.max_levels = max_levels
        self.k_states = k_states
        self.probe_len = probe_len
        self.device = resolve_device(device)
        self.tries: Dict[str, SubscriptionTrie] = {}
        self._compiled: Optional[CompiledTrie] = None
        self._device_tables = None
        self._dirty = True
        self._patched = patched
        # full compiles by trigger: a retained flood keeps `rebuilds` at 0
        self.rebuilds = 0
        self.compactions = 0
        self.compile_time_s = 0.0
        self.patch_fallbacks = 0
        self.patch_flushes = 0
        # rows expand_scan served by match_filter_host: padding rows, and
        # '+' overflows the native walker could not take
        self.host_rows = 0
        # exact-invalidation consumers: called per applied mutation with
        # (tenant, levels, op), op "set" | "del"; a rebuild calls none
        # (results are the same across renumbering)
        self.delta_hooks: List = []
        # slot -> retained topic string, a capacity-padded object array,
        # so slot ranges expand with one vectorized fancy-index
        self._receiver_arr = np.empty(0, dtype=object)
        # a scan plane pins its dispatch ring here, so that every flush,
        # ring-less callers' too, sees the scans in flight before it
        # writes the tables in place
        self.serving_ring = None

    # ---------------- mutation side (patch first) ---------------------------

    def _emit_delta(self, tenant_id: str, levels, op: str) -> None:
        for cb in list(self.delta_hooks):
            try:
                cb(tenant_id, tuple(levels), op)
            except Exception:  # noqa: BLE001 — observers must not break
                logging.getLogger(__name__).exception("retained delta hook")

    def _patch_base(self):
        """The live patchable base, or None when patching cannot serve
        this mutation (no base yet, an unpatched index, a pending
        rebuild)."""
        if not self._patched or self._dirty or self._compiled is None:
            return None
        from ..retained_plane.patched import RetainedPatchableTrie
        ct = self._compiled
        return ct if isinstance(ct, RetainedPatchableTrie) else None

    def add_topic(self, tenant_id: str, topic_levels: Sequence[str],
                  topic_str: str) -> bool:
        trie = self.tries.setdefault(tenant_id, SubscriptionTrie())
        route = _topic_route(topic_levels, topic_str)
        added = trie.add(route)
        if added:  # a payload replacement leaves the index unchanged
            base = self._patch_base()
            if base is not None:
                try:
                    action, slot = base.retained_add(
                        tenant_id, list(topic_levels), route)
                    if action == "add":
                        self._recv_set(slot, topic_str)
                except PatchFallback:
                    # a patch-era hash collision: never guess, the
                    # rebuild re-salts
                    self.patch_fallbacks += 1
                    self._dirty = True
            else:
                self._dirty = True
            self._emit_delta(tenant_id, topic_levels, "set")
        return added

    def remove_topic(self, tenant_id: str, topic_levels: Sequence[str],
                     topic_str: str) -> bool:
        trie = self.tries.get(tenant_id)
        if trie is None:
            return False
        r = _topic_route(topic_levels, topic_str)
        removed = trie.remove(r.matcher, r.receiver_url)
        if removed:
            if len(trie) == 0:
                del self.tries[tenant_id]
            base = self._patch_base()
            if base is not None:
                try:
                    if not base.retained_remove(tenant_id,
                                                list(topic_levels)):
                        # index and authority drifted: rebuild, never
                        # serve wrong
                        self.patch_fallbacks += 1
                        self._dirty = True
                except PatchFallback:
                    self.patch_fallbacks += 1
                    self._dirty = True
            else:
                self._dirty = True
            self._emit_delta(tenant_id, topic_levels, "del")
        return removed

    def topic_count(self, tenant_id: str) -> int:
        trie = self.tries.get(tenant_id)
        return len(trie) if trie is not None else 0

    # ---------------- compile / compaction ----------------------------------

    def _recv_set(self, slot: int, topic_str: str) -> None:
        if slot >= self._receiver_arr.shape[0]:
            arr = np.empty(_next_pow2(slot + 1, floor=64), dtype=object)
            arr[:self._receiver_arr.shape[0]] = self._receiver_arr
            self._receiver_arr = arr
        self._receiver_arr[slot] = topic_str

    def frag_pending(self) -> bool:
        base = self._patch_base()
        return base is not None and base.frag_pending()

    def _install(self, ct: CompiledTrie, receivers: Sequence[str]) -> None:
        """Serve ``ct``: upload its tables and mirror its slot → topic
        array."""
        from ..ops.retained import RetainedDeviceTables
        self._compiled = ct
        self._device_tables = RetainedDeviceTables.from_trie(ct,
                                                             self.device)
        arr = np.empty(_next_pow2(max(len(receivers), 1), floor=64),
                       dtype=object)
        arr[:len(receivers)] = receivers
        self._receiver_arr = arr
        self._dirty = False

    def refresh(self) -> CompiledTrie:
        if self._compiled is None:
            reason = "first"
        elif self._dirty:
            reason = "rebuild"
        elif self.frag_pending():
            # fragmentation compaction: the ONLY compile a patched index
            # runs after its first build (tombstone / garbage reclaim)
            reason = "compact"
        else:
            return self._compiled
        t0 = time.perf_counter()
        ct = compile_tries(self.tries, max_levels=self.max_levels,
                           probe_len=self.probe_len)
        if self._patched:
            from ..retained_plane.patched import RetainedPatchableTrie
            ct = RetainedPatchableTrie(ct)
        self._install(ct, [m.receiver_id for m in ct.matchings])
        self.compile_time_s += time.perf_counter() - t0
        if reason == "rebuild":
            self.rebuilds += 1
        elif reason == "compact":
            self.compactions += 1
        return self._compiled

    def flush_device(self, *, ring=None, own_slots: int = 0) -> None:
        """Write pending host patches into the device tables, at most one
        flush per dispatch. The rows are written in place only when no
        scan in flight can still read the old tables: the caller's own
        not-yet-dispatched slots and an empty quarantine, as the forward
        matcher proves it."""
        base = self._patch_base()
        if base is None or not base.dirty or self._device_tables is None:
            return
        from ..ops.retained import patch_retained_tables
        if ring is None:
            # a ring-less caller must still honor a scan plane's scans
            # in flight
            ring = self.serving_ring
            own_slots = 0
        donate = ring is None or (ring.in_flight <= own_slots
                                  and not len(ring.quarantine))
        self._device_tables, _stats = patch_retained_tables(
            self._device_tables, base, donate=donate)
        self.patch_flushes += 1

    # ---------------- staged scan pipeline ----------------------------------

    def prepare_scan(self, queries: Sequence[Tuple[str, Sequence[str]]],
                     *, batch: Optional[int] = None) -> _ScanPrep:
        """Stage 0: pack (tenant, filter_levels) pairs into filter probes;
        K1 hashes their literal lanes on the device."""
        from ..ops.tokenize import device_tokenize_filters
        from .matcher import _pow2_batch

        ct = self.refresh()
        if batch is None:
            batch = _pow2_batch(len(queries))
        roots = [ct.root_of(t) for t, _ in queries]
        mirror, probes = device_tokenize_filters(
            [f for _, f in queries], roots, max_levels=ct.max_levels,
            salt=ct.salt, batch=batch, device=self.device)
        return _ScanPrep(queries=list(queries), probes=probes,
                         roots=np.asarray(roots, dtype=np.int64),
                         lengths=mirror.lengths, batch=batch, ct=ct)

    def device_probes(self, queries: Sequence[Tuple[str, Sequence[str]]],
                      *, batch: Optional[int] = None):
        """Back-compat probe constructor: (probes, roots, lengths)."""
        prep = self.prepare_scan(queries, batch=batch)
        return prep.probes, list(prep.roots), prep.lengths

    def dispatch_scan(self, prep: _ScanPrep, *, ring=None,
                      own_slots: int = 0):
        """Stage 1: flush pending patches and enqueue the extras-aware
        walk. Returns ``(prep, RetainedScanResult)``: the result is
        enqueued, not synchronized, and ``prep`` may be a new one: a
        compaction between prepare and dispatch renumbers roots and salt,
        so the probes are prepared again against the installed base."""
        from ..ops.retained import retained_walk_ext
        if self._compiled is not prep.ct:
            prep = self.prepare_scan(prep.queries, batch=prep.batch)
        self.flush_device(ring=ring, own_slots=own_slots)
        # the slot -> topic mirror AT dispatch: later growth reallocates
        # it, and a compaction renumbers every slot
        prep.recv = self._receiver_arr
        res = retained_walk_ext(self._device_tables, prep.probes,
                                probe_len=prep.ct.probe_len,
                                k_states=self.k_states)
        return prep, res

    @staticmethod
    def fetch_scan(res):
        """Stage 2: the one synchronization, through pinned copies and
        one CUDA event. The overflow copy is writable (the expansion
        clears the rows the native walker serves)."""
        a = res.host_fetch().arrays()
        return a["start"], a["count"], np.array(a["overflow"])

    def walk_device(self, probes):
        """Dispatch the retained walk on the current tables (back-compat
        surface: returns (base ranges, overflow))."""
        from ..ops.retained import retained_walk_ext
        self.refresh()
        self.flush_device()
        res = retained_walk_ext(self._device_tables, probes,
                                probe_len=self._compiled.probe_len,
                                k_states=self.k_states)
        return res.start, res.overflow

    # ---------------- expansion (stage 3) -----------------------------------

    def expand_scan(self, prep: _ScanPrep, fetched,
                    limit: Optional[int] = None) -> List[List[str]]:
        """Ranges → retained topic strings: native escalation for
        overflow rows, extras-plane resolution, dead-slot filtering and
        scan-bounded ``limit`` trimming, all against host mirrors."""
        queries = prep.queries
        nq = len(queries)
        base_r, ext_r, overflow = fetched
        base_r = base_r[:nq]
        ext_r = ext_r[:nq]
        overflow = np.array(overflow[:nq])    # writable: escalation clears
        lengths = np.asarray(prep.lengths)[:nq]
        roots_a = prep.roots[:nq]
        # the dispatch-time snapshot, not the live index
        ct = prep.ct
        recv = prep.recv if prep.recv is not None else self._receiver_arr
        from ..retained_plane.patched import RetainedPatchableTrie
        base = ct if isinstance(ct, RetainedPatchableTrie) else None
        pristine = base is None or base.pristine
        kind_arr = ct.slot_kind if (base is not None
                                    and base.dead_slots) else None

        # native escalation: rows the '+' fan-out overflowed resolve by
        # the C++ DFS over the same compiled tables, only while the base
        # is pristine (it reads the frozen subtree ranges; with extras or
        # tombstones such rows go to the exact host matcher until the
        # next compaction). A walker that fails to build raises.
        native_map: Dict[int, tuple] = {}
        esc = np.nonzero(overflow & (lengths >= 0) & (roots_a >= 0))[0]
        if esc.size and pristine:
            from .native_retained import match_rows_native
            sub_tok = tokenize_filters(
                [list(queries[i][1]) for i in esc],
                [int(roots_a[i]) for i in esc],
                max_levels=ct.max_levels, salt=ct.salt)
            rr, rn, rovf = match_rows_native(
                ct, sub_tok.tok_h1, sub_tok.tok_h2, sub_tok.tok_kind,
                sub_tok.lengths, sub_tok.roots, limit=limit)
            for j, qi in enumerate(esc):
                if not rovf[j]:
                    n = int(rn[j])
                    s0 = rr[j, :n, 0].astype(np.int64)
                    c0 = np.maximum(rr[j, :n, 1], 0).astype(np.int64)
                    if limit is not None and n:
                        cum = np.cumsum(c0)
                        c0 = np.clip(limit - (cum - c0), 0, c0)
                    native_map[int(qi)] = (s0, c0)
                    overflow[qi] = False

        starts = base_r[..., 0].astype(np.int64)
        counts = np.maximum(base_r[..., 1], 0).astype(np.int64)
        estarts = ext_r[..., 0].astype(np.int64)
        ecounts = np.maximum(ext_r[..., 1], 0).astype(np.int64)
        host_rows = overflow | (lengths < 0)
        row_mask = host_rows | (roots_a < 0)
        counts[row_mask] = 0
        ecounts[row_mask] = 0
        for qi in native_map:
            counts[qi] = 0      # the grid contributes nothing for them
            ecounts[qi] = 0
        if limit is not None:
            # clip the concatenated base + extras counts so expansion
            # stops at the cap; a base with tombstones gets dead-slot
            # head-room, trimmed back after host filtering
            cap = limit if kind_arr is None \
                else limit + base.expansion_budget()
            all_c = np.concatenate([counts, ecounts], axis=1)
            cum = np.cumsum(all_c, axis=1)
            all_c = np.clip(cap - (cum - all_c), 0, all_c)
            counts = all_c[:, :counts.shape[1]]
            ecounts = all_c[:, counts.shape[1]:]

        bslots, boffs = _ragged(starts, counts, nq)
        eidx, eoffs = _ragged(estarts, ecounts, nq)
        eslots = base.extra_list[eidx].astype(np.int64) if eidx.size \
            else eidx

        out: List[List[str]] = []
        for qi, (tenant_id, levels) in enumerate(queries):
            if roots_a[qi] < 0:
                out.append([])
                continue
            if qi in native_map:
                s0, c0 = native_map[qi]
                tot = int(c0.sum())
                if tot:
                    o = np.cumsum(c0) - c0
                    flat = (np.arange(tot, dtype=np.int64)
                            - np.repeat(o, c0) + np.repeat(s0, c0))
                    out.append(list(recv[flat]))
                else:
                    out.append([])
                continue
            if host_rows[qi]:
                self.host_rows += 1
                trie = self.tries.get(tenant_id)
                out.append(match_filter_host(trie, list(levels),
                                             limit=limit)
                           if trie is not None else [])
                continue
            row = np.concatenate([bslots[boffs[qi]:boffs[qi + 1]],
                                  eslots[eoffs[qi]:eoffs[qi + 1]]])
            if kind_arr is not None and row.size:
                row = row[kind_arr[row] != CompiledTrie.SLOT_DEAD]
            if limit is not None and row.size > limit:
                row = row[:limit]
            out.append(list(recv[row]) if row.size else [])
        return out

    # ---------------- sync entry points -------------------------------------

    def match_batch(self, queries: Sequence[Tuple[str, Sequence[str]]],
                    *, batch: Optional[int] = None,
                    limit: Optional[int] = None) -> List[List[str]]:
        """(tenant, filter_levels) pairs → matched retained topic strings.

        ``limit`` bounds the expansion per query (scan-bounded, as the
        reference's RetainMessageMatchLimit): entries a caller filters
        out afterwards (expired ones) may leave fewer than ``limit``.
        """
        if not queries:
            return []
        prep = self.prepare_scan(queries, batch=batch)
        prep, res = self.dispatch_scan(prep)
        return self.expand_scan(prep, self.fetch_scan(res), limit=limit)

    def match(self, tenant_id: str, filter_levels: Sequence[str],
              limit: Optional[int] = None) -> List[str]:
        return self.match_batch([(tenant_id, filter_levels)],
                                limit=limit)[0]


def _ragged(starts: np.ndarray, counts: np.ndarray, nq: int):
    """Flatten per-lane (start, count) ranges row by row: (flat slot ids,
    row offsets [nq + 1])."""
    fc = counts.ravel()
    total = int(fc.sum())
    if not total:
        return (np.empty(0, dtype=np.int64),
                np.zeros(nq + 1, dtype=np.int64))
    offs = np.cumsum(fc) - fc
    flat = (np.arange(total, dtype=np.int64)
            - np.repeat(offs, fc) + np.repeat(starts.ravel(), fc))
    row_offs = np.concatenate(
        [np.zeros(1, np.int64), np.cumsum(counts.sum(axis=1))])
    return flat, row_offs
