"""TorchMatcher: the match plane — compile, walk and expand on the card.

Port of the sync serving leg of ``bifromq_tpu/models/matcher.TpuMatcher``.
Authoritative subscription state lives in host-side per-tenant tries;
a compiled automaton snapshot serves batched match queries on the device
through three kernels — the BLAKE2b level hash, the fused interval walk
and the fan-out expansion — and topics that exceed the fixed-shape walk
fall back to the exact host oracle.

Mutation → visibility:

- Every mutation applies to the authoritative tries instantly and lands
  in a small **delta overlay** — per-tenant delta tries for adds plus a
  tombstone set for removes/supersedes — so it is visible to the next
  match call without recompiling anything (in-place patching of the
  device arenas is not ported yet: ``supports_patching`` is False).
- Serving walks the **base** compiled automaton and corrects the
  expansion with the overlay.
- A background **compaction** folds the overlay into a new base: the
  mutation log replays onto a shadow copy of the tries, the shadow
  compiles off-thread, and the serving thread swaps the new tables in and
  rebuilds the overlay from the log suffix.

The fetch is the synchronization: a ``.cpu()`` readback of the result
tensors.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..utils import topic as topic_util
from ..utils.device import resolve_device
from .automaton import (CompiledTrie, GroupMatching, Matching, TokenCache,
                        compile_tries, tokenize)
from .oracle import (PERSISTENT_SUB_BROKER_ID, UNCAPPED_FANOUT,
                     MatchedRoutes, Route, SubscriptionTrie)


def _pow2_batch(n: int, floor: int = 16) -> int:
    """Snap a batch size up to a power of two (a small set of shapes)."""
    b = floor
    while b < n:
        b *= 2
    return b


def _parse_levels(levels) -> List[str]:
    """Queries carry the raw topic (str or wire bytes) or a pre-parsed
    level sequence; normalize to a level-string list at the point of
    use."""
    if isinstance(levels, bytes):
        levels = levels.decode("utf-8")
    if isinstance(levels, str):
        return topic_util.parse(levels)
    return list(levels)


# tombstone key: (full mqtt topic filter incl. any share prefix, receiver_url)
_TombKey = Tuple[str, Tuple[int, str, str]]


class _Prepared:
    """Stage-0 output: a tokenized + uploaded probe batch, with the base
    snapshot it tokenized against."""

    __slots__ = ("queries", "ct", "tok", "probes", "roots", "batch")

    def __init__(self, **kw) -> None:
        for k, v in kw.items():
            setattr(self, k, v)


class _InFlight:
    """Captured dispatch state for one device batch: expansion runs
    against the SNAPSHOT the walk dispatched on (base tables and overlay
    dict objects), never a base a compaction swapped in meanwhile."""

    __slots__ = ("queries", "ct", "dev", "tok", "roots", "res", "tomb",
                 "delta", "batch", "peer_tab")

    def __init__(self, **kw) -> None:
        for k, v in kw.items():
            setattr(self, k, v)


class _HostPairs:
    """Host view of one device-expanded batch: the (slot, row) pair
    buffers + peer buckets ``_fetch_walk`` read back, plus the result for
    the lazy grid fetch that only buffer-truncated rows need."""

    __slots__ = ("slots", "rows", "row_offsets", "n_pairs", "trunc",
                 "peer_slots", "peer_rows", "peer_offsets", "res")

    def __init__(self, **kw) -> None:
        for k, v in kw.items():
            setattr(self, k, v)


def _host(t: torch.Tensor) -> np.ndarray:
    """Writable host copy of a device tensor (the readback syncs)."""
    return t.cpu().numpy().copy()


def apply_log_op(tries: Dict[str, SubscriptionTrie], op: Tuple) -> None:
    """Apply ONE matcher log op to a tries dict (the shadow replay)."""
    if op[0] == "add":
        _, tenant, route = op
        tries.setdefault(tenant, SubscriptionTrie()).add(route)
    elif op[0] == "rm":
        _, tenant, matcher, url, inc = op
        trie = tries.get(tenant)
        if trie is not None:
            trie.remove(matcher, url, inc)
            if len(trie) == 0:
                del tries[tenant]


class TorchMatcher:
    # in-place patching of the device arenas is not ported yet: every
    # mutation takes the overlay + compaction path
    supports_patching = False

    def __init__(self, *, max_levels: int = 16, k_states: int = 32,
                 probe_len: int = 16, device=None,
                 auto_compact: bool = True,
                 compact_threshold: int = 2048,
                 max_intervals: int = 32) -> None:
        self.max_levels = max_levels
        self.k_states = k_states
        self.probe_len = probe_len
        self.max_intervals = max_intervals
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            from .kernels import WALK_PROBE_LENS, WALK_SHAPES
            for shape in ((k_states, max_intervals),
                          self._escalation_budget()):
                if shape not in WALK_SHAPES:
                    raise ValueError(f"the walk kernel has no (K, A) = "
                                     f"{shape} instance; have {WALK_SHAPES}")
            if probe_len not in WALK_PROBE_LENS:
                raise ValueError(f"the walk kernel has no bucket width "
                                 f"{probe_len}; have {WALK_PROBE_LENS}")
        self.auto_compact = auto_compact
        self.compact_threshold = compact_threshold
        # authoritative state (exact guards; host fallback matches)
        self.tries: Dict[str, SubscriptionTrie] = {}
        # serving snapshot (swapped atomically; old tables stay alive for
        # an in-flight batch)
        self._base_ct: Optional[CompiledTrie] = None
        self._device_trie = None
        # overlay since the base snapshot
        self._delta: Dict[str, SubscriptionTrie] = {}
        self._tomb: Dict[str, Set[_TombKey]] = {}
        self._overlay_n = 0
        # per-topic token-row cache for level-list queries
        self._tok_cache = TokenCache()
        # mutation log since the shadow copy last synced; shadow is the
        # frozen snapshot source for off-thread compiles
        self._log: List[Tuple] = []
        self._shadow: Dict[str, SubscriptionTrie] = {}
        self._swap_lock = threading.Lock()
        self._pending_swap = None   # set by the compact thread
        self._compact_done = False
        self._compact_thread: Optional[threading.Thread] = None
        self.compile_count = 0      # full compiles
        self.compile_time_s = 0.0   # cumulative wall time in compiles
        # slot -> delivery-peer table, cached on base-snapshot identity;
        # last_expanded is the most recent device-bucketed batch
        self._peer_cache: Optional[Tuple] = None
        self.last_expanded = None

    @classmethod
    def from_tries(cls, tries: Dict[str, SubscriptionTrie],
                   **kwargs) -> "TorchMatcher":
        """Seed a matcher from pre-built tries WITHOUT replaying every
        route through the mutation log/overlay (bulk loads). The trie
        objects are SHARED between authoritative and shadow state: serve-
        only or serially-mutating workloads only."""
        m = cls(**kwargs)
        m.tries = tries
        m._shadow = tries
        m.refresh()
        return m

    # ---------------- mutation side (≈ batchAddRoute/batchRemoveRoute) -----

    def add_route(self, tenant_id: str, route: Route) -> bool:
        trie = self.tries.setdefault(tenant_id, SubscriptionTrie())
        created, effective = trie.add_effective(route)
        if not effective:  # stale-incarnation upsert: nothing changed
            return False
        op = ("add", tenant_id, route)
        self._log.append(op)
        self._overlay_record(op)
        self._maybe_compact()
        return created

    def remove_route(self, tenant_id: str, matcher, receiver_url,
                     incarnation: int = 0) -> bool:
        trie = self.tries.get(tenant_id)
        if trie is None:
            return False
        if not trie.remove(matcher, receiver_url, incarnation):
            return False
        if len(trie) == 0:
            del self.tries[tenant_id]
        op = ("rm", tenant_id, matcher, receiver_url, incarnation)
        self._log.append(op)
        self._overlay_record(op)
        self._maybe_compact()
        return True

    def _overlay_record(self, op: Tuple) -> None:
        """Fold one log op into the serving overlay (delta tries +
        tombstones): an add supersedes any base copy (tombstone) and
        supplies the live version via the delta trie; a remove tombstones
        the base copy and retracts any delta copy."""
        if op[0] == "add":
            _, tenant, route = op
            self._delta.setdefault(tenant, SubscriptionTrie()).add(route)
            self._tomb.setdefault(tenant, set()).add(
                (route.matcher.mqtt_topic_filter, route.receiver_url))
        else:
            _, tenant, matcher, url, inc = op
            d = self._delta.get(tenant)
            if d is not None:
                d.remove(matcher, url, inc)
            self._tomb.setdefault(tenant, set()).add(
                (matcher.mqtt_topic_filter, url))
        self._overlay_n += 1

    # ---------------- compilation / compaction -----------------------------

    @property
    def overlay_size(self) -> int:
        return self._overlay_n

    def _replay_log_into_shadow(self) -> None:
        for op in self._log:
            apply_log_op(self._shadow, op)
        self._log.clear()

    def _compile_shadow(self):
        from ..ops.match import DeviceTrie
        t0 = time.perf_counter()
        self.compile_count += 1
        ct = compile_tries(self._shadow, max_levels=self.max_levels,
                           probe_len=self.probe_len)
        dev = DeviceTrie.from_compiled(ct, device=self.device)
        self.compile_time_s += time.perf_counter() - t0
        return ct, dev

    def refresh(self) -> CompiledTrie:
        """Blocking quiesce: every pending mutation lands in the base."""
        self.drain()
        if self._base_ct is None or self._log:
            self._replay_log_into_shadow()
            self._install_base(*self._compile_shadow())
        return self._base_ct

    def _install_base(self, ct: CompiledTrie, dev) -> None:
        self._base_ct = ct
        self._device_trie = dev
        # mutations not in this base = the log suffix
        self._delta = {}
        self._tomb = {}
        self._overlay_n = 0
        for op in self._log:
            self._overlay_record(op)

    def _maybe_compact(self) -> None:
        # trigger on the FIRST mutation too (base is None): the first base
        # builds in the background so the first publish finds it ready
        if (self._compact_thread is not None
                or not self.auto_compact
                or (self._base_ct is not None
                    and self._overlay_n < self.compact_threshold)):
            self._apply_pending_swap()
            return
        # snapshot: fold the log into the shadow NOW (serving thread,
        # O(log)); the compile thread then reads only the frozen shadow
        self._replay_log_into_shadow()

        def work():
            try:
                result = self._compile_shadow()
            except Exception:  # noqa: BLE001 — must not wedge compaction
                logging.getLogger(__name__).exception(
                    "background compaction failed; will retry")
                result = None
            with self._swap_lock:
                self._pending_swap = result
                self._compact_done = True

        self._compact_done = False
        t = threading.Thread(target=work, name="torch-matcher-compact",
                             daemon=True)
        self._compact_thread = t
        t.start()

    def _apply_pending_swap(self) -> None:
        with self._swap_lock:
            pending, self._pending_swap = self._pending_swap, None
            done = self._compact_done
        if pending is not None:
            self._install_base(*pending)
        if done:
            # thread finished (successfully or not): allow the next compact
            self._compact_thread = None
            self._compact_done = False

    def drain(self) -> None:
        """Wait for any in-flight compaction and apply its result."""
        t = self._compact_thread
        if t is not None:
            t.join()
        self._apply_pending_swap()

    @property
    def compiled(self) -> CompiledTrie:
        return self.refresh()

    @property
    def device_trie(self):
        self.refresh()
        return self._device_trie

    # ---------------- query side (≈ SubscriptionCache.get) -----------------

    def match_batch(self, queries: Sequence[Tuple[str, Sequence[str]]],
                    *, max_persistent_fanout: int = UNCAPPED_FANOUT,
                    max_group_fanout: int = UNCAPPED_FANOUT,
                    batch: Optional[int] = None) -> List[MatchedRoutes]:
        """Match (tenant_id, topic) pairs; returns per-query routes.

        Exact at every instant: base walk ⊕ overlay ⊖ tombstones equals a
        match against the authoritative tries. Dispatch (tokenize + walk +
        expand on the device), fetch and host expansion run back to back.
        """
        if not queries:
            return []
        fl = self._dispatch_prepared(self._prepare_probes(queries, batch))
        overflow, pairs = self._fetch_walk(fl.res)
        return self._expand_walk(fl, overflow, pairs,
                                 max_persistent_fanout, max_group_fanout)

    def match(self, tenant_id: str, topic: str, **kwargs) -> MatchedRoutes:
        return self.match_batch([(tenant_id, topic)], **kwargs)[0]

    def _prepare_probes(self, queries, batch: Optional[int] = None
                        ) -> _Prepared:
        """Stage 0: topic prep + probe upload. String/bytes topic rows
        pack into ONE contiguous ``TopicBytes`` buffer whose raw bytes
        ship to the device hash kernel; pre-parsed level lists take the
        token-cache host path."""
        from ..ops.match import Probes
        self._apply_pending_swap()
        if self._base_ct is None:
            self.refresh()
        ct = self._base_ct
        if batch is None:
            batch = _pow2_batch(len(queries))
        roots = [ct.root_of(t) for t, _ in queries]
        topics = [levels for _, levels in queries]
        if all(isinstance(t, (str, bytes)) for t in topics):
            from ..ops.tokenize import device_tokenize
            from .bytetok import TopicBytes
            tok, probes = device_tokenize(
                TopicBytes.from_topics(topics), roots,
                max_levels=ct.max_levels, salt=ct.salt, batch=batch,
                device=self.device)
        else:
            tok = tokenize(topics, roots, max_levels=ct.max_levels,
                           salt=ct.salt, batch=batch, cache=self._tok_cache)
            probes = Probes.from_tokenized(tok, device=self.device)
        return _Prepared(queries=list(queries), ct=ct, tok=tok,
                         probes=probes, roots=roots, batch=batch)

    def _dispatch_prepared(self, prep: _Prepared) -> _InFlight:
        """Stage 1: enqueue the walk and the fan-out expansion for a
        prepared probe batch; returns once both are enqueued."""
        from ..ops.match import expand_cap_lanes, expand_routes
        if self._base_ct is not prep.ct:
            # a compaction swap landed between prep and dispatch: roots
            # and salt are per-snapshot, so re-prep against the new base
            prep = self._prepare_probes(prep.queries, prep.batch)
        ct = prep.ct
        res = self._walk_primary(prep.probes, ct)
        peer_tab, slot_peer = self._peer_table(ct)
        res = expand_routes(res, slot_peer,
                            cap=prep.batch * expand_cap_lanes(),
                            n_peers=peer_tab.n_peers)
        return _InFlight(queries=prep.queries, ct=ct,
                         dev=self._device_trie, tok=prep.tok,
                         roots=prep.roots, res=res, tomb=self._tomb,
                         delta=self._delta, batch=prep.batch,
                         peer_tab=peer_tab)

    def _escalation_budget(self) -> Tuple[int, int]:
        """(K, A) of the overflow re-walk: a higher state budget and a
        wider interval budget, never narrower than the primary's."""
        return (min(4 * self.k_states, 128),
                max(min(4 * self.max_intervals, 256), self.max_intervals))

    def _walk_primary(self, probes, ct):
        """The primary serving walk: the fused walk kernel."""
        from .kernels import fused_walk_routes
        return fused_walk_routes(self._device_trie, probes,
                                 probe_len=ct.probe_len,
                                 k_states=self.k_states,
                                 max_intervals=self.max_intervals)

    def _peer_table(self, ct):
        """The slot→delivery-peer table for this base snapshot, host +
        device halves, cached on snapshot identity."""
        cached = self._peer_cache
        if cached is not None and cached[0] is ct:
            return cached[1], cached[2]
        from ..dist.deliverer import build_peer_table
        tab = build_peer_table(ct.matchings_arr)
        dev_tab = torch.from_numpy(tab.slot_peer).to(self.device)
        self._peer_cache = (ct, tab, dev_tab)
        return tab, dev_tab

    @staticmethod
    def _fetch_walk(res):
        """Stage 2: the synchronization — writable host copies of the
        compact pair buffers (the interval grids stay on the device;
        escalation and truncated rows fetch them lazily)."""
        overflow = _host(res.overflow)
        pairs = _HostPairs(
            slots=_host(res.slots), rows=_host(res.rows),
            row_offsets=_host(res.row_offsets),
            n_pairs=int(res.n_pairs), trunc=_host(res.trunc),
            peer_slots=_host(res.peer_slots), peer_rows=_host(res.peer_rows),
            peer_offsets=_host(res.peer_offsets), res=res)
        return overflow, pairs

    @staticmethod
    def _fetch_escalation_grids(res):
        """Slow-path grid readback: only buffer-truncated rows ever need
        the interval grids on the host."""
        return _host(res.start), _host(res.count)

    def _expand_walk(self, fl: _InFlight, overflow, pairs: _HostPairs,
                     max_persistent_fanout: int,
                     max_group_fanout: int) -> List[MatchedRoutes]:
        """Stage 3: escalation + interval expansion + overlay correction,
        all against the _InFlight SNAPSHOT."""
        from ..ops.match import Probes, expand_intervals
        from .kernels import fused_walk_routes
        queries, ct, tok, roots = fl.queries, fl.ct, fl.tok, fl.roots
        # escalation: rows whose active set (or interval budget)
        # overflowed re-walk in one compacted sub-batch through the walk
        # kernel at a higher state budget AND a wider interval budget —
        # only rows that overflow even that fall through to the oracle
        esc_k, esc_a = self._escalation_budget()
        esc_slots = {}
        n = len(queries)
        ovf_rows = np.nonzero(overflow[:n] & (tok.lengths[:n] >= 0))[0]
        if len(ovf_rows) and (esc_k > self.k_states
                              or esc_a > self.max_intervals):
            sub = Probes.from_tokenized(
                tok.sub_batch(ovf_rows, _pow2_batch(len(ovf_rows))),
                device=self.device)
            res2 = fused_walk_routes(fl.dev, sub, probe_len=ct.probe_len,
                                     k_states=esc_k, max_intervals=esc_a)
            o2 = _host(res2.overflow)
            slots2, offs2 = expand_intervals(_host(res2.start),
                                             _host(res2.count))
            for j, qi in enumerate(ovf_rows):
                if not o2[j]:
                    esc_slots[int(qi)] = slots2[offs2[j]:offs2[j + 1]]
                    overflow[qi] = False
        # buffer-truncated rows re-expand on host from the (lazily
        # fetched) interval grids — exact, just not pre-bucketed
        slots, offs = pairs.slots, pairs.row_offsets
        trunc_slots = trunc_offs = None
        trunc_map: dict = {}
        need = np.nonzero(pairs.trunc[:n] & ~overflow[:n])[0]
        if len(need):
            g_s, g_c = self._fetch_escalation_grids(pairs.res)
            trunc_slots, trunc_offs = expand_intervals(g_s[need], g_c[need])
            trunc_map = {int(qi): j for j, qi in enumerate(need)}
        self.last_expanded = (pairs, fl.peer_tab)
        out: List[MatchedRoutes] = []
        for qi, (tenant_id, levels) in enumerate(queries):
            tomb = fl.tomb.get(tenant_id)
            delta = fl.delta.get(tenant_id)
            if roots[qi] < 0 or overflow[qi] or tok.lengths[qi] < 0:
                # tenant absent from the base snapshot, or the row
                # overflowed even the escalation, or the topic is too deep
                # for the walk shape: exact host oracle
                out.append(self.match_from_tries(
                    [(tenant_id, levels)],
                    max_persistent_fanout=max_persistent_fanout,
                    max_group_fanout=max_group_fanout)[0])
                continue
            if qi in esc_slots:
                row = esc_slots[qi]
            elif qi in trunc_map:
                j = trunc_map[qi]
                row = trunc_slots[trunc_offs[j]:trunc_offs[j + 1]]
            else:
                row = slots[offs[qi]:offs[qi + 1]]
            if not tomb and delta is None:
                # fast path: no overlay for this tenant
                out.append(self._routes_from_slots(
                    ct, row, max_persistent_fanout, max_group_fanout))
                continue
            out.append(self._expand_with_overlay(
                ct, row, tomb or (), delta, _parse_levels(levels),
                max_persistent_fanout, max_group_fanout))
        return out

    def match_from_tries(self, queries: Sequence[Tuple[str, Sequence[str]]],
                         *, max_persistent_fanout: int = UNCAPPED_FANOUT,
                         max_group_fanout: int = UNCAPPED_FANOUT
                         ) -> List[MatchedRoutes]:
        """Match straight from the authoritative host tries — the ONE
        exact-oracle fallback surface."""
        out: List[MatchedRoutes] = []
        for tenant_id, levels in queries:
            trie = self.tries.get(tenant_id)
            out.append(trie.match(
                _parse_levels(levels),
                max_persistent_fanout=max_persistent_fanout,
                max_group_fanout=max_group_fanout)
                if trie is not None else MatchedRoutes())
        return out

    @staticmethod
    def _routes_from_slots(ct: CompiledTrie, row: np.ndarray,
                           max_persistent_fanout: int,
                           max_group_fanout: int) -> MatchedRoutes:
        """Slot ids → MatchedRoutes, caps applied vectorized
        (MatchedRoutes.java:38 rules): kind masks + cumsum ranks instead
        of a Python loop over slots."""
        out = MatchedRoutes()
        if row.size == 0:
            return out
        kinds = ct.slot_kind[row]
        pers_mask = kinds == CompiledTrie.SLOT_PERSISTENT
        if (max_persistent_fanout != UNCAPPED_FANOUT
                and int(pers_mask.sum()) > max_persistent_fanout):
            out.max_persistent_fanout_exceeded = True
            drop = pers_mask & (np.cumsum(pers_mask)
                                > max_persistent_fanout)
            row, kinds, pers_mask = (row[~drop], kinds[~drop],
                                     pers_mask[~drop])
        out.persistent_fanout = int(pers_mask.sum())
        grp_mask = kinds == CompiledTrie.SLOT_GROUP
        arr = ct.matchings_arr
        if grp_mask.any():
            grp_slots = row[grp_mask]
            if (max_group_fanout != UNCAPPED_FANOUT
                    and grp_slots.size > max_group_fanout):
                out.max_group_fanout_exceeded = True
                grp_slots = grp_slots[:max_group_fanout]
            for m in arr[grp_slots]:
                out.groups[m.mqtt_topic_filter] = list(m.members)
            out.normal = arr[row[~grp_mask]].tolist()
        else:
            out.normal = arr[row].tolist()
        return out

    def _expand_with_overlay(self, ct: CompiledTrie, slots: np.ndarray,
                             tomb, delta: Optional[SubscriptionTrie],
                             levels: List[str],
                             max_persistent_fanout: int,
                             max_group_fanout: int) -> MatchedRoutes:
        """Base expansion ⊖ tombstones ⊕ delta matches, then caps."""
        normal: List[Route] = []
        groups: Dict[str, List[Route]] = {}
        for slot in (int(s) for s in slots):
            m: Matching = ct.matchings[slot]
            if isinstance(m, GroupMatching):
                members = [r for r in m.members
                           if (m.mqtt_topic_filter, r.receiver_url)
                           not in tomb]
                if members:
                    groups[m.mqtt_topic_filter] = members
            elif (m.matcher.mqtt_topic_filter, m.receiver_url) not in tomb:
                normal.append(m)
        if delta is not None:
            dm = delta.match(levels)
            normal.extend(dm.normal)
            for f, members in dm.groups.items():
                groups.setdefault(f, []).extend(members)
        # caps over the merged set (MatchedRoutes.java:38 rules)
        out = MatchedRoutes()
        for r in normal:
            if r.broker_id == PERSISTENT_SUB_BROKER_ID:
                if out.persistent_fanout >= max_persistent_fanout:
                    out.max_persistent_fanout_exceeded = True
                    continue
                out.persistent_fanout += 1
            out.normal.append(r)
        for f, members in groups.items():
            if len(out.groups) >= max_group_fanout:
                out.max_group_fanout_exceeded = True
                continue
            out.groups[f] = members
        return out
