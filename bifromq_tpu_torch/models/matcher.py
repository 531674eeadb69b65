"""TorchMatcher: the match plane — compile, walk and expand on the card.

Port of ``bifromq_tpu/models/matcher.TpuMatcher``'s serving legs: the
sync ``match_batch`` and the pipelined, failure-bounded
``match_batch_async``.
Authoritative subscription state lives in host-side per-tenant tries;
a compiled automaton snapshot serves batched match queries on the device
through three kernels — the BLAKE2b level hash, the fused interval walk
and the fan-out expansion — and topics that exceed the fixed-shape walk
fall back to the exact host oracle.

Query side: ``match_batch`` is a **match-result cache** front end
(``models/matchcache.TenantMatchCache``, on by default): a repeated
(tenant, topic) is a dict probe, N identical rows of a batch walk once,
and only the unique misses reach the device (``_match_batch_device``).

Mutation → visibility:

- Every mutation applies to the authoritative tries instantly and then
  **patches the base in place** (``PatchableTrie``): new nodes, edges and
  route slots land in the host arenas, removed routes become dead slots,
  and the dirty rows ship to the device tables as narrow row writes
  before the next walk (``_flush_patches``). No recompile.
- An op the patcher declines (no base yet, a hash collision among
  patch-era edges, a group add without members) lands in a small **delta
  overlay** — per-tenant delta tries for adds plus a tombstone set for
  removes/supersedes — and serving corrects the base expansion with it.
- A background **compaction** builds a fresh base: the mutation log
  replays onto a shadow copy of the tries, the shadow compiles
  off-thread, and the serving thread swaps the new tables in and folds
  the log suffix in as patches. It runs when the overlay reaches
  ``compact_threshold`` ops or when dead and relocated slots fragment
  the arena (``PatchableTrie.frag_pending``).

Serving legs: ``match_batch`` prepares, dispatches, waits on the
result's readiness and fetches back to back; ``match_batch_async`` runs
the same stages through the bounded dispatch ring
(``models/pipeline.DispatchRing``), awaiting readiness on the event loop
so batch N+1 prepares and dispatches while batch N is in flight. A
result's readiness is a CUDA event recorded after its device→host copies
into pinned buffers (``ops/match.HostFetch``); the fetch reads those
buffers. Both legs sit behind the device breaker and the readiness
watchdog (``resilience/device.py``): a hung, failing or lying card
degrades the batch to the exact host oracle, counted, never silently.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..utils import topic as topic_util
from ..utils.device import KernelLaunchError, resolve_device
from ..utils.metrics import STAGES
from ..utils.nativelib import NativeLibError
from ..types import RouteMatcherType
from .automaton import (CompiledTrie, GroupMatching, Matching, PatchableTrie,
                        PatchFallback, TokenCache, compile_tries, tokenize)
from .oracle import (PERSISTENT_SUB_BROKER_ID, UNCAPPED_FANOUT,
                     MatchedRoutes, Route, SubscriptionTrie)

# what the serving legs raise to their caller instead of serving the host
# oracle: a kernel that refused to launch, a native host helper that
# failed to build or load and a wrapper's argument check are faults of
# the program, and degrading around them would hide them
_PROGRAM_FAULTS = (KernelLaunchError, NativeLibError, ValueError)


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


def _query_key(levels):
    """Cache/dedup key of a query's topic half: the raw string (or wire
    bytes) is its own key; level lists keep the tuple form."""
    if isinstance(levels, (str, bytes)):
        return levels
    return tuple(levels)


# tombstone key: (full mqtt topic filter incl. any share prefix, receiver_url)
_TombKey = Tuple[str, Tuple[int, str, str]]


class _Prepared:
    """Stage-0 output: a tokenized + uploaded probe batch, with the base
    snapshot it tokenized against and the seconds the prep took."""

    __slots__ = ("queries", "ct", "tok", "probes", "roots", "batch",
                 "tokenize_s")

    def __init__(self, **kw) -> None:
        for k, v in kw.items():
            setattr(self, k, v)


class _InFlight:
    """Captured dispatch state for one device batch: expansion runs
    against the SNAPSHOT the walk dispatched on (base tables and overlay
    dict objects), never a base a compaction swapped in meanwhile. With
    batches in flight, a patch flush writes new table tensors
    (``_flush_patches``), so ``dev`` stays the tables this batch was
    dispatched on, for its escalation re-walk too."""

    __slots__ = ("queries", "ct", "dev", "tok", "roots", "res", "tomb",
                 "delta", "batch", "peer_tab", "fault")

    def __init__(self, **kw) -> None:
        self.fault = None   # a fired device FaultRule (the chaos hook)
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


def _canon(m: MatchedRoutes):
    """Row identity for the canary's parity check: receivers and groups."""
    return (sorted((r.matcher.mqtt_topic_filter, r.receiver_url)
                   for r in m.normal),
            {f: sorted(r.receiver_url for r in ms)
             for f, ms in m.groups.items()})


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


def _safe_hook(cb, what: str, *args) -> None:
    """Fire an optional observer hook without letting it poison the
    mutation/install path (the dist coproc's apply-stream outlet)."""
    if cb is None:
        return
    try:
        cb(*args)
    except Exception:  # noqa: BLE001 — observers must not break serving
        logging.getLogger(__name__).exception("%s hook failed", what)


class TorchMatcher:
    # the pipelined leg (match_batch_async) drives _dispatch_prepared
    # directly; a subclass replacing the whole device plane (the mesh)
    # turns this off and the async entry takes its sync leg
    supports_async = True
    # single-table bases are PatchableTrie and mutations fold into the
    # arenas in place; a subclass whose compile target is not one
    # CompiledTrie (the mesh's stacked shards) turns this off and keeps
    # the overlay + compaction path
    supports_patching = True

    def __init__(self, *, max_levels: int = 16, k_states: int = 32,
                 probe_len: int = 16, device=None,
                 auto_compact: bool = True,
                 compact_threshold: int = 2048,
                 max_intervals: int = 32,
                 match_cache: bool = True) -> None:
        self.max_levels = max_levels
        self.k_states = k_states
        self.probe_len = probe_len
        self.max_intervals = max_intervals
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            from ..ops.tokenize import BLAKE2B
            from ..utils.device import build_all
            from ..ops.match import _expand_lib
            from .kernels import EXPAND, FUSED_WALK, WALK_PROBE_LENS
            from .native_tok import load_lib
            if probe_len not in WALK_PROBE_LENS:
                raise ValueError(f"the walk kernel has no bucket width "
                                 f"{probe_len}; have {WALK_PROBE_LENS}")
            # the serving path's kernels and native host helpers load
            # here, so a build or load failure raises before any batch is
            # served and can never reach the device leg's
            # degrade-to-oracle boundary
            build_all([BLAKE2B, FUSED_WALK, EXPAND])
            load_lib()
            _expand_lib()
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
        # the match-result cache front end: filter-aware invalidation in
        # add/remove_route, a generation bump on a salt change
        from .matchcache import TenantMatchCache
        self.match_cache = (TenantMatchCache(scope="matcher")
                            if match_cache else None)
        # the async dispatch ring, made at the first async match (see
        # models/pipeline.py for the knobs)
        self._ring = None
        # the device circuit breaker, fed by device timeouts and errors:
        # open serves the exact host oracle with no dispatch at all,
        # half-open admits ONE canary batch that re-closes only on row
        # parity with the oracle
        from ..resilience.device import (DEVICE_BREAKERS,
                                         device_breaker_enabled)
        self.device_breaker = (DEVICE_BREAKERS.create()
                               if device_breaker_enabled() else None)
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
        # patch-plane accounting: mutations folded into the base in place,
        # ops the patcher declined (overlaid), device flushes (and those
        # that wrote new tensors because a batch was in flight) and the
        # cumulative host (plan + arena) and device-write seconds
        self.patch_count = 0
        self.patch_fallbacks = 0
        self.patch_flushes = 0
        self.patch_flushes_undonated = 0
        self.patch_host_s = 0.0
        self.patch_device_s = 0.0

    def clone_empty(self) -> "TorchMatcher":
        """A fresh matcher with the same configuration on the same
        device — the dist coproc's reset-from-KV rebuild target."""
        return type(self)(**self._clone_kwargs())

    def _clone_kwargs(self) -> dict:
        """The constructor knobs ``clone_empty`` carries over."""
        return dict(max_levels=self.max_levels, k_states=self.k_states,
                    probe_len=self.probe_len, device=self.device,
                    auto_compact=self.auto_compact,
                    compact_threshold=self.compact_threshold,
                    max_intervals=self.max_intervals,
                    match_cache=self.match_cache is not None)

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
        self._fold_op(op)
        if self.match_cache is not None:
            # exact filters evict one topic key, wildcard filters bump
            # the tenant epoch
            self.match_cache.invalidate(tenant_id,
                                        route.matcher.filter_levels)
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
        self._fold_op(op)
        if self.match_cache is not None:
            self.match_cache.invalidate(tenant_id, matcher.filter_levels)
        self._maybe_compact()
        return True

    # ---------------- in-place patching ------------------------------------

    def _fold_op(self, op: Tuple) -> None:
        """Patch-first fold of one log op; an op the patcher declines is
        served from the delta overlay until the next compaction folds it
        in."""
        if not self._try_patch(op):
            self._overlay_record(op)

    def _group_members(self, tenant_id: str, matcher) -> dict:
        """The authoritative surviving member set for a shared-group op —
        the patcher replaces the whole GroupMatching slot with it (group
        member churn is a host-side object swap, zero device traffic)."""
        trie = self.tries.get(tenant_id)
        node = trie._root if trie is not None else None
        for level in matcher.filter_levels:
            if node is None:
                return {}
            node = node.children.get(level)
        if node is None:
            return {}
        gkey = (int(matcher.type), matcher.group or "")
        return dict(node.groups.get(gkey, {}))

    def _patch_targets(self, tenant_id: str) -> list:
        """The PatchableTrie arena(s) a mutation for this tenant folds
        into: the single-table base itself. Empty when there is nothing
        to patch (no base yet, or a non-patchable compile target)."""
        base = self._base_ct
        if not self.supports_patching or not isinstance(base,
                                                        PatchableTrie):
            return []
        return [base]

    def _try_patch(self, op: Tuple) -> bool:
        """Fold one log op straight into the installed base arenas.

        Returns False when there is nothing to patch or the patcher
        declined (``PatchFallback``) — the caller then records the op
        into the overlay. The patch methods are find-or-append
        idempotent, so a fold that declines mid-way is safe: the overlay
        record supersedes the partially patched copy like a base copy.
        """
        targets = self._patch_targets(op[1])
        if not targets:
            return False
        t0 = time.perf_counter()
        try:
            if op[0] == "add":
                _, tenant_id, route = op
                gm = None
                if route.matcher.type != RouteMatcherType.NORMAL:
                    gm = self._group_members(tenant_id, route.matcher)
                for base in targets:
                    base.patch_add(tenant_id, route, group_members=gm)
            else:
                _, tenant_id, matcher, url, _inc = op
                gm = None
                if matcher.type != RouteMatcherType.NORMAL:
                    gm = self._group_members(tenant_id, matcher)
                for base in targets:
                    base.patch_remove(tenant_id, matcher, url,
                                      group_members=gm)
        except PatchFallback:
            self.patch_fallbacks += 1
            return False
        self.patch_count += 1
        self.patch_host_s += time.perf_counter() - t0
        return True

    def _flush_patches(self, own_slots: int = 0) -> None:
        """Ship the host patches accumulated since the last flush to the
        device tables as narrow row writes (coalesced: at most one flush
        per dispatch, however many mutations landed since).

        The writes go into the serving tables in place (``donate``) only
        while no dispatched batch can still read them: no ring slot in
        flight beyond ``own_slots`` (the slots the CALLER holds — the
        async leg acquires before dispatching, so its own not-yet-
        dispatched slot counts in ``in_flight`` but reads nothing yet)
        and an empty quarantine (timed-out or cancelled batches park
        there while the card may still run them). Otherwise the flush
        writes new table tensors, so a batch in flight — its escalation
        re-walk included, which runs after the fetch and after this
        flush on the stream — keeps the tables it was dispatched on.
        Only the serving thread flushes, always before its own
        dispatch."""
        base = self._base_ct
        if not isinstance(base, PatchableTrie) or not base.dirty \
                or self._device_trie is None:
            return
        from ..ops.match import patch_device_trie
        ring = self._ring
        donate = ring is None or (ring.in_flight <= own_slots
                                  and not len(ring.quarantine))
        t0 = time.perf_counter()
        self._device_trie, _ = patch_device_trie(
            self._device_trie, base, device=self.device, donate=donate)
        self.patch_flushes += 1
        self.patch_flushes_undonated += not donate
        self.patch_device_s += time.perf_counter() - t0

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
        if self.supports_patching:
            # pad the arenas with pow2 growth headroom so the serving
            # base accepts in-place patches
            ct = PatchableTrie(ct)
        dev = DeviceTrie.from_compiled(ct, device=self.device)
        self.compile_time_s += time.perf_counter() - t0
        return ct, dev

    def refresh(self) -> CompiledTrie:
        """Blocking quiesce: every pending mutation lands in the base.

        When the base is patchable and every pending log op was already
        folded in as a patch (the overlay is empty), quiesce is just a
        shadow sync + device flush — no rebuild."""
        self.drain()
        if self._base_ct is None:
            self._replay_log_into_shadow()
            self._install_base(*self._compile_shadow())
        elif self._log:
            self._replay_log_into_shadow()
            if self._overlay_n or not self._base_patchable():
                self._install_base(*self._compile_shadow())
        self._flush_patches()
        return self._base_ct

    def _base_patchable(self) -> bool:
        """Is the installed base exact under the patch-first path (so a
        quiesce needs no rebuild)?"""
        return isinstance(self._base_ct, PatchableTrie)

    @staticmethod
    def _base_salt(ct) -> object:
        """Salt fingerprint of a base snapshot — the single-table
        CompiledTrie's salt, or the mesh ShardedTables' per-shard salts."""
        salt = getattr(ct, "salt", None)
        if salt is not None:
            return salt
        shards = getattr(ct, "compiled", None)
        if shards is not None:
            return tuple(getattr(s, "salt", None) for s in shards)
        return None

    def _install_base(self, ct: CompiledTrie, dev) -> None:
        prev = self._base_ct
        self._base_ct = ct
        self._device_trie = dev
        # mutations not in this base = the log suffix: fold them in as
        # PATCHES on the fresh arenas (find-or-append idempotent, so an op
        # that raced the compile snapshot is safe to replay); only ops the
        # patcher declines land in the overlay. Dirty rows flush on the
        # next dispatch.
        self._delta = {}
        self._tomb = {}
        self._overlay_n = 0
        for op in self._log:
            self._fold_op(op)
        # a same-salt compaction gives an automaton equivalent to base ⊕
        # overlay, so every cached result stays exact (each mutation
        # invalidated its keys when it was applied); only the first
        # install or a salt change (hash-collision recompile) bumps the
        # cache generation
        if self.match_cache is not None and (
                prev is None or self._base_salt(prev) != self._base_salt(ct)):
            self.match_cache.bump_all()

    def _patch_frag_pending(self) -> bool:
        """Compaction trigger of the patch path: dead + garbage slots
        crossed the fragmentation threshold. Pure adds never fragment."""
        base = self._base_ct
        return isinstance(base, PatchableTrie) and base.frag_pending()

    def _maybe_compact(self, force: bool = False) -> None:
        # trigger on the FIRST mutation too (base is None): the first base
        # builds in the background so the first publish finds it ready.
        # With patch-first mutations the overlay stays empty and the
        # threshold trigger goes quiet; fragmentation triggers instead.
        # ``force`` recompiles regardless.
        frag = self.auto_compact and self._patch_frag_pending()
        if (self._compact_thread is not None
                or (not force and not frag
                    and (not self.auto_compact
                         or (self._base_ct is not None
                             and self._overlay_n < self.compact_threshold)))):
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
                    batch: Optional[int] = None,
                    stats: Optional[dict] = None) -> List[MatchedRoutes]:
        """Match (tenant_id, topic) pairs; returns per-query routes.

        The cache front end: a per-query cache probe, then in-batch
        dedup, so N identical (tenant, topic) rows walk once and only the
        unique misses reach ``_match_batch_device``. Cached and fanned-out
        results are shared objects: callers treat them as read-only.
        ``stats["degraded"]`` names the reason when the device leg served
        the batch from the host oracle.
        """
        if not queries:
            return []
        cache = self.match_cache
        if cache is None:
            return self._match_batch_device(
                queries, max_persistent_fanout=max_persistent_fanout,
                max_group_fanout=max_group_fanout, batch=batch, stats=stats)
        # fold any finished background compaction in BEFORE probing: its
        # generation bump must land before this batch's token snapshots
        self._apply_pending_swap()
        caps = (max_persistent_fanout, max_group_fanout)
        out, uniq, uniq_queries, miss_rows, tokens = \
            self._frontend_probe(queries, caps)
        if uniq_queries:
            res = self._match_batch_device(
                uniq_queries, max_persistent_fanout=max_persistent_fanout,
                max_group_fanout=max_group_fanout, batch=batch, stats=stats)
            self._frontend_fill(out, res, uniq, miss_rows, tokens, caps)
        self._frontend_metrics(len(queries), uniq_queries, miss_rows)
        return out

    def _frontend_probe(self, queries, caps):
        """Cache probe + in-batch dedup: returns (out, uniq, uniq_queries,
        miss_rows, tokens) where ``out`` holds the hits and ``tokens``
        the invalidation snapshots, taken BEFORE any walk is issued so a
        mutation landing mid-match defeats the store."""
        cache = self.match_cache
        out: List[Optional[MatchedRoutes]] = [None] * len(queries)
        uniq: Dict[Tuple[str, object], int] = {}
        uniq_queries: List[Tuple[str, Sequence[str]]] = []
        miss_rows: List[Tuple[int, int]] = []   # (query idx, unique pos)
        for qi, (tenant_id, levels) in enumerate(queries):
            key = _query_key(levels)
            m = cache.get(tenant_id, key, caps)
            if m is not None:
                out[qi] = m
                continue
            uk = (tenant_id, key)
            pos = uniq.get(uk)
            if pos is None:
                pos = uniq[uk] = len(uniq_queries)
                uniq_queries.append((tenant_id, levels))
            miss_rows.append((qi, pos))
        tokens = ({t: cache.token(t) for t in {q[0] for q in uniq_queries}}
                  if uniq_queries else {})
        return out, uniq, uniq_queries, miss_rows, tokens

    def _frontend_fill(self, out, res, uniq, miss_rows, tokens, caps):
        cache = self.match_cache
        for (tenant_id, key), pos in uniq.items():
            cache.put(tenant_id, key, caps, res[pos], tokens[tenant_id])
        for qi, pos in miss_rows:
            out[qi] = res[pos]

    def _frontend_metrics(self, n_queries, uniq_queries, miss_rows):
        # global section totals: one locked inc per batch, not per row
        from ..utils.metrics import MATCH_CACHE
        MATCH_CACHE.inc(self.match_cache.scope, "hits",
                        n_queries - len(miss_rows))
        MATCH_CACHE.inc(self.match_cache.scope, "misses", len(miss_rows))
        if uniq_queries:
            MATCH_CACHE.record_dedup(len(uniq_queries),
                                     len(miss_rows) - len(uniq_queries))

    # ---------------- async device pipeline -------------------------------
    # (the reference's trace spans and OBS hooks at the sites below — ring
    # registration, per-batch profiler records, the e2e degraded map — are
    # ROADMAP A.10)

    def _pipeline_ring(self):
        if self._ring is None:
            from .pipeline import DispatchRing
            self._ring = DispatchRing()
            # OBS.device.register_ring: ROADMAP A.10
        return self._ring

    async def drain_device(self, timeout_s: Optional[float] = None) -> bool:
        """Graceful drain: wait bounded for in-flight device batches to
        retire, then sweep the quarantine. Returns whether the ring
        actually went idle."""
        ring = self._ring
        if ring is None:
            return True
        from ..resilience.device import drain_timeout_s
        if timeout_s is None:
            timeout_s = drain_timeout_s()
        idle = await ring.wait_idle(timeout_s)
        ring.quarantine.sweep()
        return idle

    async def match_batch_async(self, queries, *,
                                max_persistent_fanout: int = UNCAPPED_FANOUT,
                                max_group_fanout: int = UNCAPPED_FANOUT,
                                batch: Optional[int] = None,
                                stats: Optional[dict] = None,
                                **device_kw) -> List[MatchedRoutes]:
        """Pipelined serving path: same results as ``match_batch``, but
        the device walk is dispatched through the bounded in-flight ring
        and awaited on READINESS — batch N+1 prepares and enqueues while
        batch N is still walking, and the event loop keeps serving between
        readiness polls instead of blocking inside a synchronize.

        ``stats`` (optional dict) receives ``device_s``: THIS batch's own
        match cost — cache probe + dispatch, ready, fetch + host expansion
        and cache fill — minus the ring-acquire wait (queue time, not
        match cost). ``stats["degraded"]`` carries the reason when the
        batch was served from the host oracle (breaker open, watchdog
        timeout, device error, canary parity).

        Takes the sync path when the pipeline is disabled
        (``BIFROMQ_PIPELINE=0``) or the subclass replaced the device plane
        (``supports_async = False``).
        """
        from .pipeline import pipeline_enabled
        if not queries:
            return []
        if not (self.supports_async and pipeline_enabled()):
            return self.match_batch(
                queries, max_persistent_fanout=max_persistent_fanout,
                max_group_fanout=max_group_fanout, batch=batch,
                stats=stats, **device_kw)
        if device_kw:
            raise TypeError("match_batch_async got unsupported kwargs: "
                            f"{sorted(device_kw)}")
        caps = (max_persistent_fanout, max_group_fanout)
        cache = self.match_cache
        t_front = time.perf_counter()
        if cache is not None:
            self._apply_pending_swap()
            out, uniq, uniq_queries, miss_rows, tokens = \
                self._frontend_probe(queries, caps)
        else:
            out = [None] * len(queries)
            uniq_queries = list(queries)
        front_s = time.perf_counter() - t_front
        if stats is not None:
            # all-hit batches: the cache probe IS the whole match cost
            stats["device_s"] = front_s
        if uniq_queries:
            t_disp = time.perf_counter()
            res, degraded, acquire_s = await self._device_serve_async(
                uniq_queries, batch, max_persistent_fanout,
                max_group_fanout)
            if cache is not None:
                self._frontend_fill(out, res, uniq, miss_rows, tokens,
                                    caps)
            else:
                out = res
            if stats is not None:
                stats["device_s"] = front_s + (
                    time.perf_counter() - t_disp - acquire_s)
                if degraded is not None:
                    stats["degraded"] = degraded
        if cache is not None:
            self._frontend_metrics(len(queries), uniq_queries, miss_rows)
        return out

    async def _device_serve_async(self, uniq_queries, batch,
                                  max_persistent_fanout, max_group_fanout):
        """The failure-bounded device leg of the async path.

        Returns ``(results, degraded_reason, acquire_s)`` —
        ``degraded_reason`` is None when the device served, else one of
        ``breaker`` (circuit open: dispatch skipped entirely), ``timeout``
        (watchdog fired: the ring slot was reclaimed, the orphaned result
        quarantined), ``device_error`` (dispatch or fetch raised) or
        ``canary_parity`` (the half-open canary's rows differed from the
        oracle's); ``acquire_s`` is the ring-acquire wait the caller
        subtracts from its device-time accounting. Every degraded serve
        comes from ``match_from_tries`` — the authoritative host oracle,
        exact by construction — and counts in ``FABRIC``
        ``MATCH_DEGRADED``. The kernels are loaded when the matcher is
        made, so a kernel that fails to build never reaches this
        boundary."""
        from ..resilience.device import DeviceTimeoutError
        from ..utils.metrics import FABRIC, FabricMetric
        br = self.device_breaker
        verdict = br.admit() if br is not None else "ok"
        reason = None
        oracle_rows = None
        timing = {"acquire_s": 0.0}
        if verdict == "rejected":
            reason = "breaker"
        else:
            settled = False
            try:
                res = await self._device_leg_async(
                    uniq_queries, batch, max_persistent_fanout,
                    max_group_fanout, timing)
                oracle_rows = self._settle_breaker(
                    verdict, uniq_queries, res, max_persistent_fanout,
                    max_group_fanout)
                settled = True
                if oracle_rows is None:
                    return res, None, timing["acquire_s"]
                reason = "canary_parity"
            except DeviceTimeoutError as e:
                FABRIC.inc(FabricMetric.DEVICE_TIMEOUT)
                if br is not None:
                    br.record_failure(repr(e))
                    settled = True
                reason = "timeout"
            except (asyncio.CancelledError, *_PROGRAM_FAULTS):
                raise
            except Exception as e:  # noqa: BLE001 — degrade, don't fail
                if br is not None:
                    br.record_failure(repr(e))
                    settled = True
                logging.getLogger(__name__).warning(
                    "device match failed; serving host oracle: %r", e)
                reason = "device_error"
            finally:
                if br is not None and verdict == "canary" and not settled:
                    # cancelled (or a program fault) mid-probe with no
                    # verdict: the half-open budget must not leak or the
                    # breaker wedges refusing
                    br.release_probe()
        FABRIC.inc(FabricMetric.MATCH_DEGRADED, len(uniq_queries))
        # OBS.profiler.record_batch and the "match.degraded" span: A.10
        if oracle_rows is None:
            oracle_rows = self.match_from_tries(
                uniq_queries, max_persistent_fanout=max_persistent_fanout,
                max_group_fanout=max_group_fanout)
        return oracle_rows, reason, timing["acquire_s"]

    def _settle_breaker(self, verdict, queries, rows,
                        max_persistent_fanout, max_group_fanout):
        """Feed the device breaker a batch the card served, on either
        leg. A half-open canary must match the host oracle row for row
        (``_canary_parity``); an "ok"-admitted batch completing while the
        breaker is no longer closed is a pre-trip straggler, whose success
        must not close the circuit past the canary's parity bar. Returns
        the oracle rows when the canary failed parity, else None."""
        br = self.device_breaker
        if br is None:
            return None
        if verdict == "canary":
            ok, oracle_rows = self._canary_parity(
                queries, rows, max_persistent_fanout, max_group_fanout)
            if ok:
                br.record_success()
                return None
            br.record_failure("canary row parity")
            return oracle_rows
        if br.state == "closed":
            br.record_success()
        return None

    async def _device_leg_async(self, uniq_queries, batch,
                                max_persistent_fanout, max_group_fanout,
                                timing=None):
        """dispatch → fetch-on-ready → expand through the bounded ring,
        with the watchdog armed on the readiness wait. A timeout RECLAIMS
        the slot: the ring releases it at once (the next batch keeps
        flowing) and the orphaned result — device tensors and pinned
        buffers the card may still be writing — goes to quarantine until
        its event completes. ``timing["acquire_s"]`` reports the
        ring-acquire wait (queue time, not match cost) even when the leg
        later raises."""
        from ..resilience.device import DeviceTimeoutError
        ring = self._pipeline_ring()
        # stage-1 prep (hash + probe upload) runs BEFORE ring admission:
        # batch N+1 prepares while batch N is still walking, and a full
        # ring stalls only the enqueue. Prep tickets (depth + 1) bound the
        # probe batches resident on the card. The dispatch half re-preps
        # iff a compaction swapped the base during the admission wait.
        t_acq = time.perf_counter()
        await ring.acquire_prep()
        try:
            if batch is None:
                # queue-depth-adaptive pow2 floor: idle ring ⇒ small pad
                # to cut time-to-first-result, busy ring ⇒ the
                # throughput floor
                batch = _pow2_batch(len(uniq_queries),
                                    floor=ring.planned_floor())
            prep = self._prepare_probes(uniq_queries, batch)
            await ring.acquire()
            if timing is not None:
                # queue time: prep-ticket wait + slot wait, minus the
                # prep work itself (match cost, in the tokenize stage)
                timing["acquire_s"] = max(
                    0.0, time.perf_counter() - t_acq - prep.tokenize_s)
            try:
                fl = self._dispatch_prepared(prep, donate=True,
                                             watchdogged=True)
                ring.start_fetch(fl.res)
                t0 = time.perf_counter()
                try:
                    await ring.wait_ready(fl.res, fault=fl.fault)
                except DeviceTimeoutError:
                    ring.reclaim(fl.res)
                    # OBS.e2e.set_degraded: ROADMAP A.10
                    raise
                except BaseException:
                    # cancelled mid-wait (caller timeout, client
                    # disconnect): the result may still be in flight —
                    # park it like a timeout does, minus the timeout
                    # accounting
                    ring.quarantine.add(fl.res)
                    raise
                STAGES.record("device.ready", time.perf_counter() - t0)
                # OBS.e2e.clear_degraded: ROADMAP A.10
            finally:
                ring.release()
        finally:
            # held for the WHOLE slot tenure: tickets bound prepped +
            # in-flight batches together at depth + 1
            ring.release_prep()
        t0 = time.perf_counter()
        overflow, pairs = self._fetch_walk(fl.res)
        STAGES.record("device.fetch", time.perf_counter() - t0)
        # OBS.profiler.record_batch: ROADMAP A.10
        return self._expand_walk(fl, overflow, pairs, max_persistent_fanout,
                                 max_group_fanout)

    def _canary_parity(self, queries, device_rows,
                       max_persistent_fanout, max_group_fanout):
        """Half-open success bar: the canary batch's device rows must be
        row-identical to the host oracle (receivers + groups per row) —
        a card that returns plausible-but-wrong rows after a fault must
        NOT re-close the breaker. Returns ``(ok, oracle_rows)`` so a
        failed parity check serves the oracle rows already computed."""
        oracle = self.match_from_tries(
            queries, max_persistent_fanout=max_persistent_fanout,
            max_group_fanout=max_group_fanout)
        return all(_canon(d) == _canon(o)
                   for d, o in zip(device_rows, oracle)), oracle

    def _match_batch_device(self, queries: Sequence[Tuple[str,
                                                          Sequence[str]]],
                            *, max_persistent_fanout: int = UNCAPPED_FANOUT,
                            max_group_fanout: int = UNCAPPED_FANOUT,
                            batch: Optional[int] = None,
                            stats: Optional[dict] = None
                            ) -> List[MatchedRoutes]:
        """Match (tenant_id, topic) pairs on the device: the sync leg.

        Exact at every instant: patched base walk ⊕ overlay ⊖ tombstones
        equals a match against the authoritative tries. Prepare, dispatch
        (hash + walk + expand on the device), a readiness wait, the fetch
        and the host expansion run back to back.

        The device breaker gates this leg too: open serves the host oracle
        with no dispatch; a device error feeds the breaker and then
        PROPAGATES (the caller owns the sync fallback); a half-open
        admission holds the canary batch to oracle row parity. The
        readiness wait short-polls the result's event under the watchdog
        deadline, and a hung card degrades THIS caller to the exact host
        oracle (breaker fed, ``MATCH_DEGRADED`` counted).
        """
        if not queries:
            return []
        from ..resilience.device import DeviceTimeoutError
        from ..utils.metrics import FABRIC, FabricMetric
        br = self.device_breaker
        verdict = br.admit() if br is not None else "ok"
        if verdict == "rejected":
            FABRIC.inc(FabricMetric.MATCH_DEGRADED, len(queries))
            if stats is not None:
                stats["degraded"] = "breaker"
            return self.match_from_tries(
                queries, max_persistent_fanout=max_persistent_fanout,
                max_group_fanout=max_group_fanout)
        try:
            fl = self._dispatch_prepared(self._prepare_probes(queries, batch))
            self._await_ready_sync(fl.res)
            t0 = time.perf_counter()
            overflow, pairs = self._fetch_walk(fl.res)
            STAGES.record("device.fetch", time.perf_counter() - t0)
            out = self._expand_walk(fl, overflow, pairs,
                                    max_persistent_fanout, max_group_fanout)
        except DeviceTimeoutError as e:
            # the watchdog fired on the sync leg: the orphaned result is
            # dropped (no ring, nothing dispatched after it reads it), the
            # breaker is fed, and this caller serves the exact host oracle
            FABRIC.inc(FabricMetric.DEVICE_TIMEOUT)
            FABRIC.inc(FabricMetric.MATCH_DEGRADED, len(queries))
            if br is not None:
                br.record_failure(repr(e))
            if stats is not None:
                stats["degraded"] = "timeout"
            return self.match_from_tries(
                queries, max_persistent_fanout=max_persistent_fanout,
                max_group_fanout=max_group_fanout)
        except BaseException as e:
            if br is not None:
                if (isinstance(e, Exception)
                        and not isinstance(e, _PROGRAM_FAULTS)):
                    br.record_failure(repr(e))
                elif verdict == "canary":
                    br.release_probe()
            raise
        oracle_rows = self._settle_breaker(
            verdict, queries, out, max_persistent_fanout, max_group_fanout)
        if oracle_rows is not None:
            FABRIC.inc(FabricMetric.MATCH_DEGRADED, len(queries))
            if stats is not None:
                stats["degraded"] = "canary_parity"
            return oracle_rows
        return out

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
        t0 = time.perf_counter()
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
        tokenize_s = time.perf_counter() - t0
        STAGES.record("tokenize", tokenize_s)
        return _Prepared(queries=list(queries), ct=ct, tok=tok,
                         probes=probes, roots=roots, batch=batch,
                         tokenize_s=tokenize_s)

    def _dispatch_prepared(self, prep: _Prepared, *, donate: bool = False,
                           watchdogged: bool = False) -> _InFlight:
        """Stage 1: enqueue the walk and the fan-out expansion for a
        prepared probe batch; returns once both are enqueued.

        ``donate`` is the reference's request to let XLA reuse the probe
        buffers for the results. The port's kernels read the probes and
        write fresh result tensors, so it changes nothing here; it stays
        so the call sites match the reference's. ``watchdogged`` marks
        the async leg: its device-fault rules (hang, slow, flaky_ready)
        ride the _InFlight into the readiness wait, while the sync leg
        honors only error rules; it also holds its own (not yet
        dispatched) ring slot while it flushes."""
        from ..ops.match import expand_cap_lanes, expand_routes
        from ..resilience.faults import get_injector
        if watchdogged:
            fault = get_injector().device_rule("dispatch")
        else:
            get_injector().check_raise("device", "tpu-device", "dispatch")
            fault = None
        if self._base_ct is not prep.ct:
            # a compaction swap landed between prep and dispatch: roots
            # and salt are per-snapshot, so re-prep against the new base
            prep = self._prepare_probes(prep.queries, prep.batch)
        # ship the host patches accumulated since the last dispatch (one
        # coalesced narrow write), so this batch walks the post-mutation
        # tables
        self._flush_patches(own_slots=1 if watchdogged else 0)
        ct = prep.ct
        t0 = time.perf_counter()
        res = self._walk_primary(prep.probes, ct)
        STAGES.record("device.dispatch", time.perf_counter() - t0)
        t0 = time.perf_counter()
        peer_tab, slot_peer = self._peer_table(ct)
        res = expand_routes(res, slot_peer,
                            cap=prep.batch * expand_cap_lanes(),
                            n_peers=peer_tab.n_peers)
        STAGES.record("device.expand", time.perf_counter() - t0)
        return _InFlight(queries=prep.queries, ct=ct,
                         dev=self._device_trie, tok=prep.tok,
                         roots=prep.roots, res=res, tomb=self._tomb,
                         delta=self._delta, batch=prep.batch,
                         peer_tab=peer_tab, fault=fault)

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
    def _await_ready_sync(res) -> None:
        """The sync leg's pre-fetch readiness wait: the async watchdog's
        own poll (``pipeline.ready_polls``) slept on this thread, under
        the same ``BIFROMQ_DEVICE_DEADLINE_S`` deadline — a hung card
        degrades the SYNC caller to the oracle instead of wedging it
        inside a synchronize. Recorded as ``device.ready``, the stage the
        watchdog's derived deadline reads."""
        from .pipeline import ready_polls
        t0 = time.perf_counter()
        for pause in ready_polls(res):
            if pause:
                time.sleep(pause)
        STAGES.record("device.ready", time.perf_counter() - t0)

    @staticmethod
    def _fetch_walk(res):
        """Stage 2: host arrays of the compact pair buffers — on the card
        read from the pinned copies the result's fetch enqueued (waiting
        on its event if it has not completed), on the CPU plain copies.
        The interval grids come in the same copies and are read only for
        buffer-truncated rows (``_fetch_escalation_grids``). The fetch-side device-fault hook fires
        here (error rules only)."""
        from ..resilience.faults import get_injector
        get_injector().check_raise("device", "tpu-device", "fetch")
        a = res.host_fetch().arrays()
        # writable: the escalation clears the rows it rescues
        overflow = a["overflow"].copy()
        pairs = _HostPairs(
            slots=a["slots"], rows=a["rows"], row_offsets=a["row_offsets"],
            n_pairs=int(a["n_pairs"]), trunc=a["trunc"],
            peer_slots=a["peer_slots"], peer_rows=a["peer_rows"],
            peer_offsets=a["peer_offsets"], res=res)
        return overflow, pairs

    @staticmethod
    def _fetch_escalation_grids(res):
        """Slow-path grid readback: only buffer-truncated rows ever need
        the interval grids on the host. A result with a fetch set reads
        them from the pinned copies queued with its pair buffers, so the
        read waits for this batch alone, not for the batches dispatched
        after it."""
        fetch = getattr(res, "host_fetch", None)
        if fetch is None:
            return _host(res.start), _host(res.count)
        a = fetch().arrays()
        return a["start"], a["count"]

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
        # tombstoned slots ride their interval until compaction reclaims
        # them: the walk emits them, this is where they die
        dead = kinds == CompiledTrie.SLOT_DEAD
        if dead.any():
            row, kinds = row[~dead], kinds[~dead]
            if row.size == 0:
                return out
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
        kind_arr = ct.slot_kind
        for slot in (int(s) for s in slots):
            if kind_arr[slot] == CompiledTrie.SLOT_DEAD:
                continue    # a patch-tombstoned base slot
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
