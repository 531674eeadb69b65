"""Match-result cache plane (copy of ``bifromq_tpu/models/matchcache.py``
without the injectable metrics section and the digest's ``hot_keys``,
which only the reference's gossip uses).

The reference broker fronts its trie walk with a ``TenantRouteCache`` /
``SubscriptionCache`` (bifromq-dist-worker .../cache/TenantRouteCache.java:65)
on the bet that publish topics repeat: a repeated (tenant, topic) never
re-matches. This module is that plane — a per-tenant LRU of expanded
``MatchedRoutes`` keyed by topic, consulted *before* any tokenization,
padding, or device dispatch.

Invalidation is **filter-aware**, mirroring the reference's
refresh-on-mutation contract (TenantRouteCache.java:100-160):

- an **exact** filter (no ``+``/``#`` level) can only change the match
  result of the one topic equal to its levels → evict just that topic key;
- a **wildcard** filter intersects an unbounded topic set → bump the
  tenant's epoch (O(1) wholesale invalidation; stale entries die lazily);
- a salt change (hash-collision recompile) or the first base install
  bumps a global generation → every tenant's entries go stale at once.

Writes racing reads: ``token()`` snapshots the tenant's (generation,
epoch, mutation-seq) *before* the match is issued; ``put`` refuses the
store when any invalidation landed in between, so a mutation during a
match can never be erased by stamping a stale result with the post-bump
state.

Two deployments of the same class:

- ``TorchMatcher`` (scope ``"matcher"``): authoritative per-range cache,
  no TTL — every mutation flows through the owning matcher, so
  epoch/evict invalidation is complete;
- ``DistService`` (scope ``"pub"``): frontend pub-side cache with a TTL
  that bounds staleness from mutations applied on OTHER nodes when the
  worker is remote (the reference's refresh window); with a local worker
  the coproc's apply-stream hook makes invalidation exact there too.

Counters feed the process-global ``utils.metrics.MATCH_CACHE`` section
per scope.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Tuple

from ..utils import topic as topic_util
from ..utils.metrics import MATCH_CACHE

# invalidation token: (generation, tenant epoch, tenant mutation seq)
Token = Tuple[int, int, int]

_WILDCARDS = (topic_util.SINGLE_WILDCARD, topic_util.MULTI_WILDCARD)


def filter_is_wildcard(filter_levels: Sequence[str]) -> bool:
    """True when the filter can match more than one concrete topic."""
    return any(level in _WILDCARDS for level in filter_levels)


class _TenantSlot:
    __slots__ = ("epoch", "seq", "entries")

    def __init__(self, seq0: int) -> None:
        self.epoch = 0
        # every seq value a slot ever holds is a UNIQUE draw from the
        # cache-wide monotone source (creation here, every invalidation
        # below): a slot dropped by the tenant-cardinality bound and later
        # recreated can therefore never alias a token snapshotted against
        # its previous life, no matter how the interleaving goes
        self.seq = seq0
        # topic key -> (generation, epoch, expires, caps, MatchedRoutes);
        # ONE caps variant per topic (caps are per-tenant settings and
        # effectively constant — a caps change is a miss + overwrite),
        # which keeps exact-filter eviction a single dict pop.
        self.entries: Dict[object, Tuple] = {}


class TenantMatchCache:
    """Per-tenant LRU of expanded match results with filter-aware
    invalidation (see module docstring). Topic keys are either parsed
    level tuples, raw topic strings or wire bytes; every form is
    evicted by exact-filter invalidation."""

    def __init__(self, *, scope: str = "matcher",
                 max_topics_per_tenant: int = 8192,
                 max_tenants: int = 4096,
                 max_entries: int = 1 << 16,
                 ttl_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.scope = scope
        self.max_topics_per_tenant = max_topics_per_tenant
        self.max_tenants = max_tenants
        # hard TOTAL bound across all tenants: per-tenant LRU alone would
        # let max_tenants × max_topics_per_tenant MatchedRoutes
        # accumulate; past the bound the oldest-inserted tenant's oldest
        # entries go first
        self.max_entries = max_entries
        self.ttl_s = ttl_s
        self._clock = clock
        self._gen = 0
        self._seq_src = 1
        self._total = 0
        self._slots: Dict[str, _TenantSlot] = {}
        # instance counters; the global section aggregates across
        # instances
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.epoch_bumps = 0

    def __len__(self) -> int:
        return self._total

    # ---------------- lookup ------------------------------------------------

    def _next_seq(self) -> int:
        v = self._seq_src
        self._seq_src += 1
        return v

    def _drop_oldest_slot(self, keep: Optional[str] = None) -> None:
        victim = next(k for k in self._slots if k != keep)
        dropped = self._slots.pop(victim)
        self._total -= len(dropped.entries)
        self._count_evictions(len(dropped.entries))

    def _evict_entry(self, keep: Optional[str] = None) -> bool:
        """Evict ONE entry — the oldest-created other tenant's oldest —
        for the total bound (a whole-slot drop here would be a cliff:
        one insert annihilating another tenant's entire working set).
        Empty token()-materialized slots passed on the way are reaped."""
        empties = []
        victim = None
        for t, s in self._slots.items():
            if t == keep:
                continue
            if not s.entries:
                empties.append(t)
                continue
            victim = t
            break
        for t in empties:
            # safe to reap: nothing cached, and a recreated slot draws a
            # fresh seq so in-flight tokens against it stay refused
            del self._slots[t]
        if victim is None:
            return False
        s = self._slots[victim]
        s.entries.pop(next(iter(s.entries)))
        self._total -= 1
        if not s.entries:
            del self._slots[victim]
        self._count_evictions(1)
        return True

    def _slot(self, tenant: str) -> _TenantSlot:
        s = self._slots.get(tenant)
        if s is None:
            if len(self._slots) >= self.max_tenants:
                # bounded tenant cardinality: drop the oldest-inserted
                # tenant's slot (dict FIFO, the codebase-wide discipline)
                self._drop_oldest_slot()
            s = self._slots.setdefault(tenant,
                                       _TenantSlot(self._next_seq()))
        return s

    def token(self, tenant: str) -> Token:
        """Invalidation snapshot to take BEFORE issuing the match whose
        result will be ``put`` under it. Materializes the tenant's slot so
        a mutation landing mid-flight always has a seq to bump."""
        s = self._slot(tenant)
        return (self._gen, s.epoch, s.seq)

    def get(self, tenant: str, topic_key, caps: Tuple[int, int]):
        """Cached MatchedRoutes for (tenant, topic) under ``caps``, or
        None. Callers treat the returned object as READ-ONLY (the same
        result object fans out to every hit). Hit/miss totals are pushed
        to the global section by the batch-level call sites (one inc per
        batch), not here — a per-row global-lock round-trip would tax the
        very hot path this cache exists to shorten."""
        s = self._slots.get(tenant)
        ent = s.entries.get(topic_key) if s is not None else None
        if ent is not None:
            gen, epoch, expires, ecaps, m = ent
            if (gen == self._gen and epoch == s.epoch and ecaps == caps
                    and (expires is None or self._clock() < expires)):
                # true LRU: refresh recency (dict insertion order)
                del s.entries[topic_key]
                s.entries[topic_key] = ent
                self.hits += 1
                return m
            del s.entries[topic_key]  # stale under any clause: drop now
            self._total -= 1
        self.misses += 1
        return None

    def put(self, tenant: str, topic_key, caps: Tuple[int, int], result,
            token: Token) -> bool:
        """Store a match result under the pre-match ``token``; refused
        (returns False) when any invalidation landed since the snapshot."""
        s = self._slot(tenant)
        if token != (self._gen, s.epoch, s.seq):
            return False
        if topic_key not in s.entries:
            if len(s.entries) >= self.max_topics_per_tenant:
                # amortized sweep: drop the oldest quarter (insertion
                # order ≈ LRU because get() refreshes recency)
                drop = max(1, len(s.entries) // 4)
                for k in list(s.entries)[:drop]:
                    del s.entries[k]
                self._total -= drop
                self._count_evictions(drop)
            while (self._total >= self.max_entries
                   and self._evict_entry(keep=tenant)):
                pass
            if self._total >= self.max_entries and s.entries:
                # this tenant holds the whole budget: its oldest out
                s.entries.pop(next(iter(s.entries)))
                self._total -= 1
                self._count_evictions(1)
            self._total += 1
        expires = (self._clock() + self.ttl_s
                   if self.ttl_s is not None else None)
        s.entries[topic_key] = (self._gen, s.epoch, expires, caps, result)
        return True

    # ---------------- invalidation -----------------------------------------

    def invalidate(self, tenant: str,
                   filter_levels: Sequence[str]) -> None:
        """Filter-aware invalidation for one route mutation: exact filters
        evict just the matching topic keys; wildcard filters bump the
        tenant epoch wholesale."""
        if filter_is_wildcard(filter_levels):
            self.bump(tenant)
            return
        s = self._slots.get(tenant)
        if s is None:
            return
        # fresh draw (never +=1): defeats in-flight puts AND keeps every
        # seq value globally unique (see _TenantSlot)
        s.seq = self._next_seq()
        n = 0
        # all three key forms: parsed level tuple, raw topic string
        # (the string serving path), and raw wire bytes
        joined = topic_util.DELIMITER.join(filter_levels)
        for key in (tuple(filter_levels), joined,
                    joined.encode("utf-8")):
            if s.entries.pop(key, None) is not None:
                n += 1
        if n:
            self._total -= n
            self._count_evictions(n)

    def bump(self, tenant: str) -> None:
        """Wholesale per-tenant invalidation (wildcard mutation, or a
        mutation whose filter is unknown)."""
        s = self._slots.get(tenant)
        if s is None:
            return
        s.epoch += 1
        s.seq = self._next_seq()
        self.epoch_bumps += 1
        MATCH_CACHE.inc(self.scope, "epoch_bumps")

    def bump_all(self) -> None:
        """Global invalidation: base rebuild (overlay compaction / salt
        change) or reset-from-KV — every tenant's entries go stale."""
        self._gen += 1
        self.epoch_bumps += 1
        MATCH_CACHE.inc(self.scope, "epoch_bumps")

    def _count_evictions(self, n: int) -> None:
        self.evictions += n
        MATCH_CACHE.inc(self.scope, "evictions", n)

    # ---------------- introspection ----------------------------------------

    def snapshot(self) -> Dict[str, float]:
        lookups = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "epoch_bumps": self.epoch_bumps,
                "hit_rate": round(self.hits / lookups, 4) if lookups
                else 0.0,
                "entries": len(self)}
