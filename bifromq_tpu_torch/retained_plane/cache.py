"""Filter-keyed retained scan cache and the retained delta stream (copy
of ``bifromq_tpu/retained_plane/cache.py``).

``RetainedScanCache`` memoizes wildcard-scan results per (tenant,
filter, limit). Retained mutations are CONCRETE topics, so exact
invalidation is a containment test, not a guess: a SET/DEL of topic T
evicts precisely the cached filters that match T
(``utils.topic.matches``, the [MQTT-4.7.2-1]-aware predicate the oracle
uses). Pre-scan tokens defeat stores racing in-flight scans, the same
discipline as the route-match cache.

``RetainedDeltaLog`` is the seq'd per-range stream of those mutations,
with the same ``since`` gap contract as the route delta log, so a remote
retained frontend or a warm standby can long-poll it.
"""

from __future__ import annotations

import threading
from collections import deque
from itertools import islice
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils import topic as topic_util
from ..utils.hlc import HLC


class RetainedScanCache:
    """Per-tenant LRU of retained-scan results with exact invalidation."""

    def __init__(self, *, max_keys_per_tenant: int = 512,
                 max_tenants: int = 4096) -> None:
        self.max_keys_per_tenant = max_keys_per_tenant
        self.max_tenants = max_tenants
        # tenant -> {(filter_levels, limit): (topics tuple, token)}
        self._d: Dict[str, dict] = {}
        self._seq: Dict[str, int] = {}
        self._gen = 0   # wholesale epoch: folded into every token so a
        # reset-raced in-flight scan can never store a stale entry
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bumps = 0

    def token(self, tenant: str):
        """Pre-scan snapshot: a mutation landing while the scan is in
        flight bumps the seq, so the late store is refused."""
        return (self._gen, self._seq.get(tenant, 0))

    def get(self, tenant: str, key, limit: Optional[int]):
        t = self._d.get(tenant)
        if t is None:
            self.misses += 1
            return None
        v = t.get((key, limit))
        if v is None:
            self.misses += 1
            return None
        # true LRU: refresh recency (dict preserves insertion order)
        del t[(key, limit)]
        t[(key, limit)] = v
        self.hits += 1
        return v[0]

    def put(self, tenant: str, key, limit: Optional[int], topics,
            token) -> None:
        if (self._gen, self._seq.get(tenant, 0)) != token:
            return      # a mutation raced this scan: instantly stale
        t = self._d.get(tenant)
        if t is None:
            if len(self._d) >= self.max_tenants:
                return  # bounded tenant cardinality: never grow past it
            t = self._d[tenant] = {}
        if len(t) >= self.max_keys_per_tenant:
            drop = len(t) // 2
            for k in list(islice(iter(t), drop)):
                del t[k]
            self.evictions += drop
        t[(key, limit)] = (tuple(topics), token)

    # ---------------- invalidation ------------------------------------------

    def on_delta(self, tenant: Optional[str], topic_levels, op: str) -> None:
        """The index delta hook: evict exactly the cached filters the
        mutated topic matches. ``tenant=None`` (reset / stream loss)
        degrades to a wholesale clear."""
        if tenant is None:
            self.bump_all()
            return
        # the seq bump must precede the key scan: an in-flight scan that
        # walked PRE-mutation tables may store after this hook ran, and
        # only the token mismatch defeats it
        self._seq[tenant] = self._seq.get(tenant, 0) + 1
        t = self._d.get(tenant)
        if not t:
            return
        levels = list(topic_levels or ())
        dead = [k for k in t
                if topic_util.matches(levels, list(k[0]))]
        for k in dead:
            del t[k]
        self.evictions += len(dead)

    def bump_all(self) -> None:
        self._gen += 1
        self._d.clear()
        self.bumps += 1

    def snapshot(self) -> dict:
        return {"tenants": len(self._d),
                "keys": sum(len(t) for t in self._d.values()),
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "bumps": self.bumps}


class RetainedDeltaLog:
    """Bounded seq'd ring of retained mutations for ONE retain range, the
    retained twin of the route delta log (records are lean ``(seq, hlc,
    tenant, topic, op)`` tuples: retained deltas carry no patch plans,
    the consumer contract is exact invalidation)."""

    def __init__(self, origin: str, range_id: str, cap: int = 8192) -> None:
        self.origin = origin
        self.range_id = range_id
        self.epoch = int(HLC.physical(HLC.INST.get()) // 1000) & 0x3FFFFFFF
        self.next_seq = 1
        self._records: deque = deque(maxlen=cap)
        self._lock = threading.Lock()
        # the replication status registry (register_hub, GET
        # /replication): ROADMAP A.9

    def append(self, tenant: str, topic_levels: Sequence[str],
               op: str) -> None:
        with self._lock:
            self._records.append(
                (self.next_seq, HLC.INST.get(), tenant,
                 tuple(topic_levels), op))
            self.next_seq += 1
        # the REPLICATION "records" counter: ROADMAP A.9; the lag plane's
        # LAG.note_emit("retained", "retained"): ROADMAP A.10

    def since(self, after_seq: int) -> Tuple[str, List[tuple]]:
        with self._lock:
            head = self.next_seq - 1
            if after_seq > head:
                return "gap", []
            if after_seq == head:
                return "ok", []
            oldest = self.next_seq - len(self._records)
            if after_seq + 1 < oldest:
                return "gap", []
            start = after_seq + 1 - oldest
            return "ok", list(islice(self._records, start, None))

    def status(self) -> dict:
        # same row shape as the route replication hub (one-range list)
        with self._lock:
            return {"role": "retained-hub", "origin": self.origin,
                    "ranges": [{"range": self.range_id,
                                "epoch": self.epoch,
                                "head_seq": self.next_seq - 1,
                                "ring": len(self._records)}]}
