"""Retained-message service (port of ``bifromq_tpu/retain/service.py``;
≈ bifromq-retain store + server + client).

Reference: RetainStoreCoProc (retain/store/RetainStoreCoProc.java:76):
RW batchRetain (empty payload deletes, per [MQTT-3.3.1-6/7/10/11]), RO
batchMatch against the in-memory RetainTopicIndex; expiry GC driven by a
tenant GC runner (store/gc/RetainStoreGCProcessor). Here:

- authoritative state: per-tenant ``topic → RetainedMsg`` maps in each
  range's coproc, replicated through consensus on the retain range
- wildcard lookup: each range's ``RetainedIndex`` (K1 hashes the filter
  probes on the card) behind its ``RetainedScanPlane`` (result cache,
  dispatch ring, watchdog, device breaker)
- expiry: lazy on match + an explicit ``gc()`` sweep
- per-tenant topic quota via IResourceThrottler (TOTAL_RETAIN_TOPICS)

A fault of the program raised in a range's scan (``models/matcher.
_PROGRAM_FAULTS``) propagates out of :meth:`RetainService.match_batch`.
The warm standby's feed (``standby_feed``, ``retained_standby``) is
ROADMAP A.9; each range's coproc keeps its ``delta_log`` for it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..models.retained import RetainedIndex
from ..plugin.events import Event, EventType, IEventCollector
from ..plugin.throttler import (AllowAllResourceThrottler, IResourceThrottler,
                                TenantResourceType)
from ..types import ClientInfo, Message

_NEVER = 0xFFFFFFFF


@dataclass
class RetainedMsg:
    topic: str
    message: Message
    publisher: ClientInfo
    expire_at: Optional[float]  # epoch seconds; None = never


class RetainService:
    """Retained messages over a REPLICATED retain range: SET/DEL ride
    consensus (retain/coproc.py), wildcard matches serve from this
    replica's derived index.

    ``index`` is the template every range's index is made like (its
    budgets, probe length, device and patching); None means the
    defaults, on the card."""

    def __init__(self, events: IEventCollector, *,
                 throttler: Optional[IResourceThrottler] = None,
                 index: Optional[RetainedIndex] = None,
                 engine=None, node_id: str = "local", voters=None,
                 transport=None, tick_interval: float = 0.01,
                 clock=time.time,
                 split_threshold: Optional[int] = None) -> None:
        from ..kv.engine import InMemKVEngine
        from ..kv.store import KVRangeStore
        from ..raft.transport import InMemTransport

        self.events = events
        self.throttler = throttler or AllowAllResourceThrottler()
        self.clock = clock
        self.tick_interval = tick_interval
        self._node_id = node_id
        engine = engine or InMemKVEngine()
        self._transport = (transport if transport is not None
                           else InMemTransport())
        # the retain keyspace on a MULTI-RANGE store ("retain_" prefix
        # namespaces its spaces on a shared engine); per-range derived
        # RetainedIndex instances rebuild via reset-from-KV. The durable
        # raft store and the legacy-space migration: ROADMAP A.5c
        self._index_template = index
        self.kvstore = KVRangeStore(
            node_id, self._transport, engine,
            coproc_factory=self._mk_coproc,
            member_nodes=voters or [node_id],
            space_prefix="retain_")
        self.kvstore.open()
        self.balance_controller = None
        if split_threshold is not None:
            from ..kv.balance import (KVStoreBalanceController,
                                      RangeSplitBalancer)
            self.balance_controller = KVStoreBalanceController(
                self.kvstore,
                [RangeSplitBalancer(max_keys=split_threshold)])
        self._tick_task = None

    def _mk_coproc(self, rid: str):
        from ..retained_plane import RetainedDeltaLog, RetainedScanPlane
        from .coproc import RetainCoProc, index_like
        tmpl = self._index_template
        coproc = RetainCoProc(index_like(tmpl) if tmpl is not None
                              else None)
        # the SUBSCRIBE-side scan plane (dispatch ring + breaker +
        # watchdog + filter-keyed cache) per range replica; the index
        # indirection survives reset-from-KV swaps
        plane = RetainedScanPlane(lambda: coproc.index)
        coproc.scan_plane = plane
        # per-range retained delta stream (the exact-invalidation feed;
        # fires for raft-replayed ops too)
        log = RetainedDeltaLog(self._node_id, rid)
        coproc.delta_consumers.append(plane.cache.on_delta)
        coproc.delta_consumers.append(
            lambda tenant, levels, op:
                log.append(tenant or "", levels or (), op))
        # the warm standby's feed (standby_feed, retained_standby):
        # ROADMAP A.9
        coproc.delta_log = log
        return coproc

    # ---------------- per-range access -------------------------------------

    def _coprocs(self):
        return self.kvstore.coprocs.values()

    def _coproc_for(self, tenant_id: str, topic: str):
        from ..kv import schema as _schema
        key = _schema.retain_key(tenant_id, topic)
        rid = self.kvstore.router.find_by_key(key)
        if rid is None:
            raise KeyError(f"no range covers retain key {key!r}")
        return self.kvstore.coprocs[rid], self.kvstore.ranges[rid]

    @property
    def index(self) -> RetainedIndex:
        """Single-range introspection convenience (tests)."""
        if len(self.kvstore.ranges) != 1:
            raise RuntimeError("multiple ranges; use kvstore.coprocs")
        return next(iter(self.kvstore.coprocs.values())).index

    async def start(self) -> None:
        import asyncio

        from ..raft.node import Role
        if self.kvstore.member_nodes == [self.kvstore.node_id]:
            for _ in range(10_000):
                if all(r.raft.role == Role.LEADER
                       for r in self.kvstore.ranges.values()):
                    break
                self.kvstore.tick()
                pump = getattr(self._transport, "pump", None)
                if pump is not None:
                    pump()

        async def loop():
            while True:
                self.kvstore.tick()
                pump = getattr(self._transport, "pump", None)
                if pump is not None:
                    pump()
                await asyncio.sleep(self.tick_interval)
        self._tick_task = asyncio.create_task(loop())
        if self.balance_controller is not None:
            await self.balance_controller.start()

    async def stop(self) -> None:
        if self.balance_controller is not None:
            await self.balance_controller.stop()
        if self._tick_task is not None:
            self._tick_task.cancel()
            self._tick_task = None
        self.kvstore.stop()

    def _decode(self, tenant_id: str, topic: str) -> Optional[RetainedMsg]:
        from .coproc import dec_retained
        coproc, _rng = self._coproc_for(tenant_id, topic)
        raw = coproc.values.get(tenant_id, {}).get(topic)
        if raw is None:
            return None
        expire_at, publisher, msg = dec_retained(raw)
        return RetainedMsg(topic=topic, message=msg, publisher=publisher,
                           expire_at=expire_at)

    # ---------------- mutations (≈ batchRetain) ----------------------------

    async def _mutate(self, tenant_id: str, topic: str, payload: bytes,
                      timeout: float = 5.0) -> bytes:
        import asyncio
        import time as _time

        from ..kv.range import propose_with_leader_wait
        deadline = _time.monotonic() + timeout
        while True:
            _coproc, rng = self._coproc_for(tenant_id, topic)
            out = await propose_with_leader_wait(
                rng, lambda rng=rng: rng.mutate_coproc(payload),
                timeout=max(0.01, deadline - _time.monotonic()),
                tick_single_voter=True)  # standalone use without start()
            if out != b"retry":
                return out
            if _time.monotonic() >= deadline:
                raise TimeoutError("retain op kept racing splits")
            await asyncio.sleep(0)    # split raced: re-resolve the range

    async def retain(self, publisher: ClientInfo, topic: str,
                     message: Message) -> bool:
        from ..kv import schema as _schema
        from .coproc import OP_DEL, OP_SET, enc_op, enc_retained

        tenant_id = publisher.tenant_id
        coproc, _rng = self._coproc_for(tenant_id, topic)
        existing = coproc.values.get(tenant_id, {})
        if not message.payload:
            # empty payload clears the retained message [MQTT-3.3.1-10/11]
            out = await self._mutate(tenant_id, topic,
                                     enc_op(OP_DEL, tenant_id, topic))
            if out == b"\x01":
                self.events.report(Event(EventType.RETAIN_MSG_CLEARED,
                                         tenant_id, {"topic": topic}))
            return True
        # quota is advisory under concurrency (check-then-propose): like
        # the reference's IResourceThrottler, has_resource is an
        # eventually-consistent gate, not a transactional reservation
        if topic not in existing and not self.throttler.has_resource(
                tenant_id, TenantResourceType.TOTAL_RETAIN_TOPICS):
            self.events.report(Event(EventType.MSG_RETAINED_ERROR, tenant_id,
                                     {"topic": topic, "reason": "quota"}))
            return False
        expire_at = None
        if message.expiry_seconds != _NEVER:
            expire_at = self.clock() + message.expiry_seconds
        value = enc_retained(_schema.encode_message(message), publisher,
                             expire_at)
        await self._mutate(tenant_id, topic,
                           enc_op(OP_SET, tenant_id, topic, value))
        self.events.report(Event(EventType.MSG_RETAINED, tenant_id,
                                 {"topic": topic}))
        return True

    # ---------------- queries (≈ batchMatch) -------------------------------

    async def match(self, tenant_id: str, filter_levels: Sequence[str],
                    limit: int) -> List[Tuple[str, Message]]:
        res = await self.match_batch([(tenant_id, filter_levels)], limit)
        return res[0]

    async def match_batch(self, queries: Sequence[Tuple[str, Sequence[str]]],
                          limit: int) -> List[List[Tuple[str, Message]]]:
        """Each query's hits: every range's index row in the index's
        order, unioned over the ranges the tenant spans, filtered by
        expiry and cut to ``limit``."""
        from ..kv import schema as _schema

        # per-tenant boundary intersect over the multi-range store, then
        # union per-range index hits (≈ dist worker's range routing)
        tenant_rids: Dict[str, List[str]] = {}
        for tenant_id, _lv in queries:
            if tenant_id not in tenant_rids:
                pfx = _schema.retain_prefix(tenant_id)
                tenant_rids[tenant_id] = self.kvstore.router.intersecting(
                    pfx, _schema.prefix_end(pfx))
        range_queries: Dict[str, List[int]] = {}
        for qi, (tenant_id, _lv) in enumerate(queries):
            for rid in tenant_rids[tenant_id]:
                range_queries.setdefault(rid, []).append(qi)
        raw: List[List[str]] = [[] for _ in queries]
        for rid, idxs in range_queries.items():
            # each range's scan plane: the `retain.scan` stage, the
            # filter-keyed cache, oracle degradation on timeout / injected
            # fault / open breaker; a fault of the program propagates
            res = await self.kvstore.coprocs[rid].scan_plane.scan_batch(
                [queries[qi] for qi in idxs], limit=limit)
            for qi, topics in zip(idxs, res):
                raw[qi].extend(topics)
        now = self.clock()
        out: List[List[Tuple[str, Message]]] = []
        for (tenant_id, _), topics in zip(queries, raw):
            hits: List[Tuple[str, Message]] = []
            for topic in topics:
                rm = self._decode(tenant_id, topic)
                if rm is None:
                    continue
                if rm.expire_at is not None and rm.expire_at <= now:
                    # best-effort consensus cleanup: a follower replica
                    # cannot propose; it still FILTERS the expired hit
                    # (the leader's gc sweep removes it for real)
                    try:
                        await self._expire(tenant_id, rm)
                    except Exception:  # noqa: BLE001
                        pass
                    continue
                if len(hits) < limit:
                    hits.append((topic, rm.message))
            out.append(hits)
        return out

    # ---------------- expiry GC (≈ RetainStoreGCProcessor) -----------------

    async def gc(self, tenant_id: Optional[str] = None) -> int:
        now = self.clock()
        removed = 0
        for coproc in list(self._coprocs()):
            tenants = ([tenant_id] if tenant_id is not None
                       else list(coproc.values))
            for t in tenants:
                for topic in list(coproc.values.get(t, {})):
                    rm = self._decode(t, topic)
                    if rm is not None and rm.expire_at is not None \
                            and rm.expire_at <= now:
                        await self._expire(t, rm)
                        removed += 1
        return removed

    async def _expire(self, tenant_id: str, rm: RetainedMsg) -> None:
        from .coproc import OP_DEL, enc_op
        await self._mutate(tenant_id, rm.topic,
                           enc_op(OP_DEL, tenant_id, rm.topic))

    def topic_count(self, tenant_id: str) -> int:
        return sum(len(c.values.get(tenant_id, {}))
                   for c in self._coprocs())

    def topics(self, tenant_id: str) -> List[str]:
        """Retained topic listing (introspection/API)."""
        out: List[str] = []
        for c in self._coprocs():
            out.extend(c.values.get(tenant_id, {}))
        return sorted(out)
