"""Distribution service: route table + device match + fan-out delivery
(copy of ``bifromq_tpu/dist/service.py`` over the port's ``DistWorker``).

Re-expression of the reference's dist stack (bifromq-dist-server
DistService → dist-worker DistWorkerCoProc → bifromq-deliverer
MessageDeliverer). There is ONE route table and it lives on the replicated
KV range hosted by ``DistWorker`` (≈ DistWorkerCoProc.java:105 — "the route
table *is* the KV"):

- ``match``/``unmatch`` are RW coproc calls through consensus
  (≈ batchAddRoute:304 / batchRemoveRoute:415, incl. incarnation guards).
- ``pub`` funnels through a per-tenant adaptive Batcher (≈ PubCallScheduler →
  BatchDistServerCall) that emits device match batches served from the
  worker replica's derived TorchMatcher.
- Fan-out: shared-group member election (ordered share = rendezvous hash on
  topic, unordered = random — ≈ DeliverExecutorGroup's cached ordered pick),
  then delivery batched per (tenant, sub-broker, deliverer key)
  (≈ MessageDeliverer/BatchDeliveryCall.java:53) with NO_SUB/NO_RECEIVER
  results feeding route cleanup.

Left out of the copy, each site marked with its ROADMAP item: the
remote-worker invalidation puller and the cross-broker ``remote_deliver``
hop (A.5b, with the RPC fabric), and the trace spans and ``OBS`` tenant
hooks (A.10).
"""

from __future__ import annotations

import hashlib
import random
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..models.matcher import TorchMatcher
from ..models.oracle import (PERSISTENT_SUB_BROKER_ID, MatchedRoutes,
                             Route)
from ..plugin.events import Event, EventType, IEventCollector
from ..plugin.settings import ISettingProvider, Setting
from ..plugin.subbroker import (DeliveryPack, DeliveryResult,
                                SubBrokerRegistry)
from ..scheduler.batcher import BatchCallScheduler
from ..types import (ClientInfo, MatchInfo, Message, PublisherMessagePack,
                     RouteMatcher, TopicMessagePack)
from ..utils import topic as topic_util
from ..utils.metrics import MATCH_CACHE, STAGES


@dataclass
class PubCall:
    publisher: ClientInfo
    topic: str
    message: Message


@dataclass
class PubResult:
    ok: bool
    fanout: int = 0
    error: str = ""


class GroupFanoutBalancer:
    """Least-outstanding election for UNORDERED shared-subscription
    groups ($share).

    The upstream broker picks an unordered-share
    member uniformly at random — fair in expectation, but a burst of a
    few hundred publishes routinely lands 2-3× the mean on one member
    (balls-into-bins), which is exactly the skew that trips slow-
    consumer backpressure under a million-client mixed workload. This
    balancer tracks per-member delivery counts per (tenant, group
    filter) and elects the least-loaded member, ties broken by the
    service rng — deterministic O(members) per publish, worst-case
    member spread 1 instead of O(log n / log log n).

    Membership churn self-heals: counts are keyed by receiver_url, a
    first-seen member seeds at the current group MINIMUM (joining the
    min tie for a fair share — seeding at zero would flood the cold
    newcomer with 100% of traffic until it caught up), and departed
    members' counts are swept once the map outgrows the live set.
    Bounded: group entries are dropped LRU-ish past ``max_groups`` (the
    counts are a balancing hint, not correctness state).
    """

    def __init__(self, rng: random.Random, max_groups: int = 8192) -> None:
        self._rng = rng
        self.max_groups = max_groups
        # (tenant, filter) -> {receiver_url: delivered count}
        self._counts: Dict[Tuple[str, str], Dict[str, int]] = {}
        self.elections = 0

    def pick(self, tenant_id: str, mqtt_filter: str, members) -> "Route":
        self.elections += 1
        key = (tenant_id, mqtt_filter)
        counts = self._counts.get(key)
        if counts is None:
            if len(self._counts) >= self.max_groups:
                # drop the oldest half (insertion order ≈ LRU for the
                # steady case: hot groups re-enter immediately)
                for k in list(self._counts)[:self.max_groups // 2]:
                    del self._counts[k]
            counts = self._counts[key] = {}
        # a first-seen member SEEDS at the current group minimum: with
        # lifetime counts, seeding at 0 would route 100% of the group's
        # traffic to every newcomer until it caught up — the exact cold-
        # consumer flood this balancer exists to prevent. Seeded, it
        # simply joins the min tie and takes a fair share from now on.
        seed = min((counts.get(r.receiver_url) for r in members
                    if r.receiver_url in counts),
                   default=0)
        lo = None
        lo_members = []
        for r in members:
            c = counts.get(r.receiver_url)
            if c is None:
                c = counts[r.receiver_url] = seed
            if lo is None or c < lo:
                lo, lo_members = c, [r]
            elif c == lo:
                lo_members.append(r)
        elected = (lo_members[0] if len(lo_members) == 1
                   else lo_members[self._rng.randrange(len(lo_members))])
        counts[elected.receiver_url] = lo + 1
        if len(counts) > 4 * len(members) + 8:
            # membership churned: retain only live members' counts
            live = {r.receiver_url for r in members}
            for url in [u for u in counts if u not in live]:
                del counts[url]
        return elected

    def spread(self, tenant_id: str, mqtt_filter: str) -> dict:
        """Per-group balance introspection (bench config 10's
        share-balance leg and the fairness tests read it)."""
        counts = self._counts.get((tenant_id, mqtt_filter), {})
        if not counts:
            return {"members": 0, "max": 0, "min": 0}
        vals = list(counts.values())
        return {"members": len(vals), "max": max(vals), "min": min(vals)}


class DistService:
    def __init__(self, sub_brokers: SubBrokerRegistry,
                 event_collector: IEventCollector,
                 setting_provider: ISettingProvider, *,
                 worker=None,
                 max_burst_latency: float = 0.005,
                 rng_seed: Optional[int] = None) -> None:
        self.sub_brokers = sub_brokers
        self.events = event_collector
        self.settings = setting_provider
        if worker is None:
            from .worker import DistWorker
            worker = DistWorker()
        self.worker = worker
        # degradation surface: a local worker's host-oracle fallback
        # reports MATCH_DEGRADED through the event stream
        if hasattr(worker, "on_degraded"):
            worker.on_degraded = self._on_match_degraded
        # the cross-broker delivery plane (deliverer_registry, server_id:
        # set by the starter for clustered frontends): ROADMAP A.5b
        self._rng = random.Random(rng_seed)
        # unordered-$share election balances on per-member
        # delivery counts instead of uniform random (ordered share keeps
        # the stateless rendezvous pick — its contract is stability)
        self.group_balancer = GroupFanoutBalancer(self._rng)
        # pub-side match cache (the shared TenantMatchCache, ≈
        # SubscriptionCache/TenantRouteCache.java:65): matched routes per
        # (tenant, topic) with filter-aware invalidation. The TTL bounds
        # staleness from mutations applied on OTHER nodes when the worker
        # is remote; with a local worker the coproc apply-stream hook
        # below makes invalidation exact (replayed mutations included).
        from ..models.matchcache import TenantMatchCache
        self._match_cache = TenantMatchCache(
            scope="pub", ttl_s=self._MATCH_CACHE_TTL_DEFAULT,
            max_topics_per_tenant=self.MATCH_CACHE_MAX,
            max_entries=self.MATCH_CACHE_MAX)   # same TOTAL bound as the
        # hand-rolled predecessor: TTL expiry is lazy, the bound is the
        # memory wall. The pub cache is always on, as the reference's is
        # by default: the port has no BIFROMQ_MATCH_CACHE kill-switch
        if hasattr(worker, "on_route_mutation"):
            worker.on_route_mutation = self._on_route_mutation
        # a REMOTE worker has no local apply stream; its exact-invalidation
        # puller comes with the remote worker (ROADMAP A.5b). Registering
        # the pub cache's hot keys with the gossip digest: ROADMAP A.10
        self._pub_scheduler: BatchCallScheduler[PubCall, PubResult] = \
            BatchCallScheduler(lambda tenant: self._make_pub_batch(tenant),
                               pipeline_depth=None,  # BIFROMQ_PIPELINE_DEPTH
                               max_burst_latency=max_burst_latency,
                               stage="queue_wait")

    @property
    def matcher(self) -> TorchMatcher:
        """This replica's derived matcher (introspection/metrics only —
        mutations MUST go through match/unmatch so they ride consensus)."""
        return self.worker.matcher

    async def start(self) -> None:
        await self.worker.start()
        # the remote-worker deployment's exact invalidation (the
        # InvalidationPuller on the delta stream): ROADMAP A.5b
        from ..utils.sysprops import SysProp, get
        interval = get(SysProp.DIST_GC_INTERVAL_SECONDS)
        if interval and interval > 0:
            import asyncio

            async def loop():
                while True:
                    await asyncio.sleep(interval)
                    try:
                        await self.gc_sweep()
                    except Exception:  # noqa: BLE001
                        import logging
                        logging.getLogger(__name__).exception("dist gc")
            self._gc_task = asyncio.create_task(loop())

    async def stop(self) -> None:
        task = getattr(self, "_gc_task", None)
        if task is not None:
            task.cancel()
            self._gc_task = None
        await self.worker.stop()

    async def gc_sweep(self) -> int:
        """Periodic dead-route sweep (≈ DistWorkerCoProc.gc:554 +
        SubscriptionCleaner): every stored route is checked against its
        sub-broker's checkSubscriptions; routes whose receiver no longer
        holds the subscription are removed through consensus."""
        if not hasattr(self.worker, "_iter_all_routes"):
            # remote worker: the sweep must run in the worker process (it
            # owns the keyspace); the frontend has nothing to scan
            return 0
        # batch checks per (broker, tenant) — the ISubBroker SPI is batched
        # exactly for this (≈ SubscriptionCleaner batching)
        groups: Dict[Tuple[int, str], List[Route]] = {}
        for tenant_id, route in self.worker._iter_all_routes():
            if self.sub_brokers.has(route.broker_id):
                groups.setdefault((route.broker_id, tenant_id),
                                  []).append(route)
        removed = 0
        for (broker_id, tenant_id), routes in groups.items():
            broker = self.sub_brokers.get(broker_id)
            mis = [MatchInfo(matcher=r.matcher, receiver_id=r.receiver_id,
                             incarnation=r.incarnation) for r in routes]
            try:
                alive = await broker.check_subscriptions(tenant_id, mis)
            except Exception:  # noqa: BLE001
                continue
            for r, ok in zip(routes, alive):
                if not ok:
                    await self.worker.remove_route(
                        tenant_id, r.matcher, r.receiver_url, r.incarnation)
                    self._match_cache.invalidate(tenant_id,
                                                 r.matcher.filter_levels)
                    removed += 1
        return removed

    # ---------------- route mutations (≈ batchAddRoute/batchRemoveRoute) ---

    async def match(self, tenant_id: str, matcher: RouteMatcher,
                    broker_id: int, receiver_id: str, deliverer_key: str,
                    incarnation: int = 0) -> bool:
        route = Route(matcher=matcher, broker_id=broker_id,
                      receiver_id=receiver_id, deliverer_key=deliverer_key,
                      incarnation=incarnation)
        try:
            out = await self.worker.add_route(tenant_id, route)
        except Exception:  # noqa: BLE001 — consensus/transport failure
            self.events.report(Event(EventType.MATCH_ERROR, tenant_id,
                                     {"filter":
                                      matcher.mqtt_topic_filter}))
            raise
        ok = out in ("ok", "exists")
        if ok:
            # filter-aware: an exact filter evicts one topic
            # key, a wildcard bumps the tenant epoch
            self._match_cache.invalidate(tenant_id, matcher.filter_levels)
        self.events.report(Event(
            EventType.MATCHED if ok else EventType.MATCH_ERROR, tenant_id,
            {"filter": matcher.mqtt_topic_filter}
            | ({} if ok else {"reason": out})))
        return ok

    async def unmatch(self, tenant_id: str, matcher: RouteMatcher,
                      broker_id: int, receiver_id: str, deliverer_key: str,
                      incarnation: int = 0) -> bool:
        try:
            out = await self.worker.remove_route(
                tenant_id, matcher, (broker_id, receiver_id, deliverer_key),
                incarnation)
        except Exception:  # noqa: BLE001
            self.events.report(Event(EventType.UNMATCH_ERROR, tenant_id,
                                     {"filter":
                                      matcher.mqtt_topic_filter}))
            raise
        ok = out == "ok"
        if ok:
            self._match_cache.invalidate(tenant_id, matcher.filter_levels)
        self.events.report(Event(
            EventType.UNMATCHED if ok else EventType.UNMATCH_ERROR,
            tenant_id, {"filter": matcher.mqtt_topic_filter}
            | ({} if ok else {"reason": out})))
        return ok

    # ---------------- publish path -----------------------------------------

    async def pub(self, publisher: ClientInfo, topic: str,
                  message: Message) -> PubResult:
        call = PubCall(publisher=publisher, topic=topic, message=message)
        return await self._pub_scheduler.submit(publisher.tenant_id, call)

    # pub-side match cache knobs (see __init__): the TTL bounds staleness
    # from mutations made on OTHER nodes, the reference's refresh window
    _MATCH_CACHE_TTL_DEFAULT = 1.0
    MATCH_CACHE_MAX = 8192

    @property
    def MATCH_CACHE_TTL(self) -> float:
        return self._match_cache.ttl_s

    @MATCH_CACHE_TTL.setter
    def MATCH_CACHE_TTL(self, value: float) -> None:
        # a runtime knob, not a constructor snapshot: tests/operators set
        # it on a live service (chaos suite pins 0.0 so every publish
        # exercises the fabric)
        self._match_cache.ttl_s = value

    def _on_route_mutation(self, tenant_id, filter_levels) -> None:
        """Apply-stream invalidation: fires for every route
        mutation the local worker's coprocs apply — including mutations
        REPLAYED from raft peers that never passed through this service's
        match/unmatch — keeping the pub cache filter-aware-fresh without
        waiting out the TTL."""
        if tenant_id is None:
            self._match_cache.bump_all()
        else:
            self._match_cache.invalidate(tenant_id, filter_levels)

    def _make_pub_batch(self, tenant_id: str):
        async def process(calls: Sequence[PubCall]) -> List[PubResult]:
            mpf = self.settings.provide(
                Setting.MaxPersistentFanout, tenant_id)
            if mpf is None:
                mpf = Setting.MaxPersistentFanout.default
            mgf = self.settings.provide(Setting.MaxGroupFanout, tenant_id)
            if mgf is None:
                mgf = Setting.MaxGroupFanout.default
            caps = (mpf, mgf)
            matched: List[Optional[MatchedRoutes]] = []
            miss_topics: List[str] = []     # deduped (hot-topic bursts
            miss_pos: Dict[str, int] = {}   # must not fan into N queries)
            n_miss_calls = 0
            for qi, c in enumerate(calls):
                m = self._match_cache.get(tenant_id, c.topic, caps)
                matched.append(m)
                if m is None:
                    n_miss_calls += 1
                    if c.topic not in miss_pos:
                        miss_pos[c.topic] = len(miss_topics)
                        miss_topics.append(c.topic)
            # the tenant's hit-rate window (OBS): ROADMAP A.10; global
            # section totals: one locked inc per pub batch
            MATCH_CACHE.inc("pub", "hits", len(calls) - n_miss_calls)
            MATCH_CACHE.inc("pub", "misses", n_miss_calls)
            if miss_topics:
                # snapshot BEFORE the (awaited) match: a mutation landing
                # mid-flight must make the stored entry instantly stale
                token = self._match_cache.token(tenant_id)
                try:
                    fresh = await self._match_missing(
                        tenant_id, miss_topics, mpf, mgf)
                except Exception:  # noqa: BLE001 — match backend failure
                    # ≈ DistError event + failed PubResults (caller acks
                    # the client with an error / QoS0 drops)
                    self.events.report(Event(
                        EventType.DIST_ERROR, tenant_id,
                        {"topics": len(miss_topics)}))
                    raise
                for t, m in zip(miss_topics, fresh):
                    self._match_cache.put(tenant_id, t, caps, m, token)
                for qi, c in enumerate(calls):
                    if matched[qi] is None:
                        matched[qi] = fresh[miss_pos[c.topic]]
            results: List[PubResult] = []
            for call, m in zip(calls, matched):
                fanout = await self._fan_out(tenant_id, call, m)
                results.append(PubResult(ok=True, fanout=fanout))
                if fanout:
                    # ≈ Disted event (dist call accepted + fanned out)
                    self.events.report(Event(
                        EventType.DISTED, tenant_id,
                        {"topic": topic_util.to_str(call.topic),
                         "fanout": fanout}))
            return results
        return process

    # match-path deadline budget: caps every RPC hop to a
    # remote worker (per-attempt timeout + retries) and gates the local
    # device walk at each range's dispatch boundary — an exhausted budget
    # degrades to the host oracle instead of failing the publish. (An
    # in-flight device call is not preempted; only remote hops carry a
    # hard per-attempt timeout.)
    MATCH_DEADLINE_S = 5.0

    def _on_match_degraded(self, n_queries: int, reason: str) -> None:
        self.events.report(Event(EventType.MATCH_DEGRADED, "-",
                                 {"queries": n_queries,
                                  "reason": reason}))

    async def _match_missing(self, tenant_id, miss_topics, mpf, mgf):
        from ..resilience.policy import deadline_scope
        with deadline_scope(self.MATCH_DEADLINE_S):
            # caps arrive pre-resolved (they are also the cache key dims).
            # byte plane: raw topic STRINGS flow to the matcher,
            # which packs one contiguous byte buffer per batch — no
            # per-topic parse/list materialization on the publish path;
            # levels appear only on the matcher's rare fallback legs.
            return await self.worker.match_batch(
                [(tenant_id, t) for t in miss_topics],
                max_persistent_fanout=mpf, max_group_fanout=mgf)

    async def _fan_out(self, tenant_id: str, call: PubCall,
                       matched: MatchedRoutes) -> int:
        """One publish's fan-out, feeding the "deliver" stage histogram
        (the "deliver.fanout" span and the tenant's SLO windows: ROADMAP
        A.10)."""
        t0 = time.perf_counter()
        # wire-bytes topics decode ONCE here, at the delivery boundary —
        # the match path upstream never did
        topic_s = topic_util.to_str(call.topic)
        try:
            return await self._fan_out_inner(tenant_id, call, matched,
                                             topic_s)
        finally:
            STAGES.record("deliver", time.perf_counter() - t0)

    async def _fan_out_inner(self, tenant_id: str, call: PubCall,
                             matched: MatchedRoutes,
                             topic_s: str) -> int:
        if matched.max_persistent_fanout_exceeded:
            self.events.report(Event(EventType.PERSISTENT_FANOUT_THROTTLED,
                                     tenant_id, {"topic": topic_s}))
        if matched.max_group_fanout_exceeded:
            self.events.report(Event(EventType.GROUP_FANOUT_THROTTLED,
                                     tenant_id, {"topic": topic_s}))
        targets: List[Route] = list(matched.normal)
        for mqtt_filter, members in matched.groups.items():
            elected = self._elect(tenant_id, mqtt_filter, members, topic_s)
            if elected is not None:
                targets.append(elected)
        # byte-based persistent fan-out cap (≈ MaxPersistentFanoutBytes in
        # DeliverExecutorGroup.java:132), applied over the FULL target set
        # (normal + elected shared-group members — an elected persistent
        # member consumes budget too); transient receivers are untouched
        max_pf_bytes = self.settings.provide(
            Setting.MaxPersistentFanoutBytes, tenant_id)
        if max_pf_bytes is None:
            max_pf_bytes = Setting.MaxPersistentFanoutBytes.default
        payload_len = len(call.message.payload)
        n_persistent = sum(1 for r in targets
                           if r.broker_id == PERSISTENT_SUB_BROKER_ID)
        if payload_len and n_persistent * payload_len > max_pf_bytes:
            allowed = int(max_pf_bytes // payload_len)
            kept: List[Route] = []
            used = 0
            for r in targets:
                if r.broker_id != PERSISTENT_SUB_BROKER_ID:
                    kept.append(r)
                elif used < allowed:
                    kept.append(r)
                    used += 1
            targets = kept
            self.events.report(Event(
                EventType.PERSISTENT_FANOUT_BYTES_THROTTLED, tenant_id,
                {"topic": topic_s, "allowed": allowed}))
        if not targets:
            return 0
        # group per (broker, deliverer_key) ≈ BatchDeliveryCall grouping
        by_deliverer: Dict[Tuple[int, str], List[Route]] = {}
        for r in targets:
            by_deliverer.setdefault((r.broker_id, r.deliverer_key),
                                    []).append(r)
        pack = TopicMessagePack(
            topic=topic_s,
            packs=(PublisherMessagePack(publisher=call.publisher,
                                        messages=(call.message,)),))
        fanout = 0
        for (broker_id, dkey), routes in by_deliverer.items():
            match_infos = tuple(
                MatchInfo(matcher=r.matcher, receiver_id=r.receiver_id,
                          incarnation=r.incarnation) for r in routes)
            # cross-broker delivery (a deliverer key owned by ANOTHER
            # server makes one RPC hop to that broker node,
            # remote_deliver): ROADMAP A.5b
            if not self.sub_brokers.has(broker_id):
                continue
            broker = self.sub_brokers.get(broker_id)
            dp = DeliveryPack(message_pack=pack, match_infos=match_infos)
            try:
                res = await broker.deliver(tenant_id, dkey, [dp])
            except Exception as e:  # noqa: BLE001
                self.events.report(Event(EventType.DELIVER_ERROR,
                                         tenant_id, {"error": repr(e)}))
                # the tenant's delivery-violation window: ROADMAP A.10
                continue
            for route, mi in zip(routes, match_infos):
                outcome = res.get(mi, DeliveryResult.ERROR)
                if outcome == DeliveryResult.OK:
                    fanout += 1
                elif outcome in (DeliveryResult.NO_SUB,
                                 DeliveryResult.NO_RECEIVER):
                    # dead route cleanup (≈ BatchDeliveryCall NO_SUB handling)
                    await self.worker.remove_route(
                        tenant_id, route.matcher, route.receiver_url,
                        route.incarnation)
                    self._match_cache.invalidate(
                        tenant_id, route.matcher.filter_levels)
        return fanout

    def _elect(self, tenant_id: str, mqtt_filter: str,
               members: List[Route], topic: str) -> Optional[Route]:
        """Shared-group member election (≈ DeliverExecutorGroup).

        Ordered share: rendezvous hash over (member, topic) — stable per
        topic, redistributes ~1/n on membership change (the reference caches
        the pick; rendezvous gives the same stability statelessly).
        Unordered share: least-outstanding balanced election
        via :class:`GroupFanoutBalancer` — worst-case member spread 1
        where uniform random gave balls-into-bins skew.
        """
        if not members:
            return None
        if members[0].matcher.type.name == "ORDERED_SHARE":
            def score(r: Route) -> int:
                h = hashlib.blake2b(
                    f"{r.receiver_id}|{r.deliverer_key}|{topic}".encode(),
                    digest_size=8).digest()
                return int.from_bytes(h, "little")
            return max(members, key=score)
        return self.group_balancer.pick(tenant_id, mqtt_filter, members)
