"""Dist-worker coproc: the route table as a raft-replicated KV coprocessor
(copy of ``bifromq_tpu/dist/worker.py`` on ``TorchMatcher``).

This is the reference's core dist architecture (bifromq-dist-worker
DistWorkerCoProc.java:105 on base-kv): route mutations are RW coproc ops
applied through consensus to the range's keyspace
(batchAddRoute:304/batchRemoveRoute:415 semantics incl. incarnation
guards), match queries are RO coproc ops served from the device matcher, and
``reset`` rebuilds the matcher from a KV scan after snapshot restore —
exactly how the reference rebuilds its caches/Fact (reset:283).

The matcher is *derived state*: every replica maintains its own
TorchMatcher from the same deterministic apply stream, so any query-ready
replica can serve matches (the reference's replica-spread reads).

Left out of the copy, each site marked with the ROADMAP item that brings
it: the replication hub and the coproc's delta/rebase outlets (A.9), the
trace spans and ``OBS`` tenant attribution (A.10). One boundary differs
from the reference on purpose: a kernel that refuses to launch, or a
kernel wrapper's argument check (``models/matcher._PROGRAM_FAULTS``), is
a fault of the program and propagates out of ``_match_on_range``; only
an injected matcher fault or an exhausted deadline degrades a range to
the host oracle there.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import time as _time
from typing import List, Optional, Sequence, Tuple

from ..kv import schema
from ..kv.engine import IKVSpace, KVWriteBatch
from ..kv.range import IKVRangeCoProc
from ..models.matcher import _PROGRAM_FAULTS, TorchMatcher, _safe_hook
from ..models.oracle import MatchedRoutes, Route
from ..resilience.faults import get_injector
from ..resilience.policy import current_deadline
from ..types import RouteMatcher
from ..utils.metrics import FABRIC, STAGES, FabricMetric

_OP_ADD = 0
_OP_REMOVE = 1
_OP_MATCH = 2
_OP_BATCH = 3


def _frame(b: bytes) -> bytes:
    return struct.pack(">I", len(b)) + b


def _read_frame(buf: bytes, pos: int) -> Tuple[bytes, int]:
    n = struct.unpack_from(">I", buf, pos)[0]
    pos += 4
    return buf[pos:pos + n], pos + n


def _tenant_of_key(key: bytes) -> str:
    """Tenant id embedded after the tag+version prefix of a route key."""
    tenant_b, _ = schema._read_len16(key, 2)
    return tenant_b.decode()


def encode_add_route(tenant_id: str, route: Route) -> bytes:
    key = schema.route_key(tenant_id, route.matcher, route.receiver_url)
    return (bytes([_OP_ADD]) + _frame(key)
            + _frame(schema.route_value(route.incarnation)))


def encode_remove_route(tenant_id: str, matcher: RouteMatcher,
                        receiver_url: Tuple[int, str, str],
                        incarnation: int = 0) -> bytes:
    key = schema.route_key(tenant_id, matcher, receiver_url)
    return (bytes([_OP_REMOVE]) + _frame(key)
            + _frame(schema.route_value(incarnation)))


def encode_batch(sub_ops: Sequence[bytes]) -> bytes:
    """Many add/remove ops as ONE raft entry (≈ BatchMatchCall folding an
    orderKey-pinned call window into a single KVRangeRWRequest,
    bifromq-dist-server .../scheduler/BatchMatchCall.java)."""
    out = bytearray([_OP_BATCH])
    out += struct.pack(">I", len(sub_ops))
    for op in sub_ops:
        out += _frame(op)
    return bytes(out)


def decode_batch_reply(buf: bytes) -> List[bytes]:
    n = struct.unpack_from(">I", buf, 0)[0]
    pos = 4
    out = []
    for _ in range(n):
        s, pos = _read_frame(buf, pos)
        out.append(s)
    return out


def encode_match_query(tenant_id: str, topics: Sequence[str]) -> bytes:
    out = bytearray([_OP_MATCH])
    out += _frame(tenant_id.encode())
    out += struct.pack(">I", len(topics))
    for t in topics:
        out += _frame(t.encode())
    return bytes(out)


# ---- THE match-result wire codec (one codec, full group fidelity) ----------
# shared by the coproc RO path and the dist-worker RPC service (the
# reference's dist/remote.py re-exports these; ROADMAP A.5b)

from ..rpc.fabric import _len16, _read16  # noqa: E402 — ONE framing impl


def _enc_route(r: Route) -> bytes:
    return (_len16(r.matcher.mqtt_topic_filter.encode())
            + struct.pack(">I", r.broker_id)
            + _len16(r.receiver_id.encode())
            + _len16(r.deliverer_key.encode())
            + struct.pack(">q", r.incarnation))


def _dec_route(buf: bytes, pos: int) -> Tuple[Route, int]:
    tf, pos = _read16(buf, pos)
    broker = struct.unpack_from(">I", buf, pos)[0]
    pos += 4
    recv, pos = _read16(buf, pos)
    dk, pos = _read16(buf, pos)
    inc = struct.unpack_from(">q", buf, pos)[0]
    pos += 8
    return Route(matcher=RouteMatcher.from_topic_filter(tf.decode()),
                 broker_id=broker, receiver_id=recv.decode(),
                 deliverer_key=dk.decode(), incarnation=inc), pos


def encode_matched(m) -> bytes:
    flags = ((1 if m.max_persistent_fanout_exceeded else 0)
             | (2 if m.max_group_fanout_exceeded else 0))
    out = bytearray([flags])
    out += struct.pack(">I", len(m.normal))
    for r in m.normal:
        out += _enc_route(r)
    out += struct.pack(">H", len(m.groups))
    for tf, members in m.groups.items():
        out += _len16(tf.encode())
        out += struct.pack(">I", len(members))
        for r in members:
            out += _enc_route(r)
    return bytes(out)


def decode_matched(buf: bytes, pos: int = 0):
    m = MatchedRoutes()
    flags = buf[pos]
    pos += 1
    m.max_persistent_fanout_exceeded = bool(flags & 1)
    m.max_group_fanout_exceeded = bool(flags & 2)
    n = struct.unpack_from(">I", buf, pos)[0]
    pos += 4
    for _ in range(n):
        r, pos = _dec_route(buf, pos)
        m.normal.append(r)
    ng = struct.unpack_from(">H", buf, pos)[0]
    pos += 2
    for _ in range(ng):
        tf, pos = _read16(buf, pos)
        nm = struct.unpack_from(">I", buf, pos)[0]
        pos += 4
        members = []
        for _ in range(nm):
            r, pos = _dec_route(buf, pos)
            members.append(r)
        m.groups[tf.decode()] = members
    return m, pos


def decode_match_reply(buf: bytes):
    """Per-topic MatchedRoutes list (the coproc RO reply)."""
    n = struct.unpack_from(">I", buf, 0)[0]
    pos = 4
    out = []
    for _ in range(n):
        m, pos = decode_matched(buf, pos)
        out.append(m)
    return out


class DistWorkerCoProc(IKVRangeCoProc):
    """Route-table coproc; one instance per range replica."""

    def __init__(self, matcher: Optional[TorchMatcher] = None) -> None:
        from ..kv.load import KVLoadRecorder
        # no matcher given: TorchMatcher() on the card (raises without one)
        self.matcher = matcher or TorchMatcher()
        # apply-stream invalidation outlet — fires for EVERY applied route
        # mutation (local proposals and raft-replicated ones alike) with
        # (tenant_id, filter_levels); (None, None) means "everything
        # changed" (reset-from-KV). DistWorker relays this to the
        # frontend's pub-side match cache.
        self.on_mutation = None
        # the replication outlets (delta_sink / anchor_sink, fed by the
        # matcher's on_delta / on_rebase hooks into the hosting worker's
        # per-range DeltaLog): ROADMAP A.9
        # per-range load profile (≈ KVLoadRecorder + FanoutSplitHinter
        # food): mutates record the route key, matches record the tenant
        # prefix weighted by fan-out (see DistWorker.match_batch)
        self.load_recorder = KVLoadRecorder()
        # (start, end) enforced at APPLY time by the hosting store: a split
        # committed between a client's range resolution and this entry's
        # apply moves the key out of this range — the mutation must bounce
        # (b"retry") so the caller re-resolves, never landing a key outside
        # the boundary (≈ KVRangeFSM boundary check on command apply)
        self.boundary = None
        # Fact: the ACTUAL stored key span [first, last] of this range
        # (≈ the reference's per-range Fact with first/last filter levels,
        # TenantRangeLookupCache.java:78-89): a range whose boundary
        # intersects a tenant's keyspace but whose real keys don't is
        # pruned from match fan-in. None = empty; "dirty" = rescan needed.
        self._fact = None
        self._fact_dirty = True
        self._fact_reader = None

    # ---------------- RW (≈ batchAddRoute / batchRemoveRoute) --------------

    def mutate(self, input_data: bytes, reader: IKVSpace,
               writer: KVWriteBatch) -> bytes:
        if input_data[0] == _OP_BATCH:
            # one raft entry, many route ops; per-op status so a boundary
            # bounce on one key doesn't poison its batch-mates. The overlay
            # makes earlier batch-mates' staged writes visible to later
            # incarnation-guard reads (KVWriteBatch only lands at done()).
            n = struct.unpack_from(">I", input_data, 1)[0]
            pos = 5
            statuses = bytearray(struct.pack(">I", n))
            overlay: dict = {}
            for _ in range(n):
                sub, pos = _read_frame(input_data, pos)
                st = self._mutate_one(sub, reader, writer, overlay)
                statuses += _frame(st)
            return bytes(statuses)
        return self._mutate_one(input_data, reader, writer, {})

    def _mutate_one(self, input_data: bytes, reader: IKVSpace,
                    writer: KVWriteBatch, overlay: dict) -> bytes:
        op = input_data[0]
        key, pos = _read_frame(input_data, 1)
        if self.boundary is not None:
            start, end = self.boundary
            if key < start or (end is not None and key >= end):
                return b"retry"
        value, pos = _read_frame(input_data, pos)
        self.load_recorder.record(key)
        tenant_id = _tenant_of_key(key)  # single source of truth: the key
        route = schema.decode_route(tenant_id, key, value)
        incarnation = route.incarnation

        def current(k: bytes):
            return overlay[k] if k in overlay else reader.get(k)

        if op == _OP_ADD:
            existing = current(key)
            if existing is not None:
                prev_inc = struct.unpack(">q", existing)[0]
                if prev_inc > incarnation:
                    return b"stale"  # incarnation guard
            writer.put(key, value)
            overlay[key] = value
            self.matcher.add_route(tenant_id, route)
            if not self._fact_dirty:    # widen the span in O(1)
                f = self._fact
                self._fact = ((min(f[0], key), max(f[1], key))
                              if f is not None else (key, key))
            self._fact_reader = reader
            self._notify_mutation(tenant_id, route.matcher.filter_levels)
            return b"ok" if existing is None else b"exists"
        if op == _OP_REMOVE:
            existing = current(key)
            if existing is None:
                return b"missing"
            prev_inc = struct.unpack(">q", existing)[0]
            if prev_inc > incarnation:
                return b"stale"
            writer.delete(key)
            overlay[key] = None
            self.matcher.remove_route(tenant_id, route.matcher,
                                      route.receiver_url, incarnation)
            if self._fact is not None and key in self._fact:
                self._fact_dirty = True     # span may shrink: lazy rescan
            self._fact_reader = reader
            self._notify_mutation(tenant_id, route.matcher.filter_levels)
            return b"ok"
        return b"bad_op"

    def _notify_mutation(self, tenant_id, filter_levels) -> None:
        # cache upkeep must not poison the apply
        _safe_hook(self.on_mutation, "route-mutation", tenant_id,
                   filter_levels)

    def fact(self) -> Optional[Tuple[bytes, bytes]]:
        """The stored [first, last] route-key span, or None when empty."""
        if self._fact_dirty:
            self._fact = None
            if self._fact_reader is not None:
                lo = schema.TAG_DIST
                hi = schema.prefix_end(schema.TAG_DIST)
                # two O(1) endpoint probes, not a full scan — this runs on
                # the match hot path after endpoint removals
                first = next(
                    (k for k, _v in self._fact_reader.iterate(lo, hi)),
                    None)
                if first is not None:
                    last = next(k for k, _v in self._fact_reader.iterate(
                        lo, hi, reverse=True))
                    self._fact = (first, last)
            self._fact_dirty = False
        return self._fact

    # ---------------- RO (≈ batchDist) -------------------------------------

    def query(self, input_data: bytes, reader: IKVSpace) -> bytes:
        op = input_data[0]
        if op != _OP_MATCH:
            return b""
        tenant_b, pos = _read_frame(input_data, 1)
        n = struct.unpack_from(">I", input_data, pos)[0]
        pos += 4
        topics: List[bytes] = []
        for _ in range(n):
            t, pos = _read_frame(input_data, pos)
            topics.append(bytes(t))     # wire bytes, no decode
        tenant_id = tenant_b.decode()
        # byte plane: raw topic strings through to the matcher
        results = self.matcher.match_batch(
            [(tenant_id, t) for t in topics])
        # full group fidelity on the wire (same codec as the RPC service)
        out = bytearray(struct.pack(">I", len(results)))
        for res in results:
            out += encode_matched(res)
        return bytes(out)

    # ---------------- reset (≈ DistWorkerCoProc.reset:283) -----------------

    def reset(self, reader: IKVSpace) -> None:
        """Rebuild the matcher (derived state) from the route keyspace."""
        self._fact_reader = reader
        self._fact_dirty = True
        # the old matcher is dropped, never drained: a batch in flight on
        # it keeps its own tables and result buffers alive until it
        # completes, and nothing reads the old matcher afterwards
        self.matcher = self.matcher.clone_empty()
        # anchoring the delta stream ("reset" rebase) and suppressing the
        # rebuild's per-op delta emission: ROADMAP A.9
        for key, value in reader.iterate(
                schema.TAG_DIST, schema.prefix_end(schema.TAG_DIST)):
            tenant_id = _tenant_of_key(key)
            self.matcher.add_route(
                tenant_id, schema.decode_route(tenant_id, key, value))
        # snapshot restore rewrote the world: wholesale invalidation
        # upstream (the rebuilt matcher starts with an empty cache)
        self._notify_mutation(None, None)


class DistWorker:
    """Hosts the dist route table on a multi-range replicated KV store and
    serves the broker's dist plane from it (≈ dist-worker role:
    DistWorker.java:48 hosting DistWorkerCoProc ranges on a
    BaseKVStoreServer, with split-driven elasticity).

    There is ONE route table and it lives on the replicated KV: mutations
    go through consensus on the range covering the route key (the route
    keyspace is order-preserving, so ranges split by key boundary —
    ``KVRangeStore``); matches union this replica's derived TorchMatchers
    across every range intersecting the tenant's keyspace (the reference's
    per-tenant boundary intersect in batchDist:515).

    Defaults give a single-voter, single-range in-process deployment (the
    standalone broker); a ``KVStoreBalanceController`` may split ranges as
    they grow.
    """

    def __init__(self, *, node_id: str = "local",
                 voters: Optional[List[str]] = None,
                 transport=None, engine=None,
                 tick_interval: float = 0.01,
                 split_threshold: Optional[int] = None,
                 load_split_threshold: Optional[float] = None,
                 merge_threshold: Optional[int] = None,
                 matcher_factory=None) -> None:
        from ..kv.engine import InMemKVEngine
        from ..kv.store import KVRangeStore
        from ..raft.transport import InMemTransport

        self.transport = (transport if transport is not None
                          else InMemTransport())
        self.engine = engine if engine is not None else InMemKVEngine()
        # matcher_factory backs every range's derived matcher (tests pass
        # lambda: TorchMatcher(device="cpu"); None builds TorchMatcher()
        # on the card)
        self.matcher_factory = matcher_factory
        # frontend invalidation outlet — every coproc relays its applied
        # route mutations here (see DistWorkerCoProc.on_mutation);
        # DistService subscribes its pub-side match cache, so mutations
        # REPLAYED from raft peers invalidate it too, not just local calls
        self.on_route_mutation = None
        # the per-worker replication hub (one DeltaLog per hosted range,
        # fed by the coproc apply stream): ROADMAP A.9

        def _mk_coproc(rid):
            cp = DistWorkerCoProc(matcher_factory() if matcher_factory
                                  else None)
            cp.on_mutation = self._relay_mutation
            return cp

        self.store = KVRangeStore(
            node_id, self.transport, self.engine,
            coproc_factory=_mk_coproc,
            member_nodes=voters or [node_id])
        self.tick_interval = tick_interval
        self._tick_task = None
        # mutations coalesce per range into ONE raft entry per flush
        # (≈ BatchMatchCall): consensus cost amortizes across the batch
        from ..scheduler.batcher import BatchCallScheduler
        self._mutation_scheduler = BatchCallScheduler(
            lambda rid: (lambda calls: self._propose_batch(rid, calls)),
            max_burst_latency=0.005,
            # consensus batches are pure throughput (one raft propose per
            # batch): never decay the cap toward idle between bursts
            shallow_decay=False)
        self.balance_controller = None
        balancers = []
        if split_threshold is not None:
            from ..kv.balance import RangeSplitBalancer
            balancers.append(RangeSplitBalancer(max_keys=split_threshold))
        if load_split_threshold is not None:
            from ..kv.load import LoadSplitBalancer
            balancers.append(LoadSplitBalancer(
                max_load_per_second=load_split_threshold))
        if merge_threshold is not None:
            from ..kv.balance import RangeMergeBalancer
            balancers.append(RangeMergeBalancer(
                min_keys=merge_threshold))
        if balancers:
            from ..kv.balance import KVStoreBalanceController
            self.balance_controller = KVStoreBalanceController(
                self.store, balancers)

    def _relay_mutation(self, tenant_id, filter_levels) -> None:
        cb = self.on_route_mutation
        if cb is not None:
            cb(tenant_id, filter_levels)

    @property
    def matcher(self) -> TorchMatcher:
        """Single-range introspection convenience; multi-range workers are
        inspected via ``store.describe()`` / per-range coprocs."""
        if len(self.store.ranges) != 1:
            raise RuntimeError("multiple ranges; use store.coprocs")
        return next(iter(self.store.coprocs.values())).matcher

    @property
    def space(self):
        """Legacy single-range space accessor (tests/introspection)."""
        if len(self.store.ranges) != 1:
            raise RuntimeError("multiple ranges; use store.ranges")
        return next(iter(self.store.ranges.values())).space

    def _iter_all_routes(self):
        for rid, r in self.store.ranges.items():
            for key, value in r.space.iterate(
                    schema.TAG_DIST, schema.prefix_end(schema.TAG_DIST)):
                tenant_id = _tenant_of_key(key)
                yield tenant_id, schema.decode_route(tenant_id, key, value)

    async def start(self) -> None:
        """Open/recover the range set, drive initial elections, start the
        tick loop (+ the balance controller when configured)."""
        import asyncio

        self.store.open()
        from ..raft.node import Role
        if self.store.member_nodes == [self.store.node_id]:
            # standalone: elect every range deterministically
            for _ in range(10_000):
                if all(r.raft.role == Role.LEADER
                       for r in self.store.ranges.values()):
                    break
                self.store.tick()
                self._pump()
        self._tick_task = asyncio.create_task(self._tick_loop())
        if self.balance_controller is not None:
            await self.balance_controller.start()

    async def stop(self) -> None:
        if self.balance_controller is not None:
            await self.balance_controller.stop()
        # graceful drain: give in-flight device batches a bounded
        # window to retire before the stores (and their matchers' base
        # tables) are torn down under them. Concurrent — the drains are
        # independent waits, and a wedged device must cost ONE timeout,
        # not one per hosted range.
        async def _drain(coproc) -> None:
            drain = getattr(coproc.matcher, "drain_device", None)
            if drain is not None:
                try:
                    await drain()
                except Exception:  # noqa: BLE001 — shutdown must proceed
                    logging.getLogger(__name__).exception("device drain")
        await asyncio.gather(*(_drain(c)
                               for c in list(self.store.coprocs.values())))
        if self._tick_task is not None:
            self._tick_task.cancel()
            try:
                await self._tick_task
            except BaseException:  # noqa: BLE001 — cancellation
                pass
            self._tick_task = None
        self.store.stop()

    def _pump(self) -> None:
        pump = getattr(self.transport, "pump", None)
        if pump is not None:
            pump()

    async def _tick_loop(self) -> None:
        import asyncio

        while True:
            self.store.tick()
            self._pump()
            await asyncio.sleep(self.tick_interval)

    # ---------------- dist plane API ---------------------------------------

    async def _mutate(self, key: bytes, payload: bytes, *,
                      timeout: float = 5.0) -> bytes:
        """Propose on the range covering ``key``, with a bounded wait for
        leadership (covers the initial-election window; follower replicas
        in multi-voter groups still raise after the timeout — leader
        forwarding rides the RPC fabric)."""
        import asyncio

        from ..raft.node import NotLeaderError

        deadline = _time.monotonic() + timeout
        while True:
            # re-resolve each attempt: a concurrent split may move the key
            rid = self.store.router.find_by_key(key)
            if rid is None:
                raise KeyError(f"no range covers key {key!r}")
            rng = self.store.ranges[rid]
            try:
                out = await self._mutation_scheduler.submit(rid, payload)
            except NotLeaderError:
                if (_time.monotonic() >= deadline
                        or rng.raft.leader_id not in (None, rng.raft.id)):
                    raise
                await asyncio.sleep(self.tick_interval)
                continue
            if out != b"retry":
                return out
            # a split moved the key out of this range between resolution
            # and apply: route again against the updated router
            if _time.monotonic() >= deadline:
                raise TimeoutError("range resolution kept racing splits")
            await asyncio.sleep(0)

    async def _propose_batch(self, rid: str, calls) -> List[bytes]:
        """One raft entry for a window of route ops on range ``rid``."""
        rng = self.store.ranges.get(rid)
        if rng is None:     # range retired (merge) between submit and flush
            return [b"retry"] * len(calls)
        if len(calls) == 1:
            return [await rng.mutate_coproc(calls[0])]
        out = await rng.mutate_coproc(encode_batch(calls))
        if out == b"retry":     # sealed range bounces the whole batch
            return [b"retry"] * len(calls)
        return decode_batch_reply(out)

    async def add_route(self, tenant_id: str, route: Route) -> str:
        key = schema.route_key(tenant_id, route.matcher, route.receiver_url)
        out = await self._mutate(key, encode_add_route(tenant_id, route))
        return out.decode()

    async def remove_route(self, tenant_id: str, matcher: RouteMatcher,
                           receiver_url: Tuple[int, str, str],
                           incarnation: int = 0) -> str:
        key = schema.route_key(tenant_id, matcher, receiver_url)
        out = await self._mutate(
            key, encode_remove_route(tenant_id, matcher, receiver_url,
                                     incarnation))
        return out.decode()

    async def purge_broker_routes(self, broker_id: int,
                                  deliverer_prefix: str = "") -> int:
        """Remove every route targeting ``broker_id`` receivers whose
        deliverer key starts with ``deliverer_prefix`` — across all ranges.

        Crash-recovery sweep: transient-session routes written through to a
        durable route keyspace must not resurrect after an unclean restart
        (their sessions are gone). The prefix scopes the sweep to ONE
        frontend instance's routes so co-tenant frontends sharing a worker
        are untouched. The reference reaps these via the dist GC +
        checkSubscriptions purge (DistWorkerCoProc.gc:554)."""
        doomed = [(t, r) for t, r in self._iter_all_routes()
                  if r.broker_id == broker_id
                  and r.deliverer_key.startswith(deliverer_prefix)]
        for tenant_id, route in doomed:
            key = schema.route_key(tenant_id, route.matcher,
                                   route.receiver_url)
            await self._mutate(key, encode_remove_route(
                tenant_id, route.matcher, route.receiver_url,
                route.incarnation))
        return len(doomed)

    # ---------------- graceful degradation ---------------------------------

    # called with (n_queries, reason) whenever a range's match is served
    # from the host oracle; DistService hooks this to emit MATCH_DEGRADED
    # events (the worker itself stays event-plumbing-free)
    on_degraded = None

    async def _match_on_range(self, coproc, sub, max_persistent_fanout,
                              max_group_fanout, deadline):
        """One range's match dispatch behind the failure boundary: an
        injected matcher fault or an exhausted deadline budget serves the
        HOST-ORACLE fallback — the matcher's authoritative per-tenant
        tries, exact by construction — instead of failing the publish.

        Routes through the matcher's ASYNC pipeline when it has one — the
        device walk dispatches, the event loop keeps serving (the next
        batch tokenizes + dispatches in the gap), and the fetch happens on
        readiness.

        A kernel that refuses to launch or a kernel wrapper's argument
        check (``_PROGRAM_FAULTS``) is a fault of the program: it is
        raised to the caller, never served around, as the matcher's own
        legs do; device faults the matcher absorbs (breaker, watchdog,
        device error) arrive as ``stats["degraded"]``."""
        t0 = _time.perf_counter()
        try:
            get_injector().check_raise("matcher", "tpu-matcher", "match")
            if deadline is not None and _time.monotonic() >= deadline:
                raise TimeoutError("match deadline budget exhausted")
            stats: dict = {}
            # the "match.device" span and its cache tags: ROADMAP A.10
            amatch = getattr(coproc.matcher, "match_batch_async", None)
            if amatch is not None:
                out = await amatch(
                    sub, max_persistent_fanout=max_persistent_fanout,
                    max_group_fanout=max_group_fanout, stats=stats)
            else:
                out = coproc.matcher.match_batch(
                    sub, max_persistent_fanout=max_persistent_fanout,
                    max_group_fanout=max_group_fanout)
            # the matcher absorbs device faults internally (breaker open /
            # watchdog timeout / device error all serve its host oracle
            # without raising) and reports the reason via stats — relay it
            # to the event plane so MATCH_DEGRADED still fires for
            # operators. FABRIC counters were already bumped at the
            # matcher; only the event outlet lives up here.
            if stats.get("degraded"):
                cb = self.on_degraded
                if cb is not None:
                    cb(len(sub), f"device:{stats['degraded']}")
            # overlapped pipeline: the outer wall clock also counts
            # ring-acquire waits and CONCURRENT batches' host work, so the
            # "device" stage uses the matcher-reported per-batch time
            # (this batch's cache probe + dispatch+ready+fetch + expand);
            # the sync fallback keeps wall time, which there IS that span
            dt = stats.get("device_s", _time.perf_counter() - t0)
            STAGES.record("device", dt)
            # per-tenant device-time attribution (OBS): ROADMAP A.10
            return out
        except (asyncio.CancelledError, *_PROGRAM_FAULTS):
            raise
        except Exception as e:  # noqa: BLE001 — degrade, don't fail
            oracle = getattr(coproc.matcher, "match_from_tries", None)
            if oracle is None:
                raise       # no authoritative host state: nothing to serve
            FABRIC.inc(FabricMetric.MATCH_DEGRADED, len(sub))
            logging.getLogger(__name__).warning(
                "match degraded to host oracle (%d queries): %r",
                len(sub), e)
            cb = self.on_degraded
            if cb is not None:
                cb(len(sub), repr(e))
            # the "match.degraded" span: ROADMAP A.10
            out = oracle(sub,
                         max_persistent_fanout=max_persistent_fanout,
                         max_group_fanout=max_group_fanout)
            STAGES.record("device", _time.perf_counter() - t0)
            return out

    async def match_batch(self, queries, *, max_persistent_fanout,
                          max_group_fanout, linearized: bool = False,
                          deadline: Optional[float] = None):
        """Serve matches from this replica's derived matchers, unioning
        across every range whose boundary intersects the query tenant's
        keyspace (per-tenant boundary intersect ≈ batchDist:515).

        ``linearized=True`` adds a read-index barrier per touched range
        (leader only); the pub hot path uses the default local read.

        ``deadline`` (absolute ``time.monotonic()``; defaults to the
        propagated RPC deadline budget) is checked at each range's
        dispatch boundary: an already-exhausted budget (or a raising
        device path) degrades that range to the host oracle rather than
        timing the publish out. A device call that STALLS mid-dispatch is
        not preempted — remote hops surface that through the RPC-level
        per-attempt timeout instead."""
        from ..models.oracle import PERSISTENT_SUB_BROKER_ID

        if deadline is None:
            deadline = current_deadline()

        # resolve the range set per tenant once; each range walks ONLY the
        # queries whose tenant keyspace intersects it
        tenant_ranges = {}
        for tenant_id, _levels in queries:
            if tenant_id not in tenant_ranges:
                pfx = schema.tenant_route_prefix(tenant_id)
                pfx_end = schema.prefix_end(pfx)
                rids = self.store.router.intersecting(pfx, pfx_end)
                # Fact pruning (≈ TenantRangeLookupCache first/last-key
                # filtering): drop ranges whose ACTUAL stored key span
                # doesn't touch the tenant's keyspace — a boundary can
                # cover a tenant the range holds no routes for
                pruned = []
                for rid in rids:
                    fact_fn = getattr(self.store.coprocs[rid], "fact",
                                      None)
                    if fact_fn is not None:
                        span = fact_fn()
                        if span is None or span[1] < pfx \
                                or span[0] >= pfx_end:
                            continue
                    pruned.append(rid)
                tenant_ranges[tenant_id] = pruned
        range_queries = {}      # rid -> [query index]
        for qi, (tenant_id, _levels) in enumerate(queries):
            for rid in tenant_ranges[tenant_id]:
                range_queries.setdefault(rid, []).append(qi)
        if linearized:
            for rid in range_queries:
                await self.store.ranges[rid].raft.read_index()
        per_query = {}          # (rid, qi) -> MatchedRoutes
        for rid, idxs in range_queries.items():
            sub = [queries[qi] for qi in idxs]
            coproc = self.store.coprocs[rid]
            res = await self._match_on_range(coproc, sub,
                                             max_persistent_fanout,
                                             max_group_fanout, deadline)
            rec = getattr(coproc, "load_recorder", None)
            for qi, m in zip(idxs, res):
                per_query[(rid, qi)] = m
                if rec is not None:
                    # fan-out-weighted query load on the tenant's keyspan
                    # (≈ FanoutSplitHinter weighing by matched routes)
                    rec.record(
                        schema.tenant_route_prefix(queries[qi][0]),
                        cost=1 + len(m.normal) + len(m.groups))
        results = []
        for qi, (tenant_id, _levels) in enumerate(queries):
            rids = tenant_ranges[tenant_id]
            if len(rids) == 1:
                results.append(per_query[(rids[0], qi)])
                continue
            # union across ranges, then RE-APPLY the per-tenant caps — each
            # range enforced them locally, the tenant limit is global
            normal, groups = [], {}
            for rid in rids:
                m = per_query[(rid, qi)]
                normal.extend(m.normal)
                for f, members in m.groups.items():
                    groups.setdefault(f, []).extend(members)
            merged = MatchedRoutes()
            for r in normal:
                if r.broker_id == PERSISTENT_SUB_BROKER_ID:
                    if merged.persistent_fanout >= max_persistent_fanout:
                        merged.max_persistent_fanout_exceeded = True
                        continue
                    merged.persistent_fanout += 1
                merged.normal.append(r)
            for f, members in groups.items():
                if len(merged.groups) >= max_group_fanout:
                    merged.max_group_fanout_exceeded = True
                    continue
                merged.groups[f] = members
            results.append(merged)
        return results
