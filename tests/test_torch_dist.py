"""Port parity: the dist plane (``DistService`` → per-tenant batcher → pub
match cache → ``DistWorker.match_batch`` → ``match_batch_async`` →
fan-out to sub-brokers) of ``bifromq_tpu_torch`` against the reference.

The same seeded route set (about 200 routes in 3 tenants: wildcards,
``$share`` and ``$oshare`` groups, persistent routes past
``MaxPersistentFanout`` and ``MaxPersistentFanoutBytes``, receivers the
persistent sub-broker answers ``NO_SUB`` for, stale incarnations) goes
through consensus into the reference ``DistService`` (its default
``TpuMatcher`` on the JAX CPU backend, as ``tests/test_chaos_fabric.py``
runs it) and the port's (``TorchMatcher(device="cpu")``). Seeded
publishes, one at a time and then in gathered windows, must give equal
``PubResult`` lists, equal delivered ``(tenant, broker, deliverer_key,
receiver, incarnation, payload)`` lists in order, equal events in order
and, after the dead-route cleanup, byte-identical route keyspaces.
Tolerance: exact equality.

Then the pub cache plane (``tests/test_match_cache.py``
``TestServiceCachePlane`` and the TTL tests), the forced matcher fault
(``tests/test_chaos_fabric.py``) and the port's program-fault boundary:
a kernel that refuses to launch, or a kernel wrapper's argument check,
fails the publish with a ``DIST_ERROR`` event instead of degrading.
"""

import asyncio
import importlib
import random

import pytest

from bifromq_tpu_torch.dist.service import DistService
from bifromq_tpu_torch.dist.worker import DistWorker
from bifromq_tpu_torch.models.matchcache import TenantMatchCache
from bifromq_tpu_torch.models.matcher import TorchMatcher
from bifromq_tpu_torch.models.oracle import Route
from bifromq_tpu_torch.plugin.events import (CollectingEventCollector,
                                             EventType)
from bifromq_tpu_torch.plugin.settings import DefaultSettingProvider
from bifromq_tpu_torch.plugin.subbroker import (DeliveryResult, ISubBroker,
                                                SubBrokerRegistry)
from bifromq_tpu_torch.resilience.faults import get_injector
from bifromq_tpu_torch.types import ClientInfo, Message, QoS, RouteMatcher
from bifromq_tpu_torch.utils.device import KernelLaunchError
from bifromq_tpu_torch.utils.metrics import FABRIC, FabricMetric

REF, PORT = "bifromq_tpu", "bifromq_tpu_torch"
UNCAPPED = (2 ** 31 - 1, 2 ** 31 - 1)
LEVELS = ("a", "b", "c", "d")
TENANTS = ("T0", "T1", "T2")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


class CollectingBroker:
    """A sub-broker of either package: records every OK delivery and
    answers ``NO_SUB`` for receivers named ``dead*``."""

    def __init__(self, pkg: str, broker_id: int, log: list) -> None:
        self.id = broker_id
        self._result = _mod(pkg, "plugin.subbroker").DeliveryResult
        self.log = log

    async def deliver(self, tenant_id, deliverer_key, packs):
        out = {}
        for dp in packs:
            for mi in dp.match_infos:
                if mi.receiver_id.startswith("dead"):
                    out[mi] = self._result.NO_SUB
                    continue
                for pmp in dp.message_pack.packs:
                    for m in pmp.messages:
                        self.log.append((tenant_id, self.id, deliverer_key,
                                         mi.receiver_id, mi.incarnation,
                                         bytes(m.payload)))
                out[mi] = self._result.OK
        return out

    async def check_subscriptions(self, tenant_id, match_infos):
        return [not mi.receiver_id.startswith("dead") for mi in match_infos]


def _service(pkg: str):
    """A started-ready DistService of ``pkg`` over a one-range worker,
    with the tenants' fan-out caps set so every cap trips."""
    settings = _mod(pkg, "plugin.settings")
    S = settings.Setting
    log: list = []
    reg = _mod(pkg, "plugin.subbroker").SubBrokerRegistry()
    for b in (0, 1):
        reg.register(CollectingBroker(pkg, b, log))
    events = _mod(pkg, "plugin.events").CollectingEventCollector()
    provider = settings.DefaultSettingProvider({
        "T1": {S.MaxPersistentFanout: 3, S.MaxGroupFanout: 2},
        "T2": {S.MaxPersistentFanoutBytes: 20}})
    kw = {}
    if pkg == PORT:
        kw["matcher_factory"] = lambda: TorchMatcher(device="cpu")
    worker = _mod(pkg, "dist.worker").DistWorker(**kw)
    svc = _mod(pkg, "dist.service").DistService(
        reg, events, provider, worker=worker, rng_seed=7)
    return svc, log, events


def _filter(rng: random.Random) -> str:
    lv = ["+" if rng.random() < 0.2 else rng.choice(LEVELS)
          for _ in range(rng.randint(1, 3))]
    if rng.random() < 0.15:
        lv.append("#")
    return "/".join(lv)


def route_ops(seed: int = 0, n: int = 200):
    """(tenant, topic filter, broker, receiver, deliverer key,
    incarnation), seeded; some repeat a route at a lower incarnation."""
    rng = random.Random(seed)
    ops = []
    for i in range(n):
        tf = _filter(rng)
        r = rng.random()
        if r < 0.15:
            tf = f"$share/g{rng.randint(0, 2)}/{tf}"
        elif r < 0.25:
            tf = f"$oshare/g{rng.randint(0, 2)}/{tf}"
        recv = f"dead{i}" if rng.random() < 0.05 else f"r{i}"
        op = (TENANTS[i % 3], tf, 1 if rng.random() < 0.35 else 0, recv,
              f"d{rng.randint(0, 4)}", rng.randint(1, 3))
        ops.append(op)
        if rng.random() < 0.05:
            ops.append(op[:5] + (0,))       # stale: a lower incarnation
    return ops


def publishes(seed: int = 1, n: int = 96):
    rng = random.Random(seed)
    return [(TENANTS[rng.randrange(3)],
             "/".join(rng.choice(LEVELS) for _ in range(rng.randint(1, 4))))
            for _ in range(n)]


async def _drive(pkg: str, pubs_seq, pubs_win, window: int):
    types = _mod(pkg, "types")
    svc, log, events = _service(pkg)
    await svc.start()
    try:
        oks = []
        for tenant, tf, broker, recv, dkey, inc in route_ops():
            oks.append(await svc.match(
                tenant, types.RouteMatcher.from_topic_filter(tf), broker,
                recv, dkey, inc))

        def pub(i, tenant, topic):
            msg = types.Message(message_id=i,
                                pub_qos=types.QoS.AT_LEAST_ONCE,
                                payload=f"m{i:0{4 + i % 5}d}".encode(),
                                timestamp=i)
            return svc.pub(types.ClientInfo(tenant_id=tenant), topic, msg)

        results = [await pub(i, t, topic)
                   for i, (t, topic) in enumerate(pubs_seq)]
        n_log, n_ev = len(log), len(events.events)
        n_kv = len(svc.worker.space)
        # the dist GC sweeps the dead routes the cleanup has not reached
        # (those the caps kept from delivery): a route removed between
        # two batches of one window would make the caps' flags depend on
        # where the adaptive cap cut the window
        swept = await svc.gc_sweep()
        base = len(pubs_seq)
        for w in range(0, len(pubs_win), window):
            results += await asyncio.gather(*(
                pub(base + w + j, t, topic)
                for j, (t, topic) in enumerate(pubs_win[w:w + window])))
        ev = [(e.type.value, e.tenant_id, e.meta) for e in events.events]
        return {"match": oks, "swept": swept, "n_kv": n_kv,
                "results": [(r.ok, r.fanout, r.error) for r in results],
                "delivered": log[:n_log], "events": ev[:n_ev],
                # the windows: each tenant's batcher fans its publishes
                # out in submission order, the tenants' batchers
                # interleave as the event loop schedules them
                "delivered_win": {t: [d for d in log[n_log:] if d[0] == t]
                                  for t in TENANTS},
                "events_win": {t: [e for e in ev[n_ev:] if e[1] == t]
                               for t in TENANTS},
                "kv": list(svc.worker.space.iterate())}
    finally:
        await svc.stop()


async def test_dist_service_parity_with_reference(monkeypatch):
    # one pub batch in flight per tenant: a window's publishes of one
    # tenant then fan out in submission order on both sides, whatever
    # batches the adaptive cap cuts, so delivery order and $share
    # elections compare
    monkeypatch.setenv("BIFROMQ_PIPELINE_DEPTH", "1")
    # the watchdog at its ceiling: a loaded test host must not time a
    # batch out on one side only (a degraded batch is exact, but its
    # MATCH_DEGRADED event would differ)
    monkeypatch.setenv("BIFROMQ_DEVICE_DEADLINE_S", "30")
    pubs = publishes()
    ref = await _drive(REF, pubs[:48], pubs[48:], window=16)
    port = await _drive(PORT, pubs[:48], pubs[48:], window=16)
    assert port["match"] == ref["match"]
    assert False in ref["match"]                # a stale incarnation
    assert port["n_kv"] == ref["n_kv"]
    assert port["swept"] == ref["swept"] > 0
    assert port["results"] == ref["results"]
    assert port["delivered"] == ref["delivered"]
    assert port["events"] == ref["events"]
    assert port["delivered_win"] == ref["delivered_win"]
    assert port["events_win"] == ref["events_win"]
    assert all(ref["delivered_win"].values())
    assert port["kv"] == ref["kv"]
    seen = {e[0] for e in ref["events"]} | {
        e[0] for evs in ref["events_win"].values() for e in evs}
    for t in (EventType.PERSISTENT_FANOUT_THROTTLED,
              EventType.GROUP_FANOUT_THROTTLED,
              EventType.PERSISTENT_FANOUT_BYTES_THROTTLED,
              EventType.DISTED, EventType.MATCHED, EventType.MATCH_ERROR):
        assert t.value in seen, t
    # the dead-route cleanup ran: NO_SUB receivers left the keyspace
    # before the sweep took the rest
    assert ref["n_kv"] < sum(ref["match"])
    # both sub-brokers were delivered to
    assert {d[1] for d in ref["delivered"]} == {0, 1}


# ---- helpers for the port-only tests below ---------------------------------

def mk_route(tf, receiver, inc=0, broker=0):
    return Route(matcher=RouteMatcher.from_topic_filter(tf),
                 broker_id=broker, receiver_id=receiver, deliverer_key="d0",
                 incarnation=inc)


class CaptureBroker(ISubBroker):
    """Transient sub-broker recording every (receiver, payload)."""

    id = 0

    def __init__(self):
        self.delivered = []

    async def deliver(self, tenant_id, deliverer_key, packs):
        out = {}
        for dp in packs:
            for mi in dp.match_infos:
                for pmp in dp.message_pack.packs:
                    for m in pmp.messages:
                        self.delivered.append((mi.receiver_id,
                                               bytes(m.payload)))
                out[mi] = DeliveryResult.OK
        return out

    async def check_subscriptions(self, tenant_id, match_infos):
        return [True] * len(match_infos)


def port_service(brokers=None, events=None):
    return DistService(
        brokers or SubBrokerRegistry(), events or CollectingEventCollector(),
        DefaultSettingProvider(),
        worker=DistWorker(matcher_factory=lambda: TorchMatcher(
            device="cpu")))


def _msg(i):
    return Message(message_id=i, pub_qos=QoS.AT_MOST_ONCE,
                   payload=f"m{i}".encode(), timestamp=i)


@pytest.fixture
def injector():
    get_injector().reset(seed=1234)
    yield get_injector()
    get_injector().reset()


class TestServiceCachePlane:
    async def test_replayed_mutation_invalidates_pub_cache(self):
        """A mutation applied through the WORKER (never passing this
        service's match/unmatch — the replayed-mutation path) must
        invalidate the pub-side cache via the apply-stream hook, not
        wait out the TTL."""
        svc = port_service()
        svc._match_cache.ttl_s = 3600.0
        await svc.start()
        try:
            pub = ClientInfo(tenant_id="T", type="test")
            msg = Message(message_id=1, pub_qos=QoS.AT_MOST_ONCE,
                          payload=b"x", timestamp=0)
            r = await svc.pub(pub, "a/b", msg)
            assert r.fanout == 0
            assert len(svc._match_cache) >= 1
            assert await svc.worker.add_route(
                "T", mk_route("a/b", "r1", broker=7)) == "ok"
            before = svc._match_cache.misses
            await svc.pub(pub, "a/b", msg)
            assert svc._match_cache.misses > before, \
                "stale pub-cache entry served after a replayed mutation"
        finally:
            await svc.stop()

    async def test_reset_from_kv_bumps_pub_cache(self):
        svc = port_service()
        await svc.start()
        try:
            c = svc._match_cache
            c.put("T", "a/b", UNCAPPED, "m", c.token("T"))
            svc._on_route_mutation(None, None)   # ≈ coproc reset relay
            assert c.get("T", "a/b", UNCAPPED) is None
        finally:
            await svc.stop()

    def test_ttl_expiry_with_injected_clock(self):
        now = [0.0]
        c = TenantMatchCache(ttl_s=1.0, clock=lambda: now[0])
        c.put("T", ("x",), UNCAPPED, "m", c.token("T"))
        assert c.get("T", ("x",), UNCAPPED) == "m"
        now[0] = 1.5
        assert c.get("T", ("x",), UNCAPPED) is None

    def test_ttl_zero_disables_serving_and_is_live(self):
        c = TenantMatchCache(ttl_s=None)
        c.put("T", ("x",), UNCAPPED, "m", c.token("T"))
        assert c.get("T", ("x",), UNCAPPED) == "m"
        c.ttl_s = 0.0
        c.put("T", ("x",), UNCAPPED, "m", c.token("T"))
        assert c.get("T", ("x",), UNCAPPED) is None

    async def test_pub_cache_ttl_is_a_live_service_knob(self):
        svc = port_service()
        assert svc.MATCH_CACHE_TTL == 1.0
        svc.MATCH_CACHE_TTL = 0.0
        await svc.start()
        try:
            pub = ClientInfo(tenant_id="T")
            await svc.pub(pub, "a/b", _msg(1))
            hits = svc._match_cache.hits
            await svc.pub(pub, "a/b", _msg(2))
            assert svc._match_cache.hits == hits
        finally:
            await svc.stop()


class TestFailureBoundary:
    async def test_forced_matcher_fault_degrades_end_to_end(self, injector):
        """An injected matcher fault during a live publish serves correct
        fan-out via the host oracle, increments match_degraded_total, and
        emits MATCH_DEGRADED — the publish itself succeeds."""
        capture = CaptureBroker()
        brokers = SubBrokerRegistry()
        brokers.register(capture)
        events = CollectingEventCollector()
        svc = port_service(brokers, events)
        svc.MATCH_CACHE_TTL = 0.0
        await svc.start()
        try:
            await svc.match("T", RouteMatcher.from_topic_filter("d/+"),
                            0, "r1", "d0")
            await svc.match("T", RouteMatcher.from_topic_filter("d/x"),
                            0, "r2", "d0")
            base = FABRIC.get(FabricMetric.MATCH_DEGRADED)
            injector.add_rule(service="tpu-matcher", action="error",
                              max_hits=1)
            res = await svc.pub(ClientInfo(tenant_id="T"), "d/x", _msg(1))
            assert res.ok and res.fanout == 2
            assert sorted(capture.delivered) == [("r1", b"m1"),
                                                 ("r2", b"m1")]
            assert FABRIC.get(FabricMetric.MATCH_DEGRADED) == base + 1
            assert events.of(EventType.MATCH_DEGRADED)
            # device path back: next publish identical fan-out, undegraded
            res2 = await svc.pub(ClientInfo(tenant_id="T"), "d/x", _msg(2))
            assert res2.ok and res2.fanout == 2
            assert FABRIC.get(FabricMetric.MATCH_DEGRADED) == base + 1
        finally:
            await svc.stop()

    async def test_exhausted_deadline_degrades_exactly(self):
        capture = CaptureBroker()
        brokers = SubBrokerRegistry()
        brokers.register(capture)
        events = CollectingEventCollector()
        svc = port_service(brokers, events)
        svc.MATCH_DEADLINE_S = 0.0
        await svc.start()
        try:
            await svc.match("T", RouteMatcher.from_topic_filter("d/#"),
                            0, "r1", "d0")
            base = FABRIC.get(FabricMetric.MATCH_DEGRADED)
            res = await svc.pub(ClientInfo(tenant_id="T"), "d/x", _msg(1))
            assert res.ok and res.fanout == 1
            assert FABRIC.get(FabricMetric.MATCH_DEGRADED) == base + 1
            ev = events.of(EventType.MATCH_DEGRADED)
            assert ev and "deadline" in ev[-1].meta["reason"]
        finally:
            await svc.stop()

    @pytest.mark.parametrize("fault", ["launch", "argument"])
    async def test_program_fault_fails_the_publish(self, monkeypatch,
                                                   fault):
        """A kernel that refuses to launch (``KernelLaunchError``) or a
        kernel wrapper's argument check (``ValueError``) propagates out of
        ``DistWorker._match_on_range``: the publish fails with a
        DIST_ERROR event and nothing is served from the oracle."""
        import torch
        from bifromq_tpu_torch.models.kernels import FUSED_WALK
        from bifromq_tpu_torch.utils.device import check_cuda

        capture = CaptureBroker()
        brokers = SubBrokerRegistry()
        brokers.register(capture)
        events = CollectingEventCollector()
        svc = port_service(brokers, events)
        await svc.start()
        try:
            await svc.match("T", RouteMatcher.from_topic_filter("d/+"),
                            0, "r1", "d0")
            m = svc.worker.matcher
            real = m._walk_primary
            if fault == "launch":
                monkeypatch.setattr(FUSED_WALK, "_fn", lambda *a: 1)

                def walk(probes, ct):
                    FUSED_WALK.launch(0)        # cudaErrorInvalidValue
                    return real(probes, ct)
                err = KernelLaunchError
            else:
                def walk(probes, ct):
                    check_cuda("tok_h1", probes.tok_h1, torch.int32)
                    return real(probes, ct)
                err = ValueError
            m._walk_primary = walk
            base = FABRIC.get(FabricMetric.MATCH_DEGRADED)
            with pytest.raises(err):
                await svc.pub(ClientInfo(tenant_id="T"), "d/x", _msg(1))
            assert FABRIC.get(FabricMetric.MATCH_DEGRADED) == base
            assert not events.of(EventType.MATCH_DEGRADED)
            assert [e.meta for e in events.of(EventType.DIST_ERROR)] == \
                [{"topics": 1}]
            assert capture.delivered == []
            # the program repaired, the same publish serves on the device
            m._walk_primary = real
            res = await svc.pub(ClientInfo(tenant_id="T"), "d/x", _msg(2))
            assert res.ok and res.fanout == 1
        finally:
            await svc.stop()
