"""Port parity: the retained service plane against the reference.

The port's ``RetainService`` (consensus on the replicated retain range,
``RetainCoProc`` patching the range's ``RetainedIndex``, the per-range
``RetainedScanPlane`` and its result cache) takes the same sequences as
the JAX package's, on the CPU: the port's index template is
``RetainedIndex(device="cpu")``, so every range index runs the plain
PyTorch versions. Tolerance: exact equality throughout. Hits are equal in
order (topic and every field of the message), and so are the reported
events, ``topic_count`` and the raw KV bytes of every retain range.

The scan plane's cases mirror the reference's ``TestScanPlane`` and hold
the port's failure boundary: a watchdog timeout, an injected fault, an
open breaker and a canary parity miss serve the host oracle; a fault of
the program (``models/matcher._PROGRAM_FAULTS``) propagates. Where no
reference device scan is needed, rows are held against the host oracle,
so the reference compiles few walk shapes.
"""

import asyncio
import dataclasses
import random

import pytest
import torch

from bifromq_tpu.kv.engine import InMemKVEngine as JEngine
from bifromq_tpu.models import retained as jret
from bifromq_tpu.plugin import events as jev
from bifromq_tpu.plugin.throttler import IResourceThrottler as JThrottler
from bifromq_tpu.plugin.throttler import TenantResourceType as JRes
from bifromq_tpu.retain import coproc as jcoproc
from bifromq_tpu.retain.service import RetainService as JService
from bifromq_tpu.retained_plane import RetainedScanPlane as JPlane
from bifromq_tpu import types as jtypes
from bifromq_tpu_torch.kv.engine import InMemKVEngine
from bifromq_tpu_torch.models import retained as tret
from bifromq_tpu_torch.models.matcher import _PROGRAM_FAULTS
from bifromq_tpu_torch.plugin import events as tev
from bifromq_tpu_torch.plugin.throttler import (IResourceThrottler,
                                                TenantResourceType)
from bifromq_tpu_torch.resilience.device import DeviceTimeoutError
from bifromq_tpu_torch.resilience.faults import get_injector
from bifromq_tpu_torch.retain import coproc as tcoproc
from bifromq_tpu_torch.retain.service import RetainService
from bifromq_tpu_torch.retained_plane import (RetainedScanCache,
                                              RetainedScanPlane)
from bifromq_tpu_torch import types as ttypes
from bifromq_tpu_torch.utils import topic as t

NEVER = 0xFFFFFFFF


def msgs(payload=b"x", expiry=NEVER, mid=0):
    """The same retained message in both packages' types."""
    kw = dict(message_id=mid, payload=payload, timestamp=7,
              expiry_seconds=expiry, is_retain=True,
              user_properties=(("k", "v"),))
    return (jtypes.Message(pub_qos=jtypes.QoS.AT_LEAST_ONCE, **kw),
            ttypes.Message(pub_qos=ttypes.QoS.AT_LEAST_ONCE, **kw))


def canon_msg(m):
    return tuple(int(v) if f.name == "pub_qos" else v
                 for f, v in ((f, getattr(m, f.name))
                              for f in dataclasses.fields(m)))


def canon_hits(rows):
    return [[(topic, canon_msg(m)) for topic, m in row] for row in rows]


def retain_spaces(engine):
    return {name: list(sp.iterate())
            for name, sp in sorted(engine.spaces().items())
            if name.startswith("retain_range")}


class Both:
    """The reference's and the port's RetainService over their own
    engines, driven with the same calls."""

    def __init__(self, *, engines=None, clock=None, quota=None,
                 index=None, **kw):
        self.jev = jev.CollectingEventCollector()
        self.tev = tev.CollectingEventCollector()
        self.jeng, self.teng = engines or (JEngine(), InMemKVEngine())
        if clock is not None:
            kw["clock"] = clock
        jkw, tkw = dict(kw), dict(kw)
        if quota is not None:
            jkw["throttler"], tkw["throttler"] = quota(self)
        self.j = JService(self.jev, engine=self.jeng, **jkw)
        self.p = RetainService(
            self.tev, engine=self.teng,
            index=index or tret.RetainedIndex(device="cpu"), **tkw)

    async def retain(self, topic, payload=b"x", expiry=NEVER, tenant="T",
                     mid=0):
        jm, tm = msgs(payload, expiry, mid)
        a = await self.j.retain(jtypes.ClientInfo(tenant_id=tenant), topic,
                                jm)
        b = await self.p.retain(ttypes.ClientInfo(tenant_id=tenant), topic,
                                tm)
        assert a == b
        return b

    async def match_batch(self, queries, limit):
        want = await self.j.match_batch(queries, limit)
        got = await self.p.match_batch(queries, limit)
        assert canon_hits(got) == canon_hits(want)
        return got

    async def match(self, tenant, filt, limit=10):
        return (await self.match_batch([(tenant, t.parse(filt))],
                                       limit))[0]

    def check(self, tenants=("T",)):
        """Events, topic counts and raw KV bytes equal."""
        assert [(e.type.value, e.tenant_id, e.meta) for e in self.tev.events] \
            == [(e.type.value, e.tenant_id, e.meta) for e in self.jev.events]
        for tn in tenants:
            assert self.p.topic_count(tn) == self.j.topic_count(tn)
            assert self.p.topics(tn) == self.j.topics(tn)
        assert retain_spaces(self.teng) == retain_spaces(self.jeng)

    async def stop(self):
        await self.j.stop()
        await self.p.stop()


# ------------------------------------------- TestRetainService, both ways

class TestRetainServiceParity:
    async def test_retain_and_match(self):
        b = Both()
        await b.retain("a/b", b"v1")
        hits = await b.match("T", "a/+")
        assert [(h[0], h[1].payload) for h in hits] == [("a/b", b"v1")]
        b.check()
        await b.stop()

    async def test_replace(self):
        b = Both()
        await b.retain("a", b"v1")
        await b.retain("a", b"v2", mid=2)
        hits = await b.match("T", "a")
        assert hits[0][1].payload == b"v2"
        assert b.p.topic_count("T") == 1
        b.check()
        await b.stop()

    async def test_empty_payload_clears(self):
        b = Both()
        await b.retain("a", b"v1")
        await b.retain("a", b"")
        await b.retain("never/set", b"")    # a clear of nothing: no event
        assert await b.match("T", "a") == []
        assert b.tev.of(tev.EventType.RETAIN_MSG_CLEARED)
        b.check()
        await b.stop()

    async def test_limit(self):
        b = Both()
        for i in range(20):
            await b.retain(f"l/{i}", b"p%d" % i, mid=i)
        hits = await b.match("T", "l/+", limit=5)
        assert len(hits) == 5
        await b.match("T", "#", limit=100)
        await b.match_batch([("T", ["l", "+"]), ("T", ["#"]),
                             ("T", ["l", "1"])], 3)
        b.check()
        await b.stop()

    async def test_expiry(self):
        now = [1000.0]
        b = Both(clock=lambda: now[0])
        await b.retain("exp", expiry=10)
        await b.retain("keep")
        assert len(await b.match("T", "#")) == 2
        now[0] = 1011.0
        hits = await b.match("T", "#")
        assert [h[0] for h in hits] == ["keep"]
        assert b.p.topic_count("T") == 1  # lazily expired
        b.check()
        await b.stop()

    async def test_gc(self):
        now = [0.0]
        b = Both(clock=lambda: now[0])
        for i in range(5):
            await b.retain(f"g/{i}", expiry=5)
        await b.retain("g/keep")
        now[0] = 100.0
        assert await b.p.gc() == await b.j.gc() == 5
        assert b.p.topic_count("T") == 1
        await b.match("T", "g/#")
        b.check()
        await b.stop()

    async def test_quota(self):
        def quota(both):
            class OneTopicOnly(JThrottler):
                def has_resource(self, tenant_id, rtype):
                    if rtype == JRes.TOTAL_RETAIN_TOPICS:
                        return both.j.topic_count(tenant_id) < 1
                    return True

            class PortOneTopicOnly(IResourceThrottler):
                def has_resource(self, tenant_id, rtype):
                    if rtype == TenantResourceType.TOTAL_RETAIN_TOPICS:
                        return both.p.topic_count(tenant_id) < 1
                    return True
            return OneTopicOnly(), PortOneTopicOnly()

        b = Both(quota=quota)
        assert await b.retain("one")
        assert not await b.retain("two")
        assert await b.retain("one", b"update")  # replace ok
        assert b.tev.of(tev.EventType.MSG_RETAINED_ERROR)
        await b.match("T", "#")
        b.check()
        await b.stop()

    async def test_seeded_sequence_over_tenants(self):
        """Seeded sets, replaces and clears over two tenants, '$' roots
        included, with checked scans in between."""
        rng = random.Random(11)
        b = Both()
        names = ["a", "b", "", "$s", "dev", "x1"]
        topics = sorted({"/".join(rng.choice(names)
                                  for _ in range(rng.randint(1, 4)))
                         for _ in range(60)})
        filters = [["#"], ["+"], ["a", "#"], ["+", "+"], ["$s", "#"],
                   ["dev", "+", "#"], ["", "+"]]
        for step in range(90):
            tn = "T" if step % 3 else "U"
            payload = b"" if rng.random() < 0.25 else b"p%d" % step
            await b.retain(rng.choice(topics), payload, tenant=tn, mid=step)
            if step % 30 == 29:
                await b.match_batch([(tn, f) for tn in ("T", "U")
                                     for f in filters], 10)
        await b.match_batch([("T", f) for f in filters], 1000)
        b.check(("T", "U"))
        await b.stop()


class TestRetainReplicatedDurability:
    async def test_retained_messages_survive_restart(self):
        jeng, teng = JEngine(), InMemKVEngine()
        b = Both(engines=(jeng, teng))
        await b.retain("keep/a", b"v1")
        await b.retain("keep/b", b"v2")
        await b.retain("keep/a", b"")  # clear one
        b.check()
        await b.stop()
        # restart over the same engines: the derived index rebuilds from KV
        b2 = Both(engines=(jeng, teng))
        hits = await b2.match("T", "keep/+")
        assert [(tp, m.payload) for tp, m in hits] == [("keep/b", b"v2")]
        assert b2.p.topic_count("T") == 1
        coproc = next(iter(b2.p.kvstore.coprocs.values()))
        assert coproc.index.device == torch.device("cpu")
        await b2.retain("keep/c", b"v3")
        await b2.match("T", "keep/#")
        b2.check()
        await b2.stop()


class TestSplit:
    async def test_split_ranges_union_equals_reference(self):
        b = Both(split_threshold=12)
        tmpl = b.p._index_template
        rng = random.Random(3)
        for i in range(40):
            await b.retain(f"s/{rng.choice('abcd')}/{i}", b"v%d" % i, mid=i)
        for _ in range(4):
            n = await b.j.balance_controller.run_once()
            assert await b.p.balance_controller.run_once() == n
        assert len(b.p.kvstore.ranges) == len(b.j.kvstore.ranges) > 1
        assert sorted(b.p.kvstore.boundaries.values()) == \
            sorted(b.j.kvstore.boundaries.values())
        for c in b.p.kvstore.coprocs.values():
            # the template's device, probe length and patching reached
            # every range's rebuilt index
            assert c.index.device == torch.device("cpu")
            assert c.index.probe_len == tmpl.probe_len
            assert c.index._patched == tmpl._patched
        filters = [["#"], ["s", "+", "#"], ["s", "a", "+"], ["s", "+", "1"]]
        await b.match_batch([("T", f) for f in filters], 100)
        await b.match_batch([("T", f) for f in filters], 7)
        # mutations after the split land in their own range
        for i in range(0, 40, 5):
            await b.retain(f"s/x/{i}", b"" if i % 2 else b"n%d" % i, mid=i)
        for i in range(0, 40, 3):
            await b.retain(f"s/{'abcd'[i % 4]}/{i}", b"", mid=i)
        await b.match_batch([("T", f) for f in filters], 100)
        b.check()
        await b.stop()


# ------------------------------------------------------------ the coproc

def test_coproc_codecs_equal_reference():
    jpub = jtypes.ClientInfo(tenant_id="T", type="MQTT",
                             metadata=(("a", "b"),))
    tpub = ttypes.ClientInfo(tenant_id="T", type="MQTT",
                             metadata=(("a", "b"),))
    from bifromq_tpu.kv import schema as jschema
    from bifromq_tpu_torch.kv import schema as tschema
    jm, tm = msgs(b"payload", 30)
    for exp in (None, 1234.5):
        jv = jcoproc.enc_retained(jschema.encode_message(jm), jpub, exp)
        tv = tcoproc.enc_retained(tschema.encode_message(tm), tpub, exp)
        assert tv == jv
        e, p, m = tcoproc.dec_retained(tv)
        assert (e, p) == (exp, tpub) and canon_msg(m) == canon_msg(jm)
    assert tcoproc.enc_op(1, "T", "a/b", b"v") == \
        jcoproc.enc_op(1, "T", "a/b", b"v")
    assert tcoproc.enc_match_query("T", "a/+", 5) == \
        jcoproc.enc_match_query("T", "a/+", 5)
    for tn, tp in (("T", "a/b"), ("", ""), ("ação", "$SYS/x")):
        assert tschema.retain_key(tn, tp) == jschema.retain_key(tn, tp)
        assert tschema.split_retain_key(tschema.retain_key(tn, tp)) == \
            (tn, tp)
        assert tschema.retain_prefix(tn) == jschema.retain_prefix(tn)


async def test_q_match_query_equals_reference():
    b = Both()
    for i in range(6):
        await b.retain(f"q/{i}", b"v%d" % i, mid=i)
    jc = next(iter(b.j.kvstore.coprocs.values()))
    tc = next(iter(b.p.kvstore.coprocs.values()))
    for filt, limit in (("q/+", 4), ("#", 10), ("none", 3)):
        req = tcoproc.enc_match_query("T", filt, limit)
        got = tc.query(req, None)
        assert got == jc.query(req, None)
        rows = tcoproc.dec_match_reply(got)
        assert len(rows) == min(limit, 6 if filt != "none" else 0)
    await b.stop()


def test_coproc_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcoproc.RetainCoProc()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RetainService(tev.CollectingEventCollector())


def test_reset_swaps_the_index_and_bumps_the_cache():
    svc = RetainService(tev.CollectingEventCollector(),
                        index=tret.RetainedIndex(device="cpu", k_states=8,
                                                 probe_len=8))
    rid, coproc = next(iter(svc.kvstore.coprocs.items()))
    plane = coproc.scan_plane
    asyncio.run(svc.retain(ttypes.ClientInfo(tenant_id="T"), "a/b",
                           msgs()[1]))
    assert asyncio.run(plane.scan_batch([("T", ["a", "+"])], limit=5)) \
        == [["a/b"]]
    assert asyncio.run(plane.scan_batch([("T", ["#"])])) == [["a/b"]]
    old = coproc.index
    assert old.serving_ring is plane._ring
    gen0, seq0 = plane.cache._gen, coproc.delta_log.next_seq
    coproc.reset(svc.kvstore.ranges[rid].space)
    new = coproc.index
    assert new is not old and plane.index is new
    assert (new.k_states, new.probe_len, new.device) == \
        (8, 8, torch.device("cpu"))
    assert plane.cache._gen == gen0 + 1 and not plane.cache._d
    assert coproc.delta_log.next_seq == seq0 + 1
    assert new.serving_ring is None
    assert asyncio.run(plane.scan_batch([("T", ["#"])])) == [["a/b"]]
    assert new.serving_ring is plane._ring
    asyncio.run(svc.stop())


# ----------------------------------------------- TestScanPlane, mirrored

ALPHABET = ["a", "b", "c", "", "x1", "$s", "dev", "ação"]


def brute_force(topics, filter_levels):
    return sorted(tp for tp in topics
                  if t.matches(t.parse(tp), list(filter_levels)))


def rand_filters(rng, k):
    out = []
    for _ in range(k):
        n = rng.randint(1, 5)
        lv = []
        for i in range(n):
            roll = rng.random()
            if roll < 0.28:
                lv.append("+")
            elif roll < 0.38 and i == n - 1:
                lv.append("#")
            else:
                lv.append(rng.choice(ALPHABET))
        out.append(lv)
    return out + [["#"], ["+"], ["$s", "#"], ["$s", "+"], ["+", "+"],
                  ["+", "#"]]


def index_pair(n=60, seed=2):
    rng = random.Random(seed)
    topics = set()
    while len(topics) < n:
        topics.add("/".join(rng.choice(ALPHABET)
                            for _ in range(rng.randint(1, 5))))
    topics = sorted(topics)
    j = jret.RetainedIndex()
    p = tret.RetainedIndex(device="cpu")
    for tp in topics:
        j.add_topic("T", t.parse(tp), tp)
        p.add_topic("T", t.parse(tp), tp)
    j.refresh()
    p.refresh()
    return j, p, topics


def oracle(idx, queries, limit=None):
    return [tret.match_filter_host(idx.tries["T"], list(f), limit=limit)
            for _, f in queries]


class TestScanPlane:
    async def test_async_scan_parity_and_cache(self):
        j, p, topics = index_pair()
        jplane = JPlane(lambda: j)
        plane = RetainedScanPlane(lambda: p)
        queries = [("T", f) for f in rand_filters(random.Random(7), 30)]
        for limit in (None, 3):
            rows = await plane.scan_batch(queries, limit=limit)
            assert rows == await jplane.scan_batch(queries, limit=limit)
            for (_, f), row in zip(queries, rows):
                want = brute_force(topics, f)
                if limit is None:
                    assert sorted(row) == want, f
                else:
                    assert len(row) == min(limit, len(want)) \
                        and set(row) <= set(want)
        hits0 = plane.cache.hits
        rows2 = await plane.scan_batch(queries, limit=3)
        assert plane.cache.hits - hits0 == len(queries)
        assert rows2 == rows
        assert plane.degraded_total == {}

    async def test_exact_invalidation_on_mutation(self):
        _, idx, _ = index_pair()
        plane = RetainedScanPlane(lambda: idx)
        idx.delta_hooks.append(plane.cache.on_delta)
        q_hit = [("T", ["zz", "+"])]
        q_other = [("T", ["yy", "#"])]
        q_all = [("T", ["#"])]
        await plane.scan_batch(q_hit)
        await plane.scan_batch(q_other)
        await plane.scan_batch(q_all)
        # a mutation matching zz/+ evicts exactly zz/+ and #
        idx.add_topic("T", ["zz", "new"], "zz/new")
        keys = {k[0] for k in plane.cache._d["T"]}
        assert keys == {("yy", "#")}
        m0 = plane.cache.misses
        rows = await plane.scan_batch(q_hit)
        assert plane.cache.misses == m0 + 1      # evicted: re-scanned
        assert rows[0] == ["zz/new"]
        h0 = plane.cache.hits
        await plane.scan_batch(q_other)          # untouched filter: hit
        assert plane.cache.hits == h0 + 1
        # a '$' topic evicts no root wildcard [MQTT-4.7.2-1]
        await plane.scan_batch(q_all)
        idx.add_topic("T", ["$s", "new"], "$s/new")
        assert ("#",) in {k[0] for k in plane.cache._d["T"]}

    async def test_store_raced_by_mutation_is_refused(self):
        _, idx, _ = index_pair()
        plane = RetainedScanPlane(lambda: idx)
        idx.delta_hooks.append(plane.cache.on_delta)
        cache = plane.cache
        token = cache.token("T")
        idx.add_topic("T", ["race", "x"], "race/x")   # bumps the seq
        cache.put("T", ("race", "+"), None, ["stale"], token)
        assert cache.get("T", ("race", "+"), None) is None
        # a reset-raced store is refused by the wholesale epoch
        token = cache.token("T")
        cache.on_delta(None, None, "reset")
        cache.put("T", ("race", "+"), None, ["stale"], token)
        assert cache.get("T", ("race", "+"), None) is None

    async def test_watchdog_timeout_degrades_to_oracle(self, monkeypatch):
        _, idx, _ = index_pair()
        plane = RetainedScanPlane(lambda: idx)
        ring = plane._pipeline_ring()

        async def hang(res, **kw):
            raise DeviceTimeoutError(0.01)
        monkeypatch.setattr(ring, "wait_ready", hang)
        queries = [("T", ["+"]), ("T", ["a", "#"])]
        rows = await plane.scan_batch(queries, limit=4)
        assert rows == oracle(idx, queries, 4)
        assert plane.degraded_total == {"timeout": 1}
        # the orphaned result was parked, and released by the slot's
        # release sweep: on the CPU its leaves are ready at once
        assert ring.timeouts_total == 1
        assert ring.quarantine.quarantined_total == 1
        assert ring.quarantine.released_total == 1
        assert plane.device_breaker._failures == 1
        # a degraded row is not cached
        assert not plane.cache._d.get("T")

    async def test_breaker_open_skips_dispatch(self):
        _, idx, _ = index_pair()
        plane = RetainedScanPlane(lambda: idx)
        br = plane.device_breaker
        br.force_open()
        called = {"n": 0}
        orig = idx.dispatch_scan

        def counting(*a, **kw):
            called["n"] += 1
            return orig(*a, **kw)
        idx.dispatch_scan = counting
        rows = await plane.scan_batch([("T", ["#"])])
        assert called["n"] == 0
        assert rows == oracle(idx, [("T", ["#"])])
        assert plane.degraded_total == {"breaker": 1}

    @pytest.mark.parametrize("method", ["dispatch", "fetch"])
    async def test_injected_fault_degrades(self, method):
        _, idx, _ = index_pair()
        plane = RetainedScanPlane(lambda: idx)
        inj = get_injector()
        inj.add_rule(service="tpu-device", method=method,
                     action="error", max_hits=1)
        queries = [("T", ["+", "#"]), ("T", ["b"])]
        try:
            rows = await plane.scan_batch(queries)
        finally:
            inj.reset()
        assert rows == oracle(idx, queries)
        assert plane.degraded_total == {"device_error": 1}
        assert plane.device_breaker._failures == 1
        # the next scan is served by the device leg, undegraded (in the
        # index's order, which is not the oracle's depth-first one)
        again = await plane.scan_batch(queries)
        assert [sorted(r) for r in again] == [sorted(r) for r in rows]
        assert plane.degraded_total == {"device_error": 1}

    async def test_canary_parity_miss_serves_the_oracle(self, monkeypatch):
        _, idx, topics = index_pair()
        plane = RetainedScanPlane(lambda: idx)
        br = plane.device_breaker
        br.force_open()
        br._opened_at -= br.recovery_time + 1     # recovery elapsed
        wrong = lambda prep, fetched, limit=None: [["bogus"]] * len(
            prep.queries)
        monkeypatch.setattr(idx, "expand_scan", wrong)
        queries = [("T", ["#"])]
        rows = await plane.scan_batch(queries)
        assert rows == oracle(idx, queries)
        assert plane.degraded_total == {"canary_parity": 1}
        assert br.state == "open"

    @pytest.mark.parametrize("fault", _PROGRAM_FAULTS)
    @pytest.mark.parametrize("where", ["prepare_scan", "dispatch_scan",
                                       "expand_scan"])
    async def test_program_faults_propagate(self, fault, where,
                                            monkeypatch):
        svc = RetainService(tev.CollectingEventCollector(),
                            index=tret.RetainedIndex(device="cpu"))
        await svc.retain(ttypes.ClientInfo(tenant_id="T"), "a/b",
                         msgs()[1])
        coproc = next(iter(svc.kvstore.coprocs.values()))
        plane, idx = coproc.scan_plane, coproc.index

        def boom(*a, **kw):
            raise fault("injected by the test")
        monkeypatch.setattr(idx, where, boom)
        br = plane.device_breaker
        with pytest.raises(fault):
            await svc.match_batch([("T", ["a", "+"])], 10)
        with pytest.raises(fault):
            await plane.scan_batch([("T", ["a", "+"])], limit=3)
        assert plane.degraded_total == {} and br._failures == 0
        assert plane._ring.in_flight == 0
        # a half-open canary's probe is released on the way out
        br.force_open()
        br._opened_at -= br.recovery_time + 1
        with pytest.raises(fault):
            await plane.scan_batch([("T", ["#"])])
        assert br.admit() == "canary"
        br.release_probe()
        monkeypatch.undo()
        hits = await svc.match("T", ["a", "+"], 10)
        assert [tp for tp, _ in hits] == ["a/b"]
        assert br.state == "closed"
        await svc.stop()

    async def test_service_scans_share_one_cache_per_range(self):
        b = Both()
        for i in range(8):
            await b.retain(f"dev/{i}/temp", b"t%d" % i, mid=i)
        coproc = next(iter(b.p.kvstore.coprocs.values()))
        plane = coproc.scan_plane
        await b.match("T", "dev/+/temp")
        h0 = plane.cache.hits
        await b.match("T", "dev/+/temp")
        assert plane.cache.hits == h0 + 1
        # the mutation evicts the cached filter: served fresh, equal
        await b.retain("dev/9/temp", b"t9", mid=9)
        assert (("dev", "+", "temp"), 10) not in plane.cache._d["T"]
        hits = await b.match("T", "dev/+/temp")
        assert len(hits) == 9
        status, recs = coproc.delta_log.since(0)
        # the range's open rebuilt its index from KV: the reset record
        assert status == "ok" and len(recs) == 10
        assert recs[0][2:] == ("", (), "reset")
        assert recs[-1][2:] == ("T", ("dev", "9", "temp"), "set")
        assert isinstance(plane.cache, RetainedScanCache)
        await b.stop()


# --------------------------------------------- the engine under the plane

def test_kv_space_equals_reference_under_seeded_ops():
    """The in-memory space's lazily ordered key list (appends, ordered
    when a delete or a scan needs it: a long tail by one sort, a short one
    by insorts) answers as the reference's bisect-maintained one, through
    a bulk load in random order, puts, re-puts of deleted keys, deletes,
    range deletes, scans both ways and checkpoints."""
    rng = random.Random(9)
    j = JEngine().create_space("s")
    p = InMemKVEngine().create_space("s")
    keys = [bytes(rng.randrange(256) for _ in range(rng.randint(1, 4)))
            for _ in range(300)]
    for k in keys:      # a tail longer than the insort bound
        j.writer().put(k, b"bulk").done()
        p.writer().put(k, b"bulk").done()
    assert p.get(keys[0]) == j.get(keys[0]) and len(p) == len(j)
    for step in range(3000):
        k = rng.choice(keys)
        roll = rng.random()
        if roll < 0.55:
            v = b"%d" % step
            j.writer().put(k, v).done()
            p.writer().put(k, v).done()
        elif roll < 0.85:
            j.writer().delete(k).done()
            p.writer().delete(k).done()
        elif roll < 0.9:
            lo, hi = sorted((k, rng.choice(keys)))
            j.writer().delete_range(lo, hi).done()
            p.writer().delete_range(lo, hi).done()
        else:
            lo, hi = sorted((k, rng.choice(keys)))
            assert list(p.iterate(lo, hi)) == list(j.iterate(lo, hi))
            assert list(p.iterate(lo, hi, reverse=True)) == \
                list(j.iterate(lo, hi, reverse=True))
            assert p.size(lo, hi) == j.size(lo, hi)
        assert p.get(k) == j.get(k) and len(p) == len(j)
    assert list(p.iterate()) == list(j.iterate())
    assert list(p.checkpoint().iterate()) == list(j.checkpoint().iterate())


async def test_compaction_defers_the_snapshot_until_a_peer_needs_it():
    """Past the threshold the raft log compacts with no serialization;
    the snapshot a lagging peer would get is cut at ``last_applied`` when
    it is asked for, leaves the log as it was, and restores the same
    retain keyspace."""
    svc = RetainService(tev.CollectingEventCollector(),
                        index=tret.RetainedIndex(device="cpu"))
    pub = ttypes.ClientInfo(tenant_id="T")
    rng_ = next(iter(svc.kvstore.ranges.values()))
    raft = rng_.raft
    calls = []
    real = raft.snapshot_cb
    raft.snapshot_cb = lambda: calls.append(1) or real()
    for i in range(raft.SNAPSHOT_THRESHOLD + 40):
        await svc.retain(pub, f"c/{i}", msgs(b"v%d" % i, mid=i)[1])
    assert raft.snap.last_index > 0 and raft.snap.data is None
    assert len(raft.log) <= raft.SNAPSHOT_THRESHOLD and not calls
    cut, log = raft.snap, list(raft.log)
    for i in range(3):      # applied past the cut
        await svc.retain(pub, f"d/{i}", msgs(b"w%d" % i, mid=i)[1])
    assert raft.snap is cut and raft.log[:len(log)] == log
    snap = raft._materialized_snap()
    assert calls == [1] and snap is not raft.snap and raft.snap is cut
    assert snap.last_index == raft.last_applied > cut.last_index
    assert raft.log[:len(log)] == log and len(raft.log) == len(log) + 3
    assert raft._materialized_snap() is snap and calls == [1]
    space = InMemKVEngine().create_space("copy")
    coproc = tcoproc.RetainCoProc(tret.RetainedIndex(device="cpu"))
    from bifromq_tpu_torch.kv.range import ReplicatedKVRange
    copy = ReplicatedKVRange.__new__(ReplicatedKVRange)
    copy.space, copy.coproc = space, coproc
    copy._restore(snap.data)
    assert list(space.iterate()) == list(rng_.space.iterate())
    assert coproc.values == next(iter(svc.kvstore.coprocs.values())).values
    await svc.stop()
