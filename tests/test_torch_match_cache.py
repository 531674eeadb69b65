"""Port parity: the match-result cache front end on TorchMatcher.

The cases mirror ``tests/test_match_cache.py``: a repeated batch skips
the device plane, in-batch duplicates walk once, an exact-filter
mutation evicts only its own topic, a same-salt compaction keeps the
cache and a salt change bumps its generation; the cache class itself
(LRU bounds, filter-aware invalidation, the stale-put refusal) is held
case by case against the reference's ``TenantMatchCache``. The port's
results with the cache on equal its results with the cache off and the
reference's, row for row in order, across mutations, a compaction and a
salt change. Inputs come from seeded generators. Tolerance: exact
equality.
"""

import random

import pytest

from bifromq_tpu.models import matchcache as jc
from bifromq_tpu.models.automaton import PatchableTrie as JPatchable
from bifromq_tpu.models.automaton import compile_tries as jcompile
from bifromq_tpu.models.matcher import TpuMatcher
from bifromq_tpu.models.oracle import Route as JRoute
from bifromq_tpu.ops.match import DeviceTrie as JDeviceTrie
from bifromq_tpu.types import RouteMatcher as JMatcher
from bifromq_tpu_torch.models import matchcache as tc
from bifromq_tpu_torch.models.automaton import PatchableTrie, compile_tries
from bifromq_tpu_torch.models.matcher import TorchMatcher
from bifromq_tpu_torch.models.oracle import Route
from bifromq_tpu_torch.ops.match import DeviceTrie
from bifromq_tpu_torch.parallel import sharded as ts
from bifromq_tpu_torch.types import RouteMatcher
from bifromq_tpu_torch.utils.metrics import MATCH_CACHE

UNCAPPED = (2 ** 31 - 1, 2 ** 31 - 1)
FILTERS = ["a/b", "a/+", "a/#", "+/b", "x/y/z", "a/b/c", "#", "s/1/t",
           "s/2/t", "$share/g1/a/b", "$share/g1/a/+", "$oshare/g2/x/y"]
TOPICS = [["a", "b"], ["a", "c"], ["a", "b", "c"], ["x", "y", "z"],
          ["s", "1", "t"], ["s", "2", "t"], ["q"]]


def mk_route(tf, rid, inc=0):
    return Route(matcher=RouteMatcher.from_topic_filter(tf), broker_id=0,
                 receiver_id=rid, deliverer_key="d0", incarnation=inc)


def matcher(**kw):
    return TorchMatcher(device="cpu", max_levels=8, auto_compact=False,
                        match_cache=True, **kw)


def _norm(m):
    return (tuple((r.matcher.mqtt_topic_filter, r.receiver_url,
                   r.incarnation) for r in m.normal),
            tuple((f, tuple(r.receiver_url for r in ms))
                  for f, ms in m.groups.items()),
            m.persistent_fanout, m.max_persistent_fanout_exceeded,
            m.max_group_fanout_exceeded)


def _device_calls(m):
    """Record the query count of every call that reaches the device."""
    seen = []
    orig = m._match_batch_device
    m._match_batch_device = (lambda queries, **k: seen.append(len(queries))
                             or orig(queries, **k))
    return seen


def test_repeated_batch_skips_the_device():
    m = matcher()
    m.add_route("T", mk_route("a/+", "r1"))
    m.refresh()
    q = [("T", "a/b"), ("T", ["a", "c"])]
    first = m.match_batch(q)
    seen = _device_calls(m)
    second = m.match_batch(q)
    assert seen == [], "a repeated batch reached the device plane"
    assert all(a is b for a, b in zip(first, second))


def test_in_batch_dedup_walks_unique_rows_once():
    m = matcher()
    m.add_route("T", mk_route("a/b", "r1"))
    m.refresh()
    seen = _device_calls(m)
    MATCH_CACHE.reset()
    res = m.match_batch([("T", "a/b")] * 8 + [("T", "a/c")])
    assert seen == [2], f"device saw {seen}, expected one 2-row batch"
    assert all(r is res[0] for r in res[:8])
    assert [x.receiver_id for x in res[0].normal] == ["r1"]
    assert res[8].all_routes() == []
    snap = MATCH_CACHE.snapshot()
    assert snap["matcher"]["misses"] == 9
    assert snap["dedup"] == {"walked": 2, "saved": 7, "ratio": 0.7778}


def test_exact_mutation_evicts_only_its_topic():
    m = matcher()
    m.add_route("T", mk_route("a/b", "r1"))
    m.add_route("T", mk_route("a/c", "r2"))
    m.refresh()
    m.match_batch([("T", "a/b"), ("T", "a/c")])
    h0 = m.match_cache.hits
    m.add_route("T", mk_route("a/b", "r3"))
    res = m.match_batch([("T", "a/b"), ("T", "a/c")])
    assert m.match_cache.hits == h0 + 1        # a/c stayed cached
    assert sorted(r.receiver_id for r in res[0].normal) == ["r1", "r3"]
    # a wildcard mutation drops the whole tenant
    m.add_route("T", mk_route("a/+", "r4"))
    res = m.match_batch([("T", "a/b"), ("T", "a/c")])
    assert m.match_cache.hits == h0 + 1
    assert [r.receiver_id for r in res[1].normal] == ["r2", "r4"]


def test_compaction_keeps_the_cache_and_a_salt_change_bumps_it():
    m = matcher()
    m.add_route("T", mk_route("a/b", "r1"))
    m.refresh()
    m.match_batch([("T", "a/b")])
    gen0, h0 = m.match_cache._gen, m.match_cache.hits
    m.add_route("T", mk_route("x/y", "r2"))
    m._maybe_compact(force=True)
    m.drain()
    assert m.compile_count == 2 and m.match_cache._gen == gen0
    res = m.match_batch([("T", "a/b")])
    assert m.match_cache.hits == h0 + 1
    ct = compile_tries(m.tries, max_levels=8, salt=m._base_ct.salt + 1)
    m._install_base(ct, DeviceTrie.from_compiled(ct, "cpu"))
    assert m.match_cache._gen == gen0 + 1
    again = m.match_batch([("T", "a/b")])
    assert m.match_cache.hits == h0 + 1        # a miss after the salt change
    assert _norm(again[0]) == _norm(res[0])


def test_cache_off_is_a_pure_bypass():
    m = TorchMatcher(device="cpu", max_levels=8, auto_compact=False,
                     match_cache=False)
    assert m.match_cache is None
    m.add_route("T", mk_route("a/b", "r1"))
    seen = _device_calls(m)
    m.match_batch([("T", "a/b")] * 3)
    assert seen == [3]


def _resalt(m, compile_fn, patchable, upload):
    """Install a base compiled from the same routes under the next salt
    (what a hash-collision recompile does), still patchable."""
    m.refresh()
    ct = patchable(compile_fn(m._shadow, max_levels=8,
                              salt=m._base_ct.salt + 1))
    m._install_base(ct, upload(ct))


def _jroute(tf, rid, inc):
    return JRoute(JMatcher.from_topic_filter(tf), 0, rid, "d0", inc)


def test_cache_on_equals_cache_off_and_the_reference():
    """One seeded stream of mutations, compactions, a salt change and
    duplicate-heavy batches: the port with the cache on, the port with
    it off and the reference (cache on, its default patch path) return
    the same ``MatchedRoutes`` row for row, in order."""
    kw = dict(max_levels=8, k_states=16, auto_compact=False)
    on = TorchMatcher(device="cpu", match_cache=True, **kw)
    off = TorchMatcher(device="cpu", match_cache=False, **kw)
    ref = TpuMatcher(match_cache=True, **kw)
    rng = random.Random(13)
    hits = 0
    for step in range(160):
        r = rng.random()
        tenant = rng.choice(["T1", "T2"])
        tf = rng.choice(FILTERS)
        rid = f"r{rng.randrange(30)}"
        if step == 60:
            for m in (on, off, ref):
                m._maybe_compact(force=True)
                m.drain()
        elif step == 95:
            # a salt change on all three: the generation bump must drop
            # every cached entry
            gen = on.match_cache._gen
            for m in (on, off):
                _resalt(m, compile_tries, PatchableTrie,
                        lambda ct: DeviceTrie.from_compiled(ct, "cpu"))
            _resalt(ref, jcompile, JPatchable, JDeviceTrie.from_compiled)
            assert on.match_cache._gen == gen + 1
        elif r < 0.3:
            assert on.add_route(tenant, mk_route(tf, rid, step)) == \
                off.add_route(tenant, mk_route(tf, rid, step)) == \
                ref.add_route(tenant, _jroute(tf, rid, step))
        elif r < 0.45:
            args = ((0, rid, "d0"), step)
            assert on.remove_route(
                tenant, RouteMatcher.from_topic_filter(tf), *args) == \
                off.remove_route(
                    tenant, RouteMatcher.from_topic_filter(tf), *args) == \
                ref.remove_route(tenant, JMatcher.from_topic_filter(tf),
                                 *args)
        else:
            batch = [(tenant, rng.choice(TOPICS))
                     for _ in range(rng.randrange(1, 6))]
            batch += [batch[0]] * rng.randrange(0, 3)
            h = on.match_cache.hits
            want = [_norm(x) for x in ref.match_batch(batch)]
            assert [_norm(x) for x in on.match_batch(batch)] == want, step
            assert [_norm(x) for x in off.match_batch(batch)] == want, step
            hits += on.match_cache.hits - h
    assert hits > 0, "the cache never hit — the test lost its bite"


def test_mesh_matcher_takes_the_cache_front_end():
    from bifromq_tpu_torch import workloads
    tries = workloads.config_multi_tenant(20, 200, seed=1)
    mm = ts.TorchMeshMatcher.from_tries(
        tries, mesh=ts.make_mesh(2, 2, device="cpu"))
    assert mm.match_cache is not None
    queries = [(f"tenant{i % 20}", "/".join(t)) for i, t in
               enumerate(workloads.probe_topics(24, seed=2))]
    first = mm.match_batch(queries)
    seen = _device_calls(mm)
    assert all(a is b for a, b in zip(mm.match_batch(queries), first))
    assert seen == []
    assert mm._base_salt(mm._base_ct) == tuple(
        ct.salt for ct in mm._base_ct.compiled)
    off = ts.TorchMeshMatcher.from_tries(
        tries, mesh=ts.make_mesh(2, 2, device="cpu"), match_cache=False)
    assert off.match_cache is None
    assert [_norm(x) for x in off.match_batch(queries)] == \
        [_norm(x) for x in first]


# ---- the cache class, case by case against the reference -------------------

def _both(**kw):
    return jc.TenantMatchCache(**kw), tc.TenantMatchCache(**kw)


def _lru(c):
    for i in range(4):
        c.put("T", ("t", str(i)), UNCAPPED, f"m{i}", c.token("T"))
    c.get("T", ("t", "0"), UNCAPPED)
    c.put("T", ("t", "4"), UNCAPPED, "m4", c.token("T"))
    return [c.get("T", ("t", str(i)), UNCAPPED) for i in range(5)]


def _total_bound(c):
    for t in range(8):
        for i in range(4):
            c.put(f"T{t}", ("x", str(i)), UNCAPPED, "m", c.token(f"T{t}"))
    return [len(c)] + [c.get(f"T{t}", ("x", "0"), UNCAPPED)
                       for t in range(8)]


def _invalidation(c):
    c.put("T", ("a", "b"), UNCAPPED, "tuple-key", c.token("T"))
    c.put("T", "a/b", UNCAPPED, "string-key", c.token("T"))
    c.put("T", ("a", "c"), UNCAPPED, "other", c.token("T"))
    c.put("U", ("a", "c"), UNCAPPED, "u", c.token("U"))
    c.invalidate("T", ["a", "b"])
    out = [c.get("T", ("a", "b"), UNCAPPED), c.get("T", "a/b", UNCAPPED),
           c.get("T", ("a", "c"), UNCAPPED)]
    c.invalidate("T", ["a", "+"])
    out += [c.get("T", ("a", "c"), UNCAPPED), c.get("U", ("a", "c"),
                                                    UNCAPPED)]
    c.bump_all()
    return out + [c.get("U", ("a", "c"), UNCAPPED)]


def _stale_put(c):
    token = c.token("T")
    c.invalidate("T", ["a", "+"])
    out = [c.put("T", ("a", "b"), UNCAPPED, "stale", token)]
    token = c.token("T")
    c.invalidate("T", ["a", "b"])
    out.append(c.put("T", ("a", "b"), UNCAPPED, "stale", token))
    token = c.token("T")
    out.append(c.put("T", ("a", "b"), UNCAPPED, "fresh", token))
    return out + [c.get("T", ("a", "b"), UNCAPPED),
                  c.get("T", ("a", "b"), (1, 1))]


def _tenant_bound(c):
    for t in ("A", "B", "C"):
        c.put(t, ("x",), UNCAPPED, t, c.token(t))
    return [c.get(t, ("x",), UNCAPPED) for t in ("A", "B", "C")]


@pytest.mark.parametrize("case,kw", [
    (_lru, dict(max_topics_per_tenant=4)),
    (_total_bound, dict(max_entries=16, max_topics_per_tenant=100)),
    (_invalidation, {}),
    (_stale_put, {}),
    (_tenant_bound, dict(max_tenants=2)),
], ids=["lru", "total_bound", "invalidation", "stale_put", "tenant_bound"])
def test_tenant_match_cache_equals_the_reference(case, kw):
    ref, port = _both(**kw)
    assert case(port) == case(ref)
    assert port.snapshot() == ref.snapshot()
    assert tc.filter_is_wildcard(["a", "#"]) and \
        not tc.filter_is_wildcard(["a", "b"])
