"""Port parity: in-place trie patching on TorchMatcher.

``TorchMatcher(device="cpu")`` runs the plain versions of the kernels on
``PatchableTrie`` bases. The cases mirror ``tests/test_patch.py``: triple
parity under interleaved churn (patched ≡ oracle ≡ after compaction, no
rebuild), node-arena growth and edge-table regrow, group-member churn, a
patch-era hash collision that falls back to the overlay, and a failed
flush that restores the dirty set. Two more hold the port against the
reference: the same churn on ``TpuMatcher`` (its default patch path) and
on the port gives byte-identical arenas and identical ``MatchedRoutes``
in order, with the match cache on and off; and ``patchable_from_numpy``
carries a reference arena across. Inputs come from seeded generators.
Tolerance: exact equality.
"""

import random

import numpy as np
import pytest
import torch

from bifromq_tpu.models.matcher import TpuMatcher
from bifromq_tpu.models.oracle import Route as JRoute
from bifromq_tpu.types import RouteMatcher as JMatcher
from bifromq_tpu_torch.models import automaton as ta
from bifromq_tpu_torch.models.automaton import GroupMatching, PatchableTrie
from bifromq_tpu_torch.models.matcher import TorchMatcher
from bifromq_tpu_torch.models.oracle import Route
from bifromq_tpu_torch.models.state import patchable_from_numpy
from bifromq_tpu_torch.ops import match as tm
from bifromq_tpu_torch.types import RouteMatcher

FILTERS = ["a/b", "a/+", "a/#", "+/b", "x/y/z", "a/b/c", "#",
           "deep/1/2/3/4", "$share/g1/a/b", "$share/g1/a/+",
           "$oshare/g2/a/b", "lit/p", "lit/q"]
TOPICS = [["a", "b"], ["a", "c"], ["a", "b", "c"], ["x", "y", "z"],
          ["deep", "1", "2", "3", "4"], ["lit", "p"], ["q"],
          ["a", "b", "c", "d"]]
ARENAS = ("node_tab", "edge_tab", "child_list", "slot_kind")


def mk_route(tf, rid, inc=0):
    return Route(matcher=RouteMatcher.from_topic_filter(tf), broker_id=0,
                 receiver_id=rid, deliverer_key="d0", incarnation=inc)


def matcher(**kw):
    return TorchMatcher(device="cpu", max_levels=8, auto_compact=False,
                        **kw)


def canon(m):
    return (sorted((r.matcher.mqtt_topic_filter, r.receiver_url)
                   for r in m.normal),
            {f: sorted(r.receiver_url for r in ms)
             for f, ms in m.groups.items()})


def assert_oracle_parity(m, queries, ctx=""):
    got = m.match_batch(queries)
    want = m.match_from_tries(queries)
    for q, a, b in zip(queries, got, want):
        assert canon(a) == canon(b), f"{ctx}: {q}"


def assert_device_equals_host(m):
    """The flushed device tables equal the host arenas element for
    element."""
    m._flush_patches()
    base, dev = m._base_ct, m._device_trie
    want = {"node_tab": base.node_tab, "edge_tab": base.edge_tab,
            "child_list": base.child_list,
            "count_tab": tm.count_cols_from_node_tab(base.node_tab),
            "route_tab": tm.route_cols_from_node_tab(base.node_tab)}
    for k, a in want.items():
        assert np.array_equal(getattr(dev, k).numpy(), a), k


def test_mutations_patch_in_place_without_recompile():
    m = matcher(k_states=16)
    m.add_route("T", mk_route("a/b", "r1"))
    m.refresh()
    assert isinstance(m._base_ct, PatchableTrie)
    c0 = m.compile_count
    m.add_route("T", mk_route("a/+", "r2"))
    m.add_route("T", mk_route("a/#", "r3"))
    assert m.overlay_size == 0 and m.patch_count == 2
    res = m.match_batch([("T", "a/b")])[0]
    assert sorted(r.receiver_id for r in res.normal) == ["r1", "r2", "r3"]
    # a tombstone is host-only: no device flush, the slot dies on the host
    flushes = m.patch_flushes
    m.remove_route("T", RouteMatcher.from_topic_filter("a/+"),
                   (0, "r2", "d0"))
    res = m.match_batch([("T", "a/b")])[0]
    assert sorted(r.receiver_id for r in res.normal) == ["r1", "r3"]
    assert m.patch_flushes == flushes and m._base_ct.dead_slots == 1
    assert m.compile_count == c0
    assert_device_equals_host(m)


def test_interleaved_churn_triple_parity():
    """Patched ≡ oracle at every probe point with no rebuild and no cache
    generation bump; then a forced compaction folds the arenas into a
    fresh base that agrees again."""
    m = matcher(k_states=16, match_cache=True)
    rng = random.Random(23)
    for i in range(60):
        m.add_route(f"T{i % 3}",
                    mk_route(FILTERS[i % len(FILTERS)], f"r{i}", inc=i))
    m.refresh()
    c0, gen0 = m.compile_count, m.match_cache._gen
    for step in range(400):
        tenant = f"T{rng.randrange(3)}"
        tf = rng.choice(FILTERS)
        rid = f"r{rng.randrange(80)}"
        if rng.random() < 0.55:
            m.add_route(tenant, mk_route(tf, rid, inc=step))
        else:
            m.remove_route(tenant, RouteMatcher.from_topic_filter(tf),
                           (0, rid, "d0"), incarnation=step)
        if step % 20 == 0:
            assert_oracle_parity(
                m, [(f"T{rng.randrange(3)}", rng.choice(TOPICS))
                    for _ in range(8)], f"step {step}")
    assert m.compile_count == c0, "steady churn rebuilt the base"
    assert m.match_cache._gen == gen0 and m.overlay_size == 0
    assert_device_equals_host(m)
    m._maybe_compact(force=True)
    m.drain()
    assert isinstance(m._base_ct, PatchableTrie)
    assert m._base_ct.dead_slots == 0 and m.compile_count == c0 + 1
    assert m.match_cache._gen == gen0, "a same-salt compaction bumped"
    assert_oracle_parity(m, [(f"T{t}", topic) for t in range(3)
                             for topic in TOPICS], "post-compaction")


def test_fragmentation_compacts_in_the_background(monkeypatch):
    monkeypatch.setattr(ta, "PATCH_FRAG_RATIO", 0.1)
    monkeypatch.setattr(ta, "PATCH_FRAG_FLOOR", 16)
    m = TorchMatcher(device="cpu", max_levels=8, k_states=16,
                     compact_threshold=10_000)
    for i in range(120):
        m.add_route("T", mk_route(f"s/{i}/+", f"r{i}"))
    m.refresh()
    rng = random.Random(5)
    for step in range(300):
        i = rng.randrange(160)
        if rng.random() < 0.5:
            m.add_route("T", mk_route(f"s/{i}/+", f"r{i}", inc=step))
        else:
            m.remove_route("T", RouteMatcher.from_topic_filter(f"s/{i}/+"),
                           (0, f"r{i}", "d0"), incarnation=step)
        if step % 13 == 0:
            assert_oracle_parity(m, [("T", ["s", str(i), "leaf"])],
                                 f"step {step}")
    m.drain()
    assert m.compile_count >= 2, "fragmentation compaction never ran"
    assert_oracle_parity(m, [("T", ["s", str(i), "leaf"])
                             for i in range(0, 160, 11)], "post")


@pytest.mark.parametrize("kind", ["node_growth", "edge_regrow"])
def test_arena_growth_keeps_serving_exact(kind):
    m = matcher()
    m.add_route("T", mk_route("seed/1", "r0"))
    m.refresh()
    base = m._base_ct
    cap0, nb0 = base.node_tab.shape[0], base.edge_tab.shape[0]
    i = 0
    if kind == "node_growth":
        while base.node_grows == 0 and i < 4 * cap0:
            m.add_route("T", mk_route(f"grow/{i}/x", f"g{i}"))
            i += 1
        assert base.node_tab.shape[0] > cap0
        queries = [("T", f"grow/{j}/x") for j in range(0, i, 7)]
    else:
        while base.edge_regrows == 0 and i < 2000:
            m.add_route("T", mk_route(f"lit{i}", f"l{i}"))
            i += 1
        assert base.edge_tab.shape[0] > nb0
        queries = [("T", f"lit{j}") for j in range(0, i, 17)]
    assert m.compile_count == 1
    assert_oracle_parity(m, queries + [("T", "seed/1")], kind)
    assert_device_equals_host(m)


def test_group_member_churn_swaps_the_slot_object():
    m = matcher()
    m.add_route("T", mk_route("$share/g/a/b", "r1"))
    m.refresh()
    m.match_batch([("T", "a/b")])
    flushes = m.patch_flushes
    m.add_route("T", mk_route("$share/g/a/b", "r2"))
    m.remove_route("T", RouteMatcher.from_topic_filter("$share/g/a/b"),
                   (0, "r1", "d0"))
    res = m.match_batch([("T", "a/b")])[0]
    assert sorted(r.receiver_id for r in res.groups["$share/g/a/b"]) == \
        ["r2"]
    assert m.patch_flushes == flushes     # a host object swap only
    m.remove_route("T", RouteMatcher.from_topic_filter("$share/g/a/b"),
                   (0, "r2", "d0"))
    assert m.match_batch([("T", "a/b")])[0].all_routes() == []


def test_patch_era_hash_collision_falls_back_to_overlay():
    m = matcher()
    m.add_route("T", mk_route("seed/x", "r0"))
    m.refresh()
    m.add_route("T", mk_route("edge/one", "r1"))       # a patch-era edge
    base = m._base_ct
    root = base.tenant_root["T"]
    edge_nid = base._edge_child(root, *ta.level_hash("edge", base.salt))
    k1, k2 = ta.level_hash("one", base.salt)
    # the 64-bit collision, simulated: another string owns (k1, k2)
    base._edge_level[(edge_nid, k1, k2)] = "SOMETHING-ELSE"
    fb0 = m.patch_fallbacks
    m.add_route("T", mk_route("edge/one", "r2"))
    assert m.patch_fallbacks == fb0 + 1 and m.overlay_size == 1
    res = m.match_batch([("T", "edge/one")])[0]
    assert sorted(r.receiver_id for r in res.normal) == ["r1", "r2"]


def test_failed_flush_restores_the_dirty_set(monkeypatch):
    m = matcher()
    m.add_route("T", mk_route("a/b", "r1"))
    m.refresh()
    m.match_batch([("T", "a/b")])
    m.add_route("T", mk_route("a/+", "r2"))
    real = tm._patch_device_trie
    calls = []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected flush failure")
        return real(*a, **kw)
    monkeypatch.setattr(tm, "_patch_device_trie", flaky)
    with pytest.raises(RuntimeError):
        m.match_batch([("T", "a/b")])
    assert m._base_ct.dirty and {"node", "edge"} <= m._base_ct._full
    res = m.match_batch([("T", "a/b")])[0]
    assert sorted(r.receiver_id for r in res.normal) == ["r1", "r2"]
    assert_device_equals_host(m)


def test_flush_without_donation_leaves_the_old_tables():
    m = matcher()
    m.add_route("T", mk_route("a/b", "r1"))
    m.refresh()
    m.add_route("T", mk_route("a/c/d", "r2"))
    old = m._device_trie
    before = old.route_tab.clone()
    dev, stats = tm.patch_device_trie(old, m._base_ct, donate=False)
    assert torch.equal(old.route_tab, before) and stats["rows"] > 0
    assert np.array_equal(
        dev.route_tab.numpy(),
        tm.route_cols_from_node_tab(m._base_ct.node_tab))


# ---- the port against the reference ----------------------------------------

def _jroute(tf, rid, inc):
    return JRoute(JMatcher.from_topic_filter(tf), 0, rid, "d0", inc)


def _norm(m):
    return (tuple((r.matcher.mqtt_topic_filter, r.receiver_url,
                   r.incarnation) for r in m.normal),
            tuple((f, tuple(r.receiver_url for r in ms))
                  for f, ms in m.groups.items()),
            m.persistent_fanout)


def _assert_same_arenas(ref, port):
    for f in ARENAS:
        a, b = getattr(ref._base_ct, f), getattr(port._base_ct, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert ref._base_ct.n_live == port._base_ct.n_live
    assert ref._base_ct.tenant_root == port._base_ct.tenant_root


@pytest.mark.parametrize("match_cache", [False, True],
                         ids=["cache_off", "cache_on"])
def test_port_arenas_equal_the_reference_under_churn(match_cache):
    kw = dict(max_levels=8, k_states=8, max_intervals=8, auto_compact=False,
              match_cache=match_cache)
    ref, port = TpuMatcher(**kw), TorchMatcher(device="cpu", **kw)
    rng = random.Random(7)
    for i in range(40):
        tf, tenant = FILTERS[i % len(FILTERS)], f"T{i % 2}"
        assert ref.add_route(tenant, _jroute(tf, f"r{i}", i)) == \
            port.add_route(tenant, mk_route(tf, f"r{i}", i))
    ref.refresh()
    port.refresh()
    for step in range(160):
        tenant = f"T{rng.randrange(3)}"
        tf = rng.choice(FILTERS + [f"grow/{step}/+"])
        rid = f"r{rng.randrange(50)}"
        if rng.random() < 0.6:
            assert ref.add_route(tenant, _jroute(tf, rid, step)) == \
                port.add_route(tenant, mk_route(tf, rid, step))
        else:
            assert ref.remove_route(tenant, JMatcher.from_topic_filter(tf),
                                    (0, rid, "d0"), step) == \
                port.remove_route(tenant, RouteMatcher.from_topic_filter(tf),
                                  (0, rid, "d0"), step)
        if step % 40 == 39:
            queries = [(f"T{rng.randrange(3)}", "/".join(rng.choice(TOPICS)))
                       for _ in range(12)]
            queries += queries[:3]          # in-batch duplicates
            assert [_norm(x) for x in ref.match_batch(queries)] == \
                [_norm(x) for x in port.match_batch(queries)]
            _assert_same_arenas(ref, port)
    assert port.compile_count == ref.compile_count == 1
    assert port.patch_count == ref.patch_count > 100
    assert port.overlay_size == ref.overlay_size == 0


def test_patchable_from_numpy_round_trips_a_reference_arena():
    ref = TpuMatcher(max_levels=8, k_states=8, auto_compact=False,
                     match_cache=False)
    for i, tf in enumerate(FILTERS * 2):
        ref.add_route("T", _jroute(tf, f"r{i}", 0))
    ref.refresh()
    for i in range(12):        # patch-era nodes, a dead slot, a relocation
        ref.add_route("T", _jroute(f"new/{i}/+", f"n{i}", 0))
    ref.remove_route("T", JMatcher.from_topic_filter("a/b"), (0, "r0", "d0"))
    ref.add_route("T", _jroute("a/+", "late", 0))
    jb = ref._base_ct
    assert jb.dead_slots == 1 and jb.relocations >= 1

    def port_matching(m):
        if hasattr(m, "members"):
            return GroupMatching(m.mqtt_topic_filter, m.ordered, tuple(
                mk_route(r.matcher.mqtt_topic_filter, r.receiver_id,
                         r.incarnation) for r in m.members))
        return mk_route(m.matcher.mqtt_topic_filter, m.receiver_id,
                        m.incarnation)
    pt, dev = patchable_from_numpy(
        **{f: np.asarray(getattr(jb, f)) for f in ARENAS},
        matchings=[port_matching(m) for m in jb.matchings],
        tenant_root=jb.tenant_root, n_live=jb.n_live, salt=jb.salt,
        probe_len=jb.probe_len, max_levels=jb.max_levels,
        dead_slots=jb.dead_slots, garbage_slots=jb.garbage_slots,
        device="cpu")
    for f in ARENAS:
        assert getattr(pt, f).tobytes() == getattr(jb, f).tobytes(), f
    assert (pt.dead_slots, pt.garbage_slots) == (jb.dead_slots,
                                                 jb.garbage_slots)
    assert np.array_equal(dev.route_tab.numpy(),
                          tm.route_cols_from_node_tab(jb.node_tab))
    # the carried arena keeps patching exactly as the reference's does
    for p in (pt, jb):
        p.patch_add("T", (mk_route if p is pt else
                          lambda tf, rid: _jroute(tf, rid, 0))(
                              "more/x/#", "m1"))
    for f in ARENAS:
        assert getattr(pt, f).tobytes() == getattr(jb, f).tobytes(), f
    with pytest.raises(ValueError):
        patchable_from_numpy(
            **{f: np.asarray(getattr(jb, f)).astype(np.int64)
               for f in ARENAS},
            matchings=[], tenant_root={}, n_live=0, salt=0, probe_len=16,
            max_levels=8, device="cpu")
