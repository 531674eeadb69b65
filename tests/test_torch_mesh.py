"""Port parity: the tenant-sharded mesh serving path against MeshMatcher.

``TorchMeshMatcher`` on a CPU ``make_mesh`` (the plain versions of the
walk, expansion and ring-hop kernels) and the reference ``MeshMatcher``
on the 8 virtual CPU devices ``conftest.py`` forces serve one query
stream over BASELINE config 5's tenant population at test size
(``config_multi_tenant(12, 600)``), on a 2x4 and a 1x4 mesh:

- once as generated (keys ``d{i % 64}`` name no server: ``n_peers = 0``);
- once with every route's deliverer key rewritten to ``srv{i % 3}|d{i}``
  in both packages' tries (3 peers), with a 1-pair expansion budget so
  buffer-truncated rows re-expand on the host;
- on the 2x4 mesh, again after overlay mutations (an add, a remove and a
  new tenant) on both sides.

The reference runs its device-expand path (``BIFROMQ_DEVICE_EXPAND=1``)
with the overlay mutation path (``BIFROMQ_MESH_PATCH=0``), set on its
side only; each reference matcher is built once per test process. Queries
include an unknown tenant, a ``$SYS`` topic, a pre-parsed level list and
a topic past ``max_levels``. A served batch expands all R·S blocks in one
``kernel_expand`` call. Tolerance: exact equality — ordered
``MatchedRoutes`` lists, per-block pair and bucket arrays, the
ring-merged ``peer_totals`` of every mesh slot, and the stacked tables.
"""

import dataclasses
import functools
import random

import numpy as np
import pytest
import torch

from bifromq_tpu import workloads as jw
from bifromq_tpu.parallel import sharded as js
from bifromq_tpu_torch import workloads as tw
from bifromq_tpu_torch.parallel import sharded as ts

MESHES = ((2, 4), (1, 4))
KEYS = ("generated", "srv")
EXPAND_CAP = {"generated": None, "srv": "1"}
KW = dict(k_states=16, auto_compact=False)
PAIR_FIELDS = ("slots", "rows", "row_offsets", "n_pairs", "trunc",
               "peer_slots", "peer_rows", "peer_offsets")


def _tries(workloads, keys):
    tries = workloads.config_multi_tenant(n_tenants=12, total_subs=600,
                                          seed=0)
    if keys == "srv":
        i = 0
        for tenant, trie in list(tries.items()):
            routes = list(trie.routes())
            trie = type(trie)()
            for r in routes:
                trie.add(dataclasses.replace(
                    r, deliverer_key=f"srv{i % 3}|d{i}"))
                i += 1
            tries[tenant] = trie
    return tries


def _queries():
    """config-5 traffic (Zipf-by-rank tenants over probe topics), topics
    made from subscribed filters so rows match, and the edge rows."""
    tries = jw.config_multi_tenant(n_tenants=12, total_subs=600, seed=0)
    tenants = sorted(tries)
    cum, acc = [], 0.0
    for i in range(len(tenants)):
        acc += 1.0 / (i + 1)
        cum.append(acc)
    rng = random.Random(3)
    topics = ["/".join(t) for t in jw.probe_topics(96, seed=1)]
    qs = list(zip(rng.choices(tenants, cum_weights=cum, k=96), topics))
    for tenant in tenants:
        for r in list(tries[tenant].routes())[:10]:
            levels = [("l0" if lv == "+" else lv)
                      for lv in r.matcher.filter_levels if lv != "#"]
            qs.append((tenant, "/".join(levels + ["l1"] * (len(qs) % 2))))
    # hot rows, repeated as hot topics are: the widest fan-outs at this
    # size (8 and 5 routes), enough to overrun a 1-pair-per-row buffer
    qs += [("tenant0", "l0")] * 16 + [("tenant2", "l0/l1")] * 8
    qs += [("ghost", "l0/l1"), ("tenant0", "$SYS/l0"),
           ("tenant1", ["l0", "l1"]), ("tenant2", "/".join(["l0"] * 20))]
    return qs


QUERIES = _queries()


def _mutate(m, Route, RouteMatcher):
    """The same overlay mutations on either package's matcher."""
    r = next(iter(m.tries["tenant0"].routes()))
    assert m.remove_route("tenant0", r.matcher, r.receiver_url,
                          r.incarnation)
    for tenant, f in (("tenant1", "l0/+/#"), ("ghost", "l0/#")):
        assert m.add_route(tenant, Route(RouteMatcher.from_topic_filter(f),
                                         0, f"new-{tenant}", "srv0|x"))


def _norm(m):
    return (tuple((r.matcher.mqtt_topic_filter, r.receiver_url, r.broker_id,
                   r.incarnation) for r in m.normal),
            tuple((f, tuple(r.receiver_url for r in ms))
                  for f, ms in m.groups.items()),
            m.persistent_fanout, m.max_persistent_fanout_exceeded,
            m.max_group_fanout_exceeded)


def _served(m, queries):
    res = m.match_batch(queries)
    pairs, tab = m.last_expanded
    return dict(
        routes=[_norm(x) for x in res],
        pairs={f: np.asarray(getattr(pairs, f)) for f in PAIR_FIELDS},
        totals=np.asarray(pairs.res.peer_totals), peers=list(tab.peers),
        tables=m._base_ct)


@functools.lru_cache(maxsize=None)
def _reference(keys, shape):
    """The reference's serve of one (keys, mesh) variant, built once per
    process (each test process builds only the variants its tests use);
    the 2x4 "generated" variant also serves again after ``_mutate``."""
    from bifromq_tpu.models.oracle import Route
    from bifromq_tpu.types import RouteMatcher
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BIFROMQ_DEVICE_EXPAND", "1")
        mp.setenv("BIFROMQ_MESH_PATCH", "0")
        _set_expand_cap(mp, keys)
        m = js.MeshMatcher(_tries(jw, keys), mesh=js.make_mesh(*shape),
                           match_cache=False, **KW)
        out = _served(m, QUERIES)
        if (keys, shape) == ("generated", (2, 4)):
            _mutate(m, Route, RouteMatcher)
            out["mutated"] = _served(m, QUERIES)
    return out


def _set_expand_cap(mp, keys):
    if EXPAND_CAP[keys]:
        mp.setenv("BIFROMQ_EXPAND_CAP", EXPAND_CAP[keys])
    else:
        mp.delenv("BIFROMQ_EXPAND_CAP", raising=False)


def _port(keys, shape, monkeypatch):
    _set_expand_cap(monkeypatch, keys)
    return ts.TorchMeshMatcher(
        _tries(tw, keys), mesh=ts.make_mesh(*shape, device="cpu"),
        match_cache=False, **KW)


def _assert_same(ref, got, shape):
    assert got["routes"] == ref["routes"]
    for f in PAIR_FIELDS:
        assert np.array_equal(got["pairs"][f], ref["pairs"][f]), f
    assert got["peers"] == ref["peers"]
    # every mesh slot holds the ring-merged totals the reference returns
    r, s = shape
    assert got["totals"].shape == (r, s) + ref["totals"].shape
    for rep in range(r):
        for sh in range(s):
            assert np.array_equal(got["totals"][rep, sh], ref["totals"])
    # the ring's ledger counts every live pair once (pad bucket last)
    assert int(ref["totals"][:-1].sum()) == int(ref["pairs"]["n_pairs"].sum())


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("keys", KEYS)
def test_mesh_serve_equals_mesh_matcher(keys, shape, monkeypatch):
    ref = _reference(keys, shape)
    got = _served(_port(keys, shape, monkeypatch), QUERIES)
    _assert_same(ref, got, shape)
    assert len(got["peers"]) == (3 if keys == "srv" else 0)
    if keys == "srv":
        assert got["pairs"]["trunc"].any()
    # the walked rows matched routes, not only the oracle's rows
    assert sum(len(r[0]) for r in got["routes"]) > 100


def test_mesh_overlay_equals_mesh_matcher(monkeypatch):
    from bifromq_tpu_torch.models.oracle import Route
    from bifromq_tpu_torch.types import RouteMatcher
    m = _port("generated", (2, 4), monkeypatch)
    ref = _reference("generated", (2, 4))
    _assert_same(ref, _served(m, QUERIES), (2, 4))
    _mutate(m, Route, RouteMatcher)
    assert m.overlay_size == 3 and m.compile_count == 1
    _assert_same(ref["mutated"], _served(m, QUERIES), (2, 4))


def test_mesh_expands_every_block_in_one_call(monkeypatch):
    """Each served mesh batch makes exactly one expansion call, with the
    whole ``[R·S, b, A]`` grid, and still equals the reference."""
    from bifromq_tpu_torch.models import kernels as tk
    calls = []
    real = tk.kernel_expand

    def counted(ivl_s, ivl_c, *, cap):
        calls.append(tuple(ivl_s.shape))
        return real(ivl_s, ivl_c, cap=cap)
    monkeypatch.setattr(tk, "kernel_expand", counted)
    m = _port("srv", (2, 4), monkeypatch)
    got = _served(m, QUERIES)
    _assert_same(_reference("srv", (2, 4)), got, (2, 4))
    assert len(calls) == 1 and len(calls[0]) == 3 and calls[0][0] == 8
    m.match_batch(QUERIES[:40])
    assert len(calls) == 2


def test_config_multi_tenant_equals_reference():
    def flat(tries):
        return [(t, r.matcher.mqtt_topic_filter, r.receiver_url,
                 r.deliverer_key) for t, trie in tries.items()
                for r in trie.routes()]
    got = flat(tw.config_multi_tenant(n_tenants=40, total_subs=900, seed=5))
    assert got == flat(jw.config_multi_tenant(n_tenants=40, total_subs=900,
                                              seed=5))
    assert len({t for t, *_ in got}) == 40
    named = tw.config_multi_tenant(n_tenants=3, total_subs=30, seed=5,
                                   deliverer_key=lambda t, i: f"s{t}|{i}")
    assert {r.deliverer_key for r in named["tenant1"].routes()} == \
        {f"s1|{i}" for i in range(len(named["tenant1"]))}


@pytest.mark.parametrize("n_shards", (1, 3, 4))
def test_build_sharded_equals_reference(n_shards):
    ref = js.build_sharded(_tries(jw, "generated"), n_shards)
    got = ts.build_sharded(_tries(tw, "generated"), n_shards)
    for f in ("edge_tab", "route_tab", "child_list"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    tenants = list(_tries(tw, "generated")) + ["ghost"]
    assert [got.shard_of(t) for t in tenants] == \
        [ref.shard_of(t) for t in tenants]
    assert [got.root_of(t) for t in tenants] == \
        [ref.root_of(t) for t in tenants]


def test_mesh_tables_equal_reference():
    got = ts.build_sharded(_tries(tw, "generated"), 4)
    ref = _reference("generated", (2, 4))["tables"]
    for f in ("edge_tab", "route_tab", "child_list"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f


def test_mesh_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        ts.make_mesh(2, 4)
    with pytest.raises(RuntimeError):
        ts.TorchMeshMatcher(mesh=ts.MeshShape(2, 4, torch.device("cuda")))
    with pytest.raises(ValueError):
        ts.TorchMeshMatcher()
