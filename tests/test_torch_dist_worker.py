"""Port parity: the dist worker (the route table on the replicated KV
range, ``DistWorkerCoProc`` / ``DistWorker`` over ``TorchMatcher``)
against the reference.

Mirrors ``tests/test_dist_worker_coproc.py`` (a three-voter coproc
cluster on ``InMemTransport``: route mutations through consensus, every
replica serving from its own derived matcher — equal row for row to each
other and to the reference's matcher —, the incarnation guard, snapshot
restore rebuilding the matcher), ``tests/test_batch_mutations.py`` (batch
statuses and coalescence) and ``tests/test_range_split.py`` (split and
merge keep every route; matches equal the reference's in order). Then
the reset-from-KV path: a route table built on the reference worker,
carried across with ``models/state.kv_engine_from_items``, serves the
reference's matches from a port worker opened on it; and a seeded
add/remove sequence leaves the two route keyspaces byte-identical.
Tolerance: exact equality.
"""

import asyncio
import random

from bifromq_tpu.dist import worker as rdw
from bifromq_tpu.models.oracle import Route as RRoute
from bifromq_tpu.types import RouteMatcher as RMatcher
from bifromq_tpu_torch.dist import worker as dw
from bifromq_tpu_torch.kv.engine import InMemKVEngine
from bifromq_tpu_torch.kv.range import ReplicatedKVRange
from bifromq_tpu_torch.models.matcher import TorchMatcher
from bifromq_tpu_torch.models.oracle import Route
from bifromq_tpu_torch.models.state import kv_engine_from_items
from bifromq_tpu_torch.raft.node import RaftNode
from bifromq_tpu_torch.raft.transport import InMemTransport
from bifromq_tpu_torch.types import RouteMatcher

UNCAPPED = 1 << 30


def mk_route(tf, receiver="r0", broker=0, inc=0, dkey="d0"):
    return Route(matcher=RouteMatcher.from_topic_filter(tf),
                 broker_id=broker, receiver_id=receiver, deliverer_key=dkey,
                 incarnation=inc)


def mk_rroute(tf, receiver="r0", broker=0, inc=0, dkey="d0"):
    return RRoute(matcher=RMatcher.from_topic_filter(tf), broker_id=broker,
                  receiver_id=receiver, deliverer_key=dkey, incarnation=inc)


def cpu_matcher():
    return TorchMatcher(device="cpu")


def port_worker(**kw):
    return dw.DistWorker(matcher_factory=cpu_matcher, **kw)


def norm(m):
    """A row route for route, in order."""
    return (tuple((r.matcher.mqtt_topic_filter, r.receiver_url,
                   r.incarnation) for r in m.normal),
            tuple((f, tuple((r.receiver_url, r.incarnation) for r in ms))
                  for f, ms in m.groups.items()),
            m.max_persistent_fanout_exceeded, m.max_group_fanout_exceeded)


async def rows(w, queries, caps=(UNCAPPED, UNCAPPED)):
    res = await w.match_batch(queries, max_persistent_fanout=caps[0],
                              max_group_fanout=caps[1])
    return [norm(m) for m in res]


class CoProcCluster:
    def __init__(self, n=3):
        self.transport = InMemTransport()
        ids = [f"s{i}" for i in range(n)]
        self.coprocs = {}
        self.ranges = {}
        for nid in ids:
            cp = dw.DistWorkerCoProc(cpu_matcher())
            r = ReplicatedKVRange("dist", nid, ids, self.transport,
                                  InMemKVEngine().create_space("dist"),
                                  coproc=cp)
            self.transport.register(r.raft)
            self.coprocs[nid] = cp
            self.ranges[nid] = r

    def step(self):
        for r in self.ranges.values():
            r.raft.tick()
        self.transport.pump()

    def run_until(self, cond, max_ticks=3000):
        for _ in range(max_ticks):
            if cond():
                return
            self.step()
        raise AssertionError("condition not reached")

    def leader(self):
        for r in self.ranges.values():
            if r.is_leader and not r.raft.stopped:
                return r
        return None

    def elect(self):
        self.run_until(lambda: self.leader() is not None)
        return self.leader()

    async def drive(self, coro, max_ticks=3000):
        task = asyncio.get_running_loop().create_task(coro)
        for _ in range(max_ticks):
            await asyncio.sleep(0)
            if task.done():
                return await task
            self.step()
        task.cancel()
        raise AssertionError("did not complete")


def group_ops(seed=3, n=60):
    """Seeded routes of one tenant: wildcards, groups, persistent."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        lv = [rng.choice("abc+") for _ in range(rng.randint(1, 3))]
        tf = "/".join(lv)
        r = rng.random()
        if r < 0.2:
            tf = f"$share/g{i % 2}/{tf}"
        elif r < 0.3:
            tf = f"$oshare/g{i % 2}/{tf}"
        out.append((tf, f"r{i}", 1 if rng.random() < 0.3 else 0,
                    f"d{i % 3}"))
    return out


TOPICS = ["a", "a/b", "b/c/a", "c/c", "a/a/a", "b", "zz"]


class TestDistWorkerCoProc:
    async def test_add_route_and_match_through_consensus(self):
        c = CoProcCluster()
        leader = c.elect()
        out = await c.drive(leader.mutate_coproc(
            dw.encode_add_route("T", mk_route("a/+", receiver="rx"))))
        assert out == b"ok"
        reply = await c.drive(leader.query_coproc(
            dw.encode_match_query("T", ["a/b", "zzz"])))
        matches = dw.decode_match_reply(reply)
        assert [(r.broker_id, r.receiver_id, r.deliverer_key)
                for r in matches[0].all_routes()] == [(0, "rx", "d0")]
        assert matches[1].all_routes() == []

    async def test_every_replica_serves_the_reference_rows(self):
        """Each voter derives its own TorchMatcher from the apply stream;
        every replica's rows equal the others' and the reference
        matcher's (fed the same routes), in order."""
        from bifromq_tpu.models.matcher import TpuMatcher
        c = CoProcCluster()
        leader = c.elect()
        ref = TpuMatcher()
        ops = group_ops()
        await c.drive(leader.mutate_coproc(dw.encode_batch([
            dw.encode_add_route("T", mk_route(tf, recv, b, dkey=dk))
            for tf, recv, b, dk in ops])))
        for tf, recv, b, dk in ops:
            ref.add_route("T", mk_rroute(tf, recv, b, dkey=dk))
        c.run_until(lambda: all(
            len(cp.matcher.tries.get("T", ())) == len(ref.tries["T"])
            for cp in c.coprocs.values()))
        queries = [("T", t) for t in TOPICS]
        want = [norm(m) for m in ref.match_batch(
            queries, max_persistent_fanout=2, max_group_fanout=1)]
        assert any(w[0] or w[1] for w in want)
        for nid, cp in c.coprocs.items():
            got = [norm(m) for m in await cp.matcher.match_batch_async(
                queries, max_persistent_fanout=2, max_group_fanout=1)]
            assert got == want, nid

    async def test_incarnation_guard_through_coproc(self):
        c = CoProcCluster()
        leader = c.elect()
        await c.drive(leader.mutate_coproc(
            dw.encode_add_route("T", mk_route("a", inc=5))))
        out = await c.drive(leader.mutate_coproc(
            dw.encode_add_route("T", mk_route("a", inc=3))))
        assert out == b"stale"
        out = await c.drive(leader.mutate_coproc(
            dw.encode_remove_route("T", mk_route("a").matcher,
                                   (0, "r0", "d0"), incarnation=3)))
        assert out == b"stale"
        out = await c.drive(leader.mutate_coproc(
            dw.encode_remove_route("T", mk_route("a").matcher,
                                   (0, "r0", "d0"), incarnation=5)))
        assert out == b"ok"

    async def test_snapshot_restore_rebuilds_matcher(self):
        c = CoProcCluster()
        leader = c.elect()
        straggler = next(nid for nid, r in c.ranges.items()
                         if not r.is_leader)
        old = c.coprocs[straggler].matcher
        c.transport.partition({straggler}, set(c.ranges) - {straggler})
        for i in range(RaftNode.SNAPSHOT_THRESHOLD + 30):
            await c.drive(c.leader().mutate_coproc(
                dw.encode_add_route("T", mk_route(f"t/{i}",
                                                  receiver=f"r{i}"))))
        c.transport.heal()
        c.run_until(lambda: c.ranges[straggler].raft.commit_index
                    >= c.leader().raft.commit_index, max_ticks=5000)
        # the straggler's matcher was rebuilt (clone_empty, then replayed
        # from the restored keyspace) on the same device
        m = c.coprocs[straggler].matcher
        assert m is not old and m.device == old.device
        got = m.match("T", "t/5")
        assert [r.receiver_id for r in got.normal] == ["r5"]
        assert len(m.tries["T"]) == \
            len(c.coprocs[c.leader().raft.id].matcher.tries["T"])

    async def test_only_the_far_peer_gets_a_snapshot(self):
        """A deferred compaction keeps the reference's log: the snapshot
        shipped to a peer partitioned past ``SNAPSHOT_THRESHOLD`` is cut
        when it is asked for, and a peer only a few entries behind the
        log's cut still catches up from the log, under a new leader whose
        applied index ran past its cut."""
        c = CoProcCluster(n=5)
        old_leader = c.elect().raft.id
        far, few, a, b = [nid for nid in c.ranges if nid != old_leader]
        dumps = []
        for nid, r in c.ranges.items():
            real = r.raft._start_dump_session
            r.raft._start_dump_session = (
                lambda peer, nid=nid, real=real:
                dumps.append((nid, peer)) or real(peer))
        rest = set(c.ranges) - {far}
        c.transport.partition({far}, rest)
        for i in range(RaftNode.SNAPSHOT_THRESHOLD + 30):
            await c.drive(c.ranges[old_leader].mutate_coproc(
                dw.encode_add_route("T", mk_route(f"t/{i}",
                                                  receiver=f"r{i}"))))
        c.transport.partition({far}, {few}, rest - {few})
        for i in range(5):
            await c.drive(c.ranges[old_leader].mutate_coproc(
                dw.encode_add_route("T", mk_route(f"u/{i}"))))
        lead = c.ranges[old_leader].raft
        c.run_until(lambda: all(c.ranges[n].raft.last_applied
                                == lead.last_applied for n in (a, b)))
        # a new leader among {a, b}, elected with the lagging peer's vote
        c.transport.partition({far}, {old_leader}, {few, a, b})
        c.run_until(lambda: any(c.ranges[n].is_leader
                                and c.ranges[n].raft.term > lead.term
                                for n in (a, b)))
        new = next(c.ranges[n].raft for n in (a, b)
                   if c.ranges[n].is_leader)
        c.run_until(lambda: c.ranges[few].raft.commit_index
                    >= new.commit_index > lead.last_applied)
        # the far peer catches up from the new leader, then the old one
        c.transport.partition({old_leader}, set(c.ranges) - {old_leader})
        c.run_until(lambda: c.ranges[far].raft.commit_index
                    >= new.commit_index, max_ticks=5000)
        c.transport.heal()
        c.run_until(lambda: all(r.raft.commit_index >= new.commit_index
                                for r in c.ranges.values()),
                    max_ticks=5000)
        # the new leader shipped a snapshot cut past its log's offset,
        # which stayed where its own compaction put it
        assert {peer for _, peer in dumps} == {far} and (new.id, far) in dumps
        assert new.snap.last_index < lead.last_applied - 5
        assert new._shipped_snap.last_index >= lead.last_applied
        for nid, cp in c.coprocs.items():
            assert len(cp.matcher.tries["T"]) == \
                RaftNode.SNAPSHOT_THRESHOLD + 35, nid
            for tp, want in (("t/7", ["r7"]), ("u/4", ["r0"])):
                got = [r.receiver_id for r in cp.matcher.match("T", tp).normal]
                assert got == want, (nid, tp)


class TestBatchCoproc:
    async def test_batch_statuses_and_incarnation_guard(self):
        w = port_worker()
        await w.start()
        try:
            rid = next(iter(w.store.ranges))
            rng = w.store.ranges[rid]
            ops = [
                dw.encode_add_route("T", mk_route("a/b", "r1", inc=5)),
                dw.encode_add_route("T", mk_route("a/b", "r1", inc=3)),
                dw.encode_add_route("T", mk_route("a/b", "r1", inc=7)),
                dw.encode_add_route("T", mk_route("c/d", "r2")),
                dw.encode_remove_route(
                    "T", RouteMatcher.from_topic_filter("c/d"),
                    (0, "r2", "d0")),
                dw.encode_remove_route(
                    "T", RouteMatcher.from_topic_filter("no/such"),
                    (0, "rX", "d0")),
            ]
            out = await rng.mutate_coproc(dw.encode_batch(ops))
            statuses = dw.decode_batch_reply(out)
            # the stale add must see its batch-mate's inc=5 write (overlay)
            assert statuses == [b"ok", b"stale", b"exists", b"ok", b"ok",
                                b"missing"], statuses
            res = await w.match_batch([("T", ["a", "b"])],
                                      max_persistent_fanout=100,
                                      max_group_fanout=100)
            assert [r.receiver_id for r in res[0].all_routes()] == ["r1"]
        finally:
            await w.stop()

    async def test_concurrent_mutations_coalesce(self):
        w = port_worker()
        await w.start()
        try:
            outs = await asyncio.gather(*(
                w.add_route("T", mk_route(f"t/{i}", f"r{i}"))
                for i in range(500)))
            assert all(o == "ok" for o in outs)
            b = w._mutation_scheduler.batcher(next(iter(w.store.ranges)))
            # 500 concurrent ops must NOT be 500 raft entries
            assert b.batches_emitted < 250, b.batches_emitted
            res = await w.match_batch([("T", ["t", "7"])],
                                      max_persistent_fanout=100,
                                      max_group_fanout=100)
            assert [r.receiver_id for r in res[0].all_routes()] == ["r7"]
        finally:
            await w.stop()

    async def test_consensus_churn_coalesces(self):
        """4000 mutations in gathered chunks of 1000 (the reference
        test's shape) must land in a small fraction as many raft
        entries."""
        w = port_worker()
        await w.start()
        try:
            for chunk in range(0, 4000, 1000):
                await asyncio.gather(*(
                    w.add_route("T", mk_route(f"c/{i}", f"r{i}"))
                    for i in range(chunk, chunk + 1000)))
            entries = sum(w._mutation_scheduler.batcher(rid).batches_emitted
                          for rid in w.store.ranges)
            assert entries < 4000 / 4, entries
            assert len(w.space) == 4000
        finally:
            await w.stop()


def _spanning(prefix):
    """Wildcards whose keys fall on both sides of a median split (a key
    frames the filter with its length first, so "#" sorts first and the
    8-byte filters after every ``{prefix}/NNN/+``): a ``leaf`` topic
    matches routes in both ranges."""
    return [("#", 1), ("+/+/leaf", 0), (f"{prefix}/+/leaf", 1),
            (f"$share/g/{prefix}/#", 0), (f"$oshare/h/+/+/leaf", 1)]


async def _split_pair(n, prefix, at):
    """The same routes on a reference and a port worker, each split at
    its ``at``-th route key."""
    ref, port = rdw.DistWorker(), port_worker()
    for w, mk in ((ref, mk_rroute), (port, mk_route)):
        await w.start()
        for i in range(n):
            await w.add_route("T", mk(f"{prefix}/{i:03d}/+", f"r{i}",
                                      broker=i % 2))
        for j, (tf, broker) in enumerate(_spanning(prefix)):
            await w.add_route("T", mk(tf, f"w{j}", broker=broker))
        rid = next(iter(w.store.ranges))
        keys = [k for k, _ in w.store.ranges[rid].space.iterate()]
        await w.store.split(rid, keys[at])
        assert len(w.store.ranges) == 2
    return ref, port


class TestSplitMerge:
    async def test_split_preserves_all_routes(self):
        ref, port = await _split_pair(200, "s", 100)
        try:
            assert sum(len(r.space) for r in port.store.ranges.values()) \
                == 205
            assert [b for b, _ in port.store.router.ranges()] == \
                [b for b, _ in ref.store.router.ranges()]
            # a wildcard spanning the boundary unions both ranges, in the
            # reference's order, with the tenant caps re-applied
            queries = [("T", ["s", f"{i:03d}", "leaf"])
                       for i in (0, 42, 99, 100, 101, 199)]
            queries.append(("T", ["s", "042", "x"]))
            for caps in ((UNCAPPED, UNCAPPED), (1, 1)):
                got = await rows(port, queries, caps)
                assert got == await rows(ref, queries, caps)
            # the caps tripped on the union: two persistent routes (one a
            # range) and two groups (one a range) over a cap of one each
            assert all(r[2] and r[3] for r in got[:6])
            # mutations keep routing to the right range post-split
            for w, mk, M in ((ref, mk_rroute, RMatcher),
                             (port, mk_route, RouteMatcher)):
                assert await w.add_route("T", mk("s/000/+", "rX")) == "ok"
                assert await w.remove_route(
                    "T", M.from_topic_filter("s/199/+"),
                    (1, "r199", "d0")) == "ok"
            queries = [("T", ["s", "000", "x"]), ("T", ["s", "199", "x"])]
            got = await rows(port, queries)
            assert got == await rows(ref, queries)
            assert [r[0] for r in got[1][0]] == ["#"]
        finally:
            await ref.stop()
            await port.stop()

    async def test_merge_preserves_all_routes(self):
        ref, port = await _split_pair(100, "g", 50)
        try:
            for w in (ref, port):
                ordered = w.store.router.ranges()
                left, right = ordered[0][1], ordered[1][1]
                await w.store.merge(left, right)
                assert len(w.store.ranges) == 1
                assert w.store.boundaries[left] == (b"", None)
                assert len(w.store.ranges[left].space) == 105
            queries = [("T", ["g", f"{i:03d}", "leaf"])
                       for i in (0, 49, 50, 99)]
            queries.append(("T", ["g", "+"]))
            assert await rows(port, queries) == await rows(ref, queries)
            assert await port.add_route("T", mk_route("g/050/+", "rX")) \
                == "ok"
            assert await port.remove_route(
                "T", RouteMatcher.from_topic_filter("g/000/+"),
                (0, "r0", "d0")) == "ok"
        finally:
            await ref.stop()
            await port.stop()

    async def test_batch_in_flight_across_a_split(self):
        """A range's matcher is derived state: the split's reset swaps in
        ``clone_empty()`` while a batch is still in flight on the old
        matcher. The batch finishes on its own dispatch snapshot (its
        result is not read before it is ready), and the new matchers
        serve the union afterwards."""
        from test_torch_pipeline import _Gate, _gate_matcher, _spin
        w = port_worker()
        await w.start()
        try:
            for i in range(40):
                await w.add_route("T", mk_route(f"q/{i:02d}/+", f"r{i}"))
            await rows(w, [("T", ["q", "05", "y"])])    # base and ring
            (rid,) = list(w.store.ranges)
            old = w.store.coprocs[rid].matcher
            # topics no batch has served: the matcher's cache cannot
            # answer them, the batch must go to the (gated) device leg
            queries = [("T", ["q", f"{i:02d}", "x"]) for i in (0, 39)]
            want = [norm(m) for m in old.match_from_tries(queries)]
            gate = _Gate()
            _gate_matcher(old, gate)
            task = asyncio.get_running_loop().create_task(
                rows(w, queries))
            for _ in range(500):
                if old._ring.in_flight:
                    break
                await asyncio.sleep(0)
            assert old._ring.in_flight == 1 and not task.done()
            keys = [k for k, _ in w.store.ranges[rid].space.iterate()]
            await w.store.split(rid, keys[20])
            assert w.store.coprocs[rid].matcher is not old
            await _spin()
            assert not task.done()
            gate.open = True
            assert await task == want
            assert await rows(w, queries) == want
            assert await old.drain_device()
        finally:
            await w.stop()


def _mesh_matcher(mesh):
    from bifromq_tpu_torch.parallel.sharded import TorchMeshMatcher
    return TorchMeshMatcher(mesh=mesh, k_states=16, max_intervals=24,
                            probe_len=8, compact_threshold=64,
                            match_cache=False)


def test_mesh_clone_empty_keeps_the_mesh_and_knobs():
    from bifromq_tpu_torch.parallel.sharded import TorchMeshMatcher, \
        make_mesh
    mm = TorchMeshMatcher(mesh=make_mesh(2, 4, device="cpu"), max_levels=12,
                          probe_len=8, k_states=16, max_intervals=24,
                          auto_compact=False, compact_threshold=64,
                          match_cache=False)
    mm.add_route("T", mk_route("a/+"))
    c = mm.clone_empty()
    assert type(c) is TorchMeshMatcher and c is not mm
    assert c.mesh is mm.mesh and c.device == mm.device
    assert (c.n_replicas, c.n_shards) == (2, 4)
    for knob in ("max_levels", "probe_len", "k_states", "max_intervals",
                 "auto_compact", "compact_threshold"):
        assert getattr(c, knob) == getattr(mm, knob), knob
    assert c.match_cache is None and not c.tries
    assert TorchMeshMatcher(mesh=mm.mesh).clone_empty().match_cache \
        is not None


def _oracle_rows(w, queries):
    """Each query's rows from the ranges' host oracles
    (``match_from_tries``), unioned in router order, uncapped."""
    from bifromq_tpu_torch.kv import schema
    from bifromq_tpu_torch.models.oracle import MatchedRoutes
    out = []
    for tenant, levels in queries:
        pfx = schema.tenant_route_prefix(tenant)
        merged = MatchedRoutes()
        for rid in w.store.router.intersecting(pfx, schema.prefix_end(pfx)):
            m = w.store.coprocs[rid].matcher.match_from_tries(
                [(tenant, levels)])[0]
            merged.normal.extend(m.normal)
            for f, members in m.groups.items():
                merged.groups.setdefault(f, []).extend(members)
        out.append(norm(merged))
    return out


class TestMeshBackedSplit:
    async def test_split_keeps_mesh_matchers_on_both_halves(self):
        """A ``TorchMeshMatcher``-backed range split at its median key
        rebuilds both halves through ``clone_empty`` on the same mesh,
        and the two ranges serve the oracle's rows in order."""
        from bifromq_tpu_torch.parallel.sharded import TorchMeshMatcher, \
            make_mesh
        mesh = make_mesh(2, 4, device="cpu")
        w = dw.DistWorker(matcher_factory=lambda: _mesh_matcher(mesh))
        single = port_worker()
        try:
            for x in (w, single):
                await x.start()
                for i in range(60):
                    await x.add_route(f"T{i % 3}", mk_route(
                        f"m/{i:02d}/+", f"r{i}", broker=i % 2))
                for t in ("T0", "T1", "T2"):
                    for j, (tf, broker) in enumerate(_spanning("m")):
                        await x.add_route(t, mk_route(tf, f"w{j}",
                                                      broker=broker))
                (rid,) = list(x.store.ranges)
                keys = [k for k, _ in x.store.ranges[rid].space.iterate()]
                await x.store.split(rid, keys[len(keys) // 2])
                assert len(x.store.ranges) == 2
            matchers = [cp.matcher for cp in w.store.coprocs.values()]
            assert all(type(m) is TorchMeshMatcher and m.mesh is mesh
                       and m.k_states == 16 and m.max_intervals == 24
                       and m.match_cache is None for m in matchers)
            assert all(m.tries for m in matchers)
            queries = [(f"T{i % 3}", ["m", f"{i:02d}", leaf])
                       for i in (0, 1, 29, 30, 31, 59) for leaf in
                       ("leaf", "x")] + [("T1", ["zz"]), ("T9", ["m"])]
            # the replayed routes sit in the overlay, which serves the
            # host oracle's rows in its own order
            got = await rows(w, queries)
            assert got == _oracle_rows(w, queries)
            assert sum(len(r[0]) for r in got) > len(queries)
            # compiled into the shard tables, the rows come off the mesh's
            # walk in slot order: the single-table worker's order (which
            # the reference-parity tests above hold), the oracle's set
            for x in (w, single):
                for cp in x.store.coprocs.values():
                    cp.matcher.refresh()
            assert all(m.compile_count and not m.overlay_size
                       for m in matchers)
            got = await rows(w, queries)
            assert all(m.last_expanded is not None for m in matchers)
            assert got == await rows(single, queries)
            assert [(sorted(r[0]), r[1:]) for r in got] == \
                [(sorted(r[0]), r[1:]) for r in _oracle_rows(w, queries)]
        finally:
            await w.stop()
            await single.stop()


def _ref_spaces(engine):
    return {name: (list(sp.iterate()), dict(sp._meta))
            for name, sp in engine.spaces().items()}


class TestResetFromKV:
    async def test_kv_engine_from_items_serves_the_reference_table(self):
        """A route table built (and split) on the reference worker,
        carried across record for record, opens on the port worker
        through the coprocs' reset-from-KV path and serves the
        reference's rows in order."""
        ref = rdw.DistWorker()
        await ref.start()
        ops = group_ops(seed=5, n=80)
        for tenant in ("A", "B"):
            for tf, recv, b, dk in ops:
                await ref.add_route(tenant, mk_rroute(tf, recv, b, dkey=dk))
        rid = next(iter(ref.store.ranges))
        keys = [k for k, _ in ref.store.ranges[rid].space.iterate()]
        await ref.store.split(rid, keys[len(keys) // 2])
        port = port_worker(engine=kv_engine_from_items(
            _ref_spaces(ref.engine)))
        await port.start()
        try:
            assert sorted(port.store.ranges) == sorted(ref.store.ranges)
            for rid, cp in port.store.coprocs.items():
                # each range's matcher was replayed from its keyspace
                assert sum(len(t) for t in cp.matcher.tries.values()) == \
                    len(port.store.ranges[rid].space) > 0
            queries = [(t, topic) for t in ("A", "B", "C")
                       for topic in TOPICS]
            for caps in ((UNCAPPED, UNCAPPED), (3, 1)):
                assert await rows(port, queries, caps) == \
                    await rows(ref, queries, caps)
        finally:
            await ref.stop()
            await port.stop()

    async def test_seeded_ops_leave_identical_keyspaces(self):
        rng = random.Random(11)
        ref, port = rdw.DistWorker(), port_worker()
        await ref.start()
        await port.start()
        try:
            statuses = {id(ref): [], id(port): []}
            for _ in range(300):
                tenant = rng.choice("XYZ")
                tf = "/".join(rng.choice("ab+") for _ in range(
                    rng.randint(1, 3)))
                if rng.random() < 0.2:
                    tf = f"$share/g/{tf}"
                url = (rng.randint(0, 1), f"r{rng.randrange(8)}",
                       f"d{rng.randrange(2)}")
                inc = rng.randint(0, 3)
                add = rng.random() < 0.65
                for w, mk, M in ((ref, mk_rroute, RMatcher),
                                 (port, mk_route, RouteMatcher)):
                    if add:
                        out = await w.add_route(tenant, mk(
                            tf, url[1], url[0], inc, url[2]))
                    else:
                        out = await w.remove_route(
                            tenant, M.from_topic_filter(tf), url, inc)
                    statuses[id(w)].append(out)
            assert statuses[id(port)] == statuses[id(ref)]
            assert {"ok", "exists", "stale", "missing"} <= \
                set(statuses[id(ref)])
            assert list(port.space.iterate()) == list(ref.space.iterate())
        finally:
            await ref.stop()
            await port.stop()
