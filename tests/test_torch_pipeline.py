"""Port parity: the pipelined serving leg (``match_batch_async`` through the
``DispatchRing``) on ``TorchMatcher(device="cpu")``.

Mirrors ``tests/test_pipeline.py``: the ring's queue-depth-adaptive pad
floor, its slot bound and cancellation hygiene, in-flight overlap through
the ring, the _InFlight snapshot discipline under mid-flight mutations
and compaction swaps, and the safety of patch flushes while a batch is in
flight (the port's counterpart of the reference's donation tests: a
flush with another batch in flight writes new table tensors). Readiness
is gated by the test (a CPU walk completes before anyone could observe
the overlap): a gated result reports not ready, and fails on any read,
until its gate opens. The Batcher's adaptive caps (``scheduler/``) come
with the broker assembly.

Two more hold the port against the reference: the same seeded routes and
queries through ``TpuMatcher.match_batch_async`` (on the CPU, as its own
tests run it) and ``TorchMatcher.match_batch_async`` give identical
``MatchedRoutes`` in identical order, cache on and off, and so do two
batches in flight with a subscription landing between their dispatches.
Tolerance: exact equality.
"""

import asyncio
import random

import pytest

from bifromq_tpu.models.matcher import TpuMatcher
from bifromq_tpu.models.oracle import Route as JRoute
from bifromq_tpu.types import RouteMatcher as JMatcher
from bifromq_tpu_torch import workloads as tw
from bifromq_tpu_torch.models.matcher import TorchMatcher
from bifromq_tpu_torch.models.oracle import Route
from bifromq_tpu_torch.models.pipeline import (DispatchRing, pipeline_depth,
                                               pipeline_min_floor)
from bifromq_tpu_torch.types import RouteMatcher


def mk_route(topic_filter: str, receiver: str, incarnation: int = 0):
    return Route(matcher=RouteMatcher.from_topic_filter(topic_filter),
                 broker_id=0, receiver_id=receiver, deliverer_key="d0",
                 incarnation=incarnation)


def mk_matcher(match_cache=False, **kw):
    kw.setdefault("k_states", 8)
    return TorchMatcher(device="cpu", max_levels=8, auto_compact=False,
                        match_cache=match_cache, **kw)


class _Gate:
    def __init__(self) -> None:
        self.open = False


class _GatedLeaf:
    """A readiness leaf the test controls: the card is 'still walking'
    until the gate opens."""

    def __init__(self, gate: _Gate) -> None:
        self._gate = gate

    def is_ready(self) -> bool:
        return self._gate.open

    def copy_to_host_async(self) -> None:
        pass


class _GatedResult:
    """A dispatched result behind a gate: its readiness leaf is the gate,
    and any read of the result before the gate opens fails (a fetch that
    did not wait for readiness)."""

    def __init__(self, res, gate: _Gate) -> None:
        self.__dict__.update(_res=res, _gate=gate, reads=0)

    def ready_leaves(self):
        return (_GatedLeaf(self._gate),)

    def __getattr__(self, name):
        self.__dict__["reads"] += 1
        assert self._gate.open, "result read before it was ready"
        return getattr(self._res, name)


def _gate_matcher(m: TorchMatcher, gate: _Gate, seen=None):
    """Wrap the dispatch so each batch's result reports not-ready until
    the gate opens; ``seen`` collects the batches' _InFlight records."""
    real = m._dispatch_prepared

    def gated(prep, **kw):
        fl = real(prep, **kw)
        fl.res = _GatedResult(fl.res, gate)
        if seen is not None:
            seen.append(fl)
        return fl

    m._dispatch_prepared = gated


async def _spin(n: int = 10) -> None:
    for _ in range(n):
        await asyncio.sleep(0)


def _ids(res):
    return sorted(r.receiver_id for r in res.normal)


def _norm(m):
    return (tuple((r.matcher.mqtt_topic_filter, r.receiver_url,
                   r.incarnation) for r in m.normal),
            tuple((f, tuple(r.receiver_url for r in ms))
                  for f, ms in m.groups.items()),
            m.persistent_fanout)


# ---------------- adaptive pad floor ----------------------------------------


class TestAdaptiveSizing:
    """The ring's occupancy picks the pow2 pad floor of the next batch:
    alone on an idle ring a batch pads to the latency floor, behind a
    batch in flight to the throughput floor."""

    @staticmethod
    def _record_batches(m):
        sizes = []
        real = m._prepare_probes

        def rec(queries, batch=None):
            sizes.append(batch)
            return real(queries, batch)
        m._prepare_probes = rec
        return sizes

    async def test_idle_ring_pads_to_latency_floor(self):
        m = mk_matcher()
        m.add_route("T", mk_route("a/b", "r1"))
        m.refresh()
        sizes = self._record_batches(m)
        res = await m.match_batch_async([("T", "a/b")])
        assert _ids(res[0]) == ["r1"]
        assert sizes == [m._ring.min_floor] == [8]

    async def test_busy_ring_pads_to_throughput_floor(self):
        m = mk_matcher()
        m.add_route("T", mk_route("a/b", "r1"))
        m.refresh()
        gate = _Gate()
        _gate_matcher(m, gate)
        sizes = self._record_batches(m)
        t1 = asyncio.ensure_future(m.match_batch_async([("T", "a/b")]))
        await _spin()
        t2 = asyncio.ensure_future(m.match_batch_async([("T", "a/c")]))
        await _spin()
        gate.open = True
        await asyncio.gather(t1, t2)
        assert sizes == [8, 16]

    def test_knobs_clamp(self, monkeypatch):
        monkeypatch.setenv("BIFROMQ_PIPELINE_DEPTH", "99")
        monkeypatch.setenv("BIFROMQ_PIPELINE_MIN_BATCH", "0")
        assert pipeline_depth() == 8 and pipeline_min_floor() == 1
        monkeypatch.setenv("BIFROMQ_PIPELINE_DEPTH", "3")
        monkeypatch.setenv("BIFROMQ_PIPELINE_MIN_BATCH", "4")
        ring = DispatchRing()
        assert (ring.depth, ring.min_floor, ring.base_floor) == (3, 4, 16)


# ---------------- dispatch ring -------------------------------------------


class TestDispatchRing:
    async def test_ring_bounds_inflight_and_tracks_peak(self):
        ring = DispatchRing(depth=2)
        await ring.acquire()
        await ring.acquire()
        assert ring.in_flight == 2
        third = asyncio.ensure_future(ring.acquire())
        await asyncio.sleep(0)
        assert not third.done()         # parked: ring is full
        assert ring.waiting == 1
        ring.release()
        await asyncio.sleep(0)
        assert third.done()
        assert ring.peak_inflight == 2
        ring.release()
        ring.release()

    async def test_cancelled_waiter_withdraws_from_queue(self):
        """A parked waiter that gets cancelled must not linger in the
        waiter deque — a stale entry overcounts ring.waiting and pins
        effective_floor at the throughput floor on an idle ring."""
        ring = DispatchRing(depth=1, min_floor=8)
        await ring.acquire()
        parked = asyncio.ensure_future(ring.acquire())
        await asyncio.sleep(0)
        assert ring.waiting == 1
        parked.cancel()
        await asyncio.sleep(0)
        assert ring.waiting == 0
        assert ring.effective_floor() == 8      # idle again: latency floor
        ring.release()
        await ring.acquire()
        ring.release()

    async def test_effective_floor_shallow_vs_busy(self):
        ring = DispatchRing(depth=3, min_floor=8)
        await ring.acquire()
        assert ring.effective_floor() == 8      # alone in flight: latency
        await ring.acquire()
        assert ring.effective_floor() == 16     # concurrency: throughput
        ring.release()
        ring.release()


    async def test_overlap_counts_only_pending_device_work(self):
        """``overlapped_total`` counts a dispatch only while an earlier
        batch's result is still not ready."""
        ring = DispatchRing(depth=3)
        gate = _Gate()
        first, second = (_GatedResult(object(), gate) for _ in range(2))
        ring.start_fetch(first)
        assert ring.overlapped_total == 0
        ring.start_fetch(second)                # first still walking
        assert ring.overlapped_total == 1
        gate.open = True
        ring.start_fetch(_GatedResult(object(), _Gate()))
        assert ring.overlapped_total == 1       # both finished: none

    async def test_wait_ready_checks_before_yielding(self):
        """A result the device has finished returns at once: the first
        readiness check comes before any yield to the loop."""
        ran = []

        async def other():
            ran.append(1)
        task = asyncio.ensure_future(other())
        gate = _Gate()
        gate.open = True
        await DispatchRing.wait_ready(_GatedResult(object(), gate))
        assert ran == []
        await task
        assert ran == [1]


class TestFetchPath:
    """What a batch moves between host and card must not wait for the
    batches queued behind it on the stream."""

    def test_upload_is_a_copy(self):
        import numpy as np
        from bifromq_tpu_torch.utils.device import upload
        a = np.arange(4, dtype=np.int32)
        b = np.array([[True, False]])
        ta, tb = upload([a, b], "cpu")
        a[0] = 9
        b[0, 0] = False
        assert ta.tolist() == [0, 1, 2, 3] and tb.tolist() == [[True, False]]

    def test_truncated_rows_read_grids_from_the_fetch_set(self):
        """The interval grids of buffer-truncated rows come from the
        result's fetch set, never from a blocking read of the device
        tensors."""
        grids = {"start": object(), "count": object()}

        class Fetch:
            def arrays(self):
                return grids

        class Res:
            def host_fetch(self):
                return Fetch()

            @property
            def start(self):
                raise AssertionError("blocking read of the device grid")

        assert TorchMatcher._fetch_escalation_grids(Res()) == (
            grids["start"], grids["count"])

    def test_fetch_set_holds_the_grids(self):
        from bifromq_tpu_torch.ops.match import FETCH_LEAVES
        assert {"start", "count"} <= set(FETCH_LEAVES)


# ---------------- matcher async pipeline -----------------------------------


@pytest.fixture(scope="module")
def matcher():
    m = mk_matcher(match_cache=True)
    m.add_route("T", mk_route("a/b", "r1"))
    m.add_route("T", mk_route("a/+", "r2"))
    m.add_route("T", mk_route("x/#", "r3"))
    m.add_route("T", mk_route("deep/q/w", "r4"))
    m.refresh()
    return m


class TestMatcherAsync:
    async def test_async_parity_with_sync(self, matcher):
        qs = [("T", ["a", "b"]), ("T", ["x", "y", "z"]),
              ("T", ["deep", "q", "w"]), ("T", ["nomatch"])]
        sync = matcher.match_batch(qs)
        matcher.match_cache.bump_all()
        got = await matcher.match_batch_async(qs)
        for a, b in zip(got, sync):
            assert _ids(a) == _ids(b)

    async def test_two_batches_in_flight_concurrently(self):
        m = mk_matcher()
        m.add_route("T", mk_route("a/b", "r1"))
        m.refresh()
        gate = _Gate()
        _gate_matcher(m, gate)
        t1 = asyncio.ensure_future(
            m.match_batch_async([("T", ["a", "b"])], batch=16))
        t2 = asyncio.ensure_future(
            m.match_batch_async([("T", ["a", "c"])], batch=16))
        await _spin()
        ring = m._ring
        assert ring.in_flight >= 2, \
            "batch N+1 must dispatch while batch N is still walking"
        gate.open = True
        r1, r2 = await asyncio.gather(t1, t2)
        assert _ids(r1[0]) == ["r1"]
        assert _ids(r2[0]) == []
        assert ring.peak_inflight >= 2
        assert ring.overlapped_total >= 1

    async def test_finished_batches_do_not_overlap(self):
        """Batches whose results are ready when first polled hold their
        slot only until that poll: two of them never share the ring."""
        m = mk_matcher()
        m.add_route("T", mk_route("a/b", "r1"))
        m.refresh()
        r1, r2 = await asyncio.gather(
            m.match_batch_async([("T", ["a", "b"])], batch=16),
            m.match_batch_async([("T", ["a", "c"])], batch=16))
        assert _ids(r1[0]) == ["r1"] and _ids(r2[0]) == []
        assert m._ring.peak_inflight == 1
        assert m._ring.overlapped_total == 0

    async def test_ring_depth_bounds_inflight(self):
        m = mk_matcher()
        m.add_route("T", mk_route("a/b", "r1"))
        m.refresh()
        gate = _Gate()
        _gate_matcher(m, gate)
        m._pipeline_ring().depth = 2
        tasks = [asyncio.ensure_future(
            m.match_batch_async([("T", ["a", str(i)])], batch=16))
            for i in range(5)]
        await _spin()
        assert m._ring.in_flight == 2
        # the 3 excess callers park behind TWO gates: prep tickets
        # (depth + 1, held for the whole slot tenure) let exactly ONE
        # caller prepare ahead and park at the slot gate; the other 2
        # wait unprepared at the prep gate
        assert m._ring.waiting == 1
        assert m._ring.prepping == 3        # 2 in flight + 1 prep-ahead
        assert m._ring._prep.waiting == 2
        gate.open = True
        await asyncio.gather(*tasks)
        assert m._ring.in_flight == 0
        assert m._ring.prepping == 0

    async def test_mutation_mid_flight_defeats_cache_store(self):
        m = mk_matcher(match_cache=True)
        m.add_route("T", mk_route("a/b", "r1"))
        m.refresh()
        gate = _Gate()
        _gate_matcher(m, gate)
        task = asyncio.ensure_future(
            m.match_batch_async([("T", ["a", "b"])], batch=16))
        await _spin()
        # a second subscriber lands WHILE the walk is in flight
        m.add_route("T", mk_route("a/b", "r9"))
        gate.open = True
        await task
        # the in-flight result must not have been stamped into the cache
        res = m.match_batch([("T", ["a", "b"])])
        assert _ids(res[0]) == ["r1", "r9"]

    async def test_compaction_swap_mid_flight_keeps_overlay(self):
        """_InFlight snapshot discipline: a blocking compaction swapping
        the base between dispatch and fetch must not lose overlay routes
        the old-base expansion needs."""
        m = mk_matcher()
        m.add_route("T", mk_route("a/b", "r1"))
        m.refresh()
        # a group add without members is declined by the patcher and
        # served from the overlay (the reference's overlay-only route)
        m._overlay_record(("add", "T", mk_route("a/+", "r2")))
        m.tries["T"].add(mk_route("a/+", "r2"))
        m._log.append(("add", "T", mk_route("a/+", "r2")))
        assert m.overlay_size == 1
        gate = _Gate()
        _gate_matcher(m, gate)
        task = asyncio.ensure_future(
            m.match_batch_async([("T", ["a", "b"])], batch=16))
        await _spin()
        m.refresh()     # folds r2 into a fresh base, clears the overlay
        assert m.overlay_size == 0
        gate.open = True
        res = await task
        assert _ids(res[0]) == ["r1", "r2"]

    async def test_pipeline_kill_switch(self, matcher, monkeypatch):
        monkeypatch.setenv("BIFROMQ_PIPELINE", "0")
        matcher.match_cache.bump_all()
        res = await matcher.match_batch_async([("T", ["a", "b"])])
        assert _ids(res[0]) == ["r1", "r2"]
        # the sync path never touched the ring
        assert matcher._ring is None or matcher._ring.in_flight == 0

    async def test_mesh_takes_the_sync_leg(self):
        from bifromq_tpu_torch.parallel import sharded
        mm = sharded.TorchMeshMatcher.from_tries(
            tw.config_multi_tenant(8, 80, seed=0),
            mesh=sharded.make_mesh(1, 2, device="cpu"))
        assert not mm.supports_async and mm.device_breaker is None
        qs = [(f"tenant{i % 8}", "/".join(t))
              for i, t in enumerate(tw.probe_topics(16, seed=2))]
        got = await mm.match_batch_async(qs)
        assert [_norm(r) for r in got] == \
            [_norm(r) for r in mm.match_batch(qs)]
        assert mm._ring is None


class TestDonationSafety:
    """A patch flush writes the serving tables in place only while no
    other batch is in flight; otherwise it writes new tensors, so a batch
    in flight — its escalation re-walk included — keeps the tables it was
    dispatched on."""

    async def test_flush_with_batch_in_flight_writes_new_tables(self):
        m = mk_matcher()
        m.add_route("T", mk_route("a/b", "r1"))
        m.refresh()
        await m.match_batch_async([("T", "a/b")])     # the ring exists
        # idle ring: the flush writes the tables in place
        m.add_route("T", mk_route("a/c", "r2"))
        before = m._device_trie.route_tab
        await m.match_batch_async([("T", "a/c")])
        assert m._device_trie.route_tab is before
        assert m.patch_flushes_undonated == 0
        # a batch in flight: the next flush leaves its tables alone
        gate = _Gate()
        seen = []
        _gate_matcher(m, gate, seen)
        t1 = asyncio.ensure_future(m.match_batch_async([("T", "a/b")]))
        await _spin()
        snapshot = {f: getattr(seen[0].dev, f).clone()
                    for f in ("node_tab", "edge_tab", "route_tab")}
        m.add_route("T", mk_route("a/+", "r3"))
        t2 = asyncio.ensure_future(m.match_batch_async([("T", "a/d")]))
        await _spin()
        assert m.patch_flushes_undonated == 1
        assert seen[1].dev.route_tab is not seen[0].dev.route_tab
        for f, want in snapshot.items():
            assert getattr(seen[0].dev, f).equal(want), f
        gate.open = True
        r1, r2 = await asyncio.gather(t1, t2)
        assert _ids(r1[0]) == ["r1"]        # as of its dispatch
        assert _ids(r2[0]) == ["r3"]

    async def test_escalated_rows_walk_their_own_tables(self):
        """Batch N's overflow rows re-walk after batch N+1's flush; they
        must still see the tables N was dispatched on (a donated flush
        would hand them the new subscription)."""
        m = mk_matcher(k_states=1, max_intervals=1)
        for i in range(6):
            m.add_route("T", mk_route(f"a/{'+' if i % 2 else 'b'}/#",
                                      f"r{i}"))
        m.refresh()
        await m.match_batch_async([("T", "q")])       # the ring exists
        gate = _Gate()
        seen = []
        _gate_matcher(m, gate, seen)
        queries = [("T", "a/b/c"), ("T", "a/x/y")]
        want = m.match_from_tries(queries)
        t1 = asyncio.ensure_future(m.match_batch_async(queries))
        await _spin()
        m.add_route("T", mk_route("a/+/#", "late"))
        t2 = asyncio.ensure_future(m.match_batch_async(queries))
        await _spin()
        gate.open = True
        r1, r2 = await asyncio.gather(t1, t2)
        assert [_ids(r) for r in r1] == [_ids(r) for r in want]
        assert all("late" in _ids(r) for r in r2)
        assert m.patch_flushes_undonated == 1

    async def test_pipelined_serving_repeats_correctly(self):
        m = mk_matcher()
        m.add_route("T", mk_route("a/b", "r1"))
        m.add_route("T", mk_route("a/+", "r2"))
        m.refresh()
        for _ in range(4):
            res = await m.match_batch_async(
                [("T", ["a", "b"]), ("T", ["a", "q"])])
            assert _ids(res[0]) == ["r1", "r2"]
            assert _ids(res[1]) == ["r2"]


# ---------------- parity with the reference's pipelined leg ------------------


FILTERS = ["a/b", "a/+", "a/#", "+/b", "x/y/z", "a/b/c", "#", "lit/p",
           "$share/g1/a/b", "$share/g1/a/+", "$oshare/g2/a/b", "deep/1/2/3"]
TOPICS = ["a/b", "a/c", "a/b/c", "x/y/z", "lit/p", "q", "deep/1/2/3",
          "a/b/c/d"]


def _pair(match_cache):
    kw = dict(max_levels=8, k_states=4, max_intervals=4, auto_compact=False,
              match_cache=match_cache)
    ref, port = TpuMatcher(**kw), TorchMatcher(device="cpu", **kw)
    for i in range(30):
        tf, tenant = FILTERS[i % len(FILTERS)], f"T{i % 2}"
        ref.add_route(tenant, JRoute(JMatcher.from_topic_filter(tf), 0,
                                     f"r{i}", "d0", i))
        port.add_route(tenant, mk_route(tf, f"r{i}", i))
    ref.refresh()
    port.refresh()
    return ref, port


def _queries(rng, n=12):
    qs = [(f"T{rng.randrange(3)}", rng.choice(TOPICS)) for _ in range(n)]
    return qs + qs[:3]                  # in-batch duplicates


@pytest.mark.parametrize("match_cache", [False, True],
                         ids=["cache_off", "cache_on"])
async def test_async_rows_equal_the_reference(match_cache):
    ref, port = _pair(match_cache)
    rng = random.Random(5)
    for _ in range(3):
        qs = _queries(rng)
        want = await ref.match_batch_async(qs, batch=16)
        got = await port.match_batch_async(qs, batch=16)
        assert [_norm(x) for x in got] == [_norm(x) for x in want]


def _gate_reference(m, gate):
    """The reference test's gate: the primary walk's result leaves report
    not-ready until the gate opens."""
    import numpy as np
    from bifromq_tpu.ops.match import RouteIntervals

    class Leaf:
        def __init__(self, arr):
            self._arr = np.asarray(arr)

        def is_ready(self):
            return gate.open

        def copy_to_host_async(self):
            pass

        def __array__(self, dtype=None, copy=None):
            return (self._arr if dtype is None
                    else self._arr.astype(dtype, copy=False))

    real = m._walk_primary

    def gated(probes, ct, *, donate):
        res, kernel = real(probes, ct, donate=donate)
        return RouteIntervals(*(Leaf(getattr(res, f)) for f in (
            "start", "count", "n_routes", "overflow"))), kernel
    m._walk_primary = gated


@pytest.mark.parametrize("match_cache", [False, True],
                         ids=["cache_off", "cache_on"])
async def test_churn_between_dispatches_equals_the_reference(match_cache):
    """Two batches in flight on each matcher with a subscription landing
    between their dispatches: identical rows in order, batch N as of its
    dispatch, batch N+1 with the new route; the port's second flush
    wrote new tables."""
    ref, port = _pair(match_cache)
    rng = random.Random(9)
    ref_gate, port_gate = _Gate(), _Gate()
    _gate_reference(ref, ref_gate)
    _gate_matcher(port, port_gate)
    for step in range(2):
        q1, q2 = _queries(rng), _queries(rng)
        ref_gate.open = port_gate.open = False
        tasks = [asyncio.ensure_future(m.match_batch_async(q1, batch=16))
                 for m in (ref, port)]
        await _spin()
        tf, rid = f"a/+/{step}", f"new{step}"
        ref.add_route("T1", JRoute(JMatcher.from_topic_filter(tf), 0, rid,
                                   "d0", 100 + step))
        port.add_route("T1", mk_route(tf, rid, 100 + step))
        tasks += [asyncio.ensure_future(m.match_batch_async(q2, batch=16))
                  for m in (ref, port)]
        await _spin()
        assert ref._ring.in_flight == port._ring.in_flight == 2
        ref_gate.open = port_gate.open = True
        want1, got1, want2, got2 = await asyncio.gather(*tasks)
        assert [_norm(x) for x in got1] == [_norm(x) for x in want1]
        assert [_norm(x) for x in got2] == [_norm(x) for x in want2]
    assert port.patch_flushes_undonated == 2
