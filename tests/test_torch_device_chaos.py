"""Port parity: the device-fault resilience plane on
``TorchMatcher(device="cpu")``.

Mirrors ``tests/test_device_chaos.py``: watchdog deadlines with slot
reclaim and result quarantine, the device circuit breaker (open serves
the host oracle with zero dispatches, the half-open canary re-closes only
on oracle row parity), the device-side fault-injector taxonomy (hang /
error / slow / flaky_ready), and graceful drain. Load shedding and the
QoS>0 ingest gate come with the broker's session ingest; the per-shard
deadline with the mesh's split dispatch.

Everything is deterministic: readiness is driven by gated results (the
``test_torch_pipeline`` pattern), clocks are injectable, and the only
waits are the watchdog's, at its 0.25 s floor.
"""

import asyncio
import gc
import time

import numpy as np
import pytest

from bifromq_tpu_torch.models.matcher import TorchMatcher
from bifromq_tpu_torch.models.oracle import MatchedRoutes, Route
from bifromq_tpu_torch.models.pipeline import DispatchRing
from bifromq_tpu_torch.resilience.breaker import CircuitBreaker
from bifromq_tpu_torch.resilience.device import (DEADLINE_CEIL_S,
                                                 DEADLINE_FLOOR_S,
                                                 DEVICE_BREAKERS,
                                                 BufferQuarantine,
                                                 device_deadline_s)
from bifromq_tpu_torch.resilience.faults import InjectedFault, get_injector
from bifromq_tpu_torch.types import RouteMatcher
from bifromq_tpu_torch.utils.device import KernelLaunchError
from bifromq_tpu_torch.utils.metrics import FABRIC, FabricMetric

pytestmark = [pytest.mark.asyncio, pytest.mark.chaos]


def mk_route(topic_filter: str, receiver: str, incarnation: int = 0):
    return Route(matcher=RouteMatcher.from_topic_filter(topic_filter),
                 broker_id=0, receiver_id=receiver, deliverer_key="d0",
                 incarnation=incarnation)


def mk_matcher(match_cache=False):
    m = TorchMatcher(device="cpu", max_levels=8, k_states=8,
                     auto_compact=False, match_cache=match_cache)
    m.add_route("T", mk_route("a/b", "r1"))
    m.add_route("T", mk_route("a/+", "r2"))
    m.refresh()
    return m


def _ids(res):
    return sorted(r.receiver_id for r in res.normal)


class _Gate:
    def __init__(self) -> None:
        self.open = False


class _GatedLeaf:
    def __init__(self, gate: _Gate) -> None:
        self._gate = gate

    def is_ready(self) -> bool:
        return self._gate.open

    def copy_to_host_async(self) -> None:
        pass


class _GatedResult:
    """A dispatched result whose readiness the test controls (the card is
    'still walking' until the gate opens); any read before then fails —
    a host read of buffers the card may still write."""

    def __init__(self, res, gate: _Gate) -> None:
        self.__dict__.update(_res=res, _gate=gate, reads=0)

    def ready_leaves(self):
        return (_GatedLeaf(self._gate),)

    def __getattr__(self, name):
        self.__dict__["reads"] += 1
        assert self._gate.open, "result read before it was ready"
        return getattr(self._res, name)


def _gate_matcher(m: TorchMatcher, gate: _Gate):
    real = m._dispatch_prepared

    def gated(prep, **kw):
        fl = real(prep, **kw)
        fl.res = _GatedResult(fl.res, gate)
        return fl

    m._dispatch_prepared = gated


@pytest.fixture(autouse=True)
def _clean_injector():
    get_injector().reset()
    yield
    get_injector().reset()


# ---------------- watchdog: deadline, reclaim, quarantine -------------------


class TestWatchdog:
    async def test_timeout_reclaims_slot_and_serves_oracle(self, monkeypatch):
        monkeypatch.setenv("BIFROMQ_DEVICE_DEADLINE_S", "0.05")
        m = mk_matcher()
        gate = _Gate()
        _gate_matcher(m, gate)
        t0 = FABRIC.get(FabricMetric.DEVICE_TIMEOUT)
        stats = {}
        res = await m.match_batch_async([("T", ["a", "b"])], batch=16,
                                        stats=stats)
        # served — exactly, from the host oracle — despite the hung card
        assert _ids(res[0]) == ["r1", "r2"]
        assert stats["degraded"] == "timeout"
        ring = m._ring
        assert ring.timeouts_total == 1
        assert FABRIC.get(FabricMetric.DEVICE_TIMEOUT) == t0 + 1
        assert ring.in_flight == 0, "timed-out slot must be reclaimed"
        # the orphaned result is quarantined, NOT dropped: the card may
        # still be writing its buffers
        assert len(ring.quarantine) == 1
        assert m.device_breaker.snapshot()["failures"] == 1

    async def test_quarantined_buffers_released_only_when_ready(
            self, monkeypatch):
        monkeypatch.setenv("BIFROMQ_DEVICE_DEADLINE_S", "0.05")
        m = mk_matcher()
        gate = _Gate()
        _gate_matcher(m, gate)
        await m.match_batch_async([("T", ["a", "b"])], batch=16)
        q = m._ring.quarantine
        assert len(q) == 1
        # still in flight: a sweep must NOT free it
        q.sweep()
        assert len(q) == 1 and q.released_total == 0
        # ...and no host read ever touched the result
        (res_obj, _at) = q._entries[0]
        assert res_obj.reads == 0
        # the card finally finishes: the next sweep lets go
        gate.open = True
        q.sweep()
        assert len(q) == 0 and q.released_total == 1

    async def test_ring_stays_live_after_timeout(self, monkeypatch):
        """A wedged dispatch must not pin a bounded ring slot — later
        batches still serve (on the device once the fault clears)."""
        monkeypatch.setenv("BIFROMQ_DEVICE_DEADLINE_S", "0.05")
        m = mk_matcher()
        gate = _Gate()
        _gate_matcher(m, gate)
        m._pipeline_ring().depth = 1        # one slot: wedging it = deadlock
        await m.match_batch_async([("T", ["a", "b"])], batch=16)
        assert m._ring.timeouts_total == 1
        gate.open = True                    # the card recovers
        stats = {}
        res = await m.match_batch_async([("T", ["a", "c"])], batch=16,
                                        stats=stats)
        assert _ids(res[0]) == ["r2"] and "degraded" not in stats
        assert m._ring.in_flight == 0

    def test_deadline_env_pin_and_disarm(self, monkeypatch):
        monkeypatch.setenv("BIFROMQ_DEVICE_DEADLINE_S", "1.25")
        assert device_deadline_s() == 1.25
        monkeypatch.setenv("BIFROMQ_DEVICE_DEADLINE_S", "0")
        assert device_deadline_s() is None      # watchdog disarmed
        monkeypatch.setenv("BIFROMQ_DEVICE_DEADLINE_S", "-3")
        assert device_deadline_s() is None

    def test_deadline_env_clamps_nonsense(self, monkeypatch):
        """A nonsensical pin degrades to the nearest sane bound instead
        of weaponizing scheduler jitter (=0.001) or silently disarming the
        watchdog (=9999); malformed values fall through to the adaptive
        derivation."""
        monkeypatch.setenv("BIFROMQ_DEVICE_DEADLINE_S", "0.001")
        assert device_deadline_s() == DEADLINE_FLOOR_S
        monkeypatch.setenv("BIFROMQ_DEVICE_DEADLINE_S", "9999")
        assert device_deadline_s() == DEADLINE_CEIL_S
        monkeypatch.setenv("BIFROMQ_DEVICE_DEADLINE_S", "2s")
        derived = device_deadline_s()       # malformed ⇒ derived, clamped
        assert derived is not None
        assert DEADLINE_FLOOR_S <= derived <= DEADLINE_CEIL_S

    async def test_wait_ready_no_deadline_never_raises(self):
        gate = _Gate()
        leaf = _GatedLeaf(gate)

        class R:
            start = count = overflow = leaf
        task = asyncio.ensure_future(
            DispatchRing.wait_ready(R(), poll_s=0.001, deadline_s=None))
        for _ in range(30):
            await asyncio.sleep(0)
        assert not task.done()
        gate.open = True
        await asyncio.wait_for(task, 2)

    def test_sync_leg_timeout_serves_oracle(self, monkeypatch):
        """The sync leg short-polls the same readiness surface: a hung
        card degrades the sync caller to the oracle, breaker fed."""
        monkeypatch.setenv("BIFROMQ_DEVICE_DEADLINE_S", "0.05")
        m = mk_matcher()
        _gate_matcher(m, _Gate())
        stats = {}
        res = m.match_batch([("T", "a/b")], stats=stats)
        assert _ids(res[0]) == ["r1", "r2"]
        assert stats["degraded"] == "timeout"
        assert m.device_breaker.snapshot()["failures"] == 1


class TestQuarantine:
    def test_expiry_bounds_a_permanently_wedged_device(self):
        t = [0.0]
        q = BufferQuarantine(max_age_s=10.0, clock=lambda: t[0])
        gate = _Gate()
        leaf = _GatedLeaf(gate)

        class R:
            start = count = overflow = leaf
        q.add(R())
        t[0] = 5.0
        q.sweep()
        assert len(q) == 1
        t[0] = 11.0
        q.sweep()
        assert len(q) == 0 and q.expired_total == 1

    def test_cpu_result_is_always_ready(self):
        """A CPU result's readiness leaf is always ready, and its fetch
        is a plain copy."""
        m = mk_matcher()
        fl = m._dispatch_prepared(m._prepare_probes([("T", "a/b")], 16))
        (leaf,) = fl.res.ready_leaves()
        assert leaf.is_ready()
        q = BufferQuarantine()
        q.add(fl.res)
        assert q.sweep() == 1 and q.released_total == 1
        host = leaf.arrays()
        assert isinstance(host["slots"], np.ndarray)
        assert host["slots"].tolist() == fl.res.slots.tolist()

    async def test_cancelled_wait_quarantines_inflight_buffers(
            self, monkeypatch):
        """A task cancelled while parked in ``wait_ready`` parks its
        in-flight result in quarantine exactly like a timeout does. No
        timeout is counted (the card did nothing wrong), and the buffers
        free once actually ready."""
        monkeypatch.setenv("BIFROMQ_DEVICE_DEADLINE_S", "30")
        m = mk_matcher()
        gate = _Gate()
        _gate_matcher(m, gate)
        task = asyncio.ensure_future(
            m.match_batch_async([("T", ["a", "b"])], batch=16))
        for _ in range(60):                 # into the readiness wait
            await asyncio.sleep(0)
        assert m._ring.in_flight == 1
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        assert m._ring.in_flight == 0       # slot released...
        assert len(m._ring.quarantine) == 1  # ...buffers parked, not lost
        assert m._ring.timeouts_total == 0
        gate.open = True                    # the card finishes with them
        m._ring.quarantine.sweep()
        assert len(m._ring.quarantine) == 0


# ---------------- device circuit breaker ------------------------------------


class TestDeviceBreaker:
    async def test_consecutive_timeouts_open_breaker_then_skip_dispatch(
            self, monkeypatch):
        monkeypatch.setenv("BIFROMQ_DEVICE_DEADLINE_S", "0.05")
        m = mk_matcher()
        gate = _Gate()
        _gate_matcher(m, gate)
        thr = m.device_breaker.failure_threshold
        for _ in range(thr):
            res = await m.match_batch_async([("T", ["a", "b"])], batch=16)
            assert _ids(res[0]) == ["r1", "r2"]     # every serve exact
        assert m.device_breaker.state == "open"
        d0 = m._ring.dispatched_total
        deg0 = FABRIC.get(FabricMetric.MATCH_DEGRADED)
        stats = {}
        res = await m.match_batch_async([("T", ["a", "b"])], batch=16,
                                        stats=stats)
        assert _ids(res[0]) == ["r1", "r2"]
        assert stats["degraded"] == "breaker"
        assert FABRIC.get(FabricMetric.MATCH_DEGRADED) == deg0 + 1
        assert m._ring.dispatched_total == d0, \
            "open breaker must skip the device entirely"

    async def test_half_open_canary_recloses_on_row_parity(self):
        t = [0.0]
        m = mk_matcher()
        m.device_breaker = CircuitBreaker(failure_threshold=1,
                                          recovery_time=5.0,
                                          clock=lambda: t[0])
        m.device_breaker.force_open()
        d0 = m._pipeline_ring().dispatched_total
        res = await m.match_batch_async([("T", ["a", "b"])], batch=16)
        assert _ids(res[0]) == ["r1", "r2"]
        assert m._ring.dispatched_total == d0      # open: no dispatch
        t[0] = 6.0                                  # recovery window passed
        res = await m.match_batch_async([("T", ["a", "b"])], batch=16)
        assert _ids(res[0]) == ["r1", "r2"]
        assert m._ring.dispatched_total == d0 + 1   # the canary probe
        assert m.device_breaker.state == "closed"
        # device serving resumed for good
        res = await m.match_batch_async([("T", ["a", "x"])], batch=16)
        assert _ids(res[0]) == ["r2"]
        assert m._ring.dispatched_total == d0 + 2

    async def test_canary_parity_failure_reopens_and_serves_oracle(self):
        t = [0.0]
        m = mk_matcher()
        m.device_breaker = CircuitBreaker(failure_threshold=1,
                                          recovery_time=5.0,
                                          clock=lambda: t[0])
        m.device_breaker.force_open()
        t[0] = 6.0
        # the recovered 'card' returns plausible-but-WRONG rows
        real = m._expand_walk

        def corrupt(fl, overflow, pairs, mpf, mgf):
            rows = real(fl, overflow, pairs, mpf, mgf)
            return [MatchedRoutes() for _ in rows]      # drops every route
        m._expand_walk = corrupt
        stats = {}
        res = await m.match_batch_async([("T", ["a", "b"])], batch=16,
                                        stats=stats)
        # the caller still gets the EXACT rows (oracle), and the breaker
        # refuses to re-close on a card that lies
        assert _ids(res[0]) == ["r1", "r2"]
        assert stats["degraded"] == "canary_parity"
        assert m.device_breaker.state == "open"

    def test_sync_path_breaker_open_serves_oracle(self):
        m = mk_matcher()
        m.device_breaker.force_open()
        stats = {}
        res = m.match_batch([("T", ["a", "b"])], stats=stats)
        assert _ids(res[0]) == ["r1", "r2"]
        assert stats["degraded"] == "breaker"

    async def test_breaker_joins_fabric_metrics_and_board(self):
        gc.collect()    # flush earlier tests' gated matchers (ref cycles)
        m = mk_matcher()
        assert DEVICE_BREAKERS.worst_state() == "closed"
        m.device_breaker.force_open()
        assert DEVICE_BREAKERS.worst_state() == "open"
        snap = FABRIC.breaker_snapshot()
        assert any(k.startswith("device:") and v["state"] == "open"
                   for k, v in snap.items())
        # a STALE success (admitted before the trip, landing after it)
        # must NOT re-close an OPEN breaker
        m.device_breaker.record_success()
        assert DEVICE_BREAKERS.worst_state() == "open"
        # the legitimate path: recovery window elapses -> half-open
        # canary admission -> its success closes
        m.device_breaker._opened_at -= (
            m.device_breaker.recovery_time + 1.0)
        assert m.device_breaker.admit() == "canary"
        m.device_breaker.record_success()
        # closed breakers stay OUT of the snapshot (absent means healthy)
        assert not any(k.startswith("device:")
                       for k in DEVICE_BREAKERS.snapshot())


# ---------------- program faults: raised, never served around -------------


def _launching_walk(m: TorchMatcher, monkeypatch, rc: int) -> None:
    """Route the primary walk through the walk kernel's launch whose C
    entry returns ``rc`` (on the CPU the wrapper itself never launches)."""
    from bifromq_tpu_torch.models.kernels import FUSED_WALK
    monkeypatch.setattr(FUSED_WALK, "_fn", lambda *args: rc)
    real = m._walk_primary

    def walk(probes, ct):
        FUSED_WALK.launch(0)
        return real(probes, ct)
    m._walk_primary = walk


def _checked_walk(m: TorchMatcher) -> None:
    """Route the primary walk through a wrapper's argument check that
    refuses the (CPU) probe tensor."""
    import torch
    from bifromq_tpu_torch.utils.device import check_cuda
    real = m._walk_primary

    def walk(probes, ct):
        check_cuda("tok_h1", probes.tok_h1, torch.int32)
        return real(probes, ct)
    m._walk_primary = walk


async def _serve(m, leg, queries, stats=None):
    if leg == "async":
        return await m.match_batch_async(queries, stats=stats)
    return m.match_batch(queries, stats=stats)


class TestProgramFaults:
    """A kernel that refuses to launch, or a wrapper's argument check, is
    a fault of the program: both legs raise it to the caller, the breaker
    is not fed, and nothing is served from the host oracle. A launch that
    meets a fault of the CUDA context is a device fault and degrades."""

    @pytest.mark.parametrize("leg", ["async", "sync"])
    @pytest.mark.parametrize("fault", ["launch", "argument"])
    async def test_program_fault_raises_not_degrades(self, monkeypatch,
                                                     leg, fault):
        m = mk_matcher()
        if fault == "launch":
            _launching_walk(m, monkeypatch, 1)     # cudaErrorInvalidValue
            err = KernelLaunchError
        else:
            _checked_walk(m)
            err = ValueError
        deg0 = FABRIC.get(FabricMetric.MATCH_DEGRADED)
        with pytest.raises(err):
            await _serve(m, leg, [("T", ["a", "b"])])
        assert FABRIC.get(FabricMetric.MATCH_DEGRADED) == deg0
        assert m.device_breaker.snapshot()["failures"] == 0
        assert m.device_breaker.state == "closed"
        if leg == "async":
            assert m._ring.in_flight == 0 and m._ring.prepping == 0

    async def test_program_fault_in_canary_returns_the_probe(
            self, monkeypatch):
        t = [0.0]
        m = mk_matcher()
        m.device_breaker = CircuitBreaker(failure_threshold=1,
                                          recovery_time=5.0,
                                          clock=lambda: t[0])
        m.device_breaker.force_open()
        t[0] = 6.0
        real = m._walk_primary
        _launching_walk(m, monkeypatch, 1)
        with pytest.raises(KernelLaunchError):
            await m.match_batch_async([("T", ["a", "b"])])
        # no verdict: the half-open probe budget is returned, and the
        # next batch is the canary that closes the breaker
        assert m.device_breaker.state == "half_open"
        m._walk_primary = real
        stats = {}
        res = await m.match_batch_async([("T", ["a", "b"])], stats=stats)
        assert _ids(res[0]) == ["r1", "r2"] and "degraded" not in stats
        assert m.device_breaker.state == "closed"

    @pytest.mark.parametrize("leg", ["async", "sync"])
    async def test_device_fault_at_launch(self, monkeypatch, leg):
        m = mk_matcher()
        _launching_walk(m, monkeypatch, 700)       # cudaErrorIllegalAddress
        stats = {}
        if leg == "async":
            res = await m.match_batch_async([("T", ["a", "b"])],
                                            stats=stats)
            assert _ids(res[0]) == ["r1", "r2"]
            assert stats["degraded"] == "device_error"
        else:
            with pytest.raises(RuntimeError) as e:
                m.match_batch([("T", ["a", "b"])])
            assert not isinstance(e.value, KernelLaunchError)
        assert m.device_breaker.snapshot()["failures"] == 1


# ---------------- device-side fault injector ---------------------------------


class TestDeviceFaultInjector:
    async def test_error_rule_at_dispatch_degrades_async(self):
        m = mk_matcher()
        get_injector().add_rule(service="tpu-device", method="dispatch",
                                action="error", max_hits=1)
        stats = {}
        res = await m.match_batch_async([("T", ["a", "b"])], stats=stats)
        assert _ids(res[0]) == ["r1", "r2"]
        assert stats["degraded"] == "device_error"
        assert m.device_breaker.snapshot()["failures"] == 1
        # rule exhausted: the device serves again
        stats = {}
        res = await m.match_batch_async([("T", ["a", "x"])], stats=stats)
        assert _ids(res[0]) == ["r2"] and "degraded" not in stats

    def test_error_rule_at_dispatch_propagates_sync(self):
        m = mk_matcher()
        get_injector().add_rule(service="tpu-device", method="dispatch",
                                action="error", max_hits=1)
        with pytest.raises(InjectedFault):
            m.match_batch([("T", ["a", "b"])])
        # ...but the breaker saw it
        assert m.device_breaker.snapshot()["failures"] == 1

    async def test_error_rule_at_fetch_degrades_async(self):
        m = mk_matcher()
        get_injector().add_rule(service="tpu-device", method="fetch",
                                action="error", max_hits=1)
        stats = {}
        res = await m.match_batch_async([("T", ["a", "b"])], stats=stats)
        assert _ids(res[0]) == ["r1", "r2"]
        assert stats["degraded"] == "device_error"

    async def test_hang_rule_times_out_then_clearing_recovers(
            self, monkeypatch):
        monkeypatch.setenv("BIFROMQ_DEVICE_DEADLINE_S", "0.05")
        m = mk_matcher()
        inj = get_injector()
        inj.add_rule(service="tpu-device", method="dispatch", action="hang")
        stats = {}
        res = await m.match_batch_async([("T", ["a", "b"])], stats=stats)
        assert _ids(res[0]) == ["r1", "r2"]
        assert stats["degraded"] == "timeout"
        assert m._ring.timeouts_total == 1
        inj.reset()     # un-wedge the card
        m._ring.quarantine.sweep()      # the result was really ready
        assert len(m._ring.quarantine) == 0
        stats = {}
        res = await m.match_batch_async([("T", ["a", "x"])], stats=stats)
        assert _ids(res[0]) == ["r2"] and "degraded" not in stats

    async def test_slow_rule_delays_but_completes(self):
        m = mk_matcher()
        get_injector().add_rule(service="tpu-device", method="dispatch",
                                action="slow", delay=0.08, max_hits=1)
        t0 = time.monotonic()
        res = await m.match_batch_async([("T", ["a", "b"])], batch=16)
        assert _ids(res[0]) == ["r1", "r2"]
        assert time.monotonic() - t0 >= 0.08
        assert m._ring.timeouts_total == 0

    def test_sync_path_does_not_consume_readiness_rules(self):
        """The sync leg threads no readiness fault into its poll: a
        hang/slow/flaky_ready rule must stay ARMED (hit budget and
        injection counters untouched) for the watchdogged async path."""
        m = mk_matcher()
        inj = get_injector()
        inj.add_rule(service="tpu-device", method="dispatch",
                     action="hang", max_hits=1)
        rule = inj.rules[0]
        res = m.match_batch([("T", ["a", "b"])])
        assert _ids(res[0]) == ["r1", "r2"]      # sync serve unaffected
        assert rule.hits == 0                    # rule still armed
        assert inj.injected_total == 0

    async def test_flaky_ready_rule_completes(self):
        m = mk_matcher()
        get_injector().add_rule(service="tpu-device", method="dispatch",
                                action="flaky_ready", probability=1.0,
                                max_hits=1)
        rule = get_injector().rules[0]
        # probability=1 would lie forever: cap the lying by removing the
        # rule from a side task once the batch is in its readiness wait
        task = asyncio.ensure_future(
            m.match_batch_async([("T", ["a", "b"])], batch=16))
        for _ in range(20):
            await asyncio.sleep(0)
        get_injector().remove_rule(rule)
        res = await asyncio.wait_for(task, 5)
        assert _ids(res[0]) == ["r1", "r2"]


# ---------------- graceful drain ---------------------------------------------


class TestDrain:
    async def test_drain_waits_bounded_then_gives_up(self, monkeypatch):
        monkeypatch.setenv("BIFROMQ_DEVICE_DEADLINE_S", "30")
        m = mk_matcher()
        gate = _Gate()
        _gate_matcher(m, gate)
        task = asyncio.ensure_future(
            m.match_batch_async([("T", ["a", "b"])], batch=16))
        for _ in range(10):
            await asyncio.sleep(0)
        assert m._ring.in_flight == 1
        assert not await m.drain_device(timeout_s=0.05)     # bounded
        gate.open = True
        await asyncio.wait_for(task, 5)
        assert await m.drain_device(timeout_s=1.0)

    async def test_drain_noop_without_ring(self):
        m = mk_matcher()
        assert await m.drain_device(timeout_s=0.01)
