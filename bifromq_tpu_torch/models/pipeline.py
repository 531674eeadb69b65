"""Async device-dispatch ring (copy of ``bifromq_tpu/models/pipeline.py``).

The sync serving leg pays prepare → dispatch → blocking fetch with
nothing overlapped. This module is the overlap plane:

- a **dispatch ring** bounds the number of in-flight device batches
  (``BIFROMQ_PIPELINE_DEPTH``, default 2 = double-buffered; 3 = triple):
  batch N+1 prepares and enqueues on the card while batch N is still
  walking, because the await happens on *readiness*, not inside dispatch;
- results come back via **fetch-on-ready**: right after the dispatch,
  ``start_fetch`` enqueues the result's device→host copies into pinned
  buffers and records a CUDA event behind them (``ExpandedRoutes.
  ready_leaves`` in ``ops/match.py``); the serving coroutine polls the
  event (yielding the event loop between polls — other batches dispatch
  in those gaps) and then reads the host copies, with no synchronize;
- the ring's occupancy is the **queue-depth signal** for adaptive batch
  shaping: an idle ring means a shallow dispatch queue, so the pow2 pad
  floor drops to ``BIFROMQ_PIPELINE_MIN_BATCH`` (default 8) to cut
  time-to-first-result; a busy ring keeps the throughput floor (16).

The ring deliberately has NO asyncio primitives bound at construction
(no Semaphore/Event): matchers outlive event loops in tests and
multi-loop processes, so waiters are plain per-call futures created on
whatever loop is running the dispatch.
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional

from ..resilience.device import (BoundedSlots, BufferQuarantine,
                                 DeviceTimeoutError, device_deadline_s)
from ..utils.env import env_bool, env_int


def pipeline_enabled() -> bool:
    """Kill-switch for the async dispatch path (``BIFROMQ_PIPELINE=0``
    degrades ``match_batch_async`` to the sync serving path)."""
    return env_bool("BIFROMQ_PIPELINE", True)


def pipeline_depth() -> int:
    """In-flight device batches (2 = double-buffered, 3 = triple)."""
    return max(1, min(env_int("BIFROMQ_PIPELINE_DEPTH", 2), 8))


def pipeline_min_floor() -> int:
    """Shallow-queue pow2 pad floor (the latency floor; 16 stays the
    throughput floor)."""
    return max(1, min(env_int("BIFROMQ_PIPELINE_MIN_BATCH", 8), 16))


def _leaves(res):
    ready = getattr(res, "ready_leaves", None)
    return list(ready()) if ready is not None \
        else [res.start, res.count, res.overflow]


def _is_ready(res) -> bool:
    """Every leaf of ``res`` ready; a leaf without ``is_ready`` counts as
    ready (the caller's fetch blocks on it)."""
    return all(getattr(leaf, "is_ready", lambda: True)()
               for leaf in _leaves(res))


def ready_polls(res, *, poll_s: float = 0.0005, spin_polls: int = 50,
                deadline_s: Optional[float] = None, fault=None):
    """The readiness poll both serving legs share: yields the pause
    before the next check until every leaf of ``res`` is ready, and
    raises :class:`DeviceTimeoutError` past ``deadline_s`` (default
    :func:`device_deadline_s`). The caller sleeps each pause — the
    async leg yielding the event loop, the sync leg on its thread.

    Two-phase: the first ``spin_polls`` misses pause 0 (a bare yield
    costing microseconds, which sub-millisecond walks on the card finish
    within; a timed sleep would quantize to the loop's ~1ms timer and tax
    every fast batch), then ``poll_s`` for genuinely long completions,
    where spinning would burn a core for nothing. The deadline check is
    one monotonic read per poll. Leaves without ``is_ready`` (a plain
    tensor) end the poll: the caller's fetch blocks on them — still
    correct, just unoverlapped. ``fault`` is a fired device FaultRule
    (models/matcher threads it from the dispatch hook): ``hang``
    withholds readiness while the rule stays installed, ``slow`` for the
    rule's delay, ``flaky_ready`` makes each poll lie with the rule's
    probability."""
    if deadline_s is None:
        deadline_s = device_deadline_s()
    t0 = time.monotonic()
    leaves = _leaves(res)
    polls = 0
    injector = None
    if fault is not None:
        from ..resilience.faults import get_injector
        injector = get_injector()
    while True:
        faulted = False
        if fault is not None:
            if fault.action == "hang":
                faulted = injector.rule_active(fault)
            elif fault.action == "slow":
                faulted = time.monotonic() - t0 < fault.delay
            elif fault.action == "flaky_ready":
                # the documented contract is delayed-never-denied: clamp
                # the per-poll lie below 1.0 so a rule with the default
                # probability (1.0) stays a flake, not a hang (hang is its
                # own action)
                faulted = (injector.rule_active(fault)
                           and injector.rng.random()
                           < min(fault.probability, 0.95))
        if not faulted:
            try:
                if all(leaf.is_ready() for leaf in leaves):
                    return
            except AttributeError:
                return
        if deadline_s is not None and time.monotonic() - t0 >= deadline_s:
            raise DeviceTimeoutError(deadline_s)
        yield 0.0 if polls < spin_polls else poll_s
        polls += 1


class DispatchRing(BoundedSlots):
    """Bounded in-flight dispatch slots + the queue-depth signal.

    One per TorchMatcher (created lazily on the first async match).
    ``effective_floor`` feeds the adaptive pow2 pad. Slot admission
    (bound, parked-waiter futures, cancellation hygiene) is
    :class:`~bifromq_tpu_torch.resilience.device.BoundedSlots`.
    """

    def __init__(self, depth: Optional[int] = None,
                 min_floor: Optional[int] = None,
                 base_floor: int = 16) -> None:
        super().__init__(depth if depth is not None else pipeline_depth())
        self.min_floor = (min_floor if min_floor is not None
                          else pipeline_min_floor())
        self.base_floor = base_floor
        # observability (tests assert overlap through these)
        self.dispatched_total = 0
        self.overlapped_total = 0
        # fetched results not yet seen ready (start_fetch's overlap count)
        self._pending: list = []
        # timed-out slots park their orphaned results here until the
        # device actually finishes with them — a reclaimed slot must never
        # let buffers the card still writes be reused mid-flight
        self.quarantine = BufferQuarantine()
        self.timeouts_total = 0
        # stage-1 prep (hash + probe upload) runs BEFORE ring admission
        # for overlap, so prep tickets — not ring slots — bound the probe
        # batches resident on device. A ticket is held for the whole
        # prep + slot tenure (released WITH the slot), so prepped +
        # in-flight batches together never exceed depth + 1: with the
        # ring full, exactly ONE caller can hold an uploaded-but-
        # undispatched probe set. Without the gate, K parked callers
        # would each hold an upload.
        self._prep = BoundedSlots(self.capacity + 1)

    # ---------------- slot management --------------------------------------

    @property
    def depth(self) -> int:
        return self.capacity

    @depth.setter
    def depth(self, v: int) -> None:
        self.capacity = v
        self._prep.capacity = max(1, v + 1)

    async def acquire_prep(self) -> None:
        """Admit one stage-1 prep (see ``_prep``): held across tokenize
        + probe upload + ring admission + the walk's slot tenure,
        released together with the slot (or when the leg dies)."""
        await self._prep.acquire()

    def release_prep(self) -> None:
        self._prep.release()

    @property
    def prepping(self) -> int:
        return self._prep.in_flight

    async def acquire(self) -> None:
        await super().acquire()
        self.dispatched_total += 1

    def release(self) -> None:
        super().release()
        # opportunistic quarantine sweep: O(1) when nothing is parked
        if len(self.quarantine):
            self.quarantine.sweep()

    def reclaim(self, res) -> None:
        """A slot timed out: park its result (device tensors, pinned host
        buffers, CUDA event) in quarantine until the device reports it
        ready. The caller releases the slot itself — the ring stays
        bounded AND live, instead of one stuck dispatch wedging a slot
        forever."""
        self.timeouts_total += 1
        self.quarantine.add(res)

    async def wait_idle(self, timeout_s: float = 2.0,
                        poll_s: float = 0.002) -> bool:
        """Graceful drain: wait bounded for every in-flight
        slot to retire. Returns False on timeout — the caller proceeds
        with shutdown/compaction anyway (in-flight coroutines release
        their slots when cancelled)."""
        deadline = time.monotonic() + timeout_s
        while self._inflight > 0:
            if time.monotonic() >= deadline:
                return False
            await asyncio.sleep(poll_s)
        return True

    # ---------------- adaptive pad floor ------------------------------------

    def effective_floor(self, *, pre_acquire: bool = False) -> int:
        """Shallow queue (nothing else in flight, nobody parked) ⇒ the
        small latency floor; any concurrency ⇒ the throughput floor.

        ONE definition for both call shapes: post-acquire (the default;
        ``in_flight`` counts this dispatch too, so <=1 is the
        idle-broker single-publish shape) and ``pre_acquire`` (stage-1
        prep chooses the pad floor BEFORE a slot is held, where the same
        idle state reads ==0).
        """
        own = 0 if pre_acquire else 1
        if self._inflight <= own and not self._waiters:
            return self.min_floor
        return self.base_floor

    def planned_floor(self) -> int:
        """The pre-admission floor the async prep leg uses."""
        return self.effective_floor(pre_acquire=True)

    # ---------------- fetch-on-ready ----------------------------------------

    def start_fetch(self, res) -> None:
        """Kick the device→host copy without blocking (fetch-on-ready
        half 1). A result names its own fetch set (``ready_leaves``: on
        the card, the pinned copies of the pair buffers and interval
        grids the fetch reads and the event after them).
        A result without one offers its grid leaves, and a leaf without
        ``copy_to_host_async`` is fetched by the caller's readback.

        Counts ``overlapped_total``: dispatches made while an earlier
        batch's result was still not ready, i.e. device work of two
        batches actually pending together."""
        self._pending = [r for r in self._pending if not _is_ready(r)]
        self.overlapped_total += bool(self._pending)
        self._pending.append(res)
        for leaf in _leaves(res):
            copy_async = getattr(leaf, "copy_to_host_async", None)
            if copy_async is not None:
                copy_async()

    @staticmethod
    async def wait_ready(res, poll_s: float = 0.0005,
                         spin_polls: int = 50,
                         deadline_s: Optional[float] = None,
                         fault=None) -> None:
        """Yield the event loop until every result leaf is ready (half 2):
        :func:`ready_polls`, each pause an ``asyncio.sleep``.

        ``is_ready`` is a CUDA event query, not a sync: other coroutines
        (the NEXT batch's prepare + dispatch) run between polls. The
        first check comes before any yield, as in the reference: a batch
        the card has already finished returns at once, and the ring only
        holds two batches together when one of them is still on the card.

        Watchdog: past ``deadline_s`` (default derived from the
        dispatch-stage p99, env ``BIFROMQ_DEVICE_DEADLINE_S``) a
        :class:`DeviceTimeoutError` fires so one hung dispatch cannot
        wedge a ring slot forever.
        """
        for pause in ready_polls(res, poll_s=poll_s, spin_polls=spin_polls,
                                 deadline_s=deadline_s, fault=fault):
            await asyncio.sleep(pause)
