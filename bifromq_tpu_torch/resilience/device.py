"""Device-fault resilience plane (copy of ``bifromq_tpu/resilience/
device.py``: the watchdog deadline, the buffer quarantine, the device
breaker board, the bounded-slot admission and the drain timeout).

One failure taxonomy threads through the dispatch ring and the matcher:

- **timeout** — ``DispatchRing.wait_ready`` polls a result's readiness
  under a watchdog deadline (``BIFROMQ_DEVICE_DEADLINE_S``, default
  derived from the live dispatch-stage p99 in ``utils.metrics.STAGES``)
  and raises :class:`DeviceTimeoutError` past it; the timed-out slot is
  reclaimed and its result — device tensors, pinned host buffers and the
  CUDA event after them — is parked in a :class:`BufferQuarantine` until
  the event completes, while the batch re-routes to the host oracle.
- **breaker** — every ``TorchMatcher`` carries a device circuit breaker
  fed by device timeouts and errors. Open ⇒ matches skip dispatch and
  serve the exact host oracle; half-open ⇒ one canary batch probes the
  card and re-closes only on row parity with the oracle. The
  :class:`DeviceBreakerBoard` joins the breakers to ``FABRIC``.
- **drain** — shutdown and compaction wait bounded for in-flight ring
  slots (``BIFROMQ_DRAIN_TIMEOUT_S``).

The per-shard deadline of the mesh's split dispatch is ROADMAP A.11;
load shedding and the QoS>0 ingest gate come with the broker's session
ingest (A.5). This module must not import ``utils.metrics`` at module
level: every hub access is lazy, as in ``breaker._meter``.
"""

from __future__ import annotations

import asyncio
import threading
import time
import weakref
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from ..utils.env import env_bool, env_float as _env_float, env_opt_str
from .breaker import CircuitBreaker

#: severity order shared with utils.metrics.FabricMetrics
_SEVERITY = {"closed": 0, "half_open": 1, "open": 2}


class DeviceTimeoutError(Exception):
    """A device dispatch failed to become ready within the watchdog
    deadline: the card is hung or saturated past its budget. Carries the
    deadline so degraded-path telemetry can say how long we waited."""

    def __init__(self, deadline_s: float, detail: str = "") -> None:
        super().__init__(
            f"device not ready within {deadline_s:.3f}s{detail}")
        self.deadline_s = deadline_s


# watchdog bounds: the derived deadline never drops below the floor (a
# cold STAGES histogram or a sub-ms CPU walk must not turn scheduler
# jitter into timeouts) and never exceeds the ceiling (a pathological
# p99 sample must not disarm the watchdog)
DEADLINE_FLOOR_S = 0.25
DEADLINE_CEIL_S = 30.0
DEADLINE_COLD_S = 5.0
#: headroom multiplier over the observed dispatch-stage p99
DEADLINE_P99_FACTOR = 32.0


def _pinned_deadline(env: str) -> Optional[float]:
    """Resolve an explicit deadline pin from ``env``.

    Returns ``(found, value)`` folded into one optional: ``None`` when
    the knob is unset or malformed (callers fall through to their
    derived default), the float otherwise — ``0``/negative disarm
    (``-0.0``... any non-positive), positive pins CLAMP into
    [``DEADLINE_FLOOR_S``, ``DEADLINE_CEIL_S``], so ``=0.001`` cannot
    turn scheduler jitter into timeouts and ``=9999`` cannot silently
    disarm the watchdog: a nonsensical knob degrades to the nearest sane
    bound.
    """
    raw = env_opt_str(env)
    if raw is None:
        return None
    try:
        v = float(raw)
    except ValueError:
        return None    # malformed pin ("2s") ⇒ the adaptive derivation,
    if v <= 0:         # same unset-garbage fallback as utils.env helpers
        return float("-inf")   # sentinel: explicit disarm
    return min(DEADLINE_CEIL_S, max(DEADLINE_FLOOR_S, v))


def device_deadline_s() -> Optional[float]:
    """The watchdog deadline for one device batch.

    ``BIFROMQ_DEVICE_DEADLINE_S`` pins it explicitly (``0`` or negative
    disarms the watchdog entirely; positive values clamp to
    [``DEADLINE_FLOOR_S``, ``DEADLINE_CEIL_S``]). Unset, it derives
    from the live dispatch-stage p99 in ``STAGES`` (``device.dispatch``
    + ``device.ready``) with generous headroom, clamped the same way;
    before any sample exists the cold-start default applies. The
    derivation is two ≤64 bucket walks — cheap enough per batch, and it
    tracks the deployment (a sub-millisecond walk on the card gets the
    floor, a slow host or a loaded card gets more).
    """
    pinned = _pinned_deadline("BIFROMQ_DEVICE_DEADLINE_S")
    if pinned is not None:
        return None if pinned == float("-inf") else pinned
    from ..utils.metrics import STAGES
    p99_ms = 0.0
    n = 0
    for stage in ("device.dispatch", "device.ready"):
        h = STAGES.hist(stage)
        if h.count:
            n += h.count
            p99_ms += h.percentile_ms(99)
    if n == 0:
        return DEADLINE_COLD_S
    derived = (p99_ms / 1000.0) * DEADLINE_P99_FACTOR
    return min(DEADLINE_CEIL_S, max(DEADLINE_FLOOR_S, derived))


# ---------------------------------------------------------------------------
# quarantine: orphaned in-flight buffers parked until actually ready
# ---------------------------------------------------------------------------

class BufferQuarantine:
    """Holds the results of timed-out (or cancelled) dispatches alive
    until the device reports them ready.

    A timed-out slot's result still has copies in flight: device→host
    copies into its pinned host buffers, behind kernels that write its
    device tensors. Dropping the last reference mid-flight would hand
    those pages back to the allocators while the card still writes them.
    Parking the whole result object here keeps them alive; ``sweep()``
    (called on ring release — O(1) when empty) frees entries whose
    leaves all report ready (on the card: the CUDA event recorded after
    the copies has completed). A hard age cap bounds the worst case of a
    permanently wedged card: after ``max_age_s`` the entry is dropped
    anyway and ``expired_total`` records the leak-or-free gamble.
    """

    def __init__(self, max_age_s: float = 300.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.max_age_s = max_age_s
        self._clock = clock
        self._entries: List[tuple] = []    # (res, quarantined_at)
        self._lock = threading.Lock()
        self.quarantined_total = 0
        self.released_total = 0
        self.expired_total = 0

    def __len__(self) -> int:
        return len(self._entries)

    def add(self, res) -> None:
        with self._lock:
            self._entries.append((res, self._clock()))
            self.quarantined_total += 1

    @staticmethod
    def _ready(res) -> bool:
        try:
            ready = getattr(res, "ready_leaves", None)
            leaves = ready() if ready is not None \
                else (res.start, res.count, res.overflow)
            for leaf in leaves:
                is_ready = getattr(leaf, "is_ready", None)
                if is_ready is not None and not is_ready():
                    return False
        except Exception:  # noqa: BLE001 — a deleted/poisoned buffer is
            return True    # no longer in flight; safe to let go
        return True

    def sweep(self) -> int:
        """Drop every entry whose buffers are ready (or too old to keep
        gambling on). Returns how many were released."""
        if not self._entries:
            return 0
        now = self._clock()
        kept: List[tuple] = []
        freed = 0
        with self._lock:
            for res, at in self._entries:
                if self._ready(res):
                    freed += 1
                    self.released_total += 1
                elif now - at >= self.max_age_s:
                    freed += 1
                    self.expired_total += 1
                else:
                    kept.append((res, at))
            self._entries = kept
        return freed

    def snapshot(self) -> dict:
        return {"held": len(self._entries),
                "quarantined_total": self.quarantined_total,
                "released_total": self.released_total,
                "expired_total": self.expired_total}


# ---------------------------------------------------------------------------
# device circuit breakers (per matcher), joined to FABRIC
# ---------------------------------------------------------------------------

def device_breaker_enabled() -> bool:
    return env_bool("BIFROMQ_DEVICE_BREAKER", True)


class DeviceBreakerBoard:
    """Process-global registry of per-matcher device breakers.

    Shaped like a breaker registry so ``FabricMetrics.breaker_snapshot``
    can merge it. Breakers are weakly held (a test-scoped matcher must
    not be pinned by telemetry); labels are stable per matcher
    lifetime."""

    def __init__(self) -> None:
        self._breakers: "weakref.WeakValueDictionary[str, CircuitBreaker]" \
            = weakref.WeakValueDictionary()
        self._seq = 0
        self._registered = False

    def create(self, *, failure_threshold: Optional[int] = None,
               recovery_time: Optional[float] = None,
               clock: Callable[[], float] = time.monotonic
               ) -> CircuitBreaker:
        if failure_threshold is None:
            failure_threshold = int(
                _env_float("BIFROMQ_DEVICE_BREAKER_THRESHOLD", 3))
        if recovery_time is None:
            recovery_time = _env_float(
                "BIFROMQ_DEVICE_BREAKER_RECOVERY_S", 5.0)
        br = CircuitBreaker(failure_threshold=max(1, failure_threshold),
                            recovery_time=recovery_time, clock=clock)
        self._seq += 1
        self._breakers[f"device:{self._seq}"] = br
        if not self._registered:
            # lazy, like every hub access of this module
            from ..utils.metrics import FABRIC
            FABRIC.register_breakers(self)
            self._registered = True
        return br

    def snapshot(self) -> Dict[str, dict]:
        """Non-closed device breakers only: closed is the default, and
        the happy-path snapshot must not grow a row per matcher ever
        constructed."""
        return {label: b.snapshot()
                for label, b in list(self._breakers.items())
                if b.state != "closed"}

    def states(self, include_closed: bool = False) -> Dict[str, str]:
        return {label: b.state
                for label, b in list(self._breakers.items())
                if include_closed or b.state != "closed"}

    def worst_state(self) -> str:
        worst = "closed"
        for b in list(self._breakers.values()):
            s = b.state
            if _SEVERITY.get(s, 0) > _SEVERITY.get(worst, 0):
                worst = s
        return worst


# the process-global board every TorchMatcher's breaker registers into
DEVICE_BREAKERS = DeviceBreakerBoard()


# ---------------------------------------------------------------------------
# bounded-slot admission: the primitive under the dispatch ring
# ---------------------------------------------------------------------------

class BoundedSlots:
    """Loop-agnostic bounded in-flight admission.

    No asyncio primitive is bound at construction: waiters are plain
    futures created on whichever loop runs the caller, so one instance
    can serve sessions and matchers across loops (and tests can drive it
    with hand-built loops). Cancellation hygiene: a parked waiter
    withdraws itself (a cancelled future is ``done()``, so it must be
    REMOVED — a stale entry would overcount ``waiting``); a waiter that
    was already granted a wake but dies before using it passes the wake
    on so the slot isn't lost. ``DispatchRing`` (models/pipeline.py)
    rides this for its slots and its prep tickets."""

    def __init__(self, capacity: int) -> None:
        self.capacity = max(1, capacity)
        self._inflight = 0
        self._waiters: Deque[asyncio.Future] = deque()
        self.peak_inflight = 0
        self.waited_total = 0

    @property
    def in_flight(self) -> int:
        return self._inflight

    @property
    def waiting(self) -> int:
        return len(self._waiters)

    async def acquire(self) -> None:
        while self._inflight >= self.capacity:
            fut = asyncio.get_running_loop().create_future()
            self._waiters.append(fut)
            self.waited_total += 1
            try:
                await fut
            except BaseException:
                if fut in self._waiters:
                    self._waiters.remove(fut)
                elif fut.done() and not fut.cancelled():
                    self._wake_one()
                raise
        self._inflight += 1
        self.peak_inflight = max(self.peak_inflight, self._inflight)

    def _wake_one(self) -> None:
        while self._waiters:
            fut = self._waiters.popleft()
            if not fut.done():
                fut.set_result(None)
                break

    def release(self) -> None:
        self._inflight = max(0, self._inflight - 1)
        self._wake_one()


def drain_timeout_s() -> float:
    """Bounded wait for in-flight device slots on shutdown/compaction."""
    return _env_float("BIFROMQ_DRAIN_TIMEOUT_S", 2.0)
