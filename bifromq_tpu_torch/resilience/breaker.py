"""Circuit breaker (closed → open → half-open): copy of ``CircuitBreaker``
from ``bifromq_tpu/resilience/breaker.py``. Transitions are metered
through ``utils.metrics.FABRIC``; ``BreakerRegistry`` comes with the
broker assembly (ROADMAP A.5).

State machine (classic Nygard breaker):

- CLOSED: all traffic flows; ``failure_threshold`` CONSECUTIVE failures
  trip it open.
- OPEN: calls are refused for ``recovery_time`` seconds.
- HALF_OPEN: after recovery_time, a bounded number of probe calls pass;
  one success closes the circuit, one failure re-opens it (with the full
  recovery window again).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


def _meter(metric_name: str) -> None:
    from ..utils.metrics import FABRIC, FabricMetric
    FABRIC.inc(FabricMetric(metric_name))


class CircuitBreaker:
    def __init__(self, *, failure_threshold: int = 5,
                 recovery_time: float = 1.0,
                 half_open_max_probes: int = 1,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.failure_threshold = failure_threshold
        self.recovery_time = recovery_time
        self.half_open_max_probes = half_open_max_probes
        self._clock = clock
        self._state = CLOSED
        self._failures = 0          # consecutive failure streak
        self._opened_at = 0.0
        self._probes_inflight = 0
        # observability
        self.open_count = 0
        self.last_error: Optional[str] = None

    # ---------------- state ------------------------------------------------

    @property
    def state(self) -> str:
        """Current state; lazily advances OPEN → HALF_OPEN by the clock."""
        if (self._state == OPEN
                and self._clock() - self._opened_at >= self.recovery_time):
            self._state = HALF_OPEN
            self._probes_inflight = 0
            _meter("breaker_half_open_total")
        return self._state

    def admit(self) -> str:
        """Admission at call time, and WHICH admission: ``"ok"`` (closed —
        normal traffic), ``"canary"`` (half-open — this call is the probe,
        charged to the probe budget; the device breaker holds it to a
        stricter success bar: oracle row parity), or ``"rejected"``
        (open, or the half-open probe budget is spent)."""
        s = self.state
        if s == CLOSED:
            return "ok"
        if s == OPEN:
            return "rejected"
        if self._probes_inflight >= self.half_open_max_probes:
            return "rejected"
        self._probes_inflight += 1
        return "canary"

    # ---------------- outcome feed -----------------------------------------

    def release_probe(self) -> None:
        """Return an admission charged by ``admit()`` WITHOUT a verdict
        (cancelled call, caller-budget timeout): the probe budget must
        not leak, or a HALF_OPEN breaker wedges refusing forever."""
        if self._probes_inflight > 0:
            self._probes_inflight -= 1

    def record_success(self) -> None:
        s = self._state
        if s == OPEN:
            # a STALE success: the call was admitted before the trip and
            # only now completed. Re-closing here would bypass the
            # recovery window and the half-open probe (for the device
            # breaker, the canary row-parity bar) — the streak that
            # tripped the breaker is better evidence than one straggler.
            return
        if s == HALF_OPEN:
            if self._probes_inflight == 0:
                return   # not the probe's verdict — same straggler case
            _meter("breaker_closed_total")
        self._state = CLOSED
        self._failures = 0
        self._probes_inflight = 0

    def record_failure(self, error: Optional[str] = None) -> None:
        self.last_error = error
        if self._state == HALF_OPEN:
            self._trip()
            return
        self._failures += 1
        if self._state == CLOSED and self._failures >= self.failure_threshold:
            self._trip()

    def _trip(self) -> None:
        self._state = OPEN
        self._opened_at = self._clock()
        self._failures = 0
        self._probes_inflight = 0
        self.open_count += 1
        _meter("breaker_open_total")

    def force_open(self) -> None:
        """Operator/test hook: trip immediately."""
        self._trip()

    def force_close(self) -> None:
        """Operator/test hook: reset to CLOSED immediately, bypassing
        the recovery window (symmetric with ``force_open``; a stray
        ``record_success`` can no longer do this — stale in-flight
        successes are ignored while OPEN)."""
        self._state = CLOSED
        self._failures = 0
        self._probes_inflight = 0

    def snapshot(self) -> dict:
        return {"state": self.state, "failures": self._failures,
                "open_count": self.open_count,
                "last_error": self.last_error}
