"""Process-global metrics of the serving plane (copy of
``LatencyHistogram``, ``StageLatencies``/``STAGES``, ``FabricMetric``,
``FabricMetrics``/``FABRIC`` and ``MatchCacheMetrics``/``MATCH_CACHE``
from ``bifromq_tpu/utils/metrics.py``; the per-tenant meters and
``MetricsRegistry`` wait for the broker assembly, ROADMAP A.5 and A.10).
"""

from __future__ import annotations

import enum
import threading
import weakref
from collections import defaultdict
from typing import Dict, List

from ..obs import window as _window


class LatencyHistogram:
    """Fixed log2-bucketed latency histogram: bucket *i* counts samples
    whose microsecond value has bit_length ``i``, topping out around 2
    minutes. Recording is one list-index increment — GIL-atomic, no lock
    on the hot path; percentile extraction returns the bucket's upper
    edge (conservative)."""

    N_BUCKETS = _window.N_BUCKETS

    def __init__(self) -> None:
        self._buckets: List[int] = [0] * self.N_BUCKETS

    def record(self, seconds: float) -> None:
        self._buckets[_window.bucket_index(seconds)] += 1

    @property
    def count(self) -> int:
        return sum(self._buckets)

    def percentile_ms(self, p: float) -> float:
        """Upper edge (ms) of the bucket containing the p-th percentile."""
        return _window.percentile_ms_from(self._buckets, p)

    def snapshot(self) -> Dict[str, float]:
        return {"count": self.count,
                "p50_ms": self.percentile_ms(50),
                "p99_ms": self.percentile_ms(99)}

    def reset(self) -> None:
        self._buckets = [0] * self.N_BUCKETS


class StageLatencies:
    """Named per-stage histograms of the serving path (``tokenize``,
    ``device.dispatch``, ``device.expand``, ``device.ready``,
    ``device.fetch``). Always on; the device watchdog derives its default
    deadline from the dispatch and ready percentiles."""

    def __init__(self) -> None:
        self._hists: Dict[str, LatencyHistogram] = {}

    def hist(self, stage: str) -> LatencyHistogram:
        h = self._hists.get(stage)
        if h is None:
            h = self._hists.setdefault(stage, LatencyHistogram())
        return h

    def record(self, stage: str, seconds: float) -> None:
        self.hist(stage).record(seconds)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {name: h.snapshot() for name, h in self._hists.items()
                if h.count}

    def reset(self) -> None:
        for h in self._hists.values():
            h.reset()


# the process-global stage-latency registry the serving path reports into
STAGES = StageLatencies()


class FabricMetric(enum.Enum):
    """Process-wide resilience counters: the members the breakers, the
    fault injector and the device leg increment."""

    BREAKER_OPENED = "breaker_open_total"
    BREAKER_HALF_OPEN = "breaker_half_open_total"
    BREAKER_CLOSED = "breaker_closed_total"
    FAULTS_INJECTED = "faults_injected_total"
    MATCH_DEGRADED = "match_degraded_total"
    DEVICE_TIMEOUT = "device_timeout_total"


class FabricMetrics:
    """Global counter registry for fabric-level metrics, plus the live
    breaker registries whose state ``breaker_snapshot`` merges.
    Thread-safe: compaction threads may report while the loop serves."""

    def __init__(self) -> None:
        self._counters: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        # live breaker registries, weakly held: a test-scoped registry must
        # not be pinned by telemetry
        self._breaker_sets: "weakref.WeakSet" = weakref.WeakSet()

    def register_breakers(self, breaker_registry) -> None:
        """Expose a breaker registry's live per-endpoint state through
        ``breaker_snapshot``."""
        self._breaker_sets.add(breaker_registry)

    # WeakSet iteration order is arbitrary: when two registries track the
    # SAME endpoint, keep the operator-conservative (worst) state
    _BREAKER_SEVERITY = {"closed": 0, "half_open": 1, "open": 2}

    def breaker_snapshot(self) -> Dict[str, dict]:
        merged: Dict[str, dict] = {}
        for reg in list(self._breaker_sets):
            try:
                snap = reg.snapshot()
            except Exception:  # noqa: BLE001 — telemetry must not raise
                continue
            for ep, state in snap.items():
                prev = merged.get(ep)
                if prev is None or (
                        self._BREAKER_SEVERITY.get(state.get("state"), 0)
                        > self._BREAKER_SEVERITY.get(prev.get("state"), 0)):
                    merged[ep] = state
        return merged

    def inc(self, metric: FabricMetric, n: int = 1) -> None:
        with self._lock:
            self._counters[metric.value] += n

    def get(self, metric: FabricMetric) -> int:
        return self._counters.get(metric.value, 0)


# the process-global instance the resilience plane reports into
FABRIC = FabricMetrics()


class MatchCacheMetrics:
    """Process-global counters for the match-result cache plane:
    hits/misses/evictions/epoch-bumps per scope (``"matcher"`` = the
    matchers' caches) plus the in-batch dedup tally. Thread-safe."""

    _FIELDS = ("hits", "misses", "evictions", "epoch_bumps")

    def __init__(self) -> None:
        self._scopes: Dict[str, Dict[str, int]] = {}
        self._lock = threading.Lock()
        self.dedup_walked = 0      # unique rows actually dispatched
        self.dedup_saved = 0       # duplicate rows served by fan-out

    def inc(self, scope: str, field: str, n: int = 1) -> None:
        with self._lock:
            s = self._scopes.setdefault(scope, dict.fromkeys(self._FIELDS, 0))
            s[field] += n

    def record_dedup(self, walked: int, saved: int) -> None:
        with self._lock:
            self.dedup_walked += walked
            self.dedup_saved += saved

    def snapshot(self) -> dict:
        with self._lock:
            out = {}
            for scope, s in self._scopes.items():
                lookups = s["hits"] + s["misses"]
                out[scope] = dict(s)
                out[scope]["hit_rate"] = (round(s["hits"] / lookups, 4)
                                          if lookups else 0.0)
            rows = self.dedup_walked + self.dedup_saved
            out["dedup"] = {
                "walked": self.dedup_walked,
                "saved": self.dedup_saved,
                "ratio": round(self.dedup_saved / rows, 4) if rows else 0.0,
            }
        return out

    def reset(self) -> None:
        with self._lock:
            self._scopes.clear()
            self.dedup_walked = 0
            self.dedup_saved = 0


# the process-global instance every TenantMatchCache reports into
MATCH_CACHE = MatchCacheMetrics()
