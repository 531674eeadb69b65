"""Process-global counters of the match-result cache plane (copy of
``MatchCacheMetrics`` and ``MATCH_CACHE`` from
``bifromq_tpu/utils/metrics.py``; the rest of that module — per-tenant
meters, latency histograms, the fabric and replication sections — is not
ported).
"""

from __future__ import annotations

import threading
from typing import Dict


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
