"""Retained wildcard scans on SUBSCRIBE, served through the resilience
machinery of the forward matcher (port of
``bifromq_tpu/retained_plane/scan.py``).

``RetainedScanPlane`` wraps one replica's :class:`RetainedIndex`:

- the extras-aware walk dispatches through a bounded
  :class:`~bifromq_tpu_torch.models.pipeline.DispatchRing` (scan N+1
  prepares while scan N walks),
- readiness is awaited under the watchdog: a hung card RECLAIMS the slot
  (the orphaned result quarantined until its CUDA event completes) and
  degrades THIS scan to the exact host oracle (``match_filter_host``),
- a per-plane device circuit breaker (on the shared ``DEVICE_BREAKERS``
  board) opens on repeated timeouts and injected faults: open means
  scans skip dispatch entirely; half-open admits ONE canary scan that
  re-closes only on oracle parity,
- results memoize in a filter-keyed :class:`RetainedScanCache` whose
  evictions are EXACT, fed per mutation by the retained delta hooks,
- every batch lands a ``retain.scan`` stage sample.

Unlike the reference, a fault of the program is never served around: a
kernel that refused to launch, a native walker that failed to build and a
wrapper's argument check (``models/matcher._PROGRAM_FAULTS``) propagate
to the caller, as they do out of ``TorchMatcher``. Only a watchdog
timeout, an injected fault, an open breaker and a canary parity miss
serve the oracle. A plane always has a cache and serves through the
ring: the reference's blocking leg (``scan_batch_sync``), which only its
environment switch selected, is not carried over.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..models.matcher import _PROGRAM_FAULTS
from ..utils.metrics import STAGES
from .cache import RetainedScanCache

log = logging.getLogger(__name__)


class RetainedScanPlane:
    """One replica's retained-scan serving plane.

    ``index_fn`` indirects to the live :class:`RetainedIndex`: the
    hosting coproc REPLACES its index on reset-from-KV, and a plane
    pinning the old object would serve a dead world.
    """

    def __init__(self, index_fn: Callable, *,
                 cache: Optional[RetainedScanCache] = None) -> None:
        self._index_fn = index_fn
        self._ring = None
        from ..resilience.device import (DEVICE_BREAKERS,
                                         device_breaker_enabled)
        self.device_breaker = (DEVICE_BREAKERS.create()
                               if device_breaker_enabled() else None)
        self.cache = cache if cache is not None else RetainedScanCache()
        self.scans_total = 0
        self.degraded_total: Dict[str, int] = {}
        # OBS.register_retained_plane and the snapshot it reads (the
        # /metrics "retained" section): ROADMAP A.10

    @property
    def index(self):
        return self._index_fn()

    def _pipeline_ring(self):
        if self._ring is None:
            from ..models.pipeline import DispatchRing
            self._ring = DispatchRing()
            # OBS.device.register_ring: ROADMAP A.10
        return self._ring

    # ---------------- serving entry points ----------------------------------

    async def scan_batch(self, queries: Sequence[Tuple[str, Sequence[str]]],
                         limit: Optional[int] = None) -> List[List[str]]:
        """Pipelined serving path: the device walk dispatches through the
        bounded ring and is awaited on READINESS under the watchdog;
        breaker-open, timeout and injected faults serve the exact
        oracle."""
        if not queries:
            return []
        miss_queries, fill = self._serve(queries, limit)
        if not miss_queries:
            return fill([], None)
        rows, reason = await self._device_serve_async(miss_queries, limit)
        return fill(rows, reason)

    def _serve(self, queries, limit):
        """Front end: cache probe and the stage sample. Returns the
        cache misses and a ``fill(rows, reason)`` continuation that
        stores the device leg's rows and completes the serve."""
        t0 = time.perf_counter()
        self.scans_total += len(queries)
        cache = self.cache
        out: List[Optional[List[str]]] = [None] * len(queries)
        miss_rows: List[int] = []
        tokens: Dict[str, object] = {}
        for qi, (tenant, levels) in enumerate(queries):
            hit = cache.get(tenant, tuple(levels), limit)
            if hit is not None:
                out[qi] = list(hit)
            else:
                miss_rows.append(qi)
                if tenant not in tokens:
                    tokens[tenant] = cache.token(tenant)

        def fill(rows, reason):
            for qi, row in zip(miss_rows, rows):
                out[qi] = row
                if reason is None:
                    tenant, levels = queries[qi]
                    cache.put(tenant, tuple(levels), limit, row,
                              tokens[tenant])
            STAGES.record("retain.scan", time.perf_counter() - t0)
            if reason is not None:
                self.degraded_total[reason] = \
                    self.degraded_total.get(reason, 0) + 1
            # the "retain.scan" span and the per-tenant latency / fan-out
            # feeds (OBS.record_latency, OBS.record_fanout): ROADMAP A.10
            return [row if row is not None else [] for row in out]

        return [queries[qi] for qi in miss_rows], fill

    # ---------------- device legs -------------------------------------------

    def _oracle_rows(self, queries, limit) -> List[List[str]]:
        idx = self.index
        out = []
        for tenant, levels in queries:
            trie = idx.tries.get(tenant)
            out.append(match_filter_host_safe(trie, levels, limit))
        return out

    def _canary_parity(self, queries, rows, limit) -> Tuple[bool, list]:
        """Half-open success bar: the canary scan's device rows must be
        an exact (limit-aware) subset of the unbounded host oracle: a
        card returning plausible-but-wrong topics after a fault must NOT
        re-close the breaker."""
        full = self._oracle_rows(queries, None)
        ok = True
        for row, want in zip(rows, full):
            wset = set(want)
            bound = len(want) if limit is None else min(limit, len(want))
            if len(row) != bound or not set(row) <= wset:
                ok = False
                break
        if limit is None:
            return ok, full
        return ok, [w[:limit] for w in full]

    def _admit(self) -> str:
        br = self.device_breaker
        return br.admit() if br is not None else "ok"

    async def _device_serve_async(self, queries, limit):
        import asyncio

        from ..resilience.device import DeviceTimeoutError
        from ..resilience.faults import InjectedFault, get_injector
        verdict = self._admit()
        if verdict == "rejected":
            return self._degrade(queries, limit, "breaker")
        br = self.device_breaker
        ring = self._pipeline_ring()
        settled = False
        try:
            idx = self.index
            idx.serving_ring = ring     # ring-less flushers must see us
            prep = idx.prepare_scan(queries)
            await ring.acquire()
            try:
                # error rules raise here; hang / slow / flaky_ready ride
                # into the readiness wait
                fault = get_injector().device_rule("dispatch")
                prep, res = idx.dispatch_scan(prep, ring=ring, own_slots=1)
                ring.start_fetch(res)
                try:
                    await ring.wait_ready(res, fault=fault)
                except DeviceTimeoutError:
                    ring.reclaim(res)
                    raise
                except BaseException:
                    # cancelled mid-wait: the buffers may still be in
                    # flight; park them as a timeout does
                    ring.quarantine.add(res)
                    raise
            finally:
                ring.release()
            out = self._settle(queries, limit, idx, prep, res,
                               verdict=verdict)
            settled = True
            return out
        except DeviceTimeoutError as e:
            from ..utils.metrics import FABRIC, FabricMetric
            FABRIC.inc(FabricMetric.DEVICE_TIMEOUT)
            settled = self._record_failure(e)
            return self._degrade(queries, limit, "timeout")
        except InjectedFault as e:
            settled = self._record_failure(e)
            return self._degrade(queries, limit, "device_error", e)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            settled = self._record_failure(e)
            raise
        finally:
            if br is not None and verdict == "canary" and not settled:
                # cancelled or a program fault mid-probe with no verdict:
                # the half-open budget must not leak or the breaker
                # wedges refusing
                br.release_probe()

    def _record_failure(self, e: Exception) -> bool:
        """Feed the breaker a failure of the card; a fault of the program
        is not one. Returns whether the breaker took a verdict."""
        br = self.device_breaker
        if br is None or isinstance(e, _PROGRAM_FAULTS):
            return False
        br.record_failure(repr(e))
        return True

    def _settle(self, queries, limit, idx, prep, res, *, verdict):
        """Fetch and expand, then the breaker bookkeeping (canary scans
        re-close only on oracle parity)."""
        from ..resilience.faults import get_injector
        get_injector().check_raise("device", "tpu-device", "fetch")
        rows = idx.expand_scan(prep, idx.fetch_scan(res), limit=limit)
        br = self.device_breaker
        if br is not None:
            if verdict == "canary":
                ok, oracle_rows = self._canary_parity(queries, rows, limit)
                if not ok:
                    br.record_failure("canary row parity")
                    return self._degrade(queries, limit, "canary_parity",
                                         rows_override=oracle_rows)
                br.record_success()
            elif br.state == "closed":
                # pre-trip straggler guard (as the forward matcher's)
                br.record_success()
        return rows, None

    def _degrade(self, queries, limit, reason, exc=None,
                 rows_override=None):
        if exc is not None:
            log.warning("retained scan failed; serving host oracle: %r",
                        exc)
        from ..utils.metrics import FABRIC, FabricMetric
        FABRIC.inc(FabricMetric.MATCH_DEGRADED, len(queries))
        rows = (rows_override if rows_override is not None
                else self._oracle_rows(queries, limit))
        return rows, reason


def match_filter_host_safe(trie, levels, limit) -> List[str]:
    from ..models.retained import match_filter_host
    if trie is None:
        return []
    return match_filter_host(trie, list(levels), limit=limit)
