"""The retained plane (port of ``bifromq_tpu/retained_plane/``).

- :mod:`patched`: :class:`RetainedPatchableTrie`, RETAIN set / clear /
  expire as in-place arena patches (child-list runs, the extras plane).
- :mod:`scan`: :class:`RetainedScanPlane`, retained wildcard scans on
  SUBSCRIBE served through the dispatch ring, the device breaker and the
  watchdog, with the host oracle on timeout, injected fault, open breaker
  or canary parity miss, and a filter-keyed result cache.
- :mod:`cache`: :class:`RetainedScanCache`, that cache, evicted EXACTLY
  by retained deltas, and :class:`RetainedDeltaLog`, the seq'd per-range
  retained delta stream.

The drain governor (``DrainGovernor``) comes with its caller, the inbox
service (ROADMAP A.5b).
"""

from __future__ import annotations

from .cache import RetainedDeltaLog, RetainedScanCache
from .patched import RetainedPatchableTrie
from .scan import RetainedScanPlane

__all__ = [
    "RetainedPatchableTrie", "RetainedScanPlane", "RetainedScanCache",
    "RetainedDeltaLog",
]
