"""Per-key load recording + load-hinted splits (copy of
``bifromq_tpu/kv/load.py``).

≈ base-kv-store-server's KVLoadRecorder (KVLoadRecorder.java:28, attached
to readers/writers via LoadRecordableKVReader) feeding split hinters
(KVLoadBasedSplitHinter, and bifromq-dist's FanoutSplitHinter.java:49
which weighs a query by its fan-out). Re-expressed host-side: coprocs
record (key, cost) samples into their range's recorder; the balancer
reads windowed totals and splits hot ranges at the load-weighted median
key instead of the key-count median.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple


class KVLoadRecorder:
    """Windowed (key → accumulated cost) samples for one range."""

    def __init__(self, *, clock=time.monotonic,
                 max_tracked_keys: int = 4096) -> None:
        self.clock = clock
        self.max_tracked_keys = max_tracked_keys
        self._samples: Dict[bytes, int] = {}
        self.window_start = clock()
        self.total = 0
        self.dropped = 0

    def record(self, key: bytes, cost: int = 1) -> None:
        self.total += cost
        cur = self._samples.get(key)
        if cur is None and len(self._samples) >= self.max_tracked_keys:
            self.dropped += cost    # bounded memory; totals stay honest
            return
        self._samples[key] = (cur or 0) + cost

    def window(self) -> Tuple[float, int]:
        """(window age seconds, total cost recorded in it)."""
        return self.clock() - self.window_start, self.total

    def load_per_second(self) -> float:
        age, total = self.window()
        return total / age if age > 0 else 0.0

    def hot_split_key(self) -> Optional[bytes]:
        """The load-weighted median key: splitting there puts ~half the
        observed load on each side (≈ KVLoadBasedSplitHinter picking the
        tracked key nearest half the total load)."""
        if not self._samples:
            return None
        items: List[Tuple[bytes, int]] = sorted(self._samples.items())
        half = sum(c for _, c in items) / 2
        acc = 0
        for key, cost in items:
            acc += cost
            if acc >= half:
                return key
        return items[-1][0]

    def reset_window(self) -> None:
        self._samples.clear()
        self.total = 0
        self.dropped = 0
        self.window_start = self.clock()


class LoadSplitBalancer:
    """Split any local leader range whose windowed load rate exceeds
    ``max_load_per_second``, at the recorder's load-median key — the
    fan-out-aware half of elasticity (key-count splits stay in
    RangeSplitBalancer). Coprocs may expose ``align_split_key`` to snap
    the hint onto a record-group boundary (e.g. an inbox prefix)."""

    MIN_WINDOW_SECONDS = 1.0

    def __init__(self, max_load_per_second: float = 10_000.0) -> None:
        self.max_load_per_second = max_load_per_second

    def balance(self, store) -> List:
        from .balance import SplitCommand

        out: List = []
        for rid, r in store.ranges.items():
            if not r.is_leader:
                continue
            coproc = store.coprocs.get(rid)
            rec: Optional[KVLoadRecorder] = getattr(coproc,
                                                    "load_recorder", None)
            if rec is None:
                continue
            age, _total = rec.window()
            if age < self.MIN_WINDOW_SECONDS:
                continue
            rate = rec.load_per_second()
            if rate <= self.max_load_per_second:
                rec.reset_window()
                continue
            key = rec.hot_split_key()
            rec.reset_window()
            if key is None:
                continue
            align = getattr(coproc, "align_split_key", None)
            if align is not None:
                key = align(key)
            start, end = store.boundaries[rid]
            if key is None or not (key > start
                                   and (end is None or key < end)):
                continue    # whole load on one record group: unsplittable
            out.append(SplitCommand(rid, key))
        return out
