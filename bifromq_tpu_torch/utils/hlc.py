"""Hybrid logical clock (copy of ``bifromq_tpu/utils/hlc.py``; ≈ reference
base-hlc).

48-bit physical milliseconds in the high bits, 16-bit causal counter in the
low bits, monotone under both local reads and remote updates. Reference:
base-hlc/src/main/java/org/apache/bifromq/basehlc/HLC.java:30
(get():79, update():112, getPhysical():141).

The reference uses a lock-free CAS loop on a volatile long; here a
threading.Lock guards the single 64-bit state (Python ints are arbitrary
precision, so masks keep the layout exact).
"""

from __future__ import annotations

import threading
import time

_CAUSAL_BITS = 16
_CAUSAL_MASK = (1 << _CAUSAL_BITS) - 1


class HLC:
    """Singleton hybrid logical clock; use ``HLC.INST``."""

    INST: "HLC"

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._state = 0

    def _physical_now(self) -> int:
        return int(time.time() * 1000) & ((1 << 48) - 1)

    def get(self) -> int:
        """Return the next monotone HLC stamp (HLC.java:79)."""
        with self._lock:
            wall = self._physical_now() << _CAUSAL_BITS
            if wall > self._state:
                self._state = wall
            else:
                self._state += 1
            return self._state

    def update(self, other: int) -> int:
        """Merge a remote stamp and return a stamp greater than both (HLC.java:112)."""
        with self._lock:
            wall = self._physical_now() << _CAUSAL_BITS
            new = max(wall, self._state + 1, other + 1)
            self._state = new
            return new

    @staticmethod
    def physical(stamp: int) -> int:
        """Extract the physical millisecond component (HLC.java:141)."""
        return stamp >> _CAUSAL_BITS


HLC.INST = HLC()
