"""Balance controller + balancers (copy of ``bifromq_tpu/kv/balance.py``;
≈ base-kv-store-balance-controller).

``KVStoreBalanceController`` periodically evaluates pluggable balancers
against its own store and executes the commands they emit — the
decentralized placement loop of KVStoreBalanceController.java:85
(balance():303). First balancer: ``RangeSplitBalancer``
(≈ balance/impl/RangeSplitBalancer.java fed by split hinters): splits any
leader range whose keyspace outgrew ``max_keys`` at its median key, which
keeps the per-range compiled automatons bounded — the device analog of
keeping per-range scan cost flat (FanoutSplitHinter's goal).
"""

from __future__ import annotations

import asyncio
import logging
from typing import List, Optional

from .store import KVRangeStore

log = logging.getLogger(__name__)


class SplitCommand:
    def __init__(self, range_id: str, split_key: bytes) -> None:
        self.range_id = range_id
        self.split_key = split_key

    def __repr__(self) -> str:
        return f"Split({self.range_id} @ {self.split_key!r})"


class RangeSplitBalancer:
    """Emit a split for any local leader range with more than ``max_keys``
    keys, at the median key (a size hinter; fan-out hinters can feed the
    same command stream)."""

    def __init__(self, max_keys: int = 100_000) -> None:
        self.max_keys = max_keys

    def balance(self, store: KVRangeStore) -> List[SplitCommand]:
        out: List[SplitCommand] = []
        for rid, r in store.ranges.items():
            if not r.is_leader:
                continue
            n = len(r.space)
            if n <= self.max_keys:
                continue
            start, end = store.boundaries[rid]
            mid = self._median_key(r.space, start, end, n)
            # coprocs with multi-key record groups (e.g. one inbox's
            # meta + queues) snap the split onto a group boundary
            align = getattr(store.coprocs.get(rid), "align_split_key", None)
            if mid is not None and align is not None:
                mid = align(mid)
            if mid is not None and mid > start \
                    and (end is None or mid < end):
                out.append(SplitCommand(rid, mid))
        return out

    @staticmethod
    def _median_key(space, start: bytes, end, n: int) -> Optional[bytes]:
        target = n // 2
        for i, (k, _v) in enumerate(space.iterate(start, end)):
            if i >= target:
                return k
        return None


class MergeCommand:
    def __init__(self, left_id: str, right_id: str) -> None:
        self.left_id = left_id
        self.right_id = right_id

    def __repr__(self) -> str:
        return f"Merge({self.left_id} <- {self.right_id})"


class RangeMergeBalancer:
    """Merge adjacent under-filled leader ranges (the shrink half of
    elasticity): when two neighbors together hold fewer than ``min_keys``
    keys, fold the right one into the left (≈ the reference's merge
    balancing driven from range load facts)."""

    def __init__(self, min_keys: int = 1000) -> None:
        self.min_keys = min_keys

    def balance(self, store: KVRangeStore) -> List["MergeCommand"]:
        ordered = store.router.ranges()  # boundary-sorted
        for ((_s1, e1), left), ((s2, _e2), right) in zip(ordered,
                                                         ordered[1:]):
            if e1 != s2:
                continue
            lr, rr = store.ranges[left], store.ranges[right]
            if not (lr.is_leader and rr.is_leader):
                continue
            if len(lr.space) + len(rr.space) < self.min_keys:
                return [MergeCommand(left, right)]  # one merge per round
        return []


class KVStoreBalanceController:
    """Runs the balancer set on an interval against one store."""

    def __init__(self, store: KVRangeStore, balancers=None, *,
                 interval: float = 1.0) -> None:
        self.store = store
        self.balancers = balancers or [RangeSplitBalancer()]
        self.interval = interval
        self._task = None
        # admin toggle + last-commands ring (≈ the reference apiserver's
        # balancer enable/disable/state endpoints over
        # KVStoreBalanceController)
        self.enabled = True
        self.history: list = []

    def state(self) -> dict:
        return {
            "enabled": self.enabled,
            "interval_s": self.interval,
            "balancers": [type(b).__name__ for b in self.balancers],
            "recent_commands": list(self.history[-20:]),
        }

    async def run_once(self) -> int:
        if not self.enabled:
            return 0
        executed = 0
        for b in self.balancers:
            for cmd in b.balance(self.store):
                try:
                    if isinstance(cmd, SplitCommand):
                        sib = await self.store.split(cmd.range_id,
                                                     cmd.split_key)
                        log.info("split %s -> %s", cmd.range_id, sib)
                        self.history.append(
                            {"cmd": "split", "range": cmd.range_id})
                        executed += 1
                    elif isinstance(cmd, MergeCommand):
                        await self.store.merge(cmd.left_id, cmd.right_id)
                        log.info("merged %s <- %s", cmd.left_id,
                                 cmd.right_id)
                        self.history.append(
                            {"cmd": "merge", "left": cmd.left_id,
                             "right": cmd.right_id})
                        executed += 1
                except Exception:  # noqa: BLE001 — keep balancing others
                    log.exception("balance command failed: %r", cmd)
        del self.history[:-100]
        return executed

    async def start(self) -> None:
        async def loop():
            while True:
                await asyncio.sleep(self.interval)
                await self.run_once()
        self._task = asyncio.create_task(loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except BaseException:  # noqa: BLE001
                pass
            self._task = None
