"""Raft transports (copy of ``bifromq_tpu/raft/transport.py``).

``InMemTransport`` is the test fabric (≈ the reference's in-process cluster
messenger used by KVRangeStoreTestCluster, SURVEY.md §4): queued delivery
with an explicit ``pump()``, plus partition/drop controls for fault tests.
Production transports (gRPC over the cluster fabric) plug in behind the same
``ITransport.send`` in a later round.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Deque, Dict, Optional, Set, Tuple

from .node import ITransport, RaftNode


class InMemTransport(ITransport):
    def __init__(self) -> None:
        self.nodes: Dict[str, RaftNode] = {}
        self.queue: Deque[Tuple[str, str, object]] = deque()
        self._blocked: Set[frozenset] = set()
        self._down: Set[str] = set()
        self.drop_fn: Optional[Callable[[str, str, object], bool]] = None
        # latency injection (the chaos surface): returns how many pump
        # rounds to defer a message (0 = deliver now). Lets tests slow the
        # append path without severing it — raft must still commit.
        self.delay_fn: Optional[Callable[[str, str, object], int]] = None
        self._delayed: Deque[Tuple[int, str, str, object]] = deque()
        self.delivered = 0
        self.deferred = 0

    def register(self, node: RaftNode) -> None:
        self.nodes[node.id] = node

    def send(self, to: str, sender: str, msg) -> None:
        self.queue.append((to, sender, msg))

    # ---------------- fault injection --------------------------------------

    def partition(self, *groups: Set[str]) -> None:
        """Block traffic between nodes in different groups."""
        self._blocked = set()
        gl = [set(g) for g in groups]
        all_nodes = set(self.nodes)
        for g in gl:
            for a in g:
                for b in all_nodes - g:
                    self._blocked.add(frozenset((a, b)))

    def heal(self) -> None:
        self._blocked = set()

    def kill(self, node_id: str) -> None:
        self._down.add(node_id)
        self.nodes[node_id].stop()

    def _deliverable(self, to: str, sender: str, msg) -> bool:
        if to in self._down or sender in self._down:
            return False
        if frozenset((to, sender)) in self._blocked:
            return False
        if self.drop_fn is not None and self.drop_fn(to, sender, msg):
            return False
        return True

    # ---------------- pumping ----------------------------------------------

    def pump(self, max_msgs: int = 10_000) -> int:
        """Deliver queued messages (and those they generate). Returns the
        number processed; while messages sit deferred the return stays
        nonzero, so drain-until-quiet drivers keep pumping them ripe."""
        n = 0
        # age the deferred set one round; ripe messages deliver DIRECTLY
        # (never re-consulting delay_fn — a deterministic delay_fn would
        # otherwise re-defer the same message forever)
        if self._delayed:
            for _ in range(len(self._delayed)):
                rounds, to, sender, msg = self._delayed.popleft()
                if rounds > 1:
                    self._delayed.append((rounds - 1, to, sender, msg))
                    continue
                n += 1
                if self._deliverable(to, sender, msg):
                    node = self.nodes.get(to)
                    if node is not None:
                        node.receive(sender, msg)
                        self.delivered += 1
        while self.queue and n < max_msgs:
            to, sender, msg = self.queue.popleft()
            n += 1
            if not self._deliverable(to, sender, msg):
                continue
            if self.delay_fn is not None:
                rounds = self.delay_fn(to, sender, msg)
                if rounds > 0:
                    self._delayed.append((rounds, to, sender, msg))
                    self.deferred += 1
                    continue
            node = self.nodes.get(to)
            if node is not None:
                node.receive(sender, msg)
                self.delivered += 1
        # still-deferred messages are pending work: report it so callers
        # looping `while pump():` don't stop with traffic in flight
        return n if not self._delayed else max(n, 1)
