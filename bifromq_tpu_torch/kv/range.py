"""Replicated KV range: raft-driven state machine over an IKVSpace (copy
of ``bifromq_tpu/kv/range.py``).

A deliberately lean re-expression of the reference's range replica
(base-kv-store-server .../store/range/KVRangeFSM.java:164 — raft WAL + data
space + apply loop + coproc). Split and the two-phase merge handshake live
in the hosting store (kv/store.py) behind the on_split/on_seal/on_merge
apply hooks:

- mutations serialize into raft entries; the apply loop executes them on the
  local space in commit order on every replica
- reads go through ``read_index`` for linearizability
  (≈ KVRangeQueryLinearizer.java:37)
- the coproc SPI mirrors IKVRangeCoProc: ``query(input, reader)`` /
  ``mutate(input, reader, writer)`` / ``reset(boundary)``
- raft snapshots serialize the whole space (RocksDB-checkpoint analog)
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

from ..raft.node import LogEntry, RaftNode
from .engine import IKVSpace, KVWriteBatch


class BoundaryBounce(Exception):
    """Raised by a coproc QUERY whose key fell outside this range's
    boundary (split/merge raced the caller's routing): the RPC facade
    maps it to the RETRY status so the client re-resolves — the read-side
    twin of the mutate path's ``b"retry"`` sentinel."""


class IKVRangeCoProc:
    """Domain-logic plug point (≈ base-kv-store-coproc-api IKVRangeCoProc)."""

    def query(self, input_data: bytes, reader: IKVSpace) -> bytes:
        raise NotImplementedError

    def mutate(self, input_data: bytes, reader: IKVSpace,
               writer: KVWriteBatch) -> bytes:
        """Stage writes into ``writer``; return the output payload.

        ``b"retry"`` is RESERVED: it signals a boundary/seal bounce and
        makes the caller re-resolve the range and re-propose — coprocs
        return it for keys outside their boundary, never as user data.
        """
        raise NotImplementedError

    def reset(self, reader: IKVSpace) -> None:
        """Rebuild derived state after a snapshot restore
        (≈ DistWorkerCoProc.reset:283 rebuilding Fact/caches)."""


async def propose_with_leader_wait(rng, fn, *, timeout: float = 5.0,
                                   tick_single_voter: bool = False):
    """Run a consensus proposal with a bounded wait for leadership.

    The ONE retry idiom for every proposal path (dist mutations, inbox,
    retain, split/merge): a NotLeaderError during the initial-election
    window waits and retries; a steady-state follower (a DIFFERENT known
    leader) re-raises so callers redirect. ``tick_single_voter`` drives a
    sole-voter group's election synchronously (standalone ranges used
    without a tick loop).
    """
    import asyncio
    import time as _time

    from ..raft.node import NotLeaderError, Role

    deadline = _time.monotonic() + timeout
    while True:
        try:
            return await fn()
        except NotLeaderError:
            raft = rng.raft
            if _time.monotonic() >= deadline or raft.stopped:
                raise
            if tick_single_voter and len(raft.voters) == 1:
                for _ in range(200):
                    if raft.role == Role.LEADER:
                        break
                    raft.tick()
                continue
            if raft.leader_id not in (None, raft.id):
                raise
            await asyncio.sleep(0.01)


# wire ops inside raft entries
_OP_PUT = 0
_OP_DEL = 1
_OP_DEL_RANGE = 2
_OP_COPROC = 3


def _enc_kv_ops(ops: List[Tuple[str, bytes, Optional[bytes]]]) -> bytes:
    out = bytearray([0])  # kind 0 = raw kv batch
    out += struct.pack(">I", len(ops))
    for op, a, b in ops:
        code = {"put": _OP_PUT, "del": _OP_DEL, "del_range": _OP_DEL_RANGE}[op]
        out.append(code)
        out += struct.pack(">I", len(a)) + a
        b = b or b""
        out += struct.pack(">I", len(b)) + b
    return bytes(out)


def _enc_coproc(payload: bytes) -> bytes:
    return bytes([1]) + payload


class ReplicatedKVRange:
    """One raft-replicated range bound to a local space + coproc.

    The replica is volatile: the reference's restart path (a durable
    IRaftStateStore plus an applied-index watermark in the data space)
    arrives with raft/store.py (ROADMAP A.5b).
    """

    def __init__(self, range_id: str, node_id: str, voters: List[str],
                 transport, space: IKVSpace,
                 coproc: Optional[IKVRangeCoProc] = None,
                 learners: Optional[List[str]] = None) -> None:
        self.range_id = range_id
        self.space = space
        self.coproc = coproc
        # results kept only for indices this node proposed (followers apply
        # the same entries but have no caller waiting — don't accumulate)
        self._mutation_results: dict = {}
        self._pending_results: set = set()
        self.raft = RaftNode(
            node_id, voters, transport,
            learners=learners,
            apply_cb=self._apply,
            snapshot_cb=self._snapshot,
            restore_cb=self._restore)

    # ---------------- raft callbacks ---------------------------------------

    # set by a hosting KVRangeStore: fn(split_key) runs the deterministic
    # split state transfer at this entry's apply position on every replica
    on_split = None
    # merge hooks (≈ KVRangeFSM's dual-range merge state machine):
    # on_seal(sealed: bool) toggles this range's write seal; on_merge(
    # payload) folds a sealed sibling into this range — both run at apply
    # position on every replica
    on_seal = None
    on_merge = None
    # derived deterministically from the log (seal/unseal apply positions);
    # blocks EVERY mutation kind, including raw kv batches
    sealed = False

    def _apply(self, entry: LogEntry) -> None:
        data = entry.data
        if not data:
            return
        kind = data[0]
        if kind == 0:
            if not self.sealed:  # sealed: content is frozen for the merge
                self._apply_kv_batch(data)
        elif kind == 2:  # split marker (≈ KVRangeFSM WALSplit command)
            if self.on_split is not None:
                self.on_split(data[1:])
        elif kind == 3:  # seal/unseal marker (merge ph.1, ≈ WALPrepareMerge)
            self.sealed = bool(data[1]) if len(data) > 1 else True
            if self.on_seal is not None:
                self.on_seal(self.sealed)
        elif kind == 4:  # merge-commit payload (phase 2, ≈ WALMerge)
            if self.on_merge is not None:
                self.on_merge(data[1:])
        else:
            if self.sealed:
                out = b"retry"
            else:
                writer = self.space.writer()
                out = (self.coproc.mutate(data[1:], self.space, writer)
                       if self.coproc is not None else b"")
                writer.done()
            if entry.index in self._pending_results:
                self._mutation_results[entry.index] = out

    def _apply_kv_batch(self, data: bytes) -> None:
        n = struct.unpack_from(">I", data, 1)[0]
        pos = 5
        w = self.space.writer()
        for _ in range(n):
            code = data[pos]
            pos += 1
            alen = struct.unpack_from(">I", data, pos)[0]
            pos += 4
            a = data[pos:pos + alen]
            pos += alen
            blen = struct.unpack_from(">I", data, pos)[0]
            pos += 4
            b = data[pos:pos + blen]
            pos += blen
            if code == _OP_PUT:
                w.put(a, b)
            elif code == _OP_DEL:
                w.delete(a)
            else:
                w.delete_range(a, b)
        w.done()

    def _snapshot(self) -> bytes:
        out = bytearray()
        for k, v in self.space.iterate():
            out += struct.pack(">I", len(k)) + k
            out += struct.pack(">I", len(v)) + v
        return bytes(out)

    def _restore(self, data: bytes) -> None:
        w = self.space.writer()
        w.delete_range(b"", b"\xff" * 32)
        pos = 0
        while pos < len(data):
            klen = struct.unpack_from(">I", data, pos)[0]
            pos += 4
            k = data[pos:pos + klen]
            pos += klen
            vlen = struct.unpack_from(">I", data, pos)[0]
            pos += 4
            v = data[pos:pos + vlen]
            pos += vlen
            w.put(k, v)
        w.done()
        if self.coproc is not None:
            self.coproc.reset(self.space)

    # ---------------- public API -------------------------------------------

    async def put(self, key: bytes, value: bytes) -> None:
        await self.raft.propose(_enc_kv_ops([("put", key, value)]))

    async def delete(self, key: bytes) -> None:
        await self.raft.propose(_enc_kv_ops([("del", key, None)]))

    async def write_batch(self, ops) -> None:
        await self.raft.propose(_enc_kv_ops(ops))

    async def propose_split(self, split_key: bytes) -> None:
        """Replicate a split marker; the hosting store's ``on_split`` hook
        executes the state transfer when it applies."""
        await self.raft.propose(bytes([2]) + split_key)

    async def propose_seal(self, sealed: bool = True) -> None:
        """Merge phase 1: once this marker applies, no later mutation of
        ANY kind can change the space — every replica's content is frozen
        at the same log position (the precondition for a deterministic
        merge). ``sealed=False`` rolls the seal back (aborted merge)."""
        await self.raft.propose(bytes([3, int(sealed)]))

    async def propose_merge(self, payload: bytes) -> None:
        """Merge phase 2 (proposed on the SURVIVING range): payload carries
        the sealed sibling's id, boundary, and data."""
        await self.raft.propose(bytes([4]) + payload)

    async def mutate_coproc(self, payload: bytes) -> bytes:
        """RW coproc call through consensus (≈ KVRangeRWRequest execute)."""
        # register interest BEFORE proposing: a single-voter leader commits
        # and applies synchronously inside propose(), so registering after
        # would miss the result
        guess = self.raft.last_index + 1
        self._pending_results.add(guess)
        try:
            index = await self.raft.propose(_enc_coproc(payload))
        finally:
            self._pending_results.discard(guess)
        return self._mutation_results.pop(index, b"")

    async def get(self, key: bytes, *, linearized: bool = True
                  ) -> Optional[bytes]:
        if linearized:
            await self.raft.read_index()
        return self.space.get(key)

    async def query_coproc(self, payload: bytes, *,
                           linearized: bool = True) -> bytes:
        """RO coproc call (≈ KVRangeRORequest via KVRangeQueryRunner)."""
        if linearized:
            await self.raft.read_index()
        if self.coproc is None:
            return b""
        return self.coproc.query(payload, self.space)

    @property
    def is_leader(self) -> bool:
        from ..raft.node import Role
        return self.raft.role == Role.LEADER
