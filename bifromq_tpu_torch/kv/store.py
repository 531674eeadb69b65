"""Multi-range KV store + boundary router + split (copy of
``bifromq_tpu/kv/store.py`` without replica placement and quorum-loss
recovery, which ride the cluster, ROADMAP A.5b; ≈ base-kv elasticity).

``KVRangeStore`` hosts many ``ReplicatedKVRange`` replicas on one node
(≈ base-kv-store-server KVRangeStore.java:101 hosting KVRangeFSMs) and
executes BOTH halves of the reference's split/merge state machine
(KVRangeFSM.java:164 — the SURVEY §7 hard part):

- every range owns a key *boundary* ``[start, end)`` (None end = +inf) and
  its own raft group (per-range member ids ``node:range``);
- a split is a raft entry on the parent range; applying it is
  deterministic on every replica: keys ≥ split_key move to a freshly
  created sibling range (new space, new raft group seeded with identical
  FSM state — a snapshot at index 0), boundaries shrink/attach, and the
  coprocs reset to rebuild derived state;
- a merge is the two-phase seal → merge-commit handshake (see
  ``KVRangeStore.merge``): the mergee freezes at a log position, its
  sealed content ships inside the survivor's merge entry, and every
  replica retires its local mergee deterministically;
- ``KVRangeRouter`` is the client-side boundary map
  (≈ base-kv-store-client's NavigableMap<Boundary, KVRangeSetting>
  ``latestEffectiveRouter``): find_by_key / intersecting.

Range metadata (id → boundary) persists in a store-meta space so a durable
store reloads its range set on restart.
"""

from __future__ import annotations

import json
import struct
from typing import Callable, Dict, List, Optional, Tuple

from .engine import IKVEngine
from .range import IKVRangeCoProc, ReplicatedKVRange

Boundary = Tuple[bytes, Optional[bytes]]   # [start, end); end None = +inf


def _intersects(b: Boundary, start: bytes, end: Optional[bytes]) -> bool:
    bs, be = b
    if be is not None and be <= start:
        return False
    if end is not None and bs >= end:
        return False
    return True


class KVRangeRouter:
    """Boundary-sorted range lookup (client-side router analog)."""

    def __init__(self) -> None:
        self._ranges: List[Tuple[Boundary, str]] = []  # sorted by start

    def update(self, range_id: str, boundary: Boundary) -> None:
        self._ranges = [(b, r) for b, r in self._ranges if r != range_id]
        self._ranges.append((boundary, range_id))
        self._ranges.sort(key=lambda x: x[0][0])

    def remove(self, range_id: str) -> None:
        self._ranges = [(b, r) for b, r in self._ranges if r != range_id]

    def find_by_key(self, key: bytes) -> Optional[str]:
        for (start, end), rid in self._ranges:
            if key >= start and (end is None or key < end):
                return rid
        return None

    def intersecting(self, start: bytes,
                     end: Optional[bytes]) -> List[str]:
        return [rid for b, rid in self._ranges if _intersects(b, start, end)]

    def ranges(self) -> List[Tuple[Boundary, str]]:
        return list(self._ranges)


_META_RANGES = b"ranges"


class KVRangeStore:
    """Hosts this node's range replicas over one engine + one transport."""

    def __init__(self, node_id: str, transport, engine: IKVEngine,
                 coproc_factory: Callable[[str], IKVRangeCoProc], *,
                 member_nodes: Optional[List[str]] = None,
                 space_prefix: str = "") -> None:
        self.node_id = node_id
        self.transport = transport
        self.engine = engine
        self.coproc_factory = coproc_factory
        self.member_nodes = member_nodes or [node_id]
        # namespaces this store's engine spaces so several KVRangeStores
        # (dist routes, inbox, retain) can share one engine
        self.space_prefix = space_prefix
        # the reference's durable raft store, its legacy-layout migration
        # (legacy_space) and replica placement (open(bootstrap=False))
        # arrive with raft/store.py (ROADMAP A.5c); the port's ranges are
        # volatile
        self.ranges: Dict[str, ReplicatedKVRange] = {}
        self.coprocs: Dict[str, IKVRangeCoProc] = {}
        self.boundaries: Dict[str, Boundary] = {}
        self.router = KVRangeRouter()
        self._meta = engine.create_space(f"{space_prefix}store_meta")
        self._split_seq = 0

    # ---------------- lifecycle -------------------------------------------

    def open(self) -> None:
        """Load existing ranges from the meta space, or bootstrap genesis
        (≈ KVRangeStore.start loading IKVSpaces + RangeBootstrapBalancer)."""
        raw = self._meta.get_metadata(_META_RANGES)
        if raw:
            for rec in json.loads(raw.decode()):
                self._open_range(
                    rec["id"],
                    (bytes.fromhex(rec["start"]),
                     bytes.fromhex(rec["end"]) if rec["end"] else None),
                    voters=rec.get("voters"),
                    learners=rec.get("learners"))
        else:
            self._open_range("r0", (b"", None))
            self._persist_meta()

    def _persist_meta(self) -> None:
        recs = [{"id": rid, "start": b[0].hex(),
                 "end": b[1].hex() if b[1] is not None else None,
                 "voters": sorted(self.ranges[rid].raft.voters),
                 "learners": sorted(self.ranges[rid].raft.learners)}
                for rid, b in self.boundaries.items()]
        self._meta.put_metadata(_META_RANGES,
                                json.dumps(sorted(recs,
                                                  key=lambda r: r["id"])
                                           ).encode())

    def _open_range(self, range_id: str, boundary: Boundary, *,
                    voters: Optional[List[str]] = None,
                    learners: Optional[List[str]] = None
                    ) -> ReplicatedKVRange:
        space = self.engine.create_space(
            f"{self.space_prefix}range_{range_id}")
        coproc = self.coproc_factory(range_id)
        member_id = f"{self.node_id}:{range_id}"
        if voters is None:
            voters = [f"{n}:{range_id}" for n in self.member_nodes]
        r = ReplicatedKVRange(range_id, member_id, voters, self.transport,
                              space, coproc=coproc, learners=learners)
        r.on_split = lambda split_key, rid=range_id: self._apply_split(
            rid, split_key)
        r.on_seal = lambda sealed, rid=range_id: self._apply_seal(
            rid, sealed)
        r.on_merge = lambda payload, rid=range_id: self._apply_merge(
            rid, payload)
        if hasattr(self.transport, "register"):
            self.transport.register(r.raft)
        self.ranges[range_id] = r
        self.coprocs[range_id] = coproc
        self.boundaries[range_id] = boundary
        self.router.update(range_id, boundary)
        if hasattr(coproc, "boundary"):
            coproc.boundary = boundary
        if space.get_metadata(b"sealed") == b"\x01":
            # a crash between seal and merge-commit must not forget the
            # seal on this replica while others still enforce it
            r.sealed = True
            self._apply_seal(range_id, True)
        coproc.reset(space)
        return r

    def tick(self) -> None:
        for r in self.ranges.values():
            r.raft.tick()

    def stop(self) -> None:
        for r in self.ranges.values():
            r.raft.stop()

    # ---------------- routing ---------------------------------------------

    def range_for_key(self, key: bytes) -> ReplicatedKVRange:
        rid = self.router.find_by_key(key)
        if rid is None:
            raise KeyError(f"no range covers key {key!r}")
        return self.ranges[rid]

    # ---------------- split (≈ KVRangeFSM split command) -------------------

    async def split(self, range_id: str, split_key: bytes) -> str:
        """Propose a split of ``range_id`` at ``split_key``; resolves with
        the new sibling's id after the split applies on this replica."""
        from .range import propose_with_leader_wait

        r = self.ranges[range_id]
        start, end = self.boundaries[range_id]
        if not (split_key > start and (end is None or split_key < end)):
            raise ValueError("split key outside boundary")
        await propose_with_leader_wait(r,
                                       lambda: r.propose_split(split_key))
        # the apply hook (this replica) created the sibling synchronously
        return self._sibling_id(range_id, split_key)

    def _sibling_id(self, parent: str, split_key: bytes) -> str:
        # hash the WHOLE key: route keys share long tenant prefixes, so a
        # key-prefix id would collide across different split points (and the
        # replay guard would silently swallow real splits)
        import hashlib
        digest = hashlib.blake2b(split_key, digest_size=6).hexdigest()
        return f"{parent}.{digest}"

    def _apply_split(self, range_id: str, split_key: bytes) -> None:
        """Runs inside the raft apply of the split entry — on EVERY replica,
        at the same log position, so the state transfer is deterministic."""
        parent = self.ranges[range_id]
        start, end = self.boundaries[range_id]
        sibling_id = self._sibling_id(range_id, split_key)
        if sibling_id in self.ranges:
            return  # replayed entry (restart); already split
        sib_space = self.engine.create_space(
            f"{self.space_prefix}range_{sibling_id}")
        # move [split_key, end) into the sibling space
        w = sib_space.writer()
        moved = 0
        for k, v in parent.space.iterate(split_key, end):
            w.put(k, v)
            moved += 1
        w.done()
        parent.space.writer().delete_range(
            split_key, end if end is not None else b"\xff" * 48).done()
        # shrink parent, open sibling
        self.boundaries[range_id] = (start, split_key)
        self.router.update(range_id, (start, split_key))
        if hasattr(self.coprocs[range_id], "boundary"):
            self.coprocs[range_id].boundary = (start, split_key)
        coproc = self.coproc_factory(sibling_id)
        member_id = f"{self.node_id}:{sibling_id}"
        # the sibling inherits the PARENT's replica placement (its current
        # voter-node set), not the store's static template — dynamically
        # placed ranges keep their placement through splits
        parent_nodes = sorted({v.split(":", 1)[0]
                               for v in parent.raft.voters})
        voters = [f"{n}:{sibling_id}" for n in parent_nodes]
        sib = ReplicatedKVRange(sibling_id, member_id, voters,
                                self.transport, sib_space, coproc=coproc)
        sib.on_split = lambda sk, rid=sibling_id: self._apply_split(rid, sk)
        sib.on_seal = lambda sealed, rid=sibling_id: self._apply_seal(
            rid, sealed)
        sib.on_merge = lambda payload, rid=sibling_id: self._apply_merge(
            rid, payload)
        if hasattr(self.transport, "register"):
            self.transport.register(sib.raft)
        self.ranges[sibling_id] = sib
        self.coprocs[sibling_id] = coproc
        self.boundaries[sibling_id] = (split_key, end)
        self.router.update(sibling_id, (split_key, end))
        if hasattr(coproc, "boundary"):
            coproc.boundary = (split_key, end)
        if parent_nodes == [self.node_id]:
            # sole-voter range: elect the new group synchronously so the
            # sibling serves immediately after the split applies
            from ..raft.node import Role
            for _ in range(200):
                if sib.raft.role == Role.LEADER:
                    break
                sib.raft.tick()
        # derived state rebuilds from the moved keyspaces
        self.coprocs[range_id].reset(parent.space)
        coproc.reset(sib_space)
        self._persist_meta()

    # ---------------- merge (≈ KVRangeFSM dual-range merge handshake) ------

    async def merge(self, left_id: str, right_id: str) -> None:
        """Merge the adjacent range ``right_id`` into ``left_id``.

        Two-phase, mirroring the reference's PrepareMerge/Merge handshake
        (KVRangeFSM.java:164 — the hard part SURVEY §7 names):

        1. a SEAL entry commits on the mergee: from its apply position no
           mutation can change the space, so every replica that applied it
           holds identical content;
        2. the sealed content ships inside a MERGE entry on the survivor:
           applying it is deterministic on every replica regardless of the
           local mergee replica's progress — write the data, extend the
           boundary, retire the local mergee replica.

        Between seal and merge-apply, mutations on the mergee's keys bounce
        (``b"retry"``) and re-resolve; once the router flips they land on
        the survivor (brief unavailability, as in the reference).
        """
        from .range import propose_with_leader_wait

        ls, le = self.boundaries[left_id]
        rs, re_ = self.boundaries[right_id]
        if le != rs:
            raise ValueError("ranges not adjacent")
        right = self.ranges[right_id]

        await propose_with_leader_wait(right, right.propose_seal)
        # the seal applied locally (propose resolves at apply): the local
        # mergee content is now the canonical sealed state
        payload = bytearray()
        payload += struct.pack(">H", len(right_id.encode()))
        payload += right_id.encode()
        payload += struct.pack(">H", len(re_ or b"\xff"))
        payload += b"\x01" if re_ is not None else b"\x00"
        payload += re_ if re_ is not None else b""
        body = bytearray()
        for k, v in right.space.iterate():
            body += struct.pack(">I", len(k)) + k
            body += struct.pack(">I", len(v)) + v
        payload += struct.pack(">Q", len(body)) + body
        left = self.ranges[left_id]
        try:
            await propose_with_leader_wait(
                left, lambda: left.propose_merge(bytes(payload)))
        except BaseException:
            # phase 2 failed: roll the seal back so the mergee's keyspan
            # does not stay write-unavailable
            try:
                await propose_with_leader_wait(
                    right, lambda: right.propose_seal(False))
            except BaseException:  # noqa: BLE001 — surface the original
                pass
            raise

    def _apply_seal(self, range_id: str, sealed: bool) -> None:
        coproc = self.coprocs.get(range_id)
        rng = self.ranges.get(range_id)
        if rng is not None:
            # durable so a restarted replica re-enforces the seal (the
            # applied-index watermark may already cover the seal entry)
            rng.space.put_metadata(b"sealed",
                                   b"\x01" if sealed else b"\x00")
        if coproc is not None and hasattr(coproc, "boundary"):
            start, end = self.boundaries[range_id]
            # sealed = empty boundary: every mutation bounces for
            # re-resolution; unsealed restores the real boundary
            coproc.boundary = (start, start) if sealed else (start, end)

    def _apply_merge(self, left_id: str, payload: bytes) -> None:
        (n,) = struct.unpack_from(">H", payload, 0)
        pos = 2
        right_id = payload[pos:pos + n].decode()
        pos += n
        (_elen,) = struct.unpack_from(">H", payload, pos)
        pos += 2
        has_end = payload[pos] == 1
        pos += 1
        new_end = None
        if has_end:
            new_end = payload[pos:pos + _elen]
            pos += _elen
        (blen,) = struct.unpack_from(">Q", payload, pos)
        pos += 8
        body = payload[pos:pos + blen]
        left = self.ranges[left_id]
        # fold the sealed content into the survivor
        w = left.space.writer()
        bpos = 0
        while bpos < len(body):
            (klen,) = struct.unpack_from(">I", body, bpos)
            bpos += 4
            k = body[bpos:bpos + klen]
            bpos += klen
            (vlen,) = struct.unpack_from(">I", body, bpos)
            bpos += 4
            w.put(k, body[bpos:bpos + vlen])
            bpos += vlen
        w.done()
        start, _ = self.boundaries[left_id]
        self.boundaries[left_id] = (start, new_end)
        self.router.update(left_id, (start, new_end))
        if hasattr(self.coprocs[left_id], "boundary"):
            self.coprocs[left_id].boundary = (start, new_end)
        self.coprocs[left_id].reset(left.space)
        # retire the local mergee replica (it may lag; its data is already
        # canonical inside this entry)
        self._retire_range(right_id)
        self._persist_meta()

    def _retire_range(self, range_id: str) -> None:
        r = self.ranges.pop(range_id, None)
        if r is None:
            return
        r.raft.stop()
        self.coprocs.pop(range_id, None)
        self.boundaries.pop(range_id, None)
        self.router.remove(range_id)
        # destroy ALL traces: data + metadata (applied watermark, seal) and
        # raft state — a later split reusing the same deterministic
        # sibling id must start from genuinely empty state
        r.space.destroy()

    # ---------------- introspection ---------------------------------------

    def describe(self) -> List[dict]:
        out = []
        for rid, r in sorted(self.ranges.items()):
            s, e = self.boundaries[rid]
            out.append({"id": rid, "start": s.hex(),
                        "end": e.hex() if e is not None else None,
                        "keys": len(r.space),
                        "leader": r.is_leader})
        return out
