"""Slot -> delivery-peer table (copy of the peer-table half of
``bifromq_tpu/dist/deliverer.py``; the RPC half is not ported yet).

The device expansion stage buckets expanded (slot, topic) pairs by
delivery target so the host receives pre-grouped grids and keeps only
the last-hop MQTT encode. The table is a compile-time hint, never a
correctness surface: slots whose target the table cannot name — group
matchings (one delivery picks ONE member at send time, possibly on any
member's server) — land in the UNKNOWN bucket and get the exact
``server_of`` grouping on host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def server_of(deliverer_key: str) -> str:
    """The owning server id of a ``{server_id}|...`` deliverer key."""
    sid, sep, _ = deliverer_key.partition("|")
    return sid if sep else ""


class PeerTable:
    """Dense delivery-peer ids for one compiled slot arena.

    ``peers[i]`` is the server id behind peer id ``i``; ``slot_peer[s]``
    maps matching slot ``s`` to its peer id, or ``n_peers`` (UNKNOWN)
    when the compile-time table cannot commit to one target.
    """

    __slots__ = ("slot_peer", "peers", "index")

    def __init__(self, slot_peer: np.ndarray,
                 peers: Sequence[str]) -> None:
        self.slot_peer = slot_peer
        self.peers = list(peers)
        self.index = {p: i for i, p in enumerate(self.peers)}

    @property
    def n_peers(self) -> int:
        return len(self.peers)


def build_peer_table(matchings: Sequence,
                     peers: Optional[Sequence[str]] = None) -> PeerTable:
    """Build the slot -> peer table from a compiled matchings arena.

    ``peers`` pins the id space; when omitted the table's own sorted
    server-id set defines it. Servers not in a pinned ``peers`` list fall
    to UNKNOWN rather than growing the id space.
    """
    keys: List[str] = []
    for m in matchings:
        dkey = getattr(m, "deliverer_key", None)
        keys.append(server_of(dkey) if isinstance(dkey, str) else "")
    if peers is None:
        peers = sorted({k for k in keys if k})
    index = {p: i for i, p in enumerate(peers)}
    unknown = len(peers)
    slot_peer = np.fromiter(
        (index.get(k, unknown) if k else unknown for k in keys),
        dtype=np.int32, count=len(keys))
    return PeerTable(slot_peer, peers)


def bucket_views(peer_slots: np.ndarray, peer_rows: np.ndarray,
                 peer_offsets: np.ndarray, peers: Sequence[str]
                 ) -> List[Tuple[str, np.ndarray, np.ndarray]]:
    """Slice a device-bucketed batch into per-peer (server_id, slots,
    rows) views — zero-copy, already grouped; the UNKNOWN bucket comes
    back under server id ``""`` for the host ``server_of`` fallback, the
    trailing pad bucket is dropped."""
    out: List[Tuple[str, np.ndarray, np.ndarray]] = []
    for i, sid in enumerate(list(peers) + [""]):
        lo, hi = int(peer_offsets[i]), int(peer_offsets[i + 1])
        if hi > lo:
            out.append((sid, peer_slots[lo:hi], peer_rows[lo:hi]))
    return out
