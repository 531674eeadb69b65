"""Retain store as a replicated KV coprocessor (port of
``bifromq_tpu/retain/coproc.py``; ≈ retain-store RetainStoreCoProc.java:76
on base-kv): batchRetain-style SET/DEL ops ride consensus into the retain
keyspace; the wildcard RetainedIndex and the message map are derived
state rebuilt from KV on reset (≈ RetainTopicIndex rebuilt on reset,
store/index/RetainTopicIndex.java:35).

Every index a coproc builds is made like its template (``index_like``):
the template's device, probe length and patching travel with it, so a
range opened, reset or split on the CPU stays on the CPU and one on the
card stays on the card. The remote reader over a shared retain store
(``RemoteRetainReader``, on ``kv/meta.ClusterKVClient``) is ROADMAP
A.5c.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional

from ..kv import schema
from ..kv.engine import IKVSpace, KVWriteBatch
from ..kv.range import IKVRangeCoProc
from ..models.retained import RetainedIndex
from ..types import ClientInfo
from ..utils import topic as topic_util

OP_SET = 0
OP_DEL = 1

_len16 = schema._len16
_read16 = schema._read_len16


def enc_retained(msg_bytes: bytes, publisher: ClientInfo,
                 expire_at: Optional[float]) -> bytes:
    out = bytearray(struct.pack(">d", -1.0 if expire_at is None
                                else expire_at))
    out += _len16(publisher.tenant_id.encode())
    out += _len16(publisher.type.encode())
    out += struct.pack(">H", len(publisher.metadata))
    for k, v in publisher.metadata:
        out += _len16(k.encode()) + _len16(v.encode())
    out += msg_bytes
    return bytes(out)


def dec_retained(buf: bytes):
    (exp,) = struct.unpack_from(">d", buf, 0)
    pos = 8
    tenant_b, pos = _read16(buf, pos)
    type_b, pos = _read16(buf, pos)
    (n,) = struct.unpack_from(">H", buf, pos)
    pos += 2
    meta = []
    for _ in range(n):
        k, pos = _read16(buf, pos)
        v, pos = _read16(buf, pos)
        meta.append((k.decode(), v.decode()))
    msg = schema.decode_message(buf[pos:])
    publisher = ClientInfo(tenant_id=tenant_b.decode(),
                           type=type_b.decode(), metadata=tuple(meta))
    return (None if exp < 0 else exp), publisher, msg


def index_like(tmpl: RetainedIndex) -> RetainedIndex:
    """An empty index shaped like ``tmpl``: its level and state budgets,
    probe length, device and patching."""
    return RetainedIndex(max_levels=tmpl.max_levels, k_states=tmpl.k_states,
                         probe_len=tmpl.probe_len, device=tmpl.device,
                         patched=tmpl._patched)


class RetainCoProc(IKVRangeCoProc):
    """Applies retain SET/DEL deterministically; derived index per replica.

    The derived index is PATCHED in place per applied op (the apply
    stream is exactly the retained delta stream), and the coproc fans
    each applied mutation out to ``delta_consumers`` (the scan cache's
    exact invalidation and the per-range retained delta log), for
    raft-replayed mutations too. ``reset`` (rebuild from KV) emits the
    wholesale ``(None, None, "reset")`` record. ``index=None`` means a
    default index on the card.
    """

    def __init__(self, index: Optional[RetainedIndex] = None) -> None:
        from ..kv.load import KVLoadRecorder

        # (tenant, topic_levels, op) consumers; op in set|del|reset
        self.delta_consumers: list = []
        # the SUBSCRIBE-side serving plane (armed by RetainService; a
        # bare coproc serves without one)
        self.scan_plane = None
        self.index = index or RetainedIndex()
        self._arm_index(self.index)
        # tenant -> topic -> value bytes (decoded lazily by the service)
        self.values: Dict[str, Dict[str, bytes]] = {}
        # multi-range hosting (boundary bounce + load profile)
        self.boundary = None
        self.load_recorder = KVLoadRecorder()

    def _arm_index(self, index: RetainedIndex) -> None:
        index.delta_hooks.append(self._emit_delta)

    def _emit_delta(self, tenant, topic_levels, op) -> None:
        for cb in list(self.delta_consumers):
            try:
                cb(tenant, topic_levels, op)
            except Exception:  # noqa: BLE001 — observers must not break
                import logging
                logging.getLogger(__name__).exception("retain delta hook")

    def reset(self, reader: IKVSpace) -> None:
        self.index = index_like(self.index)
        self.values = {}
        for key, value in reader.iterate(
                schema.TAG_RETAIN, schema.prefix_end(schema.TAG_RETAIN)):
            tenant, topic = schema.split_retain_key(key)
            self.values.setdefault(tenant, {})[topic] = value
            self.index.add_topic(tenant, topic_util.parse(topic), topic)
        # the rebuilt world renumbers everything: consumers degrade to
        # their wholesale form (scan cache bump), THEN new deltas flow
        self._arm_index(self.index)
        self._emit_delta(None, None, "reset")

    # RO wildcard match over the wire (retain-store-as-a-service read
    # side, ≈ RetainStoreCoProc's RO batchMatch): a replica-less frontend
    # matches retained messages via the store RPC. Wire:
    #   req  := 0x01 ‖ len16 tenant ‖ u32 limit ‖ len16 filter
    #   resp := u32 n ‖ n × (len16 topic ‖ len32 stored-value)
    Q_MATCH = 1

    def query(self, input_data: bytes, reader: IKVSpace) -> bytes:
        from ..kv.range import BoundaryBounce

        if not input_data or input_data[0] != self.Q_MATCH:
            return b""  # local reads go through the index/service
        tenant_b, pos = _read16(input_data, 1)
        (limit,) = struct.unpack_from(">I", input_data, pos)
        pos += 4
        filter_b, pos = _read16(input_data, pos)
        tenant = tenant_b.decode()
        if self.boundary is not None:
            start, end = self.boundary
            pfx = schema.retain_prefix(tenant)
            if pfx < start or (end is not None and pfx >= end):
                # split/seal raced the routing: bounce, never answer
                # "no retained messages" from an emptied span
                raise BoundaryBounce(tenant)
        topics = self.index.match_batch(
            [(tenant, topic_util.parse(filter_b.decode()))],
            limit=limit)[0]
        vals = self.values.get(tenant, {})
        out = bytearray(struct.pack(">I", 0))
        n = 0
        for topic in topics:
            raw = vals.get(topic)
            if raw is None:
                continue
            out += _len16(topic.encode())
            out += struct.pack(">I", len(raw)) + raw
            n += 1
            if n >= limit:
                break
        struct.pack_into(">I", out, 0, n)
        return bytes(out)

    def mutate(self, input_data: bytes, reader: IKVSpace,
               writer: KVWriteBatch) -> bytes:
        op = input_data[0]
        tenant_b, pos = _read16(input_data, 1)
        topic_b, pos = _read16(input_data, pos)
        tenant, topic = tenant_b.decode(), topic_b.decode()
        key = schema.retain_key(tenant, topic)
        if self.boundary is not None:
            start, end = self.boundary
            if key < start or (end is not None and key >= end):
                return b"retry"     # split moved the key: re-resolve
        self.load_recorder.record(key)
        store = self.values.setdefault(tenant, {})
        if op == OP_DEL:
            existed = store.pop(topic, None) is not None
            if existed:
                writer.delete(key)
                self.index.remove_topic(tenant, topic_util.parse(topic),
                                        topic)
            if not store:
                self.values.pop(tenant, None)
            return b"\x01" if existed else b"\x00"
        value = input_data[pos:]
        created = topic not in store
        store[topic] = value
        writer.put(key, value)
        if created:
            self.index.add_topic(tenant, topic_util.parse(topic), topic)
        return b"\x01" if created else b"\x00"


def enc_op(op: int, tenant: str, topic: str, value: bytes = b"") -> bytes:
    return (bytes([op]) + _len16(tenant.encode()) + _len16(topic.encode())
            + value)


def enc_match_query(tenant_id: str, topic_filter: str,
                    limit: int) -> bytes:
    return (bytes([RetainCoProc.Q_MATCH]) + _len16(tenant_id.encode())
            + struct.pack(">I", limit) + _len16(topic_filter.encode()))


def dec_match_reply(buf: bytes):
    """[(topic, expire_at, publisher, Message)] from a Q_MATCH reply."""
    (n,) = struct.unpack_from(">I", buf, 0)
    pos = 4
    out = []
    for _ in range(n):
        topic_b, pos = _read16(buf, pos)
        (rlen,) = struct.unpack_from(">I", buf, pos)
        pos += 4
        expire_at, publisher, msg = dec_retained(buf[pos:pos + rlen])
        pos += rlen
        out.append((topic_b.decode(), expire_at, publisher, msg))
    return out
