"""KV key/value codecs (copy of the route, message and retain parts of
``bifromq_tpu/kv/schema.py``; the inbox codecs come with their slice,
ROADMAP A.5b).

Order-preserving, tenant-scoped binary encodings with the same structural
properties as the reference schemas, byte-identical to the JAX package's:

- dist routes (≈ bifromq-dist-worker-schema .../schema/KVSchemaUtil.java:96):
  one record per (tenant, filter, flag, group?, receiver); keys sort so a
  tenant's whole route table is one contiguous range (prefix scan rebuilds
  the matcher), and escaped filter levels sort in trie DFS order.
- retained messages (≈ retain-store schema): (tenant, topic) records.

Values are framed with a tiny struct codec (no pickle: stable + safe).
"""

from __future__ import annotations

import struct
from typing import Tuple

from ..models.oracle import Route
from ..types import Message, QoS, RouteMatcher, RouteMatcherType
from ..utils import topic as topic_util

# key-space tags (first byte)
TAG_DIST = b"\x00"
TAG_INBOX = b"\x01"
TAG_RETAIN = b"\x02"

SCHEMA_VER = b"\x01"

# route flags (≈ KVSchemaConstants flag byte)
FLAG_NORMAL = 0
FLAG_UNORDERED = 1
FLAG_ORDERED = 2


def _len16(b: bytes) -> bytes:
    return struct.pack(">H", len(b)) + b


def _read_len16(buf: bytes, pos: int) -> Tuple[bytes, int]:
    n = struct.unpack_from(">H", buf, pos)[0]
    pos += 2
    return buf[pos:pos + n], pos + n


# ------------------------------- dist routes --------------------------------

def tenant_route_prefix(tenant_id: str) -> bytes:
    return TAG_DIST + SCHEMA_VER + _len16(tenant_id.encode())


def route_key(tenant_id: str, matcher: RouteMatcher,
              receiver_url: Tuple[int, str, str]) -> bytes:
    """Key = tenant prefix ‖ len16(escaped-filter) ‖ flag ‖ group ‖ receiver.

    The filter field is length-framed (NUL is the escaped level separator,
    so it cannot double as a terminator); tenant-prefix contiguity — the
    property the matcher rebuild scan relies on — is preserved.
    """
    flag = {RouteMatcherType.NORMAL: FLAG_NORMAL,
            RouteMatcherType.UNORDERED_SHARE: FLAG_UNORDERED,
            RouteMatcherType.ORDERED_SHARE: FLAG_ORDERED}[matcher.type]
    broker_id, receiver_id, deliverer_key = receiver_url
    return (tenant_route_prefix(tenant_id)
            + _len16(topic_util.escape(
                "/".join(matcher.filter_levels)).encode())
            + bytes([flag])
            + _len16((matcher.group or "").encode())
            + struct.pack(">I", broker_id)
            + _len16(receiver_id.encode())
            + _len16(deliverer_key.encode()))


def route_value(incarnation: int) -> bytes:
    return struct.pack(">q", incarnation)


def decode_route(tenant_id: str, key: bytes, value: bytes) -> Route:
    prefix = tenant_route_prefix(tenant_id)
    assert key.startswith(prefix)
    rest = key[len(prefix):]
    filter_b, pos = _read_len16(rest, 0)
    filter_levels = tuple(topic_util.unescape(filter_b.decode()).split("/"))
    flag = rest[pos]
    pos += 1
    group_b, pos = _read_len16(rest, pos)
    broker_id = struct.unpack_from(">I", rest, pos)[0]
    pos += 4
    receiver_b, pos = _read_len16(rest, pos)
    deliverer_b, pos = _read_len16(rest, pos)
    mtype = {FLAG_NORMAL: RouteMatcherType.NORMAL,
             FLAG_UNORDERED: RouteMatcherType.UNORDERED_SHARE,
             FLAG_ORDERED: RouteMatcherType.ORDERED_SHARE}[flag]
    group = group_b.decode() or None
    filter_str = "/".join(filter_levels)
    if mtype == RouteMatcherType.UNORDERED_SHARE:
        mqtt_filter = f"{topic_util.UNORDERED_SHARE}/{group}/{filter_str}"
    elif mtype == RouteMatcherType.ORDERED_SHARE:
        mqtt_filter = f"{topic_util.ORDERED_SHARE}/{group}/{filter_str}"
    else:
        mqtt_filter = filter_str
    incarnation = struct.unpack(">q", value)[0]
    return Route(
        matcher=RouteMatcher(type=mtype, filter_levels=filter_levels,
                             mqtt_topic_filter=mqtt_filter, group=group),
        broker_id=broker_id, receiver_id=receiver_b.decode(),
        deliverer_key=deliverer_b.decode(), incarnation=incarnation)


# ------------------------------- messages -----------------------------------

def encode_message(msg: Message) -> bytes:
    props = msg.user_properties or ()
    out = struct.pack(">QBQI?", msg.message_id, int(msg.pub_qos),
                      msg.timestamp, msg.expiry_seconds, msg.is_retain)
    out += _len16(msg.payload if isinstance(msg.payload, bytes)
                  else bytes(msg.payload))
    out += struct.pack(">H", len(props))
    for k, v in props:
        out += _len16(k.encode()) + _len16(v.encode())
    out += _len16(msg.content_type.encode())
    out += _len16(msg.response_topic.encode())
    out += _len16(msg.correlation_data)
    out += struct.pack(">B", msg.payload_format_indicator)
    return out


def decode_message(buf: bytes) -> Message:
    message_id, qos, ts, expiry, retain = struct.unpack_from(">QBQI?", buf, 0)
    pos = struct.calcsize(">QBQI?")
    payload, pos = _read_len16(buf, pos)
    n_props = struct.unpack_from(">H", buf, pos)[0]
    pos += 2
    props = []
    for _ in range(n_props):
        k, pos = _read_len16(buf, pos)
        v, pos = _read_len16(buf, pos)
        props.append((k.decode(), v.decode()))
    content_type, pos = _read_len16(buf, pos)
    response_topic, pos = _read_len16(buf, pos)
    correlation, pos = _read_len16(buf, pos)
    pfi = buf[pos]
    return Message(message_id=message_id, pub_qos=QoS(qos), payload=payload,
                   timestamp=ts, expiry_seconds=expiry, is_retain=retain,
                   user_properties=tuple(props),
                   content_type=content_type.decode(),
                   response_topic=response_topic.decode(),
                   correlation_data=correlation, payload_format_indicator=pfi)


# ------------------------------- retain -------------------------------------

def retain_key(tenant_id: str, topic: str) -> bytes:
    return TAG_RETAIN + _len16(tenant_id.encode()) + topic.encode()


def split_retain_key(key: bytes) -> tuple:
    tenant_b, pos = _read_len16(key, 1)
    return tenant_b.decode(), key[pos:].decode()


def retain_prefix(tenant_id: str) -> bytes:
    return TAG_RETAIN + _len16(tenant_id.encode())


def prefix_end(prefix: bytes) -> bytes:
    """Smallest byte string greater than every key with this prefix."""
    b = bytearray(prefix)
    while b:
        if b[-1] != 0xFF:
            b[-1] += 1
            return bytes(b)
        b.pop()
    return b"\xff" * 16
