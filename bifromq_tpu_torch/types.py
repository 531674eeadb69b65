"""Shared value types (copy of ``bifromq_tpu/types.py``; ≈ reference
bifromq-common-type protos).

These mirror the semantics of the reference protos without protobuf: they
are frozen dataclasses used across the broker plane. The match plane
(models/ops) works on integer-packed tensors derived from these.

Reference protos:
- RouteMatcher   bifromq-common-type/src/main/proto/commontype/RouteMatcher.proto:27
- ClientInfo     .../commontype/ClientInfo.proto
- QoS            .../commontype/QoS.proto
- Message/TopicMessagePack  .../commontype/TopicMessage.proto
- MatchInfo      .../commontype/SubInfo.proto
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from .utils import topic as topic_util


class QoS(enum.IntEnum):
    AT_MOST_ONCE = 0
    AT_LEAST_ONCE = 1
    EXACTLY_ONCE = 2


class RouteMatcherType(enum.IntEnum):
    """RouteMatcher.Type (RouteMatcher.proto:28-32)."""
    NORMAL = 0
    UNORDERED_SHARE = 1
    ORDERED_SHARE = 2


@dataclass(frozen=True)
class RouteMatcher:
    """A parsed subscription topic filter (RouteMatcher.proto:27).

    ``filter_levels`` excludes the ``$share/<group>`` / ``$oshare/<group>``
    prefix; ``mqtt_topic_filter`` preserves the original filter string.
    """
    type: RouteMatcherType
    filter_levels: Tuple[str, ...]
    mqtt_topic_filter: str
    group: Optional[str] = None

    @staticmethod
    def from_topic_filter(topic_filter: str) -> "RouteMatcher":
        """Build from a validated MQTT topic filter string."""
        for shared, prefix, kind in (
                (topic_util.is_unordered_shared, topic_util.UNORDERED_SHARE,
                 RouteMatcherType.UNORDERED_SHARE),
                (topic_util.is_ordered_shared, topic_util.ORDERED_SHARE,
                 RouteMatcherType.ORDERED_SHARE)):
            if shared(topic_filter):
                rest = topic_filter[len(prefix) + 1:]
                group, _, real_filter = rest.partition(topic_util.DELIMITER)
                return RouteMatcher(
                    type=kind,
                    filter_levels=tuple(topic_util.parse(real_filter)),
                    mqtt_topic_filter=topic_filter,
                    group=group,
                )
        return RouteMatcher(
            type=RouteMatcherType.NORMAL,
            filter_levels=tuple(topic_util.parse(topic_filter)),
            mqtt_topic_filter=topic_filter,
        )


@dataclass(frozen=True)
class ClientInfo:
    """Identity of a connected client (ClientInfo.proto)."""
    tenant_id: str
    type: str = "MQTT"
    metadata: Tuple[Tuple[str, str], ...] = ()

    def meta(self) -> Dict[str, str]:
        return dict(self.metadata)


@dataclass(frozen=True)
class Message:
    """A published application message (TopicMessage.proto Message)."""
    message_id: int
    pub_qos: QoS
    payload: bytes
    timestamp: int  # HLC stamp
    expiry_seconds: int = 0xFFFFFFFF
    is_retain: bool = False
    is_retained: bool = False  # delivered because it was a retained message
    user_properties: Tuple[Tuple[str, str], ...] = ()
    content_type: str = ""
    response_topic: str = ""
    correlation_data: bytes = b""
    payload_format_indicator: int = 0


@dataclass(frozen=True)
class PublisherMessagePack:
    publisher: ClientInfo
    messages: Tuple[Message, ...]


@dataclass(frozen=True)
class TopicMessagePack:
    """Messages grouped by topic (TopicMessage.proto TopicMessagePack)."""
    topic: str
    packs: Tuple[PublisherMessagePack, ...]


@dataclass(frozen=True)
class MatchInfo:
    """A matched delivery target (SubInfo.proto MatchInfo)."""
    matcher: RouteMatcher
    receiver_id: str
    incarnation: int = 0


@dataclass(frozen=True)
class TopicFilterOption:
    """Per-subscription options recorded by inbox/session (TopicFilterOption.proto)."""
    qos: QoS = QoS.AT_MOST_ONCE
    retain_as_published: bool = False
    no_local: bool = False
    retain_handling: int = 0
    sub_id: Optional[int] = None
    incarnation: int = 0


def now_millis() -> int:
    return int(time.time() * 1000)
