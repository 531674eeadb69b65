"""Event collector extension point (copy of the dist plane's part of
``bifromq_tpu/plugin/events.py``; ≈ plugin-event-collector).

The reference streams its pooled event types through IEventCollector
(eventcollector/EventType.java). Here events are lightweight
dataclasses; this copy carries the members the dist plane reports
(route mutations, dispatch, fan-out and delivery) and the retain service
reports, under the reference's names and values. The session and inbox
families come with their slice (ROADMAP A.5b).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List


class EventType(enum.Enum):
    # pub/deliver family
    DELIVER_ERROR = "deliver_error"
    # dist family
    DIST_ERROR = "dist_error"
    # a matcher failure or an exhausted deadline served via the
    # host-oracle fallback (delivery correct, device path down)
    MATCH_DEGRADED = "match_degraded"
    PERSISTENT_FANOUT_THROTTLED = "persistent_fanout_throttled"
    GROUP_FANOUT_THROTTLED = "group_fanout_throttled"
    # route mutation family (≈ distservice Matched/Unmatched/...Error)
    MATCHED = "matched"
    UNMATCHED = "unmatched"
    MATCH_ERROR = "match_error"
    UNMATCH_ERROR = "unmatch_error"
    # dist success (≈ Disted) + byte-capped persistent fanout
    DISTED = "disted"
    PERSISTENT_FANOUT_BYTES_THROTTLED = "persistent_fanout_bytes_throttled"
    # retain family
    RETAIN_MSG_CLEARED = "retain_msg_cleared"
    MSG_RETAINED = "msg_retained"
    MSG_RETAINED_ERROR = "msg_retained_error"


@dataclass
class Event:
    type: EventType
    tenant_id: str = ""
    meta: Dict[str, Any] = field(default_factory=dict)


class IEventCollector:
    def report(self, event: Event) -> None:
        raise NotImplementedError


class CollectingEventCollector(IEventCollector):
    """Default: keeps a bounded in-memory tail (tests assert against it)."""

    def __init__(self, capacity: int = 10_000) -> None:
        self.events: List[Event] = []
        self.capacity = capacity

    def report(self, event: Event) -> None:
        self.events.append(event)
        if len(self.events) > self.capacity:
            del self.events[:len(self.events) - self.capacity]

    def of(self, etype: EventType) -> List[Event]:
        return [e for e in self.events if e.type == etype]
