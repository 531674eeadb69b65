"""Route-matcher value types (copy of ``RouteMatcher``/``RouteMatcherType``
from ``bifromq_tpu/types.py``).

Reference proto: bifromq-common-type/src/main/proto/commontype/RouteMatcher.proto:27
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Tuple

from .utils import topic as topic_util


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
