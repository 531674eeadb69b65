"""MQTT topic constants, level parsing and the KV escape (copy of the
parts of ``bifromq_tpu/utils/topic.py`` the match and dist planes use).

Reference: ``bifromq-util/src/main/java/org/apache/bifromq/util/TopicUtil.java``
and ``TopicConst.java``.
"""

from __future__ import annotations

from typing import List

NUL = "\u0000"
DELIMITER = "/"
SINGLE_WILDCARD = "+"
MULTI_WILDCARD = "#"
SYS_PREFIX = "$"
UNORDERED_SHARE = "$share"
ORDERED_SHARE = "$oshare"

_PREFIX_UNORDERED_SHARE = UNORDERED_SHARE + DELIMITER
_PREFIX_ORDERED_SHARE = ORDERED_SHARE + DELIMITER


def to_str(topic) -> str:
    """Raw wire topic ``bytes`` → ``str`` at a cold boundary (events,
    delivery packs). The pub path carries topics as given end to end;
    only boundaries that need text pay the decode, once."""
    if isinstance(topic, bytes):
        return topic.decode("utf-8", "replace")
    return topic


def parse(topic: str, escaped: bool = False) -> List[str]:
    """Split a topic/topic-filter into levels.

    Mirrors TopicUtil.parse (TopicUtil.java:205): every separator produces a
    new (possibly empty) level; "/" -> ["", ""].
    """
    sep = NUL if escaped else DELIMITER
    return topic.split(sep)


def escape(topic_filter: str) -> str:
    """Replace '/' with NUL for order-preserving KV encoding (TopicUtil.escape)."""
    assert NUL not in topic_filter
    return topic_filter.replace(DELIMITER, NUL)


def unescape(topic_filter: str) -> str:
    return topic_filter.replace(NUL, DELIMITER)


def is_unordered_shared(topic_filter: str) -> bool:
    return topic_filter.startswith(_PREFIX_UNORDERED_SHARE)


def is_ordered_shared(topic_filter: str) -> bool:
    return topic_filter.startswith(_PREFIX_ORDERED_SHARE)
