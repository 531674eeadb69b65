"""MQTT topic constants, level parsing, the KV escape and the
single-filter match rule (copy of the parts of
``bifromq_tpu/utils/topic.py`` the match, dist and retained planes use).

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


def matches(topic_levels: List[str], filter_levels: List[str]) -> bool:
    """Single-filter MQTT match semantics, used as the parity oracle.

    Implements [MQTT-4.7.1-*]: '+' matches exactly one level, '#' matches any
    number (including zero) of trailing levels, and [MQTT-4.7.2-1]: wildcards
    do not match a first level beginning with '$' (reference:
    bifromq-dist-coproc-proto .../trie/TopicTrieNode.java:151 wildcardMatchable).
    """
    sys_first = bool(topic_levels) and topic_levels[0].startswith(SYS_PREFIX)
    ti, fi = 0, 0
    nt, nf = len(topic_levels), len(filter_levels)
    while fi < nf:
        fl = filter_levels[fi]
        if fl == MULTI_WILDCARD:
            # '#' must be last; matches remaining levels including none
            if ti == 0 and sys_first:
                return False
            return fi == nf - 1
        if ti >= nt:
            return False
        if fl == SINGLE_WILDCARD:
            if ti == 0 and sys_first:
                return False
        elif fl != topic_levels[ti]:
            return False
        ti += 1
        fi += 1
    return ti == nt
