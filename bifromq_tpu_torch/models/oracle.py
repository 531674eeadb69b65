"""Pure-Python subscription-trie matcher: the semantics oracle & CPU fallback
(copy of ``bifromq_tpu/models/oracle.py``).

This mirrors the observable behavior of the reference hot loop —
``TenantRouteMatcher.matchAll`` (bifromq-dist/bifromq-dist-worker/src/main/java/
org/apache/bifromq/dist/worker/cache/TenantRouteMatcher.java:68) joined with
the ``TopicFilterIterator`` expansion-set semantics
(bifromq-dist-coproc-proto .../trie/TopicFilterIterator.java:38) — but with an
idiomatic direct NFA walk over a level trie instead of the reference's
sort-merge join over a KV iterator (that design is RocksDB-iterator-shaped;
ours is table-shaped, see models/automaton.py for the device form).

Roles:
- Ground truth in parity tests for the device automaton walk.
- Host-side fallback for probes that overflow the fixed-shape device walk
  (mirrors the reference's seek-vs-next fallback heuristic role,
  TenantRouteMatcher.java:129-136).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

from ..types import RouteMatcher, RouteMatcherType
from ..utils import topic as topic_util


@dataclass(frozen=True)
class Route:
    """One route-table entry: a matcher plus its delivery target.

    Equivalent to a decoded dist-worker-schema record
    (bifromq-dist-worker-schema .../schema/KVSchemaUtil.java:96-130):
    normal routes carry an incarnation; shared routes live in a group map
    keyed by receiver.
    """
    matcher: RouteMatcher
    broker_id: int
    receiver_id: str
    deliverer_key: str
    incarnation: int = 0

    @property
    def receiver_url(self) -> Tuple[int, str, str]:
        return (self.broker_id, self.receiver_id, self.deliverer_key)


class _TrieNode:
    __slots__ = ("children", "routes", "groups")

    def __init__(self) -> None:
        self.children: Dict[str, _TrieNode] = {}
        # normal routes terminating at this node, keyed by receiver_url
        self.routes: Dict[Tuple[int, str, str], Route] = {}
        # shared groups keyed by (matcher type, group name): "$share/g/f" and
        # "$oshare/g/f" are distinct route groups in the reference schema
        # (distinct flag byte in the route key, KVSchemaConstants.java:25-33)
        self.groups: Dict[Tuple[int, str], Dict[Tuple[int, str, str], Route]] = {}

    def is_empty(self) -> bool:
        return not self.children and not self.routes and not self.groups


PERSISTENT_SUB_BROKER_ID = 1  # inbox sub-broker (IInboxClient.java:55 id=1)
UNCAPPED_FANOUT = 2 ** 31 - 1  # "no limit" sentinel for fan-out caps


@dataclass
class MatchedRoutes:
    """Match result with caps mirroring
    bifromq-dist-worker .../cache/MatchedRoutes.java:38 semantics:

    - ``max_persistent_fanout`` caps only *persistent* normal routes
      (sub-broker id == 1, MatchedRoutes.addNormalMatching:88-104); transient
      routes are uncapped.
    - ``max_group_fanout`` caps the number of distinct *group matchings*
      (keyed by the full mqtt topic filter incl. the share prefix,
      MatchedRoutes.putGroupMatching:119-141), not members within a group.
    """
    normal: List[Route] = field(default_factory=list)
    # mqtt_topic_filter ("$share/g/f" / "$oshare/g/f") -> member routes
    groups: Dict[str, List[Route]] = field(default_factory=dict)
    persistent_fanout: int = 0
    max_persistent_fanout_exceeded: bool = False
    max_group_fanout_exceeded: bool = False

    def all_routes(self) -> List[Route]:
        out = list(self.normal)
        for members in self.groups.values():
            out.extend(members)
        return out


class SubscriptionTrie:
    """A mutable per-tenant subscription trie with NFA wildcard matching.

    add/remove mirror DistWorkerCoProc.batchAddRoute/batchRemoveRoute effects
    on the route table (DistWorkerCoProc.java:304/415): normal routes are
    incarnation-guarded per receiver; shared routes upsert into a group map.
    """

    def __init__(self) -> None:
        self._root = _TrieNode()
        self._count = 0

    def __len__(self) -> int:
        return self._count

    def add(self, route: Route) -> bool:
        """Insert or refresh a route. Returns True if a new entry was created.

        Incarnation guard: an insert with a stale incarnation (< existing) is
        ignored, matching the reference's guard on normal-route upsert.
        """
        return self.add_effective(route)[0]

    def add_effective(self, route: Route) -> Tuple[bool, bool]:
        """Insert or refresh a route; returns (created, effective).

        ``created``: a new entry was created. ``effective``: the stored state
        changed at all (a refresh of an existing entry with an equal-or-newer
        incarnation is effective but not created; a stale-incarnation insert
        is neither). Overlay maintenance (TpuMatcher) keys off ``effective``.
        """
        url = route.receiver_url
        # probe without creating first: a stale-incarnation insert must not
        # materialize (and leak) empty trie nodes along a new path
        probe = self._root
        for level in route.matcher.filter_levels:
            probe = probe.children.get(level)
            if probe is None:
                break
        if (probe is not None
                and route.matcher.type == RouteMatcherType.NORMAL):
            existing = probe.routes.get(url)
            if existing is not None:
                if existing.incarnation > route.incarnation:
                    return False, False
                probe.routes[url] = route
                return False, True
        node = self._root
        for level in route.matcher.filter_levels:
            node = node.children.setdefault(level, _TrieNode())
        if route.matcher.type == RouteMatcherType.NORMAL:
            node.routes[url] = route
            self._count += 1
            return True, True
        gkey = (int(route.matcher.type), route.matcher.group or "")
        group = node.groups.setdefault(gkey, {})
        created = url not in group
        group[url] = route
        if created:
            self._count += 1
        return created, True

    def remove(self, matcher: RouteMatcher, receiver_url: Tuple[int, str, str],
               incarnation: int = 0) -> bool:
        """Remove a route; stale-incarnation removes of normal routes are no-ops."""
        path: List[Tuple[_TrieNode, str]] = []
        node = self._root
        for level in matcher.filter_levels:
            child = node.children.get(level)
            if child is None:
                return False
            path.append((node, level))
            node = child
        removed = False
        if matcher.type == RouteMatcherType.NORMAL:
            existing = node.routes.get(receiver_url)
            if existing is not None and existing.incarnation <= incarnation:
                del node.routes[receiver_url]
                removed = True
        else:
            gkey = (int(matcher.type), matcher.group or "")
            group = node.groups.get(gkey)
            if group is not None and receiver_url in group:
                del group[receiver_url]
                if not group:
                    del node.groups[gkey]
                removed = True
        if removed:
            self._count -= 1
            # prune empty branches
            for parent, level in reversed(path):
                child = parent.children[level]
                if child.is_empty():
                    del parent.children[level]
                else:
                    break
        return removed

    def routes(self) -> Iterable[Route]:
        stack = [self._root]
        while stack:
            n = stack.pop()
            yield from n.routes.values()
            for g in n.groups.values():
                yield from g.values()
            stack.extend(n.children.values())

    def match(self, topic_levels: List[str],
              max_persistent_fanout: int = UNCAPPED_FANOUT,
              max_group_fanout: int = UNCAPPED_FANOUT) -> MatchedRoutes:
        """NFA walk collecting every matching route.

        Semantics identical to utils.topic.matches applied to every stored
        filter, including the [MQTT-4.7.2-1] '$'-first-level rule; caps follow
        MatchedRoutes.java:38 (normal-route cap counts every normal route,
        group cap counts members per group).
        """
        out = MatchedRoutes()
        sys_first = bool(topic_levels) and topic_levels[0].startswith(topic_util.SYS_PREFIX)
        n_levels = len(topic_levels)
        # active set of (node, wildcard-blocked) — blocked only matters at level 0
        active: List[_TrieNode] = [self._root]
        for i in range(n_levels + 1):
            allow_wildcard = not (i == 0 and sys_first)
            next_active: List[_TrieNode] = []
            for node in active:
                # '#' child accepts regardless of remaining levels
                if allow_wildcard:
                    acc = node.children.get(topic_util.MULTI_WILDCARD)
                    if acc is not None:
                        self._collect(acc, out, max_persistent_fanout, max_group_fanout)
                if i == n_levels:
                    self._collect(node, out, max_persistent_fanout, max_group_fanout)
                    continue
                level = topic_levels[i]
                # literal '+'/'#' levels are invalid in topic names and can
                # only exist in the trie as wildcard children — skipping the
                # exact lookup keeps the oracle consistent with the device
                # walk even on unvalidated input
                exact = (node.children.get(level)
                         if level not in (topic_util.SINGLE_WILDCARD,
                                          topic_util.MULTI_WILDCARD) else None)
                if exact is not None:
                    next_active.append(exact)
                if allow_wildcard:
                    plus = node.children.get(topic_util.SINGLE_WILDCARD)
                    if plus is not None:
                        next_active.append(plus)
            active = next_active
            if not active and i < n_levels:
                break
        return out

    @staticmethod
    def _collect(node: _TrieNode, out: MatchedRoutes,
                 max_persistent_fanout: int, max_group_fanout: int) -> None:
        for route in node.routes.values():
            if route.broker_id == PERSISTENT_SUB_BROKER_ID:
                if out.persistent_fanout >= max_persistent_fanout:
                    out.max_persistent_fanout_exceeded = True
                    continue
                out.persistent_fanout += 1
            out.normal.append(route)
        for members in node.groups.values():
            if not members:
                continue
            key = next(iter(members.values())).matcher.mqtt_topic_filter
            if key not in out.groups and len(out.groups) >= max_group_fanout:
                out.max_group_fanout_exceeded = True
                continue
            out.groups[key] = list(members.values())
