"""Level-packed trie automaton: the host-side compiler for the device walk
(copy of the compile, in-place patching, probe-tokenization and
filter-tokenization parts of ``bifromq_tpu/models/automaton.py``).

The whole multi-tenant route table compiles into flat int32 tables that
live in device memory, and batches of topics match with a fixed-shape NFA
walk (``ops/match.py``, ``csrc/fused_walk.cu``).

Table layout (all int32):

- ``node_tab [N, 12]``: packed per-node record:
    col 0  plus_child   ('+' child node id, -1 if none)
    col 1  hash_child   ('#' child node id, -1 if none)
    col 2  route_start  (first matching slot attached to this node)
    col 3  route_count  (number of matching slots at this node)
    col 4  subtree_end  (DFS pre-order: subtree of n is [n, subtree_end[n)))
    col 5  child_count  (number of literal children)
    col 6  child_start  (into child_list)
    col 7  subtree_route_count (total matchings in subtree)
    col 8  sys_child_count ('$'-prefixed literal children; they sort FIRST)
    col 9  sys_slot_count  (matchings inside those children's subtrees)
    col 10 hash_rcount  (route_count of the '#' child, 0 if none — folded
           into the parent record so the walk needs no extra gather)
    col 11 hash_rstart  (route_start of the '#' child, folded likewise)
- ``edge_tab [NB, P, 4]``: single-choice bucketed hash table of literal
  edges, entries ``(node, h1, h2, child)``. Every key lives in bucket
  mix1(key), so a device lookup reads exactly ONE contiguous bucket row.
- ``child_list [E]``: literal child node ids in CSR order (DFS order).

Level strings are hashed to 64 bits (two int32 lanes) with BLAKE2b + salt; the
compiler detects the same-parent collision and recompiles with a new salt,
so device matches are exact, not probabilistic.

:class:`PatchableTrie` lets the same arenas take mutations in place (see
the section comment above it). The reference's replication half of it
(``PatchPlan``, ``begin_plan``, ``take_plan``, ``apply_plan``) is not
copied, and its env knobs are module constants here.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np

from ..types import RouteMatcherType
from ..utils import topic as topic_util
from .oracle import Route, SubscriptionTrie, _TrieNode

# node_tab column indices
NODE_PLUS = 0
NODE_HASH = 1
NODE_RSTART = 2
NODE_RCOUNT = 3
NODE_SUB_END = 4
NODE_CCOUNT = 5
NODE_CSTART = 6
NODE_SUB_RCOUNT = 7
NODE_SYS_CCOUNT = 8
NODE_SYS_SLOTS = 9
NODE_HRCOUNT = 10
NODE_HRSTART = 11
NODE_COLS = 12

# ext_tab column indices (the retained extras plane): the host patcher
# (retained_plane/patched.py) writes these columns and the retained walk
# (ops/retained.retained_walk_ext) reads them
EXT_START = 0    # first extra_list index of the node's extras run
EXT_COUNT = 1    # live entries in the run
EXT_OWN = 2      # extra_list index of the node's OWN patch slot (-1 none)
EXT_COLS = 4     # padded to a power of two (16-byte rows)

_EMPTY = -1


@dataclass(frozen=True)
class GroupMatching:
    """One matched shared-subscription group (≈ GroupMatching.java:34)."""
    mqtt_topic_filter: str
    ordered: bool
    members: Tuple[Route, ...]


Matching = Union[Route, GroupMatching]


class HashCollisionError(RuntimeError):
    pass


def level_hash(level: str, salt: int) -> Tuple[int, int]:
    """Stable 64-bit hash of a topic level, as two int32s."""
    d = hashlib.blake2b(level.encode("utf-8"), digest_size=8,
                        salt=salt.to_bytes(8, "little")).digest()
    h1 = int.from_bytes(d[:4], "little", signed=True)
    h2 = int.from_bytes(d[4:], "little", signed=True)
    return h1, h2


def _mix_u32(node: np.ndarray, h1: np.ndarray, h2: np.ndarray) -> np.ndarray:
    """Bucket-choice mixer #1; MUST stay in sync with ops.match._mix_u32,
    _mix_u32_int below and mix_u32 in csrc/fused_walk.cu."""
    with np.errstate(over="ignore"):
        x = node.astype(np.uint32) * np.uint32(0x9E3779B1)
        x ^= h1.astype(np.uint32) * np.uint32(0x85EBCA6B)
        x ^= x >> np.uint32(15)
        x *= np.uint32(0xC2B2AE35)
        x ^= h2.astype(np.uint32) * np.uint32(0x27D4EB2F)
        x ^= x >> np.uint32(13)
    return x


_U32 = 0xFFFFFFFF


def _mix_u32_int(node: int, h1: int, h2: int) -> int:
    """``_mix_u32`` of one (node, h1, h2) in Python ints: the patch
    plane's per-edge bucket choice, which every subscribe through
    consensus and every route a reset replays pays at each level,
    without building three numpy arrays a call."""
    x = ((node & _U32) * 0x9E3779B1) & _U32
    x ^= ((h1 & _U32) * 0x85EBCA6B) & _U32
    x ^= x >> 15
    x = (x * 0xC2B2AE35) & _U32
    x ^= ((h2 & _U32) * 0x27D4EB2F) & _U32
    return x ^ (x >> 13)


@dataclass
class CompiledTrie:
    """Immutable compiled automaton (host numpy; see ops.match.DeviceTrie)."""
    node_tab: np.ndarray          # [N, NODE_COLS] int32
    edge_tab: np.ndarray          # [NB, P, 4] int32
    child_list: np.ndarray        # [max(E,1)] int32
    matchings: List[Matching]     # slot -> matching
    tenant_root: Dict[str, int]
    salt: int
    probe_len: int
    max_levels: int

    @property
    def n_nodes(self) -> int:
        return self.node_tab.shape[0]

    @property
    def n_slots(self) -> int:
        return len(self.matchings)

    def root_of(self, tenant_id: str) -> int:
        return self.tenant_root.get(tenant_id, _EMPTY)

    # ---- slot metadata for vectorized host expansion ----------------------

    SLOT_NORMAL = 0
    SLOT_PERSISTENT = 1
    SLOT_GROUP = 2
    # a tombstoned route slot: the walk still emits it inside its node's
    # interval (device tables are patched narrowly, never re-packed per
    # mutation); host expansion filters it out. Reclaimed only by
    # compaction.
    SLOT_DEAD = 3

    @property
    def slot_kind(self) -> np.ndarray:
        """[S] int8: SLOT_NORMAL / SLOT_PERSISTENT / SLOT_GROUP per slot."""
        sk = getattr(self, "_slot_kind", None)
        if sk is None or len(sk) != len(self.matchings):
            from .oracle import PERSISTENT_SUB_BROKER_ID
            sk = np.fromiter(
                (self.SLOT_GROUP if isinstance(m, GroupMatching)
                 else (self.SLOT_PERSISTENT
                       if m.broker_id == PERSISTENT_SUB_BROKER_ID
                       else self.SLOT_NORMAL)
                 for m in self.matchings),
                dtype=np.int8, count=len(self.matchings))
            object.__setattr__(self, "_slot_kind", sk)
        return sk

    @property
    def matchings_arr(self) -> np.ndarray:
        """[S] object ndarray of matchings (fancy-indexable by slot id)."""
        ma = getattr(self, "_matchings_arr", None)
        if ma is None or len(ma) != len(self.matchings):
            ma = np.empty(len(self.matchings), dtype=object)
            for i, m in enumerate(self.matchings):
                ma[i] = m
            object.__setattr__(self, "_matchings_arr", ma)
        return ma


def _node_matchings(node: _TrieNode) -> List[Matching]:
    out: List[Matching] = list(node.routes.values())
    for members in node.groups.values():
        if not members:
            continue
        first = next(iter(members.values()))
        out.append(GroupMatching(
            mqtt_topic_filter=first.matcher.mqtt_topic_filter,
            ordered=first.matcher.type == RouteMatcherType.ORDERED_SHARE,
            members=tuple(members.values()),
        ))
    return out


def compile_tries(tries: Dict[str, SubscriptionTrie], *, max_levels: int = 16,
                  probe_len: int = 16, salt: int = 0, min_edge_cap: int = 8,
                  _max_salt_retries: int = 4) -> CompiledTrie:
    """Compile per-tenant subscription tries into one packed automaton.

    DFS pre-order numbering per tenant (tenants concatenated) gives contiguous
    subtrees. Wildcard children ('+'/'#') become dedicated pointer columns;
    literal children become hash-table edges.
    """
    for attempt in range(_max_salt_retries):
        try:
            return _compile_once(tries, max_levels=max_levels,
                                 probe_len=probe_len, salt=salt + attempt,
                                 min_edge_cap=min_edge_cap)
        except HashCollisionError:
            continue
    raise HashCollisionError("level-hash collisions persisted across salts")


def _compile_once(tries: Dict[str, SubscriptionTrie], *, max_levels: int,
                  probe_len: int, salt: int, min_edge_cap: int) -> CompiledTrie:
    # --- pass 1: DFS, assign pre-order ids, collect rows -------------------
    tenant_root: Dict[str, int] = {}
    matchings: List[Matching] = []
    # per-node scratch rows; grown in DFS order so index == node id
    plus_child: List[int] = []
    hash_child: List[int] = []
    route_start: List[int] = []
    route_count: List[int] = []
    subtree_end: List[int] = []
    child_start: List[int] = []
    child_count: List[int] = []
    sub_rcount: List[int] = []
    sys_ccount: List[int] = []
    sys_slots: List[int] = []
    # (nid, literal child ids); child_list CSR is emitted after the DFS so each
    # node's children stay contiguous despite pre-order subtree allocation
    pending_children: List[Tuple[int, List[int]]] = []
    edges: List[Tuple[int, int, int, int]] = []  # (parent, h1, h2, child)

    def alloc(node: _TrieNode) -> int:
        nid = len(plus_child)
        ms = _node_matchings(node)
        plus_child.append(_EMPTY)
        hash_child.append(_EMPTY)
        route_start.append(len(matchings))
        route_count.append(len(ms))
        subtree_end.append(_EMPTY)
        child_start.append(_EMPTY)
        child_count.append(0)
        sub_rcount.append(0)
        sys_ccount.append(0)
        sys_slots.append(0)
        matchings.extend(ms)
        return nid

    def dfs(node: _TrieNode, nid: int) -> int:
        """Returns total matchings in subtree of nid."""
        total = route_count[nid]
        literals: List[Tuple[str, _TrieNode]] = []
        plus_node = None
        hash_node = None
        for level, child in node.children.items():
            if level == topic_util.SINGLE_WILDCARD:
                plus_node = child
            elif level == topic_util.MULTI_WILDCARD:
                hash_node = child
            else:
                literals.append((level, child))
        # DFS order: literals ('$'-prefixed FIRST, then sorted), '+', '#' —
        # sys-first keeps sys children contiguous for the root-wildcard rule.
        literals.sort(key=lambda kv: (0 if kv[0].startswith(
            topic_util.SYS_PREFIX) else 1, kv[0]))
        seen: Dict[Tuple[int, int], str] = {}
        lit_ids: List[int] = []
        for level, child in literals:
            h1, h2 = level_hash(level, salt)
            prev = seen.get((h1, h2))
            if prev is not None and prev != level:
                raise HashCollisionError(f"collision {prev!r} vs {level!r}")
            seen[(h1, h2)] = level
            cid = alloc(child)
            edges.append((nid, h1, h2, cid))
            lit_ids.append(cid)
            child_total = dfs(child, cid)
            total += child_total
            if level.startswith(topic_util.SYS_PREFIX):
                sys_ccount[nid] += 1
                sys_slots[nid] += child_total
        if lit_ids:
            pending_children.append((nid, lit_ids))
        child_count[nid] = len(literals)
        if plus_node is not None:
            pid = alloc(plus_node)
            plus_child[nid] = pid
            total += dfs(plus_node, pid)
        if hash_node is not None:
            hid = alloc(hash_node)
            hash_child[nid] = hid
            total += dfs(hash_node, hid)
        subtree_end[nid] = len(plus_child)
        sub_rcount[nid] = total
        return total

    for tenant_id, trie in tries.items():
        root = trie._root
        rid = alloc(root)
        tenant_root[tenant_id] = rid
        dfs(root, rid)

    child_list: List[int] = []
    for nid, lit_ids in pending_children:
        child_start[nid] = len(child_list)
        child_list.extend(lit_ids)

    n = len(plus_child)
    node_tab = np.full((max(n, 1), NODE_COLS), _EMPTY, dtype=np.int32)
    if n:
        node_tab[:n, NODE_PLUS] = plus_child
        node_tab[:n, NODE_HASH] = hash_child
        node_tab[:n, NODE_RSTART] = route_start
        node_tab[:n, NODE_RCOUNT] = route_count
        node_tab[:n, NODE_SUB_END] = subtree_end
        node_tab[:n, NODE_CCOUNT] = child_count
        node_tab[:n, NODE_CSTART] = child_start
        node_tab[:n, NODE_SUB_RCOUNT] = sub_rcount
        node_tab[:n, NODE_SYS_CCOUNT] = sys_ccount
        node_tab[:n, NODE_SYS_SLOTS] = sys_slots
        hc = node_tab[:n, NODE_HASH]
        node_tab[:n, NODE_HRCOUNT] = np.where(
            hc >= 0, node_tab[hc.clip(0), NODE_RCOUNT], 0)
        node_tab[:n, NODE_HRSTART] = np.where(
            hc >= 0, node_tab[hc.clip(0), NODE_RSTART], 0)

    # --- pass 2: build the open-addressing edge table ----------------------
    edge_tab = _build_edge_table(edges, probe_len, min_cap=min_edge_cap)

    cl = np.asarray(child_list, dtype=np.int32) if child_list else np.full(
        1, _EMPTY, dtype=np.int32)
    return CompiledTrie(
        node_tab=node_tab,
        edge_tab=edge_tab,
        child_list=cl,
        matchings=matchings,
        tenant_root=tenant_root,
        salt=salt,
        probe_len=probe_len,
        max_levels=max_levels,
    )


def _build_edge_table(edges: List[Tuple[int, int, int, int]],
                      probe_len: int, min_cap: int = 2) -> np.ndarray:
    """Single-choice bucketed hash insert → [n_buckets, probe_len, 4].

    Every key lives in bucket mix1(key) & (nb-1), so the device lookup is
    exactly ONE contiguous bucket-row read (ops.match._edge_lookup).
    n_buckets (power of two) grows until no bucket exceeds probe_len
    entries; the build is a vectorized sort-by-bucket.
    """
    n_edges = len(edges)
    nb = max(min_cap, 2)
    while nb * probe_len < 2 * max(n_edges, 1):
        nb *= 2
    if not n_edges:
        return np.full((nb, probe_len, 4), _EMPTY, dtype=np.int32)
    earr = np.asarray(edges, dtype=np.int32)
    while True:
        mask = np.uint32(nb - 1)
        b1 = (_mix_u32(earr[:, 0], earr[:, 1], earr[:, 2])
              & mask).astype(np.int64)
        counts = np.bincount(b1, minlength=nb)
        if counts.max() <= probe_len:
            tab = np.full((nb, probe_len, 4), _EMPTY, dtype=np.int32)
            order = np.argsort(b1, kind="stable")
            sb = b1[order]
            starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
            slots = np.arange(n_edges, dtype=np.int64) - starts[sb]
            tab[sb, slots] = earr[order]
            return tab
        nb *= 2


# ------------------------ in-place patching --------------------------------
#
# PatchableTrie restructures the layout above for in-place delta patching:
# trie mutations become row-level writes into the flat arenas.
#
# - **node arena with growth headroom**: node_tab is allocated at a
#   power-of-2 row capacity above the live count; new nodes are appended
#   at ``n_live``. Exhausting the headroom doubles the arena (one full
#   re-upload of the node tables) — never a trie recompile.
# - **edge inserts into bucket slack**: the single-choice bucketed hash
#   table already carries ≥2x slack (load ≤ 0.5 at build); a new literal
#   edge drops into the first empty entry of its mix1 bucket. A full
#   bucket regrows the edge table from its own live entries (vectorized
#   ``_build_edge_table`` re-insert — O(E) numpy, no DFS).
# - **tombstoned route slots**: the matching-slot arena is append-only.
#   Removing a route marks its slot SLOT_DEAD (zero device traffic — the
#   walk keeps emitting the interval, host expansion filters); adding a
#   route to a node whose slot interval is not at the arena tail
#   RELOCATES the node's live slots to the tail (the old copies become
#   garbage but stay readable, so a batch dispatched against the old
#   interval still expands exactly).
# - **folded-column maintenance**: a '#'-child's (route_start, route_count)
#   is denormalized into its parent record (NODE_HRCOUNT/NODE_HRSTART);
#   the patcher tracks parents and re-folds on every interval change.
#
# Columns only the retained-mode walk reads (NODE_SUB_END,
# NODE_SUB_RCOUNT, NODE_SYS_*, NODE_CSTART runs) are NOT maintained: the
# match walk never reads them (``retained_plane/patched.py``'s
# RetainedPatchableTrie maintains them for the retained walk, with an
# extras plane for patch-era topics). Compaction (a full compile) runs when
# dead + garbage slots cross PATCH_FRAG_RATIO of the arena.

# the reference's BIFROMQ_PATCH_HEADROOM / _FRAG_RATIO / _FRAG_FLOOR
# defaults, as constants: the arenas must be byte-identical to the
# reference's
PATCH_HEADROOM = 0.125    # minimum spare-row fraction of the node arena
PATCH_FRAG_RATIO = 0.25   # dead+garbage slot fraction that compacts
PATCH_FRAG_FLOOR = 64     # ... once at least this many slots are waste


class PatchFallback(RuntimeError):
    """A mutation this patcher cannot express in place — the caller falls
    back to the delta-overlay path (and typically schedules a compaction)."""


def _next_pow2(n: int, floor: int = 1) -> int:
    p = max(1, floor)
    while p < n:
        p *= 2
    return p


class PatchableTrie(CompiledTrie):
    """A CompiledTrie whose arenas accept in-place delta patches.

    Host numpy arrays are authoritative for patches; dirty row/bucket ids
    accumulate in ``_dirty_nodes``/``_dirty_edges`` (or ``_full`` after a
    reshape) and are drained by ``ops.match.patch_device_trie`` into
    narrow device row writes. Serving correctness contract:

    - A patched arena is exact: base walk + host dead-slot filtering
      equals a match against the authoritative tries, with NO overlay.
    - In-flight snapshot safety: patches are append-only with respect to
      already-dispatched intervals — a relocation leaves the old slot
      copies live (garbage, not dead), so an expansion running against a
      pre-patch walk result still yields the pre-patch route set.
    """

    def __init__(self, ct: CompiledTrie) -> None:
        n = int(ct.node_tab.shape[0])
        cap = _next_pow2(max(n + 1, int(n * (1.0 + PATCH_HEADROOM))),
                         floor=16)
        node_tab = np.full((cap, NODE_COLS), _EMPTY, dtype=np.int32)
        node_tab[:n] = ct.node_tab
        # child_list gets the same pow2-floor padding as the node arena;
        # the CSR runs only ever index real entries
        ncl = int(ct.child_list.shape[0])
        clcap = _next_pow2(max(ncl, 1), floor=16)
        child_list = ct.child_list
        if clcap != ncl:
            child_list = np.full(clcap, _EMPTY, dtype=np.int32)
            child_list[:ncl] = ct.child_list
        super().__init__(node_tab=node_tab, edge_tab=ct.edge_tab,
                         child_list=child_list, matchings=ct.matchings,
                         tenant_root=ct.tenant_root, salt=ct.salt,
                         probe_len=ct.probe_len, max_levels=ct.max_levels)
        self.n_live = n
        self.child_used = ncl   # real CSR length under the pad
        self._init_runtime(ct.slot_kind, ct.matchings_arr)

    @classmethod
    def from_arenas(cls, *, node_tab: np.ndarray, n_live: int,
                    edge_tab: np.ndarray, child_list: np.ndarray,
                    matchings: List[Matching], slot_kind: np.ndarray,
                    tenant_root: Dict[str, int], salt: int, probe_len: int,
                    max_levels: int, dead_slots: int = 0,
                    garbage_slots: int = 0) -> "PatchableTrie":
        """Rebuild a PatchableTrie from given host arenas — capacity
        padding, patch-era node order and dead slots included — with no
        trie DFS and no recompile."""
        self = cls.__new__(cls)
        CompiledTrie.__init__(
            self, node_tab=node_tab, edge_tab=edge_tab,
            child_list=child_list, matchings=list(matchings),
            tenant_root=dict(tenant_root), salt=salt, probe_len=probe_len,
            max_levels=max_levels)
        self.n_live = int(n_live)
        # the given arenas carry their padding; a retained trie installs
        # its own child_live, so the full length is the safe default
        self.child_used = int(child_list.shape[0])
        s = len(self.matchings)
        marr = np.empty(max(s, 1), dtype=object)
        for i, m in enumerate(self.matchings):
            marr[i] = m
        self._init_runtime(np.asarray(slot_kind, dtype=np.int8), marr[:s])
        self.dead_slots = int(dead_slots)
        self.garbage_slots = int(garbage_slots)
        return self

    def _init_runtime(self, kind_src: np.ndarray, marr_src) -> None:
        """The non-arena half of construction, shared by ``__init__`` and
        ``from_arenas``."""
        n, cap = self.n_live, int(self.node_tab.shape[0])
        # parent links (vectorized from the edge table + wildcard columns)
        # so interval changes can re-fold the '#'-child columns upward
        parent = np.full(cap, _EMPTY, dtype=np.int32)
        ids = np.arange(n, dtype=np.int32)
        for col in (NODE_PLUS, NODE_HASH):
            c = self.node_tab[:n, col]
            m = c >= 0
            parent[c[m]] = ids[m]
        entries = self.edge_tab.reshape(-1, 4)
        live = entries[:, 0] >= 0
        parent[entries[live, 3]] = entries[live, 0]
        self.parent = parent
        # slot arena mirrors with capacity (the CompiledTrie cached-array
        # properties are O(S) per length change — unusable per mutation)
        s = len(self.matchings)
        scap = _next_pow2(max(s + 1, 64))
        kind = np.full(scap, CompiledTrie.SLOT_NORMAL, dtype=np.int8)
        marr = np.empty(scap, dtype=object)
        if s:
            kind[:s] = kind_src
            marr[:s] = marr_src
        self._kind = kind
        self._marr = marr
        # fragmentation accounting (the compaction trigger)
        self.dead_slots = 0      # tombstoned, still inside a live interval
        self.garbage_slots = 0   # relocated-away copies, unreachable
        self.relocations = 0
        self.patched_ops = 0
        self.edge_regrows = 0
        self.node_grows = 0
        # dirty tracking drained by the device patch flush
        self._dirty_nodes: Set[int] = set()
        self._dirty_edges: Set[int] = set()
        self._full: Set[str] = set()
        self._pending_ops = 0
        # level strings of PATCH-inserted edges, keyed (parent, h1, h2):
        # the compiler re-salts on a same-parent 64-bit hash collision;
        # the patcher cannot, so a colliding hit among patch-era edges
        # raises PatchFallback (the op serves from the overlay, and the
        # next compaction re-salts). A new level colliding with a BASE
        # edge (whose string the compiled table no longer carries) is
        # undetectable here — ~2^-64 per new sibling pair — until the
        # next compaction sees both strings under one parent.
        self._edge_level: Dict[Tuple[int, int, int], str] = {}

    # CompiledTrie caches these as O(S)-rebuilt arrays keyed on list
    # length; the patchable form maintains them incrementally instead.
    @property
    def slot_kind(self) -> np.ndarray:
        return self._kind[:len(self.matchings)]

    @property
    def matchings_arr(self) -> np.ndarray:
        return self._marr[:len(self.matchings)]

    # ---------------- dirty bookkeeping ------------------------------------

    @property
    def dirty(self) -> bool:
        return bool(self._full or self._dirty_nodes or self._dirty_edges)

    def frag_ratio(self) -> float:
        return (self.dead_slots + self.garbage_slots) \
            / max(1, len(self.matchings))

    def frag_pending(self) -> bool:
        dead = self.dead_slots + self.garbage_slots
        return dead >= PATCH_FRAG_FLOOR \
            and self.frag_ratio() >= PATCH_FRAG_RATIO

    def restore_dirty(self, ops: int) -> None:
        """A device flush failed AFTER draining: the drained row ids are
        gone and some tables may be half written, so mark BOTH tables for
        a full re-upload. The next dispatch's flush rebuilds the device
        state from the (authoritative) host arenas; nothing is lost."""
        self._full |= {"node", "edge"}
        self._dirty_nodes.clear()
        self._dirty_edges.clear()
        self._pending_ops += ops

    def drain_dirty(self):
        """(full-table names, node rows, edge bucket rows, ops) since the
        last drain; clears the dirty state."""
        full = self._full
        nodes = np.fromiter(sorted(self._dirty_nodes), dtype=np.int64,
                            count=len(self._dirty_nodes))
        edges = np.fromiter(sorted(self._dirty_edges), dtype=np.int64,
                            count=len(self._dirty_edges))
        ops = self._pending_ops
        self._full = set()
        self._dirty_nodes = set()
        self._dirty_edges = set()
        self._pending_ops = 0
        return full, nodes, edges, ops

    def patch_stats(self) -> Dict[str, object]:
        cap = int(self.node_tab.shape[0])
        return {
            "node_capacity": cap,
            "live_nodes": int(self.n_live),
            "node_headroom_ratio": round(1.0 - self.n_live / cap, 4),
            "slots": len(self.matchings),
            "dead_slots": int(self.dead_slots),
            "garbage_slots": int(self.garbage_slots),
            "frag_ratio": round(self.frag_ratio(), 4),
            "patched_ops": int(self.patched_ops),
            "relocations": int(self.relocations),
            "edge_regrows": int(self.edge_regrows),
            "node_grows": int(self.node_grows),
        }

    def _mark_node(self, nid: int) -> None:
        if "node" not in self._full:
            self._dirty_nodes.add(int(nid))

    # ---------------- the patch ops (host plan + arena update) --------------

    def patch_add(self, tenant_id: str, route: Route, *,
                  group_members: Optional[Dict] = None) -> str:
        """Fold one effective add into the arenas. Idempotent on the slot
        level (find-or-append keyed by receiver/group identity), so the
        log-suffix replay at a compaction swap can re-apply safely."""
        root = self.tenant_root.get(tenant_id, _EMPTY)
        if root < 0:
            root = self._alloc_node()
            self.tenant_root[tenant_id] = root
        nid = self._descend(root, route.matcher.filter_levels, create=True)
        if route.matcher.type == RouteMatcherType.NORMAL:
            url = route.receiver_url
            s = self._find_slot(
                nid, lambda m: not isinstance(m, GroupMatching)
                and m.receiver_url == url)
            if s is not None:
                self._slot_set(s, route)
            else:
                self._slot_append(nid, route)
        else:
            members = group_members or {}
            if not members:
                raise PatchFallback("group add without members")
            gm = GroupMatching(
                mqtt_topic_filter=route.matcher.mqtt_topic_filter,
                ordered=route.matcher.type == RouteMatcherType.ORDERED_SHARE,
                members=tuple(members.values()))
            tf = route.matcher.mqtt_topic_filter
            s = self._find_slot(
                nid, lambda m: isinstance(m, GroupMatching)
                and m.mqtt_topic_filter == tf)
            if s is not None:
                self._slot_set(s, gm)
            else:
                self._slot_append(nid, gm)
        self.patched_ops += 1
        self._pending_ops += 1
        return "add"

    def patch_remove(self, tenant_id: str, matcher, receiver_url, *,
                     group_members: Optional[Dict] = None) -> str:
        """Fold one effective remove in: tombstone the slot (normal / last
        group member) or swap the group matching for the surviving member
        set. Zero device traffic — intervals are untouched."""
        root = self.tenant_root.get(tenant_id, _EMPTY)
        if root < 0:
            raise PatchFallback("tenant absent from base")
        nid = self._descend(root, matcher.filter_levels, create=False)
        if matcher.type == RouteMatcherType.NORMAL:
            s = self._find_slot(
                nid, lambda m: not isinstance(m, GroupMatching)
                and m.receiver_url == receiver_url)
            if s is None:
                raise PatchFallback("route not in base (overlay-resident?)")
            self._kill_slot(s)
        else:
            tf = matcher.mqtt_topic_filter
            s = self._find_slot(
                nid, lambda m: isinstance(m, GroupMatching)
                and m.mqtt_topic_filter == tf)
            if s is None:
                raise PatchFallback("group not in base (overlay-resident?)")
            if group_members:
                old = self.matchings[s]
                gm = GroupMatching(mqtt_topic_filter=tf,
                                   ordered=old.ordered,
                                   members=tuple(group_members.values()))
                self._slot_set(s, gm)
            else:
                self._kill_slot(s)
        self.patched_ops += 1
        self._pending_ops += 1
        return "remove"

    # ---------------- path machinery ----------------------------------------

    def _descend(self, nid: int, levels: Sequence[str], *,
                 create: bool) -> int:
        for level in levels:
            if level == topic_util.SINGLE_WILDCARD:
                child = int(self.node_tab[nid, NODE_PLUS])
            elif level == topic_util.MULTI_WILDCARD:
                child = int(self.node_tab[nid, NODE_HASH])
            else:
                h1, h2 = level_hash(level, self.salt)
                child = self._edge_child(nid, h1, h2)
                if child >= 0:
                    known = self._edge_level.get((nid, h1, h2))
                    if known is not None and known != level:
                        # same-parent 64-bit collision among patch-era
                        # edges: never guess — overlay + recompile
                        raise PatchFallback(
                            f"level-hash collision {known!r} vs {level!r}")
            if child < 0:
                if not create:
                    raise PatchFallback(f"path missing at {level!r}")
                child = self._alloc_child(nid, level)
            nid = child
        return nid

    def _bucket_of(self, nid: int, h1: int, h2: int) -> int:
        return _mix_u32_int(nid, h1, h2) & (self.edge_tab.shape[0] - 1)

    def _edge_child(self, nid: int, h1: int, h2: int) -> int:
        row = self.edge_tab[self._bucket_of(nid, h1, h2)]
        hit = np.nonzero((row[:, 0] == nid) & (row[:, 1] == h1)
                         & (row[:, 2] == h2))[0]
        return int(row[hit[0], 3]) if hit.size else _EMPTY

    def _edge_insert(self, nid: int, h1: int, h2: int, cid: int) -> None:
        b = self._bucket_of(nid, h1, h2)
        row = self.edge_tab[b]
        empty = np.nonzero(row[:, 0] < 0)[0]
        if not empty.size:
            self._edge_regrow()
            return self._edge_insert(nid, h1, h2, cid)
        self.edge_tab[b, empty[0]] = (nid, h1, h2, cid)
        if "edge" not in self._full:
            self._dirty_edges.add(b)

    def _edge_regrow(self) -> None:
        """A bucket overflowed: rebuild the hash table at ≥2x the bucket
        count from its OWN live entries — vectorized re-insert, no trie
        DFS. The mix mask changes, so the whole table re-ships."""
        entries = self.edge_tab.reshape(-1, 4)
        live = entries[entries[:, 0] >= 0]
        self.edge_tab = _build_edge_table(
            live, self.probe_len, min_cap=2 * self.edge_tab.shape[0])
        self.edge_regrows += 1
        self._full.add("edge")
        self._dirty_edges.clear()

    def _alloc_node(self) -> int:
        if self.n_live >= self.node_tab.shape[0]:
            self._grow_nodes()
        nid = self.n_live
        self.n_live += 1
        self.node_tab[nid] = _EMPTY
        self.node_tab[nid, NODE_RSTART] = len(self.matchings)
        self.node_tab[nid, NODE_RCOUNT] = 0
        self.node_tab[nid, NODE_CCOUNT] = 0
        self.node_tab[nid, NODE_SYS_CCOUNT] = 0
        self.node_tab[nid, NODE_SYS_SLOTS] = 0
        self.node_tab[nid, NODE_HRCOUNT] = 0
        self.node_tab[nid, NODE_HRSTART] = 0
        self._mark_node(nid)
        return nid

    def _grow_nodes(self) -> None:
        cap = self.node_tab.shape[0]
        new = np.full((cap * 2, NODE_COLS), _EMPTY, dtype=np.int32)
        new[:cap] = self.node_tab
        self.node_tab = new
        par = np.full(cap * 2, _EMPTY, dtype=np.int32)
        par[:cap] = self.parent
        self.parent = par
        self.node_grows += 1
        self._full.add("node")
        self._dirty_nodes.clear()

    def _alloc_child(self, nid: int, level: str) -> int:
        cid = self._alloc_node()
        if level == topic_util.SINGLE_WILDCARD:
            self.node_tab[nid, NODE_PLUS] = cid
        elif level == topic_util.MULTI_WILDCARD:
            self.node_tab[nid, NODE_HASH] = cid
            self.node_tab[nid, NODE_HRCOUNT] = 0
            self.node_tab[nid, NODE_HRSTART] = \
                self.node_tab[cid, NODE_RSTART]
        else:
            h1, h2 = level_hash(level, self.salt)
            self._edge_insert(nid, h1, h2, cid)
            self._edge_level[(nid, h1, h2)] = level
            self.node_tab[nid, NODE_CCOUNT] += 1
            if level.startswith(topic_util.SYS_PREFIX):
                self.node_tab[nid, NODE_SYS_CCOUNT] += 1
        self.parent[cid] = nid
        self._mark_node(nid)
        return cid

    # ---------------- slot machinery ----------------------------------------

    def _classify(self, m: Matching) -> int:
        if isinstance(m, GroupMatching):
            return CompiledTrie.SLOT_GROUP
        from .oracle import PERSISTENT_SUB_BROKER_ID
        return (CompiledTrie.SLOT_PERSISTENT
                if m.broker_id == PERSISTENT_SUB_BROKER_ID
                else CompiledTrie.SLOT_NORMAL)

    def _append_slot(self, m: Matching) -> int:
        s = len(self.matchings)
        if s >= self._kind.shape[0]:
            self._kind = np.concatenate(
                [self._kind, np.full(self._kind.shape[0],
                                     CompiledTrie.SLOT_NORMAL, np.int8)])
            marr = np.empty(self._marr.shape[0] * 2, dtype=object)
            marr[:s] = self._marr
            self._marr = marr
        self.matchings.append(m)
        self._kind[s] = self._classify(m)
        self._marr[s] = m
        return s

    def _slot_set(self, s: int, m: Matching) -> None:
        """In-place slot content replacement (incarnation upsert / group
        member swap) — same kind class, zero device traffic."""
        self.matchings[s] = m
        self._marr[s] = m
        self._kind[s] = self._classify(m)

    def _find_slot(self, nid: int, pred) -> Optional[int]:
        rs = int(self.node_tab[nid, NODE_RSTART])
        rc = int(self.node_tab[nid, NODE_RCOUNT])
        for s in range(rs, rs + rc):
            if self._kind[s] != CompiledTrie.SLOT_DEAD \
                    and pred(self._marr[s]):
                return s
        return None

    def _kill_slot(self, s: int) -> None:
        # the matching object stays in place: in-flight expansions of the
        # pre-remove walk may still be holding this slot id
        self._kind[s] = CompiledTrie.SLOT_DEAD
        self.dead_slots += 1

    def _slot_append(self, nid: int, m: Matching) -> None:
        rs = int(self.node_tab[nid, NODE_RSTART])
        rc = int(self.node_tab[nid, NODE_RCOUNT])
        tail = len(self.matchings)
        if rc == 0:
            s = self._append_slot(m)
            self.node_tab[nid, NODE_RSTART] = s
            self.node_tab[nid, NODE_RCOUNT] = 1
        elif rs + rc == tail:
            # the node already owns the arena tail: plain append
            self._append_slot(m)
            self.node_tab[nid, NODE_RCOUNT] = rc + 1
        else:
            # relocate the node's live slots to the tail; the old copies
            # become garbage but stay LIVE so in-flight expansions of the
            # pre-patch interval still see the pre-patch route set
            new_start = tail
            moved = 0
            for s in range(rs, rs + rc):
                if self._kind[s] == CompiledTrie.SLOT_DEAD:
                    self.dead_slots -= 1    # dropped, now plain garbage
                else:
                    self._append_slot(self._marr[s])
                    moved += 1
            self.garbage_slots += rc
            self._append_slot(m)
            self.node_tab[nid, NODE_RSTART] = new_start
            self.node_tab[nid, NODE_RCOUNT] = moved + 1
            self.relocations += 1
        self._after_interval_change(nid)

    def _after_interval_change(self, nid: int) -> None:
        self._mark_node(nid)
        p = int(self.parent[nid])
        if p >= 0 and int(self.node_tab[p, NODE_HASH]) == nid:
            # re-fold the '#'-child interval into the parent record (the
            # walk's per-step '#'-accept reads ONLY the parent row)
            self.node_tab[p, NODE_HRCOUNT] = self.node_tab[nid, NODE_RCOUNT]
            self.node_tab[p, NODE_HRSTART] = self.node_tab[nid, NODE_RSTART]
            self._mark_node(p)


# --------------------------- probe tokenization ----------------------------

def pad_rows(a: np.ndarray, rows: int, fill=0) -> np.ndarray:
    """Pad a row-gathered array up to ``rows`` rows (escalation
    sub-batches snap to power-of-two batch sizes)."""
    if a.shape[0] == rows:
        return a
    out = np.full((rows,) + a.shape[1:], fill, dtype=a.dtype)
    out[:a.shape[0]] = a
    return out


@dataclass
class TokenizedTopics:
    """Fixed-shape probe batch on the host. Padding rows have length == -1."""
    tok_h1: np.ndarray    # [B, max_levels + 1] int32
    tok_h2: np.ndarray    # [B, max_levels + 1] int32
    lengths: np.ndarray   # [B] int32 (level count; -1 for padding rows)
    roots: np.ndarray     # [B] int32 (tenant root node id, -1 unknown tenant)
    sys_mask: np.ndarray  # [B] bool (first level starts with '$')

    @property
    def batch(self) -> int:
        return self.tok_h1.shape[0]

    def sub_batch(self, rows: np.ndarray, batch: int) -> "TokenizedTopics":
        """Row-subset probe batch padded to ``batch`` rows — the
        escalation re-walk's sub-batch constructor (shared with the
        device-tokenized mirror, which re-tokenizes the selected rows)."""
        return TokenizedTopics(
            tok_h1=pad_rows(self.tok_h1[rows], batch),
            tok_h2=pad_rows(self.tok_h2[rows], batch),
            lengths=pad_rows(self.lengths[rows], batch, fill=_EMPTY),
            roots=pad_rows(self.roots[rows], batch, fill=_EMPTY),
            sys_mask=pad_rows(self.sys_mask[rows], batch))


class TokenCache:
    """Per-topic token-row LRU (topics repeat).

    Keyed by the raw topic (string or level tuple); rows depend only on
    (topic, salt, max_levels), so the cache SURVIVES trie recompiles —
    only a salt change clears it. Roots are per-batch and never cached.
    """

    def __init__(self, max_entries: int = 1 << 18) -> None:
        self.max_entries = max_entries
        self._salt: Optional[int] = None
        self._width: Optional[int] = None
        # value: (h1_row [L+1] int32, h2_row, length, sys) — numpy rows
        self._d: "dict" = {}
        self.hits = 0
        self.misses = 0

    def match_config(self, salt: int, width: int) -> None:
        if self._salt != salt or self._width != width:
            self._d.clear()
            self._salt, self._width = salt, width

    def get(self, key):
        v = self._d.get(key)
        if v is not None:
            self.hits += 1
            # true LRU: refresh recency so the eviction sweep (insertion-
            # ordered) drops cold keys, not the hottest ones
            del self._d[key]
            self._d[key] = v
        else:
            self.misses += 1
        return v

    def put(self, key, value) -> None:
        if len(self._d) >= self.max_entries:
            # amortized sweep: drop the oldest half (insertion order)
            drop = len(self._d) // 2
            for k in list(self._d)[:drop]:
                del self._d[k]
        self._d[key] = value


def _tokenize_cached(keys, roots: Sequence[int], cache: TokenCache, *,
                     batch: int, width: int, salt: int,
                     miss_tokenize) -> TokenizedTopics:
    """The ONE cache-probe + miss-fill + padded-assembly definition:
    ``miss_tokenize(miss_idx)`` returns a TokenizedTopics for exactly
    those rows; cached values are (h1_row, h2_row, length, sys)."""
    cache.match_config(salt, width)
    miss_idx = []
    vals = []
    for i, k in enumerate(keys):
        v = cache.get(k)
        vals.append(v)
        if v is None:
            miss_idx.append(i)
    if miss_idx:
        sub = miss_tokenize(miss_idx)
        for j, i in enumerate(miss_idx):
            v = (sub.tok_h1[j].copy(), sub.tok_h2[j].copy(),
                 int(sub.lengths[j]), bool(sub.sys_mask[j]))
            cache.put(keys[i], v)
            vals[i] = v
    tok_h1 = np.zeros((batch, width), dtype=np.int32)
    tok_h2 = np.zeros((batch, width), dtype=np.int32)
    lengths = np.full(batch, _EMPTY, dtype=np.int32)
    rootv = np.full(batch, _EMPTY, dtype=np.int32)
    sys_mask = np.zeros(batch, dtype=bool)
    for i, (h1, h2, ln, sm) in enumerate(vals):
        tok_h1[i] = h1
        tok_h2[i] = h2
        lengths[i] = ln
        rootv[i] = roots[i] if ln >= 0 else _EMPTY
        sys_mask[i] = sm
    return TokenizedTopics(tok_h1=tok_h1, tok_h2=tok_h2,
                           lengths=lengths, roots=rootv,
                           sys_mask=sys_mask)


def tokenize(topics, roots: Sequence[int], *, max_levels: int, salt: int,
             batch: Optional[int] = None, native: bool = True,
             cache: Optional[TokenCache] = None) -> TokenizedTopics:
    """Hash topic levels into a padded probe batch on the host.

    ``topics`` are pre-parsed level lists (utils.topic.parse), raw topic
    strings, or one pre-packed :class:`~bifromq_tpu_torch.models.bytetok.
    TopicBytes` batch; ``roots`` the per-topic tenant root ids
    (CompiledTrie.root_of). Topics longer than ``max_levels`` are marked
    as padding and must take the host fallback. With ``cache``, repeated
    topics skip hashing.

    ``native=True`` (the serving default) runs the C++ tokenizer
    (``models/native_tok.py``); a helper that fails to build or load
    raises :class:`~bifromq_tpu_torch.utils.nativelib.NativeLibError`
    and is never served around. ``native=False`` runs the per-level
    Python loop below, the semantics reference.
    """
    from .bytetok import TopicBytes
    if isinstance(topics, TopicBytes):
        return _tokenize_topic_bytes(topics, roots, max_levels=max_levels,
                                     salt=salt, batch=batch, native=native,
                                     cache=cache)
    if cache is not None:
        n = len(topics)
        keys = [t if isinstance(t, (str, bytes)) else tuple(t)
                for t in topics]
        return _tokenize_cached(
            keys, roots, cache, batch=batch or n,
            width=max_levels + 1, salt=salt,
            miss_tokenize=lambda idx: tokenize(
                [topics[i] for i in idx], [0] * len(idx),
                max_levels=max_levels, salt=salt, native=native))
    if native:
        return _tokenize_native(topics, roots, max_levels=max_levels,
                                salt=salt, batch=batch)
    n = len(topics)
    b = batch or n
    assert b >= n
    width = max_levels + 1
    tok_h1 = np.zeros((b, width), dtype=np.int32)
    tok_h2 = np.zeros((b, width), dtype=np.int32)
    lengths = np.full(b, _EMPTY, dtype=np.int32)
    rootv = np.full(b, _EMPTY, dtype=np.int32)
    sys_mask = np.zeros(b, dtype=bool)
    for i, (levels, root) in enumerate(zip(topics, roots)):
        if isinstance(levels, bytes):   # raw wire bytes (byte plane)
            levels = levels.decode("utf-8")
        if isinstance(levels, str):
            levels = levels.split(topic_util.DELIMITER)
        if len(levels) > max_levels:
            continue  # leave as padding; caller falls back to oracle
        lengths[i] = len(levels)
        rootv[i] = root
        if levels and levels[0].startswith(topic_util.SYS_PREFIX):
            sys_mask[i] = True
        for j, level in enumerate(levels):
            h1, h2 = level_hash(level, salt)
            tok_h1[i, j] = h1
            tok_h2[i, j] = h2
    return TokenizedTopics(tok_h1=tok_h1, tok_h2=tok_h2, lengths=lengths,
                           roots=rootv, sys_mask=sys_mask)


def _tokenize_native(topics, roots: Sequence[int], *, max_levels: int,
                     salt: int, batch: Optional[int]) -> TokenizedTopics:
    from .native_tok import tokenize_topics_native
    h1, h2, lengths, rootv, sysm = tokenize_topics_native(
        topics, roots, max_levels=max_levels, salt=salt, batch=batch)
    return TokenizedTopics(tok_h1=h1, tok_h2=h2, lengths=lengths,
                           roots=rootv, sys_mask=sysm)


def _tokenize_topic_bytes(tb, roots: Sequence[int], *, max_levels: int,
                          salt: int, batch: Optional[int], native: bool,
                          cache: Optional[TokenCache]) -> TokenizedTopics:
    """The byte-plane leg of :func:`tokenize`. ``native=True`` feeds the
    raw (data, offsets) pair straight to the C++ tokenizer, with no
    re-encoding; ``native=False`` decodes the rows back into the Python
    semantics reference. With ``cache``, keys are the raw byte slices."""
    n = len(tb)
    b = batch or n
    assert b >= n
    if cache is not None:
        return _tokenize_cached(
            [tb.row_bytes(i) for i in range(n)], roots, cache, batch=b,
            width=max_levels + 1, salt=salt,
            miss_tokenize=lambda idx: _tokenize_topic_bytes(
                tb.select(idx), [0] * len(idx), max_levels=max_levels,
                salt=salt, batch=None, native=native, cache=None))
    if not native:
        return tokenize([tb.row_str(i) for i in range(n)], roots,
                        max_levels=max_levels, salt=salt, batch=b,
                        native=False)
    return _tokenize_native(tb, roots, max_levels=max_levels, salt=salt,
                            batch=b)


# ------------------------ filter-probe tokenization -------------------------
# (retained-message lookup: wildcard FILTERS probe a trie of concrete topics)

KIND_LIT = 0
KIND_PLUS = 1
KIND_HASH = 2


@dataclass
class TokenizedFilters:
    """Fixed-shape filter probe batch; padding rows have length == -1."""
    tok_h1: np.ndarray    # [B, max_levels + 1] int32
    tok_h2: np.ndarray    # [B, max_levels + 1] int32
    tok_kind: np.ndarray  # [B, max_levels + 1] int32 (KIND_*)
    lengths: np.ndarray   # [B] int32
    roots: np.ndarray     # [B] int32

    @property
    def batch(self) -> int:
        return self.tok_h1.shape[0]


class LevelEmbedsDelimiter(ValueError):
    """A filter level contains the topic delimiter, so the joined byte
    row would split into other levels than the filter has."""


def tokenize_filters(filters: Sequence[Sequence[str]], roots: Sequence[int],
                     *, max_levels: int, salt: int,
                     batch: Optional[int] = None,
                     vectorized: bool = True) -> TokenizedFilters:
    """Hash filter levels ('+'/'#' become kind codes) into a probe batch.

    The vectorized leg packs the joined filters into one
    :class:`~bifromq_tpu_torch.models.bytetok.TopicBytes` batch, scans
    the level boundaries and hashes every literal level in one numpy
    BLAKE2b pass. A batch with a level that embeds the delimiter cannot
    be scanned that way; it, and ``vectorized=False``, run the per-row
    Python loop, the semantics reference. Any other failure of the
    vectorized leg propagates."""
    n = len(filters)
    b = batch or n
    assert b >= n
    if vectorized and n:
        try:
            return _tokenize_filters_vec(filters, roots,
                                         max_levels=max_levels, salt=salt,
                                         batch=b)
        except LevelEmbedsDelimiter:
            pass
    return _tokenize_filters_py(filters, roots, max_levels=max_levels,
                                salt=salt, batch=b)


def _tokenize_filters_vec(filters, roots, *, max_levels: int, salt: int,
                          batch: int) -> TokenizedFilters:
    """Byte-plane filter tokenization, row-identical to the loop."""
    from . import bytetok
    n = len(filters)
    width = max_levels + 1
    tb = bytetok.TopicBytes.from_topics(
        [topic_util.DELIMITER.join(f) for f in filters])
    st = bytetok.topic_structure(tb)
    # a joined empty filter ([] -> "") scans as one empty level; the
    # loop records length 0 with no levels — align below
    n_ref = np.fromiter((len(f) for f in filters), dtype=np.int64, count=n)
    empty_rows = n_ref == 0
    if not np.array_equal(st.n_levels[~empty_rows], n_ref[~empty_rows]):
        raise LevelEmbedsDelimiter("level contains the topic delimiter")
    ok = (st.n_levels <= max_levels) & ~empty_rows
    lengths = np.full(batch, _EMPTY, dtype=np.int32)
    rootv = np.full(batch, _EMPTY, dtype=np.int32)
    roots_a = np.asarray(list(roots), dtype=np.int32)
    lengths[:n][ok] = st.n_levels[ok]
    rootv[:n][ok] = roots_a[ok]
    lengths[:n][empty_rows] = 0
    rootv[:n][empty_rows] = roots_a[empty_rows]
    tok_h1 = np.zeros((batch, width), dtype=np.int32)
    tok_h2 = np.zeros((batch, width), dtype=np.int32)
    tok_kind = np.zeros((batch, width), dtype=np.int32)
    sel = ok[st.lvl_row]
    if sel.any():
        kind_lvl = level_kinds(tb.data, st)
        lit = sel & (kind_lvl == KIND_LIT)
        if lit.any():
            h1, h2 = bytetok.hash_levels(tb.data, st.lvl_start[lit],
                                         st.lvl_len[lit], salt)
            tok_h1[st.lvl_row[lit], st.lvl_idx[lit]] = h1
            tok_h2[st.lvl_row[lit], st.lvl_idx[lit]] = h2
        tok_kind[st.lvl_row[sel], st.lvl_idx[sel]] = kind_lvl[sel]
    return TokenizedFilters(tok_h1=tok_h1, tok_h2=tok_h2, tok_kind=tok_kind,
                            lengths=lengths, roots=rootv)


def level_kinds(data: np.ndarray, st) -> np.ndarray:
    """KIND_* of every level of a scanned byte batch: the wildcard levels
    are exactly the single-byte '+' / '#' levels."""
    one = st.lvl_len == 1
    b0 = np.zeros(st.lvl_len.shape[0], dtype=np.uint8)
    oidx = np.nonzero(one)[0]
    b0[oidx] = data[st.lvl_start[oidx]]
    kind = np.zeros(st.lvl_len.shape[0], dtype=np.int32)
    kind[one & (b0 == ord(topic_util.SINGLE_WILDCARD))] = KIND_PLUS
    kind[one & (b0 == ord(topic_util.MULTI_WILDCARD))] = KIND_HASH
    return kind


def _tokenize_filters_py(filters, roots, *, max_levels: int, salt: int,
                         batch: int) -> TokenizedFilters:
    """The per-row loop (the semantics reference)."""
    width = max_levels + 1
    tok_h1 = np.zeros((batch, width), dtype=np.int32)
    tok_h2 = np.zeros((batch, width), dtype=np.int32)
    tok_kind = np.zeros((batch, width), dtype=np.int32)
    lengths = np.full(batch, _EMPTY, dtype=np.int32)
    rootv = np.full(batch, _EMPTY, dtype=np.int32)
    for i, (levels, root) in enumerate(zip(filters, roots)):
        if len(levels) > max_levels:
            continue  # padding; the caller serves the row on the host
        lengths[i] = len(levels)
        rootv[i] = root
        for j, level in enumerate(levels):
            if level == topic_util.SINGLE_WILDCARD:
                tok_kind[i, j] = KIND_PLUS
            elif level == topic_util.MULTI_WILDCARD:
                tok_kind[i, j] = KIND_HASH
            else:
                h1, h2 = level_hash(level, salt)
                tok_h1[i, j] = h1
                tok_h2[i, j] = h2
    return TokenizedFilters(tok_h1=tok_h1, tok_h2=tok_h2, tok_kind=tok_kind,
                            lengths=lengths, roots=rootv)
