"""Tenant-sharded, replica-parallel match plane on one card (port of the
serving leg of ``bifromq_tpu/parallel/sharded.py``).

Tenants hash onto ``n_shards`` automaton shards and probe batches split
across ``n_replicas`` replicas of every shard. The reference lays this
``[R, S]`` grid over a ``jax.sharding.Mesh`` of chips; on one card the
grid is a leading ``[R, S]`` block axis of every tensor:

- the stacked shard tables ``[S, ...]`` are uploaded once and shared by
  every replica row;
- the walk (``csrc/fused_walk.cu``) runs once for all R·S blocks, each
  on its shard's slice of the stacked tables;
- the expansion (``csrc/expand.cu``) runs once for all R·S blocks, each
  into its own pair buffer;
- the per-peer delivery counts of all blocks merge by a ring of
  right-rotate hops (``csrc/ring_hop.cu``), shard ring first, then
  replica ring, as the reference's ``_ring_allreduce`` does between
  chips.

Serving is ``TorchMeshMatcher.match_batch``: shard-route → host tokenize
per shard → one walk launch and one expansion call for the whole grid →
per-peer bucketing per block → ring merge → fetch → ``MatchedRoutes``.
The match-result cache front end of
:class:`~bifromq_tpu_torch.models.matcher.TorchMatcher` sits in front of
it, as it does in the reference. Mutations take TorchMatcher's overlay +
compaction path. Not ported yet: shard breakers, canaries and split
dispatch, the per-shard patch plane (``supports_patching`` is False),
pins, rebalance, migration and resize, hot-tenant replication, the
completion board.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Dict, List, Set, Tuple

import numpy as np
import torch

from ..models.automaton import CompiledTrie, compile_tries, tokenize
from ..models.matcher import TorchMatcher, _HostPairs, _host, \
    _parse_levels, _pow2_batch
from ..models.oracle import MatchedRoutes, SubscriptionTrie
from ..ops.match import RT_COLS, DeviceTrie, Probes, RouteIntervals, \
    _bucket_pairs, _unbucketed_offsets, expand_cap_lanes, expand_intervals, \
    route_cols_from_node_tab
from ..utils.device import resolve_device

REPLICA_AXIS = "replica"
SHARD_AXIS = "shard"
# the grid dimension of each mesh axis in every [R, S, ...] tensor
_AXIS_DIM = {REPLICA_AXIS: 0, SHARD_AXIS: 1}


def tenant_shard(tenant_id: str, n_shards: int) -> int:
    """Stable tenant → shard assignment (≈ range ownership by tenant prefix)."""
    d = hashlib.blake2b(tenant_id.encode("utf-8"), digest_size=4).digest()
    return int.from_bytes(d, "little") % n_shards


@dataclass
class ShardedTables:
    """Per-shard compiled automata padded and stacked for the mesh walk
    (the walk reads ``edge_tab`` and ``route_tab``; ``child_list`` rides
    along as in the reference)."""
    edge_tab: np.ndarray    # [S, NB, P, 4], one bucket count for all
    child_list: np.ndarray  # [S, E], -1-padded
    route_tab: np.ndarray   # [S, N, RT_COLS], 0-padded
    compiled: List[CompiledTrie]   # per-shard (salt, matchings, roots)
    n_shards: int
    probe_len: int
    max_levels: int

    def shard_of(self, tenant_id: str) -> int:
        return tenant_shard(tenant_id, self.n_shards)

    def root_of(self, tenant_id: str) -> int:
        return self.compiled[self.shard_of(tenant_id)].root_of(tenant_id)


def build_sharded(tries: Dict[str, SubscriptionTrie], n_shards: int, *,
                  max_levels: int = 16, probe_len: int = 16
                  ) -> ShardedTables:
    """Compile each tenant shard with a common edge-table capacity.

    All shards share one edge-table size (power of two) so the walk's
    bucket mask is identical; node/child arrays are padded to the max.
    """
    by_shard: List[Dict[str, SubscriptionTrie]] = [
        dict() for _ in range(n_shards)]
    for tenant_id, trie in tries.items():
        by_shard[tenant_shard(tenant_id, n_shards)][tenant_id] = trie

    compiled = [compile_tries(s, max_levels=max_levels, probe_len=probe_len)
                for s in by_shard]
    # common bucket count: the mixing mask must be identical across shards
    cap = max(ct.edge_tab.shape[0] for ct in compiled)
    # re-sync: rebuilding one shard at `cap` can itself overflow a bucket
    # and grow past it; iterate until all bucket counts agree.
    while True:
        compiled = [
            ct if ct.edge_tab.shape[0] == cap else compile_tries(
                by_shard[i], max_levels=max_levels, probe_len=probe_len,
                min_edge_cap=cap)
            for i, ct in enumerate(compiled)
        ]
        new_cap = max(ct.edge_tab.shape[0] for ct in compiled)
        if new_cap == cap:
            break
        cap = new_cap

    n_max = max(ct.node_tab.shape[0] for ct in compiled)
    e_max = max(ct.child_list.shape[0] for ct in compiled)
    edge_tab = np.full((n_shards, cap, probe_len, 4), -1, dtype=np.int32)
    child_list = np.full((n_shards, e_max), -1, dtype=np.int32)
    route_tab = np.zeros((n_shards, n_max, RT_COLS), dtype=np.int32)
    for s, ct in enumerate(compiled):
        edge_tab[s] = ct.edge_tab
        child_list[s, :ct.child_list.shape[0]] = ct.child_list
        route_tab[s, :ct.node_tab.shape[0]] = route_cols_from_node_tab(
            ct.node_tab)
    return ShardedTables(edge_tab=edge_tab, child_list=child_list,
                         route_tab=route_tab, compiled=compiled,
                         n_shards=n_shards, probe_len=probe_len,
                         max_levels=max_levels)


@dataclass(frozen=True)
class MeshShape:
    """The ``[R, S]`` grid on one device: ``shape[REPLICA_AXIS]`` and
    ``shape[SHARD_AXIS]`` as on a ``jax.sharding.Mesh``."""
    n_replicas: int
    n_shards: int
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {REPLICA_AXIS: self.n_replicas, SHARD_AXIS: self.n_shards}


def make_mesh(n_replicas: int, n_shards: int, device=None) -> MeshShape:
    """An ``n_replicas × n_shards`` grid on ``device`` (``None`` means the
    card, and raises without one)."""
    if n_replicas < 1 or n_shards < 1:
        raise ValueError(f"mesh {n_replicas}x{n_shards} has no slot")
    return MeshShape(n_replicas, n_shards, resolve_device(device))


def mesh_walk(dev_tables: Tuple[torch.Tensor, ...], probes: Probes, *,
              probe_len: int, k_states: int,
              max_intervals: int) -> RouteIntervals:
    """The mesh match step: one walk-kernel launch for every (replica,
    shard) block of the ``[R, S, B, ...]`` probe grids, block ``(r, s)``
    on shard s's slice of the stacked tables. Returns the ``[R, S, B, A]``
    interval grids and ``[R, S, B]`` totals and overflow flags. No
    escalation re-walk: the mesh serves overflow rows from the host
    oracle."""
    from ..models.kernels import fused_walk_routes
    edge, child, route = dev_tables
    r, s, b, w = probes.tok_h1.shape
    # route_tab stands in for the node_tab the walk never reads
    trie = DeviceTrie(route, edge, child, None, route)
    out = fused_walk_routes(
        trie, Probes(probes.tok_h1.reshape(r * s, b, w),
                     probes.tok_h2.reshape(r * s, b, w),
                     probes.lengths.reshape(r * s, b),
                     probes.roots.reshape(r * s, b),
                     probes.sys_mask.reshape(r * s, b), probes.max_len),
        probe_len=probe_len, k_states=k_states, max_intervals=max_intervals)
    return RouteIntervals(*(x.reshape(r, s, *x.shape[1:]) for x in (
        out.start, out.count, out.n_routes, out.overflow)))


def _ring_allreduce(x: torch.Tensor, axis_name: str,
                    size: int) -> torch.Tensor:
    """Right-rotate ring allreduce over one mesh axis of an ``[R, S, n]``
    grid: ``size - 1`` hops of the ring-hop kernel, each adding the
    predecessor's running block. After it every slot of the ring holds
    the ring's sum."""
    if size <= 1:
        return x
    from ..models.kernels import ring_hop
    axis = _AXIS_DIM[axis_name]
    acc = x
    buf = x
    for _ in range(size - 1):
        buf = ring_hop(buf, axis)
        acc = acc + buf
    return acc


class _MeshExpanded:
    """One mesh batch on the device: the walk's ``[R, S, B, A]`` interval
    grids (fetched only for buffer-truncated rows) and the per-block
    expansion — ``slots``/``rows`` ``[R, S, cap]``, ``row_offsets``
    ``[R, S, B+1]``, ``n_pairs`` ``[R, S]``, ``trunc`` ``[R, S, B]``,
    ``peer_slots``/``peer_rows`` ``[R, S, cap]``, ``peer_offsets``
    ``[R, S, n_peers+3]`` — plus ``peer_totals`` ``[R, S, n_peers+2]``,
    the ring-merged global per-peer counts as every slot holds them
    (the pad bucket last)."""

    __slots__ = ("start", "count", "overflow", "slots", "rows",
                 "row_offsets", "n_pairs", "trunc", "peer_slots",
                 "peer_rows", "peer_offsets", "peer_totals")

    def __init__(self, **kw) -> None:
        for k, v in kw.items():
            setattr(self, k, v)


def mesh_expand(ivl: RouteIntervals, slot_peer: torch.Tensor, *, cap: int,
                n_peers: int) -> _MeshExpanded:
    """The mesh's second device stage: one call of the expansion kernel
    for all R·S blocks (walk-overflow rows zeroed, ``cap`` pairs a
    block), the per-peer bucketing of each block against its shard's
    ``slot_peer`` row, then the per-peer counts merged over the shard
    ring and then the replica ring."""
    from ..models.kernels import kernel_expand
    r, s, b, a = ivl.start.shape

    def grid(x):    # [R·S, ...] -> [R, S, ...]
        return x.reshape(r, s, *x.shape[1:])
    serve_c = torch.where(ivl.overflow[..., None], 0, ivl.count)
    expanded = kernel_expand(ivl.start.reshape(r * s, b, a),
                             serve_c.reshape(r * s, b, a), cap=cap)
    slots, rows, row_offsets, n_pairs, trunc = (grid(x) for x in expanded)
    if n_peers == 0:
        # every pair sits in the pad bucket in (slot, row) order, so the
        # peer arrays alias slots/rows
        peer_slots, peer_rows = slots, rows
        peer_offsets = _unbucketed_offsets(n_pairs, cap)
    else:
        blocks = [_bucket_pairs(slots[rep, sh], rows[rep, sh], slot_peer[sh],
                                n_peers)
                  for rep in range(r) for sh in range(s)]
        peer_slots, peer_rows, peer_offsets = (grid(torch.stack(x))
                                               for x in zip(*blocks))
    counts = peer_offsets[..., 1:] - peer_offsets[..., :-1]
    totals = _ring_allreduce(counts, SHARD_AXIS, s)
    totals = _ring_allreduce(totals, REPLICA_AXIS, r)
    return _MeshExpanded(
        start=ivl.start, count=ivl.count, overflow=ivl.overflow,
        slots=slots, rows=rows, row_offsets=row_offsets, n_pairs=n_pairs,
        trunc=trunc, peer_slots=peer_slots, peer_rows=peer_rows,
        peer_offsets=peer_offsets, peer_totals=totals)


class _MeshPeerTable:
    """The pinned shared delivery-peer id space of one base snapshot:
    every shard buckets against its OWN arena's slot→peer row, but ids
    index this one ``peers`` list, so bucket b is the same broker in
    every block and per-peer totals are summable across the mesh."""

    __slots__ = ("peers", "tables")

    def __init__(self, peers, tables) -> None:
        self.peers = list(peers)
        self.tables = tables     # per-shard dist.deliverer.PeerTable

    @property
    def n_peers(self) -> int:
        return len(self.peers)


class _MeshPrepared:
    """Stage-0 output: shard-routed, tokenized and uploaded ``[R, S, b]``
    probe grids, with the base snapshot they were tokenized against."""

    __slots__ = ("queries", "ct", "batch", "b", "slots", "probes",
                 "lengths_np")

    def __init__(self, **kw) -> None:
        for k, v in kw.items():
            setattr(self, k, v)


class _MeshInFlight:
    """Captured dispatch state for one mesh batch: expansion runs against
    THIS snapshot (tables object and overlay dict objects)."""

    __slots__ = ("queries", "ct", "dev", "res", "tomb", "delta", "batch",
                 "b", "slots", "lengths_np", "peer_tab")

    def __init__(self, **kw) -> None:
        for k, v in kw.items():
            setattr(self, k, v)


class TorchMeshMatcher(TorchMatcher):
    """The tenant-sharded match plane on one card, with TorchMatcher's
    cache front end and mutation machinery (delta overlay + background
    compaction) and the same staged serving path (prepare → dispatch →
    fetch → expand)."""

    # the per-shard patch plane is not ported (ROADMAP A.11)
    supports_patching = False
    # the mesh keeps the sync leg: match_batch_async takes it, as the
    # reference's own sync route does; the per-shard readiness waits,
    # shard breakers and split dispatch of its async leg are ROADMAP A.11
    supports_async = False

    def __init__(self, tries: Dict[str, SubscriptionTrie] = None,
                 mesh: MeshShape = None, *, max_levels: int = 16,
                 probe_len: int = 16, k_states: int = 32,
                 auto_compact: bool = True, compact_threshold: int = 2048,
                 max_intervals: int = 32, match_cache: bool = True) -> None:
        if mesh is None:
            raise ValueError("TorchMeshMatcher requires a mesh (make_mesh)")
        super().__init__(max_levels=max_levels, k_states=k_states,
                         probe_len=probe_len, device=mesh.device,
                         auto_compact=auto_compact,
                         compact_threshold=compact_threshold,
                         max_intervals=max_intervals,
                         match_cache=match_cache)
        # no device breaker until the shard breakers come (ROADMAP A.11)
        self.device_breaker = None
        self.mesh = mesh
        self.n_replicas = mesh.shape[REPLICA_AXIS]
        self.n_shards = mesh.shape[SHARD_AXIS]
        if tries:
            # seed path: write straight into authoritative + shadow state
            # and compile one base
            for tenant_id, trie in tries.items():
                for route in trie.routes():
                    self.tries.setdefault(
                        tenant_id, SubscriptionTrie()).add(route)
                    self._shadow.setdefault(
                        tenant_id, SubscriptionTrie()).add(route)
            self._install_base(*self._compile_shadow())

    def _clone_kwargs(self) -> dict:
        """``clone_empty`` builds a fresh mesh matcher on the same mesh (so
        the same device) with the same knobs. The reference also carries
        its hot-tenant ``replicate=`` set over; hot-tenant replication is
        not ported yet (ROADMAP A.11)."""
        kw = super()._clone_kwargs()
        del kw["device"]
        return dict(kw, mesh=self.mesh)

    # ---------------- compile target: stacked shard tables -----------------

    def _compile_shadow(self):
        from ..models.state import sharded_tables_to_device
        t0 = time.perf_counter()
        self.compile_count += 1
        tables = build_sharded(self._shadow, self.n_shards,
                               max_levels=self.max_levels,
                               probe_len=self.probe_len)
        dev = sharded_tables_to_device(tables, self.device)
        self.compile_time_s += time.perf_counter() - t0
        return tables, dev

    # ---------------- staged serving path ----------------------------------

    def _route_slots(self, queries, tables: ShardedTables
                     ) -> List[List[int]]:
        """Route each query to its (replica, shard) slot: the home shard's
        least-loaded replica, the first on ties; queries keep their order
        inside a slot."""
        r, s = self.n_replicas, self.n_shards
        slots: List[List[int]] = [[] for _ in range(r * s)]
        for qi, (tenant_id, _) in enumerate(queries):
            sh = tables.shard_of(tenant_id)
            slot = min((j * s + sh for j in range(r)),
                       key=lambda j: len(slots[j]))
            slots[slot].append(qi)
        return slots

    def _prepare_probes(self, queries, batch=None) -> _MeshPrepared:
        """Stage 0: shard-route + host tokenize per shard (with that
        shard's salt) + probe-grid upload. Every slot pads to ``b``, the
        power of two over the busiest slot; ``batch`` is ignored."""
        self._apply_pending_swap()
        if self._base_ct is None:
            self.refresh()
        tables: ShardedTables = self._base_ct
        r, s = self.n_replicas, self.n_shards
        slots = self._route_slots(queries, tables)
        b = _pow2_batch(max([len(x) for x in slots] + [1]))
        width = tables.max_levels + 1
        tok_h1 = np.zeros((r, s, b, width), dtype=np.int32)
        tok_h2 = np.zeros((r, s, b, width), dtype=np.int32)
        lengths = np.full((r, s, b), -1, dtype=np.int32)
        roots = np.full((r, s, b), -1, dtype=np.int32)
        sys_mask = np.zeros((r, s, b), dtype=bool)
        salts = {ct.salt for ct in tables.compiled}
        cache = self._tok_cache if len(salts) == 1 else None
        for rep in range(r):
            for sh in range(s):
                idxs = slots[rep * s + sh]
                if not idxs:
                    continue
                ct = tables.compiled[sh]
                tk = tokenize([queries[qi][1] for qi in idxs],
                              [ct.root_of(queries[qi][0]) for qi in idxs],
                              max_levels=ct.max_levels, salt=ct.salt,
                              batch=b, cache=cache)
                tok_h1[rep, sh] = tk.tok_h1
                tok_h2[rep, sh] = tk.tok_h2
                lengths[rep, sh] = tk.lengths
                roots[rep, sh] = tk.roots
                sys_mask[rep, sh] = tk.sys_mask

        def put(a):
            return torch.from_numpy(a).to(self.device)
        probes = Probes(put(tok_h1), put(tok_h2), put(lengths), put(roots),
                        put(sys_mask), int(lengths.max()))
        return _MeshPrepared(queries=list(queries), ct=tables,
                             batch=r * s * b, b=b, slots=slots,
                             probes=probes, lengths_np=lengths)

    def _dispatch_prepared(self, prep: _MeshPrepared) -> _MeshInFlight:
        """Stage 1: enqueue one walk and one expansion for the grid and
        the ring merge; returns once all are enqueued."""
        if self._base_ct is not prep.ct:
            # a compaction swap landed between prep and dispatch: roots
            # and salts are per-snapshot, so re-prep against the new base
            prep = self._prepare_probes(prep.queries)
        ivl = mesh_walk(self._device_trie, prep.probes,
                        probe_len=prep.ct.probe_len, k_states=self.k_states,
                        max_intervals=self.max_intervals)
        peer_tab, slot_peer = self._mesh_peer_table(prep.ct)
        res = mesh_expand(ivl, slot_peer, cap=prep.b * expand_cap_lanes(),
                          n_peers=peer_tab.n_peers)
        return _MeshInFlight(
            queries=prep.queries, ct=prep.ct, dev=self._device_trie,
            res=res, tomb=self._tomb, delta=self._delta, batch=prep.batch,
            b=prep.b, slots=prep.slots, lengths_np=prep.lengths_np,
            peer_tab=peer_tab)

    def _mesh_peer_table(self, tables: ShardedTables):
        """The per-shard slot→delivery-peer tables of one base snapshot,
        stacked ``[S, n_cap]`` on the device, with the peer-id space
        PINNED to the sorted union of every shard's deliverer servers so
        bucket ids line up across blocks. Cached on snapshot identity."""
        cached = self._peer_cache
        if cached is not None and cached[0] is tables:
            return cached[1], cached[2]
        from ..dist.deliverer import build_peer_table, server_of
        arenas = [ct.matchings_arr for ct in tables.compiled]
        keys: Set[str] = set()
        for arr in arenas:
            for m in arr:
                dkey = getattr(m, "deliverer_key", None)
                if isinstance(dkey, str):
                    sid = server_of(dkey)
                    if sid:
                        keys.add(sid)
        peers = sorted(keys)
        tabs = [build_peer_table(arr, peers=peers) for arr in arenas]
        n_cap = max([t.slot_peer.shape[0] for t in tabs] + [1])
        # pad rows read UNKNOWN (= n_peers)
        stacked = np.full((self.n_shards, n_cap), len(peers), np.int32)
        for sh, t in enumerate(tabs):
            stacked[sh, :t.slot_peer.shape[0]] = t.slot_peer
        tab = _MeshPeerTable(peers, tabs)
        dev = torch.from_numpy(stacked).to(self.device)
        self._peer_cache = (tables, tab, dev)
        return tab, dev

    @staticmethod
    def _fetch_walk(res: _MeshExpanded):
        """Stage 2: the synchronization — host copies of the compact
        per-block pair buffers and peer buckets (the interval grids stay
        on the device; truncated rows fetch them lazily)."""
        overflow = _host(res.overflow)
        slots, rows = _host(res.slots), _host(res.rows)
        aliased = res.peer_slots is res.slots      # the n_peers == 0 case
        pairs = _HostPairs(
            slots=slots, rows=rows,
            row_offsets=_host(res.row_offsets), n_pairs=_host(res.n_pairs),
            trunc=_host(res.trunc),
            peer_slots=slots if aliased else _host(res.peer_slots),
            peer_rows=rows if aliased else _host(res.peer_rows),
            peer_offsets=_host(res.peer_offsets), res=res)
        return overflow, pairs

    def _expand_walk(self, fl: _MeshInFlight, overflow, pairs: _HostPairs,
                     max_persistent_fanout: int,
                     max_group_fanout: int) -> List[MatchedRoutes]:
        """Stage 3: per-row slot lists from the per-block pair buffers
        (truncated rows re-expand from the interval grids) + overlay
        correction against the _MeshInFlight SNAPSHOT, and the exact host
        oracle for unknown-tenant / overflowed / too-deep rows."""
        tables: ShardedTables = fl.ct
        r, s, _ = overflow.shape
        g_s = g_c = None
        out: List[MatchedRoutes] = [None] * len(fl.queries)
        oracle_qis: List[int] = []
        for rep in range(r):
            for sh in range(s):
                ct = tables.compiled[sh]
                for bi, qi in enumerate(fl.slots[rep * s + sh]):
                    tenant_id, levels = fl.queries[qi]
                    if ct.root_of(tenant_id) < 0 \
                            or overflow[rep, sh, bi] \
                            or fl.lengths_np[rep, sh, bi] < 0:
                        oracle_qis.append(qi)
                        continue
                    if pairs.trunc[rep, sh, bi]:
                        if g_s is None:
                            g_s, g_c = self._fetch_escalation_grids(
                                pairs.res)
                        row, _ = expand_intervals(
                            g_s[rep, sh, bi:bi + 1],
                            g_c[rep, sh, bi:bi + 1])
                    else:
                        offs = pairs.row_offsets[rep, sh]
                        row = pairs.slots[rep, sh][offs[bi]:offs[bi + 1]]
                    tomb = fl.tomb.get(tenant_id)
                    delta = fl.delta.get(tenant_id)
                    if not tomb and delta is None:
                        out[qi] = self._routes_from_slots(
                            ct, row, max_persistent_fanout,
                            max_group_fanout)
                    else:
                        out[qi] = self._expand_with_overlay(
                            ct, row, tomb or (), delta,
                            _parse_levels(levels),
                            max_persistent_fanout, max_group_fanout)
        self.last_expanded = (pairs, fl.peer_tab)
        if oracle_qis:
            qlist = sorted(oracle_qis)
            rows = self.match_from_tries(
                [fl.queries[qi] for qi in qlist],
                max_persistent_fanout=max_persistent_fanout,
                max_group_fanout=max_group_fanout)
            for qi, m in zip(qlist, rows):
                out[qi] = m
        return out
