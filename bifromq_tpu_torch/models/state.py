"""Carry compiled automaton state across from the JAX package.

``device_trie_from_numpy`` takes the five leaves of a ``bifromq_tpu``
``DeviceTrie`` as numpy arrays (``np.asarray(leaf)`` of each) and returns
the port's :class:`~bifromq_tpu_torch.ops.match.DeviceTrie` on
``device``, so the port can walk the very tables the reference compiled.
The layouts are the same column for column.

``sharded_tables_to_device`` uploads the stacked per-shard tables of a
``parallel.sharded.ShardedTables`` for the mesh walk.

``patchable_from_numpy`` takes a reference ``PatchableTrie``'s arenas and
state and returns the port's ``PatchableTrie`` and its ``DeviceTrie``,
so the port can serve and keep patching the very arenas the reference
built.

``retained_index_from_numpy`` takes a reference ``RetainedIndex``'s
topics and its ``RetainedPatchableTrie`` arenas (the extras plane
included) and returns the port's ``RetainedIndex`` serving and patching
the very same arenas.

``kv_engine_from_items`` rebuilds a reference KV engine's spaces (route
records and range metadata) as the port's ``InMemKVEngine``, so a port
``DistWorker`` opened on it takes the reset-from-KV path over the very
route table the reference wrote.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence, Tuple

import numpy as np
import torch

from ..ops.match import CT_COLS, RT_COLS, DeviceTrie
from ..utils.device import resolve_device

TRIE_LEAVES = ("node_tab", "edge_tab", "child_list", "count_tab", "route_tab")


def device_trie_from_numpy(arrays: Mapping[str, np.ndarray],
                           device=None) -> DeviceTrie:
    """``arrays``: ``{node_tab, edge_tab, child_list, count_tab,
    route_tab}`` as numpy arrays. ``device=None`` means the card."""
    dev = resolve_device(device)
    missing = [k for k in TRIE_LEAVES if k not in arrays]
    if missing:
        raise KeyError(f"missing DeviceTrie leaves: {missing}")
    out = {}
    for k in TRIE_LEAVES:
        a = np.ascontiguousarray(arrays[k])
        if a.dtype != np.int32:
            raise ValueError(f"{k}: expected int32, got {a.dtype}")
        out[k] = torch.from_numpy(a.copy()).to(dev)
    if out["edge_tab"].dim() != 3 or out["edge_tab"].shape[2] != 4:
        raise ValueError("edge_tab: expected [NB, P, 4]")
    if out["count_tab"].shape[1] != CT_COLS or \
            out["route_tab"].shape[1] != RT_COLS:
        raise ValueError("count_tab/route_tab: unexpected column count")
    return DeviceTrie(**out)


def sharded_tables_to_device(tables, device=None
                             ) -> Tuple[torch.Tensor, ...]:
    """``(edge_tab [S, NB, P, 4], child_list [S, E], route_tab [S, N,
    RT_COLS])`` of a ``ShardedTables`` on ``device`` (``None`` means the
    card). One copy serves every replica row of the mesh: the reference
    replicates the stacks over the replica axis only because each chip
    needs its own. ``node_tab`` is not uploaded: the walk reads
    ``route_tab`` in its place."""
    dev = resolve_device(device)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (tables.edge_tab, tables.child_list,
                           tables.route_tab))


PATCHABLE_ARENAS = ("node_tab", "edge_tab", "child_list", "slot_kind")


def patchable_from_numpy(*, matchings, tenant_root, n_live: int, salt: int,
                         probe_len: int, max_levels: int, dead_slots: int = 0,
                         garbage_slots: int = 0, device=None,
                         **arenas: np.ndarray):
    """Carry a reference ``PatchableTrie`` across: its arenas as numpy
    (``node_tab``, ``edge_tab``, ``child_list`` int32 and ``slot_kind``
    int8, capacity padding and patch-era rows included), its
    ``matchings`` rebuilt as port ``Route``/``GroupMatching`` objects in
    slot order, and its scalar state. Returns the port ``PatchableTrie``
    (through ``from_arenas``: no DFS, no recompile) and its
    :class:`~bifromq_tpu_torch.ops.match.DeviceTrie` on ``device``
    (``None`` means the card)."""
    from .automaton import PatchableTrie
    dev = resolve_device(device)
    if sorted(arenas) != sorted(PATCHABLE_ARENAS):
        raise KeyError(f"expected the arenas {PATCHABLE_ARENAS}, got "
                       f"{sorted(arenas)}")
    for k, dtype in zip(PATCHABLE_ARENAS,
                        (np.int32, np.int32, np.int32, np.int8)):
        if np.asarray(arenas[k]).dtype != dtype:
            raise ValueError(f"{k}: expected {np.dtype(dtype).name}, got "
                             f"{np.asarray(arenas[k]).dtype}")
    if len(arenas["slot_kind"]) != len(matchings):
        raise ValueError(f"slot_kind has {len(arenas['slot_kind'])} slots, "
                         f"matchings {len(matchings)}")
    pt = PatchableTrie.from_arenas(
        **{k: np.array(arenas[k]) for k in PATCHABLE_ARENAS},
        n_live=n_live, matchings=matchings, tenant_root=tenant_root,
        salt=salt, probe_len=probe_len, max_levels=max_levels,
        dead_slots=dead_slots, garbage_slots=garbage_slots)
    return pt, DeviceTrie.from_compiled(pt, device=dev)


RETAINED_ARENAS = ("node_tab", "edge_tab", "child_list", "ext_tab",
                   "extra_list", "slot_kind")
RETAINED_EXTRAS = ("extra_live", "extra_garbage", "child_live",
                   "child_garbage", "child_cap", "ext_cap", "own_slot")


def retained_index_from_numpy(*, topics: Mapping[str, Iterable[str]],
                              receivers: Sequence[str],
                              tenant_root: Mapping[str, int], salt: int,
                              n_live: int, probe_len: int, max_levels: int,
                              extras: Mapping[str, object],
                              dead_slots: int = 0, garbage_slots: int = 0,
                              k_states: int = 32, device=None,
                              **arenas: np.ndarray):
    """Carry a reference ``RetainedIndex`` across.

    ``topics``: each tenant's retained topic strings (the authority), in
    a pre-order walk of its trie, so that each node keeps its child
    order (the host matcher lists the rows it serves in that order);
    ``receivers``: the slot → topic array, in slot order; the arenas of
    ``RETAINED_ARENAS`` as numpy (int32, ``slot_kind`` int8), capacity
    padding, patch-era rows and tombstones included; ``extras``: the
    extras plane's scalars and run tables (``RETAINED_EXTRAS``). Returns
    the port's ``RetainedIndex`` on ``device`` (``None`` means the card),
    installed through ``from_arenas`` with no compile, so it serves the
    same scans and its next patches land on the same rows."""
    from ..retained_plane.patched import RetainedPatchableTrie
    from ..utils import topic as topic_util
    from .oracle import SubscriptionTrie
    from .retained import RetainedIndex, _topic_route
    if sorted(arenas) != sorted(RETAINED_ARENAS):
        raise KeyError(f"expected the arenas {RETAINED_ARENAS}, got "
                       f"{sorted(arenas)}")
    if sorted(extras) != sorted(RETAINED_EXTRAS):
        raise KeyError(f"expected the extras {RETAINED_EXTRAS}, got "
                       f"{sorted(extras)}")
    for k in RETAINED_ARENAS:
        want = np.int8 if k == "slot_kind" else np.int32
        if np.asarray(arenas[k]).dtype != want:
            raise ValueError(f"{k}: expected {np.dtype(want).name}, got "
                             f"{np.asarray(arenas[k]).dtype}")
    receivers = list(receivers)
    if len(arenas["slot_kind"]) != len(receivers):
        raise ValueError(f"slot_kind has {len(arenas['slot_kind'])} slots, "
                         f"receivers {len(receivers)}")
    rt = RetainedPatchableTrie.from_arenas(
        node_tab=np.array(arenas["node_tab"]), n_live=n_live,
        edge_tab=np.array(arenas["edge_tab"]),
        child_list=np.array(arenas["child_list"]),
        matchings=[_topic_route(topic_util.parse(t), t) for t in receivers],
        slot_kind=np.array(arenas["slot_kind"]), tenant_root=tenant_root,
        salt=salt, probe_len=probe_len, max_levels=max_levels,
        dead_slots=dead_slots, garbage_slots=garbage_slots)
    rt.install_retained_extras(ext_tab=np.array(arenas["ext_tab"]),
                               extra_list=np.array(arenas["extra_list"]),
                               **extras)
    idx = RetainedIndex(max_levels=max_levels, k_states=k_states,
                        probe_len=probe_len, device=device)
    for tenant, ts in topics.items():
        trie = idx.tries[tenant] = SubscriptionTrie()
        for t in ts:
            trie.add(_topic_route(topic_util.parse(t), t))
    idx._install(rt, receivers)
    return idx


def kv_engine_from_items(
        spaces: Mapping[str, Tuple[Iterable[Tuple[bytes, bytes]],
                                   Mapping[bytes, bytes]]]):
    """``spaces``: ``{name: (items, metadata)}`` — each space's ``(key,
    value)`` records and its metadata records, as bytes. Returns the
    port's :class:`~bifromq_tpu_torch.kv.engine.InMemKVEngine` holding
    the same spaces, record for record."""
    from ..kv.engine import InMemKVEngine
    engine = InMemKVEngine()
    for name, (items, metadata) in spaces.items():
        space = engine.create_space(name)
        w = space.writer()
        for k, v in items:
            w.put(bytes(k), bytes(v))
        w.done()
        for k, v in metadata.items():
            space.put_metadata(bytes(k), bytes(v))
    return engine
