"""Carry compiled automaton state across from the JAX package.

``device_trie_from_numpy`` takes the five leaves of a ``bifromq_tpu``
``DeviceTrie`` as numpy arrays (``np.asarray(leaf)`` of each) and returns
the port's :class:`~bifromq_tpu_torch.ops.match.DeviceTrie` on
``device``, so the port can walk the very tables the reference compiled.
The layouts are the same column for column.

``sharded_tables_to_device`` uploads the stacked per-shard tables of a
``parallel.sharded.ShardedTables`` for the mesh walk.
"""

from __future__ import annotations

from typing import Mapping, Tuple

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
