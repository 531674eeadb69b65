"""Port parity: fan-out expansion and per-peer bucketing.

``bifromq_tpu_torch.ops.match._expand_pairs`` (the plain version of
``csrc/expand.cu``, and what ``models.kernels.kernel_expand`` runs on CPU
tensors) must be array-equal to the reference's lax ``expand_pairs`` and
its Pallas ``pallas_expand`` in interpret mode, on random grids and on
the grids that stress the kernel's design (long runs of empty lanes, a
lane longer than a merge tile, totals below, at and far above the buffer,
a buffer that is no multiple of the tile, negative counts); the batched
``[G, B, A]`` entry must equal per-block reference calls block by block;
``_bucket_pairs`` must equal ``bucket_pairs_host`` on both bucketing
paths (counting scan up to 16 buckets, stable argsort above). The CUDA
kernels themselves are checked on the card by ``chip_smoke.py``.
Tolerance: exact equality — every output is int32 or bool.
"""

import numpy as np
import pytest
import torch

from bifromq_tpu.models.kernels import pallas_expand
from bifromq_tpu.ops.match import bucket_pairs_host, expand_pairs
from bifromq_tpu_torch.models import kernels as tk
from bifromq_tpu_torch.ops import match as tm


def _grid(seed, b, a, p_empty=0.3, max_count=6):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, 500, size=(b, a)).astype(np.int32)
    counts = rng.integers(1, max_count + 1, size=(b, a)).astype(np.int32)
    counts[rng.random((b, a)) < p_empty] = 0
    return starts, counts


def _port(starts, counts, cap):
    return [x.numpy() for x in tk.kernel_expand(
        torch.from_numpy(starts), torch.from_numpy(counts), cap=cap)]


@pytest.mark.parametrize("shape,cap", [((1, 1), 4), ((4, 8), 64),
                                       ((16, 32), 300), ((64, 4), 5),
                                       ((8, 8), 1000)])
def test_expand_equals_lax(shape, cap):
    starts, counts = _grid(sum(shape) + cap, *shape)
    ref = [np.asarray(x) for x in expand_pairs(starts, counts, cap=cap)]
    got = _port(starts, counts, cap)
    for r, g in zip(ref, got):
        assert r.shape == g.shape and (r == g).all()


@pytest.mark.parametrize("shape,cap", [((4, 8), 40), ((8, 4), 200)])
def test_expand_equals_pallas_interpret(shape, cap):
    starts, counts = _grid(cap, *shape)
    ref = [np.asarray(x) for x in pallas_expand(starts, counts, cap=cap,
                                                interpret=True)]
    got = _port(starts, counts, cap)
    for r, g in zip(ref, got):
        assert r.shape == g.shape and (r == g).all()


def test_expand_empty_and_truncated():
    starts = np.zeros((4, 4), np.int32)
    counts = np.zeros((4, 4), np.int32)
    got = _port(starts, counts, 16)
    assert int(got[3]) == 0 and (got[0] == -1).all() and (got[1] == -1).all()
    counts[0, 0] = 40            # row 0 alone overflows the buffer
    ref = [np.asarray(x) for x in expand_pairs(starts, counts, cap=16)]
    got = _port(starts, counts, 16)
    assert got[4].all()     # row offsets are cumulative: all rows cut
    for r, g in zip(ref, got):
        assert (r == g).all()


def _adversarial(kind, a):
    """Seeded grids of 24 rows at width ``a`` for one stress case of the
    expansion kernel: (starts, counts, cap)."""
    rng = np.random.default_rng(a)
    b, tile = 24, tk.EXPAND_MERGE_TILE
    starts = rng.integers(0, 1 << 20, size=(b, a)).astype(np.int32)
    counts = rng.integers(1, 9, size=(b, a)).astype(np.int32)
    counts[rng.random((b, a)) < 0.4] = 0
    total = int(counts.sum())
    if kind == "empty_runs":
        counts[rng.random((b, a)) < 0.9] = 0
        counts[3:17] = 0
        return starts, counts, int(counts.sum()) + 7
    if kind == "long_lane":
        counts[rng.random((b, a)) < 0.8] = 0
        counts[2, 1] = tile + 5
        return starts, counts, int(counts.sum())
    if kind == "negative_counts":
        counts = rng.integers(-6, 7, size=(b, a)).astype(np.int32)
        return starts, counts, int(np.maximum(counts, 0).sum()) // 2
    cap = {"total_lt_cap": total + 1, "total_eq_cap": total,
           "total_gg_cap": total // 16,
           "cap_not_tile_multiple": min(total, tile) - 3}[kind]
    return starts, counts, cap


ADVERSARIAL = ("empty_runs", "long_lane", "total_lt_cap", "total_eq_cap",
               "total_gg_cap", "cap_not_tile_multiple", "negative_counts")


@pytest.mark.parametrize("a", [32, 128])
@pytest.mark.parametrize("kind", ADVERSARIAL)
def test_expand_adversarial_equals_reference(kind, a):
    starts, counts, cap = _adversarial(kind, a)
    got = _port(starts, counts, cap)
    for ref in (expand_pairs(starts, counts, cap=cap),
                pallas_expand(starts, counts, cap=cap, interpret=True)):
        for r, g in zip(ref, got):
            r = np.asarray(r)
            assert r.shape == g.shape and (r == g).all()


@pytest.mark.parametrize("a", [4, 32])
def test_expand_batched_equals_per_block_reference(a):
    """G = 8 blocks of different totals under one cap (block 0 empty,
    block 4 far past the buffer, block 5 with negative counts) in one
    [G, B, A] call, held block by block against the reference."""
    rng = np.random.default_rng(100 + a)
    g, b, cap = 8, 12, 40
    starts = rng.integers(0, 1000, size=(g, b, a)).astype(np.int32)
    counts = rng.integers(0, 3, size=(g, b, a)).astype(np.int32)
    counts[0] = 0
    counts[1, 1:] = 0
    counts[4] *= 9
    counts[5] = rng.integers(-4, 4, size=(b, a))
    got = _port(starts, counts, cap)
    for blk in range(g):
        ref = expand_pairs(starts[blk], counts[blk], cap=cap)
        for r, x in zip(ref, got):
            r = np.asarray(r)
            assert r.shape == x[blk].shape and (r == x[blk]).all()
    totals = np.maximum(counts, 0).sum(axis=(1, 2))
    assert totals[0] == 0 and totals[4] > cap > totals[1]


def test_kernel_expand_rejects_other_ranks():
    with pytest.raises(ValueError):
        tk.kernel_expand(torch.zeros(4, dtype=torch.int32),
                         torch.zeros(4, dtype=torch.int32), cap=4)
    with pytest.raises(ValueError):
        tk.kernel_expand(torch.zeros((2, 4), dtype=torch.int32),
                         torch.zeros((1, 2, 4), dtype=torch.int32), cap=4)


@pytest.mark.parametrize("n_peers", [0, 3, 14, 15, 40])
def test_bucket_pairs_equals_host(n_peers):
    rng = np.random.default_rng(n_peers)
    cap, n_slot = 257, 300
    slots = rng.integers(0, n_slot + 20, size=cap).astype(np.int32)
    slots[rng.random(cap) < 0.2] = -1           # pad lanes
    rows = rng.integers(0, 16, size=cap).astype(np.int32)
    slot_peer = rng.integers(0, n_peers + 1, size=n_slot).astype(np.int32)
    ref = bucket_pairs_host(slots, rows, slot_peer, n_peers)
    got = tm._bucket_pairs(torch.from_numpy(slots), torch.from_numpy(rows),
                           torch.from_numpy(slot_peer), n_peers)
    for r, g in zip(ref, got):
        assert (r == g.numpy()).all()


def test_bucket_pairs_empty_arena():
    slots = np.array([3, -1, 0, -1], np.int32)
    rows = np.array([0, 0, 1, 1], np.int32)
    empty = np.zeros(0, np.int32)
    ref = bucket_pairs_host(slots, rows, empty, 2)
    got = tm._bucket_pairs(torch.from_numpy(slots), torch.from_numpy(rows),
                           torch.from_numpy(empty), 2)
    for r, g in zip(ref, got):
        assert (r == g.numpy()).all()


def test_expand_routes_no_peers_aliases_and_serves():
    """n_peers == 0: the peer views ARE the pair buffers (no copy), and
    overflow rows spend no buffer."""
    starts, counts = _grid(9, 8, 4)
    ivl = tm.RouteIntervals(
        start=torch.from_numpy(starts), count=torch.from_numpy(counts),
        n_routes=torch.from_numpy(counts.sum(1).astype(np.int32)),
        overflow=torch.tensor([False, True] * 4))
    out = tm.expand_routes(ivl, torch.zeros(0, dtype=torch.int32), cap=64,
                           n_peers=0)
    assert out.peer_slots is out.slots and out.peer_rows is out.rows
    served = np.where(np.array([False, True] * 4)[:, None], 0, counts)
    ref = [np.asarray(x) for x in expand_pairs(starts, served, cap=64)]
    for r, g in zip(ref, (out.slots, out.rows, out.row_offsets,
                          out.n_pairs, out.trunc)):
        assert (r == g.numpy()).all()
    assert out.peer_offsets.tolist() == [0, int(out.n_pairs), 64]


def test_expand_intervals_matches_reference():
    from bifromq_tpu.ops.match import expand_intervals as ref_expand
    starts, counts = _grid(3, 12, 6)
    rs, ro = ref_expand(starts, counts)
    gs, go = tm.expand_intervals(starts, counts)
    assert rs.dtype == gs.dtype and (rs == gs).all() and (ro == go).all()


@pytest.mark.parametrize("pinned", [None, ["srv1", "srv0"]])
def test_peer_table_and_bucket_views_equal_reference(pinned):
    from types import SimpleNamespace
    from bifromq_tpu.dist import deliverer as jd
    from bifromq_tpu_torch.dist import deliverer as td
    keys = ["srv2|a", "srv0|b", None, "nosep", "srv1|c", "srv0|d", "|e"]
    arena = [SimpleNamespace(deliverer_key=k) for k in keys]
    ref, got = jd.build_peer_table(arena, pinned), \
        td.build_peer_table(arena, pinned)
    assert ref.peers == got.peers and ref.index == got.index
    assert np.array_equal(ref.slot_peer, got.slot_peer)
    slots = np.array([0, 1, 2, 3, 4, 5, 6, 1, -1, -1], np.int32)
    rows = np.arange(10, dtype=np.int32) // 3
    ps, pr, po = (x.numpy() for x in tm._bucket_pairs(
        torch.from_numpy(slots), torch.from_numpy(rows),
        torch.from_numpy(got.slot_peer), got.n_peers))
    want = jd.bucket_views(ps, pr, po, ref.peers)
    have = td.bucket_views(ps, pr, po, got.peers)
    assert [(s, a.tolist(), b.tolist()) for s, a, b in want] == \
        [(s, a.tolist(), b.tolist()) for s, a, b in have]
    assert have[-1][0] == "" and len(have) > 2
