"""Port parity: the fused walk's plain version against the JAX package.

``bifromq_tpu_torch.ops.match.walk_routes`` (the plain PyTorch version of
``csrc/fused_walk.cu``, and what ``models.kernels.fused_walk_routes`` runs
on CPU tensors) must be array-equal to the reference's lax
``walk_routes(esc_k=0)``, its escalating variant, and the Pallas
``fused_walk_routes`` in interpret mode, on the same compiled tables and
tokens. Tolerance: exact equality — every output is int32 or bool.
Small K/A budgets make the state-overflow and interval-overflow rows
occur.
"""

import random

import numpy as np
import pytest
import torch

from bifromq_tpu.models.automaton import compile_tries, tokenize
from bifromq_tpu.models.kernels import fused_walk_routes as jax_fused
from bifromq_tpu.models.oracle import Route, SubscriptionTrie
from bifromq_tpu.ops import match as jm
from bifromq_tpu.types import RouteMatcher
from bifromq_tpu import workloads as jw
from bifromq_tpu_torch.models import automaton as ta
from bifromq_tpu_torch.models import kernels as tk
from bifromq_tpu_torch.ops import match as tm
from bifromq_tpu_torch import workloads as tw

FIELDS = ("start", "count", "n_routes", "overflow")


def _world(seed: int):
    """Hand-made '+'/'#'/'$SYS'/'$share' filters over a small alphabet,
    plus deep topics (past max_levels) and '$SYS' probes."""
    rng = random.Random(seed)
    names = [f"n{i}" for i in range(6)]
    trie = SubscriptionTrie()
    for i in range(150):
        levels = [rng.choice(names + ["+"]) for _ in range(rng.randint(1, 5))]
        if rng.random() < 0.25:
            levels.append("#")
        if rng.random() < 0.1:
            levels[0] = "$SYS"
        f = "/".join(levels)
        if rng.random() < 0.1:
            f = f"$share/g{i % 3}/{f}"
        trie.add(Route(matcher=RouteMatcher.from_topic_filter(f),
                       broker_id=i % 2, receiver_id=f"r{i}",
                       deliverer_key="d0"))
    topics = []
    for _ in range(48):
        t = [rng.choice(names) for _ in range(rng.randint(1, 6))]
        if rng.random() < 0.15:
            t[0] = "$SYS"
        topics.append(t)
    topics.append(["n0"] * 12)        # deeper than max_levels: padding
    topics.append(["#"])
    return {"T": trie}, topics


def _tables(tries, topics, max_levels=8, batch=64):
    ct = compile_tries(tries, max_levels=max_levels)
    tok = tokenize(topics, [ct.root_of("T")] * len(topics),
                   max_levels=ct.max_levels, salt=ct.salt, batch=batch)
    return ct, tok


def _port_probes(tok):
    return tm.Probes(*(torch.from_numpy(np.asarray(a)) for a in (
        tok.tok_h1, tok.tok_h2, tok.lengths, tok.roots, tok.sys_mask)),
        max_len=int(tok.lengths.max()))


def _port_trie(ct):
    return tm.DeviceTrie.from_compiled(ct, device="cpu")


def _assert_equal(ref, got, what):
    for f in FIELDS:
        a = np.asarray(getattr(ref, f))
        b = getattr(got, f).numpy()
        assert a.shape == b.shape and (a == b).all(), f"{what}: {f}"


@pytest.mark.parametrize("seed,k,a", [(0, 32, 32), (1, 4, 4), (3, 6, 5)])
def test_plain_walk_equals_lax_walk(seed, k, a):
    tries, topics = _world(seed)
    ct, tok = _tables(tries, topics)
    kw = dict(probe_len=ct.probe_len, k_states=k, max_intervals=a)
    ref = jm.walk_routes(jm.DeviceTrie.from_compiled(ct),
                         jm.Probes.from_tokenized(tok), esc_k=0, **kw)
    got = tk.fused_walk_routes(_port_trie(ct), _port_probes(tok), **kw)
    _assert_equal(ref, got, f"seed {seed} K {k} A {a}")
    if k == 4:
        assert np.asarray(ref.overflow).any()   # overflow rows exercised


# every state budget K and interval budget A that the reference's tests
# reach: primaries K in {2, 4, 6, 8, 16, 32} x A in {1, ..., 32}, and their
# escalations (min(4K, 128), max(min(4A, 256), A)), K = 24 and 256-wide A
# included — each K and each A at least once
BUDGETS = [(2, 1), (4, 2), (6, 4), (8, 8), (16, 16), (8, 4), (16, 8),
           (24, 16), (24, 32), (64, 128), (128, 256)]


@pytest.mark.parametrize("k,a", BUDGETS, ids=lambda v: str(v))
def test_plain_walk_equals_lax_walk_at_every_budget(k, a):
    tries, topics = _world(11)
    ct, tok = _tables(tries, topics)
    kw = dict(probe_len=ct.probe_len, k_states=k, max_intervals=a)
    ref = jm.walk_routes(jm.DeviceTrie.from_compiled(ct),
                         jm.Probes.from_tokenized(tok), esc_k=0, **kw)
    got = tk.fused_walk_routes(_port_trie(ct), _port_probes(tok), **kw)
    _assert_equal(ref, got, f"K {k} A {a}")


@pytest.mark.parametrize("k", [257, 300, 512])
def test_plain_walk_equals_lax_walk_past_256(k):
    """State budgets past the walk kernel's old K = 256 ceiling, on the
    seeded full-bucket tables with rows of up to 13 levels, which widen
    past 2^10 candidates and so reach the sorted compaction at every one
    of these K: the plain walk (what ``fused_walk_routes`` runs on CPU
    tensors, and no longer raises for) equals the reference's lax
    walk."""
    d = tw.dense_walk_tables(0, batch=32, depth=13)
    kw = dict(probe_len=16, k_states=k, max_intervals=64)
    route = torch.from_numpy(d["route_tab"])
    probes = tm.Probes(*(torch.from_numpy(d[f]) for f in (
        "tok_h1", "tok_h2", "lengths", "roots", "sys_mask")),
        int(d["lengths"].max()))
    got = tk.fused_walk_routes(
        tm.DeviceTrie(route, torch.from_numpy(d["edge_tab"]), None, None,
                      route), probes, **kw)
    ref = jm.walk_routes(
        jm.DeviceTrie(d["route_tab"], d["edge_tab"], np.zeros(1, np.int32),
                      None, d["route_tab"]),
        jm.Probes(d["tok_h1"], d["tok_h2"], d["lengths"], d["roots"],
                  d["sys_mask"]), esc_k=0, **kw)
    _assert_equal(ref, got, f"K {k}")
    assert got.overflow.any() and (d["lengths"] > 10).any()


@pytest.mark.parametrize("k", [257, 300, 512, 1024])
def test_torch_matcher_serves_every_state_budget(k):
    """``TorchMatcher(k_states=K)`` past 256 serves every row equal to
    the host oracle (on the CPU, through the plain walk)."""
    from bifromq_tpu_torch.models.matcher import TorchMatcher
    m = TorchMatcher.from_tries(tw.config_wildcard(2000, seed=3),
                                k_states=k, device="cpu", match_cache=False)
    queries = [("tenant0", "/".join(t)) for t in tw.probe_topics(64, seed=4)]
    got = m.match_batch(queries)
    want = m.match_from_tries(queries)
    for g, w in zip(got, want):
        assert sorted(map(repr, g.all_routes())) == \
            sorted(map(repr, w.all_routes()))


@pytest.mark.parametrize("seed,k,a", [(5, 4, 4)])
def test_plain_walk_equals_pallas_interpret(seed, k, a):
    tries, topics = _world(seed)
    ct, tok = _tables(tries, topics)
    kw = dict(probe_len=ct.probe_len, k_states=k, max_intervals=a)
    ref = jax_fused(jm.DeviceTrie.from_compiled(ct),
                    jm.Probes.from_tokenized(tok), interpret=True, **kw)
    got = tk.fused_walk_routes(_port_trie(ct), _port_probes(tok), **kw)
    _assert_equal(ref, got, f"pallas seed {seed}")


@pytest.mark.parametrize("k,a,esc_k,esc_rows", [(4, 8, 16, 2)])
def test_escalating_walk_equals_reference(k, a, esc_k, esc_rows):
    tries, topics = _world(7)
    ct, tok = _tables(tries, topics)
    kw = dict(probe_len=ct.probe_len, k_states=k, max_intervals=a,
              esc_k=esc_k, esc_rows=esc_rows)
    ref = jm.walk_routes(jm.DeviceTrie.from_compiled(ct),
                         jm.Probes.from_tokenized(tok), **kw)
    got = tm.walk_routes(_port_trie(ct), _port_probes(tok), **kw)
    _assert_equal(ref, got, "escalation")


def test_config_wildcard_walk_from_port_compile():
    """Both packages generate, compile and tokenize config 2 at 3K subs
    from one seed; the port walks its OWN tables."""
    ref_ct = compile_tries(jw.config_wildcard(3000, seed=11))
    port_ct = ta.compile_tries(tw.config_wildcard(3000, seed=11))
    topics = ["/".join(t) for t in tw.probe_topics(120, seed=3)]
    roots = [ref_ct.root_of("tenant0")] * len(topics)
    tok = tokenize(topics, roots, max_levels=16, salt=ref_ct.salt,
                   batch=128)
    port_tok = ta.tokenize(topics, roots, max_levels=16, salt=port_ct.salt,
                           batch=128)
    kw = dict(probe_len=16, k_states=8, max_intervals=8)
    ref = jm.walk_routes(jm.DeviceTrie.from_compiled(ref_ct),
                         jm.Probes.from_tokenized(tok), esc_k=0, **kw)
    got = tk.fused_walk_routes(_port_trie(port_ct),
                               tm.Probes.from_tokenized(port_tok, "cpu"),
                               **kw)
    _assert_equal(ref, got, "config_wildcard")


@pytest.mark.parametrize("vals", [
    (0, 0, 0), (0xFFFFFFFF, -1, -1), (2**31 - 1, -2**31, 2**31 - 1),
    (123456789, -987654321, 55555)])
def test_mix_u32_edges(vals):
    from bifromq_tpu.models.automaton import _mix_u32 as ref_mix
    node, h1, h2 = vals
    node32 = np.array([node], dtype=np.uint32).astype(np.int32)
    ref = ref_mix(node32, np.array([h1], np.int32), np.array([h2], np.int32))
    got = tm._mix_u32(torch.from_numpy(node32), torch.tensor([h1],
                      dtype=torch.int32), torch.tensor([h2],
                                                       dtype=torch.int32))
    assert int(got[0]) == int(ref[0])
    # the patch plane's scalar copy of the mixer
    from bifromq_tpu_torch.models.automaton import _mix_u32_int
    assert _mix_u32_int(int(node32[0]), h1, h2) == int(ref[0]) & 0xFFFFFFFF


def test_mix_u32_random_lanes():
    from bifromq_tpu.models.automaton import _mix_u32 as ref_mix
    rng = np.random.default_rng(0)
    a, b, c = (rng.integers(-2**31, 2**31, size=4096, dtype=np.int64)
               .astype(np.int32) for _ in range(3))
    got = tm._mix_u32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = ref_mix(a, b, c)
    assert (got == want.astype(np.int64)).all()
    from bifromq_tpu_torch.models.automaton import _mix_u32_int
    assert [_mix_u32_int(int(x), int(y), int(z))
            for x, y, z in zip(a, b, c)] == want.astype(np.int64).tolist()


def test_bitonic_matches_sort():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(-1, 50, size=(16, 12),
                                      dtype=np.int32))
    assert torch.equal(tm._bitonic_desc(x)[:, :12],
                       torch.sort(x, dim=1, descending=True).values)


# ---- the batched [G, B, W] walk and the mesh's one launch ------------------

def _dense_trie(ds):
    """Stacked ``[S, ...]`` port tables of ``dense_walk_tables`` dicts."""
    route = torch.from_numpy(np.stack([d["route_tab"] for d in ds]))
    return tm.DeviceTrie(route, torch.from_numpy(np.stack(
        [d["edge_tab"] for d in ds])), None, None, route)


def _dense_probes(ds):
    f = {k: torch.from_numpy(np.stack([d[k] for d in ds]))
         for k in ("tok_h1", "tok_h2", "lengths", "roots", "sys_mask")}
    return tm.Probes(f["tok_h1"], f["tok_h2"], f["lengths"], f["roots"],
                     f["sys_mask"], int(f["lengths"].max()))


def test_dense_walk_tables_fill_buckets_and_overflow():
    """The synthetic walk input the card's check uses: every bucket holds
    P = 16 entries, and at K = A = 32 rows reach the sorted compaction and
    both overflows; the port's plain walk equals the reference's lax walk
    on it."""
    d = tw.dense_walk_tables(0, batch=64)
    assert (d["edge_tab"][..., 0] >= 0).all()
    kw = dict(probe_len=16, k_states=32, max_intervals=32)
    probes = _dense_probes([d])
    one = tm.Probes(*(x[0] for x in (probes.tok_h1, probes.tok_h2,
                                     probes.lengths, probes.roots,
                                     probes.sys_mask)), probes.max_len)
    route = torch.from_numpy(d["route_tab"])
    got = tk.fused_walk_routes(
        tm.DeviceTrie(route, torch.from_numpy(d["edge_tab"]), None, None,
                      route), one, **kw)
    ref = jm.walk_routes(
        jm.DeviceTrie(d["route_tab"], d["edge_tab"], np.zeros(1, np.int32),
                      None, d["route_tab"]),
        jm.Probes(d["tok_h1"], d["tok_h2"], d["lengths"], d["roots"],
                  d["sys_mask"]), esc_k=0, **kw)
    _assert_equal(ref, got, "dense tables")
    assert got.overflow.any() and not got.overflow.all()
    assert (d["lengths"] > 5).sum() > 4       # rows past 2^5 = K states


@pytest.mark.parametrize("shape", [(1, 3), (2, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("k,a", [(32, 32), (8, 4)])
def test_batched_walk_equals_per_block_loop(shape, k, a):
    """``fused_walk_routes`` on ``[G, B, W]`` probes over stacked shard
    tables equals the walk called block by block on the table and grid
    views, block g on shard g % S, element for element."""
    r, s = shape
    tabs = [tw.dense_walk_tables(seed, batch=48) for seed in range(s)]
    trie = _dense_trie(tabs)
    # block g probes its own shard's tokens, rows rotated per replica
    grid = _dense_probes([{k: np.roll(v, 7 * g, axis=0)
                           for k, v in tabs[g % s].items()}
                          for g in range(r * s)])
    kw = dict(probe_len=16, k_states=k, max_intervals=a)
    got = tk.fused_walk_routes(trie, grid, **kw)
    for g in range(r * s):
        view = tm.DeviceTrie(trie.route_tab[g % s], trie.edge_tab[g % s],
                             None, None, trie.route_tab[g % s])
        want = tk.fused_walk_routes(view, tm.Probes(
            grid.tok_h1[g], grid.tok_h2[g], grid.lengths[g], grid.roots[g],
            grid.sys_mask[g], grid.max_len), **kw)
        for f in FIELDS:
            assert torch.equal(getattr(got, f)[g], getattr(want, f)), (g, f)
    assert got.overflow.any()


@pytest.mark.parametrize("shape", [(2, 4), (1, 3)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_walk_equals_reference_mesh_step(shape):
    """``parallel.sharded.mesh_walk`` (one walk call for every block)
    equals the reference's shard_map match step on the 8 CPU devices,
    on the same stacked tables and probe grids."""
    from bifromq_tpu.parallel import sharded as js
    from bifromq_tpu_torch.parallel import sharded as ts
    r, s = shape
    tries = tw.config_multi_tenant(n_tenants=12, total_subs=600, seed=0)
    mm = ts.TorchMeshMatcher(tries, mesh=ts.make_mesh(r, s, device="cpu"),
                             k_states=16, auto_compact=False)
    tenants = sorted(tries)
    topics = ["/".join(t) for t in tw.probe_topics(64, seed=1)]
    queries = [(tenants[i % len(tenants)], t) for i, t in enumerate(topics)]
    for tenant in tenants:
        for route in list(tries[tenant].routes())[:4]:
            queries.append((tenant, "/".join(
                "l0" if lv == "+" else lv
                for lv in route.matcher.filter_levels if lv != "#")))
    queries.append(("tenant0", "$SYS/l0"))
    prep = mm._prepare_probes(queries)
    kw = dict(probe_len=16, k_states=16, max_intervals=32)
    got = ts.mesh_walk(mm._device_trie, prep.probes, **kw)
    step = js.make_match_step(js.make_mesh(r, s), merge_total=False, **kw)
    tables = prep.ct
    p = prep.probes
    ref = step(tables.edge_tab, tables.child_list, tables.route_tab,
               *(x.numpy() for x in (p.tok_h1, p.tok_h2, p.lengths,
                                     p.roots, p.sys_mask)))
    for f, want in zip(FIELDS, ref):
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(want)), f
    assert int(got.n_routes.sum()) > 20
