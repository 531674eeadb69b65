"""Port parity: the retained-message index against the reference.

The port's filter tokenizers, its extras-aware retained walk, its
``RetainedIndex`` (in-place patching, native escalation) and its native
walker take the same seeded inputs as the JAX package's, on the CPU
(``device="cpu"``: the plain PyTorch versions; the reference's jitted
walk, and its device filter tokenizer through the ``lax`` hash).
Tolerance: exact equality throughout, and every list of matched topics
equal in order. The reference side compiles one walk per batch and
table shape, so each test scans few shapes.
"""

import random

import jax
import numpy as np
import pytest

from bifromq_tpu.models import automaton as ja
from bifromq_tpu.models import retained as jret
from bifromq_tpu.models.native_retained import (
    match_rows_native as j_native)
from bifromq_tpu.ops import retained as jops
from bifromq_tpu.ops import tokenize as jtok
from bifromq_tpu.utils import topic as jtopic
from bifromq_tpu_torch.models import automaton as ta
from bifromq_tpu_torch.models import retained as tret
from bifromq_tpu_torch.models import state
from bifromq_tpu_torch.models.native_retained import (
    match_rows_native as t_native)
from bifromq_tpu_torch.ops import retained as tops
from bifromq_tpu_torch.ops import tokenize as ttok
from bifromq_tpu_torch.utils import nativelib
from bifromq_tpu_torch.utils import topic as t

ALPHABET = ["a", "b", "c", "", "x1", "$s", "dev", "ação"]
ARENAS = ("node_tab", "edge_tab", "child_list", "ext_tab", "extra_list")


def brute_force(topics, filter_levels):
    return sorted(tp for tp in topics
                  if jtopic.matches(t.parse(tp), list(filter_levels)))


def rand_topic(rng, depth=(1, 5)):
    return "/".join(rng.choice(ALPHABET)
                    for _ in range(rng.randint(*depth)))


def rand_filters(rng, k):
    out = []
    for _ in range(k):
        n = rng.randint(1, 5)
        lv = []
        for i in range(n):
            roll = rng.random()
            if roll < 0.28:
                lv.append("+")
            elif roll < 0.38 and i == n - 1:
                lv.append("#")
            else:
                lv.append(rng.choice(ALPHABET))
        out.append(lv)
    return out + [["#"], ["+"], ["$s", "#"], ["$s", "+"], ["+", "+"],
                  ["+", "#"]]


def both(topics, tenant="T", **kw):
    """The reference's and the port's index over the same topics."""
    j, p = jret.RetainedIndex(**kw), tret.RetainedIndex(device="cpu", **kw)
    for tp in topics:
        add(j, p, tenant, tp)
    j.refresh()
    p.refresh()
    return j, p


def add(j, p, tenant, tp):
    a = j.add_topic(tenant, t.parse(tp), tp)
    assert p.add_topic(tenant, t.parse(tp), tp) == a
    return a


def remove(j, p, tenant, tp):
    a = j.remove_topic(tenant, t.parse(tp), tp)
    assert p.remove_topic(tenant, t.parse(tp), tp) == a
    return a


def scan(j, p, queries, limit=None):
    """Both indexes' lists for ``queries``; asserts them equal, in order."""
    got = p.match_batch(queries, limit=limit)
    want = j.match_batch(queries, limit=limit)
    assert got == want
    return got


def assert_arenas_equal(j, p):
    jc, pc = j._compiled, p._compiled
    for k in ARENAS:
        a, b = getattr(pc, k), getattr(jc, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k
    assert np.array_equal(pc.slot_kind, jc.slot_kind)
    assert (pc.n_live, pc.dead_slots, pc.extra_live, pc.child_live) == \
        (jc.n_live, jc.dead_slots, jc.extra_live, jc.child_live)
    assert (p.rebuilds, p.compactions, p.patch_fallbacks) == \
        (j.rebuilds, j.compactions, j.patch_fallbacks)


def assert_device_equals_host(p):
    p.flush_device()
    host = tops.RetainedDeviceTables.host_arrays(p._compiled)
    for k, a in zip(tops.RETAINED_TABLES, host):
        d = getattr(p._device_tables, k)
        assert tuple(d.shape) == a.shape and np.array_equal(d.numpy(), a), k


# ------------------------------------------------------- (a) tokenizers

def _filter_corpus():
    rng = random.Random(2)
    filters = []
    for _ in range(110):
        depth = rng.randint(1, 6)
        lv = []
        for d in range(depth):
            r = rng.random()
            if r < 0.2:
                lv.append("+")
            elif r < 0.28 and d == depth - 1:
                lv.append("#")
            elif r < 0.34:
                lv.append(rng.choice(["ação", "日本語", "größe", ""]))
            else:
                lv.append(f"l{rng.randint(0, 9)}")
        if rng.random() < 0.1:
            lv[0] = rng.choice(["$SYS", "$s"])
        filters.append(lv)
    # too deep, over tok_max_bytes(), a level over 128 bytes, empty, and
    # '+' / '#' glued to a literal (literals, not wildcards)
    return filters + [["x"] * 20, ["b" * 100, "c" * 100, "d" * 100],
                      ["a" * 200], [], ["+"], ["#"], ["$SYS", "#"],
                      ["a+", "#b"], ["+", "+", "#"]]


@pytest.mark.parametrize("vectorized", [True, False])
def test_tokenize_filters_equals_reference(vectorized):
    filters = _filter_corpus()
    roots = list(range(len(filters)))
    kw = dict(max_levels=8, salt=987654321, batch=256)
    got = ta.tokenize_filters(filters, roots, vectorized=vectorized, **kw)
    want = ja.tokenize_filters(filters, roots, vectorized=vectorized, **kw)
    for k in ("tok_h1", "tok_h2", "tok_kind", "lengths", "roots"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    # an embedded delimiter refuses the vectorized leg; the batch then
    # takes the loop, as the reference's does
    bad = filters + [["em/bed"]]
    with pytest.raises(ta.LevelEmbedsDelimiter):
        ta._tokenize_filters_vec(bad, roots + [0], max_levels=8, salt=1,
                                 batch=256)
    got = ta.tokenize_filters(bad, roots + [0], max_levels=8, salt=1,
                              batch=256, vectorized=vectorized)
    want = ja._tokenize_filters_py(bad, roots + [0], max_levels=8, salt=1,
                                   batch=256)
    assert np.array_equal(got.tok_h1, want.tok_h1)
    assert np.array_equal(got.lengths, want.lengths)


def test_device_tokenize_filters_equals_reference():
    filters = _filter_corpus() + [["em/bed"]]
    roots = list(range(len(filters)))
    kw = dict(max_levels=8, salt=987654321, batch=128)
    mir, pr = ttok.device_tokenize_filters(filters, roots, device="cpu",
                                           **kw)
    # compiled, the lax hash's unrolled rounds take minutes on the CPU
    with jax.disable_jit():
        jmir, jpr = jtok.device_tokenize_filters(filters, roots,
                                                 impl="lax", **kw)
    for k in ("lengths", "roots", "kinds"):
        assert np.array_equal(getattr(mir, k), np.asarray(getattr(jmir, k)))
    for k in ("tok_h1", "tok_h2", "tok_kind", "lengths", "roots"):
        assert np.array_equal(getattr(pr, k).numpy(),
                              np.asarray(getattr(jpr, k))), k
    assert pr.max_len == int(mir.lengths.max())
    # supported rows equal the host tokenizer; wildcard lanes carry zero
    ref = ja.tokenize_filters(filters[:-1], roots[:-1], **kw)
    sup = mir.lengths != -1
    assert sup.sum() > 100
    for k in ("tok_h1", "tok_h2", "tok_kind"):
        assert np.array_equal(getattr(pr, k).numpy()[sup],
                              getattr(ref, k)[sup]), k
    kd = pr.tok_kind.numpy()
    assert not pr.tok_h1.numpy()[kd != 0].any()
    n = len(filters)
    # too deep, over the byte budget, a level over one block, empty,
    # an embedded delimiter: padding, except the empty filter
    assert list(mir.lengths[n - 10:n - 6]) == [-1, -1, -1, 0]
    assert mir.lengths[n - 1] == -1
    assert (mir.lengths[n:] == -1).all()


# ------------------------------------------------------- (b) the walk

def _walk_both(jc, filters, root, k):
    tok = ja.tokenize_filters(filters, [root] * len(filters),
                              max_levels=jc.max_levels, salt=jc.salt,
                              batch=128)
    jres = jops.retained_walk_ext(
        jops.RetainedDeviceTables.from_trie(jc),
        jops.FilterProbes.from_tokenized(tok), probe_len=jc.probe_len,
        k_states=k)
    tres = tops.retained_walk_ext(
        tops.RetainedDeviceTables.from_trie(jc, "cpu"),
        tops.FilterProbes.from_tokenized(tok, "cpu"),
        probe_len=jc.probe_len, k_states=k)
    for leaf in ("start", "count", "overflow"):
        assert np.array_equal(getattr(tres, leaf).numpy(),
                              np.asarray(getattr(jres, leaf))), leaf
    return tres


@pytest.mark.parametrize("patched", [False, True])
def test_walk_equals_reference(patched):
    k = 8
    rng = random.Random(7)
    topics = sorted({rand_topic(rng) for _ in range(300)}
                    | {f"w{i}/x" for i in range(40)})
    j = jret.RetainedIndex(k_states=k)
    for tp in topics:
        j.add_topic("T", t.parse(tp), tp)
    j.refresh()
    if patched:
        # extras, tombstones, new '$' children and a fresh tenant root
        for i in range(60):
            tp = rand_topic(rng) + f"/p{i}"
            j.add_topic("T", t.parse(tp), tp)
        for tp in topics[::5]:
            j.remove_topic("T", t.parse(tp), tp)
        for tp in ("$SYS/new", "$s/q", "a/$d"):
            j.add_topic("T", t.parse(tp), tp)
        assert j._compiled.extra_live and j._compiled.dead_slots
    jc = j.refresh()
    res = _walk_both(jc, rand_filters(rng, 100) + [["+", "x"]],
                     jc.root_of("T"), k)
    # the '+' fan-out ran past K on some row, and was flagged
    assert res.overflow.any()


# ----------------------------------------------- (c) match_batch, TestRetainedIndex

SMALL = ["a/b", "a/c", "a/b/c", "b/b", "x", "$SYS/health", "$SYS/x/y",
         "a", "c/d/e"]


@pytest.fixture(scope="module")
def small():
    return both(SMALL)


@pytest.mark.parametrize("tf", [
    "a/b", "a/+", "a/#", "#", "+", "+/+", "+/b", "a/b/#", "x",
    "$SYS/#", "$SYS/+", "+/health", "a/+/c",
])
def test_parity_small(small, tf):
    j, p = small
    got = scan(j, p, [("T", t.parse(tf))])[0]
    assert sorted(got) == brute_force(SMALL, t.parse(tf))
    assert sorted(tret.match_filter_host(p.tries["T"], t.parse(tf))) == \
        sorted(got)


@pytest.mark.parametrize("limit", [None, 10])
def test_random_parity(limit):
    rng = random.Random(5)
    alphabet = ["a", "b", "c", "", "x1", "$s"]
    topics = set()
    while len(topics) < 300:
        topics.add("/".join(rng.choice(alphabet)
                            for _ in range(rng.randint(1, 5))))
    topics = sorted(topics)
    j, p = both(topics, k_states=16)
    filters = []
    for _ in range(150):
        n = rng.randint(1, 5)
        levels = []
        for i in range(n):
            roll = rng.random()
            if roll < 0.25:
                levels.append("+")
            elif roll < 0.35 and i == n - 1:
                levels.append("#")
            else:
                levels.append(rng.choice(alphabet))
        filters.append(levels)
    res = scan(j, p, [("T", f) for f in filters], limit=limit)
    for f, got in zip(filters, res):
        want = brute_force(topics, f)
        if limit is None:
            assert sorted(got) == want, f
        else:
            assert len(got) == min(limit, len(want)) and set(got) <= set(want)


def test_plus_overflow_escalates_natively(monkeypatch):
    """40 children > k_states=8: the native walker serves the row; the
    oracle must not run (it is patched to raise in both packages)."""
    def boom(*a, **k):
        raise AssertionError("host oracle used despite escalation")
    topics = [f"t{i}/x" for i in range(40)]
    j, p = both(topics, k_states=8)
    monkeypatch.setattr(jret, "match_filter_host", boom)
    monkeypatch.setattr(tret, "match_filter_host", boom)
    before = nativelib.CALLS["retained_walk"]
    got = scan(j, p, [("T", ["+", "x"]), ("T", ["+", "#"])])
    assert sorted(got[0]) == sorted(topics)
    assert nativelib.CALLS["retained_walk"] == before + 1
    assert p.host_rows == 0
    many = [f"m{i}" for i in range(300)]
    j2, p2 = both(many, k_states=8)
    assert sorted(scan(j2, p2, [("T", ["+"])])[0]) == sorted(many)
    assert scan(j2, p2, [("T", ["+"])], limit=10)[0] == \
        p2.match("T", ["+"], limit=10)


def test_back_compat_probes_and_walk_equal_reference():
    """``device_probes`` and ``walk_device``, the surface of bench.py's
    config 4, with patches pending, so that the walk flushes them
    first."""
    rng = random.Random(11)
    j, p = both(sorted({rand_topic(rng) for _ in range(200)}), k_states=8)
    for i in range(20):
        add(j, p, "T", rand_topic(rng) + f"/n{i}")
    queries = [("T", f) for f in rand_filters(rng, 40)]
    jpr, jroots, jlen = j.device_probes(queries, batch=64)
    ppr, proots, plen = p.device_probes(queries, batch=64)
    assert [int(r) for r in proots] == [int(r) for r in jroots]
    assert np.array_equal(plen, np.asarray(jlen))
    for k in ("tok_h1", "tok_h2", "tok_kind", "lengths", "roots"):
        assert np.array_equal(getattr(ppr, k).numpy(),
                              np.asarray(getattr(jpr, k))), k
    flushes = p.patch_flushes
    (pstart, povf), (jstart, jovf) = p.walk_device(ppr), j.walk_device(jpr)
    assert p.patch_flushes == flushes + 1
    assert np.array_equal(pstart.numpy(), np.asarray(jstart))
    assert np.array_equal(povf.numpy(), np.asarray(jovf))
    assert povf.numpy().any()
    assert_device_equals_host(p)


def test_plus_overflow_falls_back():
    topics = [f"t{i}/x" for i in range(40)]
    j, p = both(topics, k_states=8)
    assert sorted(scan(j, p, [("T", ["+", "x"])])[0]) == sorted(topics)
    # a filter deeper than max_levels is padding: the host matcher serves
    # it, and counts it
    got = scan(j, p, [("T", ["+", "x"]), ("T", ["t1"] + ["+"] * 20)])
    assert sorted(got[0]) == sorted(topics) and got[1] == []
    assert p.host_rows == 1


def test_remove():
    j, p = both(["a/b", "a/c"])
    remove(j, p, "T", "a/b")
    assert scan(j, p, [("T", ["a", "+"])]) == [["a/c"]]


def test_unknown_tenant():
    j, p = both(["a"])
    assert scan(j, p, [("nobody", ["a"])]) == [[]]


def test_multi_tenant():
    j, p = both([])
    for tenant in ("t1", "t2"):
        add(j, p, tenant, "a")
    remove(j, p, "t1", "a")
    assert scan(j, p, [("t1", ["a"]), ("t2", ["a"])]) == [[], ["a"]]


# ------------------------------- (d) patching, TestPatchedRetainedParity

def test_flood_parity_randomized():
    rng = random.Random(11)
    live = set()
    while len(live) < 150:
        live.add(rand_topic(rng))
    j, p = both(sorted(live), k_states=16)
    assert hasattr(p._compiled, "retained_add")
    for i in range(500):
        roll = rng.random()
        if roll < 0.5:
            tp = rand_topic(rng)
            if rng.random() < 0.4:
                tp += f"/d{i}"
            if tp not in live:
                add(j, p, "T", tp)
                live.add(tp)
        elif roll < 0.8 and live:
            tp = rng.choice(sorted(live))
            remove(j, p, "T", tp)
            live.discard(tp)
        elif live:
            add(j, p, "T", rng.choice(sorted(live)))   # payload replace
        if i % 125 == 60:
            # a scan compacts a fragmented base: both compact here
            j.refresh()
            p.refresh()
            assert_arenas_equal(j, p)
            assert_device_equals_host(p)
            for f, got in zip(fs := rand_filters(rng, 60), p.match_batch(
                    [("T", f) for f in fs])):
                assert sorted(got) == brute_force(live, f), f
    assert_arenas_equal(j, p)
    fs = rand_filters(rng, 80)
    res = scan(j, p, [("T", f) for f in fs])
    assert p.rebuilds == 0 and p.patch_fallbacks == 0 and p.patch_flushes
    assert_device_equals_host(p)
    # an unpatched index compiled from the live topics serves the same
    fresh = tret.RetainedIndex(device="cpu", k_states=16, patched=False)
    for tp in sorted(live):
        fresh.add_topic("T", t.parse(tp), tp)
    rows = fresh.match_batch([("T", f) for f in fs])
    assert [sorted(r) for r in rows] == [sorted(r) for r in res] == \
        [brute_force(live, f) for f in fs]


def test_sys_roots_resurrection_and_new_tenant():
    j, p = both(["a/b", "a/c"])
    live = ["a/b", "a/c", "$SYS/health", "$SYS/x/y", "$stat", "c/$d", "c/e"]
    for tp in live[2:]:
        add(j, p, "T", tp)
    fs = [["#"], ["+"], ["$SYS", "#"], ["$SYS", "+"], ["+", "+"],
          ["c", "+"], ["$stat"], ["+", "$d"]]
    for f, got in zip(fs, p.match_batch([("T", f) for f in fs])):
        assert sorted(got) == brute_force(live, f), f
    # set -> clear -> set of the same topic resurrects the slot in place
    slots0 = len(p._compiled.matchings)
    remove(j, p, "T", "a/b")
    assert p._compiled.dead_slots == 1
    add(j, p, "T", "a/b")
    assert p._compiled.dead_slots == 0
    assert len(p._compiled.matchings) == slots0
    for tp in ("a/d", "a/d"):
        add(j, p, "T", tp)
        remove(j, p, "T", tp)
    add(j, p, "T", "a/d")
    add(j, p, "U", "u/v")
    add(j, p, "U", "$SYS/s")
    assert_arenas_equal(j, p)
    got = scan(j, p, [("T", ["a", "#"]), ("T", ["a", "+"]), ("U", ["#"]),
                      ("U", ["$SYS", "#"]), ("T", ["u", "v"])])
    assert [sorted(r) for r in got] == [
        ["a/b", "a/c", "a/d"], ["a/b", "a/c", "a/d"], ["u/v"], ["$SYS/s"],
        []]
    assert p.rebuilds == 0


def test_arena_growth_parity():
    rng = random.Random(3)
    j, p = both(["seed/x"], k_states=16)
    for i in range(400):
        add(j, p, "T", f"f{i % 37}/s{i % 11}/d{i}")
    assert p._compiled.node_grows >= 1 and p.rebuilds == 0
    assert_arenas_equal(j, p)
    assert_device_equals_host(p)
    scan(j, p, [("T", f) for f in rand_filters(rng, 40)
                + [["f3", "+", "#"], ["+", "s4", "#"]]])


def test_compaction_limit_and_tombstones():
    topics = [f"a/b/t{i}" for i in range(120)]
    j, p = both(topics)
    for tp in topics[:90]:
        remove(j, p, "T", tp)
    assert p.frag_pending() and j.frag_pending()
    j.refresh()
    p.refresh()
    assert p.compactions == 1 and p.rebuilds == 0 and p._compiled.pristine
    assert_arenas_equal(j, p)
    xs = [f"x/t{i:03d}" for i in range(50)]
    for tp in xs:
        add(j, p, "T", tp)
    for tp in xs[::2]:
        remove(j, p, "T", tp)
    got = scan(j, p, [("T", ["x", "#"]), ("T", ["a", "b", "#"])], limit=7)
    assert len(got[0]) == 7 and set(got[0]) <= set(xs[1::2])
    got = scan(j, p, [("T", ["x", "+"])], limit=1000)
    assert sorted(got[0]) == sorted(xs[1::2])


def test_unpatched_index_rebuilds():
    j, p = both(["a/b"], patched=False)
    assert not hasattr(p._compiled, "retained_add")
    add(j, p, "T", "a/c")
    assert p._dirty
    assert sorted(scan(j, p, [("T", ["a", "+"])])[0]) == ["a/b", "a/c"]
    assert p.rebuilds == 1
    j, p = both(["only/one"])
    remove(j, p, "T", "only/one")
    assert "T" not in p.tries
    assert scan(j, p, [("T", ["#"]), ("T", ["+"] * 3)]) == [[], []]


def test_failed_flush_restores_the_dirty_set(monkeypatch):
    p = tret.RetainedIndex(device="cpu")
    for tp in ("a/b", "a/c"):
        p.add_topic("T", t.parse(tp), tp)
    p.refresh()
    p.add_topic("T", ["a", "d"], "a/d")
    real = tops.upload

    def fail(*a, **k):
        raise RuntimeError("injected upload failure")
    monkeypatch.setattr(tops, "upload", fail)
    with pytest.raises(RuntimeError, match="injected"):
        p.flush_device()
    assert {"node", "edge", "child", "ext", "extra"} <= p._compiled._full
    monkeypatch.setattr(tops, "upload", real)
    assert_device_equals_host(p)
    assert sorted(p.match("T", ["a", "+"])) == ["a/b", "a/c", "a/d"]


def test_index_needs_a_card_unless_asked_for_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tret.RetainedIndex()
    assert tret.RetainedIndex(device="cpu").device.type == "cpu"


# ------------------------------------------------ (e) the native walker

def _native_corpus():
    rng = random.Random(5)
    names = [f"n{i}" for i in range(12)]
    topics = [[rng.choice(names) for _ in range(rng.randint(1, 4))]
              for _ in range(800)]
    topics += [["$SYS", "a"], ["$SYS", "a", "b"], ["$x", "y"]]
    trie = ja.SubscriptionTrie()
    for tp in topics:
        trie.add(jret._topic_route(tp, "/".join(tp)))
    return ja.compile_tries({"T": trie}, max_levels=8)


@pytest.mark.parametrize("limit,max_ranges", [(None, 8192), (7, 8192),
                                              (None, 8)])
def test_native_walker_equals_reference(limit, max_ranges):
    ct = _native_corpus()
    filters = [["+"], ["#"], ["+", "#"], ["+", "+"], ["n0", "#"],
               ["+", "n1"], ["n2", "+", "n3"], ["+", "+", "+"],
               ["$SYS", "#"], ["$SYS", "+"], ["+", "+", "#"], ["n0"],
               ["missing", "+"]]
    tok = ja.tokenize_filters(filters, [ct.root_of("T")] * len(filters),
                              max_levels=ct.max_levels, salt=ct.salt)
    args = (tok.tok_h1, tok.tok_h2, tok.tok_kind, tok.lengths, tok.roots)
    got = t_native(ct, *args, limit=limit, max_ranges=max_ranges)
    want = j_native(ct, *args, limit=limit, max_ranges=max_ranges)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert got[2].any() == (max_ranges == 8)


@pytest.fixture
def broken_compiler(tmp_path, monkeypatch):
    runs = tmp_path / "runs"
    cxx = tmp_path / "broken-g++"
    cxx.write_text(f"#!/bin/sh\necho run >> {runs}\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(nativelib, "CXX", str(cxx))
    monkeypatch.setattr(nativelib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nativelib, "_cache", {})
    return lambda: len(runs.read_text().split()) if runs.exists() else 0


def test_failed_native_build_raises_out_of_match_batch(broken_compiler,
                                                       monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the oracle served a row")
    monkeypatch.setattr(tret, "match_filter_host", boom)
    p = tret.RetainedIndex(device="cpu", k_states=2)
    for i in range(8):
        p.add_topic("T", [f"n{i}"], f"n{i}")
    assert p.match("T", ["n3"]) == ["n3"]     # no escalation: served
    for _ in range(2):
        with pytest.raises(nativelib.NativeLibError):
            p.match_batch([("T", ["+"])])
        assert broken_compiler() == 1


def test_native_library_lands_under_build():
    from bifromq_tpu_torch.models import native_retained
    native_retained.load_lib()
    lib = nativelib.library_path(native_retained._SRC)
    assert lib.exists() and lib.parent == nativelib.BUILD_DIR
    assert native_retained._SRC.is_relative_to(
        nativelib.CSRC_HOST.parents[1])


# ------------------------------------------- (f) carried-over state

def preorder(trie):
    """A trie's topics in pre-order: re-adding them in this order gives
    every node the same child order, which the host matcher's order of
    results follows."""
    out = []

    def walk(node):
        out.extend(r.receiver_id for r in node.routes.values())
        for child in node.children.values():
            walk(child)
    walk(trie._root)
    return out


def test_reference_state_carried_across_serves_the_same():
    rng = random.Random(13)
    live = sorted({rand_topic(rng) for _ in range(200)})
    j = jret.RetainedIndex(k_states=16)
    for tp in live:
        j.add_topic("T", t.parse(tp), tp)
    j.refresh()
    for i in range(150):
        tp = rand_topic(rng) + f"/c{i}"
        j.add_topic("T", t.parse(tp), tp)
        if i % 3 == 0:
            j.remove_topic("T", t.parse(live[i]), live[i])
    jc = j._compiled
    assert jc.extra_live and jc.dead_slots
    p = state.retained_index_from_numpy(
        topics={tn: preorder(tr) for tn, tr in j.tries.items()},
        receivers=list(j._receiver_arr[:len(jc.matchings)]),
        tenant_root=jc.tenant_root, salt=jc.salt, n_live=jc.n_live,
        probe_len=jc.probe_len, max_levels=jc.max_levels,
        dead_slots=jc.dead_slots, garbage_slots=jc.garbage_slots,
        k_states=16, device="cpu",
        extras=dict(extra_live=jc.extra_live,
                    extra_garbage=jc.extra_garbage,
                    child_live=jc.child_live,
                    child_garbage=jc.child_garbage,
                    child_cap=jc._child_cap, ext_cap=jc._ext_cap,
                    own_slot=jc._own_slot),
        **{k: np.asarray(getattr(jc, k)) for k in ARENAS},
        slot_kind=np.asarray(jc.slot_kind))
    assert_arenas_equal(j, p)
    queries = [("T", f) for f in rand_filters(rng, 100)]
    scan(j, p, queries)
    scan(j, p, queries, limit=10)
    # and both keep patching the same rows
    for i in range(30):
        add(j, p, "T", f"later/{i}/x")
    remove(j, p, "T", live[1])
    assert_arenas_equal(j, p)
    assert_device_equals_host(p)
