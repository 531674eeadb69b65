"""Port parity: the native host helpers (C++ topic tokenizer and interval
expander) against the reference's legs.

The port builds its own copies of ``tokenizer.cpp`` and ``expand.cpp``
(``bifromq_tpu_torch/csrc/host/``) with g++ into ``build/host/``. Held
with exact array equality:

- the port's native ``tokenize`` against the reference's
  ``tokenize(..., native=False)`` (the per-level Python loop) and the
  port's own ``native=False`` leg, on seeded ``probe_topics``, ``$SYS``
  topics, empty levels, multibyte UTF-8, rows deeper than ``max_levels``,
  ``batch > n``, a ``TopicBytes`` batch and a cached batch, at two salts;
  and its threaded leg (n >= 2048) against its serial leg;
- the port's native ``expand_intervals`` against its numpy leg and the
  reference's ``expand_intervals``, on seeded 2-D grids with zero and
  negative counts, a 1-D grid, empty grids and the mesh's one-row slices.

Then: a build that fails raises ``NativeLibError`` (a ``RuntimeError``)
out of the serving calls and out of ``DistWorker``, and a second call
raises without running the compiler again; the libraries land under the
repository's ``build/`` and nothing under ``native/`` changes.
"""

import asyncio
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest

from bifromq_tpu.models import automaton as ja
from bifromq_tpu.ops.match import expand_intervals as ref_expand
from bifromq_tpu_torch import workloads as tw
from bifromq_tpu_torch.models import automaton as ta
from bifromq_tpu_torch.models import native_tok
from bifromq_tpu_torch.models.bytetok import TopicBytes
from bifromq_tpu_torch.ops import match as tm
from bifromq_tpu_torch.utils import nativelib

REPO = Path(__file__).resolve().parents[1]
SALTS = (0, 987654321)
FIELDS = ("tok_h1", "tok_h2", "lengths", "roots", "sys_mask")
MAX_LEVELS = 16


def _corpus(seed):
    """Seeded probe topics plus the edge rows, as level lists."""
    topics = [list(t) for t in tw.probe_topics(300, seed=seed)]
    topics += [["a", "b", "c"], [""], ["", ""], ["$SYS", "health"],
               ["$SYS"], ["héllo", "wörld", "日本語"], ["x" * 200, "y" * 500],
               ["a"] * (MAX_LEVELS + 1), ["lvl%d" % i
                                          for i in range(MAX_LEVELS)],
               ["", "leading"], ["trailing", ""], ["🙂", "$x"]]
    return topics


def _assert_tok_equal(a, b):
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x, y), f


# ---------------------------------------------------------------- (a) tokenize

@pytest.mark.parametrize("salt", SALTS)
@pytest.mark.parametrize("form", ["levels", "strings", "bytes",
                                  "topic_bytes"])
def test_native_tokenize_equals_the_python_legs(salt, form):
    topics = _corpus(seed=salt % 7)
    strs = ["/".join(t) for t in topics]
    rows = {"levels": topics, "strings": strs,
            "bytes": [s.encode("utf-8") for s in strs],
            "topic_bytes": TopicBytes.from_topics(strs)}[form]
    roots = list(range(5, 5 + len(topics)))
    batch = len(topics) + 13        # padding rows past n
    ref = ja.tokenize(topics, roots, max_levels=MAX_LEVELS, salt=salt,
                      batch=batch, native=False)
    nat = ta.tokenize(rows, roots, max_levels=MAX_LEVELS, salt=salt,
                      batch=batch)
    py = ta.tokenize(rows, roots, max_levels=MAX_LEVELS, salt=salt,
                     batch=batch, native=False)
    _assert_tok_equal(nat, ref)
    _assert_tok_equal(py, ref)
    assert nat.lengths[len(topics) - 5] == -1       # deeper than max
    assert (nat.lengths[len(topics):] == -1).all()


@pytest.mark.parametrize("salt", SALTS)
def test_native_tokenize_through_the_token_cache(salt):
    topics = _corpus(seed=1)
    roots = [3] * len(topics)
    ref = ja.tokenize(topics, roots, max_levels=MAX_LEVELS, salt=salt,
                      native=False)
    cache = ta.TokenCache()
    for tb in (False, True):
        rows = TopicBytes.from_topics(["/".join(t) for t in topics]) \
            if tb else topics
        first = ta.tokenize(rows, roots, max_levels=MAX_LEVELS, salt=salt,
                            cache=cache)
        # the second pass is all hits
        again = ta.tokenize(rows, roots, max_levels=MAX_LEVELS, salt=salt,
                            cache=cache)
        _assert_tok_equal(first, ref)
        _assert_tok_equal(again, ref)


def test_threaded_leg_equals_serial_leg(monkeypatch):
    topics = [list(t) for t in tw.probe_topics(4096, seed=9)]
    topics[7] = ["$SYS", "x"]
    topics[11] = ["lv"] * 20
    roots = list(range(len(topics)))
    assert len(topics) >= native_tok._MT_THRESHOLD
    mt = native_tok.tokenize_topics_native(topics, roots,
                                           max_levels=MAX_LEVELS, salt=3)
    monkeypatch.setattr(native_tok, "_MT_THRESHOLD", 1 << 30)
    ser = native_tok.tokenize_topics_native(topics, roots,
                                            max_levels=MAX_LEVELS, salt=3)
    for a, b in zip(mt, ser):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ref = ja.tokenize(topics, roots, max_levels=MAX_LEVELS, salt=3,
                      native=False)
    for f, a in zip(FIELDS, mt):
        assert np.array_equal(a, getattr(ref, f)), f


def test_escalation_sub_batch_tokenizes_natively():
    """The escalation re-walk's host rows (``DeviceTokenized.sub_batch``)
    take the native TopicBytes leg and equal the reference's loop."""
    from bifromq_tpu_torch.ops.tokenize import pack_topic_bytes, \
        DeviceTokenized
    strs = ["/".join(t) for t in _corpus(seed=2)]
    tb = TopicBytes.from_topics(strs)
    roots = list(range(len(strs)))
    lengths, rootv, sys_mask, *_ = pack_topic_bytes(
        tb, roots, max_levels=MAX_LEVELS, batch=len(strs))
    dt = DeviceTokenized(lengths, rootv, sys_mask, tb, 5, MAX_LEVELS)
    pick = np.array([0, 3, 17, len(strs) - 2])
    got = dt.sub_batch(pick, 16)
    ref = ja.tokenize([strs[i] for i in pick], [int(r) for r in rootv[pick]],
                      max_levels=MAX_LEVELS, salt=5, batch=16, native=False)
    _assert_tok_equal(got, ref)


# ---------------------------------------------------------------- (b) expand

def _grid(rng, shape, max_start=5000, lo=-3, hi=9, p_zero=0.3):
    starts = rng.integers(0, max_start, size=shape).astype(np.int32)
    counts = rng.integers(lo, hi, size=shape).astype(np.int32)
    counts[rng.random(shape) < p_zero] = 0
    return starts, counts


def _assert_expand_equal(starts, counts):
    nat = tm.expand_intervals(starts, counts)
    npy = tm.expand_intervals_numpy(starts, counts)
    ref = ref_expand(starts, counts)
    for got in (nat, npy):
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and g.shape == r.shape
            assert np.array_equal(g, r)
    return nat


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [(64, 32), (7, 1), (1, 128)])
def test_native_expand_equals_numpy_and_reference_2d(seed, shape):
    rng = np.random.default_rng(seed)
    starts, counts = _grid(rng, shape)
    slots, offs = _assert_expand_equal(starts, counts)
    assert offs[-1] == np.maximum(counts, 0).sum() == slots.size


def test_native_expand_1d_grid_and_empty_grids():
    rng = np.random.default_rng(4)
    starts, counts = _grid(rng, (40,))
    slots, offs = _assert_expand_equal(starts, counts)
    assert offs.shape == (2,) and slots.size == offs[-1] > 0
    # total 0 takes the numpy leg (a size rule), with the same results
    for shape, count in (((0, 8), 0), ((5, 8), -1), ((8,), 0)):
        z = np.zeros(shape, np.int32)
        slots, offs = _assert_expand_equal(z + 7, z + count)
        assert slots.size == 0 and slots.dtype == np.int32


def test_native_expand_mesh_one_row_slices():
    """The mesh's truncated rows expand one row a call, from a
    ``[R, S, b, A]`` grid's ``[1, A]`` slice."""
    rng = np.random.default_rng(5)
    starts, counts = _grid(rng, (2, 4, 16, 32), hi=40)
    for rep in range(2):
        for sh in range(4):
            for bi in (0, 5, 15):
                row, offs = _assert_expand_equal(
                    starts[rep, sh, bi:bi + 1], counts[rep, sh, bi:bi + 1])
                assert offs.shape == (2,)


# ------------------------------------- the serving call sites go through them

def _canon(m):
    return (sorted((r.matcher.mqtt_topic_filter, r.receiver_url)
                   for r in m.normal),
            sorted((f, sorted(r.receiver_url for r in ms))
                   for f, ms in m.groups.items()))


def test_serving_call_sites_run_the_native_helpers(monkeypatch):
    """With a 1-pair expansion buffer (every fanned-out row truncated) and
    a 2-state walk (rows overflow and escalate): the single-table stage 0
    host leg (level lists) and stage 3 (escalation and truncated rows),
    and the mesh's stage 0 and stage 3, all count native calls, and the
    rows equal the host oracle's."""
    from bifromq_tpu_torch.models.matcher import TorchMatcher
    from bifromq_tpu_torch.parallel.sharded import TorchMeshMatcher, \
        make_mesh
    monkeypatch.setenv("BIFROMQ_EXPAND_CAP", "1")
    calls = nativelib.CALLS

    def served(m, queries):
        before = dict(calls)
        res = m.match_batch(queries)
        assert [_canon(r) for r in res] == \
            [_canon(r) for r in m.match_from_tries(queries)]
        return {k: calls[k] - before.get(k, 0) for k in calls}

    m = TorchMatcher.from_tries(tw.config_wildcard(400, seed=0),
                                device="cpu", k_states=2,
                                match_cache=False)
    levels = [list(t) for t in tw.probe_topics(64, seed=4)]
    got = served(m, [("tenant0", "/".join(t)) for t in levels])
    # the escalation's host rows and its grid, the truncated rows' grids
    assert got["tokenize"] >= 1 and got["expand"] >= 2
    got = served(m, [("tenant0", t) for t in levels])
    assert got["tokenize"] >= 1 and got["expand"] >= 2
    tries = tw.config_multi_tenant(12, 600, seed=0)
    mm = TorchMeshMatcher.from_tries(tries, mesh=make_mesh(2, 4, device="cpu"),
                                     match_cache=False)
    # topics made from subscribed filters, so rows fan out
    queries = [(tenant, "/".join("l0" if lv == "+" else lv
                                 for lv in r.matcher.filter_levels
                                 if lv != "#"))
               for tenant, trie in sorted(tries.items())
               for r in list(trie.routes())[:8]]
    got = served(mm, queries)
    # one tokenize a busy (replica, shard) slot, one expand a truncated row
    assert got["tokenize"] >= 4 and got["expand"] >= 1


# ------------------------------------------------ (c) a failed build raises

@pytest.fixture
def broken_compiler(tmp_path, monkeypatch):
    """A compiler that records each run and fails, an empty library
    cache and an empty build directory: every helper must build anew."""
    runs = tmp_path / "runs"
    cxx = tmp_path / "broken-g++"
    cxx.write_text(f"#!/bin/sh\necho run >> {runs}\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(nativelib, "CXX", str(cxx))
    monkeypatch.setattr(nativelib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nativelib, "_cache", {})

    def count():
        return len(runs.read_text().split()) if runs.exists() else 0
    return count


def test_failed_build_raises_out_of_the_serving_calls(broken_compiler):
    from bifromq_tpu_torch.models.matcher import TorchMatcher
    from bifromq_tpu_torch.models.oracle import Route
    from bifromq_tpu_torch.types import RouteMatcher
    m = TorchMatcher(device="cpu")
    m.add_route("T", Route(matcher=RouteMatcher.from_topic_filter("a/+"),
                           broker_id=0, receiver_id="r", deliverer_key="d",
                           incarnation=0))
    for i in range(2):
        # level-list rows take the host tokenizer
        with pytest.raises(nativelib.NativeLibError) as e:
            m.match_batch([("T", ["a", f"b{i}"])])
        assert isinstance(e.value, RuntimeError)
        assert broken_compiler() == 1       # the compiler ran once
    for _ in range(2):
        with pytest.raises(nativelib.NativeLibError):
            tm.expand_intervals(np.zeros((2, 4), np.int32),
                                np.ones((2, 4), np.int32))
        assert broken_compiler() == 2
    # the explicit Python and numpy legs still serve
    assert ta.tokenize([["a"]], [0], max_levels=4, salt=0,
                       native=False).lengths[0] == 1
    assert tm.expand_intervals_numpy(np.zeros((1, 1), np.int32),
                                     np.ones((1, 1), np.int32))[0].size == 1


def test_failed_build_raises_out_of_the_dist_worker(broken_compiler):
    """A mesh-backed range tokenizes on the host: the worker re-raises
    the helper's failure and does not degrade to the oracle."""
    from bifromq_tpu_torch.dist.worker import DistWorker
    from bifromq_tpu_torch.models.oracle import Route
    from bifromq_tpu_torch.parallel.sharded import TorchMeshMatcher, \
        make_mesh
    from bifromq_tpu_torch.types import RouteMatcher
    from bifromq_tpu_torch.utils.metrics import FABRIC, FabricMetric
    degraded = []

    async def run():
        w = DistWorker(matcher_factory=lambda: TorchMeshMatcher(
            mesh=make_mesh(2, 4, device="cpu"), k_states=16))
        w.on_degraded = lambda n, why: degraded.append(why)
        await w.start()
        try:
            await w.add_route("T", Route(
                matcher=RouteMatcher.from_topic_filter("a/+"), broker_id=0,
                receiver_id="r", deliverer_key="d", incarnation=0))
            before = FABRIC.get(FabricMetric.MATCH_DEGRADED)
            for i in range(2):
                with pytest.raises(nativelib.NativeLibError):
                    await w.match_batch([("T", ["a", f"x{i}"])],
                                        max_persistent_fanout=1 << 30,
                                        max_group_fanout=1 << 30)
            assert FABRIC.get(FabricMetric.MATCH_DEGRADED) == before
        finally:
            await w.stop()
    asyncio.run(run())
    assert broken_compiler() == 1 and not degraded


# --------------------------------------------- (d) where the libraries land

def test_libraries_build_under_build_and_leave_native_untouched():
    src_tok, src_exp = native_tok._SRC, nativelib.CSRC_HOST / "expand.cpp"
    port = REPO / "bifromq_tpu_torch"
    assert src_tok.is_relative_to(port) and src_exp.is_relative_to(port)
    native_tok.load_lib()
    tm._expand_lib()
    for src, flags in ((src_tok, ("-pthread",)), (src_exp, ())):
        lib = nativelib.library_path(src, flags)
        assert lib.exists() and lib.is_relative_to(REPO / "build" / "host")
    assert not list(port.rglob("*.so"))
    out = subprocess.run(["git", "status", "--porcelain", "native/"],
                         cwd=REPO, capture_output=True, text=True)
    assert out.returncode == 0 and out.stdout == ""
    assert os.path.isdir(REPO / "native")
