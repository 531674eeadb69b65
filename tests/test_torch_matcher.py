"""Port parity: TorchMatcher against TpuMatcher, and the import boundary.

``TorchMatcher(device="cpu", match_cache=False)`` (plain versions of all
three kernels) and the reference ``TpuMatcher(match_cache=False)`` take
one randomized query stream with add/remove churn, ``$share`` groups,
fan-out caps, an unknown tenant, small walk budgets (so escalation and
the oracle fallback run) and a small expansion buffer (so truncated rows
re-expand on the host). Both run their default mutation path: in-place
patching of the base arenas. Every query's ``MatchedRoutes`` must be
identical as normalized tuples, in order, and the device-bucketed
``last_expanded`` pairs must be array-equal. Tolerance: exact equality.
"""

import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from bifromq_tpu.models.matcher import TpuMatcher
from bifromq_tpu.models.oracle import Route as JRoute
from bifromq_tpu.types import RouteMatcher as JMatcher
from bifromq_tpu_torch.models.matcher import TorchMatcher
from bifromq_tpu_torch.models.oracle import Route as TRoute
from bifromq_tpu_torch.types import RouteMatcher as TMatcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = [f"n{i}" for i in range(5)]


def _norm(m):
    return (tuple((r.matcher.mqtt_topic_filter, r.receiver_url, r.broker_id,
                   r.incarnation) for r in m.normal),
            tuple((f, tuple(r.receiver_url for r in ms))
                  for f, ms in m.groups.items()),
            m.persistent_fanout, m.max_persistent_fanout_exceeded,
            m.max_group_fanout_exceeded)


def _route_spec(rng, i):
    levels = [rng.choice(NAMES + ["+"]) for _ in range(rng.randint(1, 4))]
    if rng.random() < 0.3:
        levels.append("#")
    if rng.random() < 0.05:
        levels[0] = "$SYS"
    f = "/".join(levels)
    if rng.random() < 0.15:
        f = f"{rng.choice(['$share', '$oshare'])}/g{i % 2}/{f}"
    return (f, i % 2, f"r{i}", f"srv{i % 3}|d{i}", rng.randint(0, 2))


def _routes(spec):
    f, broker, rcv, dkey, inc = spec
    return (JRoute(JMatcher.from_topic_filter(f), broker, rcv, dkey, inc),
            TRoute(TMatcher.from_topic_filter(f), broker, rcv, dkey, inc))


def _queries(rng, n):
    out = []
    for _ in range(n):
        t = [rng.choice(NAMES) for _ in range(rng.randint(1, 5))]
        if rng.random() < 0.1:
            t[0] = "$SYS"
        tenant = "ghost" if rng.random() < 0.05 else "T"
        out.append((tenant, "/".join(t)) if rng.random() < 0.8
                   else (tenant, t))
    return out


def _check_round(ref, port, queries, **caps):
    a = ref.match_batch(queries, **caps)
    b = port.match_batch(queries, **caps)
    assert [_norm(m) for m in a] == [_norm(m) for m in b]
    (rp, rtab), (pp, ptab) = ref.last_expanded, port.last_expanded
    for f in ("slots", "rows", "row_offsets", "trunc", "peer_slots",
              "peer_rows", "peer_offsets"):
        assert np.array_equal(np.asarray(getattr(rp, f)),
                              getattr(pp, f)), f
    assert int(rp.n_pairs) == int(pp.n_pairs)
    assert rtab.peers == ptab.peers
    assert np.array_equal(rtab.slot_peer, ptab.slot_peer)
    return bool(pp.res.overflow.any()), bool(pp.trunc.any())


def test_torch_matcher_equals_tpu_matcher_under_churn(monkeypatch):
    monkeypatch.setenv("BIFROMQ_EXPAND_CAP", "1")
    kw = dict(k_states=4, max_intervals=4, auto_compact=False,
              match_cache=False)
    ref = TpuMatcher(**kw)
    port = TorchMatcher(device="cpu", **kw)
    rng = random.Random(0)
    specs = [_route_spec(rng, i) for i in range(160)]
    for spec in specs:
        jr, tr = _routes(spec)
        assert ref.add_route("T", jr) == port.add_route("T", tr)
    ref.refresh()
    port.refresh()
    seen = [_check_round(ref, port, _queries(rng, 24))]
    for rnd in range(3):
        for _ in range(12):
            if rng.random() < 0.6:
                spec = _route_spec(rng, rng.randrange(400))
                jr, tr = _routes(spec)
                assert ref.add_route("T", jr) == port.add_route("T", tr)
            else:
                f, broker, rcv, dkey, inc = rng.choice(specs)
                jr, tr = _routes((f, broker, rcv, dkey, inc))
                assert (ref.remove_route("T", jr.matcher, jr.receiver_url,
                                         inc)
                        == port.remove_route("T", tr.matcher,
                                             tr.receiver_url, inc))
        caps = ({} if rnd != 1 else
                dict(max_persistent_fanout=2, max_group_fanout=1))
        seen.append(_check_round(ref, port, _queries(rng, 24), **caps))
        if rnd == 1:
            ref.refresh()
            port.refresh()
            assert port.overlay_size == 0
    # every mutation was patched in place: the refreshes rebuilt nothing
    assert port.compile_count == ref.compile_count == 1
    assert port.patch_count == ref.patch_count > 0
    # the walk-overflow (escalation) and buffer-truncation legs both ran
    assert any(o for o, _ in seen) and any(t for _, t in seen)


def test_torch_matcher_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        TorchMatcher()


_SERVE_WITHOUT_JAX = """
import sys
from bifromq_tpu_torch import workloads
from bifromq_tpu_torch.models.matcher import TorchMatcher
import bifromq_tpu_torch.models.state, bifromq_tpu_torch.dist.deliverer
import bifromq_tpu_torch.models.matchcache, bifromq_tpu_torch.utils.metrics
from bifromq_tpu_torch.models.oracle import Route
from bifromq_tpu_torch.types import RouteMatcher
m = TorchMatcher.from_tries(workloads.config_wildcard(500, seed=0),
                            device="cpu")
topics = ["/".join(t) for t in workloads.probe_topics(32, seed=1)]
m.add_route("tenant0", Route(RouteMatcher.from_topic_filter(topics[0]), 0,
                             "patched", "d0", 0))
assert m.patch_count == 1 and m.overlay_size == 0
res = m.match_batch([("tenant0", t) for t in topics])
assert m.match_batch([("tenant0", t) for t in topics])[0] is res[0]
oracle = m.match_from_tries([("tenant0", t) for t in topics])
assert [len(r.all_routes()) for r in res] == \
    [len(r.all_routes()) for r in oracle]
from bifromq_tpu_torch.parallel import sharded
mm = sharded.TorchMeshMatcher.from_tries(
    workloads.config_multi_tenant(40, 400, seed=0),
    mesh=sharded.make_mesh(2, 4, device="cpu"))
mq = [(f"tenant{i % 40}", t) for i, t in enumerate(topics)]
assert [len(r.all_routes()) for r in mm.match_batch(mq)] == \
    [len(r.all_routes()) for r in mm.match_from_tries(mq)]
# the native host helpers: the mesh's prepare tokenized through them
import bifromq_tpu_torch.utils.nativelib, bifromq_tpu_torch.models.native_tok
assert "bifromq_tpu_torch.models.native_tok" in sys.modules
from bifromq_tpu_torch.ops.match import expand_intervals
assert expand_intervals([[3, 9]], [[2, 1]])[0].tolist() == [3, 4, 9]
# the batched walk over stacked tables and the hash's edge-case batch
import numpy as np, torch
from bifromq_tpu_torch.models import kernels
from bifromq_tpu_torch.models.bytetok import TopicBytes
from bifromq_tpu_torch.ops import match, tokenize
ds = [workloads.dense_walk_tables(s, batch=16) for s in range(2)]
def stack(k):
    return torch.from_numpy(np.stack([d[k] for d in ds]))
rt = stack("route_tab")
g = kernels.fused_walk_routes(
    match.DeviceTrie(rt, stack("edge_tab"), None, None, rt),
    match.Probes(stack("tok_h1"), stack("tok_h2"), stack("lengths"),
                 stack("roots"), stack("sys_mask"), 10), probe_len=16)
assert g.start.shape == (2, 16, 32)
_, probes = tokenize.device_tokenize(
    TopicBytes.from_topics(workloads.hash_edge_topics(24)), [0] * 24,
    max_levels=16, salt=0, batch=32, device="cpu")
assert probes.tok_h1.shape == (32, 17)
# the pipelined, failure-bounded leg and its modules
import asyncio
import bifromq_tpu_torch.models.pipeline, bifromq_tpu_torch.obs.window
import bifromq_tpu_torch.resilience.breaker
import bifromq_tpu_torch.resilience.device
import bifromq_tpu_torch.resilience.faults
stats = {}
res_async = asyncio.run(m.match_batch_async(
    [("tenant0", t + "/x") for t in topics], stats=stats))
assert "degraded" not in stats and m._ring.dispatched_total == 1
assert [len(r.all_routes()) for r in res_async] == [len(r.all_routes())
    for r in m.match_from_tries([("tenant0", t + "/x") for t in topics])]
# the dist plane: one publish through DistService -> DistWorker (one
# voter, one range, routes through consensus) -> match_batch_async
import bifromq_tpu_torch.dist.service, bifromq_tpu_torch.dist.worker
import bifromq_tpu_torch.kv.balance, bifromq_tpu_torch.kv.engine
import bifromq_tpu_torch.kv.load, bifromq_tpu_torch.kv.range
import bifromq_tpu_torch.kv.schema, bifromq_tpu_torch.kv.store
import bifromq_tpu_torch.plugin.events, bifromq_tpu_torch.plugin.settings
import bifromq_tpu_torch.plugin.subbroker, bifromq_tpu_torch.raft.node
import bifromq_tpu_torch.raft.transport, bifromq_tpu_torch.rpc.fabric
import bifromq_tpu_torch.resilience.policy, bifromq_tpu_torch.utils.hlc
import bifromq_tpu_torch.scheduler.batcher, bifromq_tpu_torch.utils.sysprops
from bifromq_tpu_torch.dist.service import DistService
from bifromq_tpu_torch.dist.worker import DistWorker
from bifromq_tpu_torch.plugin.events import CollectingEventCollector
from bifromq_tpu_torch.plugin.settings import DefaultSettingProvider
from bifromq_tpu_torch.plugin.subbroker import (DeliveryResult, ISubBroker,
                                                SubBrokerRegistry)
from bifromq_tpu_torch.types import ClientInfo, Message, QoS
from bifromq_tpu_torch.utils.hlc import HLC
class Sink(ISubBroker):
    id = 0
    got = []
    async def deliver(self, tenant_id, deliverer_key, packs):
        out = {}
        for dp in packs:
            for mi in dp.match_infos:
                self.got.append(mi.receiver_id)
                out[mi] = DeliveryResult.OK
        return out
async def publish():
    reg = SubBrokerRegistry()
    reg.register(Sink())
    svc = DistService(reg, CollectingEventCollector(),
                      DefaultSettingProvider(), worker=DistWorker(
                          matcher_factory=lambda: TorchMatcher(device="cpu")))
    await svc.start()
    try:
        assert await svc.match("T", RouteMatcher.from_topic_filter("a/+"),
                               0, "r1", "d0")
        return await svc.pub(ClientInfo(tenant_id="T"), "a/b", Message(
            message_id=1, pub_qos=QoS.AT_MOST_ONCE, payload=b"x",
            timestamp=HLC.INST.get()))
    finally:
        await svc.stop()
pr = asyncio.run(publish())
assert pr.ok and pr.fanout == 1 and Sink.got == ["r1"], (pr, Sink.got)
# the retained index: one scan (K1's plain version, the retained walk,
# one row escalated to the native walker)
import bifromq_tpu_torch.ops.retained, bifromq_tpu_torch.retained_plane
import bifromq_tpu_torch.models.native_retained
from bifromq_tpu_torch.models.retained import RetainedIndex
idx = RetainedIndex(device="cpu", k_states=2)
for t in ("a/b", "a/c", "a/d", "$SYS/x", "b"):
    idx.add_topic("T", t.split("/"), t)
assert idx.match_batch([("T", ["a", "+"]), ("T", ["#"]), ("T", ["b"])]) \
    == [["a/b", "a/c", "a/d"], ["a/b", "a/c", "a/d", "b"], ["b"]]
# the retained service plane: one retain through consensus, one match
# through the range's scan plane
import bifromq_tpu_torch.plugin.throttler, bifromq_tpu_torch.retain.coproc
import bifromq_tpu_torch.retain.service
import bifromq_tpu_torch.retained_plane.cache
import bifromq_tpu_torch.retained_plane.scan
from bifromq_tpu_torch.retain.service import RetainService
async def retained():
    rs = RetainService(CollectingEventCollector(),
                       index=RetainedIndex(device="cpu"))
    try:
        assert await rs.retain(ClientInfo(tenant_id="T"), "r/1", Message(
            message_id=2, pub_qos=QoS.AT_MOST_ONCE, payload=b"v",
            timestamp=0))
        return await rs.match("T", ["r", "+"], 10)
    finally:
        await rs.stop()
hits = asyncio.run(retained())
assert [(t, m.payload) for t, m in hits] == [("r/1", b"v")], hits
assert "jax" not in sys.modules, "jax imported"
bad = [k for k in sys.modules
       if k == "bifromq_tpu" or k.startswith("bifromq_tpu.")]
assert not bad, bad
print("served", sum(len(r.all_routes()) for r in res))
"""


def test_port_serves_without_importing_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _SERVE_WITHOUT_JAX],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("served")
