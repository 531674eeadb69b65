"""Port parity: compile output and state carried across from the JAX package.

The port's own ``compile_tries`` must produce byte-identical
``node_tab``/``edge_tab``/``child_list``, the same salt and the same
matchings order as the reference for tries built from one seed, and
``models.state.device_trie_from_numpy`` must turn a JAX ``DeviceTrie``'s
leaves into port tables that walk to the reference's answers.
Tolerance: exact equality — every table and output is integer or bool.
"""

import numpy as np
import pytest
import torch

from bifromq_tpu import workloads as jw
from bifromq_tpu.models.automaton import compile_tries, tokenize
from bifromq_tpu.ops import match as jm
from bifromq_tpu_torch import workloads as tw
from bifromq_tpu_torch.models import automaton as ta
from bifromq_tpu_torch.models.state import (TRIE_LEAVES,
                                            device_trie_from_numpy)
from bifromq_tpu_torch.ops import match as tm


def _norm(m):
    if hasattr(m, "members"):
        return ("group", m.mqtt_topic_filter, m.ordered,
                tuple(r.receiver_url for r in m.members))
    return ("route", m.matcher.mqtt_topic_filter, m.receiver_url,
            m.broker_id, m.incarnation)


@pytest.mark.parametrize("n_subs,seed", [(2000, 0), (5000, 3)])
def test_compile_parity(n_subs, seed):
    ref = compile_tries(jw.config_wildcard(n_subs, seed=seed))
    got = ta.compile_tries(tw.config_wildcard(n_subs, seed=seed))
    for f in ("node_tab", "edge_tab", "child_list"):
        a, b = getattr(ref, f), getattr(got, f)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), f
    assert ref.salt == got.salt and ref.tenant_root == got.tenant_root
    assert [_norm(m) for m in ref.matchings] == \
        [_norm(m) for m in got.matchings]
    assert (ref.slot_kind == got.slot_kind).all()


def test_workload_generators_draw_the_same_sequence():
    assert jw.probe_topics(50, seed=4) == tw.probe_topics(50, seed=4)
    assert jw.diverse_topics(50, seed=4) == tw.diverse_topics(50, seed=4)


def test_device_trie_from_numpy_walks_reference_tables():
    ct = compile_tries(jw.config_wildcard(3000, seed=5))
    jdev = jm.DeviceTrie.from_compiled(ct)
    arrays = {k: np.asarray(getattr(jdev, k)) for k in TRIE_LEAVES}
    dev = device_trie_from_numpy(arrays, device="cpu")
    for k in TRIE_LEAVES:
        assert (getattr(dev, k).numpy() == arrays[k]).all(), k
    topics = ["/".join(t) for t in jw.probe_topics(100, seed=8)]
    tok = tokenize(topics, [ct.root_of("tenant0")] * 100, max_levels=16,
                   salt=ct.salt, batch=128)
    kw = dict(probe_len=ct.probe_len, k_states=16, max_intervals=16)
    ref = jm.walk_routes(jdev, jm.Probes.from_tokenized(tok), esc_k=0, **kw)
    got = tm.walk_routes(dev, tm.Probes.from_tokenized(tok, "cpu"), esc_k=0,
                         **kw)
    for f in ("start", "count", "n_routes", "overflow"):
        assert (np.asarray(getattr(ref, f))
                == getattr(got, f).numpy()).all(), f


def test_device_trie_from_numpy_rejects_bad_leaves():
    ct = compile_tries(jw.config_wildcard(100, seed=1))
    jdev = jm.DeviceTrie.from_compiled(ct)
    arrays = {k: np.asarray(getattr(jdev, k)) for k in TRIE_LEAVES}
    with pytest.raises(KeyError):
        device_trie_from_numpy({k: v for k, v in arrays.items()
                                if k != "route_tab"}, device="cpu")
    bad = dict(arrays, edge_tab=arrays["edge_tab"].astype(np.int64))
    with pytest.raises(ValueError):
        device_trie_from_numpy(bad, device="cpu")
    assert isinstance(device_trie_from_numpy(arrays, device="cpu").route_tab,
                      torch.Tensor)
