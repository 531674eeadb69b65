"""Workload generators (copy of the config-2, config-4 and config-5 parts
of ``bifromq_tpu/workloads.py``).

- ``config_wildcard``: BASELINE config 2, one tenant with wildcard-heavy
  Zipf subscriptions (1M by default).
- ``config_multi_tenant``: BASELINE config 5, 10K tenants with Zipf
  sizes summing to 10M subscriptions, for the tenant-sharded mesh.
- ``config_retained``: BASELINE config 4, one tenant's concrete retained
  topics (5M by default), probed by ``probe_filters``' wildcard
  SUBSCRIBE filters.
- ``probe_topics``: concrete PUBLISH topics drawn from the same Zipf tree.
- ``diverse_topics``: topic strings with realistic shapes (deep paths,
  multi-byte UTF-8, empty levels, ``$SYS`` roots).

Generation is deterministic per seed and draws the same ``random.Random``
sequence as the reference generators, so both packages build identical
tries and topics from one seed.
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence, Tuple

from .models.oracle import Route, SubscriptionTrie
from .types import RouteMatcher, RouteMatcherType
from .utils import topic as topic_util


def _zipf_levels(n_levels: int) -> Tuple[List[str], List[float]]:
    """Returns (names, CUMULATIVE weights) — cumulative so random.choices
    skips its per-call accumulate pass."""
    names = [f"l{i}" for i in range(n_levels)]
    acc, cum = 0.0, []
    for i in range(n_levels):
        acc += 1.0 / (i + 1)
        cum.append(acc)
    return names, cum


def _mk_matcher(levels: Sequence[str]) -> RouteMatcher:
    return RouteMatcher(type=RouteMatcherType.NORMAL,
                        filter_levels=tuple(levels),
                        mqtt_topic_filter="/".join(levels))


def gen_filter_levels(rng: random.Random, names: List[str],
                      weights: List[float], *, max_depth: int = 6,
                      p_plus: float = 0.15, p_hash: float = 0.1) -> List[str]:
    depth = rng.randint(1, max_depth)
    levels = rng.choices(names, cum_weights=weights, k=depth)
    for j in range(depth):
        if rng.random() < p_plus:
            levels[j] = topic_util.SINGLE_WILDCARD
    if rng.random() < p_hash:
        levels.append(topic_util.MULTI_WILDCARD)
    return levels


def gen_topic_levels(rng: random.Random, names: List[str],
                     weights: List[float], *, max_depth: int = 6) -> List[str]:
    depth = rng.randint(1, max_depth)
    return rng.choices(names, cum_weights=weights, k=depth)


def config_wildcard(n_subs: int = 1_000_000, *, seed: int = 0,
                    n_level_names: int = 1000, max_depth: int = 6,
                    persistent_ratio: float = 0.1,
                    deliverer_key=lambda i: f"d{i % 64}"
                    ) -> Dict[str, SubscriptionTrie]:
    """Config 2: one tenant, wildcard-heavy Zipf subscriptions.

    ``deliverer_key(i)`` names subscription ``i``'s delivery target; the
    default is the reference's ``d{i % 64}`` (no server prefix, so every
    slot falls in the UNKNOWN peer bucket)."""
    rng = random.Random(seed)
    names, weights = _zipf_levels(n_level_names)
    trie = SubscriptionTrie()
    for i in range(n_subs):
        levels = gen_filter_levels(rng, names, weights, max_depth=max_depth)
        broker = 1 if rng.random() < persistent_ratio else 0
        trie.add(Route(matcher=_mk_matcher(levels), broker_id=broker,
                       receiver_id=f"r{i}", deliverer_key=deliverer_key(i)))
    return {"tenant0": trie}


def config_multi_tenant(n_tenants: int = 10_000, total_subs: int = 10_000_000,
                        *, seed: int = 0,
                        deliverer_key=lambda t, i: f"d{i % 64}"
                        ) -> Dict[str, SubscriptionTrie]:
    """Config 5: tenant-sharded: Zipf tenant sizes summing to total_subs.

    ``deliverer_key(t, i)`` names the delivery target of tenant ``t``'s
    subscription ``i``; the default is the reference's ``d{i % 64}``."""
    rng = random.Random(seed)
    names, weights = _zipf_levels(1000)
    tenant_weights = [1.0 / (i + 1) for i in range(n_tenants)]
    wsum = sum(tenant_weights)
    out: Dict[str, SubscriptionTrie] = {}
    for t in range(n_tenants):
        n = max(1, int(total_subs * tenant_weights[t] / wsum))
        trie = SubscriptionTrie()
        for i in range(n):
            levels = gen_filter_levels(rng, names, weights)
            trie.add(Route(matcher=_mk_matcher(levels), broker_id=0,
                           receiver_id=f"t{t}r{i}",
                           deliverer_key=deliverer_key(t, i)))
        out[f"tenant{t}"] = trie
    return out


def config_retained(n_topics: int = 5_000_000, *, seed: int = 0,
                    n_level_names: int = 1000, max_depth: int = 6
                    ) -> Dict[str, List[List[str]]]:
    """Config 4: the retained-message store, unique concrete topics of
    one tenant (level lists), which wildcard FILTERS probe."""
    rng = random.Random(seed)
    names, weights = _zipf_levels(n_level_names)
    seen = set()
    topics: List[List[str]] = []
    for i in range(n_topics):
        levels = gen_topic_levels(rng, names, weights, max_depth=max_depth)
        if tuple(levels) in seen:
            # disambiguate with a device-id tail (per-device leaves under
            # shared prefixes); may exceed max_depth by one level
            levels = levels + [f"d{i}"]
        seen.add(tuple(levels))
        topics.append(levels)
    return {"tenant0": topics}


def probe_filters(n: int, *, seed: int = 2, n_level_names: int = 1000,
                  max_depth: int = 6) -> List[List[str]]:
    """Wildcard SUBSCRIBE filters probing the retained store (config 4)."""
    rng = random.Random(seed)
    names, weights = _zipf_levels(n_level_names)
    return [gen_filter_levels(rng, names, weights, max_depth=max_depth)
            for _ in range(n)]


def probe_topics(n: int, *, seed: int = 1, n_level_names: int = 1000,
                 max_depth: int = 6) -> List[List[str]]:
    """Concrete PUBLISH topics drawn from the same Zipf tree."""
    rng = random.Random(seed)
    names, weights = _zipf_levels(n_level_names)
    return [gen_topic_levels(rng, names, weights, max_depth=max_depth)
            for _ in range(n)]


# ---------------------- topic-diversity generator --------------------------

TENANT_TOPIC_PROFILES: dict = {
    # flat sensor telemetry: shallow, short ASCII levels, numeric leaf
    "telemetry": dict(weight=0.40, depth=(3, 6), seg_len=(3, 10),
                      unicode_p=0.0, numeric_leaf_p=0.8, sys_p=0.0),
    # fleet/vehicle: deep paths, mid-size levels, uuid-ish leaves
    "fleet": dict(weight=0.25, depth=(6, 12), seg_len=(6, 18),
                  unicode_p=0.02, numeric_leaf_p=0.5, sys_p=0.0),
    # retail/i18n: shallow but multi-byte-UTF-8-heavy long levels
    "retail_i18n": dict(weight=0.20, depth=(2, 5), seg_len=(4, 24),
                        unicode_p=0.6, numeric_leaf_p=0.1, sys_p=0.0),
    # operational $SYS streams (exercises the sys-root walk rule)
    "sysmon": dict(weight=0.05, depth=(2, 4), seg_len=(4, 12),
                   unicode_p=0.0, numeric_leaf_p=0.0, sys_p=1.0),
    # adversarial edge: empty levels / separator runs / deep shapes
    "edge": dict(weight=0.10, depth=(1, 15), seg_len=(0, 8),
                 unicode_p=0.1, numeric_leaf_p=0.2, sys_p=0.0),
}

_UNICODE_SEGS = ["日本語", "センサー", "größe", "müller", "caféteria",
                 "датчик", "température", "aßßen", "चैनल", "중계기"]
_ASCII = "abcdefghijklmnopqrstuvwxyz"


def diverse_topics(n: int, *, seed: int = 0,
                   profiles: dict = None) -> List[str]:
    """``n`` topic STRINGS drawn from the tenant profiles above.
    Deterministic per seed."""
    rng = random.Random(seed)
    profs = profiles or TENANT_TOPIC_PROFILES
    names = list(profs)
    cum: List[float] = []
    acc = 0.0
    for p in names:
        acc += profs[p]["weight"]
        cum.append(acc)
    out: List[str] = []
    for _ in range(n):
        p = profs[rng.choices(names, cum_weights=cum, k=1)[0]]
        depth = rng.randint(*p["depth"])
        levels: List[str] = []
        for j in range(depth):
            lo, hi = p["seg_len"]
            seg_len = rng.randint(lo, hi)
            if seg_len == 0:
                levels.append("")       # empty level / separator run
            elif rng.random() < p["unicode_p"]:
                levels.append(rng.choice(_UNICODE_SEGS))
            else:
                levels.append("".join(rng.choice(_ASCII)
                                      for _ in range(seg_len)))
        if p["sys_p"] and rng.random() < p["sys_p"]:
            levels.insert(0, "$SYS")
        if levels and rng.random() < p["numeric_leaf_p"]:
            levels.append(f"d{rng.randrange(1 << 20)}")
        out.append("/".join(levels) if levels else "x")
    return out


# ------------------- seeded adversarial kernel inputs ----------------------
# Not reference workloads: inputs that drive the port's kernels through
# their rare paths, for the parity checks on the card and on the CPU.

def hash_edge_topics(n: int, *, max_levels: int = 16, max_bytes: int = 256,
                     seed: int = 0) -> List[str]:
    """``n`` topic strings for the level hash's edge cases: a 128-byte
    level and one over a block (a padding row), empty levels, a row at
    ``max_levels`` and one past it, a level that ends on the row's last
    byte (byte ``max_bytes - 1``), a row past the byte budget, ``$``
    topics, multi-byte UTF-8, then seeded random rows of short levels at
    every byte alignment. Deterministic per seed."""
    last = "y" * 128                           # ends at byte max_bytes - 1
    fill = max_bytes - len(last) - 1
    head = "/".join("x" * min(128, fill - 129 * i)
                    for i in range(-(-fill // 129))) if fill > 0 else ""
    fixed = ["q" * 128 + "/a", "z" * 129, "", "/", "//", "a//b",
             "trailing/", "/leading", "/".join(["l"] * max_levels),
             "/".join(["l"] * (max_levels + 1)),
             (head + "/" + last) if head else last,
             "p" * (max_bytes + 1), "$SYS/health/cpu", "$share/g/t", "$x",
             "é" * 64, "日本語/датчик//température"]
    rng = random.Random(seed)
    segs = ["", "a", "bb", "ccc", "sensor", "$SYS", "日本語", "x" * 40,
            "d" * 127, "0123456789abcdef"]
    out = fixed[:n]
    while len(out) < n:
        depth = rng.randint(1, max_levels)
        out.append("/".join(rng.choice(segs) if rng.random() < 0.3 else
                            "k" * rng.randint(0, 20) for _ in range(depth)))
    return out


def dense_walk_tables(seed: int, *, n_nodes: int = 128,
                      n_buckets: int = 64, probe_len: int = 16,
                      n_tokens: int = 4, batch: int = 256,
                      depth: int = 10):
    """A seeded synthetic automaton and probe batch for the walk: every
    bucket of the ``[n_buckets, probe_len, 4]`` edge table holds
    ``probe_len`` entries (real edges, repeated keys with other children,
    and decoys that share the bucket and part of a key), most nodes have
    a '+' child, so rows of ``depth`` levels widen past any K and reach
    the sorted compaction and the state and interval overflows.

    Returns a dict of int32 numpy arrays (``sys_mask`` bool):
    ``edge_tab``, ``route_tab`` ``[n_nodes, 8]`` (the ``route_tab``
    columns of ``ops.match``), and ``tok_h1``/``tok_h2``
    ``[batch, depth + 1]``, ``lengths``, ``roots``, ``sys_mask``
    ``[batch]``."""
    import numpy as np
    from .models.automaton import _mix_u32
    rng = np.random.default_rng(seed)
    mask = np.uint32(n_buckets - 1)
    tok = rng.integers(-2**31, 2**31, (n_tokens, 2)).astype(np.int32)
    # real edges: (node, token) -> child, nine in ten pairs
    node, t = (x.ravel() for x in np.meshgrid(np.arange(n_nodes),
                                              np.arange(n_tokens)))
    keep = rng.random(node.size) < 0.9
    keys = np.stack([node[keep], tok[t[keep], 0], tok[t[keep], 1],
                     rng.integers(0, n_nodes, keep.sum())], 1)
    keys = keys.astype(np.int32)
    # decoys: a real key with its h1 or h2 changed, or a random node
    dec = keys[rng.integers(0, len(keys), 40 * n_buckets * probe_len)]
    kind = rng.integers(0, 3, len(dec))
    dec[kind == 0, 1] ^= rng.integers(1, 1 << 30, (kind == 0).sum(),
                                      dtype=np.int32)
    dec[kind == 1, 2] ^= rng.integers(1, 1 << 30, (kind == 1).sum(),
                                      dtype=np.int32)
    dec[kind == 2, 0] = rng.integers(n_nodes, 2 * n_nodes,
                                     (kind == 2).sum())
    dec[:, 3] = rng.integers(0, n_nodes, len(dec))

    def bucket(k):
        return (_mix_u32(k[:, 0], k[:, 1], k[:, 2]) & mask).astype(np.int64)
    kb, db = bucket(keys), bucket(dec)
    edge_tab = np.empty((n_buckets, probe_len, 4), dtype=np.int32)
    for bk in range(n_buckets):
        real = keys[kb == bk][:probe_len - 4]
        again = real[rng.integers(0, len(real), 2)].copy() if len(real) \
            else np.empty((0, 4), np.int32)
        again[:, 3] = rng.integers(0, n_nodes, len(again))
        ent = np.concatenate([real, again, dec[db == bk]])[:probe_len]
        if len(ent) < probe_len:
            raise ValueError("too few decoys to fill a bucket; raise the "
                             "decoy count")
        edge_tab[bk] = ent[rng.permutation(probe_len)]
    route_tab = np.zeros((n_nodes, 8), dtype=np.int32)
    route_tab[:, 0] = np.where(rng.random(n_nodes) < 0.95,
                               rng.integers(0, n_nodes, n_nodes), -1)
    for cnt, start in ((1, 3), (2, 4)):          # '#'-child, own interval
        route_tab[:, cnt] = np.where(rng.random(n_nodes) < 0.3,
                                     rng.integers(1, 6, n_nodes), 0)
        route_tab[:, start] = rng.integers(0, 1 << 20, n_nodes)
    w = depth + 1
    levels = rng.integers(0, n_tokens, (batch, w))
    miss = rng.random((batch, w)) < 0.05
    tok_h1 = np.where(miss, rng.integers(-2**31, 2**31, (batch, w)),
                      tok[levels, 0]).astype(np.int32)
    tok_h2 = tok[levels, 1].astype(np.int32)
    lengths = rng.integers(0, depth + 1, batch).astype(np.int32)
    lengths[rng.random(batch) < 0.05] = -1
    return dict(edge_tab=edge_tab, route_tab=route_tab, tok_h1=tok_h1,
                tok_h2=tok_h2, lengths=lengths,
                roots=rng.integers(0, n_nodes, batch).astype(np.int32),
                sys_mask=rng.random(batch) < 0.1)
