#!/usr/bin/env python3
"""A/B the native host helpers against their numpy and Python legs
inside stage 3 (host expansion) of one served batch, on one card.

Usage: ``python3 scripts/torch_host_legs_ab.py [PAIRS]`` from the root of
a checkout, on a machine with a CUDA card. It builds BASELINE config 2
(``config_wildcard(1_000_000, seed=0)``) on ``TorchMatcher`` and config 5
cut to 2M subscriptions (``config_multi_tenant(10_000, 2_000_000,
seed=0)``) on ``TorchMeshMatcher`` over ``make_mesh(2, 4)``, match cache
off, serves one warm-up batch of each, then prepares, dispatches and
fetches one more 4096-query batch (config 2: ``probe_topics(4096,
seed=200)``; config 5: ``chip_smoke.config5_traffic``'s second batch) and
runs that batch's stage 3 (``_expand_walk``) PAIRS times (default 10)
with each of two legs, alternating which runs first:

- ``native``: the serving path as it is (``ops/match.expand_intervals``
  over ``csrc/host/expand.cpp``; the escalation's host rows through the
  native tokenizer);
- ``numpy``: ``expand_intervals`` replaced by ``expand_intervals_numpy``
  and ``tokenize`` by its ``native=False`` loop.

Every run starts from the same fetched buffers (a copy of the overflow
flags, which the escalation clears) and must serve the same routes. It
prints one JSON line with the card's name and power limit and every
run's milliseconds.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B_SERVE = 4096


def legs():
    """(name, patch) pairs; patch(on) swaps the leg in or out."""
    from bifromq_tpu_torch.models import automaton
    from bifromq_tpu_torch.ops import match
    from bifromq_tpu_torch.parallel import sharded
    native = (match.expand_intervals, automaton.tokenize)
    slow = (match.expand_intervals_numpy,
            functools.partial(automaton.tokenize, native=False))

    def use(pair):
        match.expand_intervals, automaton.tokenize = pair
        sharded.expand_intervals, sharded.tokenize = pair
    return {"native": lambda: use(native), "numpy": lambda: use(slow)}


def ab(torch, m, queries, pairs: int):
    from bifromq_tpu_torch.models.oracle import UNCAPPED_FANOUT
    m.match_batch(queries[0])                   # warm-up
    fl = m._dispatch_prepared(m._prepare_probes(queries[1]))
    overflow, fetched = m._fetch_walk(fl.res)
    torch.cuda.synchronize()
    switch = legs()
    runs = {"native": [], "numpy": []}
    want = None
    for i in range(pairs):
        order = ("native", "numpy") if i % 2 == 0 else ("numpy", "native")
        for name in order:
            switch[name]()
            t0 = time.perf_counter()
            rows = m._expand_walk(fl, overflow.copy(), fetched,
                                  UNCAPPED_FANOUT, UNCAPPED_FANOUT)
            runs[name].append((time.perf_counter() - t0) * 1e3)
            got = [len(r.all_routes()) for r in rows]
            if want is None:
                want = got
            elif got != want:
                raise AssertionError(f"leg {name} served other routes")
    switch["native"]()
    return {"routes": sum(want), "stage3_ms": runs}


def main() -> int:
    pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    import torch
    if not torch.cuda.is_available():
        print("torch_host_legs_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import config5_traffic, smi_line
    from bifromq_tpu_torch import workloads
    from bifromq_tpu_torch.models.matcher import TorchMatcher
    from bifromq_tpu_torch.parallel.sharded import TorchMeshMatcher, \
        make_mesh
    dev = torch.device("cuda")
    out = {"card": smi_line(), "pairs": pairs}
    m = TorchMatcher.from_tries(workloads.config_wildcard(1_000_000, seed=0),
                                device=dev, match_cache=False)
    out["config2"] = ab(torch, m, [
        [("tenant0", "/".join(t)) for t in
         workloads.probe_topics(B_SERVE, seed=s)] for s in (199, 200)],
        pairs)
    del m
    torch.cuda.empty_cache()
    tries = workloads.config_multi_tenant(10_000, 2_000_000, seed=0)
    mm = TorchMeshMatcher.from_tries(tries, mesh=make_mesh(2, 4, device=dev),
                                     match_cache=False)
    out["config5_mesh"] = ab(torch, mm, config5_traffic(tries, B_SERVE, 2),
                             pairs)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
