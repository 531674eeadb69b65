#!/usr/bin/env python3
"""Time the patch plane's bucket choice two ways on the host CPU.

Usage: ``python3 scripts/torch_bucket_of_ab.py [N_SUBS] [ROUNDS]``
(defaults 20000 and 5). It needs no card: the matcher runs on the CPU.

It loads the routes of ``config_wildcard(N_SUBS, seed=0)`` (bench.py
config 7's population, cut to ``N_SUBS``) one ``add_route`` at a time
into a ``TorchMatcher(device="cpu")``, each folded into the installed
``PatchableTrie`` as the dist plane's subscribes are, and records every
``PatchableTrie._bucket_of(nid, h1, h2)`` call the load makes. Then it
times those calls under two mixers, alternating their order each round
(A, B, B, A, ...):

- ``int``: ``_mix_u32_int`` on Python ints, as the port ships it;
- ``numpy``: ``_mix_u32`` on three one-element numpy arrays, the
  reference's ``_bucket_of``.

Both must choose the same bucket for every call. It prints one JSON line:
the calls per route, each mixer's median microseconds per call, and what
the difference comes to for 200K routes loaded the same way.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    n_subs = int(sys.argv[1]) if len(sys.argv) > 1 else 20_000
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    import numpy as np

    from bifromq_tpu_torch import workloads
    from bifromq_tpu_torch.models import automaton
    from bifromq_tpu_torch.models.matcher import TorchMatcher

    calls = []
    shipped = automaton.PatchableTrie._bucket_of

    def recording(self, nid, h1, h2):
        calls.append((nid, h1, h2, self.edge_tab.shape[0] - 1))
        return shipped(self, nid, h1, h2)

    m = TorchMatcher(device="cpu")
    routes = [(t, r) for t, trie in workloads.config_wildcard(
        n_subs, seed=0).items() for r in trie.routes()]
    m.add_route(*routes[0])
    m.match_batch([(routes[0][0], "warm")])     # installs the base
    automaton.PatchableTrie._bucket_of = recording
    try:
        t0 = time.perf_counter()
        for t, r in routes[1:]:
            m.add_route(t, r)
        load_s = time.perf_counter() - t0
    finally:
        automaton.PatchableTrie._bucket_of = shipped
    assert calls, "the load made no bucket choice: nothing was patched"

    def mix_int():
        return [automaton._mix_u32_int(n, a, b) & mask
                for n, a, b, mask in calls]

    def mix_numpy():
        return [int(automaton._mix_u32(
            np.array([n], np.int32), np.array([a], np.int32),
            np.array([b], np.int32))[0] & np.uint32(mask))
            for n, a, b, mask in calls]

    assert mix_int() == mix_numpy(), "the two mixers disagree"
    times = {"int": [], "numpy": []}
    for k in range(rounds):
        order = ("int", "numpy") if k % 2 == 0 else ("numpy", "int")
        for name in order:
            fn = mix_int if name == "int" else mix_numpy
            t0 = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - t0) / len(calls))
    us = {k: statistics.median(v) * 1e6 for k, v in times.items()}
    per_route = len(calls) / (len(routes) - 1)
    print(json.dumps({
        "subs": n_subs, "routes_loaded": len(routes) - 1,
        "bucket_of_calls": len(calls),
        "calls_per_route": per_route,
        "load_s": load_s,
        "us_per_call_int": us["int"], "us_per_call_numpy": us["numpy"],
        "saved_s_at_200k": (us["numpy"] - us["int"]) * 1e-6
        * per_route * 200_000,
        "rounds": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
