#!/usr/bin/env python3
"""Time the prepare stage of one pipelined batch under three ways of
moving its host arrays to the card.

Usage: ``python3 scripts/torch_upload_ab.py [ROUNDS]`` on a machine with a
CUDA card (default 10 rounds). On ``config_wildcard(20_000, seed=0)`` it
times ``TorchMatcher._prepare_probes`` for 16-topic batches of
``probe_topics(seed=1)`` (pack on the host, the uploads, the K1 launch),
the pipelined leg's batch shape, with the uploads done by:

- ``staged``: ``utils/device.upload`` as the port ships it: a batch's
  arrays in one pinned buffer, one ``non_blocking`` copy;
- ``pinned``: each array pinned and copied ``non_blocking`` on its own;
- ``pageable``: each array copied with ``.to(device)``, which PyTorch
  follows with a stream synchronize.

Each variant is timed on an idle card (``idle_us``: the card has drained
before every call) and behind ~2 ms of queued device work
(``busy_us``: a sleep kernel is enqueued just before the call, as when
the batch before it is still on the card). Rounds alternate the
variants' order; the medians over rounds of each round's median are
printed as one JSON line with the card's name and power limit. Every
variant's probes are checked equal to the staged ones.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 200
BUSY_CYCLES = 4_000_000     # ~2 ms at 1.98 GHz


def main() -> int:
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_upload_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from bifromq_tpu_torch import workloads
    from bifromq_tpu_torch.models.matcher import TorchMatcher
    from bifromq_tpu_torch.ops import match as M
    from bifromq_tpu_torch.ops import tokenize as T
    from bifromq_tpu_torch.utils.device import upload
    from chip_smoke import smi_line

    def pinned(arrays, device):
        return [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                .to(device, non_blocking=True) for a in arrays]

    def pageable(arrays, device):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in arrays]

    variants = {"staged": upload, "pinned": pinned, "pageable": pageable}
    m = TorchMatcher.from_tries(workloads.config_wildcard(20_000, seed=0),
                                device="cuda", match_cache=False,
                                auto_compact=False)
    topics = ["/".join(t) for t in workloads.probe_topics(16 * CALLS,
                                                          seed=1)]
    batches = [[("tenant0", t) for t in topics[i * 16:(i + 1) * 16]]
               for i in range(CALLS)]

    def use(fn):
        T.upload = M.upload = fn

    def probes_of(fn):
        use(fn)
        p = m._prepare_probes(batches[0], 16).probes
        torch.cuda.synchronize()
        return [p.tok_h1, p.tok_h2, p.lengths, p.roots, p.sys_mask]

    want = probes_of(upload)
    for name, fn in variants.items():
        got = probes_of(fn)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            print(f"torch_upload_ab: {name} probes differ", file=sys.stderr)
            return 1

    def one_round(fn, busy: bool) -> float:
        use(fn)
        times = []
        for b in batches:
            torch.cuda.synchronize()
            if busy:
                torch.cuda._sleep(BUSY_CYCLES)
            t0 = time.perf_counter()
            m._prepare_probes(b, 16)
            times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return statistics.median(times) * 1e6

    res = {name: {"idle_us": [], "busy_us": []} for name in variants}
    order = list(variants)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            for busy in (False, True):
                res[name]["busy_us" if busy else "idle_us"].append(
                    one_round(variants[name], busy))
    use(upload)
    out = {name: {k: statistics.median(v) for k, v in d.items()}
           for name, d in res.items()}
    print(json.dumps({"script": "torch_upload_ab", "card": smi_line(),
                      "rounds": rounds, "calls_per_round": CALLS,
                      "busy_cycles": BUSY_CYCLES, "median": out,
                      "rounds_us": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
