#!/usr/bin/env python3
"""Time the serving stages of one checkout of the port on one card, with
the host stages (prepare and host expansion) in focus.

Usage: ``python3 scripts/torch_host_stages_ab.py ROOT [BATCHES]`` on a
machine with a CUDA card, where ROOT is a checkout of this repository
(the working tree, or an older commit unpacked with ``git archive``).
The script imports ``bifromq_tpu_torch`` from ROOT and builds what it
needs, then serves, with the match cache off:

- BASELINE config 2 (``config_wildcard(1_000_000, seed=0)``) through
  ``TorchMatcher``: one warm-up batch, then BATCHES (default 4)
  ``match_batch``-sized batches of 4096 ``probe_topics`` (seeds 200...);
- BASELINE config 5 cut to 2M subscriptions
  (``config_multi_tenant(10_000, 2_000_000, seed=0)``) through
  ``TorchMeshMatcher`` on ``make_mesh(2, 4)``: one warm-up batch (it
  builds the peer tables), then BATCHES batches of 4096 config-5
  queries (``chip_smoke.config5_traffic``);

each batch timed stage by stage with a device synchronize around each
stage (prepare, dispatch, fetch, host expansion), as ``chip_smoke.py``'s
"stages" lines do. It prints one JSON line with the card's name and
power limit, every batch's stage times and a digest of the served
routes (the route count of every row), which must agree between
checkouts. To compare two checkouts, run it for each in one command, in
the order A, B, B, A.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B_SERVE = 4096


def staged_batch(torch, m, queries):
    """One batch through the matcher's four stages; returns the stage
    times (ms) and the served rows."""
    from bifromq_tpu_torch.models.oracle import UNCAPPED_FANOUT
    out = {}

    def staged(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3
        return res

    fl = staged("dispatch_ms", m._dispatch_prepared,
                staged("prepare_ms", m._prepare_probes, queries))
    overflow, pairs = staged("fetch_ms", m._fetch_walk, fl.res)
    rows = staged("expand_walk_ms", m._expand_walk, fl, overflow, pairs,
                  UNCAPPED_FANOUT, UNCAPPED_FANOUT)
    return out, rows


def serve(torch, m, batches):
    staged_batch(torch, m, batches[0])          # warm-up
    times, digest = [], hashlib.sha256()
    for q in batches[1:]:
        t, rows = staged_batch(torch, m, q)
        times.append(t)
        digest.update(json.dumps([len(r.all_routes()) for r in rows])
                      .encode())
    return {"batches": times, "routes_digest": digest.hexdigest()[:16]}


def main() -> int:
    root = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else HERE
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    import torch
    if not torch.cuda.is_available():
        print("torch_host_stages_ab: no CUDA device", file=sys.stderr)
        return 1
    # the helpers come from this checkout, the package from ROOT
    sys.path.insert(0, HERE)
    from chip_smoke import config5_traffic, smi_line
    sys.path.insert(0, root)
    import bifromq_tpu_torch
    from bifromq_tpu_torch import workloads
    from bifromq_tpu_torch.models.matcher import TorchMatcher
    from bifromq_tpu_torch.parallel.sharded import TorchMeshMatcher, \
        make_mesh
    from bifromq_tpu_torch.utils import device as D
    D.build_all()
    dev = torch.device("cuda")
    out = {"root": os.path.relpath(root, HERE), "card": smi_line(),
           "package": os.path.relpath(bifromq_tpu_torch.__file__, HERE)}

    t0 = time.perf_counter()
    m = TorchMatcher.from_tries(workloads.config_wildcard(1_000_000, seed=0),
                                device=dev, match_cache=False)
    out["config2_setup_s"] = time.perf_counter() - t0
    batches = [[("tenant0", "/".join(t)) for t in
                workloads.probe_topics(B_SERVE, seed=199 + i)]
               for i in range(n + 1)]
    out["config2"] = serve(torch, m, batches)
    del m
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    tries = workloads.config_multi_tenant(10_000, 2_000_000, seed=0)
    mm = TorchMeshMatcher.from_tries(tries, mesh=make_mesh(2, 4, device=dev),
                                     match_cache=False)
    out["config5_setup_s"] = time.perf_counter() - t0
    out["config5_mesh"] = serve(torch, mm, config5_traffic(tries, B_SERVE,
                                                           n + 1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
