#!/usr/bin/env python3
"""Drive bifromq_tpu_torch's publish -> match -> fan-out path on one CUDA card.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with an NVIDIA H100 and the CUDA toolkit. The script

1. builds the three CUDA kernels from ``bifromq_tpu_torch/csrc`` (one
   ``nvcc`` per source, started together) into ``build/kernels/``;
2. compiles BASELINE config 2 (one tenant, 1M Zipf wildcard
   subscriptions, ``workloads.config_wildcard(1_000_000, seed=0)``) and
   uploads its automaton to the card;
3. holds each kernel against its plain PyTorch version on the card, at
   the main path's shapes, with exact equality (every output is an
   integer or a bool), and times kernel, plain version and (for the
   expansion) ``torch.searchsorted`` with CUDA events;
4. serves 3 ``match_batch`` calls of 4096 topic strings through
   ``TorchMatcher`` — the main path — with the kernels' launch counts
   reset just before and read just after, and checks 256 rows of each
   batch against the host oracle; then times one more batch stage by
   stage (prepare, dispatch, fetch, host expansion);
5. serves a 100K-subscription tenant whose deliverer keys name 8 servers
   and checks the device's per-peer buckets against the host bucketing.

It prints the card's name and power limit, one ``{"kernels": [...]}``
line and, last, ``{"ok": true, "device": {...}}``. Any failure exits
non-zero without the last line; so does a machine with no CUDA card or
a directory without the package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

B_CHECK = 16384          # the bench's default batch (bench.py BENCH_BATCH)
B_SERVE = 4096
N_SUBS = 1_000_000       # BASELINE config 2
N_PEER_SUBS = 100_000
N_SERVE_BATCHES = 3
ORACLE_SAMPLE = 256
# H100 SXM published peaks (NVIDIA H100 datasheet): HBM bytes/s, and
# the 67 TFLOP/s float32 non-tensor rate, used for 32-bit integer ops
HBM_BPS = 3.35e12
INT32_OPS = 67e12


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable: {e!r}"


def time_ms(torch, fn, iters: int, warm: int = 2) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(torch, got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != "
                                 f"{tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def canon(m):
    return (sorted((r.matcher.mqtt_topic_filter, r.receiver_url)
                   for r in m.normal),
            {f: sorted(r.receiver_url for r in ms)
             for f, ms in m.groups.items()})


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: this script runs only on the card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from bifromq_tpu_torch import workloads
        from bifromq_tpu_torch.models import kernels as K
        from bifromq_tpu_torch.models.bytetok import TopicBytes
        from bifromq_tpu_torch.models.matcher import TorchMatcher
        from bifromq_tpu_torch.models.oracle import UNCAPPED_FANOUT
        from bifromq_tpu_torch.ops import match as M
        from bifromq_tpu_torch.ops import tokenize as T
        from bifromq_tpu_torch.utils import device as D
    except ImportError as e:
        return fail(f"the bifromq_tpu_torch package is missing: {e!r}")

    dev = torch.device("cuda")
    smi = smi_line()
    print(smi, flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)

    t0 = time.perf_counter()
    D.build_all()
    print(json.dumps({"phase": "build",
                      "seconds": time.perf_counter() - t0}), flush=True)

    t0 = time.perf_counter()
    tries = workloads.config_wildcard(N_SUBS, seed=0)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m = TorchMatcher.from_tries(tries, device=dev)
    ct, trie = m.compiled, m.device_trie
    print(json.dumps({"phase": "compile", "subs": N_SUBS,
                      "nodes": int(ct.n_nodes), "slots": int(ct.n_slots),
                      "generate_s": gen_s,
                      "compile_s": time.perf_counter() - t0}), flush=True)
    root = ct.root_of("tenant0")
    rows = {}

    # ---- K1: BLAKE2b level hashing ----------------------------------------
    k1_err, k1 = 0, None
    for name, topics in (
            ("probe_topics", ["/".join(t) for t in
                              workloads.probe_topics(B_CHECK, seed=1)]),
            ("diverse_topics", workloads.diverse_topics(B_CHECK, seed=0))):
        tb = TopicBytes.from_topics(topics)
        lengths, _, _, rows_b, starts, lens = T.pack_topic_bytes(
            tb, [root] * B_CHECK, max_levels=ct.max_levels, batch=B_CHECK)
        args = [torch.from_numpy(a).to(dev) for a in
                (rows_b, starts, lens, lengths.reshape(B_CHECK, 1))]
        args.append(T.h0_tensor(ct.salt, dev))
        got = T.blake2b_levels(*args)
        want = T._hash_lanes(*args)
        torch.cuda.synchronize()
        k1_err = max(k1_err, max_abs_err(torch, got, want))
        if name == "probe_topics":
            live = int((torch.from_numpy(lengths).clamp(min=0)).sum())
            b, mb = rows_b.shape
            w = starts.shape[1]
            k1 = dict(
                args=args, live=live,
                bytes=b * mb + 2 * b * w * 4 + b * 4 + 64 + 2 * b * w * 4,
                # 12 rounds x 8 G x 14 64-bit ops, 2 32-bit ops each
                ops=live * 12 * 8 * 14 * 2)
    if k1_err:
        return fail(f"K1 blake2b_levels differs from _hash_lanes: {k1_err}")
    k1["ms"] = time_ms(torch, lambda: T.blake2b_levels(*k1["args"]), 50)
    k1["plain_ms"] = time_ms(torch, lambda: T._hash_lanes(*k1["args"]), 3, 1)
    rows["blake2b_levels"] = k1
    print(json.dumps({"phase": "K1", "max_abs_err": k1_err,
                      "ms": k1["ms"], "plain_ms": k1["plain_ms"]}),
          flush=True)

    # ---- K2: fused interval walk ------------------------------------------
    topics = ["/".join(t) for t in workloads.probe_topics(B_CHECK, seed=1)]
    _, probes = T.device_tokenize(TopicBytes.from_topics(topics),
                                  [root] * B_CHECK,
                                  max_levels=ct.max_levels, salt=ct.salt,
                                  batch=B_CHECK, device=dev)
    k2_err = 0
    walk32 = None
    for k_states, a in ((32, 32), (128, 128)):
        kw = dict(probe_len=ct.probe_len, k_states=k_states,
                  max_intervals=a)
        got = K.fused_walk_routes(trie, probes, **kw)
        want = M.walk_routes(trie, probes, esc_k=0, **kw)
        torch.cuda.synchronize()
        fields = ("start", "count", "n_routes", "overflow")
        err = max_abs_err(torch, [getattr(got, f) for f in fields],
                          [getattr(want, f) for f in fields])
        k2_err = max(k2_err, err)
        print(json.dumps({"phase": "K2", "K": k_states, "A": a,
                          "max_abs_err": err,
                          "overflow_rows": int(got.overflow.sum()),
                          "routes_per_topic":
                              float(got.n_routes.float().mean())}),
              flush=True)
        if k_states == 32:
            walk32 = got
    if k2_err:
        return fail(f"K2 fused_walk_routes differs from walk_routes: {k2_err}")
    kw = dict(probe_len=ct.probe_len, k_states=32, max_intervals=32)
    visits = {"rows": [], "buckets": []}
    M._route_walk(trie, probes, ct.probe_len, 32, 32, visits=visits)
    n_row_v = sum(int(v.numel()) for v in visits["rows"])
    n_bkt_v = sum(int(v.numel()) for v in visits["buckets"])
    u_rows = int(torch.unique(torch.cat(visits["rows"])).numel())
    u_bkts = int(torch.unique(torch.cat(visits["buckets"])).numel())
    w = probes.tok_h1.shape[1]
    rows["fused_walk"] = dict(
        bytes=(u_rows * M.RT_COLS * 4 + u_bkts * ct.probe_len * 16
               + B_CHECK * (2 * w * 4 + 4 + 4 + 1)
               + B_CHECK * (2 * 32 * 4 + 4 + 1)),
        ops=n_bkt_v * ct.probe_len * 4 + n_row_v * 8,
        ms=time_ms(torch, lambda: K.fused_walk_routes(trie, probes, **kw),
                   20),
        plain_ms=time_ms(torch, lambda: M.walk_routes(
            trie, probes, esc_k=0, **kw), 3, 1))
    print(json.dumps({"phase": "K2-time", "ms": rows["fused_walk"]["ms"],
                      "plain_ms": rows["fused_walk"]["plain_ms"],
                      "unique_rows": u_rows, "unique_buckets": u_bkts}),
          flush=True)

    # ---- K3: ragged-arange expansion --------------------------------------
    cap = B_CHECK * M.expand_cap_lanes()
    serve_c = torch.where(walk32.overflow[:, None], 0, walk32.count)
    ivl_s = walk32.start
    got = K.kernel_expand(ivl_s, serve_c, cap=cap)
    want = M._expand_pairs(ivl_s, serve_c, cap)
    torch.cuda.synchronize()
    k3_err = max_abs_err(torch, got, want)
    if k3_err:
        return fail(f"K3 kernel_expand differs from _expand_pairs: {k3_err}")
    _, ends, _, _, _ = M._expand_prefix(ivl_s, serve_c, cap)
    j = torch.arange(cap, dtype=torch.int32, device=dev)
    n = ends.numel()
    rows["expand_pairs"] = dict(
        bytes=3 * n * 4 + 2 * cap * 4,
        ops=cap * (n.bit_length() * 3 + 6),
        ms=time_ms(torch, lambda: K.kernel_expand(ivl_s, serve_c, cap=cap),
                   50),
        plain_ms=time_ms(torch, lambda: M._expand_pairs(ivl_s, serve_c,
                                                        cap), 10),
        library_ms=time_ms(torch, lambda: torch.searchsorted(
            ends, j, right=True), 50))
    print(json.dumps({"phase": "K3", "max_abs_err": k3_err,
                      "n_pairs": int(got[3]), "trunc_rows":
                          int(got[4].sum()),
                      "ms": rows["expand_pairs"]["ms"]}), flush=True)

    # ---- serve: the main path ---------------------------------------------
    D.reset_launches()
    serve = []
    for s in range(N_SERVE_BATCHES):
        topics = ["/".join(t) for t in
                  workloads.probe_topics(B_SERVE, seed=100 + s)]
        queries = [("tenant0", t) for t in topics]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = m.match_batch(queries)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        pairs, _ = m.last_expanded
        sample = list(range(0, B_SERVE, B_SERVE // ORACLE_SAMPLE))
        oracle = m.match_from_tries([queries[i] for i in sample])
        bad = [i for i, o in zip(sample, oracle) if canon(res[i]) != canon(o)]
        if bad:
            return fail(f"serve batch {s}: rows {bad[:8]} differ from the "
                        f"host oracle")
        n_routes = sum(len(r.all_routes()) for r in res)
        serve.append({"batch_ms": ms, "routes_per_topic": n_routes / B_SERVE,
                      "walk_overflow_rows": int(pairs.res.overflow.sum()),
                      "trunc_rows": int(pairs.trunc[:B_SERVE].sum()),
                      "oracle_rows_checked": len(sample)})
    launches = {k: v.launches for k, v in D.KERNELS.items()}
    print(json.dumps({"phase": "serve", "subs": N_SUBS, "batch": B_SERVE,
                      "card": smi, "batches": serve,
                      "launches": launches}), flush=True)
    missing = [k for k, v in launches.items() if not v]
    if missing:
        return fail(f"the main path did not launch {missing}")

    # ---- where one served batch's time goes: match_batch's four stages,
    # each bracketed by a device synchronize
    queries = [("tenant0", "/".join(t)) for t in
               workloads.probe_topics(B_SERVE, seed=200)]
    stages = {}

    def staged(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out

    fl = staged("dispatch_ms", m._dispatch_prepared,
                staged("prepare_ms", m._prepare_probes, queries))
    overflow, pairs = staged("fetch_ms", m._fetch_walk, fl.res)
    staged("expand_walk_ms", m._expand_walk, fl, overflow, pairs,
           UNCAPPED_FANOUT, UNCAPPED_FANOUT)
    print(json.dumps({"phase": "stages", "batch": B_SERVE, "card": smi,
                      **stages}), flush=True)

    # ---- peers: per-peer bucketing on the card ----------------------------
    t0 = time.perf_counter()
    mp = TorchMatcher.from_tries(workloads.config_wildcard(
        N_PEER_SUBS, seed=0, deliverer_key=lambda i: f"srv{i % 8}|d{i}"),
        device=dev)
    topics = ["/".join(t) for t in workloads.probe_topics(B_SERVE, seed=7)]
    queries = [("tenant0", t) for t in topics]
    D.reset_launches()
    res = mp.match_batch(queries)
    peer_launches = {k: v.launches for k, v in D.KERNELS.items()}
    pairs, peer_tab = mp.last_expanded
    if peer_tab.n_peers != 8:
        return fail(f"peer table has {peer_tab.n_peers} peers, expected 8")
    hs, hr, ho = M.bucket_pairs_host(pairs.slots, pairs.rows,
                                     peer_tab.slot_peer, peer_tab.n_peers)
    import numpy as np
    if not (np.array_equal(hs, pairs.peer_slots)
            and np.array_equal(hr, pairs.peer_rows)
            and np.array_equal(ho, pairs.peer_offsets)):
        return fail("device peer buckets differ from bucket_pairs_host")
    sample = list(range(0, B_SERVE, B_SERVE // ORACLE_SAMPLE))
    oracle = mp.match_from_tries([queries[i] for i in sample])
    if any(canon(res[i]) != canon(o) for i, o in zip(sample, oracle)):
        return fail("peer serve differs from the host oracle")
    print(json.dumps({"phase": "peers", "subs": N_PEER_SUBS,
                      "n_peers": peer_tab.n_peers,
                      "bucket_sizes": np.diff(pairs.peer_offsets).tolist(),
                      "launches": peer_launches,
                      "seconds": time.perf_counter() - t0}), flush=True)

    # ---- the kernels line -------------------------------------------------
    meta = {
        "blake2b_levels": ("blake2b_levels.cu",
                           "bifromq_tpu/ops/tokenize.py:205", k1_err),
        "fused_walk": ("fused_walk.cu",
                       "bifromq_tpu/models/kernels.py:153", k2_err),
        "expand_pairs": ("expand.cu",
                         "bifromq_tpu/models/kernels.py:246", k3_err),
    }
    out = []
    for name, (src, replaces, err) in meta.items():
        r = rows[name]
        t_bytes = r["bytes"] / HBM_BPS * 1e3
        t_ops = r["ops"] / INT32_OPS * 1e3
        out.append({"name": name, "route": "cuda",
                    "source": f"bifromq_tpu_torch/csrc/{src}",
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": err, "ms": r["ms"],
                    "plain_ms": r["plain_ms"],
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops
                    else "operations",
                    "library_ms": r.get("library_ms")})
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:  # noqa: BLE001 — report, then exit non-zero
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
