#!/usr/bin/env python3
"""Drive bifromq_tpu_torch's serving paths on one CUDA card.

Usage: ``python3 chip_smoke.py [--mesh-subs N]`` from the repository
root, on a machine with an NVIDIA H100 and the CUDA toolkit
(``--mesh-subs`` sets config 5's subscriptions on the mesh path, 1M by
default; it measures what a deeper mesh phase costs). The script

1. builds the four CUDA kernels from ``bifromq_tpu_torch/csrc`` (one
   ``nvcc`` per source, started together) into ``build/kernels/`` and,
   beside them, the two native host helpers from ``csrc/host/`` (the C++
   topic tokenizer and interval expander, one ``g++`` each) into
   ``build/host/``, printing each build's seconds;
2. compiles BASELINE config 2 (one tenant, 1M Zipf wildcard
   subscriptions, ``workloads.config_wildcard(1_000_000, seed=0)``) and
   uploads its automaton to the card;
3. holds each kernel against its plain PyTorch version on the card, at
   the main path's shapes, with exact equality (every output is an
   integer or a bool), and times kernel, plain version and (for the
   expansion) ``torch.searchsorted`` with CUDA events:
   - the level hash (K1) on the probe topics, the diverse topics, a
     seeded edge-case batch (a 128-byte level, empty levels, a row at
     ``max_levels``, a level ending on the row's last byte, padding
     rows, ``$`` topics) and that batch with its level boundaries moved
     outside the rows; timed at B = 16384 and 4096, with the live lanes;
     then ("K1-wide") at row widths 1536, 4096, 16384 and 65535 bytes,
     past the default 48 KB tile, on random rows and on packed topics;
   - the walk (K2) on the config-2 probes at (K, A) = (32, 32) and
     (128, 128), and on seeded synthetic automata whose buckets are full
     and whose rows reach the sorted compaction and overflow, one table
     and four stacked under a [2, 4] block grid in one batched call;
     then ("K2-budgets") at every (K, A) of K in {2, 4, 6, 8, 16, 24,
     32, 64, 128, 256} x A in {1, 2, ..., 256}, which covers every
     primary and escalation budget the reference's tests reach, and at
     K in {257, 300, 512, 1024} x A in {32, 256} on the config-2 rows
     and the full-bucket tables with 13-level rows, which reach the
     sorted compaction at each of these K (K = 512 the largest
     registers-and-shared-memory instance, 1024 the global-scratch
     path), and
     ``TorchMatcher(k_states=16)`` (escalation (64, 128)) serving 1024
     topics equal to the host oracle; then ("K2-large-time") times K =
     32, 512 and 1024 on 4096 config-2 rows and on the full-bucket
     tables;
   - the expansion (K3) also on seeded adversarial grids (long runs of
     empty lanes, a lane longer than a tile, totals below, at and far
     above the buffer, a buffer that is no multiple of the tile,
     negative counts, 8 blocks of different totals with one empty), each
     at A = 32 and 128, timed at B = 16384 and 4096 three ways: the
     whole call, its launches' device time alone, and
     ``torch.searchsorted`` over the same lanes;
4. serves 3 ``match_batch`` calls of 4096 topic strings through
   ``TorchMatcher`` — the main path — with the kernels' launch counts
   reset just before and read just after, and checks 256 rows of each
   batch against the host oracle and the launches of each batch (the
   hash once, the walk once or twice, the expansion once); then times
   one more batch stage by stage (prepare, dispatch, fetch, host
   expansion), counting the native host helpers' calls in each stage
   (stage 3 must re-expand its truncated rows natively); then
   ("host-helpers") expands that batch's truncated rows' interval grids
   with the native expander and with its numpy leg, and tokenizes its
   4096 topics (as level lists) natively and with the Python loop,
   timing both legs and asserting exact equality; then runs bench.py's
   config 8 ("churn") on the same matcher: 256 subscribes, each patched
   in place and flushed to the card, and 128 unsubscribes, with a
   64-topic batch every 8 subscribes, checking that no full compile
   ran, that the device tables equal the host arenas and that the
   results equal the host oracle;
5. serves a 100K-subscription tenant whose deliverer keys name 8 servers
   and checks the device's per-peer buckets against the host bucketing;
   that matcher keeps the match-result cache on, and the same batch
   served again ("cache") must launch no kernel and return the very same
   results, an exact-filter subscribe must re-walk only its topic's rows
   and a wildcard subscribe every row;
6. holds the mesh ring-hop kernel against its plain version for both
   mesh axes at the mesh path's shape ``[2, 4, n_peers + 2]`` (n_peers 0
   and 8) and at ``[2, 4, 1 << 20]``, timing kernel, its device time,
   plain version and ``torch.roll``; then splits the host time of 1000
   back-to-back hops at ``[2, 4, 2]`` into the parts of the launch path,
   beside the longer path it replaced and ``torch.roll``;
7. compiles BASELINE config 5 (``config_multi_tenant``: 10K Zipf-sized
   tenants, cut from 10M to 1M subscriptions) onto a ``make_mesh(2, 4)``
   grid and serves 3 ``match_batch`` calls of 4096 config-5 queries
   through ``TorchMeshMatcher`` — the mesh path — with the launch counts
   reset just before and read just after (per batch: the walk once and
   the expansion once for all blocks, the ring hop 4 times); checks 256
   rows of each batch against the host oracle, every block's peer
   buckets against the host bucketing and the ring-merged per-peer
   totals; then times one more batch stage by stage (stage 0 must
   tokenize the token cache's misses natively), holds the walk's
   one launch on that batch's own [8, 1024, W] probe grids against the
   plain walk block by block and times it beside 8 per-block launches
   of the same kernel, and times the expansion on the batch's own
   [8, 1024, 32] grids;
8. serves one checked mesh batch over a 100K-subscription config-5
   population whose deliverer keys name 8 servers, so the blocks bucket
   into 8 peers and the ring merges ``[2, 4, 10]`` count vectors;
9. ("pipeline") runs bench.py's config 7 on the port: 200K
   subscriptions (``config_wildcard(200_000, seed=0)``, cache off), 8
   blocking ``match_batch`` calls of 4096 topics against the same stream
   as 2048 batches of 16 through ``match_batch_async`` and the dispatch
   ring, with the launch counts reset just before the pipelined leg and
   read just after (the hash, the walk and the expansion must each have
   launched); prints both legs' topics/s and batch p50/p99, the ring's
   peak in flight and depth, the p99 speedup and the stage percentiles;
   checks sampled rows against the sync leg (in order) and the oracle,
   an overlap of two batches, and no degraded batch; then the same leg
   with 16 subscribes landing between dispatches, each churn row equal
   to the oracle as of its batch's dispatch and at least one patch flush
   that wrote new tables because a batch was in flight;
10. ("dist") drives the broker's publish path through its entry points:
   ``DistService`` over a default ``DistWorker()`` (one raft voter, one
   range, the coproc's ``TorchMatcher()`` on the card, the pub cache
   on). It subscribes config 7's 200K routes through consensus
   (``DistService.match``, 1000 gathered at a time), then publishes
   4096 probe topics through ``DistService.pub`` in gathered windows of
   256 to sub-brokers 0 and 1 that record every delivery, with the
   launch counts reset just before and read just after (the hash, the
   walk and the expansion must each have launched): every publish's
   fan-out equals the host oracle's route count, and 256 sampled
   publishes delivered, in order, the list the fan-out makes of the sync
   device leg's row, which equals the oracle's. Then 64 subscribes and
   64 unsubscribes, each seen by the next publish; then a split of the
   range at its median key and 512 publishes checked in full against the
   union of the two ranges' rows (two ``TorchMatcher`` on the card). No
   publish may be degraded, and every matcher must drain;
11. ("retained", run right after step 1, while the heap is small)
   retains BASELINE config 4 (``config_retained``: one tenant's retained
   topics, cut from 5M to 1M, each with a seeded payload) through
   ``RetainService.retain``: consensus on the replicated retain range,
   whose ``RetainCoProc`` patches the range's ``RetainedIndex(
   max_levels=18, k_states=16)`` on the card; prints retains/s and the
   first scan's compile. On that index it serves 4 batches of 4096
   ``probe_filters`` through ``match_batch`` with ``limit=10``, then the
   first unlimited, with the launch counts reset just before and read just
   after (the hash on every batch, no other kernel): every limit-10 row
   has the host oracle's length, only matching topics and no duplicate,
   64 seeded rows unlimited pass the same checks and equal the oracle's
   (the rows the host matcher served are counted); K1 is held against
   its plain version on the phase's filters; one batch is timed stage by
   stage. Then the same 4 batches through ``RetainService.match_batch``
   (the range's scan plane: result cache, dispatch ring, watchdog,
   breaker), launch counts reset just before and read just after (K1
   once a batch, nothing else): every row equals the index's limit-10
   row in order, with the written payloads; 256 of the filters served
   twice, the second time all cache hits with no launch. Then 2,048 set
   / clear mutations
   through ``retain``, each patched in place and flushed, each evicting
   exactly the cached filters it matches, with a checked service scan
   after every 256, no full compile, and the device tables equal to the
   host arenas at the end. Last, the restart: config 4's first 100K
   topics retained through a service of their own, then a second
   ``RetainService`` over the same engine, which rebuilds its index from
   KV and serves the 64 seeded rows as the first did;
12. ("device-chaos") on a 400-subscription matcher: a dispatch error,
   a hang under a 0.25 s watchdog deadline with the batch held on the
   card by a sleep kernel (the quarantine keeps the result until its
   CUDA event completes, then a sweep empties it) and a forced-open
   breaker (served with no launch, re-closed by the half-open canary),
   each served exactly from the host oracle and followed by a batch the
   card serves exactly; then the same three on a 400-topic
   ``RetainService``'s scan plane, and a ``NativeLibError`` raised in
   the plane, which must propagate. No batch or scan outside this phase
   may be degraded, and every device breaker must read closed at the
   end.

The config-2 and mesh matchers run with the match cache off, as
bench.py's config 2 does, so every batch reaches the card. It prints the
card's name and power limit, the script's total seconds, one
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``. Any failure exits
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
MESH = (2, 4)            # (replicas, shards), as the reference's tests
MESH_TENANTS = 10_000    # BASELINE config 5
MESH_SUBS = 1_000_000    # config 5 has 10M; cut to 1M (PERF.md section 4)
MESH_PEER_TENANTS = 1_000   # config 5's shape, keys naming 8 servers
MESH_PEER_SUBS = 100_000
RING_N = (2, 10, 1 << 20)  # n_peers + 2 for n_peers 0 and 8; bandwidth
# H100 SXM published peaks, x 132 SMs x the 1.98 GHz SXM boost clock
# (the clock at which the datasheet's 67 TFLOP/s float32 rate is 132 x
# 128 lanes x 2): HBM bytes/s (NVIDIA H100 datasheet); the integer ALU
# pipe, 64 INT32 lanes per SM (NVIDIA H100 Tensor Core GPU Architecture
# whitepaper), which alone runs logic ops, shifts and compares (LOP3,
# SHF, PRMT, ISETP); and the issue rate, one warp instruction per clock
# on each of an SM's 4 schedulers, 128 lanes, which caps all integer
# instructions together, since an add may also issue as an IMAD on the
# FMA pipe (Nsight Compute Kernel Profiling Guide, "Pipelines").
HBM_BPS = 3.35e12
INT32_OPS = 64 * 132 * 1.98e9
ISSUE_OPS = 128 * 132 * 1.98e9
# K1's 32-bit instructions per live lane, the least one BLAKE2b block
# needs on sm_90: a G step makes 4 64-bit adds (a + b + m is one
# three-input add), 2 instructions each, on either pipe; 4 xors, 2 LOP3
# each, and rotates by 24, 16 and 63, 2 SHF or PRMT each (by 32 swaps
# the halves: none), on the ALU: 14 ALU and 22 in all. 12 rounds of 8
# G, but the output v0 ^ v8 (2 LOP3) reads only 2 G of the last round in
# full, 3 up to their 7th step (10 ALU, 18 in all) and one up to its 5th
# (6, 12).
K1_ALU_OPS = 11 * 8 * 14 + 2 * 14 + 3 * 10 + 6 + 2
K1_OPS = 11 * 8 * 22 + 2 * 22 + 3 * 18 + 12 + 2


def _bound_times(row):
    return (row["bytes"] / HBM_BPS,
            max(row.get("alu_ops", row["ops"]) / INT32_OPS,
                row["ops"] / ISSUE_OPS))


def bound_ms(row) -> float:
    """The least time the card could take for a row's work: its bytes
    over HBM bandwidth, its ALU-only 32-bit operations (``alu_ops``,
    default all of ``ops``) over the ALU rate, or all its 32-bit
    operations over the issue rate, whichever is longest."""
    return max(_bound_times(row)) * 1e3


def bound_by(row) -> str:
    t_bytes, t_ops = _bound_times(row)
    return "bytes" if t_bytes >= t_ops else "operations"


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


def time_device_ms(torch, fn, iters: int) -> float:
    """Device time per call of ``fn``'s launches alone. A sleep kernel
    holds the stream while the host enqueues ``iters`` calls, so the
    events around them time the launches back to back on the card, with
    no host gap. Until the enqueue ends inside the sleep, the sleep
    doubles and the count halves (the card's launch queue holds about a
    thousand launches; a fuller queue blocks the host)."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 26
    for _ in range(10):
        s0 = torch.cuda.Event(enable_timing=True)
        s1 = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        s0.record()
        torch.cuda._sleep(cycles)
        s1.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host_ms < s0.elapsed_time(s1):
            return s1.elapsed_time(end) / iters
        cycles *= 2
        iters = max(1, iters // 2)
    raise AssertionError("the host enqueue outlasted every sleep")


def host_us(torch, fn, calls: int = 1000) -> float:
    """Host time per call of ``calls`` back-to-back calls, no sync inside
    (one before and one after, outside the clock)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


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


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def start_host_builds():
    """Start the g++ builds of the two native host helpers
    (``csrc/host/tokenizer.cpp`` and ``expand.cpp``, into
    ``build/host/``) on worker threads, so they run beside ``nvcc``;
    returns a function that waits for them and gives each one's
    seconds."""
    from concurrent.futures import ThreadPoolExecutor
    from bifromq_tpu_torch.models import native_tok
    from bifromq_tpu_torch.ops import match as M

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    pool = ThreadPoolExecutor(2)
    futs = {"tokenizer": pool.submit(timed, native_tok.load_lib),
            "expand": pool.submit(timed, M._expand_lib)}

    def wait():
        try:
            return {k: f.result() for k, f in futs.items()}
        finally:
            pool.shutdown()
    return wait


def native_calls():
    from bifromq_tpu_torch.utils.nativelib import CALLS
    return dict(CALLS)


def calls_since(before):
    return {k: v - before.get(k, 0) for k, v in native_calls().items()
            if v - before.get(k, 0)}


def host_helpers_phase(np, M, m, overflow, pairs, ct, workloads, root, smi,
                       reps: int = 3):
    """The native host helpers against their numpy and Python legs on
    the config-2 serve batch: the truncated rows' fetched interval grids
    (what stage 3 re-expands) and 4096 probe topics (level lists, the
    host tokenizer's input), each timed ``reps`` times a leg, with
    exact equality asserted."""
    from bifromq_tpu_torch.models.automaton import tokenize
    n = B_SERVE
    need = np.nonzero(pairs.trunc[:n] & ~overflow[:n])[0]
    g_s, g_c = m._fetch_escalation_grids(pairs.res)
    gs, gc = g_s[need], g_c[need]

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    nat_ms, npy_ms = [], []
    for _ in range(reps):
        (s1, o1), t = timed(lambda: M.expand_intervals(gs, gc))
        nat_ms.append(t)
        (s2, o2), t = timed(lambda: M.expand_intervals_numpy(gs, gc))
        npy_ms.append(t)
    if not (s1.dtype == s2.dtype and np.array_equal(s1, s2)
            and np.array_equal(o1, o2)):
        raise AssertionError("native expand_intervals differs from numpy")
    topics = workloads.probe_topics(n, seed=200)
    roots = [root] * n
    kw = dict(max_levels=ct.max_levels, salt=ct.salt, batch=n)
    tok_ms, py_ms = [], []
    for _ in range(reps):
        a, t = timed(lambda: tokenize(topics, roots, **kw))
        tok_ms.append(t)
        b, t = timed(lambda: tokenize(topics, roots, native=False, **kw))
        py_ms.append(t)
    for f in ("tok_h1", "tok_h2", "lengths", "roots", "sys_mask"):
        x, y = getattr(a, f), getattr(b, f)
        if not (x.dtype == y.dtype and np.array_equal(x, y)):
            raise AssertionError(f"native tokenize differs in {f}")
    out = {"phase": "host-helpers", "batch": n, "card": smi,
           "expand": {"rows": int(need.size), "slots": int(s1.size),
                      "native_ms": nat_ms, "numpy_ms": npy_ms,
                      "equal": True},
           "tokenize": {"topics": n, "native_ms": tok_ms,
                        "python_ms": py_ms, "equal": True}}
    print(json.dumps(out), flush=True)
    return out


def ring_phase(torch, K, dev):
    """K4: ``ring_hop`` against ``ring_hop_plain`` for both mesh axes at
    every ``RING_N`` width, each timed (whole call, and its launch's
    device time alone) beside its plain version and ``torch.roll``.
    Returns the kernels-line row (the mesh path's shape,
    ``[2, 4, 2]``, shard axis) and the max error over every case."""
    gen = torch.Generator(device=dev).manual_seed(0)
    err, row = 0, None
    for n in RING_N:
        x = torch.randint(-(1 << 30), 1 << 30, (*MESH, n), dtype=torch.int32,
                          device=dev, generator=gen)
        iters = 20 if n > 4096 else 200
        for axis in (0, 1):
            got = K.ring_hop(x, axis)
            want = K.ring_hop_plain(x, axis)
            torch.cuda.synchronize()
            e = max_abs_err(torch, [got], [want])
            err = max(err, e)
            r = dict(
                bytes=2 * x.numel() * 4, ops=0,
                ms=time_ms(torch, lambda: K.ring_hop(x, axis), iters),
                plain_ms=time_ms(torch, lambda: K.ring_hop_plain(x, axis),
                                 iters),
                library_ms=time_ms(torch, lambda: torch.roll(x, 1, dims=axis),
                                   iters))
            r["device_ms"] = time_device_ms(
                torch, lambda: K.ring_hop(x, axis), iters)
            print(json.dumps({"phase": "K4", "shape": list(x.shape),
                              "axis": axis, "max_abs_err": e,
                              "ms": r["ms"], "device_ms": r["device_ms"],
                              "plain_ms": r["plain_ms"],
                              "roll_ms": r["library_ms"],
                              "bound_ms": bound_ms(r)}),
                  flush=True)
            if n == RING_N[0] and axis == 1:
                row = r
    if err:
        raise AssertionError(f"K4 ring_hop differs from ring_hop_plain: {err}")
    return row, err


def _long_check(name, t, dtype):
    """``check_cuda`` as it was before the launch path was cut: one test
    after another, kept here to time the two paths side by side."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected 16-byte alignment")


def k4_host_split(torch, K, D, dev, smi):
    """Where a ring hop's time goes on the host at the serving shape
    ``[2, 4, 2]``: 1000 back-to-back calls of the whole wrapper and of each
    part of its launch path alone, host clock, no sync inside. Beside the
    current path, the longer one it replaced, rebuilt here from the same
    library: the checks one by one, ``torch.empty_like``, a
    ``torch.cuda.Stream`` object and fresh ``c_void_p`` pointers per
    launch, and the C entry called through ``ctypes``; and
    ``torch.roll``. Returns the split, microseconds per call."""
    import ctypes
    x = torch.arange(2 * 4 * 2, dtype=torch.int32, device=dev).reshape(2, 4, 2)
    out = torch.empty_like(x)
    r, s, n = x.shape
    fn = K.RING_HOP.load()
    stream = D.stream_of(x)
    c_fn = getattr(ctypes.CDLL(str(K.RING_HOP.library)), "ring_hop")
    c_fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    c_fn.restype = ctypes.c_int

    def long_path():
        _long_check("x", x, torch.int32)
        o = torch.empty_like(x)
        K.RING_HOP.load()
        rc = c_fn(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(o.data_ptr()),
                  r, s, n, 1, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(rc)
        return o

    parts = {
        "ring_hop": lambda: K.ring_hop(x, 1),
        "long_path": long_path,
        "torch_roll": lambda: torch.roll(x, 1, dims=1),
        "checks": lambda: D.check_cuda("x", x, torch.int32),
        "long_checks": lambda: _long_check("x", x, torch.int32),
        "empty_like": lambda: torch.empty_like(x),
        "stream": lambda: D.stream_of(x),
        "stream_object": lambda: torch.cuda.current_stream().cuda_stream,
        "pointers": lambda: (D.ptr(x), D.ptr(out)),
        "void_p_pointers": lambda: (ctypes.c_void_p(x.data_ptr()),
                                    ctypes.c_void_p(out.data_ptr())),
        "entry_call": lambda: fn(x.data_ptr(), out.data_ptr(), r, s, n, 1,
                                 stream),
        "ctypes_call": lambda: c_fn(x.data_ptr(), out.data_ptr(), r, s, n,
                                    1, stream),
    }
    split = {}
    for _ in range(2):   # the second pass is the one kept
        split = {k: host_us(torch, f) for k, f in parts.items()}
    print(json.dumps({"phase": "K4-host", "shape": [r, s, n], "axis": 1,
                      "calls": 1000, "card": smi, "us_per_call": split}),
          flush=True)
    return split


def k3_grids(np, a: int, merge_tile: int):
    """Seeded adversarial expansion inputs at interval width ``a``:
    (name, ivl_s, ivl_c, cap) with [G, B, A] int32 numpy grids."""
    rng = np.random.default_rng(a)
    b = 1024

    def starts(shape):
        return rng.integers(0, 1 << 24, shape).astype(np.int32)

    def counts(shape, hi=24, p_empty=0.4):
        c = rng.integers(1, hi, shape).astype(np.int32)
        c[rng.random(shape) < p_empty] = 0
        return c

    out = []
    # long runs of empty lanes: most rows use one or two of their A
    # slots, and rows 100-699 are empty altogether
    c = counts((1, b, a), p_empty=0.97)
    c[:, 100:700] = 0
    out.append(("empty_runs", starts(c.shape), c, int(c.sum()) + 333))
    # one lane longer than a merge tile and a scan tile, among sparse ones
    c = counts((1, b, a), hi=4, p_empty=0.9)
    c[0, 5, 3] = 5 * merge_tile + 3
    c[0, 700, a - 1] = 3 * 2048 + 1
    out.append(("long_lane", starts(c.shape), c, int(c.sum())))
    c = counts((1, b, a))
    tot = int(c.sum())
    st = starts(c.shape)
    out.append(("total_lt_cap", st, c, tot + 1))
    out.append(("total_eq_cap", st, c, tot))
    out.append(("total_gg_cap", st, c, tot // 40))
    out.append(("cap_not_tile_multiple", st, c, 3 * merge_tile + 5))
    c = rng.integers(-9, 16, (1, b, a)).astype(np.int32)
    out.append(("negative_counts", starts(c.shape), c,
                int(np.maximum(c, 0).sum()) // 2))
    # G = 8 blocks of different totals under one cap, block 0 empty
    cap = 64 * b
    eq = counts((b, a), hi=6).reshape(-1)                # total == cap
    eq[np.cumsum(eq) >= cap] = 0
    eq[-1] += cap - int(eq.sum())
    c = np.stack([np.zeros((b, a), np.int32),            # empty
                  counts((b, a), p_empty=0.9995),        # a few lanes
                  counts((b, a), hi=4, p_empty=0.9),     # total < cap
                  eq.reshape(b, a),
                  counts((b, a), hi=200),                # total >> cap
                  rng.integers(-3, 8, (b, a)).astype(np.int32),
                  counts((b, a), p_empty=0.97),
                  counts((b, a), hi=80)])
    out.append(("blocks8", starts(c.shape), c, cap))
    return out


def k3_adversarial(torch, K, M, dev):
    """K3 against ``_expand_pairs`` on every adversarial grid at A = 32
    and 128, exact: the batched entry block by block and, for one-block
    grids, the [B, A] entry too. Returns the max error."""
    import numpy as np
    err, cases = 0, []
    for a in (32, 128):
        for name, st, c, cap in k3_grids(np, a, K.EXPAND_MERGE_TILE):
            s_t = torch.from_numpy(st).to(dev)
            c_t = torch.from_numpy(c).to(dev)
            got = K.kernel_expand(s_t, c_t, cap=cap)
            want = [M._expand_pairs(s_t[g], c_t[g], cap)
                    for g in range(st.shape[0])]
            want = [torch.stack(x) for x in zip(*want)]
            torch.cuda.synchronize()
            e = max_abs_err(torch, got, want)
            if st.shape[0] == 1:
                got2 = K.kernel_expand(s_t[0], c_t[0], cap=cap)
                torch.cuda.synchronize()
                e = max(e, max_abs_err(torch, got2, [w[0] for w in want]))
            err = max(err, e)
            cases.append({"grid": name, "A": a, "G": int(st.shape[0]),
                          "cap": cap, "n_pairs": got[3].tolist(),
                          "trunc_rows": int(got[4].sum()),
                          "max_abs_err": e})
    print(json.dumps({"phase": "K3-adversarial", "cases": cases,
                      "max_abs_err": err}), flush=True)
    if err:
        raise AssertionError(f"K3 differs from _expand_pairs: {err}")
    return err


def k3_time(torch, K, M, ivl_s, ivl_c, cap: int, label: str, smi,
            iters: int = 50):
    """K3 at one shape: the whole ``kernel_expand`` call, the device time
    of its launches alone, the plain version and the one-call yardstick
    ``torch.searchsorted(ends, j, right=True)`` over the same lanes
    (batched over G for [G, B, A] grids), with its check and its bytes
    and operations. Returns the kernels-line row."""
    batched = ivl_s.dim() == 3
    g = ivl_s.shape[0] if batched else 1
    b, a = ivl_s.shape[-2:]
    got = K.kernel_expand(ivl_s, ivl_c, cap=cap)
    if batched:
        want = [torch.stack(x) for x in zip(*[
            M._expand_pairs(ivl_s[i], ivl_c[i], cap) for i in range(g)])]
    else:
        want = M._expand_pairs(ivl_s, ivl_c, cap)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    if err:
        raise AssertionError(f"K3 differs from _expand_pairs at {label}: "
                             f"{err}")
    ends = torch.cumsum(ivl_c.reshape(g, b * a).clamp(min=0), dim=1,
                        dtype=torch.int32)
    j = torch.arange(cap, dtype=torch.int32,
                     device=ivl_s.device).expand(g, cap).contiguous()
    n_pairs = got[3].reshape(g)
    row = dict(
        bytes=2 * g * b * a * 4 + 2 * g * cap * 4 + g * (b + 1) * 4
        + g * b + g * 4,
        # the scan's adds, then the merge steps the data needs (lanes
        # that start below the limit, and every position) at ~4 ops each
        ops=g * b * a + 4 * (g * cap + int(
            (ends - ivl_c.reshape(g, b * a).clamp(min=0)
             < n_pairs[:, None]).sum())),
        ms=time_ms(torch, lambda: K.kernel_expand(ivl_s, ivl_c, cap=cap),
                   iters),
        device_ms=time_device_ms(
            torch, lambda: K.kernel_expand(ivl_s, ivl_c, cap=cap), iters),
        plain_ms=time_ms(torch, lambda: (
            K._expand_blocks_plain(ivl_s, ivl_c, cap) if batched
            else M._expand_pairs(ivl_s, ivl_c, cap)), 10),
        library_ms=time_ms(torch, lambda: torch.searchsorted(
            ends, j, right=True), iters))
    print(json.dumps({"phase": "K3-time", "shape": label, "G": g, "B": b,
                      "A": a, "cap": cap, "card": smi, "max_abs_err": err,
                      "n_pairs": n_pairs.tolist(),
                      "trunc_rows": int(got[4].sum()),
                      "ms": row["ms"], "device_ms": row["device_ms"],
                      "plain_ms": row["plain_ms"],
                      "searchsorted_ms": row["library_ms"],
                      "bound_ms": bound_ms(row)}), flush=True)
    return row


def sass_histogram(lib) -> dict:
    """Opcode counts of the SASS in one built kernel library (static: each
    instruction once, wherever it sits), read with the toolkit's
    ``cuobjdump``; an empty dict where that tool is missing or fails."""
    import re
    from bifromq_tpu_torch.utils.device import _nvcc
    exe = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    try:
        sass = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=120).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    counts: dict = {}
    for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)", sass):
        counts[op] = counts.get(op, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def k1_inputs(torch, T, tb, root: int, max_levels: int, batch: int, dev):
    """Pack ``tb`` into a ``batch``-row byte block and upload the K1
    arguments (rows past ``len(tb)`` are padding rows, nlv == -1)."""
    lengths, _, _, rows_b, starts, lens = T.pack_topic_bytes(
        tb, [root] * len(tb), max_levels=max_levels, batch=batch)
    args = [torch.from_numpy(a).to(dev) for a in
            (rows_b, starts, lens, lengths.reshape(batch, 1))]
    return args


def k1_phase(torch, T, workloads, TopicBytes, ct, root, dev, smi):
    """K1 against ``_hash_lanes`` with exact equality on the probe
    topics, the diverse topics, the seeded edge-case batch (a 128-byte
    level, empty levels, a row at ``max_levels``, a level ending on byte
    ``mb - 1``, padding rows, ``$`` topics) and that batch with level
    boundaries moved outside their rows (the clamped path); then timed on
    the probe topics at B = 16384 and at their first 4096 rows. Returns
    the max error and the kernels-line row (B = 16384)."""
    import numpy as np
    h0 = T.h0_tensor(ct.salt, dev)
    mb = T.tok_max_bytes()
    probe = TopicBytes.from_topics(["/".join(t) for t in
                                    workloads.probe_topics(B_CHECK, seed=1)])
    edge = workloads.hash_edge_topics(B_CHECK - 64, max_levels=ct.max_levels,
                                      max_bytes=mb, seed=2)
    cases = {
        "probe_topics": k1_inputs(torch, T, probe, root, ct.max_levels,
                                  B_CHECK, dev),
        "diverse_topics": k1_inputs(
            torch, T, TopicBytes.from_topics(
                workloads.diverse_topics(B_CHECK, seed=0)),
            root, ct.max_levels, B_CHECK, dev),
        "edge_cases": k1_inputs(torch, T, TopicBytes.from_topics(edge), root,
                                ct.max_levels, B_CHECK, dev),
    }
    rng = np.random.default_rng(3)
    rows_b, starts, lens, nlv = cases["edge_cases"]
    shape = tuple(starts.shape)
    cases["clamped"] = [
        rows_b,
        torch.from_numpy(rng.integers(-9, mb + 9, shape).astype(
            np.int32)).to(dev),
        torch.from_numpy(rng.integers(-3, 141, shape).astype(
            np.int32)).to(dev), nlv]
    err, out = 0, {}
    for name, args in cases.items():
        got = T.blake2b_levels(*args, h0)
        want = T._hash_lanes(*args, h0)
        torch.cuda.synchronize()
        e = max_abs_err(torch, got, want)
        err = max(err, e)
        nlv = args[3]
        out[name] = {"max_abs_err": e,
                     "live": int(nlv.clamp(0, shape[1]).sum()),
                     "padding_rows": int((nlv < 0).sum())}
    if err:
        raise AssertionError(f"K1 blake2b_levels differs from _hash_lanes: "
                             f"{out}")
    row = None
    for b in (B_CHECK, B_SERVE):
        args = [a[:b].contiguous() for a in cases["probe_topics"]]
        live = int(args[3].clamp(min=0).sum())
        r = dict(live=live,
                 bytes=args[0].numel() + 2 * args[1].numel() * 4 + b * 4 + 64
                 + 2 * args[1].numel() * 4,
                 ops=live * K1_OPS, alu_ops=live * K1_ALU_OPS,
                 ms=time_ms(torch, lambda: T.blake2b_levels(*args, h0), 50),
                 device_ms=time_device_ms(
                     torch, lambda: T.blake2b_levels(*args, h0), 50),
                 plain_ms=time_ms(torch, lambda: T._hash_lanes(*args, h0),
                                  3, 1))
        out[f"B={b}"] = {"live": live, "ms": r["ms"],
                         "device_ms": r["device_ms"],
                         "plain_ms": r["plain_ms"], "bound_ms": bound_ms(r),
                         "bound_by": bound_by(r)}
        row = row or r
    print(json.dumps({"phase": "K1", "card": smi, "max_abs_err": err,
                      "ops_per_lane": K1_OPS, "alu_ops_per_lane": K1_ALU_OPS,
                      "sass": sass_histogram(T.BLAKE2B.library),
                      "cases": out}), flush=True)
    return err, row


WALK_FIELDS = ("start", "count", "n_routes", "overflow")


def k2_hold(torch, K, M, trie, probes, k_states: int, a: int, probe_len: int,
            label: str):
    """One K2 call against its plain version (``walk_routes(esc_k=0)``,
    block by block for ``[G, B, W]`` probes) with exact equality. Prints
    the case and returns the kernel's result and the max error."""
    kw = dict(probe_len=probe_len, k_states=k_states, max_intervals=a)
    got = K.fused_walk_routes(trie, probes, **kw)
    if probes.tok_h1.dim() == 3:
        want = K._walk_blocks_plain(trie, probes, **kw)
    else:
        want = M.walk_routes(trie, probes, esc_k=0, **kw)
    torch.cuda.synchronize()
    err = max_abs_err(torch, [getattr(got, f) for f in WALK_FIELDS],
                      [getattr(want, f) for f in WALK_FIELDS])
    print(json.dumps({"phase": "K2", "case": label, "K": k_states, "A": a,
                      "shape": list(probes.tok_h1.shape), "max_abs_err": err,
                      "overflow_rows": int(got.overflow.sum()),
                      "routes_per_topic":
                          float(got.n_routes.float().mean())}), flush=True)
    if err:
        raise AssertionError(f"K2 fused_walk_routes differs from walk_routes "
                             f"on {label} (K={k_states}, A={a}): {err}")
    return got, err


def k2_dense(torch, K, M, workloads, dev) -> int:
    """K2 on seeded synthetic automata whose buckets all hold P = 16
    entries and whose rows widen into the sorted compaction and overflow:
    one table at (32, 32) and (128, 128), then four tables stacked as
    shards under a [2, 4] grid of probe blocks in one batched call.
    Returns the max error."""
    import numpy as np
    tabs = [workloads.dense_walk_tables(seed) for seed in range(4)]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def probes_of(ds):
        f = {k: put(np.stack([d[k] for d in ds]))
             for k in ("tok_h1", "tok_h2", "lengths", "roots", "sys_mask")}
        return M.Probes(f["tok_h1"], f["tok_h2"], f["lengths"], f["roots"],
                        f["sys_mask"], int(f["lengths"].max()))
    err = 0
    rt = put(tabs[0]["route_tab"])
    one = M.DeviceTrie(rt, put(tabs[0]["edge_tab"]), None, None, rt)
    p1 = probes_of(tabs[:1])
    p1 = M.Probes(p1.tok_h1[0], p1.tok_h2[0], p1.lengths[0], p1.roots[0],
                  p1.sys_mask[0], p1.max_len)
    for k_states, a in ((32, 32), (128, 128)):
        got, e = k2_hold(torch, K, M, one, p1, k_states, a, 16, "dense")
        err = max(err, e)
        if k_states == 32 and not bool(got.overflow.any()):
            raise AssertionError("the dense walk case made no overflow row")
    rt = put(np.stack([d["route_tab"] for d in tabs]))
    stacked = M.DeviceTrie(rt, put(np.stack([d["edge_tab"] for d in tabs])),
                           None, None, rt)
    grid = probes_of([tabs[g % 4] for g in range(8)])
    for k_states, a in ((32, 32), (128, 128)):
        err = max(err, k2_hold(torch, K, M, stacked, grid, k_states, a, 16,
                               "dense 2x4")[1])
    return err


def walk_bound_row(torch, M, blocks, probe_len: int, a: int,
                   k_states: int = 32):
    """Bytes and operations of the walk over ``blocks`` — (trie, probes,
    shard) triples, 2-D probes each — at state budget ``k_states``, as
    this run's data needs them: every route-table row and edge bucket the
    walk visits, read once per shard, the probe grids read and the
    results written once."""
    rows, bkts, n_row_v, n_bkt_v, n = [], [], 0, 0, 0
    for trie, probes, sh in blocks:
        visits = {"rows": [], "buckets": []}
        M._route_walk(trie, probes, probe_len, k_states, a, visits=visits)
        n_row_v += sum(int(v.numel()) for v in visits["rows"])
        n_bkt_v += sum(int(v.numel()) for v in visits["buckets"])
        rows.append(torch.cat(visits["rows"]).long() * 64 + sh)
        bkts.append(torch.cat(visits["buckets"]).long() * 64 + sh)
        n += probes.tok_h1.shape[0]
    u_rows = int(torch.unique(torch.cat(rows)).numel())
    u_bkts = int(torch.unique(torch.cat(bkts)).numel())
    w = blocks[0][1].tok_h1.shape[1]
    return dict(bytes=(u_rows * M.RT_COLS * 4 + u_bkts * probe_len * 16
                       + n * (2 * w * 4 + 4 + 4 + 1) + n * (2 * a * 4 + 4 + 1)),
                ops=n_bkt_v * probe_len * 4 + n_row_v * 8,
                unique_rows=u_rows, unique_buckets=u_bkts,
                row_visits=n_row_v, bucket_visits=n_bkt_v)


def check_mesh_batch(M, mm, queries, res, pairs, peer_tab) -> None:
    """One served mesh batch against the host: sampled rows against the
    oracle, every block's buckets against the host bucketing, and the
    ring-merged totals against the blocks' own bucket counts."""
    import numpy as np
    step = max(1, len(queries) // ORACLE_SAMPLE)
    sample = list(range(0, len(queries), step))
    oracle = mm.match_from_tries([queries[i] for i in sample])
    bad = [i for i, o in zip(sample, oracle) if canon(res[i]) != canon(o)]
    if bad:
        raise AssertionError(f"mesh rows {bad[:8]} differ from the oracle")
    r, s = pairs.slots.shape[:2]
    for rep in range(r):
        for sh in range(s):
            hs, hr, ho = M.bucket_pairs_host(
                pairs.slots[rep, sh], pairs.rows[rep, sh],
                peer_tab.tables[sh].slot_peer, peer_tab.n_peers)
            if not (np.array_equal(hs, pairs.peer_slots[rep, sh])
                    and np.array_equal(hr, pairs.peer_rows[rep, sh])
                    and np.array_equal(ho, pairs.peer_offsets[rep, sh])):
                raise AssertionError(f"block ({rep}, {sh}) buckets differ "
                                     f"from bucket_pairs_host")
    totals = pairs.res.peer_totals.cpu().numpy()
    want = np.diff(pairs.peer_offsets, axis=-1).sum(axis=(0, 1))
    if not (totals == want).all():
        raise AssertionError(f"ring totals {totals.tolist()} != the "
                             f"blocks' bucket sums {want.tolist()}")
    if int(totals[0, 0, :-1].sum()) != int(pairs.n_pairs.sum()):
        raise AssertionError("ring totals do not count the live pairs")


def config5_traffic(tries, batch: int, n_batches: int):
    """bench.py's config-5 traffic: probe topics (seed 1), each for a
    tenant drawn Zipf by the rank of its sorted name (seed 3)."""
    import random
    from bifromq_tpu_torch import workloads
    n_q = batch * n_batches
    topics = ["/".join(t) for t in workloads.probe_topics(n_q, seed=1)]
    tenants = sorted(tries)
    cum, acc = [], 0.0
    for i in range(len(tenants)):
        acc += 1.0 / (i + 1)
        cum.append(acc)
    seq = random.Random(3).choices(tenants, cum_weights=cum, k=n_q)
    return [list(zip(seq[i * batch:(i + 1) * batch],
                     topics[i * batch:(i + 1) * batch]))
            for i in range(n_batches)]


def serve_mesh_batch(torch, dev, mm, queries):
    """One checked ``match_batch`` on the mesh: exactly one walk launch
    and one expansion call for the whole grid and (R-1)+(S-1) ring hops,
    then
    :func:`check_mesh_batch`. Returns the batch's summary."""
    from bifromq_tpu_torch.ops import match as M
    from bifromq_tpu_torch.utils import device as D
    r, s = mm.n_replicas, mm.n_shards
    want = {k: 0 for k in D.KERNELS}
    want.update(fused_walk=1, expand_pairs=1,
                ring_hop=(r - 1) + (s - 1))
    before = {k: v.launches for k, v in D.KERNELS.items()}
    sync(torch, dev)
    t0 = time.perf_counter()
    res = mm.match_batch(queries)
    sync(torch, dev)
    ms = (time.perf_counter() - t0) * 1e3
    launched = {k: v.launches - before[k] for k, v in D.KERNELS.items()}
    if launched != want:
        raise AssertionError(f"mesh batch launched {launched}, expected "
                             f"{want}")
    pairs, peer_tab = mm.last_expanded
    check_mesh_batch(M, mm, queries, res, pairs, peer_tab)
    return {"batch_ms": ms,
            "routes_per_topic": sum(len(x.all_routes()) for x in res)
            / len(queries),
            "block_rows": int(pairs.trunc.shape[-1]),
            "pairs": int(pairs.n_pairs.sum()),
            "walk_overflow_rows": int(pairs.res.overflow.sum()),
            "trunc_rows": int(pairs.trunc.sum()),
            "n_peers": peer_tab.n_peers,
            "peer_totals": pairs.res.peer_totals[0, 0].tolist(),
            "oracle_rows_checked": min(len(queries), ORACLE_SAMPLE),
            "launches": launched}


def k2_mesh(torch, K, M, mm, queries, smi, iters: int = 20) -> None:
    """K2 on one mesh batch's own ``[R·S, b, W]`` probe grids: the batched
    launch against the plain walk block by block (exact), then timed as
    one launch beside 8 per-block launches of the same kernel on the
    blocks' table and grid views (the summed time of the 8), with the
    bound of the walk's bytes at this shape."""
    prep = mm._prepare_probes(queries)
    edge, child, route = mm._device_trie
    r, s, b, w = prep.probes.tok_h1.shape
    g = r * s
    p = prep.probes
    grid = M.Probes(p.tok_h1.reshape(g, b, w), p.tok_h2.reshape(g, b, w),
                    p.lengths.reshape(g, b), p.roots.reshape(g, b),
                    p.sys_mask.reshape(g, b), p.max_len)
    trie = M.DeviceTrie(route, edge, child, None, route)
    a, probe_len = mm.max_intervals, prep.ct.probe_len
    _, err = k2_hold(torch, K, M, trie, grid, mm.k_states, a, probe_len,
                     f"mesh {g}x{b}")
    views = [(M.DeviceTrie(route[i % s], edge[i % s], child[i % s], None,
                           route[i % s]),
              M.Probes(grid.tok_h1[i], grid.tok_h2[i], grid.lengths[i],
                       grid.roots[i], grid.sys_mask[i], grid.max_len), i % s)
             for i in range(g)]
    kw = dict(probe_len=probe_len, k_states=mm.k_states, max_intervals=a)

    def one():
        return K.fused_walk_routes(trie, grid, **kw)

    def per_block():
        return [K.fused_walk_routes(t, q, **kw) for t, q, _ in views]
    row = walk_bound_row(torch, M, views, probe_len, a)
    out = {"phase": "K2-mesh", "shape": [g, b, w], "card": smi,
           "max_abs_err": err,
           "one_launch_ms": time_ms(torch, one, iters),
           "one_launch_device_ms": time_device_ms(torch, one, iters),
           "per_block_8_ms": time_ms(torch, per_block, iters),
           "per_block_8_device_ms": time_device_ms(torch, per_block, iters),
           "plain_ms": time_ms(torch, lambda: K._walk_blocks_plain(
               trie, grid, **kw), 3, 1),
           "bound_ms": bound_ms(row), "bound_by": bound_by(row),
           "unique_rows": row["unique_rows"],
           "unique_buckets": row["unique_buckets"],
           "row_visits": row["row_visits"],
           "bucket_visits": row["bucket_visits"]}
    print(json.dumps(out), flush=True)


def mesh_phase(torch, dev, smi, n_tenants=MESH_TENANTS, total_subs=MESH_SUBS,
               batch=B_SERVE):
    """The mesh path: config 5 on ``make_mesh(*MESH)``, 3 counted
    checked ``match_batch`` calls, then one batch timed stage by stage,
    and K2 and K3 held against their plain versions and timed on that
    batch's own grids. Returns the launch counts of the counted run and
    K3's row at the mesh shape."""
    from bifromq_tpu_torch import workloads
    from bifromq_tpu_torch.models import kernels as K
    from bifromq_tpu_torch.models.oracle import UNCAPPED_FANOUT
    from bifromq_tpu_torch.ops import match as M
    from bifromq_tpu_torch.parallel.sharded import (TorchMeshMatcher,
                                                    make_mesh)
    from bifromq_tpu_torch.utils import device as D

    t0 = time.perf_counter()
    tries = workloads.config_multi_tenant(n_tenants, total_subs, seed=0)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mm = TorchMeshMatcher.from_tries(tries, mesh=make_mesh(*MESH, device=dev),
                                     match_cache=False)
    tables = mm.compiled
    sync(torch, dev)
    compile_s = time.perf_counter() - t0
    home = [0] * mm.n_shards
    for t in tries:
        home[tables.shard_of(t)] += 1
    shards = [{"tenants": home[sh], "nodes": int(ct.n_nodes),
               "slots": int(ct.n_slots),
               "table_bytes": int(tables.edge_tab[sh].nbytes
                                  + tables.route_tab[sh].nbytes
                                  + tables.child_list[sh].nbytes),
               "unpadded_bytes": int(ct.edge_tab.nbytes + ct.child_list.nbytes
                                     + ct.n_nodes * M.RT_COLS * 4)}
              for sh, ct in enumerate(tables.compiled)]
    print(json.dumps({"phase": "mesh-compile", "tenants": n_tenants,
                      "subs": total_subs, "mesh": list(MESH),
                      "edge_buckets": int(tables.edge_tab.shape[1]),
                      "generate_s": gen_s, "compile_s": compile_s,
                      "shards": shards}), flush=True)

    batches = config5_traffic(tries, batch, N_SERVE_BATCHES + 1)
    D.reset_launches()
    served = [serve_mesh_batch(torch, dev, mm, q)
              for q in batches[:N_SERVE_BATCHES]]
    launches = {k: v.launches for k, v in D.KERNELS.items()}
    print(json.dumps({"phase": "mesh-serve", "batch": batch, "card": smi,
                      "batches": served, "launches": launches}), flush=True)

    stages = {"native_calls": {}}

    def staged(name, fn, *args):
        sync(torch, dev)
        before = native_calls()
        t0 = time.perf_counter()
        out = fn(*args)
        sync(torch, dev)
        stages[name] = (time.perf_counter() - t0) * 1e3
        stages["native_calls"][name] = calls_since(before)
        return out

    misses = mm._tok_cache.misses
    fl = staged("dispatch_ms", mm._dispatch_prepared,
                staged("prepare_ms", mm._prepare_probes, batches[-1]))
    misses = mm._tok_cache.misses - misses
    overflow, pairs = staged("fetch_ms", mm._fetch_walk, fl.res)
    staged("expand_walk_ms", mm._expand_walk, fl, overflow, pairs,
           UNCAPPED_FANOUT, UNCAPPED_FANOUT)
    print(json.dumps({"phase": "mesh-stages", "batch": batch, "card": smi,
                      "token_cache_misses": misses, **stages}), flush=True)
    # stage 0 tokenizes the token cache's misses natively
    if misses and not stages["native_calls"]["prepare_ms"].get("tokenize"):
        raise AssertionError("mesh stage 0 tokenized nothing natively")
    k2_mesh(torch, K, M, mm, batches[-1], smi)
    # K3 on this batch's own [R·S, b, A] grids, one call for all blocks
    g = mm.n_replicas * mm.n_shards
    b, a = fl.res.start.shape[-2:]
    serve_c = torch.where(fl.res.overflow[..., None], 0, fl.res.count)
    k3_row = k3_time(torch, K, M, fl.res.start.reshape(g, b, a).contiguous(),
                     serve_c.reshape(g, b, a).contiguous(),
                     b * M.expand_cap_lanes(), f"mesh {g}x{b}", smi)
    return launches, k3_row


def mesh_peer_phase(torch, dev, n_tenants=MESH_PEER_TENANTS,
                    total_subs=MESH_PEER_SUBS, batch=B_SERVE) -> None:
    """The mesh path with deliverer keys naming 8 servers, so every block
    buckets its pairs into 8 peers and the ring merges [2, 4, 10] count
    vectors: one checked batch of config-5 traffic."""
    from bifromq_tpu_torch import workloads
    from bifromq_tpu_torch.parallel.sharded import (TorchMeshMatcher,
                                                    make_mesh)
    t0 = time.perf_counter()
    tries = workloads.config_multi_tenant(
        n_tenants, total_subs, seed=0,
        deliverer_key=lambda t, i: f"srv{(t + i) % 8}|t{t}d{i}")
    mm = TorchMeshMatcher.from_tries(tries, mesh=make_mesh(*MESH, device=dev),
                                     match_cache=False)
    out = serve_mesh_batch(torch, dev, mm,
                           config5_traffic(tries, batch, 1)[0])
    if out["n_peers"] != 8:
        raise AssertionError(f"mesh peer table has {out['n_peers']} "
                             f"peers, expected 8")
    print(json.dumps({"phase": "mesh-peers", "tenants": n_tenants,
                      "subs": total_subs, **out,
                      "seconds": time.perf_counter() - t0}), flush=True)


K1_WIDE_MB = (1536, 4096, 16384, 65535)   # past the old 1520-byte limit
# every primary and escalation (K, A) budget the reference's tests reach:
# k_states in {2, 4, 6, 8, 16, 32}, max_intervals in {1, ..., 32} and the
# escalation (min(4K, 128), max(min(4A, 256), A)); plus the kernel's top K
K2_BUDGET_K = (2, 4, 6, 8, 16, 24, 32, 64, 128, 256)
K2_LARGE_K = (257, 300, 512, 1024)
K2_BUDGET_A = (1, 2, 4, 8, 16, 32, 64, 128, 256)
CHURN_OPS = 256          # bench.py config 8 (BENCH_CHURN_OPS default)
CHURN_BATCH = 64


def k1_wide_phase(torch, T, TopicBytes, dev, smi):
    """K1 against ``_hash_lanes`` with exact equality at row widths past
    the default 48 KB tile (``K1_WIDE_MB``): random row bytes with level
    boundaries spread over the whole row, and packed topics whose levels
    fill it (``pack_topic_bytes`` at that width). Returns the max
    error."""
    import random

    import numpy as np
    rng = np.random.default_rng(11)
    err, out = 0, {}
    for mb in K1_WIDE_MB:
        b, w = 256, 17
        rows = rng.integers(0, 256, (b, mb), dtype=np.uint8)
        lens = rng.integers(0, 129, (b, w)).astype(np.int32)
        starts = rng.integers(0, mb - 128, (b, w)).astype(np.int32)
        starts[:, -1] = mb - lens[:, -1]          # levels ending on mb - 1
        nlv = rng.integers(-1, w + 1, (b, 1)).astype(np.int32)
        cases = {"random": [torch.from_numpy(a).to(dev)
                            for a in (rows, starts, lens, nlv)]}
        # packed topics: 128-byte levels filling the row, max_levels deep
        pr = random.Random(mb)
        max_levels = mb // 129
        topics = ["/".join("".join(pr.choice("abcdefgh$+")
                                   for _ in range(pr.randint(0, 128)))
                           for _ in range(pr.randint(1, max_levels)))
                  for _ in range(64)]
        old = os.environ.get("BIFROMQ_TOK_MAX_BYTES")
        os.environ["BIFROMQ_TOK_MAX_BYTES"] = str(mb)
        try:
            lengths, _, _, rows_b, st_b, ln_b = T.pack_topic_bytes(
                TopicBytes.from_topics(topics), [0] * 64,
                max_levels=max_levels, batch=64)
        finally:
            if old is None:
                del os.environ["BIFROMQ_TOK_MAX_BYTES"]
            else:
                os.environ["BIFROMQ_TOK_MAX_BYTES"] = old
        cases["packed"] = [torch.from_numpy(a).to(dev) for a in
                           (rows_b, st_b, ln_b, lengths.reshape(64, 1))]
        h0 = T.h0_tensor(7, dev)
        res = {}
        for name, args in cases.items():
            got = T.blake2b_levels(*args, h0)
            want = T._hash_lanes(*args, h0)
            torch.cuda.synchronize()
            e = max_abs_err(torch, got, want)
            err = max(err, e)
            res[name] = {"shape": list(args[1].shape), "max_abs_err": e,
                         "live": int(args[3].clamp(0, args[1].shape[1])
                                     .sum())}
        res["ms"] = time_ms(torch, lambda: T.blake2b_levels(
            *cases["random"], h0), 20)
        out[str(mb)] = res
    print(json.dumps({"phase": "K1-wide", "card": smi, "cases": out,
                      "max_abs_err": err}), flush=True)
    if err:
        raise AssertionError(f"K1 differs from _hash_lanes on wide rows: "
                             f"{out}")
    return err


def dense_walk_inputs(torch, M, workloads, dev, **kw):
    """``workloads.dense_walk_tables(0, **kw)`` on the card: the walk's
    ``(DeviceTrie, Probes)``."""
    import numpy as np
    d = workloads.dense_walk_tables(0, **kw)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    rt = put(d["route_tab"])
    return (M.DeviceTrie(rt, put(d["edge_tab"]), None, None, rt),
            M.Probes(put(d["tok_h1"]), put(d["tok_h2"]), put(d["lengths"]),
                     put(d["roots"]), put(d["sys_mask"]),
                     int(d["lengths"].max())))


def k2_budgets_phase(torch, K, M, D, workloads, trie, probes, dev, smi):
    """K2 against ``walk_routes(esc_k=0)`` at every (K, A) of
    ``K2_BUDGET_K`` x ``K2_BUDGET_A`` on the first 4096 config-2 probe
    rows, at K = 6 and 24 on the seeded full-bucket tables, and at every
    K of ``K2_LARGE_K`` x A in {32, 256} on the config-2 rows and on
    full-bucket tables with 13-level rows, exact; then
    ``TorchMatcher(k_states=16)`` — escalation budget (64, 128) — serves
    a batch of 1024 topic strings equal to the host oracle row for row.
    Returns the max error."""
    from bifromq_tpu_torch.models.matcher import TorchMatcher
    sub = M.Probes(*(x[:B_SERVE].contiguous() for x in
                     (probes.tok_h1, probes.tok_h2, probes.lengths,
                      probes.roots, probes.sys_mask)), probes.max_len)
    err, cases = 0, []
    for k_states in K2_BUDGET_K:
        for a in K2_BUDGET_A:
            kw = dict(probe_len=16, k_states=k_states, max_intervals=a)
            got = K.fused_walk_routes(trie, sub, **kw)
            want = M.walk_routes(trie, sub, esc_k=0, **kw)
            torch.cuda.synchronize()
            e = max_abs_err(torch, [getattr(got, f) for f in WALK_FIELDS],
                            [getattr(want, f) for f in WALK_FIELDS])
            err = max(err, e)
            cases.append([k_states, a, e, int(got.overflow.sum())])
    dense, dp = dense_walk_inputs(torch, M, workloads, dev)
    for k_states in (6, 24):
        err = max(err, k2_hold(torch, K, M, dense, dp, k_states, 32, 16,
                               "dense")[1])
    # past the registers-and-shared-memory instances: KC = 512 in shared
    # memory, and K > 512 on the global-scratch path; rows of up to 13
    # levels widen past 2^10 candidates, so every one of these K reaches
    # the sorted compaction
    deep, deep_p = dense_walk_inputs(torch, M, workloads, dev, depth=13)
    for k_states in K2_LARGE_K:
        for a in (32, 256):
            e = k2_hold(torch, K, M, trie, sub, k_states, a, 16,
                        "config 2")[1]
            e = max(e, k2_hold(torch, K, M, deep, deep_p, k_states, a, 16,
                               "dense depth 13")[1])
            err = max(err, e)
            cases.append([k_states, a, e, None])
    print(json.dumps({"phase": "K2-budgets", "card": smi,
                      "rows": B_SERVE, "cases [K, A, err, overflow]": cases,
                      "max_abs_err": err}), flush=True)
    if err:
        raise AssertionError(f"K2 differs from walk_routes at some budget: "
                             f"{[c for c in cases if c[2]]}")
    t0 = time.perf_counter()
    m16 = TorchMatcher.from_tries(workloads.config_wildcard(N_PEER_SUBS,
                                                            seed=0),
                                  k_states=16, device=dev, match_cache=False)
    queries = [("tenant0", "/".join(t))
               for t in workloads.probe_topics(1024, seed=5)]
    D.reset_launches()
    res = m16.match_batch(queries)
    launched = {k: v.launches for k, v in D.KERNELS.items()}
    oracle = m16.match_from_tries(queries)
    bad = [i for i, (r, o) in enumerate(zip(res, oracle))
           if canon(r) != canon(o)]
    pairs, _ = m16.last_expanded
    print(json.dumps({"phase": "K2-budgets-serve", "k_states": 16,
                      "escalation": list(m16._escalation_budget()),
                      "rows": len(queries), "rows_differing": len(bad),
                      "walk_overflow_rows": int(pairs.res.overflow.sum()),
                      "launches": launched,
                      "seconds": time.perf_counter() - t0}), flush=True)
    if bad or not launched["fused_walk"]:
        raise AssertionError(f"TorchMatcher(k_states=16) rows {bad[:8]} "
                             f"differ from the oracle, launches {launched}")
    return err


def k2_large_time(torch, K, M, workloads, trie, probes, dev, smi):
    """K2 timed at K = 32, 512 (the largest shared-memory instance) and
    1024 (the global-scratch path), A = 32: on the first 4096 config-2
    probe rows (few live states a row), and on the seeded full-bucket
    tables with rows of up to 13 levels (256 rows; past 2^10 candidates
    the K^2 rank selection runs at every level). Whole call, device time
    and the plain walk, with the byte bound of each run. Returns the
    rows."""
    sub = M.Probes(*(x[:B_SERVE].contiguous() for x in
                     (probes.tok_h1, probes.tok_h2, probes.lengths,
                      probes.roots, probes.sys_mask)), probes.max_len)
    dense, dp = dense_walk_inputs(torch, M, workloads, dev, depth=13)
    out = []
    for label, t, p in (("config 2", trie, sub),
                        ("dense depth 13", dense, dp)):
        for k_states in (32, 512, 1024):
            kw = dict(probe_len=16, k_states=k_states, max_intervals=32)
            r = walk_bound_row(torch, M, [(t, p, 0)], 16, 32, k_states)

            def kern():
                return K.fused_walk_routes(t, p, **kw)
            row = {"case": label, "rows": int(p.tok_h1.shape[0]),
                   "K": k_states, "ms": time_ms(torch, kern, 10),
                   "device_ms": time_device_ms(torch, kern, 10),
                   "plain_ms": time_ms(torch, lambda: M.walk_routes(
                       t, p, esc_k=0, **kw), 2, 1),
                   "bound_ms": bound_ms(r), "bound_by": bound_by(r),
                   "overflow_rows": int(kern().overflow.sum())}
            out.append(row)
    print(json.dumps({"phase": "K2-large-time", "card": smi, "A": 32,
                      "cases": out}), flush=True)
    return out


def _pcts(xs):
    import numpy as np
    a = np.asarray(xs) * 1e3
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)), "mean": float(a.mean()),
            "n": len(xs)}


def churn_phase(torch, M, D, workloads, m, smi):
    """bench.py config 8 on the config-2 matcher: ``CHURN_OPS``
    subscribes, each patched into the 1M-subscription base and flushed to
    the card, then half as many unsubscribes, with a 64-topic
    ``match_batch`` every 8 subscribes. Fails unless no full compile ran,
    the device tables equal the host arenas element for element, the
    walk launched on them, and 256 probe rows plus the churn topics equal
    the host oracle. Returns the phase's summary."""
    from bifromq_tpu_torch.models.oracle import Route
    from bifromq_tpu_torch.types import RouteMatcher

    def mk(tf, rid, inc=0):
        return Route(matcher=RouteMatcher.from_topic_filter(tf),
                     broker_id=0, receiver_id=rid, deliverer_key="d0",
                     incarnation=inc)

    topics = ["/".join(t) for t in
              workloads.probe_topics(CHURN_BATCH * 8, seed=1)]
    mbs = [[("tenant0", t) for t in
            topics[i * CHURN_BATCH:(i + 1) * CHURN_BATCH]] for i in range(8)]
    for wb in mbs:      # warm every batch shape, as bench.py does
        m.match_batch(wb)
    m.add_route("tenant0", mk("bench/churn/warm/+", "w0"))
    m._flush_patches()
    m.match_batch(mbs[0])
    compiles0 = m.compile_count
    fallbacks0, flushes0 = m.patch_fallbacks, m.patch_flushes
    D.reset_launches()
    patch_s, unsub_s, match_s, added = [], [], [], []
    for i in range(CHURN_OPS):
        tf = f"bench/churn/{i}/+"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.add_route("tenant0", mk(tf, f"c{i}", inc=1))
        m._flush_patches()
        torch.cuda.synchronize()
        patch_s.append(time.perf_counter() - t0)
        added.append((tf, f"c{i}"))
        if i % 8 == 4:
            t0 = time.perf_counter()
            m.match_batch(mbs[(i // 8) % 8])
            torch.cuda.synchronize()
            match_s.append(time.perf_counter() - t0)
    for tf, rid in added[:CHURN_OPS // 2]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.remove_route("tenant0", RouteMatcher.from_topic_filter(tf),
                       (0, rid, "d0"), incarnation=1)
        m._flush_patches()
        torch.cuda.synchronize()
        unsub_s.append(time.perf_counter() - t0)
    launches = {k: v.launches for k, v in D.KERNELS.items()}
    base, dev = m._base_ct, m._device_trie
    host = {"node_tab": base.node_tab, "edge_tab": base.edge_tab,
            "child_list": base.child_list,
            "count_tab": M.count_cols_from_node_tab(base.node_tab),
            "route_tab": M.route_cols_from_node_tab(base.node_tab)}
    unequal = [k for k, a in host.items()
               if not (tuple(getattr(dev, k).shape) == a.shape
                       and (getattr(dev, k).cpu().numpy() == a).all())]
    probe = [("tenant0", t) for t in topics[:ORACLE_SAMPLE]]
    probe += [("tenant0", f"bench/churn/{i}/x")
              for i in range(0, CHURN_OPS, 7)]
    got = m.match_batch(probe)
    want = m.match_from_tries(probe)
    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if canon(a) != canon(b)]
    out = {"phase": "churn", "card": smi, "subs": N_SUBS,
           "subscribes": CHURN_OPS, "unsubscribes": CHURN_OPS // 2,
           "match_batch": CHURN_BATCH,
           "patch_apply_ms": _pcts(patch_s), "unsubscribe_ms": _pcts(unsub_s),
           "match_ms_during_churn": _pcts(match_s),
           "full_rebuild_s": m.compile_time_s,
           "full_compiles_in_window": m.compile_count - compiles0,
           "patch_fallbacks": m.patch_fallbacks - fallbacks0,
           "patch_flushes": m.patch_flushes - flushes0,
           "patch": base.patch_stats(), "launches": launches,
           "tables_unequal": unequal, "oracle_rows_checked": len(probe),
           "oracle_rows_differing": len(bad)}
    print(json.dumps(out), flush=True)
    if m.compile_count != compiles0:
        raise AssertionError("the churn window ran a full compile")
    if unequal:
        raise AssertionError(f"patched device tables differ from the host "
                             f"arenas: {unequal}")
    if not launches["fused_walk"]:
        raise AssertionError("the walk never launched during churn")
    if bad:
        raise AssertionError(f"churn rows {bad[:8]} differ from the oracle")
    return out


def cache_phase(torch, D, mp, queries, miss_ms, smi):
    """The match-result cache on the 100K-subscription matcher (cache on,
    the port's default): the peers phase's batch served again launches
    no kernel and returns the very same results; then an exact-filter
    subscribe re-walks only the rows of its topic, and a wildcard
    subscribe every row of the tenant, each checked against the host
    oracle."""
    from bifromq_tpu_torch.models.oracle import Route
    from bifromq_tpu_torch.types import RouteMatcher
    first = mp.match_batch(queries)       # the peers phase's results
    D.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = mp.match_batch(queries)
    hit_ms = (time.perf_counter() - t0) * 1e3
    hit_launches = {k: v.launches for k, v in D.KERNELS.items()}
    same = all(a is b for a, b in zip(again, first))
    out = {"phase": "cache", "card": smi, "rows": len(queries),
           "unique_rows": len(set(queries)), "miss_batch_ms": miss_ms,
           "hit_batch_ms": hit_ms, "hit_launches": hit_launches,
           "hit_results_identical": same}
    if any(hit_launches.values()) or not same:
        print(json.dumps(out), flush=True)
        raise AssertionError("a repeated batch reached the card or "
                             "changed its results")
    for name, tf in (("exact", queries[0][1]), ("wildcard", "+/#")):
        mp.add_route("tenant0", Route(
            matcher=RouteMatcher.from_topic_filter(tf), broker_id=0,
            receiver_id=f"cache-{name}", deliverer_key="srv0|cache"))
        D.reset_launches()
        res = mp.match_batch(queries)
        launched = {k: v.launches for k, v in D.KERNELS.items()}
        pairs, _ = mp.last_expanded
        rewalked = [i for i, (a, b) in enumerate(zip(res, first))
                    if a is not b]
        check = rewalked[:ORACLE_SAMPLE]
        oracle = mp.match_from_tries([queries[i] for i in check])
        bad = [i for i, o in zip(check, oracle) if canon(res[i]) != canon(o)]
        touched = [i for i, q in enumerate(queries) if q[1] == tf]
        out[name] = {"filter": tf, "rows_rewalked": len(rewalked),
                     "device_rows": int(pairs.trunc.shape[-1]),
                     "launches": launched, "oracle_rows_checked": len(check),
                     "oracle_rows_differing": len(bad)}
        first = res
        if bad or not launched["fused_walk"] or (
                name == "exact" and rewalked != touched) or (
                name == "wildcard" and len(rewalked) != len(queries)):
            print(json.dumps(out), flush=True)
            raise AssertionError(f"cache invalidation by a {name} "
                                 f"subscribe went wrong")
    from bifromq_tpu_torch.utils.metrics import MATCH_CACHE
    out["cache"] = mp.match_cache.snapshot()
    out["metrics"] = MATCH_CACHE.snapshot()
    print(json.dumps(out), flush=True)
    return out


PIPE_SUBS = 200_000       # bench.py config 7 (BENCH_PIPE_SUBS default)
PIPE_BIG = 4096
PIPE_SMALL = 16
PIPE_SYNC_ITERS = 8
PIPE_CHURN = 16
PIPE_STALL_CYCLES = 8_000_000  # ~4 ms at 1.98 GHz: the card behind the host


def norm(m):
    """A row route for route, in order (``canon`` compares as sets)."""
    return (tuple((r.matcher.mqtt_topic_filter, r.receiver_url,
                   r.incarnation) for r in m.normal),
            tuple((f, tuple(r.receiver_url for r in ms))
                  for f, ms in m.groups.items()),
            m.persistent_fanout)


def _launches(D):
    return {k: v.launches for k, v in D.KERNELS.items()}


def pipeline_holds(torch, m, shapes, dev):
    """K1, K2 (at the primary and at the escalation budget) and K3 on the
    serving leg's own prepared batches, each held exactly against its
    plain version: ``shapes`` maps a label to (queries, batch), the
    batch as ``match_batch_async`` pads it (``batch=None``: the idle
    ring's latency floor and the busy ring's throughput floor) or as the
    sync leg runs it. The escalation hold walks the sub-batch of the
    primary's overflow rows as the matcher builds it, or the batch's own
    probes when no row overflowed. Returns the max error per kernel."""
    import numpy as np
    from bifromq_tpu_torch.models import kernels as K
    from bifromq_tpu_torch.models.bytetok import TopicBytes
    from bifromq_tpu_torch.models.matcher import _pow2_batch
    from bifromq_tpu_torch.ops import match as M
    from bifromq_tpu_torch.ops import tokenize as T

    ct = m._base_ct
    trie = m._device_trie
    esc_k, esc_a = m._escalation_budget()
    err = {"blake2b_levels": 0, "fused_walk": 0, "expand_pairs": 0}
    out = {}
    for label, (queries, batch) in shapes.items():
        prep = m._prepare_probes(queries, batch)
        lengths, _, _, rows_b, starts, lens = T.pack_topic_bytes(
            TopicBytes.from_topics([t for _, t in queries]), prep.roots,
            max_levels=ct.max_levels, batch=batch)
        args = [torch.from_numpy(a).to(dev) for a in
                (rows_b, starts, lens, lengths.reshape(batch, 1))]
        h0 = T.h0_tensor(ct.salt, dev)
        want = T._hash_lanes(*args, h0)
        e1 = max(max_abs_err(torch, T.blake2b_levels(*args, h0), want),
                 max_abs_err(torch, [prep.probes.tok_h1, prep.probes.tok_h2],
                             want))
        ivl, e2 = k2_hold(torch, K, M, trie, prep.probes, m.k_states,
                          m.max_intervals, ct.probe_len, f"pipeline {label}")
        ovf = np.nonzero(ivl.overflow.cpu().numpy()[:len(queries)]
                         & (prep.tok.lengths[:len(queries)] >= 0))[0]
        sub = (M.Probes.from_tokenized(
            prep.tok.sub_batch(ovf, _pow2_batch(len(ovf))), device=dev)
            if len(ovf) else prep.probes)
        e2 = max(e2, k2_hold(torch, K, M, trie, sub, esc_k, esc_a,
                             ct.probe_len,
                             f"pipeline {label} escalation")[1])
        cap = batch * M.expand_cap_lanes()
        serve_c = torch.where(ivl.overflow[:, None], 0, ivl.count)
        got = K.kernel_expand(ivl.start, serve_c, cap=cap)
        e3 = max_abs_err(torch, list(got),
                         list(M._expand_pairs(ivl.start, serve_c, cap)))
        torch.cuda.synchronize()
        for k, e in zip(err, (e1, e2, e3)):
            err[k] = max(err[k], e)
        out[label] = {"batch": batch, "topics": len(queries),
                      "overflow_rows": int(len(ovf)),
                      "escalation_rows": int(sub.tok_h1.shape[0]),
                      "expand_cap": cap, "pairs": int(got[3]),
                      "max_abs_err": {"K1": e1, "K2": e2, "K3": e3}}
    print(json.dumps({"phase": "pipeline-holds", "K": m.k_states,
                      "A": m.max_intervals, "escalation": [esc_k, esc_a],
                      "cases": out}), flush=True)
    if any(err.values()):
        raise AssertionError(f"pipeline: a kernel differs from its plain "
                             f"version at the serving leg's shapes: {out}")
    return err


def pipeline_phase(torch, D, workloads, smi, dev):
    """bench.py config 7 (``bench_config7``) on the port: the sync leg
    (8 blocking ``match_batch`` calls of 4096 topics) against the
    pipelined leg (the same stream as 2048 batches of 16 topics through
    ``match_batch_async``, ``pipeline_depth()`` asyncio workers), on
    ``config_wildcard(200_000)`` with the cache off. K1, K2 and K3 are
    first held against their plain versions on the leg's own prepared
    batches (``pipeline_holds``). The launch counts are reset just before
    the pipelined leg and read just after; K1, K2 and K3 must each have
    launched. Checks: 256 sampled pipelined rows equal the sync leg's
    route for route in order, and the host oracle's as sets (the oracle
    walks its trie in another order); no batch was degraded. The leg's
    ring occupancy (``peak_in_flight``) and its dispatches made while an
    earlier batch was still on the card (``overlapped``) are reported:
    at 16 topics the card finishes a batch within its own enqueue, so
    there may be nothing to overlap. Then the same leg again with the
    card made slower than the host — a sleep kernel of
    ``PIPE_STALL_CYCLES`` ahead of each walk — and 16 subscribes
    (``bench/churn/{i}/+``) landing between dispatches, each batch's last
    topic on a churn filter: batch N+1 must dispatch while N is still on
    the card (peak in flight 2, at least one overlapped dispatch), every
    churn row equal the oracle as of its batch's dispatch, 256 other rows
    the oracle, and at least one patch flush write new tables because a
    batch was in flight. Returns the phase's summary."""
    import asyncio

    import numpy as np
    from bifromq_tpu_torch.models.matcher import TorchMatcher, _pow2_batch
    from bifromq_tpu_torch.models.oracle import Route
    from bifromq_tpu_torch.models.pipeline import pipeline_depth
    from bifromq_tpu_torch.types import RouteMatcher
    from bifromq_tpu_torch.utils.metrics import STAGES

    t0 = time.perf_counter()
    m = TorchMatcher.from_tries(workloads.config_wildcard(PIPE_SUBS, seed=0),
                                device=dev, match_cache=False,
                                auto_compact=False)
    build_s = time.perf_counter() - t0
    topics = ["/".join(t) for t in workloads.probe_topics(4 * PIPE_BIG,
                                                          seed=1)]
    batches = [[("tenant0", t) for t in topics[i * PIPE_BIG:
                                               (i + 1) * PIPE_BIG]]
               for i in range(4)]
    # ---- sync leg
    m.match_batch(batches[0])
    sync_rows = [None] * len(topics)
    lat = []
    t0 = time.perf_counter()
    for it in range(PIPE_SYNC_ITERS):
        s0 = time.perf_counter()
        res = m.match_batch(batches[it % 4])
        lat.append(time.perf_counter() - s0)
        if it < 4:
            sync_rows[it * PIPE_BIG:(it + 1) * PIPE_BIG] = res
    sync_s = time.perf_counter() - t0
    sync = {"batch": PIPE_BIG, "batches": PIPE_SYNC_ITERS,
            "topics_per_s": PIPE_BIG * PIPE_SYNC_ITERS / sync_s,
            "batch_p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "batch_p99_ms": float(np.percentile(lat, 99)) * 1e3}
    # ---- pipelined leg
    n_small = max(1, min(PIPE_BIG * PIPE_SYNC_ITERS // PIPE_SMALL, 2048))
    ring = m._pipeline_ring()
    holds = pipeline_holds(torch, m, {
        "idle": (batches[0][:PIPE_SMALL],
                 _pow2_batch(PIPE_SMALL, floor=ring.min_floor)),
        "busy": (batches[0][PIPE_SMALL:2 * PIPE_SMALL],
                 _pow2_batch(PIPE_SMALL, floor=ring.base_floor)),
        "sync": (batches[0], _pow2_batch(PIPE_BIG))}, dev)

    def small_batches(churn: bool):
        out = []
        for j in range(n_small):
            b = [("tenant0", topics[(j * PIPE_SMALL + k) % len(topics)])
                 for k in range(PIPE_SMALL)]
            if churn:
                b[-1] = ("tenant0", f"bench/churn/{j % PIPE_CHURN}/x")
            out.append(b)
        return out

    def run(sm, churner=None):
        lats, results, degraded = [], [None] * len(sm), []
        nxt = {"i": 0}

        async def worker():
            while nxt["i"] < len(sm):
                j = nxt["i"]
                nxt["i"] += 1
                stats = {}
                s0 = time.perf_counter()
                results[j] = await m.match_batch_async(sm[j], batch=None,
                                                       stats=stats)
                lats.append(time.perf_counter() - s0)
                if "degraded" in stats:
                    degraded.append((j, stats["degraded"]))

        async def main_():
            workers = [asyncio.ensure_future(worker())
                       for _ in range(pipeline_depth())]
            side = (asyncio.ensure_future(churner(workers))
                    if churner is not None else None)
            await asyncio.gather(*workers)
            if side is not None:
                await side

        t0 = time.perf_counter()
        asyncio.run(main_())
        return results, lats, degraded, time.perf_counter() - t0

    from bifromq_tpu_torch.utils.metrics import FABRIC, FabricMetric
    deg0 = FABRIC.get(FabricMetric.MATCH_DEGRADED)
    sm = small_batches(False)
    asyncio.run(m.match_batch_async(sm[0]))       # the ring and its shapes
    STAGES.reset()
    ring.peak_inflight = 0
    ov0 = ring.overlapped_total
    torch.cuda.synchronize()
    D.reset_launches()
    results, lats, degraded, pipe_s = run(sm)
    torch.cuda.synchronize()
    launched = _launches(D)
    pipe = {"batch": PIPE_SMALL, "batches": len(sm),
            "topics_per_s": PIPE_SMALL * len(sm) / pipe_s,
            "batch_p50_ms": float(np.percentile(lats, 50)) * 1e3,
            "batch_p99_ms": float(np.percentile(lats, 99)) * 1e3,
            "peak_in_flight": ring.peak_inflight,
            "overlapped": ring.overlapped_total - ov0,
            "ring_depth": ring.depth, "launches": launched,
            "degraded_batches": len(degraded)}
    stages = {k: v for k, v in STAGES.snapshot().items()
              if k.startswith("device") or k == "tokenize"}
    # ---- checks
    flat = [(q, r) for b, rs in zip(sm, results) for q, r in zip(b, rs)]
    step = max(1, len(flat) // ORACLE_SAMPLE)
    sample = list(range(0, len(flat), step))[:ORACLE_SAMPLE]
    oracle = m.match_from_tries([flat[i][0] for i in sample])
    topic_pos = {t: i for i, t in enumerate(topics)}
    bad_sync = [i for i in sample if norm(flat[i][1])
                != norm(sync_rows[topic_pos[flat[i][0][1]]])]
    bad_oracle = [i for i, o in zip(sample, oracle)
                  if canon(flat[i][1]) != canon(o)]
    n_checked = len(sample)
    missing = [k for k in ("blake2b_levels", "fused_walk", "expand_pairs")
               if not launched[k]]
    if (bad_sync or bad_oracle or degraded or missing
            or FABRIC.get(FabricMetric.MATCH_DEGRADED) != deg0):
        raise AssertionError(
            f"pipeline: rows {bad_sync[:8]} differ from the sync leg, "
            f"{bad_oracle[:8]} from the oracle; degraded {degraded[:8]}; "
            f"kernels not launched {missing}")
    # ---- the same leg with subscribes landing between dispatches
    churn_sm = small_batches(True)
    churn_topics = [f"bench/churn/{i}/x" for i in range(PIPE_CHURN)]
    base_churn = m.match_from_tries([("tenant0", t) for t in churn_topics])
    applied = {"n": 0}
    at_dispatch = {}
    real_dispatch = m._dispatch_prepared

    def recording_dispatch(prep, **kw):
        # which subscribes this batch's tables hold: the ones applied
        # before its dispatch
        at_dispatch[id(prep.queries[-1])] = applied["n"]
        torch.cuda._sleep(PIPE_STALL_CYCLES)
        return real_dispatch(prep, **kw)

    async def churner(workers):
        # the i-th subscribe lands once (i + 1/2) / 16 of the batches have
        # dispatched, while a batch is in flight
        every = max(2, n_small // PIPE_CHURN)
        while applied["n"] < PIPE_CHURN and not all(w.done()
                                                    for w in workers):
            await asyncio.sleep(0)
            due = d0 + applied["n"] * every + every // 2
            if ring.dispatched_total >= due and ring.in_flight:
                i = applied["n"]
                m.add_route("tenant0", Route(
                    RouteMatcher.from_topic_filter(f"bench/churn/{i}/+"),
                    0, f"churn{i}", "d0", 0))
                applied["n"] += 1

    m._dispatch_prepared = recording_dispatch
    d0, und0 = ring.dispatched_total, m.patch_flushes_undonated
    ring.peak_inflight = 0
    ov0 = ring.overlapped_total
    try:
        results, lats_c, degraded, churn_s = run(churn_sm, churner)
    finally:
        del m._dispatch_prepared
    bad_churn = []
    for j, (b, rs) in enumerate(zip(churn_sm, results)):
        i = j % PIPE_CHURN
        n = at_dispatch[id(b[-1])]
        want = canon(base_churn[i])
        if i < n:
            want = (sorted(want[0] + [(f"bench/churn/{i}/+",
                                       (0, f"churn{i}", "d0"))]), want[1])
        if canon(rs[-1]) != want:
            bad_churn.append(j)
    flat = [(q, r) for b, rs in zip(churn_sm, results)
            for q, r in list(zip(b, rs))[:-1]]
    sample = list(range(0, len(flat), max(1, len(flat) // ORACLE_SAMPLE)))
    oracle = m.match_from_tries([flat[i][0] for i in sample])
    bad_rows = [i for i, o in zip(sample, oracle)
                if canon(flat[i][1]) != canon(o)]
    undonated = m.patch_flushes_undonated - und0
    churn = {"subscribes": applied["n"], "batches": len(churn_sm),
             "stall_cycles_per_dispatch": PIPE_STALL_CYCLES,
             "peak_in_flight": ring.peak_inflight,
             "overlapped": ring.overlapped_total - ov0,
             "undonated_flushes": undonated,
             "flushes": m.patch_flushes, "degraded_batches": len(degraded),
             "batch_p50_ms": float(np.percentile(lats_c, 50)) * 1e3,
             "batch_p99_ms": float(np.percentile(lats_c, 99)) * 1e3,
             "topics_per_s": PIPE_SMALL * len(churn_sm) / churn_s}
    out = {"phase": "pipeline", "card": smi, "subs": PIPE_SUBS,
           "build_s": build_s, "sync": sync, "pipelined": pipe,
           "batch_p99_speedup": sync["batch_p99_ms"] / pipe["batch_p99_ms"],
           "stage_latency_ms": stages,
           "rows_checked": n_checked, "churn": churn,
           "max_abs_err": holds}
    print(json.dumps(out), flush=True)
    if (bad_churn or bad_rows or undonated < 1 or degraded
            or applied["n"] < PIPE_CHURN or churn["peak_in_flight"] < 2
            or churn["overlapped"] < 1):
        raise AssertionError(
            f"pipeline churn: churn rows {bad_churn[:8]} and rows "
            f"{bad_rows[:8]} differ from the oracle as of dispatch, "
            f"{undonated} undonated flushes, degraded {degraded[:8]}, "
            f"peak in flight {churn['peak_in_flight']}, "
            f"{churn['overlapped']} overlapped dispatches")
    return out


DIST_SUBS = 200_000       # bench.py config 7's population (BENCH_PIPE_SUBS)
DIST_LOAD_CHUNK = 1000    # gathered subscribes, as the consensus churn test
DIST_PUBS = 4096
DIST_WINDOW = 256
DIST_CHURN = 64
DIST_SPLIT_PUBS = 512


def fan_out_order(rows):
    """The delivery order ``DistService._fan_out_inner`` gives a row of
    normal routes: grouped per (broker, deliverer key) in order of first
    appearance, each group in row order."""
    groups = {}
    for r in rows:
        groups.setdefault((r.broker_id, r.deliverer_key), []).append(r)
    return [(b, dk, r.receiver_id) for (b, dk), rs in groups.items()
            for r in rs]


def union_rows(per_range, mpf: int, mgf: int):
    """Rows of the ranges a tenant spans, unioned in range order with the
    tenant's caps applied again over the union (``DistWorker.match_batch``
    on a tenant that straddles a split)."""
    from bifromq_tpu_torch.models.oracle import (PERSISTENT_SUB_BROKER_ID,
                                                 MatchedRoutes)
    out = []
    for ms in zip(*per_range):
        merged = MatchedRoutes()
        groups = {}
        for m in ms:
            for r in m.normal:
                if r.broker_id == PERSISTENT_SUB_BROKER_ID:
                    if merged.persistent_fanout >= mpf:
                        merged.max_persistent_fanout_exceeded = True
                        continue
                    merged.persistent_fanout += 1
                merged.normal.append(r)
            for f, members in m.groups.items():
                groups.setdefault(f, []).extend(members)
        for f, members in groups.items():
            if len(merged.groups) >= mgf:
                merged.max_group_fanout_exceeded = True
                continue
            merged.groups[f] = members
        out.append(merged)
    return out


def dist_phase(torch, D, workloads, smi):
    """The dist plane on the card — the broker's publish path through
    its user entry points: ``DistService(SubBrokerRegistry(),
    CollectingEventCollector(), DefaultSettingProvider())`` over a default
    ``DistWorker()`` (one voter, one range, the in-memory engine, the
    coproc's ``TorchMatcher()`` on the card, the pub cache on).

    - Load: the routes of bench.py config 7's population
      (``config_wildcard(200_000, seed=0)``) as ``DistService.match``
      calls through consensus, gathered 1000 at a time.
    - Publish: 4096 ``probe_topics(4096, seed=1)`` publishes through
      ``DistService.pub`` in gathered windows of 256, with the launch
      counts reset just before and read just after (K1, K2 and K3 must
      each have launched). Every publish's fan-out equals the host
      oracle's route count under the tenant's caps; 256 sampled
      publishes delivered exactly the (broker, deliverer key, receiver)
      list, in order, that the fan-out makes of the sync device leg's
      row, and that row equals the host oracle's.
    - Churn: 64 subscribes ``bench/churn/{i}/+``, each followed by a
      publish of ``bench/churn/{i}/x`` that must reach the new receiver;
      then 64 unsubscribes, each followed by one that must not.
    - Split: ``store.split`` at the median route key, then 512 publishes
      checked in full against the union of the two ranges' rows.

    No publish may be degraded, and every matcher drains at the end.
    Returns the phase's summary."""
    import asyncio

    import numpy as np
    from bifromq_tpu_torch.dist.service import DistService
    from bifromq_tpu_torch.kv import schema
    from bifromq_tpu_torch.plugin.events import (CollectingEventCollector,
                                                 EventType)
    from bifromq_tpu_torch.plugin.settings import (DefaultSettingProvider,
                                                   Setting)
    from bifromq_tpu_torch.plugin.subbroker import (DeliveryResult,
                                                    ISubBroker,
                                                    SubBrokerRegistry)
    from bifromq_tpu_torch.types import (ClientInfo, Message, QoS,
                                         RouteMatcher)
    from bifromq_tpu_torch.utils.hlc import HLC
    from bifromq_tpu_torch.utils.metrics import (FABRIC, STAGES,
                                                 FabricMetric)

    delivered = []      # (publish index, broker, deliverer key, receiver)

    class Collecting(ISubBroker):
        def __init__(self, broker_id: int) -> None:
            self.id = broker_id

        async def deliver(self, tenant_id, deliverer_key, packs):
            out = {}
            for dp in packs:
                for pmp in dp.message_pack.packs:
                    for msg in pmp.messages:
                        idx = int(msg.payload)
                        for mi in dp.match_infos:
                            delivered.append((idx, self.id, deliverer_key,
                                              mi.receiver_id))
                for mi in dp.match_infos:
                    out[mi] = DeliveryResult.OK
            return out

    registry = SubBrokerRegistry()
    for b in (0, 1):
        registry.register(Collecting(b))
    events = CollectingEventCollector()
    settings = DefaultSettingProvider()
    tenant = "tenant0"
    mpf = settings.provide(Setting.MaxPersistentFanout, tenant) \
        or Setting.MaxPersistentFanout.default
    mgf = settings.provide(Setting.MaxGroupFanout, tenant) \
        or Setting.MaxGroupFanout.default
    publisher = ClientInfo(tenant_id=tenant)
    deg0 = FABRIC.get(FabricMetric.MATCH_DEGRADED)
    t_phase = time.perf_counter()
    out = {"phase": "dist", "card": smi, "subs": DIST_SUBS}

    async def publish(indices_topics, lats=None):
        """One window of publishes; each payload carries its index."""
        async def one(idx, topic):
            s0 = time.perf_counter()
            r = await svc.pub(publisher, topic, Message(
                message_id=idx, pub_qos=QoS.AT_MOST_ONCE,
                payload=str(idx).encode(), timestamp=HLC.INST.get()))
            if lats is not None:
                lats.append(time.perf_counter() - s0)
            return r
        return await asyncio.gather(*(one(i, t) for i, t in indices_topics))

    def by_publish(start: int):
        """The deliveries recorded from ``delivered[start]`` on, per
        publish index."""
        got = {}
        for idx, b, dk, recv in delivered[start:]:
            got.setdefault(idx, []).append((b, dk, recv))
        return got

    def check(rows_device, rows_oracle, results, got, first_idx, full):
        """Fan-out counts against the oracle for every publish; the
        delivered lists of ``full`` (indices into the window) in order
        against the fan-out of the device rows, which must equal the
        oracle's as sets."""
        bad = []
        for j, (res, o) in enumerate(zip(results, rows_oracle)):
            want = len(o.normal) + sum(1 for ms in o.groups.values() if ms)
            if not (res.ok and res.fanout == want):
                bad.append(("fanout", first_idx + j, res.fanout, want))
        for j in full:
            d, o = rows_device[j], rows_oracle[j]
            if o.groups or canon(d) != canon(o):
                bad.append(("row", first_idx + j))
            elif got.get(first_idx + j, []) != fan_out_order(d.normal):
                bad.append(("delivered", first_idx + j))
        return bad

    async def run():
        nonlocal svc
        svc = DistService(registry, events, settings)
        await svc.start()
        worker = svc.worker
        # ---- load: config 7's routes through consensus
        routes = list(workloads.config_wildcard(DIST_SUBS, seed=0)
                      [tenant].routes())
        sched = worker._mutation_scheduler
        t0 = time.perf_counter()
        for c in range(0, len(routes), DIST_LOAD_CHUNK):
            oks = await asyncio.gather(*(
                svc.match(tenant, r.matcher, r.broker_id, r.receiver_id,
                          r.deliverer_key, r.incarnation)
                for r in routes[c:c + DIST_LOAD_CHUNK]))
            if not all(oks):
                raise AssertionError(f"dist load: {oks.count(False)} "
                                     f"subscribes refused")
        load_s = time.perf_counter() - t0
        m = worker.matcher
        out["load"] = {
            "seconds": load_s, "mutations_per_s": len(routes) / load_s,
            "raft_entries": sum(sched.batcher(rid).batches_emitted
                                for rid in worker.store.ranges),
            "compiles": m.compile_count, "compile_s": m.compile_time_s,
            "patches": m.patch_count, "patch_fallbacks": m.patch_fallbacks,
            "patch_flushes": m.patch_flushes, "keys": len(worker.space)}
        print(json.dumps({"phase": "dist-load", **out["load"]}), flush=True)

        # ---- publish: 4096 probe topics in gathered windows of 256
        topics = ["/".join(t) for t in workloads.probe_topics(DIST_PUBS,
                                                             seed=1)]
        await publish([(0, topics[0])])        # the ring and the pub batcher
        delivered.clear()
        STAGES.reset()
        lats, results = [], []
        torch.cuda.synchronize()
        D.reset_launches()
        t0 = time.perf_counter()
        for w in range(0, DIST_PUBS, DIST_WINDOW):
            results += await publish(
                [(i, topics[i]) for i in range(w, w + DIST_WINDOW)], lats)
        torch.cuda.synchronize()
        pub_s = time.perf_counter() - t0
        launched = _launches(D)
        n_deliv = len(delivered)
        stages = STAGES.snapshot()
        t0 = time.perf_counter()
        queries = [(tenant, t) for t in topics]
        oracle = m.match_from_tries(queries, max_persistent_fanout=mpf,
                                    max_group_fanout=mgf)
        step = DIST_PUBS // ORACLE_SAMPLE
        sample = list(range(0, DIST_PUBS, step))[:ORACLE_SAMPLE]
        device_rows = [None] * DIST_PUBS
        for i, r in zip(sample, m._match_batch_device(
                [queries[i] for i in sample], max_persistent_fanout=mpf,
                max_group_fanout=mgf)):
            device_rows[i] = r
        bad = check(device_rows, oracle, results, by_publish(0), 0, sample)
        out["publish"] = {
            "publishes": DIST_PUBS, "window": DIST_WINDOW,
            "publishes_per_s": DIST_PUBS / pub_s,
            "deliveries": n_deliv, "deliveries_per_s": n_deliv / pub_s,
            "fanout_mean": n_deliv / DIST_PUBS,
            "pub_latency_ms": _pcts(lats), "launches": launched,
            "rows_checked": len(sample),
            "check_s": time.perf_counter() - t0, "stage_latency_ms": stages,
            "pub_cache": svc._match_cache.snapshot(),
            "bad": bad[:8]}
        missing = [k for k in ("blake2b_levels", "fused_walk",
                               "expand_pairs") if not launched[k]]
        if missing or bad:
            raise AssertionError(f"dist publish: kernels not launched "
                                 f"{missing}, mismatches {bad[:8]}")

        # ---- churn: a subscribe is seen by the very next publish, an
        # unsubscribe by the next one after it
        idx = DIST_PUBS
        churn_bad = []
        t0 = time.perf_counter()
        for sub in (True, False):
            for i in range(DIST_CHURN):
                f = RouteMatcher.from_topic_filter(f"bench/churn/{i}/+")
                recv = f"churn{i}"
                if sub:
                    ok = await svc.match(tenant, f, 0, recv, "dchurn")
                else:
                    ok = await svc.unmatch(tenant, f, 0, recv, "dchurn")
                topic = f"bench/churn/{i}/x"
                n0 = len(delivered)
                (res,) = await publish([(idx, topic)])
                got = by_publish(n0).get(idx, [])
                (o,) = m.match_from_tries([(tenant, topic)],
                                          max_persistent_fanout=mpf,
                                          max_group_fanout=mgf)
                if not (ok and ((0, "dchurn", recv) in got) == sub
                        and res.fanout == len(o.normal) == len(got)):
                    churn_bad.append((sub, i, ok, res.fanout, len(got)))
                idx += 1
        out["churn"] = {"subscribes": DIST_CHURN,
                        "unsubscribes": DIST_CHURN,
                        "seconds": time.perf_counter() - t0,
                        "patches": m.patch_count,
                        "compiles": m.compile_count, "bad": churn_bad[:8]}
        if churn_bad:
            raise AssertionError(f"dist churn: {churn_bad[:8]}")

        # ---- split at the median route key: the tenant straddles two
        # ranges, each with its own TorchMatcher on the card
        (rid,) = list(worker.store.ranges)
        keys = [k for k, _ in worker.store.ranges[rid].space.iterate()]
        t0 = time.perf_counter()
        await worker.store.split(rid, keys[len(keys) // 2])
        split_s = time.perf_counter() - t0
        pfx = schema.tenant_route_prefix(tenant)
        rids = worker.store.router.intersecting(pfx, schema.prefix_end(pfx))
        if len(rids) != 2:
            raise AssertionError(f"dist split: the tenant spans {rids}")
        coprocs = [worker.store.coprocs[r] for r in rids]
        split_topics = ["/".join(t) for t in
                        workloads.probe_topics(DIST_SPLIT_PUBS, seed=2)]
        base, n0 = idx, len(delivered)
        D.reset_launches()
        results = await publish([(base + j, t)
                                 for j, t in enumerate(split_topics)])
        split_launches = _launches(D)
        t0 = time.perf_counter()
        queries = [(tenant, t) for t in split_topics]
        kw = dict(max_persistent_fanout=mpf, max_group_fanout=mgf)
        device_rows = union_rows([c.matcher._match_batch_device(queries, **kw)
                                  for c in coprocs], mpf, mgf)
        oracle = union_rows([c.matcher.match_from_tries(queries, **kw)
                             for c in coprocs], mpf, mgf)
        bad = check(device_rows, oracle, results, by_publish(n0), base,
                    range(DIST_SPLIT_PUBS))
        out["split"] = {"seconds": split_s, "ranges": len(worker.store.ranges),
                        "keys": [len(worker.store.ranges[r].space)
                                 for r in rids],
                        "publishes": DIST_SPLIT_PUBS,
                        "check_s": time.perf_counter() - t0,
                        "launches": split_launches, "bad": bad[:8]}
        if bad or not split_launches["fused_walk"]:
            raise AssertionError(f"dist split: launches {split_launches}, "
                                 f"mismatches {bad[:8]}")

        # ---- every range's matcher drains, then the service stops
        t0 = time.perf_counter()
        drained = [await c.matcher.drain_device()
                   for c in worker.store.coprocs.values()]
        await svc.stop()
        out["stop"] = {"drained": drained,
                       "seconds": time.perf_counter() - t0}
        if not all(drained):
            raise AssertionError(f"dist: a matcher did not drain {drained}")

    svc = None
    try:
        asyncio.run(run())
    finally:
        out["seconds"] = time.perf_counter() - t_phase
        out["match_degraded"] = FABRIC.get(FabricMetric.MATCH_DEGRADED) - deg0
        out["degraded_events"] = len(events.of(EventType.MATCH_DEGRADED))
        print(json.dumps(out), flush=True)
    if out["match_degraded"] or out["degraded_events"]:
        raise AssertionError(f"dist: {out['match_degraded']} rows served "
                             f"degraded")
    return out


RET_TOPICS = 1_000_000   # BASELINE config 4 has 5M; cut to 1M (PERF.md section 4)
RET_BATCH = 4096         # bench.py config 4's batch
RET_BATCHES = 4
RET_LIMIT = 10           # RetainMessageMatchLimit's default
RET_EXACT_ROWS = 64
RET_MUTATIONS = 2048
RET_SCAN_EVERY = 256
RET_CHURN_BATCH = 512
RET_ORACLE_PROCS = 4
# cuts that keep the script inside its time (PERF.md section 4): the
# unlimited leg serves 2 of the 4 batches, and the restart leg reopens a
# service of 100K topics, not the 1M one
RET_UNLIMITED_BATCHES = 2
RET_RESTART_TOPICS = 100_000
RET_HIT_ROWS = 256       # half the scan cache's 512 filters a tenant
RET_ALL = 1 << 30        # a service limit no row reaches
# the key of the seeded payload each retained topic carries
RET_PAYLOAD_KEY = b"config4-retained-seed-4"


def ret_payload(topic: str) -> bytes:
    """The payload the phase writes for ``topic``, from the seed."""
    import hashlib
    return hashlib.blake2b(topic.encode(), digest_size=16,
                           key=RET_PAYLOAD_KEY).digest()

# the oracle worker's own copy of the config-4 trie (set in the worker)
_RET_TRIE = None


def _oracle_init(n_topics: int) -> None:
    """Build config 4's trie in a spawned oracle worker, from the seed,
    in the order the phase adds the topics to its index."""
    global _RET_TRIE
    from bifromq_tpu_torch import workloads
    from bifromq_tpu_torch.models.oracle import SubscriptionTrie
    from bifromq_tpu_torch.models.retained import _topic_route
    _RET_TRIE = SubscriptionTrie()
    for levels in workloads.config_retained(n_topics, seed=0)["tenant0"]:
        _RET_TRIE.add(_topic_route(levels, "/".join(levels)))


def _oracle_limited(filters):
    from bifromq_tpu_torch.models.retained import match_filter_host
    return [len(match_filter_host(_RET_TRIE, f, limit=RET_LIMIT))
            for f in filters]


def filter_matches(topic: str, filt) -> bool:
    """The MQTT rule, written here independently of the package: '+'
    one level, '#' the rest (the parent included), and no root-level
    wildcard reaches a '$' topic [MQTT-4.7.2-1]."""
    lv = topic.split("/")
    if filt and filt[0] in ("+", "#") and lv[0].startswith("$"):
        return False
    for i, f in enumerate(filt):
        if f == "#":
            return True
        if i >= len(lv) or (f != "+" and f != lv[i]):
            return False
    return len(lv) == len(filt)


def check_limited(rows, filters, oracle_lens, what: str) -> None:
    """Limit-10 rows: the oracle's length, topics that match, no
    duplicates."""
    for i, (got, f, n) in enumerate(zip(rows, filters, oracle_lens)):
        if len(got) != n or len(set(got)) != len(got) \
                or not all(filter_matches(tp, f) for tp in got):
            raise AssertionError(f"{what} row {i} {f}: {len(got)} topics "
                                 f"{got[:4]}, oracle {n}")


def retained_phase(torch, D, T, workloads, smi, dev):
    """BASELINE config 4 on the card: ``config_retained(1_000_000,
    seed=0)`` (cut from 5M), each topic with a seeded payload, retained
    through ``RetainService.retain`` (consensus on the retain range, the
    coproc patching the range's ``RetainedIndex(max_levels=18,
    k_states=16)``), probed with ``probe_filters(seed=2)``.

    - Print retains/s and the compile the first scan runs.
    - On the service's index: serve 4 batches of 4096 filters with
      ``limit=10``, then the first unlimited, with the launch counts reset
      just before and read just after: K1 must have launched on each
      batch, K2, K3 and K4 never. Every limit-10 row has the oracle's
      length (``match_filter_host`` with ``limit=10``, in spawned
      workers), only topics that match the filter by the MQTT rule and no
      duplicate; 64 seeded rows unlimited pass the same checks and equal
      the oracle's, sorted, and are served once more as one batch to
      count the rows the host matcher served (``RetainedIndex.
      host_rows``). K1's filter hashes equal its plain version on one
      batch, and the probes equal the host tokenizer's. One limit-10
      batch is timed stage by stage.
    - Serve the same 4 batches through ``RetainService.match_batch`` at
      ``limit=10`` (the range's scan plane), launch counts reset just
      before and read just after (K1 once a batch, nothing else): every
      row's topics equal, in order, the index's limit-10 row, and every
      hit carries its topic's payload. Then 256 distinct filters of the
      phase served twice: every row of the second a cache hit, rows
      identical to the first's and to the index's, no launch.
    - Send 2,048 seeded set / clear mutations through ``retain`` (a clear
      is an empty payload), each flushed to the card: after each, the
      cached filters the mutated topic matches, and only those, are
      evicted. A 512-filter limit-10 service scan after every 256 (64
      sampled rows checked as above) and the churned topics' own filters
      served unlimited by the index and equal to the oracle. No full
      compile may run, and at the end the five device tables equal the
      host arenas.
    - Restart (cut to the first 100K topics, retained through a service
      of their own): stop the service and open a second one over the
      same engine; its index rebuilds from KV (``RetainCoProc.reset``).
      Its rows for the 64 seeded filters equal the first service's
      (topics and payloads, as sets: a rebuilt index orders its slots by
      key).
    No scan may be degraded. Returns the phase's summary."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    filters = workloads.probe_filters(RET_BATCH * RET_BATCHES, seed=2)
    # the limit-10 oracle runs in spawned workers, each on its own trie,
    # while this process builds the index; a worker that dies breaks the
    # pool, and its futures raise
    pool = ProcessPoolExecutor(
        RET_ORACLE_PROCS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_oracle_init, initargs=(RET_TOPICS,))
    import asyncio
    import gc
    loop = asyncio.new_event_loop()
    gc_timer = GCTimer()
    gc.callbacks.append(gc_timer)
    try:
        pending = [pool.submit(_oracle_limited, filters[i:i + 256])
                   for i in range(0, len(filters), 256)]
        out, exact_q = _retained_serve(
            torch, D, T, workloads, smi, dev, filters, pending,
            loop.run_until_complete)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    try:
        out["restart"] = _retained_restart(
            torch, dev, smi, workloads, exact_q, loop.run_until_complete)
    finally:
        loop.close()
        gc.callbacks.remove(gc_timer)
    out["seconds"] += out["restart"]["seconds"]
    out["gc_s"] = gc_timer.seconds
    print(json.dumps({"phase": "retained-total", "card": smi,
                      "seconds": out["seconds"], "gc_s": gc_timer.seconds}),
          flush=True)
    return out


class GCTimer:
    """A ``gc.callbacks`` hook summing the seconds the collector runs."""

    def __init__(self) -> None:
        self.seconds = 0.0
        self._t0 = None

    def __call__(self, phase, info) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self._t0 = None


def _retain_service(dev, engine=None):
    from bifromq_tpu_torch.models.retained import RetainedIndex
    from bifromq_tpu_torch.plugin.events import CollectingEventCollector
    from bifromq_tpu_torch.retain.service import RetainService
    return RetainService(CollectingEventCollector(), engine=engine,
                         index=RetainedIndex(max_levels=18, k_states=16,
                                             device=dev))


def _retain_msg(i: int, topic: str, clear: bool = False):
    from bifromq_tpu_torch.types import Message, QoS
    return Message(message_id=i, pub_qos=QoS.AT_LEAST_ONCE,
                   payload=b"" if clear else ret_payload(topic),
                   timestamp=0, is_retain=True)


def check_hits(rows, what: str) -> None:
    """Every service hit carries its topic's seeded payload."""
    for i, row in enumerate(rows):
        for tp, msg in row:
            if msg.payload != ret_payload(tp):
                raise AssertionError(f"{what} row {i}: {tp} carries "
                                     f"{msg.payload!r}")


def _retained_serve(torch, D, T, workloads, smi, dev, filters, pending,
                    run):
    """The body of :func:`retained_phase` up to the restart; ``pending``
    holds the futures of the limit-10 oracle's lengths of ``filters``, in
    order, and ``run`` runs a coroutine on the phase's event loop.
    Returns the summary and the 64 seeded queries."""
    import random

    import numpy as np

    from bifromq_tpu_torch.models.automaton import tokenize_filters
    from bifromq_tpu_torch.models.retained import match_filter_host
    from bifromq_tpu_torch.ops import retained as R
    from bifromq_tpu_torch.types import ClientInfo
    from bifromq_tpu_torch.utils import nativelib
    t_phase = time.perf_counter()
    marks = {}      # seconds since the phase began, at each leg's start

    def mark(name):
        marks[name] = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    topics = workloads.config_retained(RET_TOPICS, seed=0)["tenant0"]
    gen_s = time.perf_counter() - t0
    svc = _retain_service(dev)
    coproc = next(iter(svc.kvstore.coprocs.values()))
    plane = coproc.scan_plane
    pub = ClientInfo(tenant_id="tenant0")

    async def load():
        for i, levels in enumerate(topics):
            tp = "/".join(levels)
            await svc.retain(pub, tp, _retain_msg(i, tp))
    t0 = time.perf_counter()
    run(load())
    load_s = time.perf_counter() - t0
    idx = svc.index
    if svc.topic_count("tenant0") != RET_TOPICS \
            or idx.topic_count("tenant0") != RET_TOPICS:
        raise AssertionError("the retained load lost topics")
    t0 = time.perf_counter()
    ct = idx.refresh()      # the compile the first scan would run
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    tabs = idx._device_tables
    build = {"topics": RET_TOPICS, "generate_s": gen_s,
             "retain_s": load_s, "retains_per_s": RET_TOPICS / load_s,
             "compile_s": compile_s, "node_rows": int(ct.n_live),
             "node_capacity": int(ct.node_tab.shape[0]),
             "device_table_bytes": {
                 k: getattr(tabs, k).numel() * 4
                 for k in R.RETAINED_TABLES}}
    print(json.dumps({"phase": "retained-build", "card": smi, **build}),
          flush=True)

    batches = [[("tenant0", f) for f in
                filters[i * RET_BATCH:(i + 1) * RET_BATCH]]
               for i in range(RET_BATCHES)]
    idx.match_batch(batches[0], limit=RET_LIMIT)      # warm
    idx.match_batch(batches[0][:64])
    mark("index_scans")
    rng = random.Random(5)
    exact_rows = sorted(rng.sample(range(RET_BATCH * RET_UNLIMITED_BATCHES),
                                   RET_EXACT_ROWS))
    D.reset_launches()
    native0 = nativelib.CALLS["retained_walk"]
    host0 = idx.host_rows
    limited, unlimited = [], {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for q in batches:
        limited.extend(idx.match_batch(q, limit=RET_LIMIT))
    lim_s = time.perf_counter() - t0
    host_lim = idx.host_rows - host0
    host0 = idx.host_rows
    matched = 0
    t0 = time.perf_counter()
    for b, q in enumerate(batches[:RET_UNLIMITED_BATCHES]):
        res = idx.match_batch(q)
        matched += sum(len(r) for r in res)
        for i in exact_rows:
            if i // RET_BATCH == b:
                unlimited[i] = res[i % RET_BATCH]
        del res
    unlim_s = time.perf_counter() - t0
    host_unlim = idx.host_rows - host0
    launches = _launches(D)
    native_calls = nativelib.CALLS["retained_walk"] - native0
    if launches["blake2b_levels"] != RET_BATCHES + RET_UNLIMITED_BATCHES \
            or any(n for k, n in launches.items() if k != "blake2b_levels"):
        raise AssertionError(f"the retained path launched {launches}")
    matched_lim = sum(len(r) for r in limited)

    # ---- the checks: every limit-10 row, 64 rows unlimited
    mark("index_checks")
    t0 = time.perf_counter()
    oracle_lens = [n for f in pending for n in f.result(timeout=600)]
    oracle_wait_s = time.perf_counter() - t0
    check_limited(limited, filters, oracle_lens, "limit-10")
    trie = idx.tries["tenant0"]
    t0 = time.perf_counter()
    wants = [sorted(match_filter_host(trie, filters[i])) for i in exact_rows]
    oracle_exact_s = time.perf_counter() - t0
    # the unlimited rows by the MQTT rule too: the host matcher also serves
    # the rows the native walker cannot, so it cannot be their only judge
    check_limited([unlimited[i] for i in exact_rows],
                  [filters[i] for i in exact_rows],
                  [len(w) for w in wants], "unlimited")
    for i, want in zip(exact_rows, wants):
        if sorted(unlimited[i]) != want:
            raise AssertionError(f"unlimited row {i} {filters[i]}: "
                                 f"{len(unlimited[i])} topics, oracle "
                                 f"{len(want)}")
    # the same rows again as one batch: how many the host matcher served
    host0 = idx.host_rows
    exact_q = [("tenant0", filters[i]) for i in exact_rows]
    again = idx.match_batch(exact_q)
    host_exact = idx.host_rows - host0
    if [sorted(g) for g in again] != wants:
        raise AssertionError("the unlimited rows served as one batch differ "
                             "from the oracle")
    del again

    # ---- K1 on the phase's own filters, and the probes it made
    lengths, rootv, kinds, rows_b, starts, lens = T.pack_filter_bytes(
        filters[:RET_BATCH], [ct.root_of("tenant0")] * RET_BATCH,
        max_levels=ct.max_levels, batch=RET_BATCH)
    args = [torch.from_numpy(a).to(dev) for a in
            (rows_b, starts, lens, lengths.reshape(RET_BATCH, 1))]
    h0 = T.h0_tensor(ct.salt, dev)
    k1_err = max_abs_err(torch, T.blake2b_levels(*args, h0),
                         T._hash_lanes(*args, h0))
    prep = idx.prepare_scan(batches[0])
    host = tokenize_filters(filters[:RET_BATCH],
                            [ct.root_of("tenant0")] * RET_BATCH,
                            max_levels=ct.max_levels, salt=ct.salt)
    sup = prep.lengths >= 0
    for k in ("tok_h1", "tok_h2", "tok_kind"):
        if not np.array_equal(getattr(prep.probes, k).cpu().numpy()[sup],
                              getattr(host, k)[sup]):
            raise AssertionError(f"device filter probes' {k} differ from "
                                 f"the host tokenizer's")
    if k1_err:
        raise AssertionError(f"K1 differs from _hash_lanes on the "
                             f"retained filters: {k1_err}")

    # ---- one limit-10 batch, stage by stage
    stages = {}

    def staged(name, fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out

    prep = staged("prepare_ms", idx.prepare_scan, batches[1])
    prep, res = staged("dispatch_ms", idx.dispatch_scan, prep)
    fetched = staged("fetch_ms", idx.fetch_scan, res)
    staged("expand_ms", idx.expand_scan, prep, fetched, limit=RET_LIMIT)
    overflow_rows = int(fetched[2][:RET_BATCH].sum())

    # ---- the service path: RetainService.match_batch at limit 10
    mark("service")
    D.reset_launches()
    svc_rows = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for q in batches:
        svc_rows.extend(run(svc.match_batch(q, RET_LIMIT)))
    svc_s = time.perf_counter() - t0
    svc_launches = _launches(D)
    if svc_launches["blake2b_levels"] != RET_BATCHES or any(
            n for k, n in svc_launches.items() if k != "blake2b_levels"):
        raise AssertionError(f"the retain service launched {svc_launches}")
    for i, (row, want) in enumerate(zip(svc_rows, limited)):
        if [tp for tp, _ in row] != want:
            raise AssertionError(f"service row {i} {filters[i]}: "
                                 f"{[tp for tp, _ in row][:4]}, index "
                                 f"{want[:4]}")
    check_hits(svc_rows, "service")
    # 256 distinct filters of the phase (the cache holds 512 a tenant),
    # served once, then again: every row of the second from the cache
    seen, hit_rows = set(), []
    for i in range(len(filters) - 1, -1, -1):
        key = tuple(filters[i])
        if key not in seen:
            seen.add(key)
            hit_rows.append(i)
            if len(hit_rows) == RET_HIT_ROWS:
                break
    hit_q = [("tenant0", filters[i]) for i in hit_rows]
    first = run(svc.match_batch(hit_q, RET_LIMIT))
    hits0 = plane.cache.hits
    D.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = run(svc.match_batch(hit_q, RET_LIMIT))
    hit_ms = (time.perf_counter() - t0) * 1e3
    hit_launches = _launches(D)
    if plane.cache.hits - hits0 != RET_HIT_ROWS \
            or any(hit_launches.values()):
        raise AssertionError(f"the repeated batch: {plane.cache.hits - hits0}"
                             f" cache hits of {RET_HIT_ROWS}, launches "
                             f"{hit_launches}")
    if not ([[tp for tp, _ in r] for r in again]
            == [[tp for tp, _ in r] for r in first]
            == [limited[i] for i in hit_rows]):
        raise AssertionError("the cached rows differ from the served ones")
    check_hits(again, "cache hit")
    del again, first
    service = {"filters_per_s_limit10": RET_BATCH * RET_BATCHES / svc_s,
               "matched_per_s_limit10":
                   sum(len(r) for r in svc_rows) / svc_s,
               "launches": svc_launches, "cache_hit_rows": RET_HIT_ROWS,
               "cache_hit_batch_ms": hit_ms,
               "cache": plane.cache.snapshot()}
    del svc_rows

    # ---- mutations through retain: set / clear, patched and flushed,
    # each evicting exactly the cached filters its topic matches
    mark("mutations")
    mrng = random.Random(7)
    names = [f"l{i}" for i in range(1000)]
    rebuilds0, compactions0 = idx.rebuilds, idx.compactions
    flushes0 = idx.patch_flushes
    patch_s, scans, churned, cleared = [], [], [], []
    cache = plane.cache
    evicted, replaced = 0, 0
    values = coproc.values
    for m in range(RET_MUTATIONS):
        roll = mrng.random()
        if roll < 0.5:
            levels = [mrng.choice(names[:50])
                      for _ in range(mrng.randint(1, 4))] + [f"m{m}"]
            clear = False
        elif roll < 0.6 and cleared:
            levels, clear = cleared.pop(), False      # resurrect
        else:
            levels, clear = topics[mrng.randrange(len(topics))], True
        tp = "/".join(levels)
        existed = tp in values.get("tenant0", {})
        before = set(cache._d.get("tenant0", ()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(svc.retain(pub, tp, _retain_msg(RET_TOPICS + m, tp, clear)))
        idx.flush_device()
        torch.cuda.synchronize()
        patch_s.append(time.perf_counter() - t0)
        changed = existed if clear else not existed
        replaced += existed and not clear
        after = set(cache._d.get("tenant0", ()))
        want_gone = {k for k in before if filter_matches(tp, k[0])} \
            if changed else set()
        if before - after != want_gone or after - before:
            raise AssertionError(
                f"mutation {m} {tp!r}: evicted {sorted(before - after)[:4]}"
                f", expected {sorted(want_gone)[:4]}")
        evicted += len(want_gone)
        if changed:
            churned.append(levels)
            if clear:
                cleared.append(levels)
        if (m + 1) % RET_SCAN_EVERY == 0:
            k = (m + 1) // RET_SCAN_EVERY
            fs = workloads.probe_filters(RET_CHURN_BATCH, seed=10 + k)
            t0 = time.perf_counter()
            got = run(svc.match_batch([("tenant0", f) for f in fs],
                                      RET_LIMIT))
            scan_ms = (time.perf_counter() - t0) * 1e3
            check_hits(got, f"churn scan {k}")
            got = [[tp for tp, _ in r] for r in got]
            sample = list(range(0, RET_CHURN_BATCH,
                                RET_CHURN_BATCH // RET_EXACT_ROWS))
            trie = idx.tries["tenant0"]
            check_limited([got[i] for i in sample], [fs[i] for i in sample],
                          [len(match_filter_host(trie, fs[i],
                                                 limit=RET_LIMIT))
                           for i in sample], f"churn scan {k}")
            own = [lv for lv in churned[-32:]]
            own = own + [lv[:-1] + ["#"] for lv in own if len(lv) > 1]
            got = idx.match_batch([("tenant0", f) for f in own])
            bad = [f for f, g in zip(own, got)
                   if sorted(g) != sorted(match_filter_host(trie, f))]
            if bad:
                raise AssertionError(f"churn scan {k}: {bad[:4]} differ "
                                     f"from the oracle")
            scans.append({"scan_ms": scan_ms, "own_filters": len(own)})
    base = idx._compiled
    host = R.RetainedDeviceTables.host_arrays(base)
    unequal = [k for k, a in zip(R.RETAINED_TABLES, host)
               if not (tuple(getattr(idx._device_tables, k).shape) == a.shape
                       and (getattr(idx._device_tables, k).cpu().numpy()
                            == a).all())]
    out = {
        "phase": "retained", "card": smi, **build,
        "batch": RET_BATCH, "batches": RET_BATCHES, "limit": RET_LIMIT,
        "unlimited_batches": RET_UNLIMITED_BATCHES,
        "filters_per_s_limit10": RET_BATCH * RET_BATCHES / lim_s,
        "matched_per_s_limit10": matched_lim / lim_s,
        "filters_per_s_unlimited":
            RET_BATCH * RET_UNLIMITED_BATCHES / unlim_s,
        "matched_per_s_unlimited": matched / unlim_s,
        "matched_unlimited": matched, "native_walker_calls": native_calls,
        "overflow_rows_one_batch": overflow_rows, "stages": stages,
        "oracle_limit10_wait_s": oracle_wait_s, "oracle_limit10_rows":
            len(filters), "oracle_exact_s": oracle_exact_s,
        "oracle_exact_rows": len(exact_rows),
        "host_rows": {"limit10": host_lim, "unlimited": host_unlim,
                      "exact_rows": host_exact},
        "k1_max_abs_err": k1_err,
        "launches": launches, "service": service,
        "mutations": RET_MUTATIONS, "patch_apply_ms": _pcts(patch_s),
        "replaced": replaced, "cache_evictions_checked": evicted,
        "churn_scans": scans,
        "rebuilds": idx.rebuilds - rebuilds0,
        "compactions": idx.compactions - compactions0,
        "patch_flushes": idx.patch_flushes - flushes0,
        "patch": base.patch_stats(), "tables_unequal": unequal,
        "degraded": dict(plane.degraded_total), "marks_s": marks,
        "seconds": time.perf_counter() - t_phase}
    print(json.dumps(out), flush=True)
    if idx.rebuilds != rebuilds0 or idx.compactions != compactions0:
        raise AssertionError("the retained mutations ran a full compile")
    if idx.patch_flushes == flushes0:
        raise AssertionError("no retained patch reached the card")
    if unequal:
        raise AssertionError(f"retained device tables differ from the host "
                             f"arenas: {unequal}")
    if plane.degraded_total:
        raise AssertionError(f"retained scans were degraded: "
                             f"{plane.degraded_total}")
    run(svc.stop())
    return out, exact_q


def _retained_restart(torch, dev, smi, workloads, exact_q, run):
    """Config 4's first ``RET_RESTART_TOPICS`` topics retained through a
    ``RetainService``, whose rows for the 64 seeded filters are kept;
    then a second ``RetainService`` over its engine: its index rebuilds
    from KV by ``reset``, and its rows must equal the first's. Returns
    the leg's summary."""
    from bifromq_tpu_torch.types import ClientInfo
    t_leg = time.perf_counter()
    topics = workloads.config_retained(RET_RESTART_TOPICS,
                                       seed=0)["tenant0"]
    first = _retain_service(dev)
    pub = ClientInfo(tenant_id="tenant0")

    async def load():
        for i, levels in enumerate(topics):
            tp = "/".join(levels)
            await first.retain(pub, tp, _retain_msg(i, tp))
    t0 = time.perf_counter()
    run(load())
    load_s = time.perf_counter() - t0
    want = run(first.match_batch(exact_q, RET_ALL))
    check_hits(want, "restart, first service")
    want_rows = [sorted((tp, msg.payload) for tp, msg in r) for r in want]
    del want
    run(first.stop())
    engine = first.kvstore.engine
    del first
    t0 = time.perf_counter()
    svc = _retain_service(dev, engine)
    reset_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run(svc.match_batch(exact_q, RET_ALL))
    torch.cuda.synchronize()
    first_scan_s = time.perf_counter() - t0
    check_hits(got, "restart")
    got = [sorted((tp, msg.payload) for tp, msg in r) for r in got]
    plane = next(iter(svc.kvstore.coprocs.values())).scan_plane
    out = {"topics": svc.topic_count("tenant0"), "retain_s": load_s,
           "reset_s": reset_s,
           "first_scan_s": first_scan_s,
           "compile_s": svc.index.compile_time_s,
           "rows": len(got), "matched": sum(len(r) for r in got),
           "degraded": dict(plane.degraded_total),
           "seconds": time.perf_counter() - t_leg}
    print(json.dumps({"phase": "retained-restart", "card": smi, **out}),
          flush=True)
    if got != want_rows:
        bad = [i for i, (g, w) in enumerate(zip(got, want_rows)) if g != w]
        raise AssertionError(f"the restarted service's rows {bad[:8]} differ "
                             f"from the first service's")
    if plane.degraded_total:
        raise AssertionError(f"restart scans were degraded: "
                             f"{plane.degraded_total}")
    run(svc.stop())
    return out


def device_chaos_phase(torch, D, workloads, smi, dev):
    """The device leg's failure boundary on the card, on a small matcher
    (``config_wildcard(400)``): a dispatch ``error`` rule, a ``hang``
    rule with the watchdog deadline pinned to its 0.25 s floor while a
    sleep kernel holds the stream (the result's CUDA event stays pending,
    so the quarantine must hold it until the event completes), and a
    forced-open breaker that serves with no launch and re-closes through
    the half-open canary. Each case ends with a batch the card serves,
    undegraded and equal to the oracle. Then the same three cases on a
    ``RetainService`` of 400 retained topics, through its scan plane
    (:func:`retained_chaos`). Returns the phase's summary."""
    import asyncio

    from bifromq_tpu_torch.models.matcher import TorchMatcher
    from bifromq_tpu_torch.resilience.faults import get_injector
    from bifromq_tpu_torch.utils.metrics import FABRIC, FabricMetric

    pinned = {k: os.environ.get(k) for k in (
        "BIFROMQ_DEVICE_DEADLINE_S", "BIFROMQ_DEVICE_BREAKER_RECOVERY_S")}
    os.environ["BIFROMQ_DEVICE_DEADLINE_S"] = "0.25"
    os.environ["BIFROMQ_DEVICE_BREAKER_RECOVERY_S"] = "0.5"
    inj = get_injector()
    cases = {}
    try:
        m = TorchMatcher.from_tries(workloads.config_wildcard(400, seed=2),
                                    device=dev, match_cache=False,
                                    auto_compact=False)
        queries = [("tenant0", "/".join(t))
                   for t in workloads.probe_topics(64, seed=3)]
        want = [canon(r) for r in m.match_from_tries(queries)]
        br = m.device_breaker

        def serve():
            """One async batch: rows exact, degraded reason, launches."""
            torch.cuda.synchronize()
            D.reset_launches()
            stats = {}
            rows = asyncio.run(m.match_batch_async(queries, stats=stats))
            torch.cuda.synchronize()
            exact = [canon(r) for r in rows] == want
            return {"exact": exact, "degraded": stats.get("degraded"),
                    "launches": _launches(D), "breaker": br.state}

        def clean(label):
            r = serve()
            if not (r["exact"] and r["degraded"] is None
                    and r["launches"]["fused_walk"]):
                raise AssertionError(f"device-chaos {label}: the recovery "
                                     f"batch was not served exactly on the "
                                     f"card: {r}")
            return r

        deg0 = FABRIC.get(FabricMetric.MATCH_DEGRADED)
        clean("warm")
        # 1. a dispatch error degrades to the oracle
        inj.add_rule(service="tpu-device", method="dispatch",
                     action="error", max_hits=1)
        c = {"faulted": serve()}
        c["recovered"] = clean("error")
        if not (c["faulted"]["exact"]
                and c["faulted"]["degraded"] == "device_error"):
            raise AssertionError(f"device-chaos error: {c}")
        cases["error"] = c
        inj.reset()
        # 2. a hang times out; a sleep kernel queued right before the walk
        #    holds the batch's kernels, copies and event for ~2 s, so the
        #    quarantine must keep the result until its event completes
        ring = m._ring
        real_walk = m._walk_primary

        def held_walk(probes, ct):
            torch.cuda._sleep(4_000_000_000)     # ~2 s at 1.98 GHz
            return real_walk(probes, ct)
        m._walk_primary = held_walk
        inj.add_rule(service="tpu-device", method="dispatch", action="hang")
        stats = {}
        t0 = time.perf_counter()
        try:
            rows = asyncio.run(m.match_batch_async(queries, stats=stats))
        finally:
            del m._walk_primary
        c = {"faulted": {"exact": [canon(r) for r in rows] == want,
                         "degraded": stats.get("degraded"),
                         "seconds": time.perf_counter() - t0}}
        inj.reset()
        c["timeouts_total"] = ring.timeouts_total
        c["held_after_reset"] = len(ring.quarantine)
        ring.quarantine.sweep()
        c["held_while_event_pending"] = len(ring.quarantine)
        torch.cuda.synchronize()
        ring.quarantine.sweep()
        c["held_after_event"] = len(ring.quarantine)
        c["recovered"] = clean("hang")
        if not (c["faulted"]["exact"] and c["faulted"]["degraded"] == "timeout"
                and c["timeouts_total"] == 1 and c["held_after_reset"] == 1
                and c["held_while_event_pending"] == 1
                and c["held_after_event"] == 0):
            raise AssertionError(f"device-chaos hang: {c}")
        cases["hang"] = c
        # 3. an open breaker serves with no launch; the half-open canary
        #    closes it after row parity
        br.force_open()
        c = {"open": serve()}
        time.sleep(br.recovery_time + 0.05)
        c["canary"] = serve()
        c["recovered"] = clean("breaker")
        if not (c["open"]["exact"] and c["open"]["degraded"] == "breaker"
                and not any(c["open"]["launches"].values())
                and c["canary"]["exact"] and c["canary"]["degraded"] is None
                and c["canary"]["launches"]["fused_walk"]
                and c["canary"]["breaker"] == "closed"):
            raise AssertionError(f"device-chaos breaker: {c}")
        cases["breaker"] = c
        degraded = FABRIC.get(FabricMetric.MATCH_DEGRADED) - deg0
        deg0 = FABRIC.get(FabricMetric.MATCH_DEGRADED)
        retained = retained_chaos(torch, D, workloads, dev)
        retained_degraded = FABRIC.get(FabricMetric.MATCH_DEGRADED) - deg0
    finally:
        inj.reset()
        for k, v in pinned.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = {"phase": "device-chaos", "card": smi, "rows": len(queries),
           "cases": cases, "match_degraded": degraded,
           "retained": retained,
           "retained_match_degraded": retained_degraded}
    print(json.dumps(out), flush=True)
    if degraded != 3 * len(queries):
        raise AssertionError(f"device-chaos: {degraded} degraded rows, "
                             f"expected {3 * len(queries)}")
    if retained_degraded != 3 * retained["rows"]:
        raise AssertionError(f"device-chaos, retained: {retained_degraded} "
                             f"degraded rows, expected "
                             f"{3 * retained['rows']}")
    return out


def retained_chaos(torch, D, workloads, dev):
    """The scan plane's failure boundary on the card: a ``RetainService``
    of 400 of config 4's topics, 64 ``probe_filters`` at ``limit=10``
    served through ``RetainService.match_batch`` with a dispatch
    ``error`` rule, a ``hang`` rule past the pinned 0.25 s deadline while
    a sleep kernel holds the scan on the card (the quarantine keeps its
    result until the CUDA event completes), and a forced-open breaker
    (no launch; the half-open canary re-closes it). Each is served
    exactly from the host oracle and followed by a scan the card serves;
    the cache is emptied before each case, so every scan reaches the
    plane's device leg. Last, a ``NativeLibError`` raised inside the
    plane must propagate out of ``match_batch``, undegraded. Runs with
    the caller's deadline and breaker recovery pinned. Returns the
    cases."""
    import asyncio

    from bifromq_tpu_torch.models.retained import match_filter_host
    from bifromq_tpu_torch.resilience.faults import get_injector
    from bifromq_tpu_torch.types import ClientInfo
    from bifromq_tpu_torch.utils.nativelib import NativeLibError

    inj = get_injector()
    loop = asyncio.new_event_loop()
    run = loop.run_until_complete
    try:
        svc = _retain_service(dev)
        pub = ClientInfo(tenant_id="tenant0")
        topics = ["/".join(lv) for lv in
                  workloads.config_retained(400, seed=0)["tenant0"]]

        async def load():
            for i, tp in enumerate(topics):
                await svc.retain(pub, tp, _retain_msg(i, tp))
        run(load())
        coproc = next(iter(svc.kvstore.coprocs.values()))
        plane, idx = coproc.scan_plane, coproc.index
        br = plane.device_breaker
        queries = [("tenant0", f)
                   for f in workloads.probe_filters(64, seed=3)]
        trie = idx.tries["tenant0"]
        oracle = [match_filter_host(trie, f, limit=RET_LIMIT)
                  for _, f in queries]
        full = [set(match_filter_host(trie, f)) for _, f in queries]

        def serve(sync=True):
            """One scan through the service. ``sync=False`` leaves the
            card's queue alone after it (the hang case's held result)."""
            plane.cache.bump_all()      # every row reaches the device leg
            deg0 = dict(plane.degraded_total)
            torch.cuda.synchronize()
            D.reset_launches()
            rows = run(svc.match_batch(queries, RET_LIMIT))
            if sync:
                torch.cuda.synchronize()
            check_hits(rows, "retained chaos")
            rows = [[tp for tp, _ in r] for r in rows]
            reasons = {k: v - deg0.get(k, 0)
                       for k, v in plane.degraded_total.items()
                       if v != deg0.get(k, 0)}
            card = all(len(r) == len(o) and set(r) <= f
                       for r, o, f in zip(rows, oracle, full))
            return {"oracle_exact": rows == oracle, "card_exact": card,
                    "degraded": reasons, "launches": _launches(D),
                    "breaker": br.state}

        def clean(label):
            r = serve()
            if not (r["card_exact"] and not r["degraded"]
                    and r["launches"]["blake2b_levels"]):
                raise AssertionError(f"retained chaos {label}: the recovery "
                                     f"scan was not served on the card: {r}")
            return r

        cases = {"warm": clean("warm")}
        # 1. a dispatch error degrades to the oracle
        inj.add_rule(service="tpu-device", method="dispatch",
                     action="error", max_hits=1)
        c = {"faulted": serve()}
        inj.reset()
        c["recovered"] = clean("error")
        if not (c["faulted"]["oracle_exact"]
                and c["faulted"]["degraded"] == {"device_error": 1}):
            raise AssertionError(f"retained chaos error: {c}")
        cases["error"] = c
        # 2. a hang times out while a sleep kernel holds the scan
        ring = plane._ring
        real_dispatch = idx.dispatch_scan

        def held_dispatch(prep, **kw):
            torch.cuda._sleep(4_000_000_000)     # ~2 s at 1.98 GHz
            return real_dispatch(prep, **kw)
        idx.dispatch_scan = held_dispatch
        inj.add_rule(service="tpu-device", method="dispatch", action="hang")
        t0 = time.perf_counter()
        try:
            c = {"faulted": serve(sync=False)}
        finally:
            del idx.dispatch_scan
            inj.reset()
        c["faulted"]["seconds"] = time.perf_counter() - t0
        c["timeouts_total"] = ring.timeouts_total
        ring.quarantine.sweep()
        c["held_while_event_pending"] = len(ring.quarantine)
        torch.cuda.synchronize()
        ring.quarantine.sweep()
        c["held_after_event"] = len(ring.quarantine)
        c["recovered"] = clean("hang")
        if not (c["faulted"]["oracle_exact"]
                and c["faulted"]["degraded"] == {"timeout": 1}
                and c["timeouts_total"] == 1
                and c["held_while_event_pending"] == 1
                and c["held_after_event"] == 0):
            raise AssertionError(f"retained chaos hang: {c}")
        cases["hang"] = c
        # 3. an open breaker serves with no launch; the canary closes it
        br.force_open()
        c = {"open": serve()}
        time.sleep(br.recovery_time + 0.05)
        c["canary"] = serve()
        c["recovered"] = clean("breaker")
        if not (c["open"]["oracle_exact"]
                and c["open"]["degraded"] == {"breaker": 1}
                and not any(c["open"]["launches"].values())
                and c["canary"]["card_exact"] and not c["canary"]["degraded"]
                and c["canary"]["launches"]["blake2b_levels"]
                and c["canary"]["breaker"] == "closed"):
            raise AssertionError(f"retained chaos breaker: {c}")
        cases["breaker"] = c
        # 4. a fault of the program propagates, undegraded
        def broken_walker(*a, **kw):
            raise NativeLibError("retained walker failed to build")
        idx.expand_scan = broken_walker
        plane.cache.bump_all()
        deg0 = dict(plane.degraded_total)
        try:
            run(svc.match_batch(queries, RET_LIMIT))
            raise AssertionError("a NativeLibError in the scan plane was "
                                 "served around")
        except NativeLibError:
            pass
        finally:
            del idx.expand_scan
        if plane.degraded_total != deg0 or br.state != "closed":
            raise AssertionError("the NativeLibError degraded the scan or "
                                 "fed the breaker")
        cases["native_lib_error"] = {"propagated": True}
        cases["recovered"] = clean("native")
        run(svc.stop())
    finally:
        inj.reset()
        loop.close()
    return {"topics": len(topics), "rows": len(queries), "cases": cases}


def parse_args(argv):
    import argparse
    ap = argparse.ArgumentParser(description="Drive bifromq_tpu_torch's "
                                 "serving paths on one CUDA card.")
    ap.add_argument("--mesh-subs", type=int, default=MESH_SUBS,
                    help="config 5's subscriptions on the mesh path "
                    "(default %(default)s, cut from 10M)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
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

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = smi_line()
    print(smi, flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)

    t0 = time.perf_counter()
    host_built = start_host_builds()
    D.build_all()
    kernels_s = time.perf_counter() - t0
    host_s = host_built()
    print(json.dumps({"phase": "build",
                      "seconds": time.perf_counter() - t0,
                      "kernels_s": kernels_s, "host_s": host_s}), flush=True)

    # ---- retained: BASELINE config 4 through RetainService, first, on a
    # small heap (its services are freed when the phase returns)
    ret = retained_phase(torch, D, T, workloads, smi, dev)

    t0 = time.perf_counter()
    tries = workloads.config_wildcard(N_SUBS, seed=0)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # cache off, as bench.py's config 2: every batch reaches the card
    m = TorchMatcher.from_tries(tries, device=dev, match_cache=False)
    ct, trie = m.compiled, m.device_trie
    print(json.dumps({"phase": "compile", "subs": N_SUBS,
                      "nodes": int(ct.n_live),
                      "node_capacity": int(ct.n_nodes),
                      "slots": int(ct.n_slots),
                      "generate_s": gen_s,
                      "compile_s": time.perf_counter() - t0}), flush=True)
    root = ct.root_of("tenant0")
    rows = {}

    # ---- K1: BLAKE2b level hashing ----------------------------------------
    k1_err, rows["blake2b_levels"] = k1_phase(torch, T, workloads, TopicBytes,
                                              ct, root, dev, smi)
    k1_err = max(k1_err, k1_wide_phase(torch, T, TopicBytes, dev, smi),
                 ret["k1_max_abs_err"])

    # ---- K2: fused interval walk ------------------------------------------
    topics = ["/".join(t) for t in workloads.probe_topics(B_CHECK, seed=1)]
    _, probes = T.device_tokenize(TopicBytes.from_topics(topics),
                                  [root] * B_CHECK,
                                  max_levels=ct.max_levels, salt=ct.salt,
                                  batch=B_CHECK, device=dev)
    walk32, k2_err = k2_hold(torch, K, M, trie, probes, 32, 32,
                             ct.probe_len, "config 2")
    k2_err = max(k2_err, k2_hold(torch, K, M, trie, probes, 128, 128,
                                 ct.probe_len, "config 2")[1],
                 k2_dense(torch, K, M, workloads, dev))
    kw = dict(probe_len=ct.probe_len, k_states=32, max_intervals=32)
    r = walk_bound_row(torch, M, [(trie, probes, 0)], ct.probe_len, 32)
    r.update(
        ms=time_ms(torch, lambda: K.fused_walk_routes(trie, probes, **kw), 20),
        device_ms=time_device_ms(
            torch, lambda: K.fused_walk_routes(trie, probes, **kw), 20),
        plain_ms=time_ms(torch, lambda: M.walk_routes(
            trie, probes, esc_k=0, **kw), 3, 1))
    rows["fused_walk"] = r
    print(json.dumps({"phase": "K2-time", "shape": [B_CHECK], "card": smi,
                      "ms": r["ms"], "device_ms": r["device_ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": bound_ms(r),
                      "bound_by": bound_by(r),
                      "unique_rows": r["unique_rows"],
                      "unique_buckets": r["unique_buckets"],
                      "row_visits": r["row_visits"],
                      "bucket_visits": r["bucket_visits"]}), flush=True)
    k2_err = max(k2_err, k2_budgets_phase(torch, K, M, D, workloads, trie,
                                          probes, dev, smi))
    k2_large_time(torch, K, M, workloads, trie, probes, dev, smi)

    # ---- K3: ragged-arange expansion --------------------------------------
    k3_err = k3_adversarial(torch, K, M, dev)
    cap = B_CHECK * M.expand_cap_lanes()
    serve_c = torch.where(walk32.overflow[:, None], 0, walk32.count)
    ivl_s = walk32.start
    rows["expand_pairs"] = k3_time(torch, K, M, ivl_s, serve_c, cap,
                                   f"single B={B_CHECK}", smi)
    cap = B_SERVE * M.expand_cap_lanes()
    k3_time(torch, K, M, ivl_s[:B_SERVE].contiguous(),
            serve_c[:B_SERVE].contiguous(), cap, f"single B={B_SERVE}", smi)

    # ---- serve: the main path ---------------------------------------------
    D.reset_launches()
    serve = []
    for s in range(N_SERVE_BATCHES):
        topics = ["/".join(t) for t in
                  workloads.probe_topics(B_SERVE, seed=100 + s)]
        queries = [("tenant0", t) for t in topics]
        before = {k: v.launches for k, v in D.KERNELS.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = m.match_batch(queries)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched = {k: v.launches - before[k] for k, v in D.KERNELS.items()}
        # the primary walk, and the escalation re-walk when a row overflows
        if not (launched["blake2b_levels"] == 1
                and launched["fused_walk"] in (1, 2)
                and launched["expand_pairs"] == 1
                and launched["ring_hop"] == 0):
            return fail(f"serve batch {s} launched {launched}")
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
                      "oracle_rows_checked": len(sample),
                      "launches": launched})
    launches = {k: v.launches for k, v in D.KERNELS.items()}
    single_launches = dict(launches)
    print(json.dumps({"phase": "serve", "subs": N_SUBS, "batch": B_SERVE,
                      "card": smi, "batches": serve,
                      "launches": launches}), flush=True)
    missing = [k for k in ("blake2b_levels", "fused_walk", "expand_pairs")
               if not launches[k]]
    if missing:
        return fail(f"the main path did not launch {missing}")

    # ---- where one served batch's time goes: match_batch's four stages,
    # each bracketed by a device synchronize
    queries = [("tenant0", "/".join(t)) for t in
               workloads.probe_topics(B_SERVE, seed=200)]
    stages = {"native_calls": {}}

    def staged(name, fn, *args):
        torch.cuda.synchronize()
        before = native_calls()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        stages["native_calls"][name] = calls_since(before)
        return out

    fl = staged("dispatch_ms", m._dispatch_prepared,
                staged("prepare_ms", m._prepare_probes, queries))
    overflow, pairs = staged("fetch_ms", m._fetch_walk, fl.res)
    staged("expand_walk_ms", m._expand_walk, fl, overflow, pairs,
           UNCAPPED_FANOUT, UNCAPPED_FANOUT)
    print(json.dumps({"phase": "stages", "batch": B_SERVE, "card": smi,
                      **stages}), flush=True)
    # stage 3 re-expands the truncated rows through the native expander
    if pairs.trunc[:B_SERVE].any() \
            and not stages["native_calls"]["expand_walk_ms"].get("expand"):
        return fail("stage 3 expanded no truncated row natively")
    import numpy as np
    host_helpers_phase(np, M, m, overflow, pairs, ct, workloads, root, smi)

    # ---- churn: in-place patching under subscription churn (config 8) ----
    churn_phase(torch, M, D, workloads, m, smi)

    # ---- peers: per-peer bucketing on the card ----------------------------
    t0 = time.perf_counter()
    mp = TorchMatcher.from_tries(workloads.config_wildcard(
        N_PEER_SUBS, seed=0, deliverer_key=lambda i: f"srv{i % 8}|d{i}"),
        device=dev)
    topics = ["/".join(t) for t in workloads.probe_topics(B_SERVE, seed=7)]
    queries = [("tenant0", t) for t in topics]
    D.reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = mp.match_batch(queries)
    torch.cuda.synchronize()
    miss_ms = (time.perf_counter() - t1) * 1e3
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

    # ---- cache: the match-result cache front end on that matcher ----------
    cache_phase(torch, D, mp, queries, miss_ms, smi)

    rows["ring_hop"], k4_err = ring_phase(torch, K, dev)
    k4_host_split(torch, K, D, dev, smi)
    mesh_launches, _ = mesh_phase(torch, dev, smi,
                                  total_subs=args.mesh_subs)
    mesh_peer_phase(torch, dev)

    # ---- pipeline: the async serving leg (bench.py config 7) --------------
    from bifromq_tpu_torch.resilience.device import DEVICE_BREAKERS
    from bifromq_tpu_torch.utils.metrics import FABRIC, FabricMetric
    pipe = pipeline_phase(torch, D, workloads, smi, dev)
    k1_err = max(k1_err, pipe["max_abs_err"]["blake2b_levels"])
    k2_err = max(k2_err, pipe["max_abs_err"]["fused_walk"])
    k3_err = max(k3_err, pipe["max_abs_err"]["expand_pairs"])
    # ---- dist: the broker's publish path (DistService -> DistWorker) ----
    dist = dist_phase(torch, D, workloads, smi)
    degraded = FABRIC.get(FabricMetric.MATCH_DEGRADED)
    if degraded:
        return fail(f"{degraded} rows were served degraded outside the "
                    f"device-chaos phase")
    # ---- device-chaos: the failure boundary of the device leg -------------
    device_chaos_phase(torch, D, workloads, smi, dev)
    not_closed = {k: v for k, v in
                  DEVICE_BREAKERS.states(include_closed=True).items()
                  if v != "closed"}
    if not_closed:
        return fail(f"device breakers not closed at the end: {not_closed}")

    # ---- the kernels line -------------------------------------------------
    launches["ring_hop"] = mesh_launches["ring_hop"]
    meta = {
        "blake2b_levels": ("blake2b_levels.cu",
                           "bifromq_tpu/ops/tokenize.py:205", k1_err),
        "fused_walk": ("fused_walk.cu",
                       "bifromq_tpu/models/kernels.py:153", k2_err),
        "expand_pairs": ("expand.cu",
                         "bifromq_tpu/models/kernels.py:246", k3_err),
        "ring_hop": ("ring_hop.cu",
                     "bifromq_tpu/models/kernels.py:325", k4_err),
    }
    out = []
    for name, (src, replaces, err) in meta.items():
        r = rows[name]
        out.append({"name": name, "route": "cuda",
                    "source": f"bifromq_tpu_torch/csrc/{src}",
                    "replaces": replaces, "launches": launches[name],
                    "launches_by_path": {
                        "single": single_launches[name],
                        "mesh": mesh_launches[name],
                        "pipelined": pipe["pipelined"]["launches"][name],
                        "dist": dist["publish"]["launches"][name],
                        "retained": ret["launches"][name],
                        "retain_service":
                            ret["service"]["launches"][name]},
                    "max_abs_err": err, "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": bound_ms(r),
                    "bound_by": bound_by(r),
                    "library_ms": r.get("library_ms")})
    print(json.dumps({"phase": "total",
                      "seconds": time.perf_counter() - t_start}), flush=True)
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
