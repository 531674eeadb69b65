#!/usr/bin/env python3
"""Drive bifromq_tpu_torch's serving paths on one CUDA card.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with an NVIDIA H100 and the CUDA toolkit. The script

1. builds the four CUDA kernels from ``bifromq_tpu_torch/csrc`` (one
   ``nvcc`` per source, started together) into ``build/kernels/``;
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
     primary and escalation budget the reference's tests reach, and
     ``TorchMatcher(k_states=16)`` (escalation (64, 128)) serving 1024
     topics equal to the host oracle;
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
   expansion); then runs bench.py's config 8 ("churn") on the same
   matcher: 256 subscribes, each patched in place and flushed to the
   card, and 128 unsubscribes, with a 64-topic batch every 8 subscribes,
   checking that no full compile ran, that the device tables equal the
   host arenas and that the results equal the host oracle;
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
   tenants, cut from 10M to 2M subscriptions) onto a ``make_mesh(2, 4)``
   grid and serves 3 ``match_batch`` calls of 4096 config-5 queries
   through ``TorchMeshMatcher`` — the mesh path — with the launch counts
   reset just before and read just after (per batch: the walk once and
   the expansion once for all blocks, the ring hop 4 times); checks 256
   rows of each batch against the host oracle, every block's peer
   buckets against the host bucketing and the ring-merged per-peer
   totals; then times one more batch stage by stage, holds the walk's
   one launch on that batch's own [8, 1024, W] probe grids against the
   plain walk block by block and times it beside 8 per-block launches
   of the same kernel, and times the expansion on the batch's own
   [8, 1024, 32] grids;
8. serves one checked mesh batch over a 100K-subscription config-5
   population whose deliverer keys name 8 servers, so the blocks bucket
   into 8 peers and the ring merges ``[2, 4, 10]`` count vectors.

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
MESH_SUBS = 2_000_000    # config 5 has 10M; cut to 2M (PERF.md section 4)
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


def walk_bound_row(torch, M, blocks, probe_len: int, a: int):
    """Bytes and operations of the walk over ``blocks`` — (trie, probes,
    shard) triples, 2-D probes each — as this run's data needs them: every
    route-table row and edge bucket the walk visits, read once per shard,
    the probe grids read and the results written once."""
    rows, bkts, n_row_v, n_bkt_v, n = [], [], 0, 0, 0
    for trie, probes, sh in blocks:
        visits = {"rows": [], "buckets": []}
        M._route_walk(trie, probes, probe_len, 32, a, visits=visits)
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

    stages = {}

    def staged(name, fn, *args):
        sync(torch, dev)
        t0 = time.perf_counter()
        out = fn(*args)
        sync(torch, dev)
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out

    fl = staged("dispatch_ms", mm._dispatch_prepared,
                staged("prepare_ms", mm._prepare_probes, batches[-1]))
    overflow, pairs = staged("fetch_ms", mm._fetch_walk, fl.res)
    staged("expand_walk_ms", mm._expand_walk, fl, overflow, pairs,
           UNCAPPED_FANOUT, UNCAPPED_FANOUT)
    print(json.dumps({"phase": "mesh-stages", "batch": batch, "card": smi,
                      **stages}), flush=True)
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


def k2_budgets_phase(torch, K, M, D, workloads, trie, probes, dev, smi):
    """K2 against ``walk_routes(esc_k=0)`` at every (K, A) of
    ``K2_BUDGET_K`` x ``K2_BUDGET_A`` on the first 4096 config-2 probe
    rows, and at K = 6 and 24 on the seeded full-bucket tables, exact;
    then ``TorchMatcher(k_states=16)`` — escalation budget (64, 128) —
    serves a batch of 1024 topic strings equal to the host oracle row for
    row. Returns the max error."""
    import numpy as np
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
    d = workloads.dense_walk_tables(0)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    rt = put(d["route_tab"])
    dense = M.DeviceTrie(rt, put(d["edge_tab"]), None, None, rt)
    dp = M.Probes(put(d["tok_h1"]), put(d["tok_h2"]), put(d["lengths"]),
                  put(d["roots"]), put(d["sys_mask"]),
                  int(d["lengths"].max()))
    for k_states in (6, 24):
        err = max(err, k2_hold(torch, K, M, dense, dp, k_states, 32, 16,
                               "dense")[1])
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

    t_start = time.perf_counter()
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
    k1_err = max(k1_err, k1_wide_phase(torch, T, TopicBytes, dev, smi))

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
    mesh_launches, _ = mesh_phase(torch, dev, smi)
    mesh_peer_phase(torch, dev)

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
