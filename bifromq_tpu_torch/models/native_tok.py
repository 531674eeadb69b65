"""ctypes binding for the native topic tokenizer (copy of
``bifromq_tpu/models/native_tok.py`` over the port's own
``csrc/host/tokenizer.cpp``).

Hashes PUBLISH-topic levels into probe arrays, bit-exact with
``automaton.level_hash`` (same BLAKE2b-8 + salt), which the parity tests
enforce against the per-level Python loop. Every call allocates its own
buffers and ctypes releases the GIL for the call, so the pipelined leg
and the dist plane may tokenize from several threads at once.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence

import numpy as np

from ..utils.nativelib import CALLS, CSRC_HOST, compile_and_load

_SRC = CSRC_HOST / "tokenizer.cpp"

# below this row count, thread spawn overhead beats the parallel win
_MT_THRESHOLD = 2048


def _configure(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    base_args = [
        u8p, i32p, ctypes.c_int, i32p, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_int, i32p, i32p, i32p, i32p, i32p, u8p, ctypes.c_int]
    lib.tok_topics.argtypes = base_args
    lib.tok_topics.restype = None
    lib.tok_topics_mt.argtypes = base_args + [ctypes.c_int]
    lib.tok_topics_mt.restype = None


def load_lib() -> ctypes.CDLL:
    return compile_and_load(_SRC, extra_flags=("-pthread",),
                            configure=_configure)


def _pack(topics: Sequence) -> tuple:
    """Join level lists (or accept raw strings) into (bytes, offsets); a
    :class:`~bifromq_tpu_torch.models.bytetok.TopicBytes` batch passes
    through untouched."""
    from .bytetok import TopicBytes
    if isinstance(topics, TopicBytes):
        return topics.data, topics.offsets
    enc: List[bytes] = []
    for t in topics:
        if isinstance(t, bytes):
            enc.append(t)
        elif isinstance(t, str):
            enc.append(t.encode("utf-8"))
        else:
            enc.append("/".join(t).encode("utf-8"))
    offsets = np.zeros(len(enc) + 1, dtype=np.int32)
    np.cumsum([len(b) for b in enc], out=offsets[1:])
    return b"".join(enc), offsets


def tokenize_topics_native(topics: Sequence, roots: Sequence[int], *,
                           max_levels: int, salt: int,
                           batch: Optional[int] = None):
    """Native equivalent of ``automaton.tokenize``.

    ``topics`` may be str / bytes / level-list rows or one pre-packed
    ``TopicBytes`` batch. Returns (tok_h1, tok_h2, lengths, roots,
    sys_mask) numpy arrays. (The reference's ``filter_mode`` leg, which
    marks wildcard levels for the retained plane's filter probes, is not
    bound: it is passed as 0 with no kind array.)
    """
    lib = load_lib()
    n = len(topics)
    b = batch or n
    if b < n:
        raise ValueError(f"batch {b} is smaller than the {n} topics")
    width = max_levels + 1
    data, offsets = _pack(topics)
    if isinstance(data, np.ndarray):
        data_arr = (np.ascontiguousarray(data, dtype=np.uint8)
                    if data.size else np.zeros(1, dtype=np.uint8))
        offsets = np.ascontiguousarray(offsets, dtype=np.int32)
    else:
        data_arr = np.frombuffer(data, dtype=np.uint8) if data else \
            np.zeros(1, dtype=np.uint8)
    roots_arr = np.asarray(list(roots), dtype=np.int32)
    if roots_arr.shape[0] < n:    # the C loop reads one root a topic
        raise ValueError(f"{roots_arr.shape[0]} roots for {n} topics")
    tok_h1 = np.zeros((b, width), dtype=np.int32)
    tok_h2 = np.zeros((b, width), dtype=np.int32)
    lengths = np.full(b, -1, dtype=np.int32)
    root_out = np.full(b, -1, dtype=np.int32)
    sys_mask = np.zeros(b, dtype=np.uint8)

    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    def p32(a):
        return a.ctypes.data_as(i32p)

    args = (
        data_arr.ctypes.data_as(u8p), p32(offsets), n, p32(roots_arr),
        max_levels, ctypes.c_uint64(salt & 0xFFFFFFFFFFFFFFFF), 0,
        p32(tok_h1), p32(tok_h2), i32p(), p32(lengths), p32(root_out),
        sys_mask.ctypes.data_as(u8p), width)
    if n >= _MT_THRESHOLD:
        # rows are independent; ctypes releases the GIL for the whole call
        lib.tok_topics_mt(*args, min(8, os.cpu_count() or 1))
    else:
        lib.tok_topics(*args)
    CALLS["tokenize"] += 1
    return tok_h1, tok_h2, lengths, root_out, sys_mask.astype(bool)
