"""ctypes binding for the native retained-filter walker (copy of
``bifromq_tpu/models/native_retained.py`` over the port's own
``csrc/host/retainedwalk.cpp``).

Resolves '+'-heavy filters whose frontier outgrows the device walk's
lane budget: a C++ DFS over the compiled int32 tables emits exact slot
ranges, about two orders faster than the Python trie oracle. A failed
build or load raises :class:`~bifromq_tpu_torch.utils.nativelib.
NativeLibError` to the caller.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ..utils.nativelib import CALLS, CSRC_HOST, compile_and_load

_SRC = CSRC_HOST / "retainedwalk.cpp"


def _configure(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    lib.retained_match_rows.argtypes = [
        i32p, i32p, i64, i64, i32p,
        i32p, i32p, i32p, i32p, i32p,
        i64, i64, i64, i64,
        i32p, i32p, u8p,
    ]
    lib.retained_match_rows.restype = None


def load_lib() -> ctypes.CDLL:
    return compile_and_load(_SRC, configure=_configure)


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def match_rows_native(ct, tok_h1: np.ndarray, tok_h2: np.ndarray,
                      tok_kind: np.ndarray, lengths: np.ndarray,
                      roots: np.ndarray, *, max_ranges: int = 8192,
                      limit: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Walk tokenized filter rows against ``ct``'s compiled tables.

    Returns (ranges [R, max_ranges, 2] int32, n_ranges [R] int32,
    overflow [R] bool): overflow means the row's range budget ran out and
    the caller serves that row through the oracle.
    """
    lib = load_lib()
    tok_h1 = np.ascontiguousarray(tok_h1, dtype=np.int32)
    tok_h2 = np.ascontiguousarray(tok_h2, dtype=np.int32)
    tok_kind = np.ascontiguousarray(tok_kind, dtype=np.int32)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    roots = np.ascontiguousarray(roots, dtype=np.int32)
    node_tab = np.ascontiguousarray(ct.node_tab, dtype=np.int32)
    edge_tab = np.ascontiguousarray(ct.edge_tab, dtype=np.int32)
    child_list = np.ascontiguousarray(ct.child_list, dtype=np.int32)
    n_rows, width = tok_h1.shape
    out_ranges = np.zeros((n_rows, max_ranges, 2), dtype=np.int32)
    out_n = np.zeros(n_rows, dtype=np.int32)
    out_ovf = np.zeros(n_rows, dtype=np.uint8)
    lib.retained_match_rows(
        _i32p(node_tab), _i32p(edge_tab), edge_tab.shape[0],
        edge_tab.shape[1], _i32p(child_list),
        _i32p(tok_h1), _i32p(tok_h2), _i32p(tok_kind),
        _i32p(lengths), _i32p(roots), n_rows, width, max_ranges,
        limit if limit is not None else 0,
        _i32p(out_ranges), _i32p(out_n),
        out_ovf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    CALLS["retained_walk"] += 1
    return out_ranges, out_n, out_ovf.astype(bool)
